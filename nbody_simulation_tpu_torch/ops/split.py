"""How the port's kernels spread a serial sum over the card.

The quadrupole sweep (K4, ``ops/traversal.py``) sums each group's columns
and the potential sweep (K6, ``ops/energy.py``) each target's sources in
one serial loop. Both cut that axis into chunks of whole runs (``RUN``
terms, each summed in f32 on its own), one block per (work item, chunk);
every block writes its f64 sums to its own slot, and a fold adds a
target's slots in chunk order and rounds once. ``chunk_plan`` picks the
chunk size for both from the grid's shape. The symmetric round kernel
(K2, K9, ``ops/allpairs.py:sym_rounds_per_launch``) spreads tournament
rounds over sequential launches instead, but holds its f64 slots within
the same ``SLOT_SCRATCH``. ``launch_shape`` reads any of these kernels'
threads, targets and resident blocks from the built library.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

RUN = 32                   # terms per f32 run sum in every kernel of csrc/
SLOT_SCRATCH = 256 << 20   # bytes of f64 slots one kernel call may hold
MAX_CHUNKS = 65535         # a grid's y extent
MIN_WAVES = 16             # waves of resident blocks a bounded grid holds
BLOCK_COST_RUNS = 1        # a block's fixed cost in the plan's model, runs


class ChunkPlan(NamedTuple):
    """``chunks`` chunks of ``chunk`` terms (a multiple of ``RUN``)."""
    chunk: int
    chunks: int


@functools.lru_cache(maxsize=512)
def chunk_plan(items: int, runs: int, resident_blocks: int,
               slot_bytes: int, bounded: bool) -> ChunkPlan:
    """Cut ``runs`` runs into chunks for a grid of ``items`` × chunks
    blocks on a card that holds ``resident_blocks`` at once.

    The model: a block of r runs costs r + ``BLOCK_COST_RUNS``, and the
    grid takes ceil(blocks / resident) waves of its longest block. The
    chunk count is the cheapest in that model, ties to fewer chunks, within
    ``SLOT_SCRATCH`` bytes of slots (``slot_bytes`` per chunk) and the
    grid's y extent; each count is evened out over its runs. Where blocks
    may end early at a bound that the plan must not see (``bounded``: K4's
    per-group bound), the model's even waves do not hold, and the count is
    the cheapest of those whose grid holds at least ``MIN_WAVES`` waves (or
    one chunk per run, if fewer), so that what the bound leaves is spread
    over many short blocks."""
    if min(items, resident_blocks, slot_bytes) <= 0 or runs < 0:
        raise ValueError(f"chunk_plan: bad shape: {items} items of {runs} "
                         f"runs, {resident_blocks} resident blocks, "
                         f"{slot_bytes} slot bytes per chunk")
    if runs == 0:
        return ChunkPlan(RUN, 0)
    cap = min(runs, max(1, SLOT_SCRATCH // slot_bytes), MAX_CHUNKS)
    lo = -(-MIN_WAVES * resident_blocks // items) if bounded else 1
    n = np.arange(min(cap, lo), cap + 1)
    per = -(-runs // n)
    chunks = -(-runs // per)
    waves = -(-(items * chunks) // resident_blocks)
    k = int(np.argmin(waves * (per + BLOCK_COST_RUNS)))
    return ChunkPlan(int(per[k]) * RUN, int(chunks[k]))


class LaunchShape(NamedTuple):
    """A built kernel's block: ``threads`` threads of ``targets`` targets,
    ``blocks_per_sm`` resident per SM (``cudaOccupancyMaxActiveBlocksPer
    Multiprocessor``), on a card of ``sms`` SMs."""
    threads: int
    targets: int
    blocks_per_sm: int
    sms: int

    @property
    def resident_blocks(self) -> int:
        return self.blocks_per_sm * self.sms


_shapes: dict = {}


def launch_shape(query, device: torch.device, *args) -> LaunchShape:
    """The launch shape that a library's C query ``query(*args, device,
    int* threads, int* targets, int* blocks)`` reports for a CUDA
    ``device``; asked once per (query, device, args). A ctypes function
    cannot be hashed: it is keyed by its id, and the entry holds it, so
    that the id is not reused while the entry stands."""
    device = torch.device(device)
    key = (id(query), device, args)
    if key not in _shapes:
        threads, targets, blocks = (ctypes.c_int(0) for _ in range(3))
        err = query(*args, device.index or 0, ctypes.byref(threads),
                    ctypes.byref(targets), ctypes.byref(blocks))
        if err != 0 or blocks.value <= 0:
            name = getattr(query, "__name__", "launch shape query")
            raise RuntimeError(f"{name}: CUDA error {err}, "
                               f"{blocks.value} resident blocks per SM")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _shapes[key] = (query, LaunchShape(threads.value, targets.value,
                                           blocks.value, sms))
    return _shapes[key][1]
