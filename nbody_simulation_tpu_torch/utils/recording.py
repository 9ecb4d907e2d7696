"""Position-delta recording, in the JAX package's ``NBREC`` v1 format.

The reference carries a commented-out sketch of this (reference
src/main.rs:119-134): every 10 steps, the per-step position deltas as
bytes, zstd-compressed at level 22. A ``Recorder`` keeps the previous
positions, writes f32 delta frames (pos - prev), compressed, and
``playback`` adds them back up.

Wire format, byte for byte the JAX package's ``utils/recording.py``: the
8-byte magic ``NBREC\\0\\0\\1``, then per frame a ``<QII`` header (step, raw
length, compressed length) and the compressed f32 deltas. The first frame
is absolute (a delta from zeros), so a stream needs no initial state.
Compression is zstd (level ≤ 22), or zlib (level ≤ 9) where the
``zstandard`` module is missing; a stream carries no codec tag, so it is
read back with the codec that wrote it (``CODEC``).

A distributed run records per process (``ShardedRecorder``): each
process streams only its own rows to ``rec_{pid:05d}.bin`` and process 0
writes ``manifest.json`` with every process's global row spans;
``playback_sharded`` reassembles the global frames. Both follow the JAX
package's sharded layout, so each package plays the other's back.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path

import numpy as np

try:
    import zstandard as _zstd

    def _compress(b: bytes, level: int) -> bytes:
        return _zstd.ZstdCompressor(level=min(level, 22)).compress(b)

    def _decompress(b: bytes) -> bytes:
        return _zstd.ZstdDecompressor().decompress(b)

    CODEC = "zstd"
except ImportError:
    import zlib

    def _compress(b: bytes, level: int) -> bytes:
        return zlib.compress(b, min(level, 9))

    def _decompress(b: bytes) -> bytes:
        return zlib.decompress(b)

    CODEC = "zlib"

_FRAME_HDR = struct.Struct("<QII")  # step, raw_len, comp_len
# Headerless files are the pre-v1 legacy format, whose first frame was a
# delta from an EXTERNAL initial state: playback needs initial_pos for them.
_REC_MAGIC = b"NBREC\x00\x00\x01"

SHARDED_REC_VERSION = 1


class Recorder:
    """Streams compressed position-delta frames to a file."""

    def __init__(self, path: str | Path, every: int = 10, level: int = 22):
        self.path = Path(path)
        self.every = every
        self.level = level
        self._prev: np.ndarray | None = None
        self._f = open(self.path, "wb")
        self._f.write(_REC_MAGIC)
        self.frames = 0
        self.raw_bytes = 0
        self.comp_bytes = 0

    def maybe_record(self, pos: np.ndarray, step: int) -> bool:
        """Record a frame if this is the first call or ``step % every ==
        0`` (src/main.rs:125); return whether it did."""
        pos = np.asarray(pos, np.float32)
        if self._prev is None or step % self.every == 0:
            self.record(pos, step)
            return True
        return False

    def record(self, pos: np.ndarray, step: int) -> None:
        """Write one delta frame; the first is taken from zeros."""
        pos = np.asarray(pos, np.float32)
        if self._prev is None:
            self._prev = np.zeros_like(pos)
        delta = pos - self._prev
        self._prev = pos.copy()
        raw = delta.tobytes()
        comp = _compress(raw, self.level)
        self._f.write(_FRAME_HDR.pack(step, len(raw), len(comp)))
        self._f.write(comp)
        self.frames += 1
        self.raw_bytes += len(raw)
        self.comp_bytes += len(comp)

    def close(self) -> None:
        self._f.close()


def playback(path: str | Path, initial_pos: np.ndarray | None = None):
    """Yield ``(step, positions)`` from a recording.

    A v1 stream (with the magic) needs no ``initial_pos``. A headerless
    legacy stream raises without one, rather than decode garbage."""
    pos = (None if initial_pos is None
           else np.asarray(initial_pos, np.float32).copy())
    with open(path, "rb") as f:
        head = f.read(len(_REC_MAGIC))
        if head != _REC_MAGIC:
            if pos is None:
                raise ValueError(
                    f"{path}: headerless (legacy) recording — its first "
                    "frame is a delta from an external initial state; "
                    "pass initial_pos")
            f.seek(0)
        while True:
            hdr = f.read(_FRAME_HDR.size)
            if not hdr:
                return
            step, raw_len, comp_len = _FRAME_HDR.unpack(hdr)
            delta = np.frombuffer(_decompress(f.read(comp_len)),
                                  np.float32).reshape(
                                      (-1, 2) if pos is None else pos.shape)
            pos = delta if pos is None else pos + delta
            yield step, pos.copy()


class ShardedRecorder:
    """Per-process position-delta recording of a distributed state.

    ``path`` is a directory: this process writes ``rec_{pid:05d}.bin``, a
    ``Recorder`` stream of its local shards' rows in shard order (padding
    rows included: they sit still and compress to almost nothing), and
    process 0 writes ``manifest.json`` (``version``, ``every``,
    ``n_processes``, ``n_rows``, ``spans``: every process's global row
    ranges, gathered with ``torch.distributed`` where there are several).
    The first frame each process writes is absolute. The cadence is
    ``step % every == 0`` with catch-up: ``maybe_record`` may be called at
    batch boundaries coarser than ``every``, and records once whenever a
    multiple of ``every`` was reached since its last frame; the first call
    sets the first due step, the first multiple at or after its step."""

    def __init__(self, path: str | Path, every: int = 10, level: int = 22):
        from nbody_simulation_tpu_torch.parallel.multihost import (
            process_index)
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.pid = process_index()
        self.every = max(1, every)
        self._next_due: int | None = None
        self._rec = Recorder(self.dir / f"rec_{self.pid:05d}.bin",
                             every=every, level=level)
        self._manifest_done = False

    def _write_manifest(self, n_rows: int, spans) -> None:
        from nbody_simulation_tpu_torch.parallel.multihost import (
            process_count)
        nproc = process_count()
        spans = [(int(a), int(b)) for a, b in spans]
        if nproc == 1:
            all_spans = [spans]
        else:
            import torch.distributed as dist
            all_spans = [None] * nproc
            dist.all_gather_object(all_spans, spans)
        if self.pid == 0:
            man = {"version": SHARDED_REC_VERSION, "every": self.every,
                   "n_processes": nproc, "n_rows": int(n_rows),
                   "spans": [[list(s) for s in proc] for proc in all_spans]}
            tmp = self.dir / "manifest.json.tmp"
            tmp.write_text(json.dumps(man))
            os.replace(tmp, self.dir / "manifest.json")
        self._manifest_done = True

    def maybe_record(self, state, step: int, mesh) -> bool:
        """Record this process's rows of ``state`` (a distributed state on
        ``mesh``) if a multiple of ``every`` was reached since the last
        frame; return whether it did. Every process calls it at the same
        steps (the first frame gathers the manifest's spans)."""
        from nbody_simulation_tpu_torch.parallel.multihost import local_block
        if self._next_due is None:
            self._next_due = -(-step // self.every) * self.every
        if step < self._next_due:
            return False
        block, spans = local_block(state.pos, mesh)
        if not self._manifest_done:
            self._write_manifest(block.shape[0] * mesh.n_shards
                                 // mesh.n_local, spans)
        self._rec.record(block, step)
        self._next_due = (step // self.every + 1) * self.every
        return True

    @property
    def frames(self) -> int:
        return self._rec.frames

    @property
    def raw_bytes(self) -> int:
        return self._rec.raw_bytes

    @property
    def comp_bytes(self) -> int:
        return self._rec.comp_bytes

    def close(self) -> None:
        self._rec.close()


def playback_sharded(path: str | Path):
    """Yield ``(step, global padded positions)`` from a sharded recording
    directory: every process's stream in lockstep, each block scattered
    into the global rows by the manifest's spans. Rows are the padded
    device-major layout of the distributed state; padding rows sit at
    ``PAD_POS``."""
    path = Path(path)
    man = json.loads((path / "manifest.json").read_text())
    if man["version"] != SHARDED_REC_VERSION:
        raise ValueError(f"unsupported recording version {man['version']}")
    spans = man["spans"]
    n_rows = man["n_rows"]
    streams = []
    for pid in range(man["n_processes"]):
        rows = sum(hi - lo for lo, hi in spans[pid])
        streams.append(playback(path / f"rec_{pid:05d}.bin",
                                np.zeros((rows, 2), np.float32)))
    for frames in zip(*streams):
        step = frames[0][0]
        out = np.zeros((n_rows, 2), np.float32)
        for (fstep, block), proc_spans in zip(frames, spans):
            if fstep != step:
                raise ValueError(f"{path}: per-process streams out of "
                                 f"lockstep (step {fstep} against {step})")
            off = 0
            for lo, hi in proc_spans:
                out[lo:hi] = block[off:off + hi - lo]
                off += hi - lo
        yield step, out
