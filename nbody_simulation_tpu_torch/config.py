"""Simulation configuration — the same knobs as the JAX package.

Field names, defaults and the ``resolved_*`` rules are identical to
``nbody_simulation_tpu/config.py`` (tests/test_torch_port_basics.py holds
them equal field by field); that module documents why each default was
chosen. The defaults are the reference's compile-time consts (reference
src/main.rs:31-35, src/bvh_tree.rs:37).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

ForcePath = Literal["direct", "pallas", "bh", "ring"]

# Reciprocal/guard modes of the force kernels. "+clamp" swaps the
# reference's is_normal skip (src/main.rs:240-243) for an L1 clamp —
# bitwise-identical on finite states. There is no "exact+clamp".
RCP_MODES = ("exact", "newton", "approx", "newton+clamp", "approx+clamp")


def check_rcp(rcp: str) -> int:
    """Raise ValueError unless ``rcp`` is one of RCP_MODES; return its
    index, the kernels' mode code (``Mode`` in csrc/pair_law.cuh)."""
    if rcp not in RCP_MODES:
        raise ValueError(f"rcp must be one of {RCP_MODES}, got {rcp!r}")
    return RCP_MODES.index(rcp)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    # World / render geometry (src/main.rs:31-32).
    world_size: float = 100_000.0
    render_size: int = 1250

    # Integration (src/main.rs:34): "euler" is the reference's
    # semi-implicit Euler, "leapfrog" kick-drift-kick.
    dt: float = 0.1
    integrator: str = "euler"

    # Barnes-Hut acceptance: max(w,h)^2 < d2 * theta^2 (src/main.rs:35).
    theta: float = 50.0

    # BVH leaf size (src/bvh_tree.rs:37).
    leaf_size: int = 64

    # Squared-distance softening clamp (src/main.rs:247-249).
    softening2: float = 1e-3

    # Which force path World.step uses.
    force_path: ForcePath = "pallas"

    # BH path: Morton re-sort every k-th step; tree summaries are rebuilt
    # from current positions every step regardless.
    resort_every: int = 16

    # Reference quirk (src/bvh_tree.rs:98-116): a leaf's COM is the
    # unweighted mean of its particle positions.
    unweighted_leaf_com: bool = True

    # All-pairs tile sizes and reciprocal mode. rcp=None resolves per path.
    tile_i: int = 512
    tile_j: int = 2048
    rcp: str | None = None

    # Symmetric third-law all-pairs kernel (K2) for force_path="pallas";
    # sym_tile and sym_strips keep the JAX package's divisibility rules.
    sym_allpairs: bool = True
    sym_tile: int = 1024
    sym_strips: int = 4

    def resolved_rcp(self, bh: bool = False) -> str:
        if self.rcp is not None:
            return self.rcp
        if bh:
            return "approx" if self.theta >= 2.0 else "newton"
        return "newton"

    # BH planner capacities: frontier slots per level and leaf-list slots
    # per planning row. None resolves from θ. Overflow falls back to COM on
    # the farthest opened nodes; force is never dropped.
    frontier_cap: int | None = None
    leaf_cap: int | None = None

    def resolved_caps(self) -> tuple[int, int]:
        pl = max(1, self.plan_leaves)
        f = self.frontier_cap if self.frontier_cap is not None else (
            16 if self.theta >= 2.0 else 256)
        l = self.leaf_cap if self.leaf_cap is not None else (
            max(8, 4 * pl) if self.theta >= 2.0 else max(256, 32 * pl))
        return f, l

    # Morton key depth per axis: 15 (one int32 key) for θ≥2, 24 (two words)
    # below.
    morton_bits: int | None = None

    def resolved_morton_bits(self) -> int:
        if self.morton_bits is not None:
            return self.morton_bits
        return 15 if self.theta >= 2.0 else 24

    # Multipole order of accepted-node forces: 1 = COM monopole (sweep
    # kernel K3), 2 = plus the quadrupole correction (sweep kernel K4).
    multipole: int | None = None

    def resolved_multipole(self) -> int:
        if self.multipole is not None:
            return self.multipole
        return 1 if self.theta >= 2.0 else 2

    # Planner fan-out: 2 walks the binary BVH one level at a time, 4 walks
    # two levels at once.
    tree_arity: int = 2

    # Planning granularity: one planner row (one sweep group) covers this
    # many adjacent leaves.
    plan_leaves: int = 4

    # The JAX package's occupancy-bucketed sweep budgets (block_frac,
    # col_frac), or None. Inert here, kept for field parity: the GPU sweep
    # always stops each group at its last nonzero-mass column
    # (ops/traversal.bh_accel_sorted), bitwise the full sweep's result.
    sweep_buckets: tuple | None = None

    # Distributed-BH knobs (parallel/bh_distributed.py): the far stages'
    # caps in ring mode, "ring" or "forest" (the default), the forest's
    # gathered levels, and the near stages' refinement (``near_remote``:
    # the compute-to-data exchange).
    far_frontier_cap: int | None = None
    far_leaf_cap: int | None = None
    far_mode: str | None = None
    forest_levels: int = 6

    def resolved_far_mode(self) -> str:
        if self.far_mode is not None:
            return self.far_mode
        return "forest"

    near_refine_levels: int | None = None
    near_rows: int | None = None

    def resolved_near_refine(self) -> int:
        if self.near_refine_levels is not None:
            return self.near_refine_levels
        return 1 if self.theta >= 2.0 else 0

    near_remote: bool = True

    # Heavy-particle render threshold (src/main.rs:55-59).
    heavy_weight: float = 10.0

    @property
    def pixels_per_world(self) -> int:
        """Integer world-units-per-pixel scale (src/main.rs:51-52)."""
        return int(self.world_size) // self.render_size

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SimConfig()
