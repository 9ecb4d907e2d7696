"""The step loop: World = state + config + a step function.

The port of ``nbody_simulation_tpu/models/world.py`` (reference
``World::update``, src/main.rs:388-425): force summation followed by
semi-implicit Euler. Accelerations are applied to the particle order they
were computed for (the reference's clone/permute index mismatch, SURVEY.md
§3.2, is not reproduced). torch runs eagerly, so a step is a sequence of
asynchronous launches on the state's device; nothing waits for the device
until the state is read.

The ``pallas`` path (the all-pairs kernels, named after the JAX package's
Pallas kernels) runs the symmetric kernel K2 where N is a multiple of the
symmetric tile and the ordered kernel K1 otherwise.

The Barnes-Hut path keeps the particle arrays in Morton order like the
reference's in-place partition (src/bvh_tree.rs:74-76): a re-sort every
``resort_every`` steps, tree summaries, planner and sweep on every step.
Below θ=2 the summaries carry second moments and the sweep is the
quadrupole kernel K4 (``SimConfig.resolved_multipole``).

On a CUDA device that step is 573-800 small launches, more host time than
device time, so ``World.run`` replays it as a CUDA graph: one graph for a
re-sorting step and one for a stale step, each captured the second time its
variant is due (the first runs eagerly, which warms every lazy
initialisation up), reading and writing static state buffers. A replay
runs the eager step's kernels, so a replayed step is bitwise an eager one.
The CPU, the all-pairs and the direct paths, and ``step_timed``, stay
eager. ``step_timed`` runs the same step as the others, with a timing hook
around each phase that is a no-op everywhere else.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import time

import torch

from nbody_simulation_tpu_torch.config import DEFAULT_CONFIG, SimConfig
from nbody_simulation_tpu_torch.ops.allpairs import (allpairs_accel,
                                                     allpairs_accel_sym)
from nbody_simulation_tpu_torch.ops.force import direct_accel
from nbody_simulation_tpu_torch.ops.integrate import euler_step, leapfrog_step
from nbody_simulation_tpu_torch.ops.morton import morton_sort_state
from nbody_simulation_tpu_torch.ops.traversal import (bh_accel_fn,
                                                      bh_accel_sorted,
                                                      grouped_sweep)
from nbody_simulation_tpu_torch.ops.tree import summarize_sorted
from nbody_simulation_tpu_torch.state import ParticleState
from nbody_simulation_tpu_torch.utils.telemetry import (PhaseTimer,
                                                        StepGraphCounts)

# Host-side launch counters that a step advances. A capture runs the step's
# Python but launches nothing, so it hands its increments back and every
# replay adds them: the counters count the kernels that ran.
LAUNCH_COUNTERS = ((grouped_sweep, "launches"),
                   (grouped_sweep, "quad_launches"))


def make_accel_fn(config: SimConfig):
    """Resolve config.force_path to a ``(pos, mass) -> accel`` function."""
    if config.force_path == "direct":
        return functools.partial(direct_accel, softening2=config.softening2)
    if config.force_path == "bh":
        return bh_accel_fn(config)
    if config.force_path == "pallas":
        ordered = functools.partial(
            allpairs_accel, softening2=config.softening2,
            tile_i=config.tile_i, tile_j=config.tile_j,
            rcp=config.resolved_rcp())
        if not config.sym_allpairs:
            return ordered

        def accel(pos, mass):
            # The symmetric kernel where the tiling admits it (World pads
            # to make it so), the ordered one otherwise: the same law up to
            # f32 summation order (ops/allpairs.allpairs_accel_sym).
            n = pos.shape[0]
            if n % min(config.sym_tile, n):
                return ordered(pos, mass)
            return allpairs_accel_sym(
                pos, mass, softening2=config.softening2,
                tile=config.sym_tile, strips=config.sym_strips,
                rcp=config.resolved_rcp())
        return accel
    raise ValueError(f"unknown force_path {config.force_path!r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CudaStepGraph:
    """One step captured as a CUDA graph; ``replay`` launches it on the
    current stream. Captures given one ``new_pool()`` share its memory and
    its side stream: the caching allocator hands a capture the blocks that
    an earlier one on the same stream freed, so a second graph allocates
    little or nothing (a new allocation costs a ``cudaMalloc``, most of a
    first capture's time). That is safe for graphs replayed one at a time
    on one stream that pass nothing to each other through the pool."""

    device_type = "cuda"

    @staticmethod
    def new_pool(device: torch.device):
        return torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)

    def __init__(self, body, pool, device: torch.device):
        handle, side = pool
        self.graph = torch.cuda.CUDAGraph()
        caller = torch.cuda.current_stream(device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            # thread_local: the engine's other threads may use the card
            # while the producer thread captures.
            self.graph.capture_begin(pool=handle,
                                     capture_error_mode="thread_local")
            try:
                body()
            finally:
                self.graph.capture_end()
        caller.wait_stream(side)

    def replay(self) -> None:
        self.graph.replay()


class World:
    """Host-side handle around a device-resident simulation."""

    def __init__(self, state: ParticleState,
                 config: SimConfig = DEFAULT_CONFIG):
        self.config = config
        # The JAX World's padding, so both packages step identical arrays.
        pad = (max(config.tile_i, config.tile_j,
                   config.sym_tile if config.sym_allpairs else 0)
               if config.force_path == "pallas" else 256)
        self.state = state.pad_to(pad)
        self.updates = 0
        self.graph_counts = StepGraphCounts()
        self._timing = None  # (Counting, device) inside step_timed
        self._drop_graphs()
        self._build_step(config)

    def reconfigure(self, **changes) -> None:
        """Swap runtime knobs (theta, dt, integrator, ...) mid-simulation —
        the live version of the reference's recompile-to-tune consts
        (src/main.rs:31-35). The state and step counter carry over. Call it
        from the thread that steps the world (the engine applies it at batch
        boundaries)."""
        self.config = self.config.replace(**changes)
        self._drop_graphs()
        self._build_step(self.config)

    def _build_step(self, config: SimConfig) -> None:
        if config.force_path == "bh":
            self._step = self._bh_step
            return
        accel = make_accel_fn(config)

        def force(pos, mass):
            with self._phase("sum_gravity"):
                return accel(pos, mass)
        self._step = lambda st: self._integrate(st, force)

    @contextlib.contextmanager
    def _phase(self, name: str):
        """The timing hook around each phase of a step: inside
        ``step_timed`` it adds the phase's wall time, up to a device sync
        at its end, to ``counting.<name>``; elsewhere, a graph capture
        included, it neither syncs nor times."""
        if self._timing is None:
            yield
            return
        counting, device = self._timing
        with PhaseTimer(counting, name):
            yield
            _sync(device)

    def _integrate(self, st: ParticleState, force) -> ParticleState:
        """``config.integrator`` over ``force`` (``(pos, mass) -> accel``).
        ``euler_step`` is looked up in this module when the step runs."""
        cfg = self.config
        if cfg.integrator == "leapfrog":
            return leapfrog_step(st, force, cfg.dt,
                                 lambda: self._phase("post_calculations"))
        acc = force(st.pos, st.mass)
        with self._phase("post_calculations"):
            return euler_step(st, acc, cfg.dt)

    def _bh_force(self, spos: torch.Tensor,
                  smass: torch.Tensor) -> torch.Tensor:
        """Tree summaries, planner and sweep: the accelerations of the
        Morton-ordered particles."""
        cfg = self.config
        with self._phase("build_bvh"):
            tree = summarize_sorted(
                spos, smass, leaf_size=cfg.leaf_size,
                unweighted_leaf_com=cfg.unweighted_leaf_com,
                quad=cfg.resolved_multipole() == 2)
        fcap, lcap = cfg.resolved_caps()
        with self._phase("sum_gravity"):
            acc = bh_accel_sorted(tree, theta=cfg.theta,
                                  softening2=cfg.softening2,
                                  frontier_cap=fcap, leaf_cap=lcap,
                                  arity=cfg.tree_arity,
                                  plan_leaves=cfg.plan_leaves,
                                  multipole=cfg.resolved_multipole(),
                                  rcp=cfg.resolved_rcp(bh=True))
            return acc[:spos.shape[0]]

    def _resort_due(self) -> bool:
        return self.updates % max(self.config.resort_every, 1) == 0

    def _bh_step(self, st: ParticleState) -> ParticleState:
        return self._bh_advance(st, resort=self._resort_due())

    def _bh_advance(self, st: ParticleState, resort: bool) -> ParticleState:
        """The Barnes-Hut step: a Morton re-sort if ``resort``, else a step
        in the current (stale) order, then the integrator over
        ``_bh_force``."""
        if resort:
            cfg = self.config
            with self._phase("build_bvh"):
                pos, vel, mass = morton_sort_state(
                    st.pos, st.vel, st.mass, cfg.world_size,
                    bits=cfg.resolved_morton_bits())
            st = st.replace(pos=pos, vel=vel, mass=mass)
        return self._integrate(st, self._bh_force)

    # -- fast path ------------------------------------------------------------
    def step(self) -> None:
        self.run(1)

    def run(self, n_steps: int) -> None:
        """``n_steps`` steps, launched back to back without a sync. On the
        Barnes-Hut path on a CUDA device a step whose variant is captured
        is one graph replay, and ``self.state`` ends as a copy of the static
        buffers, made once, that later steps leave as it is."""
        if not self._graphed():
            for _ in range(n_steps):
                self.state = self._step(self.state)
                self.updates += 1  # per step: the BH path branches on it
            self.graph_counts.eager += max(n_steps, 0)
            return
        for _ in range(n_steps):
            self._graph_step()
            self.updates += 1
        s = self._static
        if s is not None and self.state.pos is s.pos:
            self.state = self._static_holds = self.state.replace(
                pos=s.pos.clone(), vel=s.vel.clone(), mass=s.mass.clone())

    # -- step graphs ----------------------------------------------------------
    step_graph = CudaStepGraph

    def _graphed(self) -> bool:
        return (self.config.force_path == "bh"
                and self.state.device.type == self.step_graph.device_type)

    def _drop_graphs(self) -> None:
        """Forget both graphs, their pool and the static buffers: each
        variant runs eagerly once more before it is captured again."""
        self._graphs = {}
        self._warmed = set()
        self._pool = None
        self._static = None
        self._static_holds = None  # the state whose values _static holds

    def _graph_step(self) -> None:
        st, s = self.state, self._static
        if s is not None and any(
                a.shape != b.shape or a.dtype != b.dtype
                or a.device != b.device
                for a, b in ((st.pos, s.pos), (st.vel, s.vel),
                             (st.mass, s.mass))):
            self._drop_graphs()
            s = None
        resort = self._resort_due()
        if resort not in self._warmed:
            self._warmed.add(resort)
            self.state = self._bh_step(st)
            self.graph_counts.eager += 1
            return
        if s is None:
            s = self._static = ParticleState(
                torch.empty_like(st.pos), torch.empty_like(st.vel),
                torch.empty_like(st.mass), st.n_real)
        if st is not self._static_holds:
            # Replaced since the last replay: a profiled step, a load, an
            # assignment, or a variant's eager first step.
            s.pos.copy_(st.pos)
            s.vel.copy_(st.vel)
            s.mass.copy_(st.mass)
        graph = self._graphs.get(resort)
        if graph is None:
            graph = self._graphs[resort] = self._capture()
        graph.replay()
        for c, n in graph.launches.items():
            setattr(*c, getattr(*c) + n)
        self.state = self._static_holds = st.replace(
            pos=s.pos, vel=s.vel, mass=s.mass)
        self.graph_counts.replayed += 1

    def _capture(self):
        """Capture the step due now (its variant follows ``self.updates``)
        from and into the static buffers."""
        s = self._static

        def body():
            out = self._bh_step(s)
            for dst, src in ((s.pos, out.pos), (s.vel, out.vel),
                             (s.mass, out.mass)):
                if src is not dst:
                    dst.copy_(src)

        if self._pool is None:
            self._pool = self.step_graph.new_pool(s.device)
        before = {c: getattr(*c) for c in LAUNCH_COUNTERS}
        t0 = time.perf_counter()
        # A collection inside the capture could free the graphs of a World
        # kept by a reference cycle, a call that invalidates the capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            graph = self.step_graph(body, self._pool, s.device)
        finally:
            if collecting:
                gc.enable()
        self.graph_counts.capture_s += time.perf_counter() - t0
        self.graph_counts.captured += 1
        graph.launches = {c: getattr(*c) - n for c, n in before.items()}
        for c, n in before.items():
            setattr(*c, n)
        return graph

    def diagnostics(self) -> dict:
        """Conserved-quantity diagnostics (0-dim tensors; same keys as the
        JAX package). Zero-mass padding is inert in every sum."""
        pos, vel, mass = self.state.pos, self.state.vel, self.state.mass
        m = mass[:, None]
        mtot = mass.sum()
        return {
            "momentum": (vel * m).sum(dim=0),
            "kinetic_energy": (0.5 * mass * (vel ** 2).sum(-1)).sum(),
            "total_mass": mtot,
            "center_of_mass": (pos * m).sum(dim=0) / mtot,
            "n_live": (mass > 0).sum(dtype=torch.int32),
        }

    # -- failure detection ----------------------------------------------------
    def assert_finite(self) -> None:
        """Divergence guard: raises on non-finite live positions."""
        pos = self.state.pos[:self.state.n_real]
        finite = torch.isfinite(pos).all(dim=1)
        if not bool(finite.all()):
            bad = int((~finite).sum())
            raise FloatingPointError(
                f"simulation diverged: {bad} particles non-finite at "
                f"step {self.updates}")

    # -- profile path ---------------------------------------------------------
    def step_timed(self, counting) -> None:
        """One step with a device sync after each phase, accumulating
        Counting like the reference's per-phase timers (src/main.rs:402,
        417, 424): build_bvh = Morton sort + tree summaries (0 off the
        Barnes-Hut path), sum_gravity = planner + sweep or the all-pairs
        force, post_calculations = integration. This step always re-sorts,
        as the JAX package's does.

        It is the step ``World.step`` takes, bit for bit, timed through
        ``_phase``; under leapfrog that is two force evaluations, each
        timed. This departs from the JAX ``step_timed``, which runs Euler
        on the "pallas" and "direct" paths whatever the integrator (its own
        test states the intent that a profiled step run the same
        integrator)."""
        st = self.state
        # The phases time this step alone: work still queued (the engine
        # enqueues a batch ahead of its host work) finishes first.
        _sync(st.device)
        self._timing = (counting, st.device)
        try:
            self.state = (self._bh_advance(st, resort=True)
                          if self.config.force_path == "bh"
                          else self._step(st))
        finally:
            self._timing = None
        self.updates += 1
        self.graph_counts.eager += 1
