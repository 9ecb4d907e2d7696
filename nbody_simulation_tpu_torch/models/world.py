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
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nbody_simulation_tpu_torch.config import DEFAULT_CONFIG, SimConfig
from nbody_simulation_tpu_torch.ops.allpairs import (allpairs_accel,
                                                     allpairs_accel_sym)
from nbody_simulation_tpu_torch.ops.force import direct_accel
from nbody_simulation_tpu_torch.ops.integrate import euler_step, leapfrog_step
from nbody_simulation_tpu_torch.ops.morton import morton_sort_state
from nbody_simulation_tpu_torch.ops.traversal import (bh_accel_fn,
                                                      bh_accel_sorted)
from nbody_simulation_tpu_torch.ops.tree import summarize_sorted
from nbody_simulation_tpu_torch.state import ParticleState
from nbody_simulation_tpu_torch.utils.telemetry import PhaseTimer


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
        self._build_step(config)

    def reconfigure(self, **changes) -> None:
        """Swap runtime knobs (theta, dt, integrator, ...) mid-simulation —
        the live version of the reference's recompile-to-tune consts
        (src/main.rs:31-35). The state and step counter carry over. Call it
        from the thread that steps the world (the engine applies it at batch
        boundaries)."""
        self.config = self.config.replace(**changes)
        self._build_step(self.config)

    def _build_step(self, config: SimConfig) -> None:
        if config.force_path == "bh":
            self._step = self._bh_step
            self._accel = bh_accel_fn(config)
            return
        accel = make_accel_fn(config)
        self._accel = accel
        if config.integrator == "leapfrog":
            self._step = lambda st: leapfrog_step(st, accel, config.dt)
        else:
            self._step = lambda st: euler_step(
                st, accel(st.pos, st.mass), config.dt)

    def _summaries(self, spos: torch.Tensor, smass: torch.Tensor):
        cfg = self.config
        return summarize_sorted(spos, smass, leaf_size=cfg.leaf_size,
                                unweighted_leaf_com=cfg.unweighted_leaf_com,
                                quad=cfg.resolved_multipole() == 2)

    def _sweep(self, tree, n: int) -> torch.Tensor:
        """Planner + sweep: accelerations of the first ``n`` Morton-ordered
        particles."""
        cfg = self.config
        fcap, lcap = cfg.resolved_caps()
        return bh_accel_sorted(tree, theta=cfg.theta,
                               softening2=cfg.softening2,
                               frontier_cap=fcap, leaf_cap=lcap,
                               arity=cfg.tree_arity,
                               plan_leaves=cfg.plan_leaves,
                               multipole=cfg.resolved_multipole(),
                               rcp=cfg.resolved_rcp(bh=True))[:n]

    def _bh_force(self, spos: torch.Tensor,
                  smass: torch.Tensor) -> torch.Tensor:
        return self._sweep(self._summaries(spos, smass), spos.shape[0])

    def _bh_step(self, st: ParticleState) -> ParticleState:
        """Re-sort on ``updates % resort_every == 0``, else step in the
        current (stale) Morton order."""
        cfg = self.config
        if self.updates % max(cfg.resort_every, 1) == 0:
            spos, svel, smass = morton_sort_state(
                st.pos, st.vel, st.mass, cfg.world_size,
                bits=cfg.resolved_morton_bits())
        else:
            spos, svel, smass = st.pos, st.vel, st.mass
        dt = float(np.float32(cfg.dt))
        if cfg.integrator == "leapfrog":
            half = float(np.float32(dt) * np.float32(0.5))
            v_half = svel + self._bh_force(spos, smass) * half
            pos = spos + v_half * dt
            vel = v_half + self._bh_force(pos, smass) * half
        else:
            vel = svel + self._bh_force(spos, smass) * dt
            pos = spos + vel * dt
        return st.replace(pos=pos, vel=vel, mass=smass)

    # -- fast path ------------------------------------------------------------
    def step(self) -> None:
        self.state = self._step(self.state)
        self.updates += 1

    def run(self, n_steps: int) -> None:
        """``n_steps`` steps, launched back to back without a sync."""
        for _ in range(n_steps):
            self.state = self._step(self.state)
            self.updates += 1  # per step: the BH path branches on it

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
        417, 424): build_bvh = Morton sort + tree summaries (0 for direct),
        sum_gravity = planner + sweep, post_calculations = integration.
        This step always re-sorts, as the JAX package's does.

        Every path runs ``config.integrator``, so a profiled step is the
        step ``World.step`` takes, bit for bit; under leapfrog that is two
        force evaluations, each timed under sum_gravity. This departs from
        the JAX ``step_timed``, which runs Euler on the "pallas" and
        "direct" paths whatever the integrator (its own test states the
        intent that a profiled step run the same integrator)."""
        cfg = self.config
        st = self.state
        dev = st.device
        if cfg.force_path != "bh":
            with PhaseTimer(counting, "sum_gravity"):
                accel = self._accel(st.pos, st.mass)
                _sync(dev)
            if cfg.integrator == "leapfrog":
                # leapfrog_step, phase by phase.
                dt32 = np.float32(cfg.dt)
                half = float(np.float32(0.5) * dt32)
                with PhaseTimer(counting, "post_calculations"):
                    v_half = st.vel + accel * half
                    pos = st.pos + v_half * float(dt32)
                    _sync(dev)
                with PhaseTimer(counting, "sum_gravity"):
                    accel2 = self._accel(pos, st.mass)
                    _sync(dev)
                with PhaseTimer(counting, "post_calculations"):
                    self.state = st.replace(pos=pos,
                                            vel=v_half + accel2 * half)
                    _sync(dev)
            else:
                with PhaseTimer(counting, "post_calculations"):
                    self.state = euler_step(st, accel, cfg.dt)
                    _sync(dev)
            self.updates += 1
            return

        with PhaseTimer(counting, "build_bvh"):
            spos, svel, smass = morton_sort_state(
                st.pos, st.vel, st.mass, cfg.world_size,
                bits=cfg.resolved_morton_bits())
            tree = self._summaries(spos, smass)
            _sync(dev)
        with PhaseTimer(counting, "sum_gravity"):
            accel = self._sweep(tree, st.n)
            _sync(dev)
        if cfg.integrator == "leapfrog":
            dt = float(np.float32(cfg.dt))
            half = float(np.float32(dt) * np.float32(0.5))
            with PhaseTimer(counting, "post_calculations"):
                v_half = svel + accel * half
                spos2 = spos + v_half * dt
                _sync(dev)
            with PhaseTimer(counting, "build_bvh"):
                tree2 = self._summaries(spos2, smass)
                _sync(dev)
            with PhaseTimer(counting, "sum_gravity"):
                accel2 = self._sweep(tree2, st.n)
                _sync(dev)
            with PhaseTimer(counting, "post_calculations"):
                vel2 = v_half + accel2 * half
                self.state = st.replace(pos=spos2, vel=vel2, mass=smass)
                _sync(dev)
        else:
            with PhaseTimer(counting, "post_calculations"):
                self.state = euler_step(
                    st.replace(pos=spos, vel=svel, mass=smass), accel, cfg.dt)
                _sync(dev)
        self.updates += 1
