"""The plain reference of the exact all-pairs path: direct summation over
every pair, semi-implicit Euler and the total energy, written again in plain
PyTorch.

It imports nothing of the port and nothing of the JAX package (of
``reference`` it takes the f32 limits and dt's rounding). What it follows:

- The pair law of the reference program (src/main.rs:234-253), as
  ``reference._law`` states it: a source j pulls target i by
  m_j·d / (|d|₁ · max(|d|², ε)), d = p_j − p_i, ε the configuration's
  ``softening2``; a pair whose |d|₁ is zero, subnormal, infinite or NaN
  in float32 (the reference's ``is_normal`` guard) adds nothing, which
  leaves out each row's pair with itself.
- Every pair summed, no approximation. A row of zero mass (the padding the
  world adds) pulls nothing: its column is weighted by its mass, 0.
- Semi-implicit Euler on float32 states with dt rounded to float32, as
  ``reference.run_steps`` integrates them: v += a·dt, then p += v·dt.
- The total energy of the law's conservative counterpart, as the port's
  energy diagnostics define it: E = Σ ½ m_i |v_i|² + Σ over pairs i < j of
  −m_i·m_j / sqrt(max(|d|², ε)), each pair masked by the same guard on
  |d|₁ as the force.

Departures from the published description, for speed on the card: the pair
terms (d, |d|₁, the clamped |d|², the kernel 1/(|d|₁·max(|d|², ε)), the
pair potential) are computed in float32 from the float32 states, as the
reference program's f32 arithmetic does, and summed in float64, in blocks
of ``BLOCK`` targets by ``BLOCK`` sources. The law's kernel is the same for
d and −d, so each block of pairs i < j is computed once and added to both
sides (Newton's third law, which this law keeps exactly: the f32 difference
p_i − p_j is −(p_j − p_i) to the bit). Block sums are matrix-vector
products; TF32 is turned off for them. ``Precision`` also gives the
control: everything in bfloat16.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.lib.reference import FLT_MAX, FLT_MIN_NORMAL, f32_dt

BLOCK = 4096


@dataclasses.dataclass(frozen=True)
class Precision:
    """``state``: positions and velocities; ``law``: the pair terms;
    ``sums``: every sum over pairs and rows."""
    state: torch.dtype = torch.float32
    law: torch.dtype = torch.float32
    sums: torch.dtype = torch.float64


REFERENCE = Precision()
CONTROL = Precision(torch.bfloat16, torch.bfloat16, torch.bfloat16)


def _full_precision_products() -> None:
    """Matrix products in the precision of their inputs (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _blocks(n: int, block: int):
    """The pairs of target and source blocks (i0, i1, j0, j1), j0 ≥ i0."""
    starts = range(0, n, block)
    return [(i0, min(i0 + block, n), j0, min(j0 + block, n))
            for i0 in starts for j0 in starts if j0 >= i0]


def _separation(p, i0, i1, j0, j1):
    """d = p_j − p_i over the block (i rows, j columns), |d|₁, and whether
    |d|₁ is a normal number of the law's precision."""
    dx = p[None, j0:j1, 0] - p[i0:i1, 0, None]
    dy = p[None, j0:j1, 1] - p[i0:i1, 1, None]
    s = dx.abs() + dy.abs()
    normal = (s >= FLT_MIN_NORMAL) & (s <= FLT_MAX)
    return dx, dy, s, normal


def accel(pos: torch.Tensor, mass: torch.Tensor, softening2: float,
          prec: Precision = REFERENCE, block: int = BLOCK) -> torch.Tensor:
    """(N, 2) accelerations, in ``prec.sums``, of every row from every
    other row."""
    _full_precision_products()
    p = pos.to(prec.law)
    m = mass.to(prec.sums)
    n = p.shape[0]
    acc = torch.zeros((n, 2), dtype=prec.sums, device=p.device)
    zero = torch.zeros((), dtype=prec.law, device=p.device)
    for i0, i1, j0, j1 in _blocks(n, block):
        dx, dy, s, normal = _separation(p, i0, i1, j0, j1)
        d2 = torch.clamp_min(dx * dx + dy * dy, softening2)
        k = torch.where(normal, 1.0 / (s * d2), zero)
        for c, d in enumerate((dx, dy)):
            f = (d * k).to(prec.sums)          # d·k, the pair's pull per mass
            acc[i0:i1, c] += f @ m[j0:j1]
            if j0 != i0:                      # the same pairs, seen from j
                acc[j0:j1, c] -= m[i0:i1] @ f
    return acc


def potential(pos: torch.Tensor, mass: torch.Tensor, softening2: float,
              prec: Precision = REFERENCE, block: int = BLOCK):
    """U = Σ over pairs i < j of −m_i·m_j / sqrt(max(|d|², ε)), in
    ``prec.sums``."""
    _full_precision_products()
    p = pos.to(prec.law)
    m = mass.to(prec.sums)
    u = torch.zeros((), dtype=prec.sums, device=p.device)
    zero = torch.zeros((), dtype=prec.law, device=p.device)
    for i0, i1, j0, j1 in _blocks(p.shape[0], block):
        dx, dy, _, normal = _separation(p, i0, i1, j0, j1)
        d2 = torch.clamp_min(dx * dx + dy * dy, softening2)
        phi = torch.where(normal, -torch.rsqrt(d2), zero).to(prec.sums)
        pair = m[i0:i1] @ phi @ m[j0:j1]
        # A diagonal block holds each of its pairs twice.
        u += pair if j0 != i0 else 0.5 * pair
    return u


def kinetic(vel: torch.Tensor, mass: torch.Tensor,
            prec: Precision = REFERENCE):
    v = vel.to(prec.sums)
    return 0.5 * (mass.to(prec.sums) * (v * v).sum(1)).sum()


def total_energy(pos, vel, mass, softening2: float,
                 prec: Precision = REFERENCE) -> float:
    """E = KE + U of a state."""
    return float(kinetic(vel, mass, prec)
                 + potential(pos, mass, softening2, prec))


def run_steps(pos, vel, mass, steps: int, sim: dict,
              prec: Precision = REFERENCE):
    """``steps`` semi-implicit Euler steps under exact all-pairs forces;
    returns (pos, vel) in ``prec.state``."""
    dt = f32_dt(sim.get("dt", 0.1))
    soft2 = float(sim.get("softening2", 1e-3))
    pos, vel = pos.to(prec.state), vel.to(prec.state)
    for _ in range(steps):
        a = accel(pos, mass, soft2, prec)
        vel = vel + a.to(prec.state) * dt
        pos = pos + vel * dt
    return pos, vel
