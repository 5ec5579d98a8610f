"""Property-style fuzz of the family-I LiDAR-avoidance closed loop.

The escape-law fuzz suite (test_escape_fuzz.py) covers the pairwise
collision class; this does the same for family I: the v4 formulation
(augmented ray state frozen at stage 0, d >= robot_radius bound, 1/d
proximity cost, Nc move blocking — obs_avoid_static_first_scenario_v4.py)
navigating RANDOMIZED obstacle fields it was never hand-tuned on.

Attribution measured first: on random fields the loop
sometimes STALLS short of the goal at a healthy standoff (clearance
0.22-0.32, far above the 0.15 keep-out). The stalls survive a 2-3x
stronger GN budget (n_gn 10->20, n_outer 6->8, tol_con 1e-3->1e-4:
3 of 4 sampled stalls reproduce at identical positions, one resolves),
so they are predominantly a property of the myopic formulation — the
frozen-pObs ray model cannot plan around what its 36-deg-spaced rays
see as a wall, and the 1/d barrier balances the goal gradient — the
same class as the eight-robot N=5 standoff the oracle confirmed in
docs/CL_PARITY.md. Family I has no escape law, so the honest invariants
are a DICHOTOMY per seed:

  1. SAFETY (every seed) — true surface clearance stays above a floor.
     The floor (0.10) is below the 0.15 ray bound: 10 rays strike
     obliquely, so planned ray distance overstates perpendicular
     clearance by a discretization margin (completers measure min 0.157
     across both classes); an actual keep-out breach realizes near 0.
  2. ACTUATION (every seed) — controls inside the published v4 box.
  3. NO STATIONARY STALL INSIDE THE KEEP-OUT — an incomplete seed is
     either a stationary standoff (<= 5 cm of motion over the last 100
     steps), which must sit at clearance >= the ray bound, or still en
     route at the horizon (a slow detour — CPU's rounding takes the
     gauntlet's seed-2 crossing at ~2 mm/step), which the global
     clearance floor already covers.
  4. COMPLETION FLOOR (per class) — at least 6/10 single-obstacle and
     1/6 two-obstacle seeds complete (measured 8/10 and 2/6; a law or
     solver regression that strands everything fails loudly).

Geometry: one goal 1.0-1.3 m away in a random direction; obstacles
(r in [0.08, 0.14]) dropped at 35-65% of the straight start->goal line
with perpendicular offset jitter — the class the reference's first
scenario instantiates once by hand.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nmpc_tpu.mpc.lidar import closed_loop_lidar
from nmpc_tpu.scenarios import get
from nmpc_tpu.solver import gn

N = 40
CFG = gn.GNConfig(Nc=20, n_gn=10, n_outer=6, tol_con=1e-3)
MAX_STEPS = 600
FAR = np.array([50.0, 50.0, 0.01], np.float32)  # disabled obstacle slot


def _random_field(seed: int, n_obs: int):
    """Goal + n_obs circles near the straight-line path (2 slots, unused
    slots pushed out of sensor range). frac in [0.35, 0.65] of a >= 1.0 m
    path keeps both endpoints >= 0.35 m from every obstacle center."""
    rng = np.random.default_rng(seed)
    bearing = rng.uniform(-np.pi, np.pi)
    dist = rng.uniform(1.0, 1.3)
    goal = np.array([dist * np.cos(bearing), dist * np.sin(bearing), 0.0])
    perp = np.array([-goal[1], goal[0]]) / dist
    obs = []
    for frac in rng.uniform(0.35, 0.65, n_obs):
        off = rng.uniform(-0.18, 0.18)
        c = frac * goal[:2] + off * perp
        obs.append([c[0], c[1], rng.uniform(0.08, 0.14)])
    while len(obs) < 2:
        obs.append(FAR)
    return goal.astype(np.float32), np.asarray(obs, np.float32)


def _run(seeds, n_obs):
    sc = get("lidar_v4")
    ocp = sc.make(N=N)
    geoms = [_random_field(s, n_obs) for s in seeds]
    goals = jnp.stack([jnp.asarray(g[0])[None] for g in geoms])
    obstacles = jnp.stack([jnp.asarray(g[1]) for g in geoms])
    fn = jax.jit(jax.vmap(lambda obs, wps: closed_loop_lidar(
        ocp, sim_obstacles=obs, waypoints=wps, cfg=CFG,
        max_steps=MAX_STEPS)))
    return fn(obstacles, goals)


def _check(seeds, out, min_complete):
    X, U, clr, gidx, done = out
    n_done = int(np.asarray(done).sum())
    assert n_done >= min_complete, (
        f"only {n_done}/{len(seeds)} tours completed (floor {min_complete})")
    for i, s in enumerate(seeds):
        mc = float(jnp.min(clr[i]))
        assert mc >= 0.10, f"seed {s}: surface clearance {mc:.3f}"
        Ui = np.asarray(U[i])
        assert np.abs(Ui[:, 0]).max() <= 0.15 + 1e-3, s
        assert np.abs(Ui[:, 1]).max() <= 1.5 + 1e-3, s
        if not bool(done[i]):
            # incomplete seeds split into two legitimate outcomes: a
            # STATIONARY standoff (the formulation-property stall — must
            # sit OUTSIDE the keep-out) or still en route at the horizon
            # (a slow detour, e.g. 2 mm/step on CPU's crossing of the
            # gauntlet seed 2 — safety is the global clearance floor
            # above). What may NOT happen is a stationary stall inside
            # the ring.
            Xi = np.asarray(X[i])
            drift = float(np.hypot(*(Xi[-1, :2] - Xi[-100, :2])))
            if drift <= 0.05:
                tail_clr = float(np.asarray(clr[i])[-1])
                assert tail_clr >= 0.15, (
                    f"seed {s}: stationary stall INSIDE the keep-out "
                    f"({tail_clr:.3f})")


@pytest.mark.slow
def test_lidar_fuzz_single_obstacle():
    """Reference-like class (one circle near the line): most seeds must
    complete; the rest must stall safely (see module docstring)."""
    seeds = tuple(range(10))
    _check(seeds, _run(seeds, n_obs=1), min_complete=6)


@pytest.mark.slow
def test_lidar_fuzz_two_obstacle_gauntlet():
    """Adversarial class (two circles forming gates/walls): safety and
    safe-stall invariants for every seed; completion floor 1/6."""
    seeds = (0, 1, 2, 3, 4, 5)
    _check(seeds, _run(seeds, n_obs=2), min_complete=1)
