"""Closed-loop MPC driver tests (L4+L5): the reference's Gazebo runs as
on-device simulations (SURVEY.md §4 point 2-3)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nmpc_tpu.mpc.driver import (
    MPCConfig,
    closed_loop,
    closed_loop_tracking,
    closed_loop_waypoints,
    plan_then_replay,
    shift_warm,
)
from nmpc_tpu.ocp.problem import make_ocp
from nmpc_tpu.scenarios import get
from nmpc_tpu.solver.alilqr import ALILQRConfig, solve

FAST = ALILQRConfig(n_outer=10, n_inner=20, tol_con=1e-4)


def test_shift_semantics():
    # shift(): u0 <- [u[1:]; u[-1]] (six-robot file :90-99)
    ocp = make_ocp(m=1, N=5, T=0.1, x0=[0, 0, 0], x_goal=[1, 1, 0])
    res = jax.jit(functools.partial(solve, cfg=FAST))(ocp)
    w = shift_warm(res, FAST)
    np.testing.assert_allclose(w.U[:-1], res.U[1:], rtol=1e-6)
    np.testing.assert_allclose(w.U[-1], res.U[-1], rtol=1e-6)


def test_single_robot_point_stabilization():
    # mpc_online_casadi.py closed loop: stop at ||x-xs|| <= 5e-2 (:168).
    # T=0.1/N=25 variant of the config for CPU test speed (the T=0.01 original
    # needs >2000 steps just to cover the distance; exercised in the slow test)
    sc = get("single_robot")
    ocp = sc.make(N=25, T=0.1)
    mpc = MPCConfig(max_steps=300, stop_tol=5e-2, escape=True)
    r = jax.jit(functools.partial(closed_loop, solver_cfg=FAST, mpc=mpc))(ocp)
    assert bool(r.reached)
    x_final = np.array(r.X_hist[-1])
    assert np.linalg.norm(x_final - np.array([1.0, 1.5, 0.0])) <= 5e-2 + 1e-6


@pytest.mark.slow
def test_single_robot_reference_config():
    # the exact mpc_online_casadi.py config (T=0.01, N=50), parking escape on
    sc = get("single_robot")
    ocp = sc.make()
    mpc = MPCConfig(max_steps=2500, stop_tol=5e-2, escape=True)
    r = jax.jit(functools.partial(closed_loop, solver_cfg=FAST, mpc=mpc))(ocp)
    assert bool(r.reached)


def test_two_robot_swap_closed_loop_collision_free():
    sc = get("two_robot_swap")
    # reference horizon N=100 at T=0.02; shrink steps via T=0.1/N=25 variant
    # to keep the CPU test fast while preserving the swap geometry
    ocp = sc.make(N=25, T=0.1)
    mpc = MPCConfig(max_steps=250, stop_tol=1e-1, escape=True)
    r = jax.jit(functools.partial(closed_loop, solver_cfg=FAST, mpc=mpc))(ocp)
    assert bool(r.reached)
    assert float(np.min(np.array(r.min_dist_hist))) >= 0.25 - 5e-3


@pytest.mark.slow
def test_six_robot_antipodal_headline():
    """Paper headline: six robots swap antipodally on the unit circle,
    collision-free and deadlock-free (all cross the center region)."""
    sc = get("six_robot_antipodal")
    ocp = sc.make()
    # escape=True: the noiseless sim otherwise parks at the nonholonomic
    # saddle ~0.11 from the 18-dim goal (the reference exits below 0.1 only
    # thanks to Gazebo odometry noise; verified the SLSQP oracle also returns
    # u=0 there). The sticky parking mode resolves it deterministically.
    mpc = MPCConfig(max_steps=120, stop_tol=1e-1, escape=True)
    strong = ALILQRConfig(n_outer=15, n_inner=25, tol_con=1e-4)
    r = jax.jit(functools.partial(closed_loop, solver_cfg=strong, mpc=mpc))(ocp)
    X = np.array(r.X_hist)
    # collision-free: realized min pairwise distance never below dmin.
    # Margin 1.5e-2: with final_clamp the executed controls are honestly
    # actuator-feasible (the old 5e-3 margin relied on the unsaturated plant
    # executing the AL iterate's ~1e-3 over-limit speeds); the dip is within
    # one discretization step of travel (T*v_max = 4.4 cm).
    assert float(np.min(np.array(r.min_dist_hist))) >= 0.3 - 1.5e-2
    # deadlock-free + converged: full 18-dim error under the reference's 0.1
    assert bool(r.reached)
    # each robot traveled ~2 units (crossed the circle)
    finals = X[-1].reshape(6, 3)
    travel = np.hypot(finals[:, 0] - X[0].reshape(6, 3)[:, 0],
                      finals[:, 1] - X[0].reshape(6, 3)[:, 1])
    assert travel.min() > 1.5


def test_waypoint_tour():
    sc = get("first_scenario")
    ocp = sc.make(N=25)
    wps = sc.waypoint_array
    # 6 legs ~ 7 m of path at v<=0.22, T=0.05 -> ~1000 steps plus parking
    mpc = MPCConfig(max_steps=1600, advance_tol=sc.advance_tol, escape=True)
    r = jax.jit(
        functools.partial(closed_loop_waypoints, waypoints=wps, solver_cfg=FAST, mpc=mpc)
    )(ocp)
    assert bool(r.reached)  # visited all 6 waypoints
    assert int(r.goal_idx_hist[-1]) == wps.shape[0]
    # final waypoint is the origin
    assert np.linalg.norm(np.array(r.X_hist[-1]) - np.array(wps[-1])) < sc.advance_tol + 1e-6


def test_trajectory_tracking():
    # mpc_control_trajectory_tracking.py: Xref = [cos(0.1 t), sin(0.1 t), 0]
    ocp = make_ocp(m=1, N=10, T=0.5, x0=[1, 0, 0], x_goal=[1, 0, 0])

    def ref_fn(t):
        p = jnp.array([jnp.cos(0.1 * t), jnp.sin(0.1 * t), 0.0])
        return jnp.tile(p[None, :], (10, 1))

    mpc = MPCConfig(max_steps=80)
    r = jax.jit(
        functools.partial(closed_loop_tracking, ref_fn=ref_fn, solver_cfg=FAST, mpc=mpc)
    )(ocp)
    # after transient, positional tracking error stays small (theta reference
    # is fixed at 0 while the heading must run tangent — position is what the
    # reference script actually tracks)
    X = np.array(r.X_hist)
    ts = np.arange(X.shape[0]) * 0.5
    ref = np.stack([np.cos(0.1 * ts), np.sin(0.1 * ts)], axis=-1)
    pos_err = np.hypot(X[:, 0] - ref[:, 0], X[:, 1] - ref[:, 1])
    assert pos_err[40:].mean() < 0.2


def test_plan_then_replay():
    # casadi_test_mpc.py: offline convergence then open-loop replay
    ocp = make_ocp(m=1, N=25, T=0.1, x0=[0, 0, 0], x_goal=[1, 1, 0])
    mpc = MPCConfig(max_steps=150, stop_tol=5e-2)
    offline, X_replay = jax.jit(
        functools.partial(plan_then_replay, solver_cfg=FAST, mpc=mpc)
    )(ocp)
    assert bool(offline.reached)
    # replay through the identical plant reproduces the offline trajectory
    np.testing.assert_allclose(
        np.array(X_replay[-1]), np.array(offline.X_hist[-1]), atol=1e-4
    )


def test_obstacle_waypoint_closed_loop():
    sc = get("obstacle_scenario_1")
    ocp = sc.make(N=25)
    mpc = MPCConfig(max_steps=250, advance_tol=sc.advance_tol)
    r = jax.jit(
        functools.partial(
            closed_loop_waypoints,
            waypoints=jnp.asarray(sc.waypoints[:2], jnp.float32),
            solver_cfg=FAST,
            mpc=mpc,
        )
    )(ocp)
    X = np.array(r.X_hist)
    d = np.hypot(X[:, 0] - 0.4, X[:, 1] - 1.1)
    # realized clearance from the obstacle never dips below r_rob + r_obs
    assert d.min() >= 0.15 + 0.15 - 1e-2
    assert int(r.goal_idx_hist[-1]) >= 1  # reached at least the first goal


def test_rk4_integrator_closed_loop():
    # mpc_pose_control_casadi.py capability: RK4 transcription (:43-59)
    ocp = make_ocp(m=1, N=20, T=0.1, x0=[0, 0, 0], x_goal=[1, 1, 0],
                   integrator="rk4")
    mpc = MPCConfig(max_steps=250, stop_tol=5e-2, escape=True)
    from nmpc_tpu.sim.plant import PlantConfig

    r = jax.jit(functools.partial(
        closed_loop, solver_cfg=FAST, mpc=mpc,
        plant=PlantConfig(integrator="rk4")))(ocp)
    assert bool(r.reached)


@pytest.mark.slow
def test_closed_loop_fused_engine():
    """Driver with solve_fn = batch-native solve_one (B=1): the
    low-latency engine closes the two-robot swap collision-free, matching the
    per-scenario engine's contract."""
    from nmpc_tpu.solver.alilqr_batched import solve_one

    sc = get("two_robot_swap")
    ocp = sc.make(N=25, T=0.1)
    mpc = MPCConfig(max_steps=250, stop_tol=1e-1, escape=True)
    run = jax.jit(functools.partial(
        closed_loop, solver_cfg=FAST, mpc=mpc,
        solve_fn=lambda o, w: solve_one(o, w, FAST)))
    r = run(ocp)
    assert bool(r.reached)
    assert float(jnp.min(r.min_dist_hist)) >= sc.dmin - 5e-3


def test_wrap_yaw_mode():
    """MPCConfig(wrap_yaw=True) reproduces the reference's modify() odometry
    wrap (mpc_online_casadi.py:28-33): a goal posed at theta=2pi-0.1 is
    reached without winding theta, and the realized yaw history stays in
    [0, 2pi)."""
    import dataclasses as dc
    import functools as ft

    from nmpc_tpu.mpc.driver import MPCConfig, closed_loop
    from nmpc_tpu.scenarios import get

    sc = get("single_robot")
    ocp = sc.make(N=10, T=0.05)
    # start just above the branch point; goal just below it
    ocp = dc.replace(
        ocp,
        x0=jnp.asarray([0.0, 0.0, 0.2], jnp.float32),
        xref=jnp.tile(jnp.asarray([[0.8, 0.6, 2.0 * np.pi - 0.1]], jnp.float32), (10, 1)),
    )
    mpc = MPCConfig(max_steps=600, stop_tol=1e-1, wrap_yaw=True)
    r = jax.jit(ft.partial(closed_loop, solver_cfg=FAST, mpc=mpc))(ocp)
    assert bool(r.reached)
    thetas = np.asarray(r.X_hist)[:, 2]
    assert thetas.min() >= -1e-6 and thetas.max() < 2.0 * np.pi + 0.3


def test_retreat_respects_static_obstacles():
    """Advisor round-3 finding: the deadlock-breaking retreat must not back
    a blocked robot into an obstacle keep-out region — static obstacles
    join the repulsion sum and the clearance gate as phantom neighbors
    (driver._escape_control). Two mutually-blocked robots with an obstacle
    parked directly behind robot 0: after the stall persists, the retreat
    must open the distance to the NEAREST threat (the obstacle surface at
    0.25 eff vs the robot at 0.35 — sandwiched, it cannot open both) while
    never violating the robot-robot keep-out. Without obstacle awareness
    the inverse-square sum sees only the other robot and reverses robot 0
    straight into the obstacle."""
    import numpy as np

    from nmpc_tpu.mpc.driver import MPCConfig, _escape_control, escape_state0
    from nmpc_tpu.ocp.problem import make_ocp

    obs = np.array([[-0.45, 0.0, 0.1]])  # directly behind robot 0
    ocp = make_ocp(
        m=2, N=5, T=0.1,
        x0=np.array([0.0, 0.0, 0.0, 0.35, 0.0, np.pi]),
        x_goal=np.array([2.0, 0.0, 0.0, -2.0, 0.0, np.pi]),
        dmin=0.3, collision=True, obstacles=obs, robot_radius=0.1)
    mpc = MPCConfig(escape=True, escape_stall_steps=3)
    x = jnp.asarray(ocp.x0)
    goal = jnp.asarray([2.0, 0.0, 0.0, -2.0, 0.0, np.pi], jnp.float32)
    esc = escape_state0(2)
    done = jnp.zeros((), bool)
    u = None
    for _ in range(mpc.escape_stall_steps + 1):
        u, esc = _escape_control(ocp, mpc, x, goal, jnp.zeros(4), esc, done)
    u = np.asarray(u)
    # robot 0 is blocked (0.35 < 1.5*dmin from robot 1, and the obstacle
    # surface sits 0.25 behind it): the retreat must be engaged...
    assert abs(u[0]) > 1e-3, u
    # ...and must not drive into either neighbor: simulate a few periods of
    # the commanded twist and check both separations are non-decreasing
    pose = np.array(ocp.x0[:3], float)
    d_obs0 = np.hypot(pose[0] - obs[0, 0], pose[1] - obs[0, 1])
    d_rob0 = 0.35
    for _ in range(3):
        v, w = float(u[0]), float(u[1])
        pose[0] += 0.1 * v * np.cos(pose[2])
        pose[1] += 0.1 * v * np.sin(pose[2])
        pose[2] += 0.1 * w
    d_obs = np.hypot(pose[0] - obs[0, 0], pose[1] - obs[0, 1])
    d_rob = np.hypot(pose[0] - 0.35, pose[1])
    assert d_obs > d_obs0 + 1e-3, (d_obs, d_obs0)   # fled the obstacle
    assert d_rob >= 0.3, (d_rob, d_rob0)            # robot keep-out held


def test_obstacle_gate_arms_without_pairs():
    """Advisor round 4 (medium): families H1-H3 are m=1 with static
    obstacles — n_pairs=0 — so the round-3 clearance gate (which lived only
    in the `if ocp.n_pairs:` branch) never armed there, and a robot
    creep-stalled at an obstacle standoff could latch a goal-bearing chase
    straight through the keep-out. The gate must arm on n_obs alone:

    * creep-stalled INSIDE the obstacle gate: no parking latch — the MPC's
      own (obstacle-aware) control passes through unchanged;
    * hard-stalled inside the gate: the deadlock-breaking retreat engages
      and backs AWAY from the obstacle (never toward it);
    * stalled with clearance: the parking latch engages as before.
    """
    from nmpc_tpu.mpc.driver import (
        _ESC_LATCH, MPCConfig, _escape_control, escape_state0)
    from nmpc_tpu.ocp.problem import make_ocp

    # obstacle dead ahead: surface distance 0.35 - 0.1 - 0.1 = 0.15, below
    # the no-pairs gate 1.5 * (robot_radius + obs_margin) = 0.225
    ocp = make_ocp(m=1, N=5, T=0.1, x0=np.array([0.0, 0.0, 0.0]),
                   x_goal=np.array([2.0, 0.0, 0.0]),
                   obstacles=np.array([[0.35, 0.0, 0.1]]),
                   robot_radius=0.1, obs_margin=0.05)
    assert ocp.n_pairs == 0 and ocp.n_obs == 1
    mpc = MPCConfig(escape=True, escape_stall_steps=3)
    x = jnp.asarray(ocp.x0)
    goal = jnp.asarray([2.0, 0.0, 0.0], jnp.float32)
    done = jnp.zeros((), bool)

    # (a) creep stall (u below escape_u_tol but above the hard tol): the
    # creep-parking debounce must NOT latch — gate closed -> u_mpc passes
    u_creep = jnp.asarray([0.01, 0.0], jnp.float32)
    esc = escape_state0(1)
    for _ in range(mpc.escape_stall_steps + 2):
        u, esc = _escape_control(ocp, mpc, x, goal, u_creep, esc, done)
    assert int(esc[0]) < _ESC_LATCH, "parking latched through the obstacle gate"
    np.testing.assert_allclose(np.asarray(u), np.asarray(u_creep), atol=1e-7)

    # (b) hard stall: retreat engages and reverses away from the obstacle
    # (robot faces it, so the repulsion bearing is behind -> v < 0)
    esc = escape_state0(1)
    for _ in range(mpc.escape_stall_steps + 1):
        u, esc = _escape_control(ocp, mpc, x, goal, jnp.zeros(2), esc, done)
    assert float(u[0]) < -1e-3, np.asarray(u)

    # (c) same stall with the obstacle far away: parking latches and drives
    # toward the (aligned) goal as before
    ocp_clear = make_ocp(m=1, N=5, T=0.1, x0=np.array([0.0, 0.0, 0.0]),
                         x_goal=np.array([2.0, 0.0, 0.0]),
                         obstacles=np.array([[-3.0, 0.0, 0.1]]),
                         robot_radius=0.1, obs_margin=0.05)
    esc = escape_state0(1)
    u, esc = _escape_control(ocp_clear, mpc, x, goal, jnp.zeros(2), esc, done)
    assert int(esc[0]) >= _ESC_LATCH
    assert float(u[0]) > 1e-3, np.asarray(u)


def test_obstacle_waypoint_closed_loop_with_escape():
    """m=1 closed-loop obstacle-clearance check WITH the escape law armed
    (advisor round 4): the obstacle_scenario_1 tour must respect the
    obstacle keep-out even when parking/retreat can fire — gen_cl_parity
    only measures pairwise clearance (vacuous at m=1), so this assertion
    is the coverage for the no-pairs obstacle gate in a real loop."""
    sc = get("obstacle_scenario_1")
    ocp = sc.make(N=25)
    mpc = MPCConfig(max_steps=300, advance_tol=sc.advance_tol, escape=True)
    r = jax.jit(
        functools.partial(
            closed_loop_waypoints,
            waypoints=jnp.asarray(sc.waypoints[:2], jnp.float32),
            solver_cfg=FAST,
            mpc=mpc,
        )
    )(ocp)
    X = np.array(r.X_hist)
    d = np.hypot(X[:, 0] - 0.4, X[:, 1] - 1.1)
    assert d.min() >= 0.15 + 0.15 - 1e-2   # r_rob + r_obs never violated
    assert int(r.goal_idx_hist[-1]) >= 1
