"""Closed-loop parity: the f64 oracle AS THE MPC SOLVER in the same driver.

The reference's product is the closed loop — solve, apply u*[0], sense,
repeat (/root/reference/AllScripts/
mpc_online_casadi_tb3_six_multi_centralized_collision_free.py:338-427) —
and its only multi-robot validation was closed-loop (SURVEY.md §4).
docs/PARITY.md compares single open-loop solves; this harness closes the
remaining fidelity axis by running the SLSQP f64 oracle (tests/oracle.py)
inside a step-exact Python replica of mpc/driver.closed_loop — same latch ->
solve -> escape -> plant -> shift semantics, same escape controller, same
exact-Euler plant — and comparing realized trajectories, arrival steps, and
min clearance against the engine's jitted loop.

Round-5 additions:
  * the oracle loop CHECKPOINTS (docs/cl_parity_state/<name>.npz) — a
    wall-budgeted run resumes exactly where it stopped, warm start and
    escape state included, so slow configs (five_robot pays ~8 s of f64
    SLSQP per MPC step) reach arrival across invocations;
  * per-row persistence (docs/cl_parity_state/rows.json) — configs can be
    (re)measured one at a time without clobbering the other rows of
    docs/CL_PARITY.md;
  * delay=1 timing (the reference's real deployment: control lands one
    period late — centralized_six_robots_implementation.py:364-388 solves
    while the robots keep moving) replicated in the oracle loop for the
    six_robot_impl hardware row;
  * the eight_robot published config (N=5 —
    mpc_online_casadi_tb3_eight_multi_centralized_collision_free.py:148-152)
    to resolve whether its myopic standoff is a formulation property (both
    solvers stand off) or an engine gap.

Caveat recorded in the output: symmetric configs (the antipodal circles)
break symmetry on solver-noise-level differences, so realized trajectories
can legitimately diverge (mirror/rotate) while both loops are correct; the
robust comparisons are arrival, clearance, and final error. Trajectory
deviation is reported for the asymmetric configs where it is meaningful.

Usage:
  python tools/gen_cl_parity.py                  # all configs
  python tools/gen_cl_parity.py five_robot       # one config (merges rows)
  python tools/gen_cl_parity.py five_robot --budget 18000   # override wall budget

Writes docs/CL_PARITY.md. Runtime: minutes to hours depending on config
(dominated by the five/six-robot oracle solves; each MPC step is one
warm-started SLSQP).
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402

# Engine loop runs on CPU: the same jitted program the test suite validates;
# this tool is about semantics, not speed.
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nmpc_tpu.mpc.driver import (  # noqa: E402
    MPCConfig,
    _escape_control,
    closed_loop,
    closed_loop_waypoints,
    escape_state0,
)
from nmpc_tpu.scenarios import get  # noqa: E402
from nmpc_tpu.solver.alilqr import ALILQRConfig  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tests"))
from oracle import solve_oracle  # noqa: E402

ENGINE_CFG = ALILQRConfig(n_outer=10, n_inner=20, tol_con=1e-4)

STATE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "..", "docs", "cl_parity_state")
ROWS_PATH = os.path.join(STATE_DIR, "rows.json")


def _plant_np(x, u, T):
    m = x.shape[0] // 3
    rhs = np.zeros_like(x)
    for i in range(m):
        v, w = u[2 * i], u[2 * i + 1]
        th = x[3 * i + 2]
        rhs[3 * i: 3 * i + 3] = [v * np.cos(th), v * np.sin(th), w]
    return x + T * rhs


def _min_pair_dist(x, m):
    if m < 2:
        return np.inf
    p = x[: 3 * m].reshape(m, 3)[:, :2]
    d = np.inf
    for i in range(m):
        for j in range(i + 1, m):
            d = min(d, float(np.hypot(*(p[i] - p[j]))))
    return d


def oracle_loop(sc, ocp, mpc: MPCConfig, waypoints=None, maxiter=200,
                log_every=25, wall_budget_s=None, ckpt=None, ckpt_every=20,
                solve_fn=None):
    """Python replica of the driver loop with solve_oracle as the solver.

    wall_budget_s bounds the f64 oracle's total wall clock per invocation;
    `ckpt` names an npz checkpoint — a budgeted-out run saves its full loop
    state (pose, warm start, escape latch, waypoint index, history) and the
    next invocation resumes from it, so arrival is reachable across wall
    budgets. Replicates MPCConfig.delay=1 semantics when set (the control
    computed at step k is applied over period k+1, driver.closed_loop).
    solve_fn(x, goal, U0) -> (U [N, nu], cost) overrides the solver — used
    by tests/test_cl_parity.py to pin the replica's step ordering exactly
    against the jitted driver with a shared deterministic control law."""
    m = ocp.m
    x = np.array(ocp.x0, float)
    goals = (np.array(waypoints, float) if waypoints is not None
             else np.array(ocp.xref[-1], float)[None])
    G = goals.shape[0]
    gidx = 0
    dmin = float(np.sqrt(float(ocp.dmin2))) if ocp.n_pairs else 0.0
    obstacles = ([tuple(map(float, row)) for row in np.array(ocp.obstacles)]
                 if ocp.n_obs else None)
    U0 = None
    esc = escape_state0(m)
    done = jnp.zeros((), bool)
    X_hist = [x.copy()]
    min_d = _min_pair_dist(x, m)
    steps = 0
    start_step = 0
    wall_prev = 0.0
    u_prev = np.zeros(ocp.nu, float)
    budget_hit = False
    if ckpt and os.path.exists(ckpt):
        z = np.load(ckpt)
        x = z["x"]
        X_hist = [row.copy() for row in z["X_hist"]]
        U0 = z["U0"] if bool(z["has_U0"]) else None
        esc = jnp.asarray(z["esc"])
        gidx = int(z["gidx"])
        start_step = steps = int(z["steps"])
        min_d = float(z["min_d"])
        wall_prev = float(z["wall_s"])
        u_prev = z["u_prev"]
        print(f"    resumed checkpoint at step {steps} "
              f"({wall_prev:.0f}s accumulated)", flush=True)

    t0 = time.time()

    def _save_ckpt():
        if not ckpt:
            return
        os.makedirs(os.path.dirname(ckpt), exist_ok=True)
        np.savez(ckpt, x=x, X_hist=np.array(X_hist),
                 U0=(U0 if U0 is not None else np.zeros((1,))),
                 has_U0=U0 is not None, esc=np.asarray(esc), gidx=gidx,
                 steps=steps, min_d=min_d,
                 wall_s=wall_prev + time.time() - t0, u_prev=u_prev)

    for step in range(start_step, mpc.max_steps):
        if wall_budget_s is not None and \
                wall_prev + time.time() - t0 > wall_budget_s:
            budget_hit = True
            _save_ckpt()
            break
        goal = goals[min(gidx, G - 1)]
        err = float(np.linalg.norm(x - goal))
        if waypoints is not None:
            if err < mpc.advance_tol:
                gidx += 1
                esc = escape_state0(m)
                if gidx >= G:
                    break
                goal = goals[gidx]
                err = float(np.linalg.norm(x - goal))
        elif err < mpc.stop_tol:
            break
        if solve_fn is not None:
            U, cost = solve_fn(x, goal, U0)
        else:
            U, _X, cost = solve_oracle(
                x, goal, ocp.N, float(ocp.T), dmin=dmin,
                v_max=float(ocp.u_hi[0]), omega_max=float(ocp.u_hi[1]),
                U0=U0, maxiter=maxiter, obstacles=obstacles,
                robot_radius=float(ocp.robot_radius),
                obs_margin=float(ocp.obs_margin),
            )
        u0 = U[0].copy()
        if mpc.escape:
            tol = mpc.advance_tol if waypoints is not None else mpc.stop_tol
            u0_j, esc = _escape_control(
                ocp, mpc, jnp.asarray(x, jnp.float32),
                jnp.asarray(goal, jnp.float32),
                jnp.asarray(u0, jnp.float32), esc, done, tol=tol)
            u0 = np.array(u0_j, float)
        if mpc.delay:
            # one-period actuation delay, exactly driver.closed_loop's
            # ordering: the plant advances under the PREVIOUS solve's
            # control; this solve's u0 lands next period. (The oracle loop
            # is reference-faithful: no delay compensation.)
            u_apply, u_prev = u_prev.copy(), u0
        else:
            u_apply = u0
        x = _plant_np(x, u_apply, float(ocp.T))
        X_hist.append(x.copy())
        min_d = min(min_d, _min_pair_dist(x, m))
        U0 = np.concatenate([U[1:], U[-1:]], axis=0)
        steps = step + 1
        if log_every and steps % log_every == 0:
            print(f"    oracle step {steps} err {err:.3f} cost {cost:.2f} "
                  f"({wall_prev + time.time() - t0:.0f}s)", flush=True)
        if ckpt and ckpt_every and steps % ckpt_every == 0:
            _save_ckpt()
    goal = goals[min(gidx, G - 1)]
    reached = (gidx >= G) if waypoints is not None else (
        float(np.linalg.norm(x - goal)) < mpc.stop_tol)
    if ckpt and not budget_hit:
        _save_ckpt()  # finished runs keep their state for re-reporting
    return dict(X=np.array(X_hist), steps=steps, reached=bool(reached),
                min_dist=min_d, final_err=float(np.linalg.norm(x - goal)),
                wall_s=wall_prev + time.time() - t0, budget_hit=budget_hit)


def engine_loop(sc, ocp, mpc: MPCConfig, waypoints=None):
    if waypoints is not None:
        r = jax.jit(functools.partial(
            closed_loop_waypoints, waypoints=jnp.asarray(waypoints, jnp.float32),
            solver_cfg=ENGINE_CFG, mpc=mpc))(ocp)
    else:
        r = jax.jit(functools.partial(
            closed_loop, solver_cfg=ENGINE_CFG, mpc=mpc))(ocp)
    su = int(r.steps_used)
    X = np.array(r.X_hist, float)[: su + 1]
    md = float(np.min(np.array(r.min_dist_hist)[: su + 1]))
    return dict(X=X, steps=su, reached=bool(r.reached), min_dist=md,
                final_err=float(np.array(r.err_hist)[min(su, mpc.max_steps - 1)]))


# Family-I closed-loop fixture: one circular obstacle dead on the straight
# line from the start (0,0) to the first goal (1.0, 0.5) — the same
# ground-truth world tests/test_gn_lidar.py drives the engine loop through.
LIDAR_OBSTACLES = np.array([[0.5, 0.25, 0.1]])


def lidar_engine_loop(sc, ocp, max_steps):
    """closed_loop_lidar at the published lidar_v4 config (N=100, Nc=50)
    with the production fleet GN recipe (tools/bench_lidar.py)."""
    from nmpc_tpu.mpc.lidar import closed_loop_lidar
    from nmpc_tpu.solver import gn

    cfg = gn.GNConfig(Nc=sc.Nc, n_gn=10, n_outer=4, tol_con=1e-3)
    wps = jnp.asarray(sc.waypoints, jnp.float32)
    X, U, clr, gidx, done = jax.jit(functools.partial(
        closed_loop_lidar, sim_obstacles=jnp.asarray(LIDAR_OBSTACLES, jnp.float32),
        waypoints=wps, cfg=cfg, max_steps=max_steps))(ocp)
    gidx = np.array(gidx)
    G = wps.shape[0]
    fin = np.nonzero(gidx >= G)[0]
    steps = int(fin[0]) if fin.size else max_steps
    X = np.array(X, float)[: steps + 1]
    return dict(X=X, steps=steps, reached=bool(done),
                min_dist=float(np.array(clr)[: steps + 1].min()),
                final_err=float(np.linalg.norm(X[-1] - np.array(sc.waypoints[-1], float))))


def lidar_oracle_loop(sc, max_steps, maxiter=150, log_every=25,
                      wall_budget_s=None, ckpt=None, ckpt_every=20,
                      solve_fn=None):
    """Python replica of mpc/lidar.closed_loop_lidar with solve_oracle_lidar
    as the solver — same per-step ordering (advance goal -> raycast ->
    freeze pObs -> solve -> exact-Euler plant -> clearance from the NEXT
    pose -> shift warm start). Sensing is shared bit-for-bit with the
    engine loop (the same f32 raycast/obstacle_points); only the NLP solve
    differs. solve_fn(pose, goal, scan, p_obs, U0) -> U overrides the
    solver for the step-exactness pin in tests/test_cl_parity.py."""
    from oracle import solve_oracle_lidar
    from nmpc_tpu.sim.lidar import obstacle_points, ray_angles, raycast

    R = sc.num_rays
    angles = ray_angles(R, jnp.float32)
    goals = np.array(sc.waypoints, float)
    G = goals.shape[0]
    pose = np.array(sc.x0, float)
    obstacles = jnp.asarray(LIDAR_OBSTACLES, jnp.float32)
    U0 = None
    gidx = 0
    X_hist = [pose.copy()]
    min_clr = np.inf
    steps = 0
    start_step = 0
    wall_prev = 0.0
    budget_hit = False
    if ckpt and os.path.exists(ckpt):
        z = np.load(ckpt)
        pose = z["pose"]
        X_hist = [row.copy() for row in z["X_hist"]]
        U0 = z["U0"] if bool(z["has_U0"]) else None
        gidx = int(z["gidx"])
        start_step = steps = int(z["steps"])
        min_clr = float(z["min_clr"])
        wall_prev = float(z["wall_s"])
        print(f"    resumed checkpoint at step {steps} "
              f"({wall_prev:.0f}s accumulated)", flush=True)

    t0 = time.time()

    def _save_ckpt():
        if not ckpt:
            return
        os.makedirs(os.path.dirname(ckpt), exist_ok=True)
        np.savez(ckpt, pose=pose, X_hist=np.array(X_hist),
                 U0=(U0 if U0 is not None else np.zeros((1,))),
                 has_U0=U0 is not None, gidx=gidx, steps=steps,
                 min_clr=min_clr, wall_s=wall_prev + time.time() - t0)

    reached = False
    for step in range(start_step, max_steps):
        if wall_budget_s is not None and \
                wall_prev + time.time() - t0 > wall_budget_s:
            budget_hit = True
            _save_ckpt()
            break
        goal = goals[min(gidx, G - 1)]
        err = float(np.linalg.norm(pose - goal))
        if err < 0.1:  # closed_loop_lidar advance_tol default
            gidx += 1
            if gidx >= G:
                reached = True
                steps = step
                break
            goal = goals[gidx]
        # shared f32 sensing — identical to the engine loop's raycast
        scan_j = raycast(jnp.asarray(pose, jnp.float32), obstacles, angles)
        p_obs_j = obstacle_points(jnp.asarray(pose, jnp.float32), scan_j, angles)
        scan = np.array(scan_j, float)
        p_obs = np.array(p_obs_j, float)
        if solve_fn is not None:
            U = solve_fn(pose, goal, scan, p_obs, U0)
            cost = 0.0
        else:
            U, _X, cost = solve_oracle_lidar(
                pose, goal, sc.N, float(sc.T), p_obs, scan,
                ray_lo=float(sc.robot_radius),
                inv_dist_weight=float(sc.inv_dist_weight), Nc=sc.Nc,
                v_max=float(sc.v_max), omega_max=float(sc.omega_max),
                U0=U0, maxiter=maxiter)
        v, w = U[0]
        th = pose[2]
        pose = pose + float(sc.T) * np.array(
            [v * np.cos(th), v * np.sin(th), w])
        X_hist.append(pose.copy())
        dc = np.sqrt(((pose[None, :2] - LIDAR_OBSTACLES[:, :2]) ** 2).sum(-1))
        min_clr = min(min_clr, float((dc - LIDAR_OBSTACLES[:, 2]).min()))
        U0 = np.concatenate([U[1:], U[-1:]], axis=0)
        steps = step + 1
        if log_every and steps % log_every == 0:
            print(f"    lidar oracle step {steps} leg {gidx} err {err:.3f} "
                  f"cost {cost:.2f} ({wall_prev + time.time() - t0:.0f}s)",
                  flush=True)
        if ckpt and ckpt_every and steps % ckpt_every == 0:
            _save_ckpt()
    if ckpt and not budget_hit:
        _save_ckpt()
    return dict(X=np.array(X_hist), steps=steps, reached=reached,
                min_dist=min_clr,
                final_err=float(np.linalg.norm(pose - goals[-1])),
                wall_s=wall_prev + time.time() - t0, budget_hit=budget_hit)


CONFIGS = [
    # name, max_steps, symmetric?, oracle maxiter, oracle wall budget [s],
    # extra MPCConfig kwargs
    ("single_robot", 2400, False, 200, None, {}),
    ("two_robot_swap", 1300, False, 200, None, {}),
    ("obstacle_scenario_1", 1400, False, 200, None, {}),
    ("six_robot_antipodal", 220, True, 150, None, {}),
    ("five_robot", 1600, False, 150, 3000.0, {}),
    # the reference's actual hardware deployment: six real TB3s, reduced
    # limits, dmin=0.4, with one control period of actuation delay (odometry
    # latched at solve start, control lands late —
    # centralized_six_robots_implementation.py:197-205,364-388). delay=1 is
    # the reference-faithful uncompensated timing.
    ("six_robot_impl", 220, True, 150, None, {"delay": 1}),
    # the published eight-robot config (N=5, T=0.02: 0.1 s of lookahead).
    # The engine's loop is collision-free but stands off myopically at the
    # dmin ring (tests/test_scenarios_closed_loop.py); this row asks the f64
    # oracle the same question. escape stays off, matching the pinned engine
    # test (the standoff is the object under study).
    ("eight_robot", 600, True, 150, 2400.0, {"escape": False}),
    # family I: the published lidar_v4 config (N=100, Nc=50, 10 rays, 1/d
    # cost — obs_avoid_static_first_scenario_v4.py:59-75) driving the
    # two-leg waypoint tour through the standard closed-loop fixture
    # (LIDAR_OBSTACLES). Engine = closed_loop_lidar with the production
    # fleet GN recipe; oracle = solve_oracle_lidar (f64 SLSQP, exact
    # sensitivities) in the step-exact replica. The obstacle sits exactly
    # on the start->goal line, so the detour side is a near-symmetric
    # choice (see footnote) — measured round 5: both loops pick the SAME
    # side and track each other to 2.4e-1 over the identical 271-step
    # tour, so the row reports trajectory deviation as meaningful.
    ("lidar_v4", 500, False, 150, 2400.0, {}),
]


def _load_rows():
    if os.path.exists(ROWS_PATH):
        with open(ROWS_PATH) as f:
            return json.load(f)
    return {}


def _save_rows(rows):
    os.makedirs(STATE_DIR, exist_ok=True)
    with open(ROWS_PATH, "w") as f:
        json.dump(rows, f, indent=1)


def main(names=None, budget_override=None):
    rows = _load_rows()
    for name, max_steps, symmetric, maxiter, wall_budget, mpc_kw in CONFIGS:
        if names and name not in names:
            continue
        if budget_override is not None:
            wall_budget = budget_override
        sc = get(name)
        if name == "lidar_v4":
            prev = rows.get(name, {})
            if prev.get("e_steps") is not None:
                e = dict(X=np.array(prev["e_X"]), steps=prev["e_steps"],
                         reached=prev["e_reached"], min_dist=prev["e_md"],
                         final_err=prev["e_err"])
                print(f"{name}: engine loop cached ({e['steps']} steps)",
                      flush=True)
            else:
                print(f"{name}: engine loop...", flush=True)
                e = lidar_engine_loop(sc, sc.make(), max_steps)
                print(f"  engine: steps {e['steps']} reached {e['reached']} "
                      f"min clearance {e['min_dist']:.3f}", flush=True)
            print(f"{name}: oracle-in-the-loop...", flush=True)
            o = lidar_oracle_loop(sc, max_steps, maxiter=maxiter,
                                  wall_budget_s=wall_budget,
                                  ckpt=os.path.join(STATE_DIR, f"{name}.npz"))
            n = min(e["X"].shape[0], o["X"].shape[0])
            dev = float(np.abs(e["X"][:n] - o["X"][:n]).max())
            # merge-on-save: reload the disk rows so a concurrent
            # invocation measuring a DIFFERENT config is not clobbered by
            # this process's stale snapshot (each row is saved right after
            # it is measured, so disk is authoritative for other names)
            rows = _load_rows()
            rows[name] = dict(
                name=name, sym=symmetric, budget=o["budget_hit"], delay=0,
                e_steps=e["steps"], o_steps=o["steps"],
                e_reached=e["reached"], o_reached=o["reached"],
                e_md=e["min_dist"], o_md=o["min_dist"],
                e_err=e["final_err"], o_err=o["final_err"],
                dev=dev, o_wall=o["wall_s"],
                e_X=np.asarray(e["X"]).tolist())
            _save_rows(rows)
            print(f"  oracle: steps {o['steps']} reached {o['reached']} "
                  f"min clearance {o['min_dist']:.3f} wall {o['wall_s']:.0f}s "
                  f"| traj dev {dev:.3e}", flush=True)
            _write_doc(rows)
            continue
        ocp = sc.make()
        wps = (np.array(sc.waypoint_array, float)
               if getattr(sc, "waypoints", None) else None)
        kw = dict(max_steps=max_steps, stop_tol=sc.stop_tol,
                  advance_tol=0.075, escape=True)
        kw.update(mpc_kw)
        mpc = MPCConfig(**kw)
        prev = rows.get(name, {})
        if prev.get("e_steps") is not None and prev.get("e_reached") is not None:
            # engine side cached from an earlier invocation (rows.json);
            # the engine loop is deterministic so re-running it only costs
            # time. Delete the row from rows.json to force a re-measure.
            e = dict(X=np.array(prev["e_X"]), steps=prev["e_steps"],
                     reached=prev["e_reached"], min_dist=prev["e_md"],
                     final_err=prev["e_err"])
            print(f"{name}: engine loop cached ({e['steps']} steps)", flush=True)
        else:
            print(f"{name}: engine loop...", flush=True)
            e = engine_loop(sc, ocp, mpc, wps)
            print(f"  engine: steps {e['steps']} reached {e['reached']} "
                  f"min_dist {e['min_dist']:.3f}", flush=True)
        print(f"{name}: oracle-in-the-loop...", flush=True)
        o = oracle_loop(sc, ocp, mpc, wps, maxiter=maxiter,
                        wall_budget_s=wall_budget,
                        ckpt=os.path.join(STATE_DIR, f"{name}.npz"))
        n = min(e["X"].shape[0], o["X"].shape[0])
        dev = float(np.abs(e["X"][:n, : 3 * ocp.m]
                           - o["X"][:n, : 3 * ocp.m]).max())
        rows = _load_rows()  # merge-on-save (see lidar branch comment)
        rows[name] = dict(
            name=name, sym=symmetric, budget=o["budget_hit"],
            delay=int(mpc_kw.get("delay", 0)),
            e_steps=e["steps"], o_steps=o["steps"],
            e_reached=e["reached"], o_reached=o["reached"],
            e_md=e["min_dist"], o_md=o["min_dist"],
            e_err=e["final_err"], o_err=o["final_err"],
            dev=dev, o_wall=o["wall_s"],
            e_X=np.asarray(e["X"]).tolist())
        _save_rows(rows)
        print(f"  oracle: steps {o['steps']} reached {o['reached']} "
              f"min_dist {o['min_dist']:.3f} wall {o['wall_s']:.0f}s "
              f"| traj dev {dev:.3e}", flush=True)
        _write_doc(rows)  # incremental: a killed run still leaves the rows
                          # measured so far (same pattern as gen_parity)
    _write_doc(rows)


def _write_doc(rows):
    order = [c[0] for c in CONFIGS]
    rlist = [rows[n] for n in order if n in rows]
    # dmin column: the binding keep-out of each config — pairwise dmin for
    # collision configs, the ray bound (robot_radius) for family I.
    dmin_of = {r["name"]: (float(get(r["name"]).robot_radius)
                           if r["name"] == "lidar_v4" else
                           float(np.sqrt(float(get(r["name"]).make().dmin2))))
               for r in rlist}
    out = [
        "# Closed-loop parity: f64 oracle as the in-loop solver\n\n",
        "Generated by `tools/gen_cl_parity.py` (see its docstring). Same\n",
        "driver semantics on both sides (latch -> solve -> escape -> exact-\n",
        "Euler plant -> shift warm start); only the solver differs: the\n",
        "engine (AL-iLQR, f32, on this machine's default JAX backend) vs\n",
        "the condensed f64 SLSQP oracle with exact sensitivities\n",
        "(tests/oracle.py), warm-started across steps exactly like the\n",
        "reference warm-starts IPOPT. The six_robot_impl row runs BOTH\n",
        "loops at the reference's hardware timing (MPCConfig.delay=1:\n",
        "control lands one period late, uncompensated). The eight_robot\n",
        "row runs the published N=5 config with escape off: both solvers\n",
        "driving the same myopic formulation (see footnotes). The lidar_v4\n",
        "row closes family I: both loops drive the LiDAR-augmented v4\n",
        "formulation (frozen ray endpoints, Nc move blocking, 1/d cost)\n",
        "through the standard obstacle fixture with SHARED f32 sensing —\n",
        "its min-clearance column is true distance to the obstacle surface\n",
        "and its dmin column is the ray keep-out (robot_radius).\n\n",
        "| config | arrived (eng/orc) | steps (eng/orc) | min clearance "
        "(eng/orc) | dmin | final err (eng/orc) | traj dev |\n",
        "|---|---|---|---|---|---|---|\n",
    ]
    for r in rlist:
        dev_s = (f"{r['dev']:.2e}" if not r["sym"]
                 else f"{r['dev']:.2e} (symmetric config: mirrored "
                      "crossings are equally optimal)")
        o_mark = ("budget" if r.get("budget") else str(r["o_reached"]))
        nm = r["name"] + (" (delay=1)" if r.get("delay") else "")
        dm = dmin_of[r["name"]]
        dm_s = f"{dm:.2f}" if dm > 0 else "—"
        out.append(
            f"| {nm} | {r['e_reached']}/{o_mark} "
            f"| {r['e_steps']}/{r['o_steps']} "
            f"| {r['e_md']:.3f}/{r['o_md']:.3f} | {dm_s} "
            f"| {r['e_err']:.3f}/{r['o_err']:.3f} | {dev_s} |\n")
    out.append(
        "\nBoth loops must agree on the loop-level outcome — arrival (or,\n"
        "for eight_robot, the standoff), realized clearance vs dmin, and\n"
        "comparable step counts; per-step trajectory deviation is the\n"
        "strictest check and is only meaningful for asymmetric configs.\n"
        "\nFootnotes:\n"
        "* single_robot: the f32 engine and f64 oracle loops stay within\n"
        "  centimeters across the whole run, parking maneuver included.\n"
        "* two_robot_swap: the diagonal swap has a passing-side symmetry —\n"
        "  the loops choose different (equally optimal) sides, so pointwise\n"
        "  trajectories diverge while every loop-level outcome agrees.\n"
        "* obstacle_scenario_1: single robot + static obstacle; pairwise\n"
        "  clearance is vacuous (the obstacle keep-out is enforced inside\n"
        "  each solve); waypoint tours advance goals at slightly different\n"
        "  steps, so same-index states compare different tour legs.\n"
        "* five_robot: the slowest oracle row (~8-15 s of f64 SLSQP per MPC\n"
        "  step at 700 decision variables; checkpoint-resumed across wall\n"
        "  budgets to arrival, ~3.05 h of oracle time total). The loops\n"
        "  agree to within FOUR steps (1122/1126) with realized clearance\n"
        "  pinned at the dmin ring through the crossing on both sides\n"
        "  (0.298/0.300) — and both independently take the same late\n"
        "  retreat-and-repark excursion near the clustered goals (err dips\n"
        "  to ~0.4 around step 800-850, the escape law backs robots out of\n"
        "  each other's clearance gate to a peak err of ~2.4-3.7 near step\n"
        "  925-950, then both park; a nontrivial emergent maneuver\n"
        "  reproduced solver-independently).\n"
        "* six_robot_antipodal / six_robot_impl / eight_robot are fully\n"
        "  symmetric formations: mirrored crossings are equally optimal, so\n"
        "  the loop-level outcomes are the honest comparison.\n"
        "* six_robot_impl runs the reference's UNCOMPENSATED hardware\n"
        "  timing: with the control landing one period (0.3 s) late, the\n"
        "  realized crossing clearance erodes below the planned dmin=0.40\n"
        "  on BOTH sides (engine 0.326, oracle 0.286) while staying above\n"
        "  the ~0.21 m physical-contact distance of two TurtleBot3s — the\n"
        "  erosion the hardware family's enlarged dmin buys margin for\n"
        "  (tests/test_rt_mode.py::test_delay_closed_loop_six_robot_hw_config\n"
        "  measures the same band, and MPCConfig.delay_compensate removes\n"
        "  it).\n"
        "* eight_robot (N=5): the published horizon gives 0.1 s of\n"
        "  lookahead; whether both solvers stand off at the dmin ring (a\n"
        "  formulation property) is exactly what this row measures.\n"
        "  RESOLVED (round 5): the f64 oracle stands off exactly like the\n"
        "  engine — both loops plateau at the same final error (3.665 to\n"
        "  three decimals) with clearance pinned at exactly dmin, tracking\n"
        "  each other to 1.4e-1 over 600 steps. The myopic standoff is a\n"
        "  property of the published N=5 formulation, not an engine gap\n"
        "  (the same swap completes at N=25 —\n"
        "  tests/test_scenarios_closed_loop.py::test_eight_robot_closed_loop_full_swap).\n"
        "* lidar_v4: the obstacle sits exactly on the start->goal line, so\n"
        "  the detour side is in principle a near-symmetric choice; in the\n"
        "  measured run both solvers pick the SAME side and the f32 GN\n"
        "  engine tracks the f64 oracle pointwise (identical 271-step tour,\n"
        "  identical 0.242 realized clearance to three decimals). The\n"
        "  step-ordering of the replica is pinned by\n"
        "  tests/test_cl_parity.py::test_lidar_oracle_loop_replica_matches_driver.\n")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "docs", "CL_PARITY.md")
    with open(path, "w") as f:
        f.writelines(out)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:]]
    budget = None
    if "--budget" in args:
        i = args.index("--budget")
        budget = float(args[i + 1])
        del args[i: i + 2]
    main(args or None, budget_override=budget)
