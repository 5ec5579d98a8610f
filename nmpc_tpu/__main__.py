"""CLI: run any registered reference scenario end to end.

    python -m nmpc_tpu list
    python -m nmpc_tpu run six_robot_antipodal [--steps N] [--save out.npz]
    python -m nmpc_tpu bench

The reference's 'CLI' is editing one of 44 script copies by hand
(SURVEY.md §1); here every configuration is a registry entry.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time


def cmd_list() -> int:
    from nmpc_tpu.scenarios import REGISTRY

    for name, sc in sorted(REGISTRY.items(), key=lambda kv: (kv[1].family, kv[0])):
        kind = "waypoints" if sc.waypoints else "point-goal"
        print(f"{sc.family}  {name:26s} m={sc.m:<2d} N={sc.N:<4d} T={sc.T:<6g} {kind}   [{sc.source}]")
    return 0


def cmd_run(args) -> int:
    import jax

    from nmpc_tpu.mpc.driver import (
        MPCConfig,
        closed_loop,
        closed_loop_waypoints,
        rt_closed_loop,
    )
    from nmpc_tpu.scenarios import get
    from nmpc_tpu.solver.alilqr import ALILQRConfig
    from nmpc_tpu.utils import save_run

    sc = get(args.scenario)
    ocp = sc.make()
    solver_cfg = ALILQRConfig(n_outer=12, n_inner=20, tol_con=1e-4)

    if args.mode != "central":
        # robot-parallel architectures: per-robot subproblems + plan
        # exchange (decentralized: one stale-plan Jacobi round per period;
        # consensus: jointly-converged rounds each period)
        if sc.m < 2 or sc.waypoints:
            print(f"--mode {args.mode} needs a multi-robot point-goal "
                  f"scenario; {args.scenario} is m={sc.m}"
                  f"{' waypoints' if sc.waypoints else ''}", file=sys.stderr)
            return 2
        import numpy as np

        goals = ocp.xref[-1].reshape(sc.m, 3)
        kw = dict(N=ocp.N, T=float(ocp.T), dmin=sc.dmin,
                  max_steps=args.steps, stop_tol=sc.stop_tol,
                  cfg=ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4))
        t0 = time.time()
        if args.mode == "decentralized":
            from nmpc_tpu.parallel.decentralized import decentralized_closed_loop

            X, U, mind, done = jax.jit(functools.partial(
                decentralized_closed_loop, **kw))(ocp.x0, goals)
        else:
            from nmpc_tpu.parallel.consensus import consensus_closed_loop

            X, U, mind, done = jax.jit(functools.partial(
                consensus_closed_loop, **kw))(ocp.x0, goals)
        X.block_until_ready()
        wall = time.time() - t0
        print(f"scenario      {args.scenario} ({args.mode} mode, m={sc.m}, "
              f"N={ocp.N}, T={float(ocp.T):g})")
        print(f"reached       {bool(done)}")
        print(f"min pair dist {float(np.min(np.asarray(mind))):.4f} "
              f"(dmin={sc.dmin})")
        print(f"wall clock    {wall:.1f} s (compile + {args.steps} steps)")
        if args.save:
            np.savez(args.save, X_hist=np.asarray(X), U_hist=np.asarray(U),
                     min_dist_hist=np.asarray(mind))
            print(f"saved         {args.save}")
        return 0 if bool(done) else 1
    if sc.num_rays:
        # family I: the generic drivers cannot run the augmented-state
        # model (the plant is the 3-state pose; the ray tail is re-seeded
        # from a fresh scan each period and pObs re-frozen —
        # obs_avoid_static_first_scenario_v4.py:109-113,296-297), so route
        # through the LiDAR loop against the standard ground-truth world of
        # the closed-loop tests (tests/test_gn_lidar.py): one circle on the
        # straight first leg, radius per version's tested world.
        import jax.numpy as jnp
        import numpy as np

        from nmpc_tpu.mpc.lidar import closed_loop_lidar

        radius = {"lidar_v2": 0.15, "lidar_v3": 0.2}.get(args.scenario, 0.1)
        obstacles = jnp.asarray([[0.5, 0.25, radius]], jnp.float32)
        if sc.Nc is not None:
            # v4 semantics: condensed GN with Nc move blocking
            from nmpc_tpu.solver import gn

            lid_kw = dict(cfg=gn.GNConfig(Nc=sc.Nc, n_gn=10, n_outer=6,
                                          tol_con=1e-3))
        else:
            # v2/v3 semantics: full control horizon on the AL-iLQR engine,
            # with the test-validated ray-bound discretization margin (10
            # sparse rays strike obliquely, so the planned ray distance
            # overstates perpendicular clearance — see
            # test_lidar_v3_closed_loop_ilqr_engine)
            from nmpc_tpu.solver.alilqr import solve as ilqr_solve

            ocp = sc.make(ray_lo=0.25 if args.scenario == "lidar_v3" else 0.3)
            icfg = ALILQRConfig(n_outer=10, n_inner=20, tol_con=1e-3)
            lid_kw = dict(solve_fn=lambda o, w: ilqr_solve(o, w, icfg))
        t0 = time.time()
        X, U, clr, gidx, done = jax.jit(functools.partial(
            closed_loop_lidar, sim_obstacles=obstacles,
            waypoints=sc.waypoint_array, max_steps=args.steps,
            **lid_kw))(ocp)
        X.block_until_ready()
        wall = time.time() - t0
        legs = int(np.asarray(gidx)[-1])
        print(f"scenario      {args.scenario} (family I, {sc.num_rays} rays, "
              f"N={ocp.N}, T={float(ocp.T):g})")
        print(f"tour done     {bool(done)} ({legs}/{len(sc.waypoints)} legs)")
        print(f"min clearance {float(np.min(np.asarray(clr))):.4f} "
              f"(to the obstacle surface; ray bound {sc.robot_radius})")
        print(f"wall clock    {wall:.1f} s (compile + {args.steps} steps)")
        if args.save:
            np.savez(args.save, X_hist=np.asarray(X), U_hist=np.asarray(U),
                     clearance_hist=np.asarray(clr))
            print(f"saved         {args.save}")
        return 0 if bool(done) else 1
    solve_fn = None
    engine = args.engine
    if engine == "auto":
        if sc.Nc is not None and sc.num_rays == 0:
            engine = "gn"     # scenario prescribes a control horizon
        else:
            # batch-native engine at long horizons, per-scenario engine
            # below; the N >= 64 crossover is provisional (ROADMAP)
            engine = "fused" if ocp.N >= 64 else "ilqr"
    if engine == "gn":
        from nmpc_tpu.solver import gn

        # B=1 deployment: the materialized-Jacobian normal equations are
        # ~1.4x lower latency than the scan (memory only matters batched)
        gcfg = gn.GNConfig(Nc=sc.Nc or ocp.N, n_gn=20, n_outer=8, normal="dense")
        solve_fn = lambda o, w: gn.solve(o, w, gcfg)
    elif engine == "fused":
        # batch-native engine at B=1
        from nmpc_tpu.solver.alilqr_batched import solve_one

        solve_fn = lambda o, w: solve_one(o, w, solver_cfg)
    t0 = time.time()
    if sc.waypoints:
        mpc = MPCConfig(max_steps=args.steps, advance_tol=sc.advance_tol, escape=True)
        run = jax.jit(functools.partial(
            closed_loop_waypoints, waypoints=sc.waypoint_array,
            solver_cfg=solver_cfg, mpc=mpc, solve_fn=solve_fn))
    elif args.rt:
        # deployment recipe: one full-strength seed solve, then the cheap
        # 3x10 rt config each period with carried mu (driver.rt_closed_loop
        # defaults — the pinned-safe recipe). This path drives the
        # per-scenario engine, whose line search is the alpha cascade;
        # adaptive LS is a batch-native engine option (solve_fn=solve_one)
        mpc = MPCConfig(max_steps=args.steps, stop_tol=sc.stop_tol, escape=True)
        # rt mode drives the per-scenario AL-iLQR engine: the rt_cfg budget
        # is what defines the mode, so an engine override would bypass it
        run = jax.jit(functools.partial(rt_closed_loop, full_cfg=solver_cfg,
                                        mpc=mpc))
    else:
        mpc = MPCConfig(max_steps=args.steps, stop_tol=sc.stop_tol, escape=True)
        run = jax.jit(functools.partial(closed_loop, solver_cfg=solver_cfg, mpc=mpc,
                                        solve_fn=solve_fn))
    r = run(ocp)
    r.X_hist.block_until_ready()
    wall = time.time() - t0
    import numpy as np

    used = max(int(r.steps_used), 1)
    print(f"scenario      {args.scenario} (family {sc.family}, m={sc.m}, N={ocp.N}, T={float(ocp.T):g})")
    print(f"reached       {bool(r.reached)} in {int(r.steps_used)} steps "
          f"({int(r.steps_used) * float(ocp.T):.1f} s sim time)")
    print(f"final error   {float(r.err_hist[min(used, len(r.err_hist)) - 1]):.4f}")
    if sc.m > 1:
        print(f"min pair dist {float(np.min(np.asarray(r.min_dist_hist))):.4f} (dmin={sc.dmin})")
    print(f"mean iters    {float(np.mean(np.asarray(r.iter_hist)[:used])):.1f} per solve")
    print(f"wall clock    {wall:.1f} s (compile + {int(r.steps_used)} MPC steps)")
    if args.save:
        save_run(args.save, r, meta={"scenario": args.scenario})
        print(f"saved         {args.save}")
    return 0 if bool(r.reached) else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nmpc_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list")
    runp = sub.add_parser("run")
    runp.add_argument("scenario")
    runp.add_argument("--steps", type=int, default=400)
    runp.add_argument("--save", default=None)
    runp.add_argument("--rt", action="store_true",
                      help="real-time mode: full-strength seed solve, then "
                           "reduced-iteration (2x5) warm solves with carried "
                           "mu each period (point-goal scenarios)")
    runp.add_argument("--mode", choices=("central", "decentralized", "consensus"),
                      default="central",
                      help="multi-robot architecture: one joint NLP "
                           "(central), per-robot subproblems with one "
                           "stale-plan exchange round per period "
                           "(decentralized), or robot-parallel jointly-"
                           "converged rounds per period (consensus)")
    runp.add_argument("--engine", choices=("auto", "ilqr", "fused", "gn"),
                      default="auto",
                      help="NLP engine: per-scenario AL-iLQR, the "
                           "batch-native AL-iLQR engine at B=1, or "
                           "condensed Gauss-Newton with move blocking")
    sub.add_parser("bench")
    args = p.parse_args(argv)
    from nmpc_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    if args.cmd == "list":
        return cmd_list()
    if args.cmd == "bench":
        import bench

        bench.main()
        return 0
    return cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
