"""Generate docs/LATENCY.md: per-step MPC latency vs the reference's
real-time budget (BASELINE metric: 'p99 per-step solve latency vs IPOPT' —
the budget is the control period T, which the serial IPOPT solve must fit
inside; SURVEY.md §6).

Two measurements:

1. ON-DEVICE closed loop (the deployment claim): the whole MPC step chain —
   solve (batch-native engine, solve_one at B=1) -> first control ->
   plant -> shift warm start —
   runs as one jitted lax.scan of K steps that never returns to host.
   Per-step time = chunk wall-clock / K, synchronously timed (a value forced
   to host after each chunk); p50/p99 over M jittered chunk invocations.
   Each chunk restarts from the jittered initial state with the seeded warm
   start, so it times the HARD phase of the maneuver (the crossing), not the
   post-arrival no-op steady state.

2. Per-call latency: one solve per blocking call, host dispatch included
   (the per-scenario engine, and the batch-native engine at B=1).

Run on the accelerator: python tools/gen_latency.py   (writes
docs/LATENCY.md, naming the device it ran on)
"""

import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from nmpc_tpu.scenarios import get
from nmpc_tpu.mpc.driver import shift_warm, steady_warm
from nmpc_tpu.ocp import problem as P
from nmpc_tpu.sim.plant import PlantConfig, plant_step
from nmpc_tpu.solver.alilqr import ALILQRConfig, solve
from nmpc_tpu.solver.alilqr_batched import solve_one
from nmpc_tpu.utils import latency_stats

CASES = [
    ("single_robot", {}),          # T=0.01, N=50
    ("tb3_1", {}),                 # T=0.01, N=200 (longest horizon)
    ("two_robot_swap", {}),        # T=0.02, N=100
    ("five_robot", {}),            # T=0.02, N=70
    ("six_robot_antipodal", {}),   # T=0.2,  N=35 (headline)
    ("eight_robot", {}),           # T=0.02, N=5
    ("ten_robot", {}),             # T=0.1,  N=20
]

CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)
# the rt deployment recipe (mpc/driver.rt_closed_loop defaults + the
# noise-safe tube margin): 3x10 carried-mu solves on the OCP tightened by
# 3 cm (solve with dmin + 0.03) — the configuration actually pinned safe
# under noise/delay by tests/test_rt_mode.py::
# test_rt_closed_loop_six_robot_noise_and_delay
CFG_RT = ALILQRConfig(n_outer=3, n_inner=10, tol_con=1e-4)
# NOTE: tol_con here is 1e-4 vs the driver default rt_cfg's 1e-3 — this
# harness measures the noise-safe PUBLISHED recipe (tighter convergence on
# the tightened OCP), a deliberately stricter configuration than the
# driver's permissive default; the difference is recorded so the latency
# table and the driver docs point at the same object (advisor round 4).
# same recipe on the adaptive per-element line search (the bench engine's LS)
CFG_RT_AD = dataclasses.replace(CFG_RT, ls="adaptive")
# The mu_init=100 seed lever is a per-deployment OPTION, not the default
# (arrival stalls on six_robot_impl / eight-robot N=25 —
# driver.rt_closed_loop docstring).
# This harness measures the default recipe; pass seed_cfg to
# measure_ondevice to A/B the lever on a specific deployment.
TIGHTEN_M = 0.03  # tube margin [m] on dmin for the rt deployment solve


def tightened(ocp):
    """The rt deployment OCP: dmin tightened by the 3 cm tube margin
    (controller solves the tightened problem; safety is judged on the true
    dmin — tests/test_rt_mode.py)."""
    if not ocp.n_pairs:
        return ocp
    dmin = float(np.sqrt(float(ocp.dmin2)))
    return dataclasses.replace(
        ocp, dmin2=jnp.asarray((dmin + TIGHTEN_M) ** 2, ocp.dmin2.dtype))

K = 20   # MPC steps per jitted chunk
M = 40   # chunk invocations (p99 tail resolution)


def make_chunk(ocp_solve, ocp_true, cfg, delay_compensate=False):
    """K MPC steps fully on device: solve_one -> u0 -> plant -> shift.

    ocp_solve is what the controller solves (possibly tightened); ocp_true
    provides the plant period and the realized-clearance metric.
    delay_compensate=True runs the reference's deployment timing (control
    lands one period late) with the latch predicted one period forward
    under the in-flight control (MPCConfig.delay semantics)."""

    def min_d2(x):
        if not ocp_true.n_pairs:
            return jnp.asarray(jnp.inf, x.dtype)
        return jnp.min(P.pairwise_sq_distances(ocp_true, x))

    def chunk(x0, warm):
        def step(carry, _):
            x, w, u_prev = carry
            if delay_compensate:
                x_solve, _ = plant_step(x, u_prev, ocp_true.T, PlantConfig())
            else:
                x_solve = x
            res = solve_one(dataclasses.replace(ocp_solve, x0=x_solve), w, cfg)
            u_apply = u_prev if delay_compensate else res.U[0]
            xn, _ = plant_step(x, u_apply, ocp_true.T, PlantConfig())
            wn = shift_warm(res, cfg, mu_reset=False)
            return (xn, wn, res.U[0]), (res.viol, res.inner_iters, min_d2(xn))

        u00 = jnp.zeros((ocp_true.nu,), x0.dtype)
        (xF, wF, _), (viols, iters, d2) = jax.lax.scan(
            step, (x0, warm, u00), None, length=K)
        return xF, jnp.max(viols), jnp.sum(iters), jnp.sqrt(jnp.min(d2))

    return jax.jit(chunk)


def measure_ondevice(ocp, cfg, tighten=False, delay_compensate=False,
                     seed_cfg=None):
    """Per-step on-device latency stats over M jittered K-step chunks.
    seed_cfg overrides the seed-solve recipe."""
    ocp_solve = tightened(ocp) if tighten else ocp
    seed = jax.jit(functools.partial(solve, cfg=seed_cfg or CFG))(ocp_solve)
    _ = float(seed.cost)
    warm = shift_warm(seed, cfg, mu_reset=False)
    f = make_chunk(ocp_solve, ocp, cfg, delay_compensate)
    x, v, it, d = f(ocp.x0, warm)
    _ = float(v)  # compile + hard sync
    key = jax.random.PRNGKey(0)
    samples, viols, iters, dists = [], [], [], []
    for _ in range(M):
        key, sub = jax.random.split(key)
        x0 = ocp.x0 + 0.01 * jax.random.normal(sub, ocp.x0.shape, ocp.x0.dtype)
        x0.block_until_ready()
        t0 = time.perf_counter()
        xF, v, it, d = f(x0, warm)
        _ = float(v)  # force a value to host (synchronous timing)
        samples.append((time.perf_counter() - t0) / K)
        viols.append(float(v))
        iters.append(float(it) / K)
        dists.append(float(d))
    st = latency_stats(samples)
    st["viol"] = float(np.max(viols))
    st["iters"] = float(np.mean(iters))
    st["min_dist"] = float(np.min(dists))
    return st


def measure_percall(ocp, cfg, engine=None):
    f = jax.jit(engine if engine is not None
                else functools.partial(solve, cfg=cfg))
    f_full = jax.jit(functools.partial(solve, cfg=CFG))
    res_full = f_full(ocp)
    _ = float(res_full.cost)
    r0 = f(ocp)
    _ = float(r0.cost)
    res = res_full
    warm = steady_warm(res)
    key = jax.random.PRNGKey(0)
    samples, viols = [], []
    for i in range(30):
        key, sub = jax.random.split(key)
        x0 = ocp.x0 + 0.01 * jax.random.normal(sub, ocp.x0.shape, ocp.x0.dtype)
        ocp_i = dataclasses.replace(ocp, x0=x0)
        t0 = time.perf_counter()
        res = f(ocp_i, warm)
        res.U.block_until_ready()
        samples.append(time.perf_counter() - t0)
        viols.append(float(res.viol))
        warm = steady_warm(res)
    st = latency_stats(samples)
    st["viol"] = float(np.max(viols))
    return st


def measure_lidar(K: int = 20, M: int = 30):
    """Family-I on-device closed loop: the published lidar_v4 config
    (obs_avoid_static_first_scenario_v4.py:59-75 — N=100, Nc=50, 10 rays,
    1/d cost, budget T=0.075 s) through mpc/lidar.closed_loop_lidar
    (raycast -> re-seed -> frozen pObs -> condensed-GN solve -> plant) as
    one jitted K-step scan. GN runs fixed iteration shapes, so per-step
    cost is constant; p50/p99 over M jittered invocations."""
    from nmpc_tpu.mpc.lidar import closed_loop_lidar
    from nmpc_tpu.scenarios import get
    from nmpc_tpu.solver import gn

    sc = get("lidar_v4")
    ocp = sc.make()
    obstacles = jnp.array([[0.5, 0.25, 0.1], [0.4, -0.3, 0.12]], jnp.float32)
    wps = jnp.asarray(sc.waypoints, jnp.float32)
    # B=1 closed loop: dense normal equations (lower latency; the scan
    # form exists for batched memory scale)
    cfg = gn.GNConfig(Nc=sc.Nc, n_gn=10, n_outer=4, tol_con=1e-3,
                      normal="dense")
    f = jax.jit(functools.partial(
        closed_loop_lidar, sim_obstacles=obstacles, waypoints=wps,
        cfg=cfg, max_steps=K))
    X, U, clr, gidx, done = f(ocp)
    _ = float(clr[0])  # compile + sync
    key = jax.random.PRNGKey(0)
    samples, clears = [], []
    for _ in range(M):
        key, sub = jax.random.split(key)
        pose = ocp.x0[:3] + 0.02 * jax.random.normal(sub, (3,), ocp.x0.dtype)
        x0 = jnp.concatenate([pose, ocp.x0[3:]])
        x0.block_until_ready()
        ocp_i = dataclasses.replace(ocp, x0=x0)
        t0 = time.perf_counter()
        X, U, clr, gidx, done = f(ocp_i)
        _ = float(clr[0])
        samples.append((time.perf_counter() - t0) / K)
        clears.append(float(jnp.min(clr)))
    st = latency_stats(samples)
    st["min_clearance"] = float(np.min(clears))
    return st


def lidar_section(st) -> str:
    return (
        "\n## Family I on-device closed loop (LiDAR v4)\n\n"
        "The published v4 config (N=100, Nc=50, 10 rays, 1/d cost,\n"
        "obs_avoid_static_first_scenario_v4.py:59-75) through the full\n"
        "raycast -> re-seed -> frozen-pObs -> condensed-GN -> plant chain\n"
        "as one jitted 20-step scan (GN iteration shape is fixed, so\n"
        "per-step cost is constant).\n\n"
        "| scenario | budget ms | p50 | p99 | p99<=budget | min clearance |\n"
        "|---|---|---|---|---|---|\n"
        f"| lidar_v4 | 75 | {st['p50_ms']:.2f} | {st['p99_ms']:.2f} | "
        f"{'yes' if st['p99_ms'] <= 75.0 else 'no'} | "
        f"{st['min_clearance']:.3f} |\n"
    )


def main():
    # host dispatch floor: a trivial jitted call, blocking
    triv = jax.jit(lambda x: x + 1.0)
    _ = triv(jnp.zeros(8)).block_until_ready()
    rtt = []
    for _ in range(20):
        t0 = time.perf_counter()
        triv(jnp.zeros(8)).block_until_ready()
        rtt.append(time.perf_counter() - t0)
    rtt_ms = float(np.median(rtt) * 1e3)
    dev = jax.devices()[0]
    print(f"{dev.device_kind}: dispatch floor (trivial jit call) "
          f"{rtt_ms:.2f} ms", flush=True)

    dev_rows, call_rows = [], []
    for name, over in CASES:
        sc = get(name)
        ocp = sc.make(**over)
        budget_ms = float(ocp.T) * 1e3
        dv_full = measure_ondevice(ocp, CFG)
        dv_rt = measure_ondevice(ocp, CFG_RT, tighten=True)
        dv_ad = measure_ondevice(ocp, CFG_RT_AD, tighten=True)
        dev_rows.append((name, sc.m, ocp.N, budget_ms, dv_full, dv_rt, dv_ad))
        print(f"{name}: on-device full p50/p99 {dv_full['p50_ms']:.2f}/"
              f"{dv_full['p99_ms']:.2f} ms | rt p50/p99 {dv_rt['p50_ms']:.2f}/"
              f"{dv_rt['p99_ms']:.2f} ms ({dv_rt['iters']:.1f} iters/step, "
              f"min dist {dv_rt['min_dist']:.3f}) | rt-ad p50/p99 "
              f"{dv_ad['p50_ms']:.2f}/{dv_ad['p99_ms']:.2f} ms "
              f"({dv_ad['iters']:.1f} iters/step) | budget {budget_ms:.0f} ms",
              flush=True)

    # delay-mode row: the headline scenario under the reference's deployment
    # timing (control lands one period late) with compensation on
    sc6 = get("six_robot_antipodal")
    ocp6 = sc6.make()
    dv_delay = measure_ondevice(ocp6, CFG_RT, tighten=True,
                                delay_compensate=True)
    print(f"six_robot_antipodal (delay-compensated rt): p50/p99 "
          f"{dv_delay['p50_ms']:.2f}/{dv_delay['p99_ms']:.2f} ms | min dist "
          f"{dv_delay['min_dist']:.3f}", flush=True)

    for name, over in CASES:
        sc = get(name)
        ocp = sc.make(**over)
        budget_ms = float(ocp.T) * 1e3
        st = measure_percall(ocp, CFG)
        rt = measure_percall(ocp, CFG_RT)
        fz = measure_percall(ocp, CFG_RT,
                             engine=functools.partial(solve_one, cfg=CFG_RT))
        call_rows.append((name, sc.m, ocp.N, budget_ms, st, rt, fz))
        fz_s = f"{fz['p50_ms']:.2f}" if fz else "-"
        print(f"{name}: per-call full p50 {st['p50_ms']:.2f} ms | rt p50 "
              f"{rt['p50_ms']:.2f} ms | batched rt p50 {fz_s} ms", flush=True)

    lid = measure_lidar()
    print(f"lidar_v4: on-device p50/p99 {lid['p50_ms']:.2f}/"
          f"{lid['p99_ms']:.2f} ms | min clearance {lid['min_clearance']:.3f} "
          f"| budget 75 ms", flush=True)

    os.makedirs("docs", exist_ok=True)
    with open("docs/LATENCY.md", "w") as f:
        f.write(
            "# Per-step MPC latency vs real-time budget\n\n"
            "Budget = the reference's control period T (the serial IPOPT\n"
            "solve must fit inside it for the loop to run at rate;\n"
            "BASELINE metric: p99 per-step solve latency vs IPOPT).\n\n"
            f"Device: {dev.device_kind} ({dev.platform}), synchronous "
            "timing.\n\n"
            "## On-device closed loop (the deployment claim)\n\n"
            "The whole MPC step chain — solve_one (B=1), first\n"
            "control, plant, shift warm start — runs as ONE jitted lax.scan\n"
            f"of {K} steps that never returns to host. Per-step time =\n"
            f"chunk/{K}, synchronously timed; p50/p99 over {M} jittered\n"
            "chunk invocations restarting from the maneuver's hard phase.\n"
            "'full' = 6x12 solver config on the published OCP; 'rt' = the\n"
            "PINNED-SAFE deployment recipe — 3x10 carried-mu solves on the\n"
            "OCP tightened by the 3 cm tube margin (dmin + 0.03), the\n"
            "configuration tests/test_rt_mode.py::\n"
            "test_rt_closed_loop_six_robot_noise_and_delay holds\n"
            "collision-safe under noise across seeds; 'rt-ad' = the same\n"
            "recipe on the adaptive per-element line search. 'realized min\n"
            "dist' is the worst realized pairwise clearance over every\n"
            "timed chunk, judged against the TRUE dmin (inf = single\n"
            "robot).\n\n"
            "| scenario | m | N | budget ms | full p50 | full p99 | rt p50 | rt p99 | rt-ad p50 | rt-ad p99 | rt iters/step | realized min dist (dmin) | rt p99<=budget |\n"
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|\n"
        )
        for name, m, N, budget, dfull, drt, dad in dev_rows:
            dmin = float(np.sqrt(float(get(name).make().dmin2))) if m > 1 else 0.0
            md = ("inf" if not np.isfinite(drt["min_dist"])
                  else f"{drt['min_dist']:.3f} ({dmin:.2f})")
            f.write(
                f"| {name} | {m} | {N} | {budget:.0f} | "
                f"{dfull['p50_ms']:.2f} | {dfull['p99_ms']:.2f} | "
                f"{drt['p50_ms']:.2f} | {drt['p99_ms']:.2f} | "
                f"{dad['p50_ms']:.2f} | {dad['p99_ms']:.2f} | "
                f"{drt['iters']:.1f} | {md} | "
                f"{'yes' if drt['p99_ms'] <= budget else 'no'} |\n"
            )
        f.write(
            "\n### Compute-delay deployment timing (headline scenario)\n\n"
            "The reference's real timing: the plant keeps moving while the\n"
            "solver runs and the control lands one period late; the rt\n"
            "recipe predicts the latched measurement one period forward\n"
            "under the in-flight control (MPCConfig.delay_compensate).\n\n"
            "| scenario | mode | p50 | p99 | realized min dist (dmin) |\n"
            "|---|---|---|---|---|\n"
            f"| six_robot_antipodal | rt + delay=1 compensated | "
            f"{dv_delay['p50_ms']:.2f} | {dv_delay['p99_ms']:.2f} | "
            f"{dv_delay['min_dist']:.3f} (0.30) |\n"
        )
        f.write(
            "\n## Per-call latency (host dispatch included)\n\n"
            "One solve per blocking call; a trivial jitted call takes\n"
            f"~{rtt_ms:.2f} ms here. 'batched rt' is the batch-native\n"
            "engine (solve_one) at B=1 on the rt recipe.\n\n"
            "| scenario | m | N | budget ms | full p50 | full p99 | rt p50 | rt p99 | batched rt p50 | rt max viol |\n"
            "|---|---|---|---|---|---|---|---|---|---|\n"
        )
        for name, m, N, budget, st, rt, fz in call_rows:
            fz_s = f"{fz['p50_ms']:.2f}" if fz else "-"
            f.write(
                f"| {name} | {m} | {N} | {budget:.0f} | {st['p50_ms']:.2f} | "
                f"{st['p99_ms']:.2f} | {rt['p50_ms']:.2f} | {rt['p99_ms']:.2f} | "
                f"{fz_s} | {rt['viol']:.1e} |\n"
            )
        f.write(lidar_section(lid))
        f.write(
            "\nNotes:\n\n"
            "* The on-device rt recipe carries the penalty weight mu with\n"
            "  the multipliers (mpc/driver.steady_warm): resetting mu under\n"
            "  carried lam breaks the PHR activation band (round-1 finding).\n"
            "* Every rt number in the on-device table is the SAME recipe the\n"
            "  test suite pins safe (3x10, carried mu, 3 cm tightening,\n"
            "  delay compensation when delayed): no deployment number here\n"
            "  lives outside a test.\n"
            "* The per-call table's rt columns run the UNtightened OCP (a\n"
            "  dispatch-path regression tracker, not a deployment claim);\n"
            "  its 'rt max viol' is the worst planned-trajectory violation\n"
            "  (future stages, squared-distance units).\n"
            "* Throughput is a different regime: see bench.py (synchronous\n"
            "  timing, B=32768).\n"
        )
    print("wrote docs/LATENCY.md")


if __name__ == "__main__":
    main()
