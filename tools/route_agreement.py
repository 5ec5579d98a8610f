"""Where two solves of one fleet disagree, and why.

The batch-native engine's XLA route on the GPU against the same engine on
the CPU backend, the per-scenario engine on the CPU and the kernel route —
at the bench's stopping rules and at tight ones. Beside each comparison
stands the engine's answer to itself with every start moved by one float32
ulp ("nudge"): rounding alone moves an element that far. For each pair, a
float64 walk along the segment between the two solutions' controls: a
segment whose cost stays flat joins two points of one flat valley; a bump
separates two minima. With --modes: one decentralized step and one
consensus solve on each inner-solve route, timed and compared.

    python tools/route_agreement.py [--n 256] [--parts engines,kernel,modes,gn]

Prints one line per comparison and writes every reading to
chiprun_out/agreement.json.
"""

import argparse
import dataclasses
import functools
import json
import os
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from nmpc_tpu.ocp import problem as P
from nmpc_tpu.parallel.batch import batch_ocp
from nmpc_tpu.scenarios import get
from nmpc_tpu.solver import alilqr_batched as ab
from nmpc_tpu.solver.alilqr import ALILQRConfig, solve

BENCH = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
# stop only where the merit no longer decreases in float32
TIGHT = ALILQRConfig(n_outer=10, n_inner=60, tol_con=1e-5, tol_cost=1e-9, ls="adaptive")
U_ATOL = 5e-3
OUT = "chiprun_out"
READINGS = {}


def log(*a):
    print(*a, flush=True)


def fleet(name, N, B, n):
    """chip_smoke.py's fleet: B starts drawn from PRNGKey(0), first n kept."""
    base = get(name).make(N=N)
    noise = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, base.nx), base.x0.dtype)
    ob = batch_ocp(base, base.x0[None] + noise)
    return dataclasses.replace(ob, x0=ob.x0[:n], xref=ob.xref[:n])


def nudge(ob):
    """Every start moved by one float32 ulp."""
    return dataclasses.replace(ob, x0=jnp.nextafter(ob.x0, jnp.inf))


def solve_on(ob, cfg, device, route="xla"):
    ob = jax.device_put(ob, device)
    f = jax.jit(functools.partial(ab._solve_batched, warm=None, cfg=cfg, route=route))
    t0 = time.perf_counter()
    r = f(ob)
    r.U.block_until_ready()
    return jax.tree.map(np.asarray, r), time.perf_counter() - t0


def per_scenario_on(ob, cfg, device):
    """The per-scenario engine (alpha cascade) vmapped over the batch."""
    ob = jax.device_put(ob, device)

    def one(x0, xref):
        return solve(dataclasses.replace(ob, x0=x0, xref=xref), cfg=cfg)

    t0 = time.perf_counter()
    r = jax.jit(jax.vmap(one))(ob.x0, ob.xref)
    r.U.block_until_ready()
    return jax.tree.map(np.asarray, r), time.perf_counter() - t0


def walk(ob, Ua, Ub, idx):
    """float64 cost and violation along U(t) = (1-t) Ua + t Ub, t in
    {0, 1/4, 1/2, 3/4, 1}, for the elements idx; returns the largest rise
    of the cost above the higher end point (relative to 1+|cost|), the
    largest end-point cost gap (same scale) and the largest violation."""
    if len(idx) == 0:
        return 0.0, 0.0, 0.0
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True):
        o = jax.device_put(dataclasses.replace(ob, x0=ob.x0[idx], xref=ob.xref[idx]), cpu)
        o = jax.tree.map(lambda a: a.astype(jnp.float64)
                         if jnp.issubdtype(a.dtype, jnp.floating) else a, o)
        ua, ub = (jnp.asarray(u[idx], jnp.float64) for u in (Ua, Ub))

        def cost_viol(u):
            def one(oo, uu):
                x = P.rollout(oo, uu)
                return P.total_cost(oo, x, uu), P.max_violation(oo, x, uu)

            return ab._vm(one, o, u)

        ts = (0.0, 0.25, 0.5, 0.75, 1.0)
        J, V = zip(*[jax.jit(cost_viol)((1 - t) * ua + t * ub) for t in ts])
        J, V = np.stack([np.asarray(j) for j in J]), np.stack([np.asarray(v) for v in V])
    scale = 1.0 + np.abs(J[0])
    bump = np.max((J.max(0) - np.maximum(J[0], J[-1])) / scale)
    gap = np.max(np.abs(J[0] - J[-1]) / scale)
    return float(bump), float(gap), float(V.max())


def compare(tag, ob, a, b, n=None):
    Ua, Ub = a.U[:n], b.U[:n]
    err = np.max(np.abs(Ua - Ub).reshape(Ua.shape[0], -1), axis=1)
    rel = np.abs(a.cost[:n] - b.cost[:n]) / (1.0 + np.abs(b.cost[:n]))
    far = np.nonzero(err > U_ATOL)[0]
    bump, gap, vmax = walk(ob, Ua, Ub, far)
    r = dict(n=int(Ua.shape[0]), u_share=float(np.mean(err <= U_ATOL)),
             u_share_5e2=float(np.mean(err <= 5e-2)), u_median=float(np.median(err)),
             u_max=float(err.max()), cost_rel_max=float(rel.max()),
             cost_rel_p99=float(np.percentile(rel, 99)),
             conv=(float(np.mean(a.converged[:n])), float(np.mean(b.converged[:n]))),
             n_far=int(len(far)), walk_bump=bump, walk_gap=gap, walk_viol_max=vmax)
    READINGS[tag] = r
    log(f"  {tag}: {r['u_share'] * 100:.2f}% with |dU| <= {U_ATOL} "
        f"({r['u_share_5e2'] * 100:.2f}% <= 5e-2; median {r['u_median']:.2e}, "
        f"max {r['u_max']:.2e}); cost rel max {r['cost_rel_max']:.2e} "
        f"(p99 {r['cost_rel_p99']:.2e}); converged {r['conv'][0]:.4f} vs "
        f"{r['conv'][1]:.4f}; f64 walk over the {r['n_far']} elements beyond "
        f"{U_ATOL}: cost rise {bump:.2e}, end gap {gap:.2e}, viol max {vmax:.2e}")


def engines(name, N, B, n):
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    ob = fleet(name, N, B, n)
    log(f"[{name} N={N}, first {n} of B={B}]")
    res = {}
    for tag, cfg in (("bench", BENCH), ("tight", TIGHT)):
        res[tag, "gpu"], t_g = solve_on(ob, cfg, gpu)
        res[tag, "nudge"], _ = solve_on(nudge(ob), cfg, gpu)
        res[tag, "cpu"], t_c = solve_on(ob, cfg, cpu)
        log(f"  {tag} {cfg}: gpu {t_g:.1f} s, cpu {t_c:.1f} s (with compile); "
            f"mean inner iters gpu {res[tag, 'gpu'].inner_iters.mean():.1f}")
        compare(f"{name} {tag}: xla GPU vs xla CPU", ob, res[tag, "gpu"], res[tag, "cpu"])
        compare(f"{name} {tag}: xla GPU vs xla GPU nudged", ob, res[tag, "gpu"],
                res[tag, "nudge"])
    compare(f"{name}: bench GPU vs tight GPU", ob, res["bench", "gpu"], res["tight", "gpu"])
    # the per-scenario engine has the alpha cascade only: the witness runs
    # the bench config with it, against the batched engine with it
    cas = dataclasses.replace(BENCH, ls="cascade")
    ps, t_p = per_scenario_on(ob, cas, cpu)
    bc, _ = solve_on(ob, cas, cpu)
    bg, _ = solve_on(ob, cas, gpu)
    log(f"  per-scenario engine (bench config, cascade) on CPU: {t_p:.1f} s")
    compare(f"{name} cascade: per-scenario CPU vs xla CPU", ob, ps, bc)
    compare(f"{name} cascade: per-scenario CPU vs xla GPU", ob, ps, bg)


def gn_engines(B=1024, n=128):
    """The LiDAR-v4 GN fleet (chip_smoke's) on the GPU against the CPU
    backend and against its own nudge, at chip_smoke's config and at one
    with more iterations."""
    from nmpc_tpu.scenarios.fleets import lidar_v4_fleet
    from nmpc_tpu.solver import gn

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    ob, cfg = lidar_v4_fleet(B, jax.random.PRNGKey(5))
    ob = dataclasses.replace(ob, x0=ob.x0[:n], xref=ob.xref[:n])
    log(f"[lidar_v4 GN fleet, first {n} of B={B}]")
    for tag, c in (("smoke", cfg), ("long", dataclasses.replace(cfg, n_outer=8, n_gn=30))):
        f = jax.jit(functools.partial(gn.solve_batched, cfg=c))
        rg, rn = (jax.tree.map(np.asarray, f(jax.device_put(o, gpu))) for o in (ob, nudge(ob)))
        rc = jax.tree.map(np.asarray, f(jax.device_put(ob, cpu)))
        compare(f"GN {tag} {c.n_outer}x{c.n_gn}: GPU vs CPU", ob, rg, rc)
        compare(f"GN {tag} {c.n_outer}x{c.n_gn}: GPU vs GPU nudged", ob, rg, rn)


def kernel_six(B=32768):
    gpu = jax.devices()[0]
    ob = fleet("six_robot_antipodal", 10, B, B)
    log(f"[six_robot_antipodal N=10 B={B}: kernel route vs XLA route, bench config]")
    rx, tx = solve_on(ob, BENCH, gpu, "xla")
    rk, tk = solve_on(ob, BENCH, gpu, "triton")
    rn, _ = solve_on(nudge(ob), BENCH, gpu, "xla")
    log(f"  first call xla {tx:.1f} s, triton {tk:.1f} s")
    compare("six_robot kernel vs xla (GPU, bench)", ob, rk, rx)
    compare("six_robot xla vs xla nudged (GPU, bench)", ob, rn, rx)


def time_calls(f, args_fn, n=7):
    ts = []
    for i in range(n):
        a = args_fn(i)
        jax.block_until_ready(a)
        t0 = time.perf_counter()
        jax.block_until_ready(f(*a))
        ts.append(time.perf_counter() - t0)
    return np.asarray(ts)


def modes():
    """One decentralized step and one consensus solve (3 rounds, the
    closed loop's per-period work) of the CLI's six-robot antipodal loops,
    on each route of the batched engine."""
    from nmpc_tpu.parallel.consensus import consensus_solve
    from nmpc_tpu.parallel.decentralized import decentralized_step, robot_template
    from nmpc_tpu.solver.alilqr import cold_start

    sc = get("six_robot_antipodal")
    ocp = sc.make()
    m, N, rh = sc.m, ocp.N, 0.1
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)
    tpl = robot_template(N, float(ocp.T), sc.dmin + rh, m)
    goals = ocp.xref[-1].reshape(m, 3)
    plans = jnp.tile(ocp.x0.reshape(m, 3)[:, None, :2], (1, N + 1, 1))
    warms = jax.vmap(lambda _: cold_start(tpl, cfg))(jnp.arange(m))
    log(f"[modes: six_robot_antipodal m={m} N={N}, {cfg}]")

    def x_at(i):
        return ocp.x0 + 0.01 * i

    fns = {
        "decentralized step": lambda r: jax.jit(lambda x: decentralized_step(
            tpl, x, goals, plans, warms, cfg, rh_bias=rh, engine="fused")[1]),
        "consensus solve (3 rounds)": lambda r: jax.jit(lambda x: consensus_solve(
            tpl, x, goals, cfg, rounds=3, damping=0.5, engine="fused", rh_bias=rh)[1]),
    }
    for tag, make in fns.items():
        out = {}
        for r in ab.ROUTES:
            with mock.patch.object(ab, "choose_route", lambda o, c, r=r: r):
                f = make(r)
                t0 = time.perf_counter()
                u = jax.block_until_ready(f(ocp.x0))
                first = time.perf_counter() - t0
            ts = time_calls(f, lambda i: (x_at(i + 1),))
            out[r] = np.asarray(u)
            READINGS[f"{tag} [{r}]"] = dict(first_s=first, p50_ms=float(np.median(ts)) * 1e3,
                                            min_ms=float(ts.min()) * 1e3,
                                            max_ms=float(ts.max()) * 1e3)
            log(f"  {tag} [{r}]: first call {first:.1f} s; warm p50 "
                f"{np.median(ts) * 1e3:.2f} ms [min {ts.min() * 1e3:.2f}, max "
                f"{ts.max() * 1e3:.2f}] over {len(ts)}")
        with mock.patch.object(ab, "choose_route", lambda o, c: "xla"):
            un = np.asarray(make("xla")(jnp.nextafter(ocp.x0, jnp.inf)))
        d = float(np.max(np.abs(out["triton"] - out["xla"])))
        dn = float(np.max(np.abs(un - out["xla"])))
        READINGS[f"{tag} max |dU|"] = dict(triton_vs_xla=d, xla_nudged_vs_xla=dn)
        log(f"    {tag}: max |dU| triton vs xla {d:.2e}; xla with the start "
            f"moved one ulp vs xla {dn:.2e}")

    # the CLI's closed loops (30 periods), compiled once per route
    from nmpc_tpu.parallel.consensus import consensus_closed_loop
    from nmpc_tpu.parallel.decentralized import decentralized_closed_loop

    kw = dict(N=N, T=float(ocp.T), dmin=sc.dmin, max_steps=30, stop_tol=sc.stop_tol,
              cfg=cfg)
    for tag, loop in (("decentralized loop", decentralized_closed_loop),
                      ("consensus loop", consensus_closed_loop)):
        for r in ab.ROUTES:
            with mock.patch.object(ab, "choose_route", lambda o, c, r=r: r):
                f = jax.jit(functools.partial(loop, **kw))
                t0 = time.perf_counter()
                X = jax.block_until_ready(f(ocp.x0, goals))[0]
                first = time.perf_counter() - t0
            ts = time_calls(lambda x: f(x, goals), lambda i: (x_at(i + 1),), n=3)
            READINGS[f"{tag} [{r}]"] = dict(first_s=first, p50_ms=float(np.median(ts)) * 1e3)
            log(f"  {tag} [{r}], 30 periods: first call {first:.1f} s; warm p50 "
                f"{np.median(ts) * 1e3:.2f} ms = {np.median(ts) / 30 * 1e3:.2f} ms per "
                f"period; final distance to goals "
                f"{float(jnp.linalg.norm(X[-1] - ocp.xref[-1])):.4f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--parts", default="engines,kernel,modes,gn")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if jax.default_backend() != "gpu":
        raise SystemExit("needs a GPU")
    os.makedirs(OUT, exist_ok=True)
    import subprocess

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    if "engines" in parts:
        engines("six_robot_antipodal", 10, 32768, args.n)
        engines("ten_robot", 20, 4096, args.n)
    if "modes" in parts:
        modes()
    if "gn" in parts:
        gn_engines()
    if "kernel" in parts:
        kernel_six()
    with open(f"{OUT}/agreement.json", "w") as f:
        json.dump(READINGS, f, indent=1)


if __name__ == "__main__":
    main()
