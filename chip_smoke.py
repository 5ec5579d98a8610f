"""Chip smoke test: the main paths of nmpc_tpu on one GPU, end to end.

    python chip_smoke.py               # one card, phases 0-4
    python chip_smoke.py --four-cards  # the cross-device paths on 4 cards

Phases run in order in one process; the first that fails ends the run with a
non-zero exit code. There is no CPU fallback: without a GPU the script fails
in phase 0. The last line of standard output is one JSON object naming the
device.

Precision: float32 throughout, with every matmul in true float32
(`jax_default_matmul_precision="float32"`, set by the package) — no TF32.

Comparisons, element by element, of a route against another, the GPU
against the CPU backend, or a sharded solve against an unsharded one. Each
stands beside a floor: the XLA route on the GPU against itself with every
start moved by one float32 ulp, over the same elements. Near-ties between
line-search candidates make some elements answer a rounding-sized change by
taking another path and stopping elsewhere in one flat valley of the merit
(the float64 cost along the segment between two such answers never rises
above its ends), so two correct solves agree on U only about as often as
the floor does; tools/route_agreement.py measures this and PERF.md holds
its readings. A comparison passes when
  * every element's cost agrees within 5e-3 relative (|dcost| / (1+|cost|)),
    or within twice the floor's largest gap if that is more: 1.7x the
    largest gap between a stop at the bench's rules and a tight stop
    (2.9e-3), 2.7x the largest disagreement read (1.9e-3);
  * its share of elements with max |dU| <= 5e-3 (the per-element bound of
    tests/test_batched_solver.py) is at most 10 points (or 3 binomial
    standard deviations, if more) below the floor's share: the largest
    shortfall read was 5.5 points;
  * the converged shares differ by at most 1 point (or 3 standard
    deviations, if more).
The GN fleet against the CPU backend is judged on cost and convergence
only; `gn_fleet` says why.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from nmpc_tpu.parallel.batch import batch_ocp
from nmpc_tpu.scenarios import get
from nmpc_tpu.scenarios.fleets import lidar_v4_fleet, ltv_qp_fleet
from nmpc_tpu.solver import alilqr_batched as ab
from nmpc_tpu.solver.alilqr import ALILQRConfig, solve
from nmpc_tpu.utils.compile_cache import setup_compile_cache

U_ATOL = 5e-3
U_SHARE_MARGIN = 0.10
COST_RTOL = 5e-3
CONV_TOL = 0.01
N_TIMED = 5
FLEET_CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
OUT = "chiprun_out"


def log(*a):
    print(*a, flush=True)


def gpu_routes(ocp_b, cfg):
    """The batched engine's routes for this problem on the GPU: the XLA
    reference, and the kernel where the route rule selects it."""
    return ("xla",) + (("triton",) if ab.choose_route(ocp_b, cfg) == "triton" else ())


def on_route(route, cfg):
    return jax.jit(functools.partial(ab._solve_batched, warm=None, cfg=cfg, route=route))


def nudge(ob):
    """Every start moved by one float32 ulp."""
    return dataclasses.replace(ob, x0=jnp.nextafter(ob.x0, jnp.inf))


# ---------------------------------------------------------------- phase 0


def phase_device(n_cards: int):
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"phase 0: default backend is {backend!r}, not 'gpu'")
    devs = jax.devices()
    if len(devs) < n_cards:
        raise SystemExit(f"phase 0: need {n_cards} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[0] nvidia-smi: {smi}")
    log(f"[0] devices: {devs}")
    log(f"[0] jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[0] compile cache: {setup_compile_cache()}")
    log(f"[0] matmul precision: {jax.config.jax_default_matmul_precision}")
    return devs


# ---------------------------------------------------------------- helpers


def fleet_batch(name: str, N: int, B: int, key) -> object:
    base = get(name).make(N=N)
    noise = 0.1 * jax.random.normal(key, (B, base.nx), base.x0.dtype)
    return base, batch_ocp(base, base.x0[None] + noise)


def time_fleet(run, ob, base, key, n=N_TIMED, place=lambda o: o):
    """Synchronous timing of n batches with fresh starts, each laid out by
    `place` before its clock starts; returns seconds."""
    ts = []
    B = ob.x0.shape[0]
    for _ in range(n):
        key, sub = jax.random.split(key)
        x0s = base.x0[None] + 0.1 * jax.random.normal(sub, (B, base.nx), base.x0.dtype)
        obi = place(dataclasses.replace(ob, x0=x0s))
        jax.block_until_ready(obi)
        t0 = time.perf_counter()
        run(obi).cost.block_until_ready()
        ts.append(time.perf_counter() - t0)
    return np.asarray(ts)


def stats_line(res) -> str:
    conv = float(np.mean(np.asarray(res.converged)))
    p99 = float(np.percentile(np.asarray(res.viol), 99))
    it = float(np.mean(np.asarray(res.inner_iters)))
    return f"converged {conv:.4f}, viol p99 {p99:.3e}, mean inner iters {it:.2f}"


def agreement(a, b, n=None) -> dict:
    """Per-element agreement of two SolveResults over their first n elements."""
    Ua, Ub = np.asarray(a.U)[:n], np.asarray(b.U)[:n]
    err = np.max(np.abs(Ua - Ub).reshape(Ua.shape[0], -1), axis=1)
    ca, cb = np.asarray(a.cost)[:n], np.asarray(b.cost)[:n]
    rel = np.abs(ca - cb) / (1.0 + np.abs(cb))
    return dict(n=len(err), u_share=float(np.mean(err <= U_ATOL)),
                u_median=float(np.median(err)), u_max=float(err.max()),
                cost_max=float(rel.max()),
                conv=(float(np.mean(np.asarray(a.converged)[:n])),
                      float(np.mean(np.asarray(b.converged)[:n]))))


def compare(tag: str, a, b, floor: dict, n=None, judge_u: bool = True):
    """a against b over their first n elements, beside the floor's
    agreement over the same elements; see the module docstring. With
    judge_u False the U share is printed but not judged."""
    g = agreement(a, b, n)
    p = floor["u_share"]
    margin = max(U_SHARE_MARGIN, 3.0 * np.sqrt(p * (1.0 - p) / g["n"]))
    q = 0.5 * (g["conv"][0] + g["conv"][1])
    dconv = abs(g["conv"][0] - g["conv"][1])
    cost_tol = max(COST_RTOL, 2.0 * floor["cost_max"])
    ok = ((g["u_share"] >= p - margin or not judge_u) and g["cost_max"] <= cost_tol
          and dconv <= max(CONV_TOL, 3.0 * np.sqrt(q * (1.0 - q) / g["n"])))
    log(f"    {tag} [{g['n']} elements, f32, matmul f32]: "
        f"{g['u_share'] * 100:.2f}% with |dU| <= {U_ATOL} (floor "
        f"{p * 100:.2f}%, "
        f"{f'need >= {(p - margin) * 100:.2f}%' if judge_u else 'not judged'}; median "
        f"{g['u_median']:.2e}, max {g['u_max']:.2e}); cost max rel "
        f"{g['cost_max']:.2e} (need <= {cost_tol:.2e}; floor "
        f"{floor['cost_max']:.2e}); converged {g['conv'][0]:.4f} vs "
        f"{g['conv'][1]:.4f} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"comparison failed: {tag}")


def fleet_phase(tag: str, name: str, N: int, B: int, cfg: ALILQRConfig,
                n_cpu: int = 256):
    base, ob = fleet_batch(name, N, B, jax.random.PRNGKey(0))
    log(f"[{tag}] {name} N={N} B={B} {cfg}")
    results = {}
    for r in gpu_routes(ob, cfg):
        run = on_route(r, cfg)
        t0 = time.perf_counter()
        res = run(ob)
        res.cost.block_until_ready()
        compile_s = time.perf_counter() - t0
        ts = time_fleet(run, ob, base, jax.random.PRNGKey(1))
        med = float(np.median(ts))
        log(f"  route {r}: first call (compile + run) {compile_s:.1f} s; "
            f"{len(ts)} batches median {med * 1e3:.2f} ms "
            f"[min {ts.min() * 1e3:.2f}, max {ts.max() * 1e3:.2f}] -> "
            f"{B / med:.1f} solves/s; {stats_line(res)}")
        if not np.all(np.isfinite(np.asarray(res.U))):
            raise SystemExit(f"route {r}: non-finite controls")
        results[r] = res
    ref = results["xla"]
    nudged = on_route("xla", cfg)(nudge(ob))
    for r, res in results.items():
        if r != "xla":
            compare(f"route {r} vs xla (GPU, all elements)", res, ref,
                    agreement(ref, nudged))
    if not n_cpu:
        return results
    # the XLA engine on the CPU backend, same process, first n_cpu elements
    cpu = jax.devices("cpu")[0]
    ob_cpu = jax.device_put(
        dataclasses.replace(ob, x0=ob.x0[:n_cpu], xref=ob.xref[:n_cpu]), cpu)
    res_cpu = on_route("xla", cfg)(ob_cpu)
    compare(f"xla GPU vs xla CPU (first {n_cpu})", ref, res_cpu,
            agreement(ref, nudged, n_cpu), n_cpu)
    return results


def long_horizon_phase(name: str):
    """One robot at N=200 (T=0.01) at B=1 through solve_one on each route
    and through the per-scenario engine: latency of warm solves (compiled,
    fresh starts). tb3_1 is published with its goal at its start, so it
    converges at once; tb3_2, the same configuration with a goal 3.2 m
    away, is the one that iterates."""
    ocp = get(name).make()
    cfg = ALILQRConfig(n_outer=12, n_inner=20, tol_con=1e-4)
    log(f"[3] {name} N={ocp.N} B=1 {cfg}")
    fns = {f"solve_one[{r}]": functools.partial(ab._solve_one, cfg=cfg, route=r)
           for r in gpu_routes(ocp, cfg)}
    fns["solve (per-scenario)"] = functools.partial(solve, cfg=cfg)
    out = {}
    for name, fn in fns.items():
        f = jax.jit(fn)
        t0 = time.perf_counter()
        res = f(ocp)
        res.U.block_until_ready()
        compile_s = time.perf_counter() - t0
        ts = []
        for i in range(7):
            x0 = ocp.x0 + 0.01 * (i + 1)
            o = dataclasses.replace(ocp, x0=x0)
            t0 = time.perf_counter()
            r = f(o)
            r.U.block_until_ready()
            ts.append(time.perf_counter() - t0)
        ts = np.asarray(ts)
        log(f"  {name}: first call {compile_s:.1f} s; warm p50 "
            f"{np.median(ts) * 1e3:.2f} ms [min {ts.min() * 1e3:.2f}, max "
            f"{ts.max() * 1e3:.2f}] over {len(ts)} solves; cost "
            f"{float(res.cost):.4f}, viol {float(res.viol):.2e}, "
            f"converged {bool(res.converged)}, inner iters {int(res.inner_iters)}")
        if not np.all(np.isfinite(np.asarray(res.U))):
            raise SystemExit(f"{name}: non-finite controls")
        out[name] = res
    ref = out["solve_one[xla]"]
    for name, res in out.items():
        if name != "solve_one[xla]":
            d = float(np.max(np.abs(np.asarray(res.U) - np.asarray(ref.U))))
            log(f"    {name} vs solve_one[xla]: max |dU| {d:.2e}, cost "
                f"{float(res.cost):.4f} vs {float(ref.cost):.4f}")
            if not abs(float(res.cost) - float(ref.cost)) <= 1e-3 * abs(float(ref.cost)) + 1e-3:
                raise SystemExit(f"{name}: cost differs from solve_one[xla]")


# ---------------------------------------------------------------- phase 4


def run_cli(args):
    """Call the CLI's main in-process; returns (exit code, stdout)."""
    from nmpc_tpu.__main__ import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    out = buf.getvalue()
    log(f"  $ python -m nmpc_tpu {' '.join(args)}  (rc {rc}, "
        f"{time.perf_counter() - t0:.1f} s)")
    for line in out.strip().splitlines():
        log(f"    | {line}")
    return rc, out


def loop_progress(npz, name):
    """(start, end) planar distance of every robot to its goal, summed, and
    the smallest pairwise distance (None for one robot) of a saved loop."""
    d = np.load(npz)
    X = np.asarray(d["X_hist"])
    sc = get(name)
    goal = np.asarray(sc.make().xref[-1]).reshape(sc.m, 3)[:, :2]

    def err(x):
        return float(np.sum(np.linalg.norm(x.reshape(sc.m, 3)[:, :2] - goal, axis=1)))

    used = int(d["steps_used"]) if "steps_used" in d else X.shape[0] - 1
    clear = float(np.min(d["min_dist_hist"])) if sc.m > 1 else None
    return err(X[0]), err(X[min(used, X.shape[0] - 1)]), clear


def entry_points_phase():
    os.makedirs(OUT, exist_ok=True)
    # central joint solve (auto -> per-scenario engine at N=35); one robot
    # at N=200 (auto -> batch-native engine): tb3_1 as published starts at
    # its goal, tb3_2 drives 3.2 m
    for name, steps in (("six_robot_antipodal", 30), ("tb3_1", 25), ("tb3_2", 60)):
        f = f"{OUT}/run_{name}.npz"
        rc, _ = run_cli(["run", name, "--steps", str(steps), "--save", f])
        e0, e1, clr = loop_progress(f, name)
        _assert_loop(f"{name} central", rc, e0, e1, clr, get(name).dmin, JOINT_TOL)
    for mode in ("decentralized", "consensus"):
        f = f"{OUT}/run_six_{mode}.npz"
        rc, _ = run_cli(["run", "six_robot_antipodal", "--mode", mode,
                         "--steps", "30", "--save", f])
        e0, e1, clr = loop_progress(f, "six_robot_antipodal")
        _assert_loop(f"six_robot_antipodal {mode}", rc, e0, e1, clr,
                     get("six_robot_antipodal").dmin, DECENTRAL_TOL[mode])
    gn_fleet()
    admm_fleet()


# Realized-clearance allowances below dmin at six_robot_antipodal's period
# T = 0.2 s and v_max = 0.22 m/s. Joint solves (central, consensus): the
# plant executes clamped controls that may leave the plan by up to one
# period of travel, T v_max = 0.044 m. Decentralized: each robot avoids its
# neighbours' plans from one period earlier, so two robots can close by up
# to 2 T v_max = 0.088 m before either sees it.
JOINT_TOL = 0.2 * 0.22
DECENTRAL_TOL = {"decentralized": 2 * 0.2 * 0.22, "consensus": JOINT_TOL}


def _assert_loop(tag, rc, e0, e1, clr, dmin, tol=None):
    ok = (rc == 0 or e1 < e0) and (clr is None or clr >= dmin - tol)
    log(f"  {tag}: distance to goals {e0:.4f} -> {e1:.4f} (reached={rc == 0})"
        + ("" if clr is None else f", min clearance {clr:.4f} >= "
           f"dmin - tol = {dmin - tol:.4f}") + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"entry point failed: {tag}")


def gn_fleet(B: int = 1024, n_cpu: int = 128):
    """The GN fleet on the card, and its first n_cpu elements on the CPU
    backend. `converged` is the AL loop's own flag: the unclamped iterate
    met tol_con. The returned trajectories are clamped to the actuator box
    and re-rolled; they must be feasible to tol_con. Against the CPU the
    costs and the converged share are judged, not U: the backends' dense
    Cholesky solves of the GN normal equations differ by more than a
    one-ulp nudge of the start does, and GN stops at its iteration caps,
    so U lands elsewhere in the same flat valley (on an H100: 68.75% within
    5e-3 against a nudge floor of 95.31%, the float64 cost along each
    segment rising at most 3e-6 above its ends; PERF.md)."""
    from nmpc_tpu.solver import gn

    ob, cfg = lidar_v4_fleet(B, jax.random.PRNGKey(5))
    f = jax.jit(functools.partial(gn.solve_batched, cfg=cfg))
    t0 = time.perf_counter()
    r = f(ob)
    r.U.block_until_ready()
    first = time.perf_counter() - t0
    conv = float(np.mean(np.asarray(r.converged)))
    p99 = float(np.percentile(np.asarray(r.viol), 99))
    ok = np.all(np.isfinite(np.asarray(r.U))) and p99 <= cfg.tol_con
    log(f"  GN fleet lidar_v4 N={ob.N} Nc={cfg.Nc} B={B}: first call "
        f"{first:.1f} s, AL converged {conv:.4f}, returned viol p99 "
        f"{p99:.2e} (need <= {cfg.tol_con}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("GN fleet failed")
    cpu = jax.devices("cpu")[0]
    ob_cpu = jax.device_put(
        dataclasses.replace(ob, x0=ob.x0[:n_cpu], xref=ob.xref[:n_cpu]), cpu)
    compare(f"GN GPU vs GN CPU (first {n_cpu})", r, f(ob_cpu),
            agreement(r, f(nudge(ob)), n_cpu), n_cpu, judge_u=False)


def admm_fleet(B: int = 64):
    fleet, args = ltv_qp_fleet(B, jax.random.PRNGKey(6))
    t0 = time.perf_counter()
    z, its, done, prim = jax.jit(fleet)(*args)
    z.block_until_ready()
    conv = float(np.mean(np.asarray(done)))
    ok = np.all(np.isfinite(np.asarray(z))) and conv >= 0.9
    log(f"  ADMM LTV fleet (N=100, Ts=0.01) B={B}: first call "
        f"{time.perf_counter() - t0:.1f} s, converged {conv:.4f}, mean iters "
        f"{float(np.mean(np.asarray(its))):.0f}, max prim res "
        f"{float(np.max(np.asarray(prim))):.1e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("ADMM fleet failed")


# ---------------------------------------------------------------- 4 cards


def four_cards_phase(devs, fleet_per_card=8192, gn_per_card=256,
                     admm_per_card=16):
    """Data-parallel fleets, the robot-sharded consensus solve and the
    decentralized all_gather round on 4 cards, each against its unsharded
    single-program form."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from nmpc_tpu.parallel.batch import shard_ocp_batch, solve_batched_sharded
    from nmpc_tpu.parallel.consensus import consensus_solve, consensus_solve_sharded
    from nmpc_tpu.parallel.decentralized import decentralized_step, decentralized_step_sharded, robot_template
    from nmpc_tpu.solver import gn
    from nmpc_tpu.solver.alilqr import cold_start

    nd = 4
    mesh = Mesh(np.array(devs[:nd]), ("data",))
    rmesh = Mesh(np.array(devs[:nd]), ("robots",))

    # -- fleets of B = 4 x 8192 split over the cards by shard_map, against
    # the unsharded solve on one card: six robots (XLA route) and two
    # robots (kernel route, which then runs once per card)
    B = nd * fleet_per_card
    for name in ("six_robot_antipodal", "two_robot_swap"):
        base, ob = fleet_batch(name, 10, B, jax.random.PRNGKey(0))
        route = ab.choose_route(ob, FLEET_CFG)
        place = functools.partial(shard_ocp_batch, mesh=mesh)
        run_sh = jax.jit(functools.partial(solve_batched_sharded, mesh=mesh, cfg=FLEET_CFG))
        run_un = jax.jit(functools.partial(ab.solve_batched, cfg=FLEET_CFG))
        t0 = time.perf_counter()
        r_sh = run_sh(place(ob))
        r_sh.cost.block_until_ready()
        log(f"[4c] {name} N=10 B={B} on the {route} route, split over {nd} "
            f"cards: first call {time.perf_counter() - t0:.1f} s; {stats_line(r_sh)}")
        t_sh = time_fleet(run_sh, ob, base, jax.random.PRNGKey(1), n=3, place=place)
        r_un = run_un(ob)
        t_un = time_fleet(run_un, ob, base, jax.random.PRNGKey(1), n=3)
        log(f"  {nd} cards: median {np.median(t_sh) * 1e3:.2f} ms "
            f"[{t_sh.min() * 1e3:.2f}, {t_sh.max() * 1e3:.2f}] -> "
            f"{B / np.median(t_sh):.1f} solves/s; 1 card: median "
            f"{np.median(t_un) * 1e3:.2f} ms [{t_un.min() * 1e3:.2f}, "
            f"{t_un.max() * 1e3:.2f}] -> {B / np.median(t_un):.1f} solves/s; "
            f"scaling {np.median(t_un) / np.median(t_sh):.2f}x")
        compare(f"{name} sharded vs unsharded fleet", r_sh, r_un,
                agreement(r_un, run_un(nudge(ob))))

    # -- robot-sharded consensus solve vs the single-program form
    m, N = 2 * nd, 20
    tpl = robot_template(N, 0.1, 0.3, m)
    ang = np.arange(m) * 2 * np.pi / m
    poses = jnp.asarray(np.stack([np.cos(ang), np.sin(ang), ang], -1), jnp.float32)
    ccfg = ALILQRConfig(n_outer=4, n_inner=10, tol_con=1e-3)
    runc = consensus_solve_sharded(rmesh, tpl, ccfg, rounds=4)
    Xc, Uc, _, _, vh, _ = runc(poses, -poses)
    Xc1, Uc1, _, _, vh1, _ = jax.jit(lambda xj, g: consensus_solve(
        tpl, xj, g, cfg=ccfg, rounds=4))(poses.reshape(-1), -poses)
    dU = float(np.max(np.abs(np.asarray(Uc) - np.asarray(Uc1))))
    dX = float(np.max(np.abs(np.asarray(Xc) - np.asarray(Xc1))))
    ok = dU <= 1e-4 and dX <= 1e-4
    log(f"[4c] consensus m={m} N={N} sharded vs single program: max |dU| "
        f"{dU:.2e}, max |dX| {dX:.2e} (tol 1e-4), viol history "
        f"{np.asarray(vh)} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("consensus sharded != single program")

    # -- decentralized all_gather round vs the single-program step
    step = decentralized_step_sharded(rmesh, tpl, ccfg)
    plans = jnp.tile(poses[:, None, :2], (1, N + 1, 1))
    w = jax.vmap(lambda _: cold_start(tpl, ccfg))(jnp.arange(m))
    u, plans_new = step(poses, -poses, plans, w.U, w.lam, w.mu)
    _, u1, plans1 = jax.jit(functools.partial(
        decentralized_step, tpl, cfg=ccfg, rh_bias=0.0, engine="xla"))(
        poses.reshape(-1), -poses, plans, w)
    du = float(np.max(np.abs(np.asarray(u).reshape(-1) - np.asarray(u1))))
    ok = np.all(np.isfinite(np.asarray(u))) and plans_new.shape == (m, N + 1, 2)
    log(f"[4c] decentralized all_gather round m={m}: u finite, plans "
        f"{plans_new.shape}; max |du| vs single program (stage-offset plans) "
        f"{du:.2e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("decentralized sharded round failed")

    # -- GN fleet and ADMM fleet, sharded vs unsharded
    ob_l, gcfg = lidar_v4_fleet(nd * gn_per_card, jax.random.PRNGKey(5))
    gfn = jax.jit(functools.partial(gn.solve_batched, cfg=gcfg))
    g_sh, g_un = gfn(shard_ocp_batch(ob_l, mesh)), gfn(ob_l)
    compare("GN fleet sharded vs unsharded", g_sh, g_un, agreement(g_un, gfn(nudge(ob_l))))
    fleet, args = ltv_qp_fleet(nd * admm_per_card, jax.random.PRNGKey(6))
    shard = NamedSharding(mesh, PartitionSpec("data"))
    f = jax.jit(fleet)
    z_sh = f(*[jax.device_put(a, shard) for a in args])[0]
    z_un = f(*args)[0]
    dz = float(np.max(np.abs(np.asarray(z_sh) - np.asarray(z_un))))
    log(f"[4c] ADMM LTV fleet B={nd * admm_per_card} sharded vs unsharded: max |dz| "
        f"{dz:.2e} (tol 1e-4) -> {'ok' if dz <= 1e-4 else 'FAIL'}")
    if dz > 1e-4:
        raise SystemExit("ADMM sharded != unsharded")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--four-cards", action="store_true",
                   help="run only the cross-device paths, on 4 cards")
    args = p.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    devs = phase_device(n_cards)
    if args.four_cards:
        four_cards_phase(devs)
    else:
        fleet_phase("1", "six_robot_antipodal", 10, 32768, FLEET_CFG)
        fleet_phase("1", "two_robot_swap", 10, 4096, FLEET_CFG, n_cpu=0)
        fleet_phase("2", "ten_robot", 20, 4096, FLEET_CFG)
        long_horizon_phase("tb3_1")
        long_horizon_phase("tb3_2")
        log("[4] entry points")
        entry_points_phase()
    dev = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
