"""Bench: sequential vs associative-scan backward sweep at long horizons.

The reference's longest-horizon configs are N=200
(AllScripts/mpc_online_casadi_tb3_1.py:57, decentralized_first_scenario.py:95).
This measures the batched solver's XLA route at the tb3_2 shape (m=1,
N=200) with sweep='seq' (Riccati sweep, sequential in N) vs sweep='scan'
(the O(log N) associative-scan LQR, ops/assoc_lqr.py), at B=1 and a fleet
batch (the N=200 scan materializes O(B N n^2) combine-tree temporaries, so
its fleet batch is smaller).

B=1 latency is measured as lax.map over K independent solves inside one
jit (per-solve device time without the per-call dispatch). Results feed the
sweep='auto' threshold (solver/alilqr.py SCAN_N_MIN).

Usage: python tools/bench_sweep.py [N] [iters]
"""

import dataclasses
import functools
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from nmpc_tpu.parallel.batch import batch_ocp  # noqa: E402
from nmpc_tpu.scenarios import get  # noqa: E402
from nmpc_tpu.solver.alilqr import ALILQRConfig  # noqa: E402
from nmpc_tpu.solver.alilqr_batched import _solve_batched  # noqa: E402


def bench_b1(base, cfg, K=16, iters=5):
    """Per-solve device time: K independent B=1 solves inside one jit."""
    def many(x0s):  # [K, nx]
        def one(x0):
            ob = batch_ocp(base, x0[None])
            r = _solve_batched(ob, None, cfg, "xla")
            return r.cost[0]
        return jax.lax.map(one, x0s)

    f = jax.jit(many)
    key = jax.random.PRNGKey(0)
    x0s = base.x0[None] + 0.05 * jax.random.normal(key, (K, base.nx))
    _ = float(f(x0s)[0])
    ts = []
    for i in range(iters):
        key, sub = jax.random.split(key)
        x0s = base.x0[None] + 0.05 * jax.random.normal(sub, (K, base.nx))
        x0s.block_until_ready()
        t0 = time.perf_counter()
        out = f(x0s)
        _ = float(out[-1])
        ts.append(time.perf_counter() - t0)
    return min(ts) / K


def bench_batch(base, cfg, B=2048, iters=4):
    key = jax.random.PRNGKey(1)
    ob = batch_ocp(base, base.x0[None] + 0.05 * jax.random.normal(key, (B, base.nx)))
    f = jax.jit(functools.partial(_solve_batched, warm=None, cfg=cfg, route="xla"))
    r = f(ob)
    _ = float(r.cost[0])
    ts = []
    for i in range(iters):
        key, sub = jax.random.split(key)
        ob_i = dataclasses.replace(
            ob, x0=base.x0[None] + 0.05 * jax.random.normal(sub, (B, base.nx)))
        ob_i.x0.block_until_ready()
        t0 = time.perf_counter()
        r = f(ob_i)
        _ = float(r.cost[0])
        ts.append(time.perf_counter() - t0)
    return min(ts), B


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    base = get("tb3_2").make(N=N)
    print(f"tb3_2 shape m=1 N={N} on {jax.devices()[0].device_kind}")
    for sweep, Bfleet in (("seq", 2048), ("scan", 512)):
        # scan's combine tree materializes O(B N n^2) temporaries
        cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, sweep=sweep)
        t1 = bench_b1(base, cfg, iters=iters)
        tb, B = bench_batch(base, cfg, B=Bfleet, iters=iters)
        print(f"sweep={sweep:4s}:  B=1 {t1*1e3:8.2f} ms/solve   "
              f"B={B} {tb:6.2f} s/batch ({B/tb:9.1f} solves/s)")


if __name__ == "__main__":
    main()
