"""Decompose a batched solve's time into phases on the current device.

Times the stages of one AL-iLQR inner iteration of the batched engine's XLA
route at the bench shape (expansions + backward sweep, the 8-alpha line
search), plus the end-to-end solve on each route — the data that drives
kernel priorities. Optionally writes a jax.profiler trace (view with
TensorBoard / xprof).

Run: python tools/profile_solve.py [--trace /tmp/jax-trace] [-B 4096]
"""

import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-B", type=int, default=4096)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    from nmpc_tpu.parallel.batch import batch_ocp
    from nmpc_tpu.scenarios import get
    from nmpc_tpu.solver.alilqr import ALILQRConfig, lqr_gains, stage_expansions
    from nmpc_tpu.solver import alilqr_batched as ab
    from nmpc_tpu.utils import time_fn

    base = get("six_robot_antipodal").make(N=10)
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3)
    B = args.B
    key = jax.random.PRNGKey(0)
    x0s = base.x0[None] + 0.1 * jax.random.normal(key, (B, base.nx), base.x0.dtype)
    ob = batch_ocp(base, x0s)
    print(f"six_robot_antipodal N=10 B={B} on {jax.devices()[0].device_kind}")

    U = jnp.zeros((B, base.N, base.nu), base.x0.dtype)
    lam = jnp.zeros((B, base.N, base.n_con), base.x0.dtype)
    mu = jnp.full((B,), cfg.mu_init, base.x0.dtype)
    X = jax.jit(ab._rollout_b)(ob, U)

    def vm(fn):
        return jax.jit(lambda *a: ab._vm(fn, ob, *a))

    exp = vm(lambda o, x, u, l, m: stage_expansions(o, x, u, l, m))
    _, st = time_fn(lambda: exp(X, U, lam, mu), iters=10)
    print(f"expansions+jacobians : p50 {st['p50_ms']:.2f} ms")

    sweep = vm(lambda o, x, u, l, m: lqr_gains(cfg, *stage_expansions(o, x, u, l, m)))
    _, st = time_fn(lambda: sweep(X, U, lam, mu), iters=10)
    print(f"expansions+sweep     : p50 {st['p50_ms']:.2f} ms")

    kff, Kfb, _ = sweep(X, U, lam, mu)
    alphas = jnp.asarray(cfg.alphas, base.x0.dtype)

    @jax.jit
    def linesearch():
        def try_alpha(a):
            Xn, Un = ab._forward_b(ob, X, U, kff, Kfb, jnp.full((B,), a))
            return ab._al_cost_b(ob, Xn, Un, lam, mu)
        return jax.vmap(try_alpha)(alphas)

    _, st = time_fn(linesearch, iters=10)
    print(f"line search (8 alpha): p50 {st['p50_ms']:.2f} ms")

    for r in ab.ROUTES:
        run = jax.jit(functools.partial(ab._solve_batched, warm=None, cfg=cfg, route=r))
        _, st = time_fn(lambda: run(ob), iters=5)
        print(f"full solve [{r:6s}]  : p50 {st['p50_ms']:.2f} ms "
              f"({B / (st['p50_ms'] / 1e3):.0f} solves/s)")

    if args.trace:
        run = jax.jit(functools.partial(ab.solve_batched, cfg=cfg))
        with jax.profiler.trace(args.trace):
            r = run(ob)
            r.cost.block_until_ready()
        print(f"trace written to {args.trace}")


if __name__ == "__main__":
    main()
