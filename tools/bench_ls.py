"""Compare the batched engine's line-search strategies on the bench shape.

Measures throughput AND solution-quality statistics (convergence rate, mean
cost, violation percentiles) for cascade vs adaptive line search, at the
official bench config (six-robot N=10, B=32768, jittered antipodal starts).

Usage: python tools/bench_ls.py [B] [--ls cascade adaptive ...]
"""
import dataclasses
import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from nmpc_tpu.parallel.batch import batch_ocp
    from nmpc_tpu.scenarios import get
    from nmpc_tpu.solver.alilqr import ALILQRConfig
    from nmpc_tpu.solver.alilqr_batched import solve_batched

    B = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 32768
    base = get("six_robot_antipodal").make(N=10)
    key = jax.random.PRNGKey(0)
    noise = 0.1 * jax.random.normal(key, (B, base.nx), base.x0.dtype)
    ob = batch_ocp(base, base.x0[None] + noise)

    import os
    names = os.environ.get("LS_VARIANTS", "cascade,adaptive-r1,adaptive-r2,adaptive-r3").split(",")
    all_variants = {"cascade": {}, "adaptive-r1": {"ls": "adaptive", "ls_rounds": 1},
                    "adaptive-r2": {"ls": "adaptive", "ls_rounds": 2},
                    "adaptive-r3": {"ls": "adaptive", "ls_rounds": 3}}
    variants = [(n, all_variants[n]) for n in names]
    for ls, kw in variants:
        cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, **kw)
        run = jax.jit(functools.partial(solve_batched, cfg=cfg))
        res = run(ob)
        conv = float(res.converged.mean())
        mcost = float(res.cost.mean())
        viol = np.asarray(res.viol)
        inner = float(res.inner_iters.mean())

        times = []
        k = key
        for _ in range(4):
            k, sub = jax.random.split(k)
            x0s = base.x0[None] + 0.1 * jax.random.normal(sub, (B, base.nx), base.x0.dtype)
            x0s.block_until_ready()
            ob_i = dataclasses.replace(ob, x0=x0s)
            t0 = time.perf_counter()
            r = run(ob_i)
            r.cost.block_until_ready()
            times.append(time.perf_counter() - t0)
        sps = B / min(times)
        print(f"{ls:9s} {sps:10.1f} solves/s  conv={conv:.4f} "
              f"meancost={mcost:.4f} viol_p50={np.percentile(viol,50):.2e} "
              f"viol_p99={np.percentile(viol,99):.2e} viol_max={viol.max():.2e} "
              f"mean_inner={inner:.1f}")


if __name__ == "__main__":
    main()
