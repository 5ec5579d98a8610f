"""BASELINE.json config 5: ten-robot, thousands of randomized scenarios
batched on one device.

The ten-robot joint NLP is the reference's largest (1,030 vars / 1,575 IPOPT
rows, mpc_online_casadi_tb3_ten_multi_centralized_collision_avoidance.py:
169-173,270-361). This bench solves B randomized ten-robot scenarios
(jittered line-formation starts) per batch and reports solves/s on the
route solver.alilqr_batched.choose_route picks. Synchronous timing (see
bench.py).

Usage: python tools/bench_ten_robot.py [B] [N]
"""
import dataclasses
import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import numpy as np


def main():
    from nmpc_tpu.parallel.batch import batch_ocp
    from nmpc_tpu.scenarios import get
    from nmpc_tpu.solver.alilqr import ALILQRConfig
    from nmpc_tpu.solver.alilqr_batched import choose_route, solve_batched

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    base = get("ten_robot").make() if len(sys.argv) <= 2 else \
        get("ten_robot").make(N=int(sys.argv[2]))
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")

    key = jax.random.PRNGKey(0)
    noise = 0.1 * jax.random.normal(key, (B, base.nx), base.x0.dtype)
    ob = batch_ocp(base, base.x0[None] + noise)
    run = jax.jit(functools.partial(solve_batched, cfg=cfg))
    res = run(ob)
    conv = float(res.converged.mean())
    viol = np.asarray(res.viol)
    print(f"compiled; conv={conv:.4f} viol_p99={np.percentile(viol, 99):.2e} "
          f"viol_max={viol.max():.2e} mean_inner={float(res.inner_iters.mean()):.1f}")

    times = []
    for _ in range(4):
        key, sub = jax.random.split(key)
        x0s = base.x0[None] + 0.1 * jax.random.normal(sub, (B, base.nx), base.x0.dtype)
        x0s.block_until_ready()
        ob_i = dataclasses.replace(ob, x0=x0s)
        t0 = time.perf_counter()
        r = run(ob_i)
        r.cost.block_until_ready()
        times.append(time.perf_counter() - t0)
    print(f"ten-robot N={base.N} B={B}: {B / min(times):.1f} solves/s on "
          f"{jax.devices()[0].device_kind}, route {choose_route(ob, cfg)} "
          f"({min(times)*1e3:.1f} ms/batch)")


if __name__ == "__main__":
    main()
