"""Benchmark: NMPC solves/s on one device, six-robot N=10-horizon fleet.

BASELINE.md metric: "NMPC solves/s/chip (six-robot, N=10 horizon)"; north-star
target >1,000 full-horizon NMPC solves/s aggregate (BASELINE.json). The
reference's implied rate is one IPOPT solve per control period T=0.2 s
(5 solves/s, serial CPU). vs_baseline here is value / 1000.

Timing is synchronous: each iteration dispatches one batch with fresh inputs
and blocks on its result before the clock stops.

Prints exactly one JSON line, naming the engine route and the device.
"""

import dataclasses
import functools
import json
import time

import jax


def main():
    from nmpc_tpu.parallel.batch import batch_ocp
    from nmpc_tpu.scenarios import get
    from nmpc_tpu.solver.alilqr import ALILQRConfig
    from nmpc_tpu.solver.alilqr_batched import choose_route, solve_batched
    from nmpc_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    B = 32768
    base = get("six_robot_antipodal").make(N=10)
    # adaptive per-element line search (ALILQRConfig.ls); its quality
    # against the cascade is pinned by
    # tests/test_batched_solver.py::test_adaptive_line_search_*
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")

    key = jax.random.PRNGKey(0)
    # randomized scenario batch: jittered starts around the unit circle
    noise = 0.1 * jax.random.normal(key, (B, base.nx), base.x0.dtype)
    ob = batch_ocp(base, base.x0[None] + noise)

    run = jax.jit(functools.partial(solve_batched, cfg=cfg))
    res = run(ob)
    _ = float(res.cost[0])  # compile + force real completion

    iters = 4
    times = []
    for i in range(iters):
        key, sub = jax.random.split(key)
        x0s = base.x0[None] + 0.1 * jax.random.normal(sub, (B, base.nx), base.x0.dtype)
        x0s.block_until_ready()  # inputs on device before the clock starts
        ob_i = dataclasses.replace(ob, x0=x0s)
        t0 = time.perf_counter()
        res = run(ob_i)
        res.cost.block_until_ready()
        times.append(time.perf_counter() - t0)

    solves_per_s = B / min(times)
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "NMPC solves/s/chip (six-robot, N=10 horizon)",
                "value": round(solves_per_s, 1),
                "unit": "solves/s",
                "vs_baseline": round(solves_per_s / 1000.0, 3),
                "engine": choose_route(ob, cfg),
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


if __name__ == "__main__":
    main()
