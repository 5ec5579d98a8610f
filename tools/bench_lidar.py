"""Bench: family-I (LiDAR v4) NMPC solves/s via the batched condensed GN.

The ray-augmented problem class with Nc move blocking runs the condensed
GN engine, gn.solve_batched: per GN iteration one dense [B, Nc*nu, Nc*nu]
Cholesky + batched residual/Jacobian GEMMs. Config = the published v4
scenario (obs_avoid_static_first_scenario_v4.py:59-75: N=100, Nc=50,
10 rays, 1/d cost; nmpc_tpu.scenarios.fleets.lidar_v4_fleet). Synchronous
timing (a value forced to host).

Usage: python tools/bench_lidar.py [B] [iters]
"""

import dataclasses
import functools
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from nmpc_tpu.scenarios.fleets import lidar_v4_fleet  # noqa: E402
from nmpc_tpu.solver import gn  # noqa: E402


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    key = jax.random.PRNGKey(0)
    ob, cfg = lidar_v4_fleet(B, key)
    f = jax.jit(functools.partial(gn.solve_batched, cfg=cfg))
    r = f(ob)
    _ = float(r.cost[0])
    print(f"lidar_v4 (N={ob.N}, Nc={cfg.Nc}, {ob.num_rays} rays) B={B} "
          f"on {jax.devices()[0].device_kind}")
    ts = []
    for i in range(iters):
        key, sub = jax.random.split(key)
        ob_i = dataclasses.replace(ob, x0=lidar_v4_fleet(B, sub)[0].x0)
        ob_i.x0.block_until_ready()
        t0 = time.perf_counter()
        r = f(ob_i)
        _ = float(r.cost[0])
        ts.append(time.perf_counter() - t0)
    t = min(ts)
    print(f"{t:.3f} s/batch -> {B/t:.1f} lidar_v4 solves/s "
          f"(max viol {float(jnp.max(r.viol)):.1e})")


if __name__ == "__main__":
    main()
