"""Scenario-fleet demo: thousands of randomized six-robot problems solved in
one shot, sharded across every visible device.

    python examples/fleet_batch.py [-B 4096]
"""

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from nmpc_tpu.parallel.batch import random_starts, shard_ocp_batch, solve_batched_sharded
from nmpc_tpu.parallel.mesh import data_mesh
from nmpc_tpu.scenarios import get
from nmpc_tpu.solver.alilqr import ALILQRConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-B", type=int, default=4096)
    args = ap.parse_args()

    base = get("six_robot_antipodal").make(N=10)
    mesh = data_mesh()
    ob = random_starts(base, jax.random.PRNGKey(0), args.B, spread=0.1)
    ob = shard_ocp_batch(ob, mesh)
    run = jax.jit(functools.partial(
        solve_batched_sharded, mesh=mesh, cfg=ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3)))
    res = run(ob)
    _ = float(res.cost[0])  # compile + force real completion
    # fresh inputs for the timed solve, so nothing is reused from the
    # warm-up call
    ob2 = shard_ocp_batch(
        random_starts(base, jax.random.PRNGKey(1), args.B, spread=0.1), mesh)
    jax.block_until_ready(ob2.x0)
    t0 = time.time()
    res = run(ob2)
    _ = float(res.cost[0])  # value to host = synchronous timing
    dt = time.time() - t0
    print(f"devices: {len(mesh.devices.flat)}  batch: {args.B}")
    print(f"{args.B / dt:.0f} NMPC solves/s   "
          f"converged {float(jnp.mean(res.converged)) * 100:.0f}%   "
          f"max violation {float(jnp.max(res.viol)):.1e}")


if __name__ == "__main__":
    main()
