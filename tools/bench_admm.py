"""Bench: OSQP-capability fleet throughput — batched LTV-MPC QP setup+solve.

The reference's OSQP prototype (/root/reference/AllScripts/mpc_osqp_test.py)
re-linearizes the unicycle around the current yaw/omega with the exact-
discretization input matrix (gamma(w, Ts) = sin(Ts*w/2)/w, :27-32,88-93),
re-assembles the sparse QP (sparse.kron layout, :104-114) and re-runs OSQP
setup+solve every Ts = 0.01 s control period at N = 100 (nz = 503 decision
vars, 806 rows). This bench runs the SAME per-period work batched: B
linearizations -> B dense KKT Cholesky factorizations (one batched call)
-> B ADMM solves (batched GEMM + triangular-solve iterations).

Budget: one setup+solve per 10 ms period per robot -> 100 QPs/s/robot.
Synchronous timing (a value forced to host after each batch).

Usage: python tools/bench_admm.py [B] [iters]
"""

import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from nmpc_tpu.scenarios.fleets import ltv_qp_fleet  # noqa: E402


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    key = jax.random.PRNGKey(0)
    fleet, args = ltv_qp_fleet(B, key)
    f = jax.jit(fleet)
    z, its, done, prim = f(*args)
    _ = float(prim[0])  # compile + sync
    print(f"LTV-MPC QP (reference OSQP config: N=100, nz={z.shape[1]}) "
          f"B={B} on {jax.devices()[0].device_kind}")
    ts = []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        a = ltv_qp_fleet(B, sub)[1]
        jax.block_until_ready(a)
        t0 = time.perf_counter()
        z, its, done, prim = f(*a)
        _ = float(prim[0])
        ts.append(time.perf_counter() - t0)
    t = min(ts)
    print(f"{t:.3f} s/batch -> {B / t:.1f} LTV setup+solves/s "
          f"(converged {float(jnp.mean(done)) * 100:.1f}%, "
          f"mean iters {float(jnp.mean(its)):.0f}, "
          f"max prim res {float(jnp.max(prim)):.1e})")


if __name__ == "__main__":
    main()
