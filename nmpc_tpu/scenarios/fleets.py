"""Fleet workloads of the reference's published configurations that need
more than a registry entry: the LiDAR-v4 Gauss-Newton fleet (a frozen scan)
and the OSQP-config LTV-MPC QP fleet. Shared by chip_smoke.py and the
tools/bench_* scripts; data is made from a PRNG key.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from nmpc_tpu.parallel.batch import batch_ocp
from nmpc_tpu.scenarios.registry import get


def lidar_v4_fleet(B: int, key):
    """B jittered starts of the published lidar_v4 config
    (obs_avoid_static_first_scenario_v4.py:59-75: N=100, Nc=50, 10 rays,
    1/d cost) against one frozen scan -> (batched OCP, GNConfig)."""
    from nmpc_tpu.mpc.lidar import obstacle_points, ray_angles
    from nmpc_tpu.solver import gn

    sc = get("lidar_v4")
    base = sc.make()
    R = sc.num_rays
    angles = ray_angles(R, jnp.float32)
    scan = jnp.full((R,), 3.5, jnp.float32).at[1].set(0.9).at[2].set(1.1)
    base = dataclasses.replace(base, p_obs=obstacle_points(base.x0[:3], scan, angles),
                               x0=base.x0.at[3:].set(scan))
    noise = 0.05 * jax.random.normal(key, (B, 3), jnp.float32)
    x0s = jnp.concatenate([base.x0[None, :3] + noise,
                           jnp.broadcast_to(base.x0[None, 3:], (B, R))], axis=1)
    cfg = gn.GNConfig(Nc=sc.Nc, n_gn=10, n_outer=4, tol_con=1e-3)
    return batch_ocp(base, x0s), cfg


def ltv_qp_fleet(B: int, key, N: int = 100, max_iter: int = 400):
    """Batched LTV-MPC QPs of the reference's OSQP configuration
    (mpc_osqp_test.py: N=100, Ts=0.01, exact-discretization input matrix,
    unicycle linearized at random (theta, w)) -> (fleet fn, args); fleet
    returns (z, iterations, converged, primal residual)."""
    from nmpc_tpu.solver.admm import ADMMConfig, qp_setup_batched, qp_solve_batched

    nx, nu, ts = 3, 2, 0.01
    nz, n_eq = (N + 1) * nx + N * nu, (N + 1) * nx
    Qd = jnp.array([1.0, 5.0, 0.1], jnp.float32)
    Rd = jnp.array([0.5, 0.05], jnp.float32)
    P = jnp.diag(jnp.concatenate([jnp.tile(Qd, N + 1), jnp.tile(Rd, N)]))
    xmax = jnp.array([1e9, 1e9, 2 * np.pi], jnp.float32)
    umax = jnp.array([0.22, 1.0], jnp.float32)
    box_hi = jnp.concatenate([jnp.tile(xmax, N + 1), jnp.tile(umax, N)])
    q = jnp.concatenate([jnp.tile(-Qd * jnp.array([1.0, 1.0, 0.0]), N + 1),
                         jnp.zeros(N * nu)])
    cfg = ADMMConfig(max_iter=max_iter)

    def assemble(theta, w):
        g = jnp.where(jnp.abs(w) < 1e-9, ts / 2, jnp.sin((ts / 2) * w) / w)
        Bd = jnp.array([[2 * g * jnp.cos(theta), ts / 2],
                        [2 * g * jnp.sin(theta), ts / 2], [0.0, ts]], jnp.float32)
        Ax = (-jnp.eye(n_eq, dtype=jnp.float32)
              + jnp.kron(jnp.eye(N + 1, k=-1, dtype=jnp.float32),
                         jnp.eye(nx, dtype=jnp.float32)))
        Bu = jnp.kron(jnp.concatenate([jnp.zeros((1, N), jnp.float32),
                                       jnp.eye(N, dtype=jnp.float32)]), Bd)
        return jnp.concatenate([jnp.concatenate([Ax, Bu], axis=1),
                                jnp.eye(nz, dtype=jnp.float32)], axis=0)

    def fleet(thetas, ws, x0s):
        A = jax.vmap(assemble)(thetas, ws)
        b = x0s.shape[0]
        lo = jnp.concatenate([-x0s, jnp.zeros((b, n_eq - nx)),
                              jnp.broadcast_to(-box_hi[None], (b, nz))], axis=1)
        hi = jnp.concatenate([-x0s, jnp.zeros((b, n_eq - nx)),
                              jnp.broadcast_to(box_hi[None], (b, nz))], axis=1)
        fac = qp_setup_batched(P, A, cfg, l=lo, u=hi)
        z, _, its, done, prim = qp_solve_batched(
            fac, jnp.broadcast_to(q[None], (b, nz)), lo, hi, cfg)
        return z, its, done, prim

    k1, k2, k3 = jax.random.split(key, 3)
    args = (jax.random.uniform(k1, (B,), jnp.float32, 0, 2 * np.pi),
            jax.random.uniform(k2, (B,), jnp.float32, -1.0, 1.0),
            0.3 * jax.random.normal(k3, (B, nx), jnp.float32))
    return fleet, args
