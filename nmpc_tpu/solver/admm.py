"""Batched dense ADMM QP solver — the OSQP capability.

The reference prototypes linear time-varying MPC as a sparse QP solved by
OSQP (/root/reference/AllScripts/mpc_osqp_test.py:104-151): decision
z = [x_0..x_N; u_0..u_{N-1}], equality dynamics as l = u rows, box bounds on
states/inputs, warm-started `prob.update(l, u)` each period.

This module implements the same ADMM iteration (OSQP's splitting) with a
*dense* pre-factorized KKT matrix: a dense Cholesky of a few-hundred-dim
matrix is one batched library factorization, reused across iterations and
across every batch element / MPC step (the matrix depends only on the
problem structure, not on l, u, q — exactly the property OSQP's
`update(l, u)` exploits). vmap over (q, l, u) gives thousands of QPs per
step; fixed-iteration loop with residual-based convergence masks keeps the
whole solve one jitted program.

ADMM iteration (sigma, rho fixed):
  x+ = solve(P + sigma I + rho A'A, sigma x - q + A'(rho z - y))
  z+ = clip(A x+ + y / rho, l, u)
  y+ = y + rho (A x+ - z+)
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    rho: float = 1.0
    sigma: float = 1e-6
    max_iter: int = 400
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    alpha: float = 1.6   # over-relaxation (OSQP default)


@partial(jax.tree_util.register_dataclass, data_fields=("chol", "A", "P", "rho"), meta_fields=())
@dataclasses.dataclass(frozen=True)
class QPFactor:
    chol: jax.Array    # Cholesky factor of (P + sigma I + A'diag(rho)A), lower=False
    A: jax.Array
    P: jax.Array
    rho: jax.Array     # per-row penalty (equality rows boosted)


def qp_setup(P: jax.Array, A: jax.Array, cfg: ADMMConfig = ADMMConfig(),
             l=None, u=None) -> QPFactor:
    """Factorize once; reuse across solves (OSQP `setup`). If (l, u) are
    given, equality rows (u - l ~ 0) get a 1e3x rho boost — OSQP's
    constraint-type scaling, essential for the l = u dynamics rows of the
    LTV-MPC formulation."""
    n = P.shape[0]
    if l is not None and u is not None:
        eq = (jnp.asarray(u) - jnp.asarray(l)) < 1e-9
        rho = jnp.where(eq, 1e3 * cfg.rho, cfg.rho)
    else:
        rho = jnp.full((A.shape[0],), cfg.rho, P.dtype)
    K = P + cfg.sigma * jnp.eye(n, dtype=P.dtype) + A.T @ (rho[:, None] * A)
    chol, _ = jax.scipy.linalg.cho_factor(K)
    return QPFactor(chol=chol, A=A, P=P, rho=rho)


def qp_solve(
    fac: QPFactor,
    q: jax.Array,
    l: jax.Array,
    u: jax.Array,
    cfg: ADMMConfig = ADMMConfig(),
    x0: jax.Array | None = None,
    y0: jax.Array | None = None,
):
    """Solve min 0.5 x'Px + q'x  s.t. l <= Ax <= u. Returns
    (x, y, iters, converged, prim_res, dual_res). vmap over (q, l, u[, x0, y0])."""
    A = fac.A
    n = A.shape[1]
    mrows = A.shape[0]
    dtype = q.dtype
    x = jnp.zeros((n,), dtype) if x0 is None else x0
    y = jnp.zeros((mrows,), dtype) if y0 is None else y0
    z = jnp.clip(A @ x, l, u)

    def cond(c):
        _, _, _, it, done = c
        return (it < cfg.max_iter) & (~done)

    def body(c):
        x, z, y, it, _ = c
        rho = fac.rho
        rhs = cfg.sigma * x - q + A.T @ (rho * z - y)
        x_new = jax.scipy.linalg.cho_solve((fac.chol, False), rhs)
        Ax = A @ x_new
        Ax_rel = cfg.alpha * Ax + (1 - cfg.alpha) * z
        z_new = jnp.clip(Ax_rel + y / rho, l, u)
        y_new = y + rho * (Ax_rel - z_new)
        prim = jnp.max(jnp.abs(Ax - z_new))
        dual = jnp.max(jnp.abs(A.T @ (rho * (z_new - z))))
        scale_p = jnp.maximum(jnp.max(jnp.abs(Ax)), jnp.max(jnp.abs(z_new)))
        scale_d = jnp.maximum(jnp.max(jnp.abs(fac.P @ x_new + q)), 1.0)
        done = (prim <= cfg.eps_abs + cfg.eps_rel * scale_p) & (
            dual <= cfg.eps_abs + cfg.eps_rel * scale_d
        )
        return (x_new, z_new, y_new, it + 1, done)

    x, z, y, iters, done = jax.lax.while_loop(
        cond, body, (x, z, y, jnp.zeros((), jnp.int32), jnp.zeros((), bool))
    )
    Ax = A @ x
    prim = jnp.max(jnp.abs(Ax - jnp.clip(Ax, l, u)))
    return x, y, iters, done, prim


def qp_setup_batched(P, A, cfg: ADMMConfig = ADMMConfig(), l=None, u=None):
    """Batched `qp_setup`: P may be shared [n, n] or batched [B, n, n]; A is
    batched [B, rows, n] (the LTV case — the reference re-linearizes Bd and
    re-runs OSQP setup every control period, mpc_osqp_test.py:88-121). The
    B Cholesky factorizations run as one batched call."""
    in_p = 0 if P.ndim == 3 else None
    in_l = None if l is None else (0 if l.ndim == 2 else None)
    in_u = None if u is None else (0 if u.ndim == 2 else None)
    return jax.vmap(
        lambda p, a, ll, uu: qp_setup(p, a, cfg, ll, uu),
        in_axes=(in_p, 0, in_l, in_u),
    )(P, A, l, u)


def qp_solve_batched(fac: QPFactor, q, l, u, cfg: ADMMConfig = ADMMConfig(),
                     x0=None, y0=None):
    """Fleet entry: solve B QPs in one call — every ADMM iteration is a
    batched GEMM + batched triangular solve. `fac` may be shared
    (one factorization, leaves [n, n] / [rows, n]) or per-element (batched
    leaves from `qp_setup_batched`). q/l/u are [B, ...]; optional warm
    starts are batched. Returns the same tuple as `qp_solve`, batched."""
    fax = QPFactor(chol=0, A=0, P=0, rho=0) if fac.A.ndim == 3 else None
    if x0 is None and y0 is None:
        return jax.vmap(
            lambda f, qq, ll, uu: qp_solve(f, qq, ll, uu, cfg),
            in_axes=(fax, 0, 0, 0),
        )(fac, q, l, u)
    B = q.shape[0]
    n = fac.A.shape[-1]
    rows = fac.A.shape[-2]
    if x0 is None:
        x0 = jnp.zeros((B, n), q.dtype)
    if y0 is None:
        y0 = jnp.zeros((B, rows), q.dtype)
    return jax.vmap(
        lambda f, qq, ll, uu, xx, yy: qp_solve(f, qq, ll, uu, cfg, xx, yy),
        in_axes=(fax, 0, 0, 0, 0, 0),
    )(fac, q, l, u, x0, y0)


def build_ltv_mpc_qp(Ad, Bd, Qd, Rd, QNd, N, x_lo, x_hi, u_lo, u_hi):
    """Assemble the reference's sparse LTV-MPC QP structure densely
    (mpc_osqp_test.py:104-114, sparse.kron layout):
      z = [x_0..x_N; u_0..u_{N-1}],
      P = blkdiag(I_N (x) Q, QN, I_N (x) R),
      equality rows: -x_{k+1} + Ad x_k + Bd u_k = 0 and x_0 = x_init,
      inequality rows: box on every x_k and u_k.
    Returns (P, A, l_template, u_template, pack) where l/u rows [0:nx] hold
    -x_init (updated each MPC step, OSQP `update(l, u)` style)."""
    nx, nu = Bd.shape
    nz = (N + 1) * nx + N * nu
    P = jnp.zeros((nz, nz))
    for k in range(N):
        P = P.at[k * nx : (k + 1) * nx, k * nx : (k + 1) * nx].set(Qd)
    P = P.at[N * nx : (N + 1) * nx, N * nx : (N + 1) * nx].set(QNd)
    off = (N + 1) * nx
    for k in range(N):
        P = P.at[off + k * nu : off + (k + 1) * nu, off + k * nu : off + (k + 1) * nu].set(Rd)

    n_eq = (N + 1) * nx
    A = jnp.zeros((n_eq + nz, nz))
    A = A.at[:nx, :nx].set(-jnp.eye(nx))  # x_0 = x_init row block
    for k in range(N):
        r = (k + 1) * nx
        A = A.at[r : r + nx, k * nx : (k + 1) * nx].set(Ad)
        A = A.at[r : r + nx, (k + 1) * nx : (k + 2) * nx].set(-jnp.eye(nx))
        A = A.at[r : r + nx, off + k * nu : off + (k + 1) * nu].set(Bd)
    A = A.at[n_eq:, :].set(jnp.eye(nz))

    x_box_lo = jnp.concatenate([jnp.tile(x_lo, N + 1), jnp.tile(u_lo, N)])
    x_box_hi = jnp.concatenate([jnp.tile(x_hi, N + 1), jnp.tile(u_hi, N)])
    l = jnp.concatenate([jnp.zeros(n_eq), x_box_lo])
    u = jnp.concatenate([jnp.zeros(n_eq), x_box_hi])

    def pack(x_init, q_xref=None):
        """Per-step updates: x_init into the first equality rows; optional
        linear cost from a reference trajectory."""
        l_k = l.at[:nx].set(-x_init)
        u_k = u.at[:nx].set(-x_init)
        return l_k, u_k

    return P, A, l, u, pack
