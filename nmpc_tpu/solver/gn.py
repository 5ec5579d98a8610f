"""Condensed Gauss-Newton AL solver with control-horizon move blocking.

The reference has two solver families beyond the stagewise NLPs:
  * the pure-Python SLSQP scripts condense the states out by rollout and
    optimize the control sequence directly, with a control horizon Nc < N
    freezing u after Nc (mpc_control_pose_py_modified.py:32-37);
  * the mature LiDAR script blocks moves at Nc=50 of N=100
    (obs_avoid_static_first_scenario_v4.py:61,128-131).

Move blocking breaks the stagewise structure the Riccati sweep exploits, so
this solver takes the condensed route: decision = U_blk [Nc, nu], states
eliminated by the exact rollout, one dense Gauss-Newton system of size
Nc*nu (<= ~200) per iteration — a single batched Cholesky when vmapped
over scenarios. The augmented-Lagrangian
outer loop and the PHR penalty are shared with the iLQR engine, and it
returns the same SolveResult/WarmStart pytrees so every MPC driver can swap
it in via `solve_fn`.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from nmpc_tpu.ocp import problem as P
from nmpc_tpu.ocp.problem import OCP
from nmpc_tpu.solver.alilqr import SolveResult, WarmStart, cold_start


@dataclasses.dataclass(frozen=True)
class GNConfig:
    Nc: int | None = None     # control horizon; None = N (no blocking)
    n_outer: int = 8
    n_gn: int = 15            # Gauss-Newton iterations per outer step
    mu_init: float = 10.0
    mu_factor: float = 10.0
    mu_max: float = 1e4
    reg: float = 1e-6
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003)
    tol_cost: float = 1e-7
    tol_con: float = 1e-4
    lam_max: float = 1e6
    final_clamp: bool = True  # project returned controls onto the actuator
                              # box + re-roll (see ALILQRConfig.final_clamp)
    normal: str = "scan"      # how the GN normal equations are formed:
                              # "scan" = stagewise forward-sensitivity scan
                              # accumulating H = J'J and g = J'r without
                              # ever materializing J — memory O(nz*(nx+nz))
                              # per element instead of O(n_res*nz), which is
                              # what capped the lidar_v4 fleet at B~1024
                              # (the [B, n_res, nz] Jacobian exceeded HBM at
                              # B=4096, VERDICT r2 weak #6);
                              # "dense" = materialize J via jacfwd (legacy,
                              # kept as the equivalence reference)


def expand_controls(U_blk: jax.Array, N: int) -> jax.Array:
    """u_k = U_blk[min(k, Nc-1)] — the reference's move-blocking rule."""
    Nc = U_blk.shape[0]
    idx = jnp.minimum(jnp.arange(N), Nc - 1)
    return U_blk[idx]


def _residuals(ocp: OCP, U_blk: jax.Array, lam: jax.Array, mu):
    """Stacked residual vector r with merit = 0.5 ||r||^2:
    state cost, control cost, (lidar 1/d cost), and PHR penalty rows."""
    N = ocp.N
    U = expand_controls(U_blk, N)
    X = P.rollout(ocp, U)
    dx = X[:-1] - ocp.xref                                   # [N, nx]
    r_state = (jnp.sqrt(2.0 * ocp.Qdiag)[None, :] * dx).reshape(-1)
    r_ctrl = (jnp.sqrt(2.0 * ocp.Rdiag)[None, :] * U).reshape(-1)
    parts = [r_state, r_ctrl]
    if ocp.num_rays:
        d = jnp.maximum(X[:-1, 3:], 1e-3)
        parts.append((jnp.sqrt(2.0 * ocp.inv_dist_weight) / d).reshape(-1))
    c = P.masked_trajectory_constraints(ocp, X, U)           # [N, n_con]
    act = jnp.maximum(0.0, lam - mu * c)
    parts.append((act / jnp.sqrt(mu)).reshape(-1))
    return jnp.concatenate(parts)


def _merit(ocp: OCP, U_blk, lam, mu):
    r = _residuals(ocp, U_blk, lam, mu)
    return 0.5 * jnp.dot(r, r)


def _stage_residual(ocp: OCP, x, u, xref_k, lam_k, mask_k, mov_k, mu):
    """One stage's residual rows (same set as _residuals, permuted — the
    normal equations H = J'J, g = J'r are permutation-invariant)."""
    parts = [jnp.sqrt(2.0 * ocp.Qdiag) * (x - xref_k),
             jnp.sqrt(2.0 * ocp.Rdiag) * u]
    if ocp.num_rays:
        d = jnp.maximum(x[3:], 1e-3)
        parts.append(jnp.sqrt(2.0 * ocp.inv_dist_weight) / d)
    c = P.stage_constraints(ocp, x, u, mov_k)
    c = jnp.where(mask_k > 0, c, P.BIG)
    act = jnp.maximum(0.0, lam_k - mu * c)
    parts.append(act / jnp.sqrt(mu))
    return jnp.concatenate(parts)


def _normal_scan(ocp: OCP, U_blk, lam, mu, Nc: int):
    """Gauss-Newton normal equations by forward-sensitivity scan.

    Propagates S_k = dX_k/dvec(U_blk) [nx, nz] along the rollout
    (S_{k+1} = A_k S_k + B_k E_k with E_k the move-blocking selector) and
    accumulates H = sum_k J_k' J_k, g = sum_k J_k' r_k stagewise, where
    J_k = dr_k/dx . S_k + dr_k/du . E_k. J itself ([n_res, nz]) is never
    materialized — this is what lifts the batched lidar_v4 fleet past the
    B~1024 HBM ceiling of the dense form (VERDICT r2 weak #6). The per-stage
    products are small GEMMs ([rows, nx] x [nx, nz] etc.) that batch
    under vmap. Returns (H [nz, nz], g [nz])."""
    from nmpc_tpu.solver.alilqr import _stage_jacobians

    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    nz = Nc * nu
    dtype = U_blk.dtype
    U = expand_controls(U_blk, N)
    X = P.rollout(ocp, U)
    mask = P.constraint_mask(ocp)
    bidx = jnp.minimum(jnp.arange(N), Nc - 1)
    eye_u = jnp.eye(nu, dtype=dtype)

    def body(carry, inp):
        S, H, g = carry
        x, u, xref_k, lam_k, mask_k, mov_k, b = inp
        onehot = (jnp.arange(Nc) == b).astype(dtype)        # [Nc]
        E = jnp.kron(onehot[None, :], eye_u)                # [nu, nz]
        rf = lambda xx, uu: _stage_residual(ocp, xx, uu, xref_k, lam_k,
                                            mask_k, mov_k, mu)
        r_k = rf(x, u)
        drx = jax.jacfwd(rf, argnums=0)(x, u)               # [rows, nx]
        dru = jax.jacfwd(rf, argnums=1)(x, u)               # [rows, nu]
        Jk = drx @ S + dru @ E                              # [rows, nz]
        H = H + Jk.T @ Jk
        g = g + Jk.T @ r_k
        A_k, B_k = _stage_jacobians(ocp, x, u)
        S = A_k @ S + B_k @ E
        return (S, H, g), None

    carry0 = (jnp.zeros((nx, nz), dtype), jnp.zeros((nz, nz), dtype),
              jnp.zeros((nz,), dtype))
    (S, H, g), _ = jax.lax.scan(
        body, carry0,
        (X[:-1], U, ocp.xref, lam, mask, ocp.mov_obs, bidx))
    return H, g


def solve(ocp: OCP, warm: WarmStart | None = None, cfg: GNConfig = GNConfig()) -> SolveResult:
    """Condensed GN-AL solve; jit/vmap-able (cfg static)."""
    N = ocp.N
    Nc = N if cfg.Nc is None else cfg.Nc
    if warm is None:
        warm = cold_start(ocp)
        warm = WarmStart(U=warm.U, lam=warm.lam, mu=jnp.asarray(cfg.mu_init, ocp.x0.dtype))
    U_blk = warm.U[:Nc]
    lam, mu = warm.lam, warm.mu
    nz = Nc * ocp.nu
    eye = jnp.eye(nz, dtype=ocp.x0.dtype)
    alphas = jnp.asarray(cfg.alphas, ocp.x0.dtype)

    def gn_inner(U_blk, lam, mu):
        cost0 = _merit(ocp, U_blk, lam, mu)

        def cond(carry):
            _, _, it, done = carry
            return (it < cfg.n_gn) & (~done)

        def body(carry):
            U_blk, cost, it, _ = carry
            flat = U_blk.reshape(-1)
            if cfg.normal == "scan":
                H, g = _normal_scan(ocp, flat.reshape(Nc, ocp.nu), lam, mu, Nc)
                H = H + cfg.reg * eye
            else:
                r = _residuals(ocp, flat.reshape(Nc, ocp.nu), lam, mu)
                J = jax.jacfwd(
                    lambda z: _residuals(ocp, z.reshape(Nc, ocp.nu), lam, mu)
                )(flat)
                g = J.T @ r
                H = J.T @ J + cfg.reg * eye
            step = -jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(H), g)

            def try_alpha(a):
                z = flat + a * step
                return z, _merit(ocp, z.reshape(Nc, ocp.nu), lam, mu)

            zs, costs = jax.vmap(try_alpha)(alphas)
            best = jnp.argmin(costs)
            improved = costs[best] < cost
            z_new = jnp.where(improved, zs[best], flat)
            cost_new = jnp.where(improved, costs[best], cost)
            rel = (cost - cost_new) / (1.0 + jnp.abs(cost))
            done = (~improved) | (rel < cfg.tol_cost)
            return (z_new.reshape(Nc, ocp.nu), cost_new, it + 1, done)

        U_blk, cost, iters, _ = jax.lax.while_loop(
            cond, body, (U_blk, cost0, jnp.zeros((), jnp.int32), jnp.zeros((), bool))
        )
        return U_blk, iters

    def cond(carry):
        _, _, _, it, _, _, done = carry
        return (it < cfg.n_outer) & (~done)

    def body(carry):
        U_blk, lam, mu, it, tot, _, _ = carry
        U_blk, iters = gn_inner(U_blk, lam, mu)
        U = expand_controls(U_blk, N)
        X = P.rollout(ocp, U)
        c = P.masked_trajectory_constraints(ocp, X, U)
        viol = jnp.maximum(0.0, -jnp.min(c))
        lam = jnp.clip(jnp.maximum(0.0, lam - mu * c), 0.0, cfg.lam_max)
        done = viol < cfg.tol_con
        mu = jnp.where(done, mu, jnp.minimum(mu * cfg.mu_factor, cfg.mu_max))
        return (U_blk, lam, mu, it + 1, tot + iters, viol, done)

    zero = jnp.zeros((), jnp.int32)
    U_blk, lam, mu, outer, tot, viol, done = jax.lax.while_loop(
        cond, body,
        (U_blk, lam, mu, zero, zero, jnp.asarray(jnp.inf, ocp.x0.dtype), jnp.zeros((), bool)),
    )
    U = expand_controls(U_blk, N)
    if cfg.final_clamp:
        U = jnp.clip(U, ocp.u_lo, ocp.u_hi)
    X = P.rollout(ocp, U)
    if cfg.final_clamp:
        viol = P.max_violation(ocp, X, U)
    return SolveResult(
        X=X, U=U, lam=lam, mu=mu,
        cost=P.total_cost(ocp, X, U),
        viol=viol, inner_iters=tot, outer_iters=outer, converged=done,
    )


def solve_batched(ocp_b: OCP, warm: WarmStart | None = None,
                  cfg: GNConfig = GNConfig()) -> SolveResult:
    """Batched condensed GN-AL: vmap over the batch leaves (x0, xref, and a
    per-element mov_obs schedule if present).

    This is the family-I (LiDAR v4) fleet engine: the per-iteration work is
    one dense [B, Nc*nu, Nc*nu] Cholesky plus batched residual/Jacobian
    evaluations — large batched GEMMs; the ray-augmented class is outside
    the stagewise kernel's problem class
    (obs_avoid_static_first_scenario_v4.py:59-75)."""
    from nmpc_tpu.solver.alilqr_batched import _batch_fields

    bf = _batch_fields(ocp_b)
    updates = {
        f.name: (0 if f.name in bf else None)
        for f in dataclasses.fields(ocp_b)
        if f.name not in P.OCP_META
    }
    ocp_axes = dataclasses.replace(ocp_b, **updates)
    fn = partial(solve, cfg=cfg)
    if warm is None:
        return jax.vmap(lambda o: fn(o), in_axes=(ocp_axes,))(ocp_b)
    return jax.vmap(fn, in_axes=(ocp_axes, 0))(ocp_b, warm)
