"""AL-iLQR: augmented-Lagrangian iLQR — the NLP engine.

Replaces CasADi's `nlpsol('solver','ipopt', ...)` (L3 of SURVEY.md §1;
/root/reference/AllScripts/mpc_online_casadi_tb3_six_multi_centralized_collision_free.py:272-276).
It solves the same multiple-shooting OCP: at convergence the rollout states
equal the shooting states (Euler defects are satisfied exactly by
construction) and the PHR multiplier iteration drives the KKT conditions of
the inequality set to tolerance, so solutions match IPOPT's to trajectory
tolerance.

Why this shape for an accelerator (instead of an interior-point +
sparse-LDL^T port):
  * every iteration is fixed-shape and branch-free under `jit` — the whole
    solve is nested `lax.scan`/`lax.while_loop`, compiled once per
    (m, N, n_obs) bucket;
  * the KKT system is never materialized: the block-tridiagonal structure is
    solved by a Riccati backward sweep of tiny (nx<=30) dense blocks, O(N)
    instead of a sparse factorization with dynamic pivoting;
  * Hessians are Gauss-Newton and therefore PSD by construction — no
    inertia-correction branches, a fixed Levenberg regularizer suffices;
  * the line search evaluates all step lengths *in parallel* (vmap over
    alphas) rather than sequentially backtracking;
  * everything vmaps over a scenario batch (solver/alilqr_batched.py is the
    batch-native form).

Structure: outer PHR multiplier loop (lam <- max(0, lam - mu c), mu <- b mu)
around an inner iLQR descent on the AL merit.  Control bounds are both
penalized and clamped in the forward rollout (ALTRO-style), so iterates are
always actuator-feasible.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from nmpc_tpu.models.unicycle import euler_jacobians
from nmpc_tpu.ocp import problem as P
from nmpc_tpu.ocp.problem import OCP


@dataclasses.dataclass(frozen=True)
class ALILQRConfig:
    """Solver options (static: hashable, part of the compiled program)."""

    n_outer: int = 12         # AL multiplier updates
    n_inner: int = 25         # max iLQR iterations per outer step
    mu_init: float = 10.0     # initial penalty weight
    mu_factor: float = 10.0   # penalty growth per outer step
    mu_max: float = 1e4       # cap (f32-friendly conditioning; lam does the rest)
    reg: float = 1e-6         # fixed Levenberg regularizer on Quu
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.001)
    tol_cost: float = 1e-7    # relative merit-decrease stop (inner)
    tol_con: float = 1e-4     # max constraint violation stop (outer)
    lam_max: float = 1e6      # multiplier clip
    armijo: float = 1e-4      # accept fraction of expected decrease
    ls: str = "cascade"       # line-search strategy of the batched engine
                              # (solver/alilqr_batched.py; the per-scenario
                              # `solve` always runs the cascade):
                              # "cascade" = evaluate every cfg.alphas
                              # candidate, accept the best Armijo-passing
                              # one (the reference-parity strategy);
                              # "adaptive" = carried per-element trial
                              # step: each round rolls ONE candidate with a
                              # per-element alpha (first-accept Armijo),
                              # failed elements backtrack by ls_beta, and
                              # the accepted step is grown by ls_grow
                              # (capped at 1) for the next iteration. A
                              # typical iteration pays 1-2 merit
                              # evaluations instead of len(alphas) = 8.
    ls_rounds: int = 2        # adaptive: candidate evaluations/iteration.
                              # An element that fails every round is NOT
                              # done — its carried trial keeps shrinking and
                              # it retries next iteration (fail-continue),
                              # so small ls_rounds trades a few extra cheap
                              # iterations for far fewer merit evaluations;
                              # it gives up only once its trial falls
                              # below ls_trial_min (the analog of
                              # exhausting the cascade's alpha grid).
    ls_beta: float = 0.2      # adaptive: backtrack factor on rejection
    ls_grow: float = 4.0      # adaptive: growth factor on acceptance
    ls_trial_min: float = 1e-5  # adaptive: give-up threshold on the carried
                              # trial step. Deeper than the cascade grid's
                              # 1e-3 floor on purpose: stiff AL box rows at
                              # mu_max need alpha ~ 1e-4..1e-5 to make
                              # progress (the two_robot_swap parity-outlier
                              # stall was exactly this — a merit-gradient
                              # norm of 218 at a point the cascade's 1e-3
                              # floor could not descend from; alphas down to
                              # 1e-5 reach the f64 oracle optimum).
    cold_seed: str = "zero"   # initial controls when no WarmStart is given:
                              # "zero" = U = 0 (reference-faithful: the
                              # scripts warm-start X0 = repmat(x0) which
                              # implies zero initial motion); "polar" =
                              # roll a per-robot polar go-to-goal law
                              # through the plant and seed its controls —
                              # the solver starts from a moving, roughly
                              # goal-directed trajectory instead of rest
                              # (batched paths only; ignored for
                              # ray-augmented problems)
    sweep: str = "seq"        # backward pass: "seq" = O(N) Riccati scan,
                              # "scan" = O(log N) associative-scan LQR
                              # (ops/assoc_lqr.py) for long horizons (the
                              # reference runs N up to 200, tb3_1.py:57),
                              # "auto" = scan iff N >= SCAN_N_MIN
    final_clamp: bool = True  # project the returned controls onto the
                              # actuator box and re-roll once (ALTRO-style
                              # feasibility restoration). The AL penalty
                              # leaves 1e-3-class u-bound violations at
                              # optima (f32 polish limit); the projected
                              # re-roll makes u rows exactly feasible and
                              # barely moves the trajectory (measured: cost
                              # +1e-3 rel, five_robot lands within 5e-5 of
                              # the f64 oracle optimum). Matches deployment:
                              # the plant saturates commands anyway
                              # (sim/plant.py). In-iteration clamping was
                              # tried and REJECTED: the quadratic model
                              # doesn't see the box, so clamped candidates
                              # stall the line search (six-robot viol
                              # degraded 8e-5 -> 4.5e-2).


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("U", "lam", "mu"),
    meta_fields=(),
)
@dataclasses.dataclass(frozen=True)
class WarmStart:
    U: jax.Array    # [N, nu]
    lam: jax.Array  # [N, n_con]
    mu: jax.Array   # scalar penalty weight


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("X", "U", "lam", "mu", "cost", "viol", "inner_iters", "outer_iters", "converged"),
    meta_fields=(),
)
@dataclasses.dataclass(frozen=True)
class SolveResult:
    X: jax.Array            # [N+1, nx] optimal state trajectory
    U: jax.Array            # [N, nu]  optimal controls
    lam: jax.Array          # [N, n_con] final multipliers (warm-startable)
    mu: jax.Array           # final penalty weight
    cost: jax.Array         # reference objective (no penalty terms)
    viol: jax.Array         # max inequality violation
    inner_iters: jax.Array  # total iLQR iterations used
    outer_iters: jax.Array  # AL outer steps used
    converged: jax.Array    # bool


def cold_start(ocp: OCP, cfg: ALILQRConfig = ALILQRConfig()) -> WarmStart:
    dtype = ocp.x0.dtype
    return WarmStart(
        U=jnp.zeros((ocp.N, ocp.nu), dtype),
        lam=jnp.zeros((ocp.N, ocp.n_con), dtype),
        mu=jnp.asarray(cfg.mu_init, dtype),
    )


# ---------------------------------------------------------------------------
# Stage expansions
# ---------------------------------------------------------------------------


def _stage_jacobians(ocp: OCP, x, u):
    """(A, B) of the discrete step; analytic for the plain Euler model,
    jacfwd for LiDAR-augmented and user-supplied (dyn_fn) models."""
    if ocp.integrator == "euler" and ocp.num_rays == 0 and ocp.dyn_fn is None:
        return euler_jacobians(x, u, ocp.T)
    F = lambda xx, uu: P.step_dynamics(ocp, xx, uu)
    return jax.jacfwd(F, argnums=0)(x, u), jax.jacfwd(F, argnums=1)(x, u)


def _stage_expansion(ocp: OCP, x, u, xref_k, lam_k, mov_k, mu):
    """Gradients and Gauss-Newton Hessians of the AL merit stage term."""
    nx, nu = ocp.nx, ocp.nu
    dx = x - xref_k
    lx = 2.0 * ocp.Qdiag * dx
    lu = 2.0 * ocp.Rdiag * u
    lxx = jnp.diag(2.0 * ocp.Qdiag)
    luu = jnp.diag(2.0 * ocp.Rdiag)
    lux = jnp.zeros((nu, nx), x.dtype)

    if ocp.num_rays:
        # inverse-distance cost w * sum 1/d^2: grad -2w/d^3, hess 6w/d^4 (diag)
        d = jnp.maximum(x[3:], 1e-3)
        gray = -2.0 * ocp.inv_dist_weight / d**3
        hray = 6.0 * ocp.inv_dist_weight / d**4
        lx = lx.at[3:].add(gray)
        lxx = lxx + jnp.diag(jnp.concatenate([jnp.zeros((3,), x.dtype), hray]))

    # PHR penalty: grad = -J' act, GN hess = mu J' 1[active] J
    c = P.stage_constraints(ocp, x, u, mov_k)
    if ocp.num_rays == 0 and ocp.dyn_fn is None:
        from nmpc_tpu.ocp.jacobians import stage_constraint_jacobians

        Jx, Ju = stage_constraint_jacobians(ocp, x, mov_k)
    else:
        Jx = jax.jacfwd(lambda xx: P.stage_constraints(ocp, xx, u, mov_k))(x)
        Ju = jax.jacfwd(lambda uu: P.stage_constraints(ocp, x, uu, mov_k))(u)
    act = jnp.maximum(0.0, lam_k - mu * c)
    w = mu * (act > 0.0).astype(x.dtype)
    lx = lx - Jx.T @ act
    lu = lu - Ju.T @ act
    JxW = Jx * w[:, None]
    JuW = Ju * w[:, None]
    lxx = lxx + Jx.T @ JxW
    luu = luu + Ju.T @ JuW
    lux = lux + Ju.T @ JxW
    return lx, lu, lxx, luu, lux


# ---------------------------------------------------------------------------
# Backward Riccati sweep
# ---------------------------------------------------------------------------


def resolve_sweep(cfg: ALILQRConfig, N: int) -> str:
    """cfg.sweep with 'auto' resolved: the associative scan only from
    SCAN_N_MIN stages up (see its note)."""
    if cfg.sweep != "auto":
        return cfg.sweep
    return "scan" if N >= SCAN_N_MIN else "seq"


# sweep='auto' threshold. No shape the reference publishes (N <= 200) is
# known to favour the O(log N) associative scan over the sequential sweep:
# each scan combine is a dense [nx, nx] product chain that does log N times
# the sequential sweep's work. The crossover on the GPU has not been
# measured, so 'auto' resolves to 'seq' at every published shape and 'scan'
# stays an explicit opt-in.
SCAN_N_MIN = 10_000


def stage_expansions(ocp: OCP, X, U, lam, mu):
    """Dynamics Jacobians and AL stage expansions at stages 0..N-1:
    (A, B, lx, lu, lxx, luu, lux), each with a leading [N] axis."""
    A, B = jax.vmap(lambda x, u: _stage_jacobians(ocp, x, u))(X[:-1], U)
    lx, lu, lxx, luu, lux = jax.vmap(
        lambda x, u, r, l, mk: _stage_expansion(ocp, x, u, r, l, mk, mu)
    )(X[:-1], U, ocp.xref, lam, ocp.mov_obs)
    return A, B, lx, lu, lxx, luu, lux


def lqr_gains(cfg: ALILQRConfig, A, B, lx, lu, lxx, luu, lux):
    """Feedback gains of the AL-quadratized LQ subproblem of one scenario:
    (kff [N, nu], Kfb [N, nu, nx], dV1), dV1 the expected decrease's linear
    term. Terminal value is exactly zero: the reference objective carries no
    terminal cost and no constraints on X[:,N] (SURVEY.md §2.1)."""
    if resolve_sweep(cfg, A.shape[0]) == "scan":
        # horizon-parallel associative-scan LQR: O(log N) depth instead of an
        # N-step sequential chain. Iterates are single-shooting consistent,
        # so the LQ subproblem in delta coordinates has zero defects (c = 0).
        from nmpc_tpu.ops.assoc_lqr import parallel_lqr_gains

        reg_I = cfg.reg * jnp.eye(B.shape[-1], dtype=A.dtype)
        kff, Kfb, _, v = parallel_lqr_gains(
            A, B, jnp.zeros_like(lx), lxx, lx, luu + reg_I, lu, lux
        )
        # dV1 = sum_k kff_k . Qu_k with Qu_k = lu_k + B_k' Vx_{k+1} and
        # Vx = S @ 0 - v = -v (delta coords)
        Qu = lu - jnp.einsum("knm,kn->km", B, v[1:])
        return kff, Kfb, jnp.sum(kff * Qu)
    return riccati_sweep(A, B, lx, lu, lxx, luu, lux, cfg.reg)


def riccati_sweep(A, B, lx, lu, lxx, luu, lux, reg):
    """Sequential LQR backward recursion over the N stages of one scenario:
    A [N, nx, nx], B [N, nx, nu], lx [N, nx], lu [N, nu], lxx [N, nx, nx],
    luu [N, nu, nu], lux [N, nu, nx] -> (kff [N, nu], Kfb [N, nu, nx], dV1)."""
    nx, nu = A.shape[-1], B.shape[-1]
    dtype = A.dtype
    reg = jnp.asarray(reg, dtype)

    def body(carry, inp):
        Vx, Vxx, dV1 = carry
        A_k, B_k, lx_k, lu_k, lxx_k, luu_k, lux_k = inp
        AtV = A_k.T @ Vxx
        Qx = lx_k + A_k.T @ Vx
        Qu = lu_k + B_k.T @ Vx
        Qxx = lxx_k + AtV @ A_k
        Qux = lux_k + B_k.T @ Vxx @ A_k
        Quu = luu_k + B_k.T @ Vxx @ B_k + reg * jnp.eye(nu, dtype=dtype)
        Quu = 0.5 * (Quu + Quu.T)
        chol = jax.scipy.linalg.cho_factor(Quu)
        kff = -jax.scipy.linalg.cho_solve(chol, Qu)
        Kfb = -jax.scipy.linalg.cho_solve(chol, Qux)
        Vx_n = Qx + Kfb.T @ Quu @ kff + Kfb.T @ Qu + Qux.T @ kff
        Vxx_n = Qxx + Kfb.T @ Quu @ Kfb + Kfb.T @ Qux + Qux.T @ Kfb
        Vxx_n = 0.5 * (Vxx_n + Vxx_n.T)
        return (Vx_n, Vxx_n, dV1 + jnp.dot(kff, Qu)), (kff, Kfb)

    init = (jnp.zeros((nx,), dtype), jnp.zeros((nx, nx), dtype),
            jnp.zeros((), dtype))
    (_, _, dV1), (kff, Kfb) = jax.lax.scan(
        body, init, (A, B, lx, lu, lxx, luu, lux), reverse=True
    )
    return kff, Kfb, dV1


# ---------------------------------------------------------------------------
# Forward pass: parallel line search
# ---------------------------------------------------------------------------


def _forward_rollout(ocp: OCP, X, U, kff, Kfb, alpha):
    def body(x, inp):
        xbar, ubar, k_k, K_k = inp
        u = ubar + alpha * k_k + K_k @ (x - xbar)
        xn = P.step_dynamics(ocp, x, u)
        return xn, (xn, u)

    _, (Xt, Un) = jax.lax.scan(body, ocp.x0, (X[:-1], U, kff, Kfb))
    Xn = jnp.concatenate([ocp.x0[None, :], Xt], axis=0)
    return Xn, Un


def _line_search(ocp: OCP, cfg: ALILQRConfig, X, U, kff, Kfb, lam, mu, cost0, dV1):
    """All candidate steps evaluated in parallel (vmap over alphas) — one
    batch instead of IPOPT's sequential backtracking. Accepts the best
    candidate achieving an Armijo fraction of the expected LQR decrease."""
    alphas = jnp.asarray(cfg.alphas, X.dtype)

    def try_alpha(alpha):
        Xn, Un = _forward_rollout(ocp, X, U, kff, Kfb, alpha)
        return Xn, Un, P.al_total_cost(ocp, Xn, Un, lam, mu)

    Xs, Us, costs = jax.vmap(try_alpha)(alphas)
    expected = cfg.armijo * alphas * jnp.maximum(-dV1, 0.0)
    ok = (cost0 - costs) >= expected
    masked = jnp.where(ok, costs, jnp.inf)
    best = jnp.argmin(masked)
    improved = ok[best] & (costs[best] < cost0)
    Xn = jnp.where(improved, Xs[best], X)
    Un = jnp.where(improved, Us[best], U)
    cost = jnp.where(improved, costs[best], cost0)
    return Xn, Un, cost, improved


# ---------------------------------------------------------------------------
# Solve
# ---------------------------------------------------------------------------


def _inner_ilqr(ocp: OCP, cfg: ALILQRConfig, X, U, lam, mu):
    cost0 = P.al_total_cost(ocp, X, U, lam, mu)

    def cond(carry):
        _, _, _, it, done = carry
        return (it < cfg.n_inner) & (~done)

    def body(carry):
        X, U, cost, it, _ = carry
        kff, Kfb, dV1 = lqr_gains(cfg, *stage_expansions(ocp, X, U, lam, mu))
        Xn, Un, costn, improved = _line_search(ocp, cfg, X, U, kff, Kfb, lam, mu, cost, dV1)
        rel_drop = (cost - costn) / (1.0 + jnp.abs(cost))
        done = (~improved) | (rel_drop < cfg.tol_cost)
        return (Xn, Un, costn, it + 1, done)

    X, U, cost, iters, _ = jax.lax.while_loop(
        cond, body, (X, U, cost0, jnp.zeros((), jnp.int32), jnp.zeros((), bool))
    )
    return X, U, cost, iters


def solve(ocp: OCP, warm: WarmStart | None = None, cfg: ALILQRConfig = ALILQRConfig()) -> SolveResult:
    """Solve one NMPC problem. jit/vmap/pjit-able (cfg is static)."""
    if warm is None:
        warm = cold_start(ocp, cfg)
    U = warm.U
    X = P.rollout(ocp, U)
    lam, mu = warm.lam, warm.mu

    def cond(carry):
        _, _, _, _, it, _, viol, done = carry
        return (it < cfg.n_outer) & (~done)

    def body(carry):
        X, U, lam, mu, it, inner_tot, _, _ = carry
        X, U, _, iters = _inner_ilqr(ocp, cfg, X, U, lam, mu)
        c = P.masked_trajectory_constraints(ocp, X, U)
        viol = jnp.maximum(0.0, -jnp.min(c))
        lam = jnp.clip(jnp.maximum(0.0, lam - mu * c), 0.0, cfg.lam_max)
        done = viol < cfg.tol_con
        mu = jnp.where(done, mu, jnp.minimum(mu * cfg.mu_factor, cfg.mu_max))
        return (X, U, lam, mu, it + 1, inner_tot + iters, viol, done)

    zero = jnp.zeros((), jnp.int32)
    X, U, lam, mu, outer, inner_tot, viol, done = jax.lax.while_loop(
        cond, body, (X, U, lam, mu, zero, zero, jnp.asarray(jnp.inf, X.dtype), jnp.zeros((), bool))
    )
    if cfg.final_clamp:
        U = jnp.clip(U, ocp.u_lo, ocp.u_hi)
        X = P.rollout(ocp, U)
        viol = P.max_violation(ocp, X, U)
    return SolveResult(
        X=X,
        U=U,
        lam=lam,
        mu=mu,
        cost=P.total_cost(ocp, X, U),
        viol=viol,
        inner_iters=inner_tot,
        outer_iters=outer,
        converged=done,
    )
