"""Batch-native AL-iLQR: the engine for scenario fleets and for the B=1
closed-loop solve.

Every array carries a leading batch axis [B, ...]. The AL outer loop, the
iLQR inner loop and the line search run as `lax.while_loop`s over the whole
batch with per-element masks, until every element is done or the iteration
caps are reached. An element that has converged (outer loop) or finished its
inner solve is frozen by selects, so its result does not depend on what
else is in the batch.

Semantics match solver/alilqr.py (same AL outer loop, merit, expansions,
backward sweep and stopping rules). `ALILQRConfig.ls` picks the line search:
the alpha cascade of the per-scenario engine, or the adaptive per-element
carried trial step.

Route rule (`choose_route`): the inner iLQR solve of each AL outer step runs
as the fused Triton kernel (ops/inner_solve_triton.py) when the problem is
in the kernel's class (`supports`, sequential sweep, at most
KERNEL_MAX_ROBOTS robots) and the default backend is the GPU; otherwise it
runs in plain XLA (`_inner_xla`), which is also the reference every kernel
is compared against. The AL outer loop is XLA on both routes.

A fleet split over several devices goes through
`parallel.batch.solve_batched_sharded`, which runs this engine per shard
inside `shard_map`. Under a plain `jit` of batch-sharded inputs XLA's SPMD
partitioner does not split the kernel's custom call, so the kernel route
would run replicated on every device.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from nmpc_tpu.ocp import problem as P
from nmpc_tpu.ocp.problem import OCP
from nmpc_tpu.solver.alilqr import (
    ALILQRConfig,
    SolveResult,
    WarmStart,
    lqr_gains,
    resolve_sweep,
    stage_expansions,
)

_META = P.OCP_META


def supports(ocp: OCP) -> bool:
    """Problem class of the fused inner-solve kernel: stacked-unicycle Euler
    dynamics with pair / static-obstacle / moving-obstacle / box rows
    (LiDAR rays and user-supplied dynamics are outside it)."""
    return ocp.num_rays == 0 and ocp.integrator == "euler" and ocp.dyn_fn is None


# inner-solve routes of solve_batched
ROUTES = ("xla", "triton")

# Largest team the kernel route takes by default. Measured on an H100
# (PERF.md): the kernel beats the XLA route at every shape it ran — 8.8x at
# one robot N=200 B=1, 15.7x at two robots B=4096, 25x on a decentralized
# step and 28x on a consensus solve (six one-robot subproblems, N=35), 7.1x
# at six robots B=32768 — but its compile time grows steeply with the team
# (5 s at one robot, 17 s at two, 190 s at six, over 8 min at ten, against
# 6-15 s for the XLA route).
KERNEL_MAX_ROBOTS = 2


def _kernel_class(ocp_b: OCP, cfg: ALILQRConfig) -> bool:
    """The problem is one the kernel solves: `supports`, with the
    sequential sweep (the kernel has no associative scan)."""
    return supports(ocp_b) and resolve_sweep(cfg, ocp_b.N) == "seq"


def choose_route(ocp_b: OCP, cfg: ALILQRConfig) -> str:
    """The inner-solve route `solve_batched` takes: the Triton kernel for
    its problem class (`_kernel_class`) with at most KERNEL_MAX_ROBOTS
    robots, on the GPU; XLA otherwise."""
    if (_kernel_class(ocp_b, cfg) and ocp_b.m <= KERNEL_MAX_ROBOTS
            and jax.default_backend() == "gpu"):
        return "triton"
    return "xla"


def _batch_fields(ocp_b: OCP):
    """Leaves carrying a leading batch axis: x0/xref always; mov_obs when a
    per-element moving-obstacle schedule is supplied ([B, N, n_mov, 2] — the
    decentralized mode's per-robot neighbor plans)."""
    bf = ["x0", "xref"]
    if ocp_b.n_mov and ocp_b.mov_obs.ndim == 4:
        bf.append("mov_obs")
    return tuple(bf)


def _vm(fn, ocp_b: OCP, *batched):
    """vmap a per-scenario fn over the batch leaves of the OCP."""
    bf = _batch_fields(ocp_b)
    updates = {
        f.name: (0 if f.name in bf else None)
        for f in dataclasses.fields(ocp_b)
        if f.name not in _META
    }
    ocp_axes = dataclasses.replace(ocp_b, **updates)
    return jax.vmap(fn, in_axes=(ocp_axes,) + (0,) * len(batched))(ocp_b, *batched)


def _gains_b(ocp_b: OCP, cfg: ALILQRConfig, X, U, lam, mu):
    """[B] batched backward pass: expansions, then the LQ gains."""
    return _vm(lambda o, x, u, l, m_: lqr_gains(cfg, *stage_expansions(o, x, u, l, m_)),
               ocp_b, X, U, lam, mu)


def _rollout_b(ocp_b: OCP, U):
    return _vm(lambda o, u: P.rollout(o, u), ocp_b, U)


def _al_cost_b(ocp_b: OCP, X, U, lam, mu):
    return _vm(lambda o, x, u, l, m_: P.al_total_cost(o, x, u, l, m_), ocp_b, X, U, lam, mu)


def _forward_b(ocp_b: OCP, X, U, kff, Kfb, alpha):
    """Closed-loop rollout under the gains with a per-element step alpha [B]."""
    def one(ocp, X, U, kff, Kfb, alpha):
        def body(x, inp):
            xbar, ubar, k_k, K_k = inp
            u = ubar + alpha * k_k + K_k @ (x - xbar)
            xn = P.step_dynamics(ocp, x, u)
            return xn, (xn, u)

        _, (Xt, Un) = jax.lax.scan(body, ocp.x0, (X[:-1], U, kff, Kfb))
        return jnp.concatenate([ocp.x0[None], Xt], axis=0), Un

    return _vm(one, ocp_b, X, U, kff, Kfb, alpha)


def _finalize(ocp_b: OCP, X, U, cfg: ALILQRConfig):
    """Final feasibility restoration (see ALILQRConfig.final_clamp): project
    the controls onto the actuator box, re-roll, recompute cost/viol."""
    if cfg.final_clamp:
        U = jnp.clip(U, ocp_b.u_lo[None, None], ocp_b.u_hi[None, None])
        X = _rollout_b(ocp_b, U)
    viol = _vm(lambda o, x, u: P.max_violation(o, x, u), ocp_b, X, U)
    cost = _vm(lambda o, x, u: P.total_cost(o, x, u), ocp_b, X, U)
    return X, U, cost, viol


def _sel(mask, new, old):
    """Per-element select over arrays with a leading batch axis."""
    return jnp.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def _cascade(ocp_b, cfg, X, U, kff, Kfb, lam, mu, cost, dV1):
    """Every cfg.alphas candidate rolled in parallel; per element the
    cheapest Armijo-passing one. Returns (improved, X, U, cost) of it."""
    B = X.shape[0]
    alphas = jnp.asarray(cfg.alphas, X.dtype)

    def try_alpha(a):
        Xn, Un = _forward_b(ocp_b, X, U, kff, Kfb, jnp.full((B,), a, X.dtype))
        return Xn, Un, _al_cost_b(ocp_b, Xn, Un, lam, mu)

    Xs, Us, costs = jax.vmap(try_alpha)(alphas)                # [A, B, ...]
    expected = cfg.armijo * alphas[:, None] * jnp.maximum(-dV1, 0.0)[None, :]
    ok = (cost[None] - costs) >= expected
    best = jnp.argmin(jnp.where(ok, costs, jnp.inf), axis=0)  # [B]
    take = lambda arr: arr[best, jnp.arange(B)]
    cost_best = take(costs)
    improved = take(ok) & (cost_best < cost)
    return improved, take(Xs), take(Us), cost_best


def _adaptive(ocp_b, cfg, X, U, kff, Kfb, lam, mu, cost, dV1, trial):
    """Carried per-element trial step, first-accept Armijo (ALILQRConfig.ls
    = 'adaptive'): each of cfg.ls_rounds rounds rolls one candidate per
    element; an element that rejects backtracks its trial by ls_beta, an
    accepted step grows by ls_grow (capped at 1) for the next iteration.
    A round in which every element has already accepted is skipped; it
    would change nothing, since accepted elements roll alpha 0 and cannot
    accept again. Returns (alpha, X, U, cost, trial); alpha = 0 where no
    round accepted."""
    decrease = jnp.maximum(-dV1, 0.0)
    zero = jnp.zeros_like(cost)
    state = (jnp.zeros(cost.shape, bool), zero, X, U, cost, trial)

    def ls_round(state):
        acc, alpha_b, Xb, Ub, cost_b, trial = state
        a = jnp.where(acc, 0.0, trial)
        Xa, Ua = _forward_b(ocp_b, X, U, kff, Kfb, a)
        ca = _al_cost_b(ocp_b, Xa, Ua, lam, mu)
        ok = (~acc) & ((cost - ca) >= cfg.armijo * a * decrease) & (ca < cost)
        acc = acc | ok
        return (acc, jnp.where(ok, a, alpha_b), _sel(ok, Xa, Xb),
                _sel(ok, Ua, Ub), jnp.where(ok, ca, cost_b),
                jnp.where(acc, trial, trial * cfg.ls_beta))

    for _ in range(cfg.ls_rounds):
        state = jax.lax.cond(jnp.all(state[0]), lambda s: s, ls_round, state)
    _, alpha, Xb, Ub, cost_b, trial = state
    trial = jnp.where(alpha > 0.0, jnp.minimum(1.0, alpha * cfg.ls_grow), trial)
    return alpha, Xb, Ub, cost_b, trial


def _inner_xla(ocp_b: OCP, cfg: ALILQRConfig, X, U, lam, mu, done0):
    """Inner iLQR solve of one AL outer step for every element not already
    done (done0). Returns (X, U, per-element iteration counts)."""
    B = X.shape[0]
    adaptive = cfg.ls == "adaptive"
    cost0 = _al_cost_b(ocp_b, X, U, lam, mu)

    def cond(c):
        it, done = c[3], c[5]
        return (it < cfg.n_inner) & ~jnp.all(done)

    def body(c):
        X, U, cost, it, it_vec, done, trial = c
        it_vec = it_vec + (~done).astype(jnp.int32)
        kff, Kfb, dV1 = _gains_b(ocp_b, cfg, X, U, lam, mu)
        if adaptive:
            alpha, Xn, Un, costn, trial_n = _adaptive(
                ocp_b, cfg, X, U, kff, Kfb, lam, mu, cost, dV1, trial)
            improved = alpha > 0.0
        else:
            improved, Xn, Un, costn = _cascade(
                ocp_b, cfg, X, U, kff, Kfb, lam, mu, cost, dV1)
            trial_n = trial
        upd = improved & ~done
        costn = jnp.where(upd, costn, cost)
        rel = (cost - costn) / (1.0 + jnp.abs(cost))
        if adaptive:
            # fail-continue: an unimproved element retries next iteration
            # at its shrunk trial, until the trial falls below ls_trial_min
            stop = (improved & (rel < cfg.tol_cost)) | (
                ~improved & (trial_n <= cfg.ls_trial_min))
        else:
            stop = ~improved | (rel < cfg.tol_cost)
        return (_sel(upd, Xn, X), _sel(upd, Un, U), costn, it + 1, it_vec,
                done | stop, jnp.where(done, trial, trial_n))

    init = (X, U, cost0, jnp.zeros((), jnp.int32), jnp.zeros((B,), jnp.int32),
            done0, jnp.ones((B,), X.dtype))
    X, U, _, _, it_vec, _, _ = jax.lax.while_loop(cond, body, init)
    return X, U, it_vec


def _inner_triton(ocp_b: OCP, cfg: ALILQRConfig, X, U, lam, mu, done0,
                  interpret: bool = False):
    """`_inner_xla`'s contract on the fused Triton kernel: the batch is
    moved to the kernel's scenario-minor layout, padded to whole blocks
    with elements marked done."""
    from nmpc_tpu.ops.inner_solve_triton import BLOCK_B, inner_solve

    B, N = U.shape[0], ocp_b.N
    dtype = U.dtype
    pad = (-B) % BLOCK_B

    def lay(a, fill=None):   # [B, ...] -> [..., Bp]
        if pad:
            tail = (jnp.repeat(a[-1:], pad, 0) if fill is None
                    else jnp.full((pad,) + a.shape[1:], fill, a.dtype))
            a = jnp.concatenate([a, tail], 0)
        return jnp.moveaxis(a, 0, -1)

    mov = None
    if ocp_b.n_mov:
        mv = ocp_b.mov_obs
        if mv.ndim == 3:
            mv = jnp.broadcast_to(mv[None], (B, *mv.shape))
        mov = lay(mv.reshape(B, N, 2 * ocp_b.n_mov))
    U_t, iters, Xs = inner_solve(
        ocp_b, cfg, lay(ocp_b.x0), lay(ocp_b.xref), lay(lam), lay(mu),
        lay(done0.astype(dtype), 1.0), lay(U), mov, interpret=interpret)
    U = jnp.moveaxis(U_t, -1, 0)[:B]
    Xs = jnp.moveaxis(Xs, -1, 0)[:B]
    xN = jax.vmap(lambda x, u: P.step_dynamics(ocp_b, x, u))(Xs[:, -1], U[:, -1])
    X = jnp.concatenate([Xs, xN[:, None]], axis=1)
    return X, U, iters[:B].astype(jnp.int32)


def solve_one(
    ocp: OCP,
    warm: WarmStart | None = None,
    cfg: ALILQRConfig = ALILQRConfig(),
) -> SolveResult:
    """Single-scenario solve through the batch-native engine at B=1: the
    engine of the closed-loop MPC drivers when they ask for the batched
    engine's line search (SURVEY.md §6's per-step budget T). Interface
    matches solver.alilqr.solve (unbatched OCP/WarmStart in, unbatched
    SolveResult out)."""
    return _solve_one(ocp, warm, cfg, choose_route(ocp, cfg))


def _solve_one(ocp, warm=None, cfg=ALILQRConfig(), route="xla"):
    ocp_b = dataclasses.replace(ocp, x0=ocp.x0[None], xref=ocp.xref[None])
    warm_b = None if warm is None else jax.tree.map(lambda a: jnp.asarray(a)[None], warm)
    res = _solve_batched(ocp_b, warm_b, cfg, route)
    return jax.tree.map(lambda a: a[0], res)


def solve_batched(
    ocp_b: OCP,
    warm: WarmStart | None = None,
    cfg: ALILQRConfig = ALILQRConfig(),
) -> SolveResult:
    """Solve a batch of OCPs (batch axis on x0/xref, and on mov_obs when it
    is [B, N, n_mov, 2]) on the route of `choose_route`. Jit-able; cfg
    static."""
    return _solve_batched(ocp_b, warm, cfg, choose_route(ocp_b, cfg))


def _solve_batched(ocp_b, warm=None, cfg=ALILQRConfig(), route="xla"):
    """`solve_batched` on a given route (one of ROUTES); comparisons of the
    routes call this. The kernel route refuses problems outside its class,
    which it would otherwise solve wrongly without an error."""
    if route not in ROUTES:
        raise ValueError(f"route {route!r} not in {ROUTES}")
    if route == "triton" and not _kernel_class(ocp_b, cfg):
        raise ValueError("the kernel route solves only the `supports` problem "
                         "class with the sequential sweep")
    B = ocp_b.x0.shape[0]
    N, nu, nc = ocp_b.N, ocp_b.nu, ocp_b.n_con
    dtype = ocp_b.x0.dtype
    if warm is None:
        if cfg.cold_seed == "polar" and ocp_b.num_rays == 0:
            U0 = _polar_seed(ocp_b)
        else:
            U0 = jnp.zeros((B, N, nu), dtype)
        warm = WarmStart(
            U=U0,
            lam=jnp.zeros((B, N, nc), dtype),
            mu=jnp.full((B,), cfg.mu_init, dtype),
        )
    U, lam, mu = warm.U, warm.lam, warm.mu
    X = _rollout_b(ocp_b, U)
    inner = _inner_triton if route == "triton" else _inner_xla

    def outer_cond(c):
        it, done = c[4], c[7]
        return (it < cfg.n_outer) & ~jnp.all(done)

    def outer_body(c):
        X, U, lam, mu, it, inner_tot, outer_vec, done = c
        outer_vec = outer_vec + (~done).astype(jnp.int32)
        X, U, iters = inner(ocp_b, cfg, X, U, lam, mu, done)
        cmask = _vm(lambda o, x, u: P.masked_trajectory_constraints(o, x, u),
                    ocp_b, X, U)
        viol = jnp.maximum(0.0, -jnp.min(cmask, axis=(1, 2)))
        lam_new = jnp.clip(
            jnp.maximum(0.0, lam - mu[:, None, None] * cmask), 0.0, cfg.lam_max
        )
        newly = viol < cfg.tol_con
        lam = _sel(done, lam, lam_new)
        mu = jnp.where(done | newly, mu, jnp.minimum(mu * cfg.mu_factor, cfg.mu_max))
        return (X, U, lam, mu, it + 1, inner_tot + iters, outer_vec, done | newly)

    zero_vec = jnp.zeros((B,), jnp.int32)
    X, U, lam, mu, _, inner_tot, outer_vec, done = jax.lax.while_loop(
        outer_cond, outer_body,
        (X, U, lam, mu, jnp.zeros((), jnp.int32), zero_vec, zero_vec,
         jnp.zeros((B,), bool)),
    )
    X, U, cost, viol = _finalize(ocp_b, X, U, cfg)
    return SolveResult(
        X=X, U=U, lam=lam, mu=mu, cost=cost, viol=viol,
        inner_iters=inner_tot, outer_iters=outer_vec, converged=done,
    )


def _polar_seed(ocp_b: OCP) -> jax.Array:
    """Cold-start controls from a per-robot polar go-to-goal law rolled
    through the model (ALILQRConfig.cold_seed='polar').

    Seeds the descent with the clipped polar controller (turn to the goal
    bearing, drive proportional to distance — the same law as the driver's
    parking escape) instead of rest. Collision handling still belongs to
    the AL loop: the seed ignores constraints on purpose (lam starts at 0
    and mu at mu_init, exactly as with a zero seed).

    MEASURED (six-robot antipodal N=10, CPU): the seed does NOT reduce
    iterations — mean inner iterations are unchanged (45.2 with either
    seed at B=64; identical mean at B=8 with explicit warm starts, costs
    differing only in the 6th digit). The solve's iterations are spent
    resolving the constraint-coupled crossing, not rebuilding motion from
    rest, so a goal-directed unconstrained seed buys nothing on the
    collision configs. Kept as an option for unconstrained/waypoint
    problem classes; the fleet benchmark stays on the reference-faithful
    zero seed."""
    B, m = ocp_b.x0.shape[0], ocp_b.m
    goal = ocp_b.xref[:, -1, :]                       # [B, nx]
    gp = goal[:, : 3 * m].reshape(B, m, 3)
    v_hi = ocp_b.u_hi[0:: 2][:m]
    w_hi = ocp_b.u_hi[1:: 2][:m]

    def step(x, _):
        pose = x[:, : 3 * m].reshape(B, m, 3)
        ex = gp[..., 0] - pose[..., 0]
        ey = gp[..., 1] - pose[..., 1]
        dist = jnp.hypot(ex, ey)
        bearing = jnp.arctan2(ey, ex)
        delta = bearing - pose[..., 2]
        delta = jnp.arctan2(jnp.sin(delta), jnp.cos(delta))
        v = jnp.clip(1.5 * dist * jnp.cos(delta), -v_hi, v_hi)
        v = jnp.where(jnp.abs(delta) < 1.2, v, 0.0)
        w = jnp.clip(1.5 * delta, -w_hi, w_hi)
        u = jnp.stack([v, w], axis=-1).reshape(B, 2 * m)
        xn = _vm(lambda o, xx, uu: P.step_dynamics(o, xx, uu),
                 dataclasses.replace(ocp_b, x0=x), x, u)
        return xn, u

    _, U = jax.lax.scan(step, ocp_b.x0, None, length=ocp_b.N)
    return jnp.swapaxes(U, 0, 1)                      # [B, N, nu]
