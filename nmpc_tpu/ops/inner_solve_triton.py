"""Fused AL-iLQR inner solve for the GPU: one Pallas kernel (Triton route)
per AL outer step.

Each thread owns one scenario. Every matrix of the iLQR iteration is a
Python list of [BLOCK_B] vectors (one entry per list slot, one scenario per
vector lane), so the kernel body is the scalar program of one scenario,
unrolled over the matrix entries and vectorised over the block's scenarios.
Blocks are independent: block b solves scenarios b*BLOCK_B .. (b+1)*BLOCK_B-1.

Per block, the kernel runs up to n_inner iterations of: stage expansions
(recomputed where they are used, never stored), the backward Riccati sweep,
the line search (cascade or adaptive, as ALILQRConfig.ls says), and the
accepted rollout. The stage states X, the gains kff/Kfb and the sweep's
dense matrices (Vxx, Qxx, Qux, Quu) live in device-memory workspaces that
the kernel declares as extra outputs and that stay in the cache; the dense
products loop over a dynamic row index on them, which keeps the unrolled
code (and the compile time) small. An iteration in which every scenario of
the block is done is skipped.

Problem class: stacked-unicycle Euler dynamics with pair / static-obstacle /
moving-obstacle / box rows (solver.alilqr_batched.supports). The unicycle
Jacobians are used in their sparse form: A = I + E with E[3r, 3r+2] = e1[r],
E[3r+1, 3r+2] = e2[r]; B[3r, 2r] = bc[r], B[3r+1, 2r] = bs[r],
B[3r+2, 2r+1] = dt.

Layouts are scenario-minor: x0 [n, Bp], xref [N, n, Bp], lam [N, nc, Bp],
U [N, nu, Bp], mov [N, 2 n_mov, Bp], with Bp a multiple of BLOCK_B.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from nmpc_tpu.ocp.problem import OCP, pair_indices

NUM_WARPS = 1
BLOCK_B = 32 * NUM_WARPS  # one scenario per thread


class _Layout:
    """Static offsets into the parameter vector."""

    def __init__(self, ocp: OCP):
        n, mc = ocp.nx, ocp.nu
        self.q = 0
        self.r = n
        self.u_lo = self.r + mc
        self.u_hi = self.u_lo + mc
        self.x_lo = self.u_hi + mc
        self.x_hi = self.x_lo + n
        self.dmin2 = self.x_hi + n
        self.dt = self.dmin2 + 1
        self.obs = self.dt + 1           # n_obs rows of (ox, oy, keepout)
        self.pairs = self.obs + 3 * ocp.n_obs   # (i, j) robot indices per pair
        self.alphas = self.pairs + 2 * ocp.n_pairs


class _Scratch:
    """Static row offsets into the per-scenario scratch workspace of the
    backward sweep: Vxx and Qxx (full n x n), Qux (nu x n), Quu (nu x nu),
    the sparse Jacobian entries (e1, e2, bc, bs per robot), Qx and Vx, the
    stage gradients lx, lu and the diagonal luu, the Cholesky factor of Quu;
    and the state x and control u that the constraint loops read by a
    dynamic index."""

    def __init__(self, ocp: OCP):
        n, mc, m = ocp.nx, ocp.nu, ocp.m
        self.v = 0
        self.q = n * n
        self.qu = 2 * n * n
        self.quu = self.qu + mc * n
        self.jac = self.quu + mc * mc
        self.qx = self.jac + 4 * m
        self.vx = self.qx + n
        self.u = self.vx + n
        self.x = self.u + mc
        self.lx = self.x + n
        self.lu = self.lx + n
        self.luu = self.lu + mc
        self.l = self.luu + mc
        self.linv = self.l + mc * mc
        self.size = self.linv + mc


def pack_params(ocp: OCP, alphas) -> jax.Array:
    """The problem's shared numeric data, its pair table and the cascade's
    step lengths as one vector (see _Layout)."""
    dtype = ocp.Qdiag.dtype
    keepout = ocp.obstacles[:, 2] + ocp.robot_radius + ocp.obs_margin
    obs = jnp.concatenate([ocp.obstacles[:, :2], keepout[:, None]], axis=1)
    pairs = (jnp.asarray(pair_indices(ocp.m), dtype).T.reshape(-1)
             if ocp.n_pairs else jnp.zeros((0,), dtype))
    return jnp.concatenate([
        ocp.Qdiag, ocp.Rdiag, ocp.u_lo, ocp.u_hi, ocp.x_lo, ocp.x_hi,
        ocp.dmin2[None], ocp.T[None], obs.reshape(-1), pairs,
        jnp.asarray(alphas, dtype),
    ])


def _for(n, body):
    """for i in range(n): body(i), as a loop with no carried values."""
    jax.lax.fori_loop(0, n, lambda i, c: (body(i), c)[1], ())


def _make_kernel(ocp: OCP, cfg):
    N, n, mc, m = ocp.N, ocp.nx, ocp.nu, ocp.m
    n_obs, n_mov = ocp.n_obs, ocp.n_mov
    L = _Layout(ocp)
    W = _Scratch(ocp)
    adaptive = cfg.ls == "adaptive"

    def kernel(prm_ref, x0_ref, xref_ref, lam_ref, mu_ref, done_ref, U_ref,
               *rest):
        if n_mov:
            mov_ref, rest = rest[0], rest[1:]
        U_s, it_ref, X_s, kff_s, Kfb_s, W_s = rest

        # ---- shared scalars, loaded once ----
        def prm(i):
            return prm_ref[i]

        q = [prm(L.q + i) for i in range(n)]
        r = [prm(L.r + a) for a in range(mc)]
        dmin2 = prm(L.dmin2)
        dt = prm(L.dt)

        mu = mu_ref[:]
        zero = jnp.zeros_like(mu)
        one = jnp.ones_like(mu)

        def load(ref, k, cnt):
            return [ref[k, i, :] for i in range(cnt)]

        def dyn(x, u):
            out = []
            for rb in range(m):
                th, v, w = x[3 * rb + 2], u[2 * rb], u[2 * rb + 1]
                out += [x[3 * rb] + dt * v * jnp.cos(th),
                        x[3 * rb + 1] + dt * v * jnp.sin(th),
                        th + dt * w]
            return out

        # Constraint rows, in the problem's row order: pairs, obstacles,
        # moving obstacles, u box, x box. Each family is a loop over its
        # rows with the stage's x and u in the scratch rows W.x / W.u, so
        # the unrolled code does not grow with the number of rows.
        # `visit(carry, row, c, grads, x_dep)` gets grads = [(index, dc/d.)]
        # over x entries (x_dep rows) or one u entry (index n + a).
        n_pairs = ocp.n_pairs
        base_obs = n_pairs
        base_mov = base_obs + m * n_obs
        base_u = base_mov + m * n_mov
        base_x = base_u + 2 * mc

        def xs(i):
            return W_s[W.x + i, :]

        def for_rows(k, visit, carry):
            def pair(p, c):
                i = prm_ref[L.pairs + 2 * p].astype(jnp.int32)
                j = prm_ref[L.pairs + 2 * p + 1].astype(jnp.int32)
                dx = xs(3 * i) - xs(3 * j)
                dy = xs(3 * i + 1) - xs(3 * j + 1)
                return visit(c, p, dx * dx + dy * dy - dmin2,
                             [(3 * i, 2 * dx), (3 * i + 1, 2 * dy),
                              (3 * j, -2 * dx), (3 * j + 1, -2 * dy)], True)

            def obstacle(t, c):
                i, o = jax.lax.div(t, n_obs), jax.lax.rem(t, n_obs)
                dx = xs(3 * i) - prm_ref[L.obs + 3 * o]
                dy = xs(3 * i + 1) - prm_ref[L.obs + 3 * o + 1]
                d = jnp.sqrt(jnp.maximum(dx * dx + dy * dy, 1e-12))
                return visit(c, base_obs + t, d - prm_ref[L.obs + 3 * o + 2],
                             [(3 * i, dx / d), (3 * i + 1, dy / d)], True)

            def moving(t, c):
                i, o = jax.lax.div(t, n_mov), jax.lax.rem(t, n_mov)
                dx = xs(3 * i) - mov_ref[k, 2 * o, :]
                dy = xs(3 * i + 1) - mov_ref[k, 2 * o + 1, :]
                return visit(c, base_mov + t, dx * dx + dy * dy - dmin2,
                             [(3 * i, 2 * dx), (3 * i + 1, 2 * dy)], True)

            def u_box(a, c):
                u = W_s[W.u + a, :]
                c = visit(c, base_u + a, u - prm_ref[L.u_lo + a], [(n + a, 1.0)], False)
                return visit(c, base_u + mc + a, prm_ref[L.u_hi + a] - u,
                             [(n + a, -1.0)], False)

            def x_box(i, c):
                x = xs(i)
                c = visit(c, base_x + i, x - prm_ref[L.x_lo + i], [(i, 1.0)], True)
                return visit(c, base_x + n + i, prm_ref[L.x_hi + i] - x,
                             [(i, -1.0)], True)

            for cnt, body in ((n_pairs, pair), (m * n_obs, obstacle),
                              (m * n_mov, moving), (mc, u_box), (n, x_box)):
                if cnt:
                    carry = jax.lax.fori_loop(0, cnt, body, carry)
            return carry

        def act_of(k, row, c, x_dep):
            """max(0, lam - mu c), zero for the state rows of stage 0
            (constraint_mask semantics)."""
            act = jnp.maximum(0.0, lam_ref[k, row, :] - mu * c)
            return jnp.where(k == 0, zero, act) if x_dep else act

        def put_xu(x, u):
            for i in range(n):
                W_s[W.x + i, :] = x[i]
            for a in range(mc):
                W_s[W.u + a, :] = u[a]

        def merit(k, x, u):
            put_xu(x, u)
            xr = load(xref_ref, k, n)
            cost = zero
            for i in range(n):
                d = x[i] - xr[i]
                cost = cost + q[i] * d * d
            for a in range(mc):
                cost = cost + r[a] * u[a] * u[a]

            def visit(pen, row, c, grads, x_dep):
                act = act_of(k, row, c, x_dep)
                return pen + act * act

            return cost + for_rows(k, visit, zero) / (2.0 * mu)

        def add(row, v):
            W_s[row, :] = W_s[row, :] + v

        def expansion(k, x, u):
            """Gauss-Newton AL expansion of stage k into the scratch rows:
            lx -> W.lx, lu -> W.lu, luu (diagonal) -> W.luu, and lxx added
            onto the Qxx rows (lux = 0 for this class)."""
            put_xu(x, u)
            xr = load(xref_ref, k, n)
            for i in range(n):
                W_s[W.lx + i, :] = 2.0 * q[i] * (x[i] - xr[i])
                add(W.q + i * n + i, 2.0 * q[i] * one)
            for a in range(mc):
                W_s[W.lu + a, :] = 2.0 * r[a] * u[a]
                W_s[W.luu + a, :] = 2.0 * r[a] * one

            def visit(carry, row, c, grads, x_dep):
                act = act_of(k, row, c, x_dep)
                w = jnp.where(act > 0.0, mu, zero)
                if x_dep:
                    for (ia, ga) in grads:
                        add(W.lx + ia, -ga * act)
                        for (ib, gb) in grads:
                            add(W.q + ia * n + ib, w * ga * gb)
                else:                       # a u-box row: one control entry
                    (ia, ga), = grads
                    add(W.lu + ia - n, -ga * act)
                    add(W.luu + ia - n, w * ga * ga)
                return carry

            for_rows(k, visit, ())

        def jac(x, u):
            e1, e2, bc, bs = [], [], [], []
            for rb in range(m):
                th, v = x[3 * rb + 2], u[2 * rb]
                c, s = jnp.cos(th), jnp.sin(th)
                e1.append(-dt * v * s)
                e2.append(dt * v * c)
                bc.append(dt * c)
                bs.append(dt * s)
            return e1, e2, bc, bs

        def bwd_stage(k):
            """One Riccati step at stage k: reads (Vx, Vxx) of stage k+1 from
            the scratch rows, writes kff/Kfb of stage k to the workspaces and
            (Vx, Vxx) of stage k back to scratch; returns kff . Qu.

            The dense parts run as loops over a dynamic row index on the
            scratch rows (a robot's three state rows, one gain column, one
            value-function row per trip), so the unrolled code grows with
            n, not with n^2 mc."""
            x = load(X_s, k, n)
            u = load(U_s, k, mc)
            e1, e2, bc, bs = jac(x, u)
            for rb, vals in enumerate(zip(e1, e2, bc, bs)):
                for t, v in enumerate(vals):
                    W_s[W.jac + t * m + rb, :] = v

            def robot_rows(r):
                """Rows 3r..3r+2 of Qxx - lxx = A'VA, rows 2r, 2r+1 of
                Qux = B'VA and of Quu - luu = B'VB."""
                er1, er2, bcr, bsr = (W_s[W.jac + t * m + r, :] for t in range(4))
                v0 = W.v + 3 * n * r          # row bases: state rows 3r..3r+2,
                q0 = W.q + 3 * n * r          # control rows 2r, 2r+1
                u0 = W.qu + 2 * n * r
                uu0 = W.quu + 2 * mc * r
                rows = [[W_s[v0 + p * n + j, :] for j in range(n)]
                        for p in range(3)]
                VA = []
                for row in rows:
                    va = list(row)
                    for c in range(m):
                        va[3 * c + 2] = (row[3 * c + 2] + e1[c] * row[3 * c]
                                         + e2[c] * row[3 * c + 1])
                    VA.append(va)
                qxx = [VA[0], VA[1],
                       [VA[2][j] + er1 * VA[0][j] + er2 * VA[1][j] for j in range(n)]]
                qux = [[bcr * VA[0][j] + bsr * VA[1][j] for j in range(n)],
                       [dt * VA[2][j] for j in range(n)]]
                VB = []
                for row in rows:
                    vb = []
                    for c in range(m):
                        vb += [bc[c] * row[3 * c] + bs[c] * row[3 * c + 1],
                               dt * row[3 * c + 2]]
                    VB.append(vb)
                quu = [[bcr * VB[0][b] + bsr * VB[1][b] for b in range(mc)],
                       [dt * VB[2][b] for b in range(mc)]]
                for p in range(3):
                    for j in range(n):
                        W_s[q0 + p * n + j, :] = qxx[p][j]
                for p in range(2):
                    for j in range(n):
                        W_s[u0 + p * n + j, :] = qux[p][j]
                    for b in range(mc):
                        W_s[uu0 + p * mc + b, :] = quu[p][b]

            _for(m, robot_rows)
            expansion(k, x, u)
            Vx = [W_s[W.vx + i, :] for i in range(n)]
            lx = [W_s[W.lx + i, :] for i in range(n)]
            lu = [W_s[W.lu + a, :] for a in range(mc)]
            for i in range(n):
                v = lx[i] + Vx[i]
                if i % 3 == 2:
                    rb = i // 3
                    v = v + e1[rb] * Vx[3 * rb] + e2[rb] * Vx[3 * rb + 1]
                W_s[W.qx + i, :] = v
            Qu = []
            for rb in range(m):
                Qu.append(lu[2 * rb] + bc[rb] * Vx[3 * rb] + bs[rb] * Vx[3 * rb + 1])
                Qu.append(lu[2 * rb + 1] + dt * Vx[3 * rb + 2])

            # Cholesky of Quu + luu + reg I into the scratch rows W.l (lower
            # L, row-major) and W.linv (reciprocal diagonal), column by
            # column; then L is held in registers for the substitutions
            def quu(i, j):
                return W_s[W.quu + i * mc + j, :]

            def chol_column(j):
                def dot(t, acc):
                    return acc + W_s[W.l + j * mc + t, :] * W_s[W.l + j * mc + t, :]

                d = jnp.sqrt(quu(j, j) + W_s[W.luu + j, :] + cfg.reg
                             - jax.lax.fori_loop(0, j, dot, zero))
                inv_j = 1.0 / d
                W_s[W.l + j * mc + j, :] = d
                W_s[W.linv + j, :] = inv_j

                def below(i):
                    def dot_i(t, acc):
                        return acc + W_s[W.l + i * mc + t, :] * W_s[W.l + j * mc + t, :]

                    W_s[W.l + i * mc + j, :] = (
                        quu(i, j) - jax.lax.fori_loop(0, j, dot_i, zero)) * inv_j

                jax.lax.fori_loop(j + 1, mc, lambda i, c: (below(i), c)[1], ())

            _for(mc, chol_column)
            Lm = {(i, j): W_s[W.l + i * mc + j, :]
                  for i in range(mc) for j in range(i + 1)}
            inv = [W_s[W.linv + j, :] for j in range(mc)]

            def solve(rhs):
                y = []
                for i in range(mc):
                    s = rhs[i]
                    for t in range(i):
                        s = s - Lm[(i, t)] * y[t]
                    y.append(s * inv[i])
                xs = [None] * mc
                for i in reversed(range(mc)):
                    s = y[i]
                    for t in range(i + 1, mc):
                        s = s - Lm[(t, i)] * xs[t]
                    xs[i] = s * inv[i]
                return xs

            kff = [-v for v in solve(Qu)]
            for a in range(mc):
                kff_s[k, a, :] = kff[a]

            def gain_column(j):
                sol = solve([W_s[W.qu + a * n + j, :] for a in range(mc)])
                for a in range(mc):
                    Kfb_s[k, a * n + j, :] = -sol[a]

            _for(n, gain_column)

            def value_row(i):
                qa = [W_s[W.qu + a * n + i, :] for a in range(mc)]
                v = W_s[W.qx + i, :]
                for a in range(mc):
                    v = v + qa[a] * kff[a]
                W_s[W.vx + i, :] = v

                def entry(j):
                    v = W_s[W.q + i * n + j, :]
                    for a in range(mc):
                        v = v + qa[a] * Kfb_s[k, a * n + j, :]
                    W_s[W.v + i * n + j, :] = v

                _for(n, entry)

            _for(n, value_row)
            dv = zero
            for a in range(mc):
                dv = dv + kff[a] * Qu[a]
            return dv

        def feedback(k, x, alpha):
            """u = ubar + alpha kff + Kfb (x - xbar) at stage k, one control
            row per loop trip through the scratch row W.u."""
            xb = load(X_s, k, n)
            dx = [x[i] - xb[i] for i in range(n)]

            def row(a):
                v = U_s[k, a, :] + alpha * kff_s[k, a, :]
                for j in range(n):
                    v = v + Kfb_s[k, a * n + j, :] * dx[j]
                W_s[W.u + a, :] = v

            _for(mc, row)
            return [W_s[W.u + a, :] for a in range(mc)]

        x0 = [x0_ref[i, :] for i in range(n)]

        def cost_of(alpha):
            def roll(k, c):
                x, acc = c
                u = feedback(k, x, alpha)
                return dyn(x, u), acc + merit(k, x, u)

            return jax.lax.fori_loop(0, N, roll, (x0, zero))[1]

        # ---- working copy of U, initial rollout and merit ----
        def init(k, c):
            x, acc = c
            u = load(U_ref, k, mc)
            for a in range(mc):
                U_s[k, a, :] = u[a]
            for i in range(n):
                X_s[k, i, :] = x[i]
            return dyn(x, u), acc + merit(k, x, u)

        cost0 = jax.lax.fori_loop(0, N, init, (x0, zero))[1]

        def iteration(c):
            cost, done, trial, iters = c
            iters = iters + jnp.where(done > 0.5, 0.0, 1.0)

            def clear(i):
                W_s[W.vx + i, :] = zero
                for j in range(n):
                    W_s[W.v + i * n + j, :] = zero

            _for(n, clear)
            dV1 = jax.lax.fori_loop(
                0, N, lambda t, acc: acc + bwd_stage(N - 1 - t), zero)
            decrease = jnp.maximum(-dV1, 0.0)

            if adaptive:
                def ls_round(s):
                    acc, alpha_b, cost_b, trial = s
                    a = jnp.where(acc > 0.5, zero, trial)
                    ca = cost_of(a)
                    ok = ((acc <= 0.5) & ((cost - ca) >= cfg.armijo * a * decrease)
                          & (ca < cost))
                    acc = jnp.where(ok, one, acc)
                    return (acc, jnp.where(ok, a, alpha_b),
                            jnp.where(ok, ca, cost_b),
                            jnp.where(acc > 0.5, trial, trial * cfg.ls_beta))

                s = jax.lax.fori_loop(
                    0, cfg.ls_rounds,
                    lambda _, s: jax.lax.cond(jnp.min(s[0]) > 0.5,
                                              lambda s: s, ls_round, s),
                    (zero, zero, cost, trial))
                _, alpha, cost_b, trial_n = s
                trial_n = jnp.where(alpha > 0.0,
                                    jnp.minimum(1.0, alpha * cfg.ls_grow), trial_n)
                improved = alpha > 0.0
            else:
                # cheapest Armijo-passing candidate; the earlier alpha wins a tie
                def candidate(ai, s):
                    alpha, cost_b, imp = s
                    a_c = prm_ref[L.alphas + ai]
                    ca = cost_of(a_c * one)
                    ok = ((cost - ca) >= cfg.armijo * a_c * decrease) & (ca < cost)
                    better = ok & ((imp <= 0.5) | (ca < cost_b))
                    return (jnp.where(better, a_c, alpha),
                            jnp.where(better, ca, cost_b),
                            jnp.where(ok, one, imp))

                alpha, cost_b, imp = jax.lax.fori_loop(
                    0, len(cfg.alphas), candidate, (zero, cost, zero))
                improved = imp > 0.5
                trial_n = trial

            upd = improved & (done <= 0.5)
            alpha_u = jnp.where(upd, alpha, zero)

            def accept(k, x):
                xs = load(X_s, k, n)
                us = load(U_s, k, mc)
                x = [jnp.where(upd, x[i], xs[i]) for i in range(n)]
                u_fb = feedback(k, x, alpha_u)
                u = [jnp.where(upd, u_fb[a], us[a]) for a in range(mc)]
                for i in range(n):
                    X_s[k, i, :] = x[i]
                for a in range(mc):
                    U_s[k, a, :] = u[a]
                return dyn(x, u)

            jax.lax.fori_loop(0, N, accept, x0)
            cost_n = jnp.where(upd, cost_b, cost)
            rel = (cost - cost_n) / (1.0 + jnp.abs(cost))
            if adaptive:
                stop = (improved & (rel < cfg.tol_cost)) | (
                    ~improved & (trial_n <= cfg.ls_trial_min))
            else:
                stop = ~improved | (rel < cfg.tol_cost)
            done = jnp.where(stop, one, done)
            return cost_n, done, trial_n, iters

        def guarded(_, c):
            return jax.lax.cond(jnp.min(c[1]) > 0.5, lambda c: c, iteration, c)

        c0 = (cost0, done_ref[:], one, zero)
        _, _, _, iters = jax.lax.fori_loop(0, cfg.n_inner, guarded, c0)
        it_ref[:] = iters

    return kernel


def inner_solve(ocp: OCP, cfg, x0, xref, lam, mu, done, U, mov=None,
                interpret: bool = False):
    """One AL outer step's inner iLQR solve for Bp scenarios (Bp a multiple
    of BLOCK_B), scenario-minor layouts (module docstring); done [Bp] is
    1.0 for scenarios that must not move. Returns (U [N, nu, Bp],
    iterations [Bp], X [N, nx, Bp] stage states 0..N-1)."""
    N, n, mc, nc = ocp.N, ocp.nx, ocp.nu, ocp.n_con
    Bp = x0.shape[-1]
    assert Bp % BLOCK_B == 0, Bp
    dtype = x0.dtype
    prm = pack_params(ocp, cfg.alphas).astype(dtype)

    def blk(*lead):
        nd = len(lead)
        return pl.BlockSpec((*lead, BLOCK_B), lambda b, nd=nd: (0,) * nd + (b,))

    ins = [prm, x0, xref, lam, mu, done, U]
    in_specs = [pl.BlockSpec(prm.shape, lambda b: (0,)), blk(n), blk(N, n),
                blk(N, nc), blk(), blk(), blk(N, mc)]
    if ocp.n_mov:
        ins.append(mov)
        in_specs.append(blk(N, 2 * ocp.n_mov))
    U_out, iters, X_s, _, _, _ = pl.pallas_call(
        _make_kernel(ocp, cfg),
        grid=(Bp // BLOCK_B,),
        in_specs=in_specs,
        out_specs=[blk(N, mc), blk(), blk(N, n), blk(N, mc), blk(N, mc * n),
                   blk(_Scratch(ocp).size)],
        out_shape=[
            jax.ShapeDtypeStruct((N, mc, Bp), dtype),       # U (working copy)
            jax.ShapeDtypeStruct((Bp,), dtype),             # iterations
            jax.ShapeDtypeStruct((N, n, Bp), dtype),        # workspace: X
            jax.ShapeDtypeStruct((N, mc, Bp), dtype),       # workspace: kff
            jax.ShapeDtypeStruct((N, mc * n, Bp), dtype),   # workspace: Kfb
            jax.ShapeDtypeStruct((_Scratch(ocp).size, Bp), dtype),  # sweep
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="alilqr_inner_solve",
    )(*ins)
    return U_out, iters, X_s
