"""Batch-native solver equivalence with the per-scenario engine."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from nmpc_tpu.parallel.batch import batch_ocp
from nmpc_tpu.scenarios import get
from nmpc_tpu.solver.alilqr import ALILQRConfig, solve
from nmpc_tpu.solver.alilqr_batched import solve_batched

CFG = ALILQRConfig(n_outer=8, n_inner=15, tol_con=1e-4)


def test_batch_native_matches_vmap():
    base = get("two_robot_swap").make(N=10)
    B = 4
    x0s = base.x0[None] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(0), (B, base.nx), base.x0.dtype
    )
    ob = batch_ocp(base, x0s)
    rb = jax.jit(functools.partial(solve_batched, cfg=CFG))(ob)
    rv = jax.jit(
        jax.vmap(lambda x0: solve(dataclasses.replace(base, x0=x0), cfg=CFG))
    )(x0s)
    # costs agree tightly; controls to trajectory tolerance (batched and
    # per-scenario programs may sum the merit in a different order, which
    # can flip near-tied alpha picks along the way)
    np.testing.assert_allclose(np.array(rb.cost), np.array(rv.cost), rtol=1e-4)
    np.testing.assert_allclose(np.array(rb.U), np.array(rv.U), atol=5e-3)
    assert bool(jnp.all(rb.converged))


def test_batch_padding_to_lane_tile():
    # an odd batch size solves and keeps its shape (no tile padding)
    base = get("single_robot").make(N=10)
    x0s = jnp.stack([base.x0, base.x0 + 0.1, base.x0 - 0.1])
    ob = batch_ocp(base, x0s)
    r = jax.jit(functools.partial(solve_batched, cfg=CFG))(ob)
    assert r.U.shape == (3, 10, 2)
    assert float(jnp.max(r.viol)) < 1e-3


def test_batched_moving_obstacles_fused_path():
    """Per-element moving-obstacle rows (the decentralized subproblems):
    batched results must match the per-scenario engine on a problem where
    the keep-out disc is ACTIVE (obstacle parked between start and goal)."""
    from nmpc_tpu.solver.alilqr_batched import supports
    from nmpc_tpu.parallel.decentralized import robot_template

    tpl = robot_template(8, 0.1, 0.3, 3)  # n_mov = 2 slots
    assert supports(tpl)
    B = 3
    x0s = jnp.asarray([[-0.5, 0, 0], [-0.4, 0.2, 0], [-0.6, -0.2, 0]], jnp.float32)
    goals = jnp.tile(jnp.asarray([[0.6, 0.0, 0.0]], jnp.float32), (B, 1))
    # one obstacle blocking the straight line, one far away; per-element path
    mov = jnp.tile(
        jnp.asarray([[0.05, 0.02], [5.0, 5.0]], jnp.float32)[None, None],
        (B, 8, 1, 1),
    )
    mov = mov + 0.01 * jax.random.normal(jax.random.PRNGKey(2), mov.shape)
    ob = dataclasses.replace(
        batch_ocp(tpl, x0s, jnp.tile(goals[:, None, :], (1, 8, 1))),
        mov_obs=mov,
    )
    rb = jax.jit(functools.partial(solve_batched, cfg=CFG))(ob)
    assert rb.U.shape == (B, 8, 2)
    rv = jax.jit(jax.vmap(
        lambda x0, xref, mv: solve(
            dataclasses.replace(tpl, x0=x0, xref=xref, mov_obs=mv), cfg=CFG
        )
    ))(ob.x0, ob.xref, mov)
    np.testing.assert_allclose(np.array(rb.cost), np.array(rv.cost), rtol=5e-4)
    np.testing.assert_allclose(np.array(rb.U), np.array(rv.U), atol=1e-2)
    assert float(jnp.max(rb.viol)) < 1e-3
    # the disc actually shaped the solution: realized clearance respects the
    # keep-out radius at stages 1..N-1 even though the straight start->goal
    # line passes within 0.05 of the disc center (dmin = 0.3)
    d = jnp.sqrt(jnp.sum((rb.X[:, 1:-1, :2] - mov[:, 1:, 0, :]) ** 2, -1))
    assert float(jnp.min(d)) > 0.3 - 1e-2


def test_solve_one_matches_per_scenario_solve():
    """solve_one (the batched engine at B=1) matches the per-scenario engine
    on the two-robot collision config — the low-latency MPC engine must be a
    drop-in for solver.alilqr.solve."""
    from nmpc_tpu.solver.alilqr_batched import solve_one

    ocp = get("two_robot_swap").make(N=12)
    r1 = jax.jit(functools.partial(solve_one, cfg=CFG))(ocp)
    rv = jax.jit(functools.partial(solve, cfg=CFG))(ocp)
    assert r1.U.shape == rv.U.shape == (12, 4)
    np.testing.assert_allclose(np.array(r1.cost), np.array(rv.cost), rtol=1e-4)
    np.testing.assert_allclose(np.array(r1.U), np.array(rv.U), atol=5e-3)
    assert bool(r1.converged)


def test_solve_one_warm_start_roundtrip():
    """shift_warm on a solve_one result feeds back in (driver contract)."""
    from nmpc_tpu.mpc.driver import shift_warm
    from nmpc_tpu.solver.alilqr_batched import solve_one

    ocp = get("single_robot").make(N=10)
    res = jax.jit(functools.partial(solve_one, cfg=CFG))(ocp)
    warm = shift_warm(res, CFG, mu_reset=True)
    res2 = jax.jit(functools.partial(solve_one, cfg=CFG))(ocp, warm)
    assert res2.U.shape == (10, 2)
    assert float(res2.viol) < 1e-3


def test_per_element_iteration_counts():
    """Batched solvers report per-element solver effort (SURVEY.md §5.5
    observability): an element warm-started at its own solution must record
    strictly fewer inner iterations than a cold element in the same batch."""
    from nmpc_tpu.solver.alilqr import WarmStart, cold_start

    base = get("two_robot_swap").make(N=10)
    B = 3
    x0s = base.x0[None] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(1), (B, base.nx), base.x0.dtype
    )
    ob = batch_ocp(base, x0s)
    r1 = jax.jit(functools.partial(solve_batched, cfg=CFG))(ob)
    assert r1.inner_iters.shape == (B,) and r1.outer_iters.shape == (B,)
    assert int(jnp.min(r1.inner_iters)) >= 1

    # warm-start element 0 at its own solution, leave 1..2 cold
    cold = cold_start(base, CFG)
    warm = WarmStart(
        U=jnp.stack([r1.U[0], cold.U, cold.U]),
        lam=jnp.stack([r1.lam[0], cold.lam, cold.lam]),
        mu=jnp.stack([r1.mu[0], cold.mu, cold.mu]),
    )
    r2 = jax.jit(functools.partial(solve_batched, cfg=CFG))(ob, warm)
    assert int(r2.inner_iters[0]) < int(r2.inner_iters[1])
    assert int(r2.inner_iters[0]) < int(r2.inner_iters[2])


def test_batched_scan_sweep_matches_seq():
    """sweep='scan' (the O(log N) associative-scan backward pass) matches
    the sequential sweep; sweep='auto' resolves to seq at every reference
    shape (SCAN_N_MIN)."""
    from nmpc_tpu.solver.alilqr import resolve_sweep

    base = get("two_robot_swap").make(N=12)
    x0s = base.x0[None] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(0), (3, base.nx), base.x0.dtype
    )
    ob = batch_ocp(base, x0s)
    rs = jax.jit(functools.partial(
        solve_batched, cfg=dataclasses.replace(CFG, sweep="scan")))(ob)
    rq = jax.jit(functools.partial(solve_batched, cfg=CFG))(ob)
    np.testing.assert_allclose(np.array(rs.cost), np.array(rq.cost), rtol=1e-4)
    np.testing.assert_allclose(np.array(rs.U), np.array(rq.U), atol=5e-3)
    assert resolve_sweep(dataclasses.replace(CFG, sweep="auto"), 200) == "seq"
    assert resolve_sweep(dataclasses.replace(CFG, sweep="scan"), 10) == "scan"


def test_adaptive_line_search_matches_or_beats_cascade():
    """ls='adaptive' (carried per-element trial step, fail-continue) must hold
    the cascade's solution quality on the bench problem class: convergence
    rate and violation statistics at least as good, mean cost within f32
    tolerance. Typical adaptive iterations pay ls_rounds=2 merit evaluations
    instead of the cascade's 8."""
    base = get("six_robot_antipodal").make(N=10)
    B = 128
    x0s = base.x0[None] + 0.1 * jax.random.normal(
        jax.random.PRNGKey(0), (B, base.nx), base.x0.dtype
    )
    ob = batch_ocp(base, x0s)
    cfg_c = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3)
    cfg_a = dataclasses.replace(cfg_c, ls="adaptive")
    rc = jax.jit(functools.partial(solve_batched, cfg=cfg_c))(ob)
    ra = jax.jit(functools.partial(solve_batched, cfg=cfg_a))(ob)
    assert float(ra.converged.mean()) >= float(rc.converged.mean()) - 1e-6
    assert float(ra.viol.max()) <= float(rc.viol.max()) + 1e-6
    assert float(ra.cost.mean()) <= float(rc.cost.mean()) * 1.001


def test_deep_alpha_grid_escapes_box_stall():
    """Regression for the round-2 parity outlier: on two_robot_swap the
    solver stalled at a NON-stationary point (cost 4044.4, merit-gradient
    norm ~2e2) because stiff AL u-box rows at mu_max=1e4 need line-search
    steps below the old 1e-3 alpha floor. With alphas extended to 1e-5 the
    engine reaches the f64 SLSQP/trust-constr optimum basin (4026.0).
    Reference NLP: mpc_online_casadi_tb3_two_centralized_collision_free.py
    :80-84 (T=0.02, N=100, dmin=0.25)."""
    deep = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.001,
            3e-4, 1e-4, 3e-5, 1e-5)
    ocp = get("two_robot_swap").make()
    tight = dict(tol_cost=1e-9, n_inner=60, n_outer=20, tol_con=1e-5)
    r_old = jax.jit(functools.partial(
        solve, cfg=ALILQRConfig(**tight)))(ocp)
    r_deep = jax.jit(functools.partial(
        solve, cfg=ALILQRConfig(alphas=deep, **tight)))(ocp)
    assert float(r_deep.cost) < 4027.0  # f64 oracle optimum 4025.99
    assert float(r_deep.cost) < float(r_old.cost) - 10.0
    assert float(r_deep.viol) < 1e-4
    assert bool(r_deep.converged)
