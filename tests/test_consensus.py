"""Robot-sharded joint solve by Jacobi-AL consensus (SURVEY.md §2.4
"model/robot parallel"): the consensus fixed point must reproduce the
centralized joint NLP's solution quality, and the shard_map form must
match the single-program form exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nmpc_tpu.ocp.problem import make_ocp
from nmpc_tpu.parallel.consensus import (
    consensus_solve,
    consensus_solve_sharded,
    joint_pair_violation,
    robot_template,
)
from nmpc_tpu.parallel.mesh import data_mesh
from nmpc_tpu.scenarios import get
from nmpc_tpu.solver.alilqr import ALILQRConfig, solve

CFG = ALILQRConfig(n_outer=8, n_inner=15, tol_con=1e-4)


def _joint_quad_cost(Xj, Uj, goal_j, Qd, Rd):
    """The reference objective sum_k (x_k-g)'Q(x_k-g) + u_k'Ru_k over stages
    0..N-1 (six-robot file :182-196,244) — one formula applied to BOTH
    solvers so convention details cancel in the comparison."""
    e = Xj[:-1] - goal_j[None]
    return float(jnp.sum(e * e * Qd[None]) + jnp.sum(Uj * Uj * Rd[None]))


def _stack_joint(X, U):
    """[m, N+1, 3], [m, N, 2] -> joint [N+1, 3m], [N, 2m]."""
    Xj = jnp.swapaxes(X, 0, 1).reshape(X.shape[1], -1)
    Uj = jnp.swapaxes(U, 0, 1).reshape(U.shape[1], -1)
    return Xj, Uj


def test_consensus_matches_centralized_two_robot():
    # offset head-on swap (the offset picks one passing basin so both
    # solvers land in it and the costs are directly comparable)
    N, T, dmin = 30, 0.1, 0.3
    x0 = jnp.array([-0.7, 0.05, 0.0, 0.7, -0.05, np.pi], jnp.float32)
    goals = jnp.array([[0.7, 0.05, 0.0], [-0.7, -0.05, np.pi]], jnp.float32)
    goal_j = goals.reshape(-1)

    central = make_ocp(m=2, N=N, T=T, x0=x0, x_goal=goal_j, dmin=dmin,
                       collision=True)
    res_c = jax.jit(functools.partial(solve, cfg=CFG))(central)
    assert float(res_c.viol) < 1e-3

    tpl = robot_template(N, T, dmin, m=2)
    X, U, _, _, violh, deltah = jax.jit(functools.partial(
        consensus_solve, cfg=CFG, rounds=12, damping=0.5, engine="xla"
    ))(tpl, x0, goals)

    # joint feasibility of the consensus iterate at the pair rows
    assert float(violh[-1]) < 1e-3
    # the Jacobi iteration has settled (plans stopped moving)
    assert float(deltah[-1]) < 2e-2
    # joint objective within a small factor of the centralized optimum
    Xj, Uj = _stack_joint(X, U)
    c_cons = _joint_quad_cost(Xj, Uj, goal_j, central.Qdiag, central.Rdiag)
    c_cent = _joint_quad_cost(res_c.X, res_c.U, goal_j, central.Qdiag, central.Rdiag)
    assert c_cons <= 1.15 * c_cent + 1e-6, (c_cons, c_cent)


def test_consensus_sharded_matches_single_program():
    # 8 robots, one per virtual device: the shard_map form (all_gather plan
    # exchange + pmax reduction) must reproduce the single-program result —
    # same algorithm, different communication path.
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    m, N, T, dmin = 8, 12, 0.1, 0.25
    ang = jnp.arange(m) * (2 * np.pi / m)
    x0 = jnp.stack([jnp.cos(ang), jnp.sin(ang), ang + np.pi], axis=1)
    goals = jnp.stack([-jnp.cos(ang), -jnp.sin(ang), ang + np.pi], axis=1)
    x_joint = x0.reshape(-1).astype(jnp.float32)
    goals = goals.astype(jnp.float32)

    cfg = ALILQRConfig(n_outer=4, n_inner=8, tol_con=1e-3)
    tpl = robot_template(N, T, dmin, m=m)
    X1, U1, _, _, v1, d1 = jax.jit(functools.partial(
        consensus_solve, cfg=cfg, rounds=3, damping=0.5, engine="xla",
        rh_bias=0.05))(tpl, x_joint, goals)

    mesh = data_mesh(8, axis="robots")
    run = consensus_solve_sharded(mesh, tpl, cfg=cfg, rounds=3, damping=0.5,
                                  rh_bias=0.05, engine="xla")
    X2, U2, _, _, v2, d2 = run(x_joint.reshape(m, 3), goals)

    np.testing.assert_allclose(np.array(U2), np.array(U1), atol=1e-4)
    np.testing.assert_allclose(np.array(X2), np.array(X1), atol=1e-4)
    np.testing.assert_allclose(np.array(v2), np.array(v1), atol=1e-5)
    np.testing.assert_allclose(np.array(d2), np.array(d1), atol=1e-5)

    # batch-native engines both sides (the production pairing): each device
    # solves its whole shard as one batch; must match the batched
    # single-program form the same way the XLA pair matches
    Xf, Uf, _, _, vf, df = jax.jit(functools.partial(
        consensus_solve, cfg=cfg, rounds=3, damping=0.5, engine="fused",
        rh_bias=0.05))(tpl, x_joint, goals)
    runf = consensus_solve_sharded(mesh, tpl, cfg=cfg, rounds=3, damping=0.5,
                                   rh_bias=0.05, engine="fused")
    X3, U3, _, _, v3, d3 = runf(x_joint.reshape(m, 3), goals)
    np.testing.assert_allclose(np.array(U3), np.array(Uf), atol=1e-4)
    np.testing.assert_allclose(np.array(X3), np.array(Xf), atol=1e-4)


@pytest.mark.slow
def test_consensus_six_robot_antipodal_joint_quality():
    # the paper headline, solved robot-parallel: joint-feasible and
    # cost-competitive with the centralized joint solve
    sc = get("six_robot_antipodal")
    central = sc.make(N=20)
    m, N = 6, 20
    goal_j = central.xref[-1]
    goals = goal_j.reshape(m, 3)

    res_c = jax.jit(functools.partial(solve, cfg=CFG))(central)
    assert float(res_c.viol) < 1e-3

    dmin = float(jnp.sqrt(central.dmin2))
    tpl = robot_template(N, float(central.T), dmin, m=m)
    X, U, _, _, violh, _ = jax.jit(functools.partial(
        consensus_solve, cfg=CFG, rounds=10, damping=0.5, engine="xla"))(
        tpl, central.x0, goals)

    assert float(violh[-1]) < 1e-3
    assert float(joint_pair_violation(X[:, :, :2], central.dmin2, N)) < 1e-3
    Xj, Uj = _stack_joint(X, U)
    c_cons = _joint_quad_cost(Xj, Uj, goal_j, central.Qdiag, central.Rdiag)
    c_cent = _joint_quad_cost(res_c.X, res_c.U, goal_j, central.Qdiag, central.Rdiag)
    assert c_cons <= 1.3 * c_cent + 1e-6, (c_cons, c_cent)


def test_consensus_closed_loop_two_robot_symmetric():
    # exactly symmetric head-on swap, solved JOINTLY each period: reaches
    # and holds the realized clearance at the centralized driver's level
    from nmpc_tpu.parallel.consensus import consensus_closed_loop

    x0 = jnp.array([-0.7, 0.0, 0, 0.7, 0.0, np.pi], jnp.float32)
    goals = jnp.array([[0.7, 0, 0], [-0.7, 0, np.pi]], jnp.float32)
    X, U, mind, done = jax.jit(functools.partial(
        consensus_closed_loop, N=30, T=0.1, dmin=0.3, rounds=3,
        max_steps=200, engine="xla",
        cfg=ALILQRConfig(n_outer=4, n_inner=10, tol_con=1e-4),
    ))(x0, goals)
    assert bool(done)
    assert float(mind.min()) >= 0.3 - 1.5e-2


@pytest.mark.slow
def test_consensus_closed_loop_six_robot_antipodal():
    # the paper headline in robot-parallel joint mode
    from nmpc_tpu.parallel.consensus import consensus_closed_loop

    sc = get("six_robot_antipodal")
    central = sc.make(N=20)
    goals = central.xref[-1].reshape(6, 3)
    dmin = float(np.sqrt(float(central.dmin2)))
    X, U, mind, done = jax.jit(functools.partial(
        consensus_closed_loop, N=20, T=float(central.T), dmin=dmin,
        rounds=3, max_steps=150, engine="xla",
        cfg=ALILQRConfig(n_outer=4, n_inner=10, tol_con=1e-4),
    ))(central.x0, goals)
    assert bool(done)
    assert float(mind.min()) >= dmin - 1.5e-2


@pytest.mark.slow
def test_consensus_closed_loop_ten_robot():
    # the reference's largest joint NLP (two-row line crossing,
    # ...ten...collision_avoidance.py:389-411) in robot-parallel joint mode
    from nmpc_tpu.parallel.consensus import consensus_closed_loop

    sc = get("ten_robot")
    central = sc.make()
    goals = central.xref[-1].reshape(10, 3)
    X, U, mind, done = jax.jit(functools.partial(
        consensus_closed_loop, N=20, T=float(central.T), dmin=sc.dmin,
        rounds=3, max_steps=250, engine="xla",
        cfg=ALILQRConfig(n_outer=4, n_inner=10, tol_con=1e-4),
    ))(central.x0, goals)
    assert bool(done)
    assert float(mind.min()) >= sc.dmin - 1.5e-2


def test_consensus_fused_engine_matches_xla():
    # the deployment default (engine='fused': robots on the batch axis,
    # neighbor plans as per-element mov_obs inputs) must track the
    # vmapped per-scenario path through the same consensus rounds
    m, N, T, dmin = 3, 10, 0.1, 0.3
    ang = jnp.arange(m) * (2 * np.pi / m)
    x0 = jnp.stack([jnp.cos(ang), jnp.sin(ang), ang + np.pi], axis=1)
    goals = jnp.stack([-jnp.cos(ang), -jnp.sin(ang), ang + np.pi], axis=1)
    x_joint = x0.reshape(-1).astype(jnp.float32)
    goals = goals.astype(jnp.float32)
    cfg = ALILQRConfig(n_outer=3, n_inner=6, tol_con=1e-3)
    tpl = robot_template(N, T, dmin, m=m)
    outs = {}
    for eng in ("xla", "fused"):
        X, U, _, _, violh, _ = jax.jit(functools.partial(
            consensus_solve, cfg=cfg, rounds=3, damping=0.5, engine=eng))(
            tpl, x_joint, goals)
        outs[eng] = (np.array(X), np.array(U), np.array(violh))
    # engine-level tolerance (batched vs per-scenario engine) compounds over the
    # 3 rounds; observed max deltas: X ~1e-3, U ~5e-3
    np.testing.assert_allclose(outs["fused"][0], outs["xla"][0], atol=5e-3)
    np.testing.assert_allclose(outs["fused"][1], outs["xla"][1], atol=1e-2)
