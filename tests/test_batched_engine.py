"""The batch-native engine: its XLA route against the per-scenario engine,
per-element independence, the fused Triton inner-solve kernel in interpret
mode against the XLA route, the route rule and the compile-cache placement.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nmpc_tpu.parallel.batch import batch_ocp
from nmpc_tpu.parallel.decentralized import robot_template
from nmpc_tpu.scenarios import get
from nmpc_tpu.solver import alilqr_batched as ab
from nmpc_tpu.solver.alilqr import ALILQRConfig, cold_start, solve

CFG = ALILQRConfig(n_outer=4, n_inner=8, tol_con=1e-3)


def _moving_obstacle_batch(B=3, N=8):
    """Single robots, each with its own schedule of two moving keep-outs
    (the decentralized subproblem), one of them across the straight path."""
    tpl = robot_template(N, 0.1, 0.3, 3)
    x0s = jnp.asarray([-0.5, 0.0, 0.0], jnp.float32) + 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), (B, 3), jnp.float32)
    goals = jnp.tile(jnp.asarray([[0.6, 0.0, 0.0]], jnp.float32), (B, N, 1))
    mov = jnp.tile(jnp.asarray([[0.05, 0.02], [5.0, 5.0]], jnp.float32)[None, None],
                   (B, N, 1, 1))
    mov = mov + 0.01 * jax.random.normal(jax.random.PRNGKey(2), mov.shape)
    return dataclasses.replace(batch_ocp(tpl, x0s, goals), mov_obs=mov)


def _batch(name, N, B=3, spread=0.05, seed=0):
    if name == "moving_obstacles":
        return _moving_obstacle_batch(B)
    base = get(name).make(N=N)
    x0s = base.x0[None] + spread * jax.random.normal(
        jax.random.PRNGKey(seed), (B, base.nx), base.x0.dtype)
    return batch_ocp(base, x0s)


def _per_scenario(ob, cfg):
    mov_b = ob.n_mov and ob.mov_obs.ndim == 4

    def one(x0, xref, mov):
        o = dataclasses.replace(ob, x0=x0, xref=xref,
                                mov_obs=mov if mov_b else ob.mov_obs)
        return solve(o, cfg=cfg)

    mov = ob.mov_obs if mov_b else jnp.zeros((ob.x0.shape[0],))
    return jax.jit(jax.vmap(one))(ob.x0, ob.xref, mov)


@pytest.mark.parametrize("name,N", [
    ("single_robot", 10), ("two_robot_swap", 10), ("six_robot_antipodal", 10),
    ("ten_robot", 20), ("obstacle_scenario_1", 12), ("moving_obstacles", 8),
])
def test_xla_engine_matches_per_scenario_solve(name, N):
    """solve_batched on its XLA route runs the per-scenario engine's
    algorithm (same expansions, sweep, cascade and stopping rules) on
    [B, ...] arrays: costs, controls and iteration counts agree."""
    cfg = ALILQRConfig(n_outer=3, n_inner=6, tol_con=1e-3) if name == "ten_robot" else CFG
    ob = _batch(name, N)
    rb = jax.jit(functools.partial(ab._solve_batched, cfg=cfg, route="xla"))(ob)
    rv = _per_scenario(ob, cfg)
    np.testing.assert_allclose(np.asarray(rb.cost), np.asarray(rv.cost), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(rb.U), np.asarray(rv.U), atol=5e-3)
    np.testing.assert_allclose(np.asarray(rb.viol), np.asarray(rv.viol), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(rb.outer_iters), np.asarray(rv.outer_iters))


@pytest.mark.parametrize("ls", ["cascade", "adaptive"])
def test_element_result_independent_of_batch(ls):
    """An element's result is the same solved alone and inside a batch whose
    other elements need more iterations (converged and finished elements
    are frozen, not re-iterated)."""
    cfg = dataclasses.replace(CFG, ls=ls)
    ob = _batch("two_robot_swap", 10, B=4, spread=0.3, seed=4)
    run = jax.jit(functools.partial(ab._solve_batched, cfg=cfg, route="xla"))
    rb = run(ob)
    for e in range(4):
        r1 = run(dataclasses.replace(ob, x0=ob.x0[e:e + 1], xref=ob.xref[e:e + 1]))
        np.testing.assert_allclose(np.asarray(r1.U[0]), np.asarray(rb.U[e]), atol=1e-5)
        assert int(r1.inner_iters[0]) == int(rb.inner_iters[e])
        assert int(r1.outer_iters[0]) == int(rb.outer_iters[e])


def _one_inner_step(ob, cfg, done=None):
    """Inputs of one AL outer step's inner solve: a cold warm start."""
    B = ob.x0.shape[0]
    w = jax.vmap(lambda _: cold_start(ob, cfg))(jnp.arange(B))
    lam = 0.05 * jax.random.uniform(jax.random.PRNGKey(7), w.lam.shape)
    U = 0.02 * jax.random.normal(jax.random.PRNGKey(8), w.U.shape)
    X = ab._rollout_b(ob, U)
    done = jnp.zeros((B,), bool) if done is None else done
    return X, U, lam, w.mu, done


@pytest.mark.parametrize("name,N,ls", [
    ("two_robot_swap", 8, "cascade"), ("two_robot_swap", 8, "adaptive"),
    ("obstacle_scenario_1", 10, "adaptive"), ("moving_obstacles", 8, "cascade"),
])
def test_triton_inner_solve_matches_xla_interpret(name, N, ls):
    """The fused kernel (interpret mode) runs the same inner iLQR solve as
    the XLA route: the merit it reaches and the controls agree; the
    iteration at which the 1e-7 relative-decrease stop fires is f32 noise
    and may differ by a few."""
    cfg = dataclasses.replace(CFG, ls=ls)
    ob = _batch(name, N)
    X, U, lam, mu, done = _one_inner_step(ob, cfg)
    Xx, Ux, itx = jax.jit(functools.partial(ab._inner_xla, ob, cfg))(X, U, lam, mu, done)
    Xt, Ut, itt = jax.jit(functools.partial(ab._inner_triton, ob, cfg, interpret=True))(
        X, U, lam, mu, done)
    cx = ab._al_cost_b(ob, Xx, Ux, lam, mu)
    ct = ab._al_cost_b(ob, Xt, Ut, lam, mu)
    np.testing.assert_allclose(np.asarray(ct), np.asarray(cx), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(Ut), np.asarray(Ux), atol=5e-3)
    np.testing.assert_allclose(np.asarray(Xt), np.asarray(Xx), atol=5e-3)
    assert np.all(np.abs(np.asarray(itt) - np.asarray(itx)) <= 3)


def test_triton_inner_solve_freezes_done_elements_interpret():
    """Elements marked done enter and leave the kernel unchanged with zero
    iterations; the batch (5) is padded to whole blocks and trimmed back."""
    ob = _batch("two_robot_swap", 8, B=5)
    X, U, lam, mu, _ = _one_inner_step(ob, CFG)
    done = jnp.asarray([True, False, True, False, False])
    Xt, Ut, it = jax.jit(functools.partial(ab._inner_triton, ob, CFG, interpret=True))(
        X, U, lam, mu, done)
    assert Ut.shape == U.shape and Xt.shape == X.shape and it.shape == (5,)
    np.testing.assert_array_equal(np.asarray(Ut)[[0, 2]], np.asarray(U)[[0, 2]])
    np.testing.assert_array_equal(np.asarray(it)[[0, 2]], 0)
    assert int(jnp.min(it[jnp.asarray([1, 3, 4])])) >= 1
    assert not np.allclose(np.asarray(Ut)[1], np.asarray(U)[1])


def test_solve_batched_triton_route_interpret(monkeypatch):
    """The whole AL solve on the kernel route (interpret mode) against the
    XLA route."""
    monkeypatch.setattr(ab, "_inner_triton",
                        functools.partial(ab._inner_triton, interpret=True))
    cfg = dataclasses.replace(CFG, ls="adaptive")
    ob = _batch("two_robot_swap", 8, B=3)
    rt = jax.jit(functools.partial(ab._solve_batched, cfg=cfg, route="triton"))(ob)
    rx = jax.jit(functools.partial(ab._solve_batched, cfg=cfg, route="xla"))(ob)
    np.testing.assert_allclose(np.asarray(rt.cost), np.asarray(rx.cost), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(rt.U), np.asarray(rx.U), atol=5e-3)
    assert bool(jnp.all(rt.converged))


@pytest.mark.parametrize("name,cfg", [
    ("lidar_v4", CFG), ("two_robot_swap", dataclasses.replace(CFG, sweep="scan")),
])
def test_kernel_route_refuses_problems_outside_its_class(name, cfg):
    """Forcing the kernel route onto a problem it does not solve (LiDAR
    rays, the associative-scan sweep) raises instead of solving wrongly."""
    with pytest.raises(ValueError, match="kernel route"):
        ab._solve_batched(get(name).make(N=5), None, cfg, "triton")


@pytest.mark.parametrize("kernel", [False, True])
def test_solve_batched_sharded_matches_unsharded(monkeypatch, kernel):
    """The fleet split over 4 devices by shard_map solves every element as
    the unsharded engine does, on the XLA route and on the kernel route
    (interpret mode), which then runs once per shard."""
    from jax.sharding import Mesh

    from nmpc_tpu.parallel.batch import solve_batched_sharded

    if kernel:
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(ab, "_inner_triton",
                            functools.partial(ab._inner_triton, interpret=True))
    cfg = dataclasses.replace(CFG, ls="adaptive")
    ob = _batch("two_robot_swap", 8, B=8, spread=0.2)
    assert ab.choose_route(ob, cfg) == ("triton" if kernel else "xla")
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    rs = jax.jit(functools.partial(solve_batched_sharded, mesh=mesh, cfg=cfg))(ob)
    ru = jax.jit(functools.partial(ab.solve_batched, cfg=cfg))(ob)
    assert rs.U.sharding.spec[0] == "data"
    np.testing.assert_allclose(np.asarray(rs.U), np.asarray(ru.U), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(rs.inner_iters), np.asarray(ru.inner_iters))
    np.testing.assert_array_equal(np.asarray(rs.converged), np.asarray(ru.converged))


def test_supports_gate():
    assert ab.supports(get("two_robot_swap").make(N=5))
    assert ab.supports(get("obstacle_scenario_1").make(N=5))
    assert ab.supports(robot_template(5, 0.1, 0.3, 3))
    assert not ab.supports(get("lidar_v4").make(N=5))


@pytest.mark.parametrize("backend,name,expect", [
    ("cpu", "two_robot_swap", "xla"),
    ("gpu", "two_robot_swap", "triton"),
    ("gpu", "tb3_2", "triton"),
    ("gpu", "moving_obstacles", "triton"),
    ("gpu", "six_robot_antipodal", "xla"),
    ("gpu", "lidar_v4", "xla"),
])
def test_route_rule(monkeypatch, backend, name, expect):
    """One rule: the kernel for its problem class (at most
    KERNEL_MAX_ROBOTS robots, sequential sweep) on the GPU, XLA otherwise."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    ob = _batch(name, 5) if name == "moving_obstacles" else get(name).make(N=5)
    assert ab.choose_route(ob, CFG) == expect
    scan = dataclasses.replace(CFG, sweep="scan")
    assert ab.choose_route(ob, scan) == "xla"


@pytest.mark.parametrize("env", [None, "/some/other/cache"])
def test_compile_cache_placement(monkeypatch, env):
    """JAX_COMPILATION_CACHE_DIR is honoured as is; without it the cache
    goes to the fixed .jax_cache directory of the checkout."""
    from nmpc_tpu.utils import compile_cache

    old = jax.config.jax_compilation_cache_dir
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    path = compile_cache.setup_compile_cache()
    if env is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
    else:
        assert path == env and calls == []
    assert jax.config.jax_compilation_cache_dir == old


@pytest.mark.gpu
@pytest.mark.parametrize("name,N,ls", [
    ("two_robot_swap", 8, "cascade"), ("tb3_2", 50, "adaptive"),
    ("moving_obstacles", 8, "adaptive"),
])
def test_triton_route_matches_xla_on_gpu(gpu, name, N, ls):
    """The compiled kernel on the card against the XLA route on the card."""
    cfg = dataclasses.replace(CFG, ls=ls)
    ob = _batch(name, N, B=64)
    rt = jax.jit(functools.partial(ab._solve_batched, cfg=cfg, route="triton"))(ob)
    rx = jax.jit(functools.partial(ab._solve_batched, cfg=cfg, route="xla"))(ob)
    err = np.max(np.abs(np.asarray(rt.U) - np.asarray(rx.U)).reshape(64, -1), axis=1)
    assert np.mean(err <= 5e-3) >= 0.95
    assert abs(float(jnp.mean(rt.converged)) - float(jnp.mean(rx.converged))) <= 0.05
