"""Structured-linear-algebra ops: associative-scan LQR against the
sequential recursion."""

import jax.numpy as jnp
import numpy as np

from nmpc_tpu.ops.assoc_lqr import parallel_lqr_gains, sequential_lqr_gains


def _rand_lqr(key, N, n, m, dtype=jnp.float32):
    rng = np.random.default_rng(key)
    A = jnp.asarray(rng.normal(size=(N, n, n)) * 0.3 + np.eye(n), dtype)
    B = jnp.asarray(rng.normal(size=(N, n, m)) * 0.3, dtype)
    c = jnp.asarray(rng.normal(size=(N, n)) * 0.1, dtype)
    M = rng.normal(size=(N, n, n))
    Qxx = jnp.asarray(np.einsum("bij,bkj->bik", M, M) + 0.5 * np.eye(n), dtype)
    M = rng.normal(size=(N, m, m))
    Quu = jnp.asarray(np.einsum("bij,bkj->bik", M, M) + 0.5 * np.eye(m), dtype)
    qx = jnp.asarray(rng.normal(size=(N, n)), dtype)
    qu = jnp.asarray(rng.normal(size=(N, m)), dtype)
    Qux = jnp.asarray(rng.normal(size=(N, m, n)) * 0.2, dtype)
    return A, B, c, Qxx, qx, Quu, qu, Qux


def test_parallel_lqr_matches_sequential():
    A, B, c, Qxx, qx, Quu, qu, Qux = _rand_lqr(0, 32, 6, 3)
    rng = np.random.default_rng(1)
    M = rng.normal(size=(6, 6))
    QxxN = jnp.asarray(M @ M.T + 0.5 * np.eye(6), jnp.float32)
    qxN = jnp.asarray(rng.normal(size=(6,)), jnp.float32)
    k1, K1 = sequential_lqr_gains(A, B, c, Qxx, qx, Quu, qu, Qux, QxxN, qxN)
    k2, K2, S, v = parallel_lqr_gains(A, B, c, Qxx, qx, Quu, qu, Qux, QxxN, qxN)
    np.testing.assert_allclose(K1, K2, atol=2e-3)
    np.testing.assert_allclose(k1, k2, atol=2e-3)


def test_parallel_lqr_no_terminal():
    # the reference OCP form: zero terminal cost
    A, B, c, Qxx, qx, Quu, qu, Qux = _rand_lqr(2, 16, 4, 2)
    k1, K1 = sequential_lqr_gains(A, B, c, Qxx, qx, Quu, qu, Qux)
    k2, K2, _, _ = parallel_lqr_gains(A, B, c, Qxx, qx, Quu, qu, Qux)
    np.testing.assert_allclose(K1, K2, atol=2e-3)
    np.testing.assert_allclose(k1, k2, atol=2e-3)
