"""Bench: decentralized NMPC rounds/s, batch-native engine vs vmapped
per-scenario engine.

One decentralized round = all m robots' 3-state subproblems solved against
the exchanged neighbor plans (SURVEY.md §2.4). engine='fused' solves them
as one batch of solver.alilqr_batched; engine='xla' vmaps the per-scenario
solver. Timing is synchronous per call (a value forced to host).

Usage: python tools/bench_decentralized.py [m] [N] [iters]
"""

import functools
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from nmpc_tpu.parallel.decentralized import (  # noqa: E402
    decentralized_step,
    robot_template,
)
from nmpc_tpu.solver.alilqr import ALILQRConfig, cold_start  # noqa: E402


def main():
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    N = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)
    tpl = robot_template(N, 0.1, 0.3, m)
    ang = np.arange(m) * 2 * np.pi / m
    x0 = jnp.asarray(
        np.stack([np.cos(ang), np.sin(ang), ang + np.pi], -1).reshape(-1), jnp.float32
    )
    goals = jnp.asarray(
        np.stack([-np.cos(ang), -np.sin(ang), ang + np.pi], -1), jnp.float32
    )
    plans = jnp.tile(x0.reshape(m, 3)[:, None, :2], (1, N + 1, 1))
    w = jax.vmap(lambda _: cold_start(tpl))(jnp.arange(m))

    print(f"m={m} N={N} backend={jax.default_backend()}")
    K = 50  # rounds per jitted scan: amortizes the per-call dispatch
            # floor out of the measurement — deployment runs the whole loop
            # on device anyway

    for engine in ("fused", "xla"):
        def k_rounds(x0_k, plans_k, warms_k):
            def body(c, _):
                x, plans, warms = c
                res, u, plans_new = decentralized_step(
                    tpl, x, goals, plans, warms, cfg, engine=engine)
                from nmpc_tpu.solver.alilqr import WarmStart
                U_sh = jnp.concatenate([res.U[:, 1:], res.U[:, -1:]], axis=1)
                lam_sh = jnp.concatenate([res.lam[:, 1:], res.lam[:, -1:]], axis=1)
                warms = WarmStart(U=U_sh, lam=lam_sh,
                                  mu=jnp.full_like(res.mu, cfg.mu_init))
                plans_sh = jnp.concatenate(
                    [plans_new[:, 1:], plans_new[:, -1:]], axis=1)
                return (x, plans_sh, warms), u[0]
            (xF, pF, wF), us = jax.lax.scan(
                body, (x0_k, plans_k, warms_k), None, length=K)
            return us

        step = jax.jit(k_rounds)
        us = step(x0, plans, w)
        _ = float(us[0])  # compile + force completion
        times = []
        for i in range(iters):
            x0_i = x0 + 1e-4 * i  # fresh inputs: defeat result caching
            x0_i.block_until_ready()
            t0 = time.perf_counter()
            us = step(x0_i, plans, w)
            _ = float(us[-1])
            times.append(time.perf_counter() - t0)
        t = min(times) / K
        print(f"{engine:6s}: {t*1e3:8.2f} ms/round  ({1.0/t:8.1f} rounds/s)"
              f"  [{K} rounds/scan]")


if __name__ == "__main__":
    main()
