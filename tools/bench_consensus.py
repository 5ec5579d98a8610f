"""Bench: robot-parallel JOINT solve (Jacobi-AL consensus) on one chip.

Two questions:
  1. What does a jointly-converged consensus solve cost vs the centralized
     joint solve on the paper headline (m=6 antipodal swap)?
  2. How does the consensus step scale with robot count m, beyond the
     reference's m=10 ceiling? (Robots ride the batch axis of the
     batch-native engine; the joint NLP the reference would need grows as
     3m states x m^2/2 pair
     rows and is already 1,575 constraint rows at m=10 —
     mpc_online_casadi_tb3_ten_multi_centralized_collision_avoidance.py.)

Per-robot subproblem size is constant in m except the m-1 moving-obstacle
rows. Synchronous timing (a value forced to host).

Usage: python tools/bench_consensus.py
"""

import functools
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from nmpc_tpu.parallel.consensus import (  # noqa: E402
    consensus_solve,
    joint_pair_violation,
    robot_template,
)
from nmpc_tpu.scenarios import get  # noqa: E402
from nmpc_tpu.solver.alilqr import ALILQRConfig  # noqa: E402
from nmpc_tpu.solver.alilqr_batched import solve_one  # noqa: E402

CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)


def timeit(f, *args, reps=20):
    r = f(*args)
    _ = float(jax.tree_util.tree_leaves(r)[0].ravel()[0])  # compile + sync
    ts = []
    for _i in range(reps):
        t0 = time.perf_counter()
        r = f(*args)
        _ = float(jax.tree_util.tree_leaves(r)[0].ravel()[0])
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), r


def circle(m, radius):
    ang = np.arange(m) * 2 * np.pi / m
    x0 = np.stack([radius * np.cos(ang), radius * np.sin(ang), ang + np.pi], 1)
    goals = np.stack([-radius * np.cos(ang), -radius * np.sin(ang),
                      ang + np.pi], 1)
    return (jnp.asarray(x0.reshape(-1), jnp.float32),
            jnp.asarray(goals, jnp.float32))


def main():
    print(f"backend={jax.default_backend()}")

    # 1. headline: consensus vs centralized joint solve (m=6, N=35)
    sc = get("six_robot_antipodal")
    ocp = sc.make()
    t_cent, res = timeit(
        jax.jit(functools.partial(solve_one, cfg=CFG)), ocp)
    print(f"centralized solve_one (m=6, N=35): {t_cent * 1e3:.2f} ms "
          f"(viol {float(res.viol):.1e})")
    tpl = robot_template(ocp.N, float(ocp.T), float(np.sqrt(float(ocp.dmin2))), 6)
    goals = ocp.xref[-1].reshape(6, 3)
    for rounds in (3, 5, 8):
        f = jax.jit(functools.partial(
            consensus_solve, cfg=CFG, rounds=rounds, damping=0.5))
        t, out = timeit(f, tpl, ocp.x0, goals)
        X, violh = out[0], out[4]
        jv = float(joint_pair_violation(X[:, :, :2], tpl.dmin2, tpl.N))
        print(f"consensus rounds={rounds}: {t * 1e3:.2f} ms "
              f"(joint viol {jv:.1e}, last-round viol {float(violh[-1]):.1e})")

    # 2. robot-count scaling (N=20, antipodal circle scaled with m so the
    #    crossing stays equally dense)
    print("\nscaling (consensus rounds=5, N=20, T=0.1, dmin=0.3):")
    for m in (6, 12, 24, 48):
        tpl = robot_template(20, 0.1, 0.3, m)
        x0, goals = circle(m, radius=0.16 * m)
        f = jax.jit(functools.partial(
            consensus_solve, cfg=CFG, rounds=5, damping=0.5))
        t, out = timeit(f, tpl, x0, goals, reps=10)
        X = out[0]
        jv = float(joint_pair_violation(X[:, :, :2], tpl.dmin2, tpl.N))
        print(f"  m={m:<3d} {t * 1e3:8.2f} ms/joint solve "
              f"({t * 1e3 / m:6.2f} ms/robot, joint viol {jv:.1e})")


if __name__ == "__main__":
    main()
