"""Reproduce + diagnose the rt-mode dual drift (a known gap):
warm-started reduced-iteration AL solves lose feasibility on tight-collision
configs. Runs on CPU. Usage: python tools/rt_drift_experiment.py
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses
import functools

import jax
import jax.numpy as jnp

from nmpc_tpu.scenarios import get
from nmpc_tpu.solver.alilqr import ALILQRConfig, WarmStart, solve

CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)


def run(name, rt_cfg, steps=30, label="", mu_carry=False, lam_decay=1.0,
        mu_rt=None):
    ocp = get(name).make()
    f_full = jax.jit(functools.partial(solve, cfg=CFG))
    res = f_full(ocp)
    f = jax.jit(functools.partial(solve, cfg=rt_cfg))

    def mk_warm(res, prev_mu):
        if mu_carry:
            mu = res.mu
        elif mu_rt is not None:
            mu = jnp.asarray(mu_rt, ocp.x0.dtype)
        else:
            mu = jnp.asarray(rt_cfg.mu_init, ocp.x0.dtype)
        return WarmStart(U=res.U, lam=lam_decay * res.lam, mu=mu)

    warm = mk_warm(res, None)
    key = jax.random.PRNGKey(0)
    worst = 0.0
    print(f"== {name} [{label}]: full viol={float(res.viol):.2e} "
          f"cost={float(res.cost):.3f} maxlam={float(res.lam.max()):.1f} "
          f"mu_final={float(res.mu):.0f}")
    for i in range(steps):
        key, sub = jax.random.split(key)
        x0 = ocp.x0 + 0.01 * jax.random.normal(sub, ocp.x0.shape, ocp.x0.dtype)
        res = f(dataclasses.replace(ocp, x0=x0), warm)
        warm = mk_warm(res, warm.mu)
        worst = max(worst, float(res.viol))
        if i % 10 == 0 or i == steps - 1:
            print(f"  step {i:2d}: viol={float(res.viol):.2e} "
                  f"cost={float(res.cost):.3f} maxlam={float(res.lam.max()):.1f}")
    print(f"  WORST viol over run: {worst:.2e}")


if __name__ == "__main__":
    rt = ALILQRConfig(n_outer=2, n_inner=5, tol_con=1e-3)
    variants = [
        dict(label="mu-carry", mu_carry=True),
        dict(label="mu-carry+decay0.9", mu_carry=True, lam_decay=0.9),
        dict(label="mu-rt-1e3", mu_rt=1e3),
    ]
    for nm in ("two_robot_swap", "six_robot_antipodal"):
        for v in variants:
            run(nm, rt, **v)
