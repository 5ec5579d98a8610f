"""Roofline / phase accounting for the family-I condensed-GN fleet engine.

Accounts for where gn.solve_batched's time goes on the published family-I
config
(/root/reference/AllScripts/obs_avoid_static_first_scenario_v4.py:59-75:
N=100, Nc=50, nx=13 = 3 pose + 10 rays, 1/d cost, move blocking):

  1. analytic FLOP model of one GN iteration (forward-sensitivity scan
     building H = J'J, g = J'r; dense Cholesky; 7-alpha line search);
  2. measured end-to-end throughput + executed-iteration statistics;
  3. measured per-phase wall time (normal equations / Cholesky+solve /
     line-search merit) at the bench shape, each as its own jitted call;
  4. achieved TFLOP/s, beside a measured batched-GEMM rate at exactly the
     H-build shapes on the same device.

Writes nothing; prints the table. Synchronous timing (value forced to
host). Run it on the accelerator: python tools/roofline_gn.py [B]
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import time

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nmpc_tpu.mpc.lidar import obstacle_points, ray_angles  # noqa: E402
from nmpc_tpu.ocp import problem as P  # noqa: E402
from nmpc_tpu.scenarios import get  # noqa: E402
from nmpc_tpu.solver import gn  # noqa: E402


def _time(fn, *args, reps=5):
    out = fn(*args)
    jax.tree.map(lambda a: a.block_until_ready(), out)
    # force one value to host (synchronous timing)
    _ = float(jnp.asarray(jax.tree.leaves(out)[0]).reshape(-1)[0])
    ts = []
    for _i in range(reps):
        t0 = time.time()
        out = fn(*args)
        _ = float(jnp.asarray(jax.tree.leaves(out)[0]).reshape(-1)[0])
        ts.append(time.time() - t0)
    return min(ts), out


def build_fleet(B):
    sc = get("lidar_v4")
    base = sc.make()
    R = sc.num_rays
    angles = ray_angles(R, jnp.float32)
    scan = np.full((R,), 3.5, np.float32)
    scan[1] = 0.9
    scan[2] = 1.1
    p_obs = obstacle_points(base.x0[:3], jnp.asarray(scan), angles)
    base = dataclasses.replace(base, p_obs=p_obs,
                               x0=base.x0.at[3:].set(jnp.asarray(scan)))
    cfg = gn.GNConfig(Nc=sc.Nc, n_gn=10, n_outer=4, tol_con=1e-3)
    key = jax.random.PRNGKey(0)
    noise = 0.05 * jax.random.normal(key, (B, 3), jnp.float32)
    x0s = jnp.concatenate(
        [base.x0[None, :3] + noise,
         jnp.broadcast_to(base.x0[None, 3:], (B, R))], axis=1)
    ob = dataclasses.replace(
        base, x0=x0s,
        xref=jnp.broadcast_to(base.xref[None], (B, *base.xref.shape)))
    return base, ob, cfg, sc


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    base, ob, cfg, sc = build_fleet(B)
    N, nx, nu, Nc = base.N, base.nx, base.nu, sc.Nc
    nz = Nc * nu
    mask = P.constraint_mask(base)
    n_con = mask.shape[1]
    rows = nx + nu + sc.num_rays + n_con
    print(f"lidar_v4 B={B}: N={N} Nc={Nc} nx={nx} nu={nu} nz={nz} "
          f"rows/stage={rows} backend={jax.default_backend()}")

    # ---- end-to-end ----
    f = jax.jit(functools.partial(gn.solve_batched, cfg=cfg))
    dt_e2e, r = _time(lambda o: f(o).cost, ob, reps=3)
    res = f(ob)
    ii = np.array(res.inner_iters)
    print(f"end-to-end: {dt_e2e:.3f} s/batch -> {B / dt_e2e:.1f} solves/s | "
          f"inner iters mean {ii.mean():.1f} max {ii.max()}")

    # vmapped while_loops execute the straggler count per batch: model the
    # executed work with the max iteration count
    it_exec = float(ii.max())
    it_useful = float(ii.mean())

    # ---- FLOP model (per element, per GN iteration) ----
    fl_J = 2 * rows * nz * (nx + nu) * N        # Jk = drx@S + dru@E
    fl_H = 2 * rows * nz * nz * N               # H += Jk' Jk  (dominant)
    fl_g = 2 * rows * nz * N
    fl_S = (2 * nx * nx * nz + 2 * nx * nu * nz) * N
    fl_chol = nz**3 // 3 + 2 * nz**2
    fl_ls = len(cfg.alphas) * N * (rows * 6 + nx * 8)
    fl_iter = fl_J + fl_H + fl_g + fl_S + fl_chol + fl_ls
    print(f"FLOP model/iteration: total {fl_iter/1e6:.1f} MFLOP "
          f"(H-build {100*fl_H/fl_iter:.0f}%, J-build {100*fl_J/fl_iter:.0f}%, "
          f"S-prop {100*fl_S/fl_iter:.0f}%, chol {100*fl_chol/fl_iter:.0f}%, "
          f"LS {100*fl_ls/fl_iter:.0f}%)")
    tf_exec = B * it_exec * fl_iter / dt_e2e / 1e12
    tf_useful = B * it_useful * fl_iter / dt_e2e / 1e12
    print(f"achieved: executed {tf_exec:.2f} TFLOP/s, useful {tf_useful:.2f} "
          f"TFLOP/s on {jax.devices()[0].device_kind}")

    # ---- phase timing at the bench shape ----
    U0 = jnp.zeros((B, Nc, nu), jnp.float32)
    lam0 = jnp.zeros((B, N, n_con), jnp.float32)
    mu0 = jnp.full((B,), 100.0, jnp.float32)

    from nmpc_tpu.solver.alilqr_batched import _batch_fields
    bf = _batch_fields(ob)
    axes = dataclasses.replace(
        ob, **{fld.name: (0 if fld.name in bf else None)
               for fld in dataclasses.fields(ob) if fld.name not in P.OCP_META})

    normal = jax.jit(jax.vmap(
        lambda o, u, l, m: gn._normal_scan(o, u, l, m, Nc),
        in_axes=(axes, 0, 0, 0)))
    dt_norm, (H, g) = _time(normal, ob, U0, lam0, mu0)
    print(f"phase normal-eq (H,g): {dt_norm*1e3:.1f} ms "
          f"-> {B * (fl_J + fl_H + fl_g + fl_S) / dt_norm / 1e12:.2f} TFLOP/s")

    chol = jax.jit(lambda Hb, gb: -jax.vmap(
        lambda h, gg: jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(h), gg))(Hb, gb))
    Hr = H + 1e-6 * jnp.eye(nz, dtype=jnp.float32)[None]
    dt_chol, _ = _time(chol, Hr, g)
    print(f"phase cholesky+solve: {dt_chol*1e3:.1f} ms "
          f"-> {B * fl_chol / dt_chol / 1e12:.3f} TFLOP/s")

    merit7 = jax.jit(jax.vmap(
        lambda o, u, l, m: jax.vmap(
            lambda a: gn._merit(o, (u + a * 0.01).reshape(Nc, nu), l, m)
        )(jnp.asarray(cfg.alphas, jnp.float32)),
        in_axes=(axes, 0, 0, 0)))
    dt_ls, _ = _time(merit7, ob, U0.reshape(B, Nc, nu), lam0, mu0)
    print(f"phase line-search merit x{len(cfg.alphas)}: {dt_ls*1e3:.1f} ms")

    per_iter = dt_norm + dt_chol + dt_ls
    print(f"phase sum x executed iters: {per_iter * it_exec:.3f} s "
          f"(vs end-to-end {dt_e2e:.3f} s — gap = outer-loop rollouts, "
          f"AL updates, dispatch)")

    # ---- measured batched-GEMM rate at exactly the H-build shape ----
    for Kc in (1, 4, 10):
        Jc = jnp.asarray(
            np.random.default_rng(0).normal(size=(B, Kc * rows, nz)),
            jnp.float32)
        gemm = jax.jit(lambda Jb: jnp.einsum("bkr,bks->brs", Jb, Jb))
        dt_g, _ = _time(gemm, Jc)
        flops = 2 * B * Kc * rows * nz * nz
        print(f"batched GEMM [{nz},{Kc*rows}]@[{Kc*rows},{nz}] x{B} "
              f"({N//Kc} calls/sweep equiv): {dt_g*1e3:.2f} ms -> "
              f"{flops / dt_g / 1e12:.2f} TFLOP/s")


if __name__ == "__main__":
    main()
