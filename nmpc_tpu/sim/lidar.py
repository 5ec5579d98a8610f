"""Planar LiDAR simulator: ray-circle intersection ranges.

Stands in for the TurtleBot3 LDS that feeds /scan in the reference
(obs_avoid_static_first_scenario_v4.py:29-40): numRays rays at body-frame
angles B0[j] = 2 pi j / numRays, ranges capped at scan_max = 3.5 m (the
reference maps Inf returns to 3.5). Fully vectorized over rays x obstacles —
one fused elementwise kernel per scan.
"""

from __future__ import annotations

import jax.numpy as jnp


def ray_angles(num_rays: int, dtype=jnp.float32):
    """Body-frame ray directions B0[j] = 2 pi j / numRays (v4 :202-205)."""
    return (2.0 * jnp.pi / num_rays) * jnp.arange(num_rays, dtype=dtype)


def raycast(pose, obstacles, angles, scan_max=3.5):
    """Ranges from `pose` [3] along body angles [R] against circles [n,3].

    Solves |o + t d - c|^2 = r^2 per ray/obstacle; returns the smallest
    positive hit distance, capped at scan_max."""
    o = pose[:2]
    th = pose[2]
    world = th + angles
    d = jnp.stack([jnp.cos(world), jnp.sin(world)], axis=-1)        # [R, 2]
    oc = obstacles[None, :, :2] - o[None, None, :2].reshape(1, 1, 2)  # [1, n, 2]
    b = jnp.sum(d[:, None, :] * oc, axis=-1)                         # [R, n]
    cc = jnp.sum(oc * oc, axis=-1) - obstacles[None, :, 2] ** 2      # [1->R, n]
    disc = b * b - cc
    safe = jnp.sqrt(jnp.maximum(disc, 0.0))
    t = b - safe
    t = jnp.where((disc >= 0.0) & (t > 0.0), t, jnp.inf)
    rng = jnp.min(t, axis=-1) if obstacles.shape[0] else jnp.full(angles.shape, jnp.inf)
    return jnp.minimum(rng, scan_max)


def obstacle_points(pose, scan, angles):
    """Frozen obstacle points pObs[j] = Rz(th) (scan_j e(B0_j)) + p — the ray
    endpoints in the world frame (v4 :109-113). Returns [R, 2]."""
    th = pose[2]
    world = th + angles
    return pose[:2][None, :] + scan[:, None] * jnp.stack(
        [jnp.cos(world), jnp.sin(world)], axis=-1
    )
