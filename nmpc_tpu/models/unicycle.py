"""Unicycle (differential-drive) kinematics, single robot and m-robot stacked.

Reference parity:
  - single-robot RHS  [v cos(th), v sin(th), w]:
    /root/reference/AllScripts/mpc_online_casadi.py:69
  - m-robot block stacking (state [x1,y1,th1,...,xm,ym,thm], control
    [v1,w1,...,vm,wm]):
    /root/reference/AllScripts/mpc_online_casadi_tb3_six_multi_centralized_collision_free.py:163-167
  - explicit-Euler discretization x_{k+1} = x_k + T f(x_k, u_k):
    same file :248-252
  - RK4 variant: /root/reference/AllScripts/mpc_pose_control_casadi.py:43-59

Accelerator notes: everything is shape-static and vectorized over the robot
axis via reshape to [m, 3]/[m, 2] — no per-robot Python loops, so a single
fused elementwise kernel regardless of m. Analytic Jacobians of the
Euler map are provided so the solver's linearization stage needs no AD and
fuses into the batched backward pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def unicycle_rhs(x: jax.Array, u: jax.Array) -> jax.Array:
    """Continuous-time RHS for one unicycle. x=[px,py,th], u=[v,w]."""
    th = x[..., 2]
    v = u[..., 0]
    w = u[..., 1]
    return jnp.stack([v * jnp.cos(th), v * jnp.sin(th), w], axis=-1)


def stacked_unicycle_rhs(x: jax.Array, u: jax.Array) -> jax.Array:
    """RHS for m stacked unicycles. x: [..., 3m], u: [..., 2m]."""
    m = x.shape[-1] // 3
    xs = x.reshape(*x.shape[:-1], m, 3)
    us = u.reshape(*u.shape[:-1], m, 2)
    return unicycle_rhs(xs, us).reshape(x.shape)


def euler_step(x: jax.Array, u: jax.Array, dt) -> jax.Array:
    """Explicit Euler: the reference's transcription integrator."""
    return x + dt * stacked_unicycle_rhs(x, u)


def rk4_step(x: jax.Array, u: jax.Array, dt) -> jax.Array:
    """Classic RK4 with zero-order-hold control (mpc_pose_control_casadi.py:43-59)."""
    f = stacked_unicycle_rhs
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def discrete_dynamics(x: jax.Array, u: jax.Array, dt, integrator: str = "euler") -> jax.Array:
    if integrator == "euler":
        return euler_step(x, u, dt)
    if integrator == "rk4":
        return rk4_step(x, u, dt)
    raise ValueError(f"unknown integrator {integrator!r}")


def euler_jacobians(x: jax.Array, u: jax.Array, dt):
    """Analytic (A, B) of the Euler map for m stacked unicycles.

    A = d x_{k+1} / d x_k  : [3m, 3m]   (block-diagonal, 3x3 blocks)
    B = d x_{k+1} / d u_k  : [3m, 2m]   (block-diagonal, 3x2 blocks)

    Built densely (3m <= 30 so the blocks are tiny); batched callers vmap over
    the stage/scenario axes and XLA fuses the trig with the scatter-free
    block assembly below.
    """
    m = x.shape[-1] // 3
    th = x.reshape(m, 3)[:, 2]
    v = u.reshape(m, 2)[:, 0]
    s, c = jnp.sin(th), jnp.cos(th)

    # Per-robot A block: I + dt * [[0,0,-v s],[0,0,v c],[0,0,0]]
    zero = jnp.zeros_like(th)
    one = jnp.ones_like(th)
    Ablk = jnp.stack(
        [
            jnp.stack([one, zero, -dt * v * s], axis=-1),
            jnp.stack([zero, one, dt * v * c], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )  # [m, 3, 3]
    Bblk = jnp.stack(
        [
            jnp.stack([dt * c, zero], axis=-1),
            jnp.stack([dt * s, zero], axis=-1),
            jnp.stack([zero, dt * one], axis=-1),
        ],
        axis=-2,
    )  # [m, 3, 2]

    A = jax.scipy.linalg.block_diag(*Ablk) if m > 1 else Ablk[0]
    B = jax.scipy.linalg.block_diag(*Bblk) if m > 1 else Bblk[0]
    return A, B
