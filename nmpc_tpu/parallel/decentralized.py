"""True decentralized NMPC with neighbor-plan exchange.

The reference's 'decentralized' deployment is m uncoupled single-robot nodes
that only share a Gazebo world (mpc_online_casadi_tb3_{1,2,3}.py — SURVEY.md
§2.4). This module implements the real thing the paper's architecture implies:
each robot solves its *own* 3-state OCP treating the other robots' previously
exchanged plans as time-indexed moving obstacles, then publishes its new plan.

Device mapping: per-robot subproblems ride the batch axis of one program
(all robots solved simultaneously); across a device mesh the plan exchange
is a single `jax.lax.all_gather` over the 'robots' axis inside `shard_map` —
the collective analog of the reference's ROS topic bus (SURVEY.md §5.8).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec
from jax import shard_map

from nmpc_tpu.ocp.problem import OCP, make_ocp
from nmpc_tpu.sim.plant import PlantConfig, plant_step
from nmpc_tpu.solver.alilqr import ALILQRConfig, WarmStart, cold_start, solve


def robot_template(
    N: int,
    T: float,
    dmin: float,
    m: int,
    v_max: float = 0.22,
    omega_max: float = 2.84,
    pos_bound: float = 10.0,
    dtype=jnp.float32,
) -> OCP:
    """Single-robot OCP with m-1 moving-obstacle slots."""
    return make_ocp(
        m=1,
        N=N,
        T=T,
        x0=jnp.zeros((3,), dtype),
        x_goal=jnp.zeros((3,), dtype),
        v_max=v_max,
        omega_max=omega_max,
        pos_bound=pos_bound,
        dmin=dmin,
        mov_obs=jnp.zeros((N, m - 1, 2), dtype),
        dtype=dtype,
    )


def _neighbor_index(m: int) -> jnp.ndarray:
    return jnp.asarray(
        np.array([[j for j in range(m) if j != i] for i in range(m)]), jnp.int32
    )


def decentralized_step(
    template: OCP,
    x_joint: jax.Array,      # [3m] latched joint measurement
    goals: jax.Array,        # [m, 3]
    plans: jax.Array,        # [m, N+1, 2] last exchanged position plans
    warms: WarmStart,        # batched over robots
    cfg: ALILQRConfig = ALILQRConfig(),
    rh_bias: float = 0.03,
    engine: str = "fused",
):
    """One synchronous decentralized round: solve all robots' subproblems
    against the exchanged plans. Returns (results, u_joint [2m], new plans).

    rh_bias > 0 applies a right-hand traffic rule: each robot perceives its
    neighbors shifted slightly to its own left, so reciprocal conflicts
    resolve with both parties passing on the right — a deterministic
    tie-break for the exactly-symmetric standoffs that make plain reciprocal
    avoidance deadlock (the decentralized analog of the reference's reliance
    on asymmetric numerics).

    engine: 'fused' routes the per-robot subproblems through the batch-native
    engine (solver/alilqr_batched.py: robots on the batch axis, neighbor
    plans as per-element moving obstacles); 'xla' vmaps the per-scenario
    solver, kept for verification."""
    m = plans.shape[0]
    N = template.N
    nbr = _neighbor_index(m)
    poses = x_joint.reshape(m, 3)

    # Stage-k constraint sees the neighbor at its plan's stage k+1 (plans are
    # one control period stale after the shift), clamped at the plan end.
    nbr_plans = plans[nbr]                       # [m, m-1, N+1, 2]
    mov = jnp.swapaxes(nbr_plans[:, :, 1 : N + 1, :], 1, 2)  # [m, N, m-1, 2]
    if rh_bias:
        rel = mov - poses[:, None, None, :2]
        nrm = jnp.sqrt(jnp.sum(rel * rel, axis=-1, keepdims=True) + 1e-9)
        left = jnp.stack([-rel[..., 1], rel[..., 0]], axis=-1) / nrm
        mov = mov + rh_bias * left

    if engine == "fused":
        from nmpc_tpu.solver.alilqr_batched import solve_batched

        ocp_b = dataclasses.replace(
            template,
            x0=poses,
            xref=jnp.tile(goals[:, None, :], (1, N, 1)),
            mov_obs=mov,
        )
        res = solve_batched(ocp_b, warms, cfg)
    else:
        def solve_i(x0_i, goal_i, mov_i, warm_i):
            ocp_i = dataclasses.replace(
                template,
                x0=x0_i,
                xref=jnp.tile(goal_i[None, :], (N, 1)),
                mov_obs=mov_i,
            )
            return solve(ocp_i, warm_i, cfg)

        res = jax.vmap(solve_i)(poses, goals, mov, warms)
    u_joint = res.U[:, 0, :].reshape(2 * m)
    plans_new = res.X[:, :, :2]
    return res, u_joint, plans_new


def decentralized_closed_loop(
    x0_joint: jax.Array,     # [3m]
    goals: jax.Array,        # [m, 3]
    N: int,
    T: float,
    dmin: float,
    max_steps: int = 200,
    stop_tol: float = 1e-1,
    cfg: ALILQRConfig = ALILQRConfig(),
    plant: PlantConfig = PlantConfig(),
    v_max: float = 0.22,
    omega_max: float = 2.84,
    rh_bias: float = 0.1,
    escape: bool = True,
    engine: str = "fused",
):
    """Closed loop in decentralized mode (single-program vmap form).

    Returns (X_hist [S+1, 3m], U_hist [S, 2m], min_dist_hist [S+1], reached).
    The keep-out radius is inflated by rh_bias so the right-hand-rule
    perception shift cannot eat into the true dmin margin."""
    m = goals.shape[0]
    template = robot_template(N, T, dmin + rh_bias, m, v_max, omega_max, dtype=x0_joint.dtype)
    goal_joint = goals.reshape(3 * m)

    def min_dist(x):
        p = x.reshape(m, 3)[:, :2]
        d2 = jnp.sum((p[:, None, :] - p[None, :, :]) ** 2, axis=-1)
        d2 = d2 + jnp.eye(m, dtype=x.dtype) * 1e9
        return jnp.sqrt(jnp.min(d2))

    def step(carry, _):
        x, plans, warms, done, steps, esc = carry
        err = jnp.linalg.norm(x - goal_joint)
        done = done | (err <= stop_tol)
        res, u_joint, plans_new = decentralized_step(
            template, x, goals, plans, warms, cfg, rh_bias=rh_bias,
            engine=engine,
        )
        if escape:
            from nmpc_tpu.mpc.driver import MPCConfig, _escape_control
            import dataclasses as _dc

            mpc_like = MPCConfig(stop_tol=stop_tol, escape=True)
            joint_tpl = _dc.replace(
                template,
                m=m,
                n_mov=0,
                collision=True,  # arms the escape clearance gate (n_pairs>0)
                x0=x,
                xref=jnp.tile(goal_joint[None], (N, 1)),
                Qdiag=jnp.tile(template.Qdiag, m),
                Rdiag=jnp.tile(template.Rdiag, m),
                u_lo=jnp.tile(template.u_lo, m),
                u_hi=jnp.tile(template.u_hi, m),
                x_lo=jnp.tile(template.x_lo, m),
                x_hi=jnp.tile(template.x_hi, m),
                mov_obs=jnp.zeros((N, 0, 2), x.dtype),
            )
            u_joint, esc = _escape_control(joint_tpl, mpc_like, x, goal_joint, u_joint, esc, done)
        u_joint = jnp.where(done, 0.0, u_joint)
        x_next, _ = plant_step(x, u_joint, template.T, plant)
        x_next = jnp.where(done, x, x_next)
        # shift: drop the executed stage, repeat the last (reference shift())
        U_sh = jnp.concatenate([res.U[:, 1:], res.U[:, -1:]], axis=1)
        lam_sh = jnp.concatenate([res.lam[:, 1:], res.lam[:, -1:]], axis=1)
        warms_new = WarmStart(U=U_sh, lam=lam_sh, mu=jnp.full_like(res.mu, cfg.mu_init))
        plans_sh = jnp.concatenate([plans_new[:, 1:], plans_new[:, -1:]], axis=1)
        carry_new = (x_next, plans_sh, warms_new, done, steps + jnp.where(done, 0, 1), esc)
        return carry_new, (x_next, u_joint, min_dist(x_next))

    warms0 = jax.vmap(lambda _: cold_start(template, cfg))(jnp.arange(m))
    plans0 = jnp.tile(x0_joint.reshape(m, 3)[:, None, :2], (1, N + 1, 1))
    carry0 = (x0_joint, plans0, warms0, jnp.zeros((), bool), jnp.zeros((), jnp.int32),
              jnp.zeros((m,), jnp.int32))
    (xF, _, _, done, steps, _), (X_t, U_t, mind_t) = jax.lax.scan(
        step, carry0, jnp.arange(max_steps)
    )
    X_hist = jnp.concatenate([x0_joint[None], X_t], axis=0)
    mind = jnp.concatenate([min_dist(x0_joint)[None], mind_t], axis=0)
    return X_hist, U_t, mind, done


def decentralized_step_sharded(
    mesh: Mesh,
    template: OCP,
    cfg: ALILQRConfig = ALILQRConfig(),
    axis: str = "robots",
):
    """shard_map form: robots sharded over the mesh axis; the plan exchange is
    an all_gather collective between devices (the TCPROS replacement). Returns a
    jitted callable (x_joint_sharded [m,3], goals [m,3], plans [m,N+1,2],
    warms) -> (u [m,2], plans_new)."""
    N = template.N

    def body(poses, goals, plans, warm_U, warm_lam, warm_mu):
        # each shard holds [m/d, ...]; gather everyone's current plans
        all_plans = jax.lax.all_gather(plans, axis, tiled=True)  # [m, N+1, 2]
        m = all_plans.shape[0]
        my_start = jax.lax.axis_index(axis) * poses.shape[0]

        def solve_i(i_local, x0_i, goal_i, wU, wlam, wmu):
            i_glob = my_start + i_local
            # mask self out of the gathered plans by pushing it to infinity
            mask = (jnp.arange(m) == i_glob)[:, None, None]
            far = jnp.where(mask, 1e6, 0.0)
            others = all_plans + far
            # drop one arbitrary slot to get m-1 rows: roll so self is slot 0
            others = jnp.roll(others, -i_glob, axis=0)[1:]
            mov = jnp.swapaxes(others[:, 1 : N + 1, :], 0, 1)  # [N, m-1, 2]
            ocp_i = dataclasses.replace(
                template,
                x0=x0_i,
                xref=jnp.tile(goal_i[None, :], (N, 1)),
                mov_obs=mov,
            )
            return solve(ocp_i, WarmStart(U=wU, lam=wlam, mu=wmu), cfg)

        res = jax.vmap(solve_i)(
            jnp.arange(poses.shape[0]), poses, goals, warm_U, warm_lam, warm_mu
        )
        return res.U[:, 0, :], res.X[:, :, :2]

    spec = PartitionSpec(axis)
    return jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(spec, spec, spec, spec, spec, spec),
            out_specs=(spec, spec),
            check_vma=False,  # scan carries inside the per-shard solver are
                              # unvarying at init; vma inference rejects them
        )
    )
