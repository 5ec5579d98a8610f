"""Robot-sharded JOINT NMPC solve by Jacobi-AL consensus (SURVEY.md §2.4
"model/robot parallel" — the one strategy round 1 left partial: the
centralized NLP lived on a single chip).

The reference's centralized joint NLP couples robots only through the
pairwise keep-out rows c_ij = d_ij^2 - dmin^2 >= 0 evaluated at stages
0..N-1 (mpc_online_casadi_tb3_six_multi_centralized_collision_free.py:
218-236,256-261); cost and dynamics are per-robot separable. Duplicating
each pair row once per endpoint yields an equivalent NLP whose KKT points
simply split the pair multiplier between the endpoints, so a block-Jacobi
scheme over robots — each robot minimizes the joint augmented Lagrangian
over its OWN trajectory with the neighbors' trajectories fixed — has the
joint problem's KKT points as fixed points. That is the decomposition this
module runs, one round being:

  1. exchange position plans (a single `jax.lax.all_gather` over the robot
     mesh axis — the collective standing in for the reference's
     shared-world coupling, SURVEY.md §5.8),
  2. every robot solves its own 3-state OCP with the neighbors' gathered
     plans as *stage-synchronous* moving keep-outs (same stage k vs stage k
     as the joint rows; contrast the deployment-mode `decentralized_step`,
     which offsets by one stage because its plans are a control period
     stale),
  3. under-relax the exchanged plans (`damping`) to suppress the limit
     cycling symmetric Jacobi iterations are prone to, and CARRY the AL
     duals and penalty (lam, mu) across rounds — steady-warm semantics
     (round-1 finding: resetting mu under carried lam breaks the PHR
     activation band).

Joint convergence is measured on the gathered iterate (max duplicated-pair
violation + plan movement), identical on every shard by construction.

vs `decentralized.decentralized_step`: that is ONE Jacobi round per control
period against stale plans — the paper's decentralized *architecture*.
This module iterates rounds at a FIXED initial state until the joint
iterate settles, i.e. it solves the centralized problem itself with robots
as the parallel axis: the batch axis of the batch-native engine on one
device, shards of a mesh across devices.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec
from jax import shard_map

from nmpc_tpu.ocp.problem import OCP
from nmpc_tpu.parallel.decentralized import _neighbor_index, robot_template
from nmpc_tpu.solver.alilqr import ALILQRConfig, WarmStart, cold_start, solve

__all__ = [
    "consensus_solve",
    "consensus_solve_sharded",
    "joint_pair_violation",
    "robot_template",
]


def joint_pair_violation(plans: jax.Array, dmin2, N: int) -> jax.Array:
    """Max violation of the joint pair rows dmin^2 - d_ij^2 <= 0 over stages
    0..N-1 of the gathered position plans [m, N+1, 2] (squared-distance
    units, matching SolveResult.viol)."""
    m = plans.shape[0]
    P = plans[:, :N, :]
    d2 = jnp.sum((P[:, None] - P[None, :]) ** 2, axis=-1)  # [m, m, N]
    off = ~jnp.eye(m, dtype=bool)
    v = jnp.maximum(0.0, dmin2 - d2) * off[:, :, None]
    return jnp.max(v)


def _plans_cold(poses: jax.Array, N: int) -> jax.Array:
    return jnp.tile(poses[:, None, :2], (1, N + 1, 1))


def consensus_solve(
    template: OCP,
    x_joint: jax.Array,      # [3m] joint initial state
    goals: jax.Array,        # [m, 3]
    cfg: ALILQRConfig = ALILQRConfig(),
    rounds: int = 10,
    damping: float = 0.5,
    warms: WarmStart | None = None,
    plans: jax.Array | None = None,
    engine: str = "fused",
    rh_bias: float = 0.0,
):
    """Joint solve on one program: robots ride the batch axis (of the
    batch-native engine, or of a vmap of the per-scenario solver with
    engine='xla').

    Returns (X [m, N+1, 3], U [m, N, 2], warms, plans, viol_hist [rounds],
    delta_hist [rounds]). `warms`/`plans` allow MPC-step warm starting;
    viol_hist is the joint duplicated-pair violation of each round's raw
    (undamped) iterate — its tail is the convergence certificate.

    rh_bias > 0 applies the right-hand traffic rule (each robot perceives
    neighbors shifted to its own left; see `decentralized_step`): EXACTLY
    symmetric conflicts make the symmetric Jacobi iteration stall on the
    reciprocal saddle the same way they deadlock the reference's joint
    solve absent Gazebo noise. Leave 0 for joint-KKT parity; the caller
    must inflate the template's dmin by rh_bias to protect the true margin.
    """
    m = goals.shape[0]
    N = template.N
    nbr = _neighbor_index(m)
    poses = x_joint.reshape(m, 3)
    xref_b = jnp.tile(goals[:, None, :], (1, N, 1))
    if plans is None:
        plans = _plans_cold(poses, N)
    if warms is None:
        warms = jax.vmap(lambda _: cold_start(template, cfg))(jnp.arange(m))

    use_fused = engine == "fused"
    if use_fused:
        from nmpc_tpu.solver.alilqr_batched import solve_batched

    def solve_round(plans_k, wU, wlam, wmu):
        # stage-k keep-out = neighbor's plan at stage k (joint-row semantics)
        mov = jnp.swapaxes(plans_k[nbr][:, :, :N, :], 1, 2)  # [m, N, m-1, 2]
        if rh_bias:
            rel = mov - poses[:, None, None, :2]
            nrm = jnp.sqrt(jnp.sum(rel * rel, axis=-1, keepdims=True) + 1e-9)
            left = jnp.stack([-rel[..., 1], rel[..., 0]], axis=-1) / nrm
            mov = mov + rh_bias * left
        w = WarmStart(U=wU, lam=wlam, mu=wmu)
        if use_fused:
            ocp_b = dataclasses.replace(
                template, x0=poses, xref=xref_b, mov_obs=mov)
            return solve_batched(ocp_b, w, cfg)

        def one(x0_i, xref_i, mov_i, w_i):
            ocp_i = dataclasses.replace(
                template, x0=x0_i, xref=xref_i, mov_obs=mov_i)
            return solve(ocp_i, w_i, cfg)

        return jax.vmap(one)(poses, xref_b, mov, w)

    def body(carry, _):
        plans_prev, wU, wlam, wmu, _X = carry
        res = solve_round(plans_prev, wU, wlam, wmu)
        raw = res.X[:, :, :2]
        plans_new = damping * raw + (1.0 - damping) * plans_prev
        delta = jnp.max(jnp.abs(plans_new - plans_prev))
        viol = joint_pair_violation(raw, template.dmin2, N)
        return (plans_new, res.U, res.lam, res.mu, res.X), (viol, delta)

    X0 = jnp.tile(poses[:, None, :], (1, N + 1, 1))
    carry0 = (plans, warms.U, warms.lam, warms.mu, X0)
    (plans_f, U_f, lam_f, mu_f, X_f), (violh, deltah) = jax.lax.scan(
        body, carry0, None, length=rounds)
    return X_f, U_f, WarmStart(U=U_f, lam=lam_f, mu=mu_f), plans_f, violh, deltah


def consensus_closed_loop(
    x0_joint: jax.Array,     # [3m]
    goals: jax.Array,        # [m, 3]
    N: int,
    T: float,
    dmin: float,
    rounds: int = 3,
    max_steps: int = 200,
    stop_tol: float = 1e-1,
    cfg: ALILQRConfig = ALILQRConfig(),
    damping: float = 0.5,
    v_max: float = 0.22,
    omega_max: float = 2.84,
    escape: bool = True,
    engine: str = "fused",
    rh_bias: float = 0.1,
):
    """Closed-loop MPC with the robot-parallel JOINT solve per step: each
    control period runs `rounds` consensus rounds warm-started from the
    previous step's shifted plans/duals (shift = drop first, repeat last —
    the reference shift(), six-robot file :90-99), executes the first joint
    control, and advances the plant. Unlike `decentralized_closed_loop`
    (one stale-plan Jacobi round per period) every executed control comes
    from a jointly-converged iterate, so the realized clearance matches the
    centralized driver's.

    Returns (X_hist [S+1, 3m], U_hist [S, 2m], min_dist_hist [S+1], reached).
    """
    from nmpc_tpu.sim.plant import PlantConfig, plant_step

    m = goals.shape[0]
    # keep-out inflated by rh_bias so the perception shift cannot eat into
    # the true dmin margin (same convention as decentralized_closed_loop)
    template = robot_template(N, T, dmin + rh_bias, m, v_max, omega_max,
                              dtype=x0_joint.dtype)
    goal_joint = goals.reshape(3 * m)

    def min_dist(x):
        p = x.reshape(m, 3)[:, :2]
        d2 = jnp.sum((p[:, None, :] - p[None, :, :]) ** 2, axis=-1)
        d2 = d2 + jnp.eye(m, dtype=x.dtype) * 1e9
        return jnp.sqrt(jnp.min(d2))

    def step(carry, _):
        x, plans, wU, wlam, wmu, done, steps, esc = carry
        err = jnp.linalg.norm(x - goal_joint)
        done = done | (err <= stop_tol)
        X, U, warms, plans_new, _violh, _ = consensus_solve(
            template, x, goals, cfg, rounds=rounds, damping=damping,
            warms=WarmStart(U=wU, lam=wlam, mu=wmu), plans=plans,
            engine=engine, rh_bias=rh_bias)
        u_joint = U[:, 0, :].reshape(2 * m)
        if escape:
            import dataclasses as _dc

            from nmpc_tpu.mpc.driver import MPCConfig, _escape_control

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
            u_joint, esc = _escape_control(
                joint_tpl, mpc_like, x, goal_joint, u_joint, esc, done)
        u_joint = jnp.where(done, 0.0, u_joint)
        x_next, _ = plant_step(x, u_joint, template.T, PlantConfig())
        x_next = jnp.where(done, x, x_next)
        # reference shift(): drop the executed stage, repeat the last; mu
        # carries (steady-warm — resetting it under carried lam breaks PHR)
        U_sh = jnp.concatenate([warms.U[:, 1:], warms.U[:, -1:]], axis=1)
        lam_sh = jnp.concatenate([warms.lam[:, 1:], warms.lam[:, -1:]], axis=1)
        plans_sh = jnp.concatenate([plans_new[:, 1:], plans_new[:, -1:]], axis=1)
        carry_new = (x_next, plans_sh, U_sh, lam_sh, warms.mu, done,
                     steps + jnp.where(done, 0, 1), esc)
        return carry_new, (x_next, u_joint, min_dist(x_next))

    poses0 = x0_joint.reshape(m, 3)
    warms0 = jax.vmap(lambda _: cold_start(template, cfg))(jnp.arange(m))
    plans0 = _plans_cold(poses0, N)
    carry0 = (x0_joint, plans0, warms0.U, warms0.lam, warms0.mu,
              jnp.zeros((), bool), jnp.zeros((), jnp.int32),
              jnp.zeros((m,), jnp.int32))
    (xF, *_, done, steps, _), (X_t, U_t, mind_t) = jax.lax.scan(
        step, carry0, None, length=max_steps)
    X_hist = jnp.concatenate([x0_joint[None], X_t], axis=0)
    mind = jnp.concatenate([min_dist(x0_joint)[None], mind_t], axis=0)
    return X_hist, U_t, mind, done


def consensus_solve_sharded(
    mesh: Mesh,
    template: OCP,
    cfg: ALILQRConfig = ALILQRConfig(),
    rounds: int = 10,
    damping: float = 0.5,
    axis: str = "robots",
    rh_bias: float = 0.0,
    engine: str = "fused",
):
    """shard_map form of `consensus_solve`: robots sharded over `axis`, one
    `all_gather` per round for the plan exchange (the cross-chip constraint
    reduction), `pmax` for the global plan-movement metric.

    Returns a jitted callable
      (poses [m, 3], goals [m, 3], plans [m, N+1, 2], warms) ->
      (X [m, N+1, 3], U [m, N, 2], warms, plans, viol_hist, delta_hist)
    with the robot-carried outputs sharded and the histories replicated.

    engine='fused' (default) solves each device's WHOLE shard of robots
    as one batch of the batch-native engine per round — shard = several
    robots, so a large fleet pays one batched solve per device per round
    instead of m/d per-robot solves. engine='xla' keeps the vmapped
    per-scenario solver."""
    N = template.N
    use_fused = engine == "fused"
    if use_fused:
        from nmpc_tpu.solver.alilqr_batched import solve_batched

    def body(poses, goals, plans, wU, wlam, wmu):
        m_loc = poses.shape[0]
        xref_l = jnp.tile(goals[:, None, :], (1, N, 1))
        my0 = jax.lax.axis_index(axis) * m_loc

        def rnd(carry, _):
            plans_loc, wU, wlam, wmu, _X = carry
            all_plans = jax.lax.all_gather(plans_loc, axis, tiled=True)

            def mov_of(i_local, x0_i):
                i_glob = my0 + i_local
                # roll self to slot 0, drop it -> the m-1 neighbor plans
                others = jnp.roll(all_plans, -i_glob, axis=0)[1:]
                mov = jnp.swapaxes(others[:, :N, :], 0, 1)  # [N, m-1, 2]
                if rh_bias:
                    rel = mov - x0_i[None, None, :2]
                    nrm = jnp.sqrt(
                        jnp.sum(rel * rel, axis=-1, keepdims=True) + 1e-9)
                    left = jnp.stack(
                        [-rel[..., 1], rel[..., 0]], axis=-1) / nrm
                    mov = mov + rh_bias * left
                return mov

            w = WarmStart(U=wU, lam=wlam, mu=wmu)
            if use_fused:
                mov_b = jax.vmap(mov_of)(jnp.arange(m_loc), poses)
                ocp_b = dataclasses.replace(
                    template, x0=poses, xref=xref_l, mov_obs=mov_b)
                res = solve_batched(ocp_b, w, cfg)
            else:
                def one(i_local, x0_i, xref_i, w_i):
                    ocp_i = dataclasses.replace(
                        template, x0=x0_i, xref=xref_i,
                        mov_obs=mov_of(i_local, x0_i))
                    return solve(ocp_i, w_i, cfg)

                res = jax.vmap(one)(
                    jnp.arange(m_loc), poses, xref_l, w)
            raw = res.X[:, :, :2]
            plans_new = damping * raw + (1.0 - damping) * plans_loc
            all_raw = jax.lax.all_gather(raw, axis, tiled=True)
            viol = joint_pair_violation(all_raw, template.dmin2, N)
            delta = jax.lax.pmax(
                jnp.max(jnp.abs(plans_new - plans_loc)), axis)
            return (plans_new, res.U, res.lam, res.mu, res.X), (viol, delta)

        X0 = jnp.tile(poses[:, None, :], (1, N + 1, 1))
        (plans_f, U_f, lam_f, mu_f, X_f), (violh, deltah) = jax.lax.scan(
            rnd, (plans, wU, wlam, wmu, X0), None, length=rounds)
        return X_f, U_f, plans_f, lam_f, mu_f, violh, deltah

    spec = PartitionSpec(axis)
    rep = PartitionSpec()
    fn = jax.jit(shard_map(
        body,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec, spec),
        out_specs=(spec, spec, spec, spec, spec, rep, rep),
        check_vma=False,  # scan carries inside the per-shard solver are
                          # unvarying at init; vma inference rejects them
    ))

    def run(poses, goals, plans=None, warms=None):
        m = poses.shape[0]
        if plans is None:
            plans = _plans_cold(poses, N)
        if warms is None:
            warms = jax.vmap(lambda _: cold_start(template, cfg))(jnp.arange(m))
        X, U, plans_f, lam_f, mu_f, violh, deltah = fn(
            poses, goals, plans, warms.U, warms.lam, warms.mu)
        return X, U, WarmStart(U=U, lam=lam_f, mu=mu_f), plans_f, violh, deltah

    return run
