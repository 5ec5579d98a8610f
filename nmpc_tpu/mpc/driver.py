"""Receding-horizon MPC drivers (L4 of SURVEY.md §1).

Replaces the reference's hand-rolled `while` loops
(/root/reference/AllScripts/mpc_online_casadi_tb3_six_multi_centralized_collision_free.py:338-427)
with a single jitted `lax.scan` over control steps: pack params -> warm-start
-> solve -> apply first control -> advance plant -> shift. Convergence is a
mask (fixed shapes under jit); once a scenario converges its control is zero
and its state frozen, exactly like the reference's stop-and-publish-zeros
epilogue (:429-449).

Modes (mirroring the reference families of SURVEY.md §2.2):
  closed_loop            point stabilization (families C/E/F/G)
  closed_loop_waypoints  goal-sequence state machine
                         (centralized_one_robots_implementation.py:176-187,236-247)
  closed_loop_tracking   time-varying reference regenerated every step
                         (mpc_control_trajectory_tracking.py:126-127)
  plan_then_replay       converge offline against the model, then replay the
                         stored controls through the plant (casadi_test_mpc.py)
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from nmpc_tpu.ocp import problem as P
from nmpc_tpu.ocp.problem import OCP
from nmpc_tpu.sim.plant import PlantConfig, plant_step
from nmpc_tpu.solver.alilqr import ALILQRConfig, SolveResult, WarmStart, cold_start, solve


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Driver options (static)."""

    max_steps: int = 200
    stop_tol: float = 1e-1     # ||x - xs|| loop-exit threshold (:338; 5e-2 single-robot)
    advance_tol: float = 0.075 # waypoint advance threshold (one_robot_impl:239)
    mu_reset: bool = True      # reset penalty weight each step (multipliers
                               # are kept — they carry the active set; a
                               # carried-over stiff mu makes warm inner solves
                               # stall after one iteration). Full-strength
                               # solver configs re-grow mu over their outer
                               # loop so the reset is safe; reduced-iteration
                               # rt configs MUST set this False — lam learned
                               # at a stiff mu re-applied at mu_init breaks
                               # the PHR activation band (see steady_warm)
    lam_decay: float = 1.0     # dual filtering on the shifted multipliers
                               # (rt modes; see shift_warm)
    wrap_yaw: bool = False     # wrap the measured yaw to [0, 2pi) before each
                               # solve — the reference's modify() on odometry
                               # (mpc_online_casadi.py:28-33). Off by default:
                               # the headline scripts disable it (six-robot
                               # file :81-87 returns theta unchanged on both
                               # branches). Prevents accumulated-theta drift
                               # from the goal branch on long runs.
    # Parking-saddle escape: the unicycle OCP has a genuine stationary point
    # when the position error is perpendicular to the heading (verified: the
    # SLSQP oracle also returns u ~ 0 there). The reference escapes it only
    # via Gazebo/odometry noise; this deterministic fallback rotates toward
    # the bearing of the goal whenever the solver returns a ~zero control
    # while the error is still above tolerance. Off = reference-faithful.
    escape: bool = False
    escape_u_tol: float = 0.02  # PARKING stall trigger: a solve whose
                                # controls all sit below this counts as
                                # saddle-stalled for the parking law.
                                # Round 4: raised from 1e-3 — the
                                # two_robot_swap endgame showed the OCP has
                                # stay-put basins where the TRUE optimum
                                # (f64 oracle agrees to 3 decimals) is a
                                # slow creep with |w| ~ 0.03: with the old
                                # tolerance the parking law never engaged
                                # and the loop asymptoted at err ~0.32
                                # forever; at 0.02 the law takes over and
                                # parks (reached in 1042 steps). Parking
                                # requires the 1.5x-dmin clearance gate, so
                                # the raised trigger cannot create
                                # collisions
    escape_block_u_tol: float = 1e-3  # RETREAT stall trigger (robots
                                # WITHOUT clearance): kept at the strict
                                # round-3 value on purpose — a slow-creep
                                # yield mid-crossing must NOT count toward
                                # the blocked-stall counter (measured: at
                                # 0.02 the six-robot noise run retreats
                                # mid-crossing and fails to arrive)
    escape_gain: float = 1.5
    escape_stall_steps: int = 10  # consecutive blocked-stall steps before
                                  # the deadlock-breaking retreat engages
                                  # (_escape_control docstring)
    # Failure handling (SURVEY.md §5.3): the reference applies IPOPT's output
    # regardless of status. Here a solve whose plan is non-finite or grossly
    # infeasible is rejected and the previous shifted plan's first control is
    # applied instead (the natural fallback: it was feasible one step ago).
    viol_fallback: float = 1e30  # reject threshold on max violation
    # Compute-delay semantics: in the reference deployment the plant keeps
    # moving while IPOPT solves — odometry is latched at solve start and the
    # control lands roughly one solve-time late (callbacks mutate globals
    # mid-loop, ...six...collision_free.py:19-77 vs the read at :373). The
    # repo's default loop is latch->solve->apply atomically (zero compute
    # delay). delay=1 reproduces the reference's actual timing: the control
    # applied over period k is the one computed from the measurement at
    # period k-1 (one full control period of actuation delay — an upper
    # bound on the real solve latency wherever the solve fits inside one
    # period).
    delay: int = 0
    # Delay compensation (only meaningful with delay=1): predict the latched
    # measurement one period forward under the KNOWN in-flight control
    # before solving, so the plan's first control applies at the state it
    # was computed for. The reference does NOT compensate — it eats the
    # stale-plan error (measured here: the six-robot hardware config's
    # realized crossing clearance degrades 0.40 -> ~0.23 m uncompensated,
    # still above the ~0.21 m physical-contact distance of two TurtleBot3s,
    # which is presumably why the hardware family uses dmin=0.4). With
    # compensation the clearance recovers to the dmin class. Default off =
    # reference-faithful.
    delay_compensate: bool = False

    def __post_init__(self):
        # the per-robot escape state packs the parking-latch sentinel and
        # TWO stall counters (retreat + creep-parking debounce) into one
        # int32 with base-256 fields (driver._CNT_BASE); a counter reaching
        # the field width would alias into the neighbor field / sentinel
        if self.escape_stall_steps >= 255:
            raise ValueError(
                f"escape_stall_steps must be < 255 (escape-state counter "
                f"field width), got {self.escape_stall_steps}")


@partial(
    jax.tree_util.register_dataclass,
    data_fields=(
        "X_hist",
        "U_hist",
        "err_hist",
        "cost_hist",
        "viol_hist",
        "iter_hist",
        "min_dist_hist",
        "steps_used",
        "reached",
        "goal_idx_hist",
    ),
    meta_fields=(),
)
@dataclasses.dataclass(frozen=True)
class MPCResult:
    X_hist: jax.Array        # [S+1, nx] realized states (xx in the reference)
    U_hist: jax.Array        # [S, nu]  applied first controls (u_cl)
    err_hist: jax.Array      # [S] ||x - xs|| before each step
    cost_hist: jax.Array     # [S] OCP objective per solve
    viol_hist: jax.Array     # [S] max constraint violation per solve
    iter_hist: jax.Array     # [S] inner iterations per solve
    min_dist_hist: jax.Array # [S+1] min realized pairwise distance (inf if m==1)
    steps_used: jax.Array    # scalar int
    reached: jax.Array       # scalar bool
    goal_idx_hist: jax.Array # [S] active waypoint index (zeros unless waypoint mode)


def shift_warm(res: SolveResult, cfg: ALILQRConfig, mu_reset: bool = False,
               lam_decay: float = 1.0) -> WarmStart:
    """Reference `shift()` semantics — drop the first stage, repeat the last
    (six-robot file :90-99 for u0, :382-387 for X0) — applied to controls and
    per-stage multipliers. The state trajectory needs no explicit shift here:
    the solver re-rolls states from the new measurement (single-shooting
    iterates), which reproduces the reference's X0 re-seeding.

    `lam_decay` < 1 forgets a fraction of the carried multipliers each step
    (dual filtering) — useful in reduced-iteration rt modes where the scene
    geometry the multipliers encode goes stale faster than two outer updates
    can repair."""
    U = jnp.concatenate([res.U[1:], res.U[-1:]], axis=0)
    lam = lam_decay * jnp.concatenate([res.lam[1:], res.lam[-1:]], axis=0)
    mu = jnp.asarray(cfg.mu_init, res.mu.dtype) if mu_reset else res.mu
    return WarmStart(U=U, lam=lam, mu=mu)


def steady_warm(res: SolveResult, lam_decay: float = 1.0) -> WarmStart:
    """Warm start for the reduced-iteration rt steady state: carry U, the
    (optionally decayed) multipliers, AND the penalty weight mu they were
    learned at.

    Carrying lam while resetting mu is what made rt mode blow up (an early
    finding): the PHR activation band is c < lam/mu, so multipliers
    built at mu=1e4 re-applied at mu=10 exert their full outward force until
    c > lam/10 — an enormous unconditional push on well-satisfied
    constraints that flings the iterate into box-bound violation (measured on
    six_robot_antipodal: first 2x5-iteration warm solve jumps viol 0.2 -> 66,
    cost 1e3 -> 5e4). With mu carried the same 2x5 budget stays bounded at
    the full solver's own violation level (worst 0.48 over 30 solves); an
    intermediate mu=1e3 reset is worst of all (lam winds up to lam_max,
    viol 2e2). tools/rt_drift_experiment.py reproduces all three."""
    return WarmStart(U=res.U, lam=lam_decay * res.lam, mu=res.mu)


def _wrap_angle(a):
    return jnp.arctan2(jnp.sin(a), jnp.cos(a))


# escape-state encoding (int32 per robot): values >= _ESC_LATCH mean the
# parking latch is engaged; otherwise the value packs TWO small counters,
# cnt_creep * _CNT_BASE + cnt_hard — the consecutive-blocked-stall counter
# driving the deadlock-breaking retreat (hard stalls without clearance) and
# the creep-stall debounce driving delayed parking (round 4). Both counters
# saturate at escape_stall_steps, which MPCConfig validates < _CNT_BASE - 1
# so the packed value stays below the latch sentinel.
_CNT_BASE = 256
_ESC_LATCH = 1 << 16


def escape_state0(m: int) -> jax.Array:
    """Initial per-robot escape state for the closed-loop carries."""
    return jnp.zeros((m,), jnp.int32)


def _escape_control(ocp: OCP, mpc: MPCConfig, x, goal, u0, esc_flags, done, tol=None):
    """Sticky per-robot parking mode (see MPCConfig.escape).

    A robot enters parking mode when the solver hands it a ~zero control while
    it still carries pose error (the nonholonomic saddle), and *stays* in it
    until the error clears — handing control straight back to the myopic MPC
    would just rotate the robot back onto the saddle. The parking law is the
    classic polar controller: turn to the goal bearing, drive, then align the
    goal heading. Returns (blended control, updated flags).

    Deadlock breaking (round 3): a robot that is saddle-stalled WITHOUT the
    1.5x-dmin clearance the parking law requires used to simply freeze — a
    stable mutual block (e.g. two robots parked at the keep-out ring, each
    occluding the other's goal approach) persisted forever in a deterministic
    plant. The reference escapes such states only via Gazebo process noise
    (SURVEY.md §0). Here blocked robots RETREAT: drive along the current
    heading with v = c*cos(delta_away) toward the inverse-square repulsion
    bearing of nearby robots, so d(min dist)/dt ∝ cos² ≥ 0 — retreat can only
    open separation, never close it. Once the clearance gate opens, the
    normal parking law (or the MPC) resumes.

    Retreat requires the blocked stall to PERSIST for
    `mpc.escape_stall_steps` consecutive steps. The discriminator matters:
    a robot yielding mid-crossing stalls transiently (a few steps) and must
    be left alone — retreating it destabilizes the compute-delay hardware
    crossing (both an immediate and a latched retreat were tried and failed
    test_delay_closed_loop_six_robot_hw_config) — while a true mutual block
    stalls forever. Once triggered, retreat persists until the gate opens
    (a single pulse per K steps would never unwind the block).

    The carried per-robot escape state is an int32: >= _ESC_LATCH while the
    parking law is engaged, else the packed pair of stall counters
    (cnt_creep * _CNT_BASE + cnt_hard — see the encoding note at
    _ESC_LATCH)."""
    m = ocp.m
    pose = x[: 3 * m].reshape(m, 3)
    gpos = goal[: 3 * m].reshape(m, 3)
    ex, ey = gpos[:, 0] - pose[:, 0], gpos[:, 1] - pose[:, 1]
    dist = jnp.hypot(ex, ey)
    bearing = jnp.arctan2(ey, ex)
    delta = _wrap_angle(bearing - pose[:, 2])
    # RAW goal-heading error, deliberately unwrapped: the stop criterion is
    # the reference-faithful raw theta difference, so the alignment branch
    # must drive theta to the goal's RAW value — a wrapped dth sends a robot
    # whose |raw error| > pi the "short way" to goal +- 2pi, a state the
    # stop norm counts as a full turn of error (found by the round-5 fuzz:
    # the law wound theta to goal + 2pi, unlatched on its wrapped err_i,
    # and left the MPC a full unwinding turn). For every reference config
    # raw == wrapped at the latch point (goal/start headings within pi);
    # only adversarial geometries differ. The bearing error `delta` stays
    # wrapped — a bearing is only defined mod 2pi.
    dth = gpos[:, 2] - pose[:, 2]
    err_i = jnp.sqrt(dist * dist + dth * dth)

    tol = mpc.stop_tol if tol is None else tol
    thresh = tol / jnp.sqrt(jnp.asarray(float(m), x.dtype))
    u_mpc = u0.reshape(m, 2)
    latch_prev = esc_flags >= _ESC_LATCH
    raw_cnt = jnp.where(latch_prev, 0, esc_flags)
    cnt_hard = raw_cnt % _CNT_BASE        # retreat's blocked-stall counter
    cnt_creep = raw_cnt // _CNT_BASE      # creep-parking debounce counter
    u_inf = jnp.max(jnp.abs(u_mpc), axis=-1)
    # Two stall notions (round 4):
    #   * hard stall (u below escape_block_u_tol = 1e-3): a true stationary
    #     point — triggers parking IMMEDIATELY at any distance (the round-3
    #     semantics the single-robot saddle and the crossing standoffs rely
    #     on) and is the only notion the retreat counter sees.
    #   * creep stall (u below escape_u_tol = 0.02): the solver inching at
    #     a stay-put basin — triggers parking only after it PERSISTS
    #     escape_stall_steps consecutive steps. The discriminator is
    #     persistence, not distance: a noisy slow yield mid-crossing dips
    #     under the tolerance for a step or two and must be left to the
    #     MPC (measured: immediate creep-parking latched the sticky polar
    #     law mid-approach on the six-robot noise run, wound robots by
    #     full turns, and the raw-angle stop criterion never fired), while
    #     a true stay-put basin (two_robot_swap endgame, oracle-confirmed)
    #     creeps forever and is correctly caught.
    K = mpc.escape_stall_steps
    stalled_hard = (u_inf < mpc.escape_block_u_tol) & (err_i > 0.7 * thresh)
    creep = (u_inf < mpc.escape_u_tol) & (err_i > 0.7 * thresh) & (~done)
    persist = creep & (cnt_creep + 1 >= K)
    # Hysteresis on the creep debounce (round 5, found by the fuzz suite):
    # under odometry/process noise a basin-stalled solver DITHERS around the
    # creep threshold (measured on a random m=4 near-antipodal geometry:
    # median u_inf 0.02-0.06, longest consecutive sub-tol run 5-14 steps vs
    # the required K=10), so a hard reset-on-any-active-step kept the
    # counter at zero forever and the loop hovered at the stay-put basin
    # for 600+ steps. The counter now climbs below escape_u_tol, HOLDS in
    # the dither band [tol, 2*tol), and resets only at clearly-active
    # controls (>= 2*tol). Mid-crossing yields still reset: crossing
    # controls sit well above 2*tol, and a false-positive latch is gated by
    # clearance anyway (esc = cand & clear).
    active = u_inf >= 2.0 * mpc.escape_u_tol
    cnt_creep_new = jnp.where(
        creep, jnp.minimum(cnt_creep + 1, K),
        jnp.where(active, 0, cnt_creep))
    cand = (latch_prev | stalled_hard | persist) & (err_i > 0.35 * thresh) & (~done)

    v_hi = ocp.u_hi[0 :: 2][:m]
    w_hi = ocp.u_hi[1 :: 2][:m]
    # Absolute 2 cm position deadband on the bearing-chasing branch: the
    # relative gate alone (0.35*thresh = stop_tol * 0.35/sqrt(m), 1.4 cm at
    # m=6) sits below odometry-noise scale, and the bearing to a goal a
    # centimeter away flips direction with every noisy latch — measured on
    # the six-robot noise run: parked robots spin-chased the jittering
    # bearing at saturated omega, winding theta by full turns (joint err
    # 13 with all positions within 1.6 cm). Inside the deadband the law
    # only aligns the goal heading; the sub-2cm position residual is far
    # inside every reference stop tolerance.
    far = dist > jnp.maximum(0.35 * thresh, 0.02)
    # Deadbeat caps: never move/rotate more than the remaining error in one
    # control period. Without the cap, w_hi*T (0.57 rad at the headline's
    # T=0.2) overshoots the alignment every step; near the +-pi boundary
    # the overshoot re-wraps and the law can wind theta by full turns —
    # measured on the noisy six-robot endgame: three robots settled aligned
    # but exactly 2*pi off, and the (reference-faithful, raw-angle) stop
    # criterion never fired.
    #
    # Axis alignment + signed drive (round 5, found by the fuzz suite): the
    # old far branch chased the full bearing (up to pi of rotation) and only
    # drove once |delta| < 1. Near the deadband boundary that circulates:
    # the deadbeat drive can land past the goal, the bearing flips ~pi, the
    # chase re-rotates the same way — measured winding theta by 2+ full
    # turns on noisy random geometries (max |theta| 11.8). The classic
    # polar form kills the cycle structurally: align the AXIS (the nearer
    # of bearing / bearing+pi — never more than pi/2 of rotation, reverse
    # gear covered by the signed cos below), and drive v = gain*dist*cos(
    # delta) capped at dist*|cos(delta)|/T — one algebra line shows the
    # post-step distance is <= dist*|sin(delta)|, i.e. monotonically
    # non-increasing: no overshoot, no flip, no circulation.
    T_e = ocp.T
    gear = jnp.where(jnp.abs(delta) <= 0.5 * jnp.pi, 1.0, -1.0)
    delta_ax = _wrap_angle(delta - (1.0 - gear) * 0.5 * jnp.pi)
    cosd = jnp.cos(delta)
    v_cap = jnp.minimum(v_hi, dist * jnp.abs(cosd) / T_e)
    w_cap_d = jnp.minimum(w_hi, jnp.abs(delta_ax) / T_e)
    w_cap_t = jnp.minimum(w_hi, jnp.abs(dth) / T_e)
    v = jnp.where(far,
                  jnp.clip(mpc.escape_gain * dist * cosd, -v_cap, v_cap),
                  0.0)
    w = jnp.where(far, jnp.clip(mpc.escape_gain * delta_ax, -w_cap_d, w_cap_d),
                  jnp.clip(mpc.escape_gain * dth, -w_cap_t, w_cap_t))
    u_esc = jnp.stack([v, w], axis=-1)

    if ocp.n_pairs or ocp.n_obs:
        # The parking law knows nothing about collision/obstacle rows, so it
        # may only drive a robot with clearance: a multi-robot standoff at
        # the dmin ring (e.g. the myopic eight-robot N=5 config) must stay a
        # standoff, not a push-through, and a single robot creep-stalled at
        # an obstacle standoff must not latch a goal-bearing chase through
        # the keep-out (advisor round 4: families H1-H3 are m=1 with
        # n_pairs=0, so the gate must arm on n_obs alone). 1.5x the keep-out
        # scale keeps a full stopping margin.
        pos2 = pose[:, :2]
        if ocp.n_pairs:
            diff = pos2[:, None] - pos2[None]  # [m, m, 2]: row i minus others
            d2 = jnp.sum(diff**2, axis=-1) + jnp.eye(m, dtype=x.dtype) * 1e9
            gate = 1.5 * jnp.sqrt(ocp.dmin2)
        else:
            diff = jnp.zeros((m, 0, 2), x.dtype)
            d2 = jnp.zeros((m, 0), x.dtype)
            # no pair rows: the keep-out scale is the obstacle surface
            # margin plus the robot's own radius of maneuvering slack
            # (surface distances below already subtract r_obs + r_robot)
            gate = 1.5 * (ocp.robot_radius + ocp.obs_margin)
        if ocp.n_obs:
            # Static obstacles join the clearance gate and the repulsion sum
            # as phantom neighbors at their centers, with the surface
            # distance (center distance minus both radii) standing in for
            # the robot-robot distance — otherwise a blocked robot could
            # retreat straight into an obstacle keep-out region.
            odiff = pos2[:, None] - ocp.obstacles[None, :, :2]  # [m, n_obs, 2]
            od = jnp.sqrt(jnp.sum(odiff**2, axis=-1))
            od_eff = jnp.maximum(
                od - ocp.obstacles[None, :, 2] - ocp.robot_radius, 1e-3)
            diff = jnp.concatenate([diff, odiff], axis=1)
            d2 = jnp.concatenate([d2, od_eff**2], axis=1)
        mind_i = jnp.sqrt(jnp.min(d2, axis=1))
        clear = mind_i > gate
        esc = cand & clear  # sticky parking latch, pre-retreat semantics
        # Hard-stalled WITHOUT clearance: count consecutive blocked steps;
        # after escape_stall_steps of them it is a mutual block, not a
        # transient yield — back out along the repulsion bearing instead of
        # freezing (docstring). Retreat persists until the gate opens.
        blocked = stalled_hard & (err_i > 0.35 * thresh) & (~done) & (~clear)
        retreating_prev = cnt_hard >= K
        retreat = ((~clear) & (~done) & (err_i > 0.35 * thresh)
                   & (retreating_prev | (blocked & (cnt_hard + 1 >= K))))
        cnt_hard_new = jnp.where(
            retreat, K,
            jnp.where(blocked, jnp.minimum(cnt_hard + 1, K - 1), 0))
        away = jnp.sum(diff / (d2[..., None] ** 1.5), axis=1)
        beta_away = jnp.arctan2(away[:, 1], away[:, 0])
        d_away = _wrap_angle(beta_away - pose[:, 2])
        # speed ramps with how far inside the gate the robot sits; signed
        # cos projects onto the heading so reverse gear is used when the
        # robot faces the crowd — either way distance is non-decreasing.
        v_ret = jnp.clip(mpc.escape_gain * (1.1 * gate - mind_i), 0.0, 0.5 * v_hi)
        # same deadbeat rotation cap as the parking law (no winding)
        w_cap_r = jnp.minimum(w_hi, jnp.abs(d_away) / ocp.T)
        u_ret = jnp.stack(
            [v_ret * jnp.cos(d_away),
             jnp.clip(mpc.escape_gain * d_away, -w_cap_r, w_cap_r)],
            axis=-1)
        u = jnp.where(esc[:, None], u_esc, u_mpc)
        u = jnp.where(retreat[:, None], u_ret, u).reshape(2 * m)
        return u, jnp.where(esc, _ESC_LATCH,
                            cnt_creep_new * _CNT_BASE + cnt_hard_new)

    u = jnp.where(cand[:, None], u_esc, u_mpc).reshape(2 * m)
    return u, jnp.where(cand, _ESC_LATCH, cnt_creep_new * _CNT_BASE)


def _wrap_yaw_state(ocp: OCP, x):
    """Reference modify() semantics: wrap each robot's measured yaw to
    [0, 2pi) before the solve (mpc_online_casadi.py:28-33). Ray states (if
    any) are untouched. Physically a no-op (the unicycle is 2pi-periodic in
    theta) but it keeps the theta tracking error bounded on long runs."""
    from nmpc_tpu.sim.frames import wrap_to_2pi

    idx = jnp.arange(3 * ocp.m) % 3 == 2
    if ocp.num_rays:
        idx = jnp.concatenate([idx, jnp.zeros((ocp.num_rays,), bool)])
    return jnp.where(idx, wrap_to_2pi(x), x)


def _min_pair_dist(ocp: OCP, x):
    if ocp.n_pairs == 0:
        return jnp.asarray(jnp.inf, x.dtype)
    return jnp.sqrt(jnp.min(P.pairwise_sq_distances(ocp, x)))


def _scan_loop(ocp_t: OCP, step_fn, carry0, mpc: MPCConfig, done_idx=2):
    carryF, ys = jax.lax.scan(step_fn, carry0, jnp.arange(mpc.max_steps))
    doneF, stepsF = carryF[done_idx], carryF[done_idx + 1]
    xs_hist, u_hist, err, cost, viol, iters, mind, goal_hist = ys
    X_hist = jnp.concatenate([carry0[0][None], xs_hist], axis=0)
    min_dist = jnp.concatenate(
        [_min_pair_dist(ocp_t, carry0[0])[None], mind], axis=0
    )
    return MPCResult(
        X_hist=X_hist,
        U_hist=u_hist,
        err_hist=err,
        cost_hist=cost,
        viol_hist=viol,
        iter_hist=iters,
        min_dist_hist=min_dist,
        steps_used=stepsF,
        reached=doneF,
        goal_idx_hist=goal_hist,
    )


def closed_loop(
    ocp: OCP,
    solver_cfg: ALILQRConfig = ALILQRConfig(),
    mpc: MPCConfig = MPCConfig(),
    plant: PlantConfig = PlantConfig(),
    warm: WarmStart | None = None,
    key: jax.Array | None = None,
    solve_fn=None,
) -> MPCResult:
    """Point stabilization: run MPC until ||x - xs|| <= stop_tol (masked).
    Pass `key` to enable the plant's noise models (Gazebo stand-in).
    solve_fn(ocp, warm) overrides the NLP engine (e.g. the condensed GN
    solver with move blocking); defaults to AL-iLQR with solver_cfg."""
    _solve = solve_fn or (lambda o, w: solve(o, w, solver_cfg))
    goal = ocp.xref[-1]
    warm0 = cold_start(ocp, solver_cfg) if warm is None else warm

    def step(carry, k):
        x, meas, w, done, steps, gidx, esc, u_prev = carry
        # explicit measurement latch (SURVEY.md §5.2): the solve runs on the
        # latched odometry `meas` (which carries odom_noise when enabled),
        # while the plant advances the TRUE state x — min_dist/safety are
        # always evaluated on the true state
        if mpc.wrap_yaw:
            # wrap both the measurement (what the solver sees — the
            # reference's modify() on odometry) and the true state (a
            # physical no-op that keeps recorded trajectories in [0, 2pi))
            meas = _wrap_yaw_state(ocp, meas)
            x = _wrap_yaw_state(ocp, x)
        err = jnp.linalg.norm(meas - goal)
        done = done | (err <= mpc.stop_tol)
        meas_solve = meas
        if mpc.delay and mpc.delay_compensate:
            # predict the latch one period forward under the in-flight
            # control so the plan starts where its first control will land
            meas_solve = P.step_dynamics(ocp, meas, u_prev)
        ocp_k = dataclasses.replace(ocp, x0=meas_solve)
        res = _solve(ocp_k, w)
        ok = jnp.isfinite(res.cost) & jnp.all(jnp.isfinite(res.U)) & (
            res.viol < mpc.viol_fallback
        )
        res = jax.tree.map(lambda new, old: jnp.where(ok, new, old),
                           res, dataclasses.replace(res, U=w.U, lam=w.lam))
        u0 = jnp.where(done, 0.0, res.U[0])
        if mpc.escape:
            u0, esc = _escape_control(ocp, mpc, meas, goal, u0, esc, done)
        if mpc.delay:
            # one-period actuation delay (MPCConfig.delay): the plant
            # advances under the PREVIOUS solve's control while this solve's
            # lands next period — the reference's deployment timing
            u_apply, u_prev = u_prev, u0
            u_apply = jnp.where(done, 0.0, u_apply)
        else:
            u_apply = u0
        step_key = None if key is None else jax.random.fold_in(key, k)
        x_next, odom_next = plant_step(x, u_apply, ocp.T, plant, step_key)
        x_next = jnp.where(done, x, x_next)
        odom_next = jnp.where(done, meas, odom_next)
        w_next = jax.tree.map(
            lambda a, b: jnp.where(done, a, b), w, shift_warm(res, solver_cfg, mpc.mu_reset, mpc.lam_decay)
        )
        steps = steps + jnp.where(done, 0, 1)
        out = (x_next, u_apply, err, res.cost, res.viol, res.inner_iters,
               _min_pair_dist(ocp, x_next), gidx)
        return (x_next, odom_next, w_next, done, steps, gidx, esc, u_prev), out

    carry0 = (ocp.x0, ocp.x0, warm0, jnp.zeros((), bool),
              jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
              escape_state0(ocp.m), jnp.zeros((ocp.nu,), ocp.x0.dtype))
    return _scan_loop(ocp, step, carry0, mpc, done_idx=3)


def rt_closed_loop(
    ocp: OCP,
    # The mu_init=100 seed lever is deliberately NOT the default: seeding
    # the rt chain at mu_init=100 cuts the headline six-robot iters/step
    # by 14% at unchanged realized clearance — but the
    # stiffer seed's carried duals STALL ARRIVAL on harder maneuvers
    # (six_robot_impl hexagon: reached 72 steps at mu10 vs hung at err 1.36
    # by 120 steps at mu100; eight-robot N=25 swap: 227 steps vs hung at
    # 0.96 by 250). The lever is config-dependent: cash it per deployment
    # by passing full_cfg=ALILQRConfig(n_outer=6, n_inner=12, mu_init=100)
    # after validating arrival on the target scenario.
    full_cfg: ALILQRConfig = ALILQRConfig(n_outer=6, n_inner=12),
    # the pinned deployment recipe (tests/test_rt_mode.py): 3x10 carried-mu
    # solves. This loop drives the per-scenario engine, whose line search
    # is the alpha cascade (cfg.ls is consumed only by the batch-native
    # engine); the adaptive-LS rt variant is available by passing
    # solve_fn=solve_one with ls='adaptive' (tools/gen_latency.py measures
    # it at B=1)
    rt_cfg: ALILQRConfig = ALILQRConfig(n_outer=3, n_inner=10, tol_con=1e-3),
    mpc: MPCConfig = MPCConfig(),
    plant: PlantConfig = PlantConfig(),
    key: jax.Array | None = None,
    solve_fn=None,
) -> MPCResult:
    """Closed loop in the real-time recipe: ONE full-strength solve seeds the
    multipliers/penalty, then every control period runs the reduced-iteration
    rt config warm-started with carried mu (mu_reset is forced off — resetting
    mu under carried lam is the drift failure mode, see steady_warm). This is
    the per-step-budget deployment mode: the rt config caps the solve at
    3x10 iterations where the full one allows 6x12."""
    res0 = solve(ocp, cold_start(ocp, full_cfg), full_cfg)
    warm = shift_warm(res0, rt_cfg, mu_reset=False, lam_decay=mpc.lam_decay)
    mpc_rt = dataclasses.replace(mpc, mu_reset=False)
    return closed_loop(ocp, solver_cfg=rt_cfg, mpc=mpc_rt, plant=plant,
                       warm=warm, key=key, solve_fn=solve_fn)


def closed_loop_waypoints(
    ocp: OCP,
    waypoints: jax.Array,  # [G, nx] goal sequence
    solver_cfg: ALILQRConfig = ALILQRConfig(),
    mpc: MPCConfig = MPCConfig(),
    plant: PlantConfig = PlantConfig(),
    solve_fn=None,
) -> MPCResult:
    """Goal-sequence tour: advance to the next waypoint when the full-pose
    error drops below advance_tol; stop after the last waypoint."""
    _solve = solve_fn or (lambda o, w: solve(o, w, solver_cfg))
    G = waypoints.shape[0]

    def step(carry, _):
        x, w, done, steps, gidx, esc = carry
        goal = waypoints[jnp.minimum(gidx, G - 1)]
        err = jnp.linalg.norm(x - goal)
        advance = (err < mpc.advance_tol) & (~done)
        gidx = gidx + advance.astype(jnp.int32)
        esc = jnp.where(advance, 0, esc)  # new goal -> leave parking mode
        done = done | (gidx >= G)
        goal = waypoints[jnp.minimum(gidx, G - 1)]
        # waypoint goals are poses; pad ray states with zero reference
        goal_full = goal if goal.shape[0] == ocp.nx else jnp.concatenate(
            [goal, jnp.zeros((ocp.nx - goal.shape[0],), goal.dtype)]
        )
        ocp_k = dataclasses.replace(
            ocp, x0=x, xref=jnp.tile(goal_full[None, :], (ocp.N, 1))
        )
        res = _solve(ocp_k, w)
        u0 = jnp.where(done, 0.0, res.U[0])
        if mpc.escape:
            u0, esc = _escape_control(ocp, mpc, x, goal_full, u0, esc, done, tol=mpc.advance_tol)
        x_next, _ = plant_step(x, u0, ocp.T, plant)
        x_next = jnp.where(done, x, x_next)
        w_next = jax.tree.map(
            lambda a, b: jnp.where(done, a, b), w, shift_warm(res, solver_cfg, mpc.mu_reset, mpc.lam_decay)
        )
        steps = steps + jnp.where(done, 0, 1)
        out = (x_next, u0, err, res.cost, res.viol, res.inner_iters,
               _min_pair_dist(ocp, x_next), gidx)
        return (x_next, w_next, done, steps, gidx, esc), out

    warm0 = cold_start(ocp, solver_cfg)
    carry0 = (ocp.x0, warm0, jnp.zeros((), bool), jnp.zeros((), jnp.int32),
              jnp.zeros((), jnp.int32), escape_state0(ocp.m))
    return _scan_loop(ocp, step, carry0, mpc)


def closed_loop_tracking(
    ocp: OCP,
    ref_fn,  # jittable: t (scalar) -> [N, nx] stage reference
    solver_cfg: ALILQRConfig = ALILQRConfig(),
    mpc: MPCConfig = MPCConfig(),
    plant: PlantConfig = PlantConfig(),
    solve_fn=None,
) -> MPCResult:
    """Trajectory tracking: the stage reference is regenerated every control
    period from `ref_fn(t)` — the reference rebuilds Xref from wall-clock time
    each step (mpc_control_trajectory_tracking.py:126-127). Runs for
    max_steps (no convergence exit; tracking never 'arrives')."""

    def step(carry, k):
        x, w, done, steps, gidx = carry
        t = k.astype(x.dtype) * ocp.T
        xref = ref_fn(t)
        ocp_k = dataclasses.replace(ocp, x0=x, xref=xref)
        res = (solve_fn or (lambda o, w_: solve(o, w_, solver_cfg)))(ocp_k, w)
        u0 = res.U[0]
        x_next, _ = plant_step(x, u0, ocp.T, plant)
        err = jnp.linalg.norm(x - xref[0])
        w_next = shift_warm(res, solver_cfg, mpc.mu_reset, mpc.lam_decay)
        out = (x_next, u0, err, res.cost, res.viol, res.inner_iters,
               _min_pair_dist(ocp, x_next), gidx)
        return (x_next, w_next, done, steps + 1, gidx), out

    warm0 = cold_start(ocp, solver_cfg)
    carry0 = (ocp.x0, warm0, jnp.zeros((), bool), jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    return _scan_loop(ocp, step, carry0, mpc)


def plan_then_replay(
    ocp: OCP,
    solver_cfg: ALILQRConfig = ALILQRConfig(),
    mpc: MPCConfig = MPCConfig(),
    plant: PlantConfig = PlantConfig(),
):
    """casadi_test_mpc.py semantics: converge the MPC offline against the
    model (shift() integrates the model instead of reading odometry), then
    replay the stored u_cl through the (possibly different) plant at period T.
    Returns (offline MPCResult, replayed X trajectory)."""
    offline = closed_loop(ocp, solver_cfg, mpc, PlantConfig())

    def replay_step(x, u):
        x_next, _ = plant_step(x, u, ocp.T, plant)
        return x_next, x_next

    _, X_replay = jax.lax.scan(replay_step, ocp.x0, offline.U_hist)
    X_replay = jnp.concatenate([ocp.x0[None], X_replay], axis=0)
    return offline, X_replay
