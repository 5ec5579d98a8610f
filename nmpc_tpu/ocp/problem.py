"""OCP definition: the multiple-shooting NMPC problem as a JAX pytree.

This is the JAX replacement for the reference's inline CasADi graph
construction (L2 of SURVEY.md §1): decision trajectory (X, U), stage cost
sum_k (x_k - xref_k)' Q (x_k - xref_k) + u_k' R u_k, explicit-Euler dynamics,
and the inequality set
  - pairwise squared-distance collision constraints d2_ij >= dmin^2 at
    stages k = 0..N-1, evaluated at X[:,k]
    (/root/reference/AllScripts/mpc_online_casadi_tb3_six_multi_centralized_collision_free.py:218-261,279-280)
  - circular static-obstacle constraints sqrt(d2) - r_rob - r_obs >= margin
    (/root/reference/AllScripts/first_scenario_mpc_obstacle_avoidance.py:125,150)
  - control and state box bounds (same file :148-150, six-robot file lbx/ubx)
  - LiDAR-augmented ray-distance states with lower bound d >= robot_radius and
    inverse-distance cost (1/d)' L (1/d)
    (/root/reference/AllScripts/obs_avoid_static_first_scenario_v4.py:67,123,135-136)

Design: instead of a symbolic graph, the problem is a dataclass pytree whose
*shapes* (m, N, n_obs, num_rays) are static — one XLA program per problem
class — while every numeric field (goals, weights, bounds, obstacle layout) is
a traced leaf, so scenario batches vmap/pjit over them with zero recompiles.
All constraints are canonicalized to c(x, u) >= 0 so the augmented-Lagrangian
solver treats them uniformly with a single fused masked-penalty kernel.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from nmpc_tpu.models.unicycle import discrete_dynamics

# A finite stand-in for +inf bounds: keeps AL arithmetic NaN-free while making
# the corresponding constraints permanently inactive.
BIG = 1e9


# Static (hashable) OCP fields — the compiled-program key. Single source of
# truth for every module that splits OCP leaves from metadata (vmap axis
# templates, batching helpers).
OCP_META = (
    "m", "N", "n_obs", "num_rays", "integrator", "collision", "n_mov",
    "dyn_fn", "nx_gen", "nu_gen", "substeps",
)


def num_pairs(m: int) -> int:
    return m * (m - 1) // 2


def pair_indices(m: int):
    """Static upper-triangle (i, j) index arrays, i < j, reference ordering
    d12, d13, ..., d1m, d23, ... (six-robot file :218-236)."""
    ii, jj = [], []
    for i in range(m):
        for j in range(i + 1, m):
            ii.append(i)
            jj.append(j)
    return tuple(ii), tuple(jj)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=(
        "T",
        "Qdiag",
        "Rdiag",
        "x0",
        "xref",
        "u_lo",
        "u_hi",
        "x_lo",
        "x_hi",
        "dmin2",
        "obstacles",
        "robot_radius",
        "obs_margin",
        "inv_dist_weight",
        "p_obs",
        "mov_obs",
    ),
    meta_fields=OCP_META,
)
@dataclasses.dataclass(frozen=True)
class OCP:
    """One NMPC problem instance (shapes static, values traced).

    Shapes: nx = 3m + num_rays, nu = 2m.
      T: scalar sampling time            Qdiag: [nx]      Rdiag: [nu]
      x0: [nx]                           xref: [N, nx] stage reference
      u_lo/u_hi: [nu]                    x_lo/x_hi: [nx]
      dmin2: scalar (squared min inter-robot distance)
      obstacles: [n_obs, 3] rows (ox, oy, r)
      p_obs: [num_rays, 2] frozen LiDAR obstacle points (augmented model)
    """

    # --- static metadata ---
    m: int
    N: int
    n_obs: int
    num_rays: int
    integrator: str
    collision: bool
    n_mov: int

    # --- traced data ---
    T: jax.Array
    Qdiag: jax.Array
    Rdiag: jax.Array
    x0: jax.Array
    xref: jax.Array
    u_lo: jax.Array
    u_hi: jax.Array
    x_lo: jax.Array
    x_hi: jax.Array
    dmin2: jax.Array
    obstacles: jax.Array
    robot_radius: jax.Array
    obs_margin: jax.Array
    inv_dist_weight: jax.Array
    p_obs: jax.Array
    # Per-stage moving obstacles [N, n_mov, 2] — neighbor plans in the
    # decentralized mode (SURVEY.md §2.4): each robot treats the other robots'
    # previously exchanged trajectories as time-indexed keep-out discs with
    # the same squared-distance bound dmin2 as the centralized pair rows.
    mov_obs: jax.Array

    # --- generic-dynamics hook (static; defaults keep the unicycle class) ---
    # The reference's CasADi layer accepts *any* symbolic dynamics — it solves
    # a Van der Pol OCP (AllScripts/mpc_pose_control_casadi.py:25-33) and a
    # first-order process model (AllScripts/mpc_test.py:22-32) with the same
    # machinery. dyn_fn is a user continuous-time RHS f(x, u) -> xdot; when
    # set, nx/nu come from nx_gen/nu_gen, the transcription integrates dyn_fn
    # (Euler or RK4 with `substeps` sub-intervals), Jacobians fall back to
    # jax.jacfwd, and the constraint set reduces to the u/x boxes (the robot
    # geometry rows require the stacked-unicycle layout). Callables hash by
    # identity: one compiled program per model function, like every other
    # meta field.
    dyn_fn: object = None
    nx_gen: int = 0
    nu_gen: int = 0
    substeps: int = 1

    @property
    def nx(self) -> int:
        if self.dyn_fn is not None:
            return self.nx_gen
        return 3 * self.m + self.num_rays

    @property
    def nu(self) -> int:
        if self.dyn_fn is not None:
            return self.nu_gen
        return 2 * self.m

    @property
    def n_pairs(self) -> int:
        return num_pairs(self.m) if self.collision else 0

    @property
    def n_con(self) -> int:
        """Inequality rows per stage (canonical c >= 0)."""
        return (
            self.n_pairs
            + self.m * self.n_obs
            + self.m * self.n_mov
            + 2 * self.nu
            + 2 * self.nx
        )


def default_weights(m: int, dtype=jnp.float32):
    """Per-robot Q = diag(1, 5, 0.1), R = diag(0.5, 0.05) — identical in every
    reference script (six-robot file :182-196)."""
    Q = jnp.tile(jnp.array([1.0, 5.0, 0.1], dtype), m)
    R = jnp.tile(jnp.array([0.5, 0.05], dtype), m)
    return Q, R


def make_ocp(
    *,
    m: int,
    N: int,
    T: float,
    x0,
    x_goal=None,
    xref=None,
    Qdiag=None,
    Rdiag=None,
    v_max: float = 0.22,
    omega_max: float = 2.84,
    pos_bound: float = 10.0,
    theta_bound: float = BIG,
    dmin: float = 0.0,
    collision: bool = False,
    obstacles=None,
    robot_radius: float = 0.1,
    obs_margin: float = 0.05,
    num_rays: int = 0,
    ray_lo: float = 0.15,
    ray_hi: float = 10.0,
    inv_dist_weight: float = 0.0,
    p_obs=None,
    mov_obs=None,
    integrator: str = "euler",
    dtype=jnp.float32,
) -> OCP:
    """Convenience constructor mirroring the knobs of the reference scripts."""
    nx_pose = 3 * m
    nx = nx_pose + num_rays
    nu = 2 * m
    x0 = jnp.asarray(x0, dtype).reshape(-1)
    if num_rays and x0.shape[0] == nx_pose:
        # seed ray states at the LiDAR range cap (Scan init 3.5 m, v4 :66)
        x0 = jnp.concatenate([x0, jnp.full((num_rays,), 3.5, dtype)])
    x0 = x0.reshape(nx)
    if xref is None:
        assert x_goal is not None, "need x_goal or xref"
        goal = jnp.asarray(x_goal, dtype).reshape(nx_pose)
        if num_rays:
            goal = jnp.concatenate([goal, jnp.zeros((num_rays,), dtype)])
        xref = jnp.tile(goal[None, :], (N, 1))
    else:
        xref = jnp.asarray(xref, dtype).reshape(N, nx)

    if Qdiag is None or Rdiag is None:
        Qd, Rd = default_weights(m, dtype)
        Qdiag = Qd if Qdiag is None else jnp.asarray(Qdiag, dtype)
        Rdiag = Rd if Rdiag is None else jnp.asarray(Rdiag, dtype)
    else:
        Qdiag, Rdiag = jnp.asarray(Qdiag, dtype), jnp.asarray(Rdiag, dtype)
    if num_rays and Qdiag.shape[0] == nx_pose:
        # ray states carry no tracking cost (v4: Q is 3x3 on the pose only)
        Qdiag = jnp.concatenate([Qdiag, jnp.zeros((num_rays,), dtype)])

    u_hi = jnp.tile(jnp.array([v_max, omega_max], dtype), m)
    x_hi_pose = jnp.tile(jnp.array([pos_bound, pos_bound, theta_bound], dtype), m)
    if num_rays:
        x_lo = jnp.concatenate([-x_hi_pose, jnp.full((num_rays,), ray_lo, dtype)])
        x_hi = jnp.concatenate([x_hi_pose, jnp.full((num_rays,), ray_hi, dtype)])
    else:
        x_lo, x_hi = -x_hi_pose, x_hi_pose

    n_obs = 0 if obstacles is None else len(obstacles)
    obstacles = (
        jnp.zeros((0, 3), dtype) if obstacles is None else jnp.asarray(obstacles, dtype).reshape(n_obs, 3)
    )
    p_obs = jnp.zeros((num_rays, 2), dtype) if p_obs is None else jnp.asarray(p_obs, dtype).reshape(num_rays, 2)
    if mov_obs is None:
        n_mov = 0
        mov_obs = jnp.zeros((N, 0, 2), dtype)
    else:
        mov_obs = jnp.asarray(mov_obs, dtype)
        n_mov = mov_obs.shape[1]

    return OCP(
        m=m,
        N=N,
        n_obs=n_obs,
        num_rays=num_rays,
        integrator=integrator,
        collision=collision and m > 1,
        n_mov=n_mov,
        T=jnp.asarray(T, dtype),
        Qdiag=Qdiag,
        Rdiag=Rdiag,
        x0=x0,
        xref=xref,
        u_lo=-u_hi,
        u_hi=u_hi,
        x_lo=x_lo,
        x_hi=x_hi,
        dmin2=jnp.asarray(dmin * dmin, dtype),
        obstacles=obstacles,
        robot_radius=jnp.asarray(robot_radius, dtype),
        obs_margin=jnp.asarray(obs_margin, dtype),
        inv_dist_weight=jnp.asarray(inv_dist_weight, dtype),
        p_obs=p_obs,
        mov_obs=mov_obs,
    )


def make_generic_ocp(
    f,
    *,
    nx: int,
    nu: int,
    N: int,
    T: float,
    x0,
    x_goal=None,
    xref=None,
    Qdiag=None,
    Rdiag=None,
    u_lo=None,
    u_hi=None,
    x_lo=None,
    x_hi=None,
    integrator: str = "rk4",
    substeps: int = 1,
    dtype=jnp.float32,
) -> OCP:
    """OCP over arbitrary user dynamics `f(x, u) -> xdot` — the capability of
    the reference's CasADi layer, which solves a Van der Pol OCP
    (AllScripts/mpc_pose_control_casadi.py:25-33,66-108) and a first-order
    process model (AllScripts/mpc_test.py:22-32) with the same machinery as
    the robot problems. The constraint set is the u/x boxes; cost is the
    diagonal tracking form. Solvable by the same AL-iLQR engine (Jacobians
    via jax.jacfwd)."""
    x0 = jnp.asarray(x0, dtype).reshape(nx)
    if xref is None:
        goal = (jnp.zeros((nx,), dtype) if x_goal is None
                else jnp.asarray(x_goal, dtype).reshape(nx))
        xref = jnp.tile(goal[None, :], (N, 1))
    else:
        xref = jnp.asarray(xref, dtype).reshape(N, nx)
    Qdiag = jnp.ones((nx,), dtype) if Qdiag is None else jnp.asarray(Qdiag, dtype).reshape(nx)
    Rdiag = jnp.ones((nu,), dtype) if Rdiag is None else jnp.asarray(Rdiag, dtype).reshape(nu)
    u_lo = jnp.full((nu,), -BIG, dtype) if u_lo is None else jnp.asarray(u_lo, dtype).reshape(nu)
    u_hi = jnp.full((nu,), BIG, dtype) if u_hi is None else jnp.asarray(u_hi, dtype).reshape(nu)
    x_lo = jnp.full((nx,), -BIG, dtype) if x_lo is None else jnp.asarray(x_lo, dtype).reshape(nx)
    x_hi = jnp.full((nx,), BIG, dtype) if x_hi is None else jnp.asarray(x_hi, dtype).reshape(nx)
    return OCP(
        m=1,
        N=N,
        n_obs=0,
        num_rays=0,
        integrator=integrator,
        collision=False,
        n_mov=0,
        T=jnp.asarray(T, dtype),
        Qdiag=Qdiag,
        Rdiag=Rdiag,
        x0=x0,
        xref=xref,
        u_lo=u_lo,
        u_hi=u_hi,
        x_lo=x_lo,
        x_hi=x_hi,
        dmin2=jnp.asarray(0.0, dtype),
        obstacles=jnp.zeros((0, 3), dtype),
        robot_radius=jnp.asarray(0.1, dtype),
        obs_margin=jnp.asarray(0.05, dtype),
        inv_dist_weight=jnp.asarray(0.0, dtype),
        p_obs=jnp.zeros((0, 2), dtype),
        mov_obs=jnp.zeros((N, 0, 2), dtype),
        dyn_fn=f,
        nx_gen=nx,
        nu_gen=nu,
        substeps=substeps,
    )


# ---------------------------------------------------------------------------
# Dynamics
# ---------------------------------------------------------------------------


def _integrate_generic(f, x, u, dt, integrator: str, substeps: int):
    """Fixed-step integration of a user RHS — the reference's hand-rolled RK4
    chain with M sub-intervals (mpc_pose_control_casadi.py:43-59)."""
    h = dt / substeps
    for _ in range(substeps):
        if integrator == "euler":
            x = x + h * f(x, u)
        elif integrator == "rk4":
            k1 = f(x, u)
            k2 = f(x + 0.5 * h * k1, u)
            k3 = f(x + 0.5 * h * k2, u)
            k4 = f(x + h * k3, u)
            x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        else:
            raise ValueError(f"unknown integrator {integrator!r}")
    return x


def step_dynamics(ocp: OCP, x: jax.Array, u: jax.Array) -> jax.Array:
    """One discrete step of the (possibly LiDAR-augmented) model."""
    if ocp.dyn_fn is not None:
        return _integrate_generic(
            ocp.dyn_fn, x, u, ocp.T, ocp.integrator, ocp.substeps
        )
    if ocp.num_rays == 0:
        return discrete_dynamics(x, u, ocp.T, ocp.integrator)
    # Augmented model (v4 semantics, obs_avoid_static_first_scenario_v4.py:128-133):
    # pose evolves by Euler; ray distance d_m propagates as the *1-norm*
    # distance from the next position to the frozen obstacle point p_obs[m].
    pose = x[:3]
    pose_next = discrete_dynamics(pose, u, ocp.T, "euler")
    delta = pose_next[None, :2] - ocp.p_obs  # [R, 2]
    d_next = jnp.sum(jnp.abs(delta), axis=-1)
    return jnp.concatenate([pose_next, d_next])


def rollout(ocp: OCP, U: jax.Array, x0=None) -> jax.Array:
    """Roll the controls through the dynamics: U [N, nu] -> X [N+1, nx]."""
    x0 = ocp.x0 if x0 is None else x0

    def body(x, u):
        xn = step_dynamics(ocp, x, u)
        return xn, xn

    _, X_tail = jax.lax.scan(body, x0, U)
    return jnp.concatenate([x0[None, :], X_tail], axis=0)


# ---------------------------------------------------------------------------
# Cost
# ---------------------------------------------------------------------------


def stage_cost(ocp: OCP, x: jax.Array, u: jax.Array, xref_k: jax.Array) -> jax.Array:
    """(x - xref)' Q (x - xref) + u' R u  [+ (1/d)' L (1/d) for ray states]."""
    dx = x - xref_k
    c = jnp.dot(dx * ocp.Qdiag, dx) + jnp.dot(u * ocp.Rdiag, u)
    if ocp.num_rays:
        inv_d = 1.0 / jnp.maximum(x[3:], 1e-3)
        c = c + ocp.inv_dist_weight * jnp.dot(inv_d, inv_d)
    return c


# ---------------------------------------------------------------------------
# Inequality constraints (canonical c(x, u) >= 0)
# ---------------------------------------------------------------------------


def pairwise_sq_distances(ocp: OCP, x: jax.Array) -> jax.Array:
    """All m(m-1)/2 squared planar distances, reference ordering."""
    ii, jj = pair_indices(ocp.m)
    pos = x[: 3 * ocp.m].reshape(ocp.m, 3)[:, :2]
    diff = pos[jnp.array(ii)] - pos[jnp.array(jj)]
    return jnp.sum(diff * diff, axis=-1)


def stage_constraints(ocp: OCP, x: jax.Array, u: jax.Array, mov_k: jax.Array | None = None) -> jax.Array:
    """Stack all per-stage inequalities as c >= 0; shape [n_con].

    mov_k: [n_mov, 2] positions of this stage's moving obstacles (neighbor
    plans in decentralized mode); defaults to stage 0's entries."""
    parts = []
    if ocp.n_pairs:
        parts.append(pairwise_sq_distances(ocp, x) - ocp.dmin2)
    if ocp.n_obs or ocp.n_mov:
        pos = x[: 3 * ocp.m].reshape(ocp.m, 3)[:, :2]  # [m, 2]
    if ocp.n_obs:
        delta = pos[:, None, :] - ocp.obstacles[None, :, :2]  # [m, n_obs, 2]
        dist = jnp.sqrt(jnp.maximum(jnp.sum(delta * delta, axis=-1), 1e-12))
        c_obs = dist - ocp.robot_radius - ocp.obstacles[None, :, 2] - ocp.obs_margin
        parts.append(c_obs.reshape(-1))
    if ocp.n_mov:
        mov_k = ocp.mov_obs[0] if mov_k is None else mov_k
        delta = pos[:, None, :] - mov_k[None, :, :]  # [m, n_mov, 2]
        d2 = jnp.sum(delta * delta, axis=-1)
        parts.append((d2 - ocp.dmin2).reshape(-1))
    parts.append(u - ocp.u_lo)
    parts.append(ocp.u_hi - u)
    parts.append(x - ocp.x_lo)
    parts.append(ocp.x_hi - x)
    return jnp.concatenate(parts)


def trajectory_constraints(ocp: OCP, X: jax.Array, U: jax.Array) -> jax.Array:
    """c_k for k = 0..N-1 evaluated at (X[k], U[k]); shape [N, n_con].

    Collision/obstacle rows are enforced at stages 0..N-1 and *not* at the
    terminal state — matching the reference's g-vector layout (stage-0 block
    padded with dummy constants; six-robot file :208,248-261)."""
    return jax.vmap(lambda x, u, mk: stage_constraints(ocp, x, u, mk))(
        X[:-1], U, ocp.mov_obs
    )


def x_dependent_rows(ocp: OCP):
    """Static bool [n_con]: rows that depend only on the state (not u).
    Order matches stage_constraints: pairs, obstacles, moving, u-box, x-box."""
    import numpy as _np

    return _np.concatenate([
        _np.ones(ocp.n_pairs, bool),
        _np.ones(ocp.m * ocp.n_obs, bool),
        _np.ones(ocp.m * ocp.n_mov, bool),
        _np.zeros(2 * ocp.nu, bool),
        _np.ones(2 * ocp.nx, bool),
    ])


def constraint_mask(ocp: OCP) -> jax.Array:
    """[N, n_con] 1/0 mask. Stage-0 state-only rows are masked out: X[:,0] is
    pinned to the measurement, so those rows are constants — penalizing them
    cannot change the solution but wrecks the violation metric and pins the
    penalty weight at its cap whenever the *measured* state is infeasible
    (e.g. a LiDAR ray already inside the safety shell). The reference's
    stage-0 dummy padding (six-robot file :208) plays the same role."""
    row0 = jnp.asarray(~x_dependent_rows(ocp), jnp.float32)
    mask = jnp.ones((ocp.N, ocp.n_con), jnp.float32)
    return mask.at[0].set(row0)


def masked_trajectory_constraints(ocp: OCP, X: jax.Array, U: jax.Array) -> jax.Array:
    """trajectory_constraints with masked rows forced far-feasible."""
    c = trajectory_constraints(ocp, X, U)
    return jnp.where(constraint_mask(ocp) > 0, c, BIG)


def al_penalty(c: jax.Array, lam: jax.Array, mu) -> jax.Array:
    """Powell-Hestenes-Rockafellar penalty for c >= 0, summed.

    The conventional PHR term is (max(0, lam - mu c)^2 - lam^2) / (2 mu); the
    -lam^2 part is constant in the decision variables, so we drop it — same
    minimizer, and the merit keeps full f32 resolution (subtracting a large
    constant would swamp line-search decrements in f32)."""
    act = jnp.maximum(0.0, lam - mu * c)
    return jnp.sum(act * act) / (2.0 * mu)


def max_violation(ocp: OCP, X: jax.Array, U: jax.Array) -> jax.Array:
    c = masked_trajectory_constraints(ocp, X, U)
    return jnp.maximum(0.0, -jnp.min(c))


def total_cost(ocp: OCP, X: jax.Array, U: jax.Array) -> jax.Array:
    """Reference objective: sum over k = 0..N-1 of stage costs (no terminal
    term; six-robot file :244 uses st = X[:,k], k < N)."""
    return jnp.sum(jax.vmap(lambda x, u, r: stage_cost(ocp, x, u, r))(X[:-1], U, ocp.xref))


def al_total_cost(ocp: OCP, X: jax.Array, U: jax.Array, lam: jax.Array, mu) -> jax.Array:
    c = masked_trajectory_constraints(ocp, X, U)
    return total_cost(ocp, X, U) + al_penalty(c, lam, mu)
