"""Generate docs/PARITY.md: open-loop solver parity vs the scipy oracle.

For each reference configuration we solve the same multiple-shooting NLP with
(a) the engine (AL-iLQR; condensed GN for the Nc-blocked LiDAR v4) and
(b) the condensed SLSQP oracle (tests/oracle.py — the reference's own
family-A solver, float64, exact hand-coded sensitivities, independent code
path), then report BOTH parity gaps:

  * raw gap   — vs the best multi-start cold oracle solve (how our optimum
    compares to what the oracle finds on its own; the problems are nonconvex,
    so a large raw gap with `ours<orc` means we found the better basin);
  * polished gap — vs the oracle seeded at our solution (small = our
    solution is a KKT point of the reference NLP at f64).

Round 2: horizons are the UNSHRUNK published configs (N=100/70/35/20 —
mpc_online_casadi_tb3_*.py), the oracle gained position-box and
static-obstacle rows (family H) and a LiDAR-augmented variant (family I),
and the cold oracle is multi-started.

Run: python tools/gen_parity.py   (CPU, ~30-60 min at full horizons)
"""

import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import jax

jax.config.update("jax_platforms", "cpu")

import dataclasses

import numpy as np

from nmpc_tpu.scenarios import get
from nmpc_tpu.solver.alilqr import ALILQRConfig, solve
from oracle import solve_oracle, solve_oracle_lidar

# Round 3: the alpha grid extends to 1e-5. The round-2 parity outliers
# (two_robot_swap 4.6e-3, obstacle_scenario_1 2.8e-3) were NOT bad basins —
# the engine stalled at non-stationary points (merit-gradient norm ~2e2)
# because stiff AL box rows at mu_max need line-search steps below the old
# 1e-3 alpha floor. With the deep grid both land on the f64 oracle optimum.
DEEP_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.001,
               3e-4, 1e-4, 3e-5, 1e-5)
TIGHT = ALILQRConfig(tol_cost=1e-9, n_inner=60, n_outer=20, tol_con=1e-5,
                     alphas=DEEP_ALPHAS)
# The deep grid is load-bearing on the stiff-AL cases (two_robot_swap,
# obstacle_scenario_1) but can CREEP on easy long-horizon ones: on tb3_2
# (N=200, boxes only) it accepts micro-steps that big steps' Armijo
# failures would have skipped, burning 133 inner iterations to stop 1.1e-4
# short of the optimum the standard grid reaches in 54. The engine solve is
# therefore a two-config best-of (the oracle side is multi-started; giving
# the engine its two standard configs is the symmetric treatment).
TIGHT_STD = dataclasses.replace(TIGHT, alphas=ALILQRConfig().alphas)


def engine_solve(ocp):
    """Best feasible result over the deep- and standard-grid configs.

    The reported time is the WARM per-solve wall clock (compile excluded:
    each config is run once to compile, then timed on a second call),
    host dispatch of the blocking call included."""
    best = None
    t_warm = 0.0
    for cfg in (TIGHT, TIGHT_STD):
        f = jax.jit(functools.partial(solve, cfg=cfg))
        r = f(ocp)
        r.X.block_until_ready()          # compile + first execution
        t0 = time.time()
        r = f(ocp)
        r.X.block_until_ready()
        t_warm += time.time() - t0
        key = (float(r.viol) > 1e-5, float(r.cost))
        if best is None or key < best[0]:
            best = (key, r)
    return best[1], t_warm

# second oracle: scipy trust-constr (interior point — IPOPT's algorithm
# family). Run on every row whose raw SLSQP gap exceeds this, to confirm
# `ours<orc` claims against an independent method, and on all family-H rows
# (SLSQP active-set cycling caps out there; trust-constr does not).
TC_GAP_TRIGGER = 1e-4

# (scenario, N override or None = published horizon, oracle multi-starts)
CASES = [
    ("single_robot", None, 1),      # N=50   (mpc_online_casadi.py:57)
    ("tb3_2", None, 1),             # N=200  (mpc_online_casadi_tb3_2.py:57)
    ("two_robot_swap", None, 2),    # N=100  (...two_centralized...py:81)
    ("two_robot_centralized", None, 1),  # N=50
    ("five_robot", None, 2),        # N=70   (...multi_centralized...py:116)
    ("six_robot_antipodal", None, 4),    # N=35 (headline, :128)
    # family G: the hardware six-robot config (reduced limits, dmin=0.4 —
    # centralized_six_robots_implementation.py:197-205) — same NLP class as
    # family E, open-loop parity row closes VERDICT r2 missing #4
    ("six_robot_impl", None, 2),
    ("eight_robot", None, 1),       # N=5
    ("ten_robot", None, 2),         # N=20   (...ten...py:170)
]

# round 3: published N=100 horizons (first_scenario_mpc_obstacle_avoidance
# .py:58-59 et al.), oracled by trust-constr (SLSQP cycles at 900+ rows)
OBSTACLE_CASES = [
    ("obstacle_scenario_1", None, 1),
    ("obstacle_scenario_2", None, 1),
    ("obstacle_scenario_3", None, 1),
]


def row_dict(name, sc, ocp, cost_ours, viol, t_ours, cost_o, cost_p, polish,
             t_orc, cost_tc=None):
    raw = abs(cost_ours - cost_o) / (1 + abs(cost_o))
    pol = abs(cost_ours - cost_p) / (1 + abs(cost_p))
    return dict(
        name=name, m=sc.m, N=ocp.N, cost_ours=cost_ours, cost_oracle=cost_o,
        raw_gap=raw, cost_polished=cost_p, pol_gap=pol,
        better=cost_ours < cost_o - 1e-6,
        viol=viol, polish=polish, t_ours=t_ours, t_orc=t_orc, cost_tc=cost_tc,
    )


def run_family_e(rows):
    for name, N_over, starts in CASES:
        sc = get(name)
        ocp = sc.make() if N_over is None else sc.make(N=N_over)
        res, t_ours = engine_solve(ocp)
        x0 = np.array(ocp.x0, float)
        xs = np.array(ocp.xref[-1], float)
        dmin = float(np.sqrt(float(ocp.dmin2))) if sc.collision else 0.0
        t0 = time.time()
        U_o, X_o, cost_o = solve_oracle(
            x0, xs, ocp.N, float(ocp.T), dmin=dmin,
            v_max=sc.v_max, omega_max=sc.omega_max, maxiter=400,
            n_starts=starts,
        )
        t_orc = time.time() - t0
        U_ours = np.array(res.U, float)
        U_p, _, cost_p = solve_oracle(
            x0, xs, ocp.N, float(ocp.T), dmin=dmin,
            v_max=sc.v_max, omega_max=sc.omega_max, U0=U_ours, maxiter=400,
        )
        polish = np.abs(U_p - U_ours).max()
        cost_tc = None
        if abs(float(res.cost) - cost_o) / (1 + abs(cost_o)) > TC_GAP_TRIGGER:
            # time_budget bounds the interior-point cross-check: the m=6
            # N=35 KKT is ~2600 rows and unbudgeted trust-constr ran >1 h
            _, _, cost_tc = solve_oracle(
                x0, xs, ocp.N, float(ocp.T), dmin=dmin,
                v_max=sc.v_max, omega_max=sc.omega_max, maxiter=400,
                method="trust-constr", time_budget=420.0,
            )
        r = row_dict(name, sc, ocp, float(res.cost), float(res.viol), t_ours,
                     cost_o, cost_p, float(polish), t_orc, cost_tc)
        rows.append(r)
        print(f"{name}: ours {r['cost_ours']:.4f} oracle {cost_o:.4f} "
              f"polished {cost_p:.4f} raw {r['raw_gap']:.1e} pol {r['pol_gap']:.1e} "
              f"tc {cost_tc} dU {polish:.2e} viol {r['viol']:.1e} "
              f"({t_ours:.1f}s vs {t_orc:.1f}s)", flush=True)


def run_family_h(rows):
    for name, N_over, starts in OBSTACLE_CASES:
        sc = get(name)
        ocp = sc.make() if N_over is None else sc.make(N=N_over)
        res, t_ours = engine_solve(ocp)
        x0 = np.array(ocp.x0, float)
        xs = np.array(ocp.xref[-1], float)
        obstacles = [tuple(map(float, o)) for o in np.array(ocp.obstacles)]
        kw = dict(
            obstacles=obstacles, robot_radius=float(ocp.robot_radius),
            obs_margin=float(ocp.obs_margin),
            v_max=sc.v_max, omega_max=sc.omega_max, maxiter=400,
            method="trust-constr", time_budget=900.0,
        )
        t0 = time.time()
        U_o, X_o, cost_o = solve_oracle(x0, xs, ocp.N, float(ocp.T),
                                        n_starts=starts, **kw)
        t_orc = time.time() - t0
        U_ours = np.array(res.U, float)
        U_p, _, cost_p = solve_oracle(x0, xs, ocp.N, float(ocp.T),
                                      U0=U_ours, **kw)
        polish = np.abs(U_p - U_ours).max()
        r = row_dict(name, sc, ocp, float(res.cost), float(res.viol), t_ours,
                     cost_o, cost_p, float(polish), t_orc, cost_o)
        rows.append(r)
        print(f"{name}: ours {r['cost_ours']:.4f} oracle {cost_o:.4f} "
              f"polished {cost_p:.4f} raw {r['raw_gap']:.1e} pol {r['pol_gap']:.1e} "
              f"dU {polish:.2e} viol {r['viol']:.1e}", flush=True)


def run_family_i(rows):
    """LiDAR-augmented parity at the published configs: v3 (full horizon,
    AL-iLQR) and v4 (Nc=50 blocking, condensed GN). Frozen obstacle points
    are a synthetic scan: two rays struck a surface 0.9 m ahead-left, the
    rest at the 3.5 m cap (obs_avoid_static_first_scenario_v4.py:29-40)."""
    from nmpc_tpu.mpc.lidar import obstacle_points, ray_angles
    from nmpc_tpu.solver import gn

    import jax.numpy as jnp

    for name in ("lidar_v2", "lidar_v3", "lidar_v4"):
        sc = get(name)
        ocp = sc.make()
        R = sc.num_rays
        angles = ray_angles(R, jnp.float32)
        scan = np.full((R,), 3.5, np.float32)
        scan[1] = 0.9
        scan[2] = 1.1
        pose0 = np.asarray(sc.x0, np.float32)
        p_obs = obstacle_points(jnp.asarray(pose0), jnp.asarray(scan), angles)
        ocp = dataclasses.replace(
            ocp,
            p_obs=p_obs,
            x0=ocp.x0.at[3:].set(jnp.asarray(scan)),
        )
        if sc.Nc:
            cfg = gn.GNConfig(Nc=sc.Nc, n_gn=40, n_outer=12, tol_con=1e-5,
                              tol_cost=1e-9)
            f_eng = jax.jit(functools.partial(gn.solve, cfg=cfg))
        else:
            f_eng = jax.jit(functools.partial(solve, cfg=TIGHT))
        res = f_eng(ocp)
        res.X.block_until_ready()        # compile + first execution
        t0 = time.time()
        res = f_eng(ocp)
        res.X.block_until_ready()        # warm per-solve (incl. dispatch)
        t_ours = time.time() - t0
        t0 = time.time()
        U_o, X_o, cost_o = solve_oracle_lidar(
            pose0, np.array(ocp.xref[-1, :3], float), ocp.N, float(ocp.T),
            np.array(p_obs, float), scan.astype(float),
            ray_lo=float(ocp.x_lo[3]),
            inv_dist_weight=float(ocp.inv_dist_weight),
            Nc=sc.Nc, v_max=sc.v_max, omega_max=sc.omega_max,
        )
        t_orc = time.time() - t0
        U_ours = np.array(res.U, float)
        U_p, _, cost_p = solve_oracle_lidar(
            pose0, np.array(ocp.xref[-1, :3], float), ocp.N, float(ocp.T),
            np.array(p_obs, float), scan.astype(float),
            ray_lo=float(ocp.x_lo[3]),
            inv_dist_weight=float(ocp.inv_dist_weight),
            Nc=sc.Nc, v_max=sc.v_max, omega_max=sc.omega_max, U0=U_ours,
        )
        polish = np.abs(U_p - U_ours).max()
        cost_tc = None
        if abs(float(res.cost) - cost_o) / (1 + abs(cost_o)) > TC_GAP_TRIGGER:
            _, _, cost_tc = solve_oracle_lidar(
                pose0, np.array(ocp.xref[-1, :3], float), ocp.N, float(ocp.T),
                np.array(p_obs, float), scan.astype(float),
                ray_lo=float(ocp.x_lo[3]),
                inv_dist_weight=float(ocp.inv_dist_weight),
                Nc=sc.Nc, v_max=sc.v_max, omega_max=sc.omega_max,
                method="trust-constr",
            )
        r = row_dict(name, sc, ocp, float(res.cost), float(res.viol), t_ours,
                     cost_o, cost_p, float(polish), t_orc, cost_tc)
        rows.append(r)
        print(f"{name}: ours {r['cost_ours']:.4f} oracle {cost_o:.4f} "
              f"polished {cost_p:.4f} raw {r['raw_gap']:.1e} pol {r['pol_gap']:.1e} "
              f"tc {cost_tc} dU {polish:.2e} viol {r['viol']:.1e}", flush=True)


def write_doc(rows):
    os.makedirs("docs", exist_ok=True)
    with open("docs/PARITY.md", "w") as f:
        f.write(
            "# Solver parity vs the reference NLP (SLSQP + trust-constr oracles)\n\n"
            "Open-loop solves of the reference's own transcriptions at the\n"
            "UNSHRUNK published horizons. The oracle (tests/oracle.py) is\n"
            "float64 SLSQP on the condensed form with exact hand-coded\n"
            "sensitivities, multi-started on the hard nonconvex cases.\n\n"
            "Two gaps are reported separately:\n"
            "`raw gap` compares against the best cold multi-start oracle\n"
            "solve; `pol gap` against the oracle seeded at our solution\n"
            "(small = our solution is a KKT point of the reference NLP at\n"
            "f64). `ours<orc` marks cases where the engine found a\n"
            "*better* local optimum than every cold oracle start. `polish\n"
            "dU` = max control change under that seeded polish.\n\n"
            "`cost (ipm)` is a SECOND oracle — scipy trust-constr, an\n"
            "interior-point method (IPOPT's algorithm family) — run cold on\n"
            "every row whose raw SLSQP gap exceeds 1e-4 (confirming\n"
            "`ours<orc` against an independent method) and on all family-H\n"
            "rows, where it replaces SLSQP as the primary oracle (SLSQP's\n"
            "active set cycles on the 900+ obstacle rows of the published\n"
            "N=100 configs; trust-constr does not, so family H now runs at\n"
            "the full published horizon).\n\n"
            "Families: E/C (pairwise collision), H (static obstacles,\n"
            "published N=100, trust-constr oracle), I (LiDAR-augmented:\n"
            "v2/v3 full horizon on AL-iLQR, v4 Nc=50 move blocking on\n"
            "condensed GN).\n\n"
            "`solve s` times one WARM engine solve (compile excluded, host\n"
            "dispatch included) vs the oracle's full multi-start solve.\n\n"
            "| scenario | m | N | cost (ours) | cost (oracle) | raw gap | cost (polished) | pol gap | cost (ipm) | ours<orc | max viol | polish dU | warm solve s (ours/oracle) |\n"
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|\n"
        )
        for r in rows:
            f.write(
                f"| {r['name']} | {r['m']} | {r['N']} | {r['cost_ours']:.4f} | "
                f"{r['cost_oracle']:.4f} | {r['raw_gap']:.1e} | "
                f"{r['cost_polished']:.4f} | {r['pol_gap']:.1e} | "
                f"{'—' if r['cost_tc'] is None else format(r['cost_tc'], '.4f')} | "
                f"{'yes' if r['better'] else ''} | {r['viol']:.1e} | "
                f"{r['polish']:.2e} | {r['t_ours']:.2f} / {r['t_orc']:.1f} |\n"
            )


class _FlushingRows(list):
    """Rewrite docs/PARITY.md after every appended row so a long run killed
    mid-flight (trust-constr cases are minutes each) still leaves the
    completed rows on disk."""

    def append(self, r):
        super().append(r)
        write_doc(self)


def main():
    rows = _FlushingRows()
    run_family_e(rows)
    run_family_h(rows)
    run_family_i(rows)
    write_doc(rows)
    print(f"wrote docs/PARITY.md ({len(rows)} rows)")


if __name__ == "__main__":
    main()
