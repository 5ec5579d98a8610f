"""nmpc_tpu — a nonlinear MPC engine for multi-robot navigation in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
`asalimil/Nonlinear-MPC-for-collision-free-and-deadlock-free-navigation-of-
multiple-nonholonomic-mobile-robots` (Lafmejani & Berman, RAS 141:103774, 2021):
multiple-shooting NMPC for 1..10 unicycle robots with pairwise collision
constraints, static-obstacle constraints, and LiDAR-augmented states — solved by
a batched augmented-Lagrangian iLQR (Riccati) engine that is jit/vmap/pjit-able
end to end, instead of CasADi symbolic graphs + IPOPT.

Layer map (mirrors SURVEY.md §1/§7):
    models/    L0: unicycle dynamics, stacked multi-robot, LiDAR-augmented model
    ocp/       L2: OCP pytree, costs, inequality constraints, transcription
    solver/    L3: AL-iLQR + condensed Gauss-Newton NLP solvers (IPOPT repl.)
    ops/       structured linear algebra (MUMPS/KKT repl.)
    mpc/       L4: receding-horizon driver, warm-start shift, waypoints
    sim/       plant simulator (Gazebo replacement), SE(2) frames, LiDAR model
    parallel/  vmap/pjit scenario batching, mesh, decentralized ppermute mode
    scenarios/ frozen registry of every reference configuration
    io/        host bridge to real robots (C++ runtime, rospy/TCPROS repl.)
    utils/     timing, structured logging, artifacts
"""

__version__ = "0.1.0"

import jax as _jax

# Every float32 contraction runs in true float32. A Riccati recursion
# iterated through reduced-precision products (TF32 on the GPU's tensor
# cores keeps about three decimal digits) diverges; a six-robot closed loop
# run through bf16 products was seen to explode where the same code in f32
# is fine.
_jax.config.update("jax_default_matmul_precision", "float32")

from nmpc_tpu.ocp.problem import OCP, default_weights  # noqa: F401
from nmpc_tpu.solver.alilqr import ALILQRConfig, SolveResult, solve  # noqa: F401
