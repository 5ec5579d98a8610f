from nmpc_tpu.parallel.mesh import data_mesh  # noqa: F401
from nmpc_tpu.parallel.batch import batch_ocp, batched_solve, shard_ocp_batch, solve_batched_sharded  # noqa: F401
from nmpc_tpu.parallel.decentralized import decentralized_step, decentralized_closed_loop  # noqa: F401
from nmpc_tpu.parallel.consensus import consensus_solve, consensus_solve_sharded  # noqa: F401
