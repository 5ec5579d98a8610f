"""Scenario batching: vmap over thousands of randomized problems, sharded
over the device mesh (SURVEY.md §2.4 'data parallel', BASELINE config 5).

An OCP pytree has static shape metadata and traced numeric leaves; a *batch*
is the same pytree with a leading [B] axis on the per-scenario leaves
(x0, xref) and broadcast scalars elsewhere. `batched_solve` vmaps the AL-iLQR
engine over that axis; `shard_ocp_batch` lays the batch across the mesh's
'data' axis so jit runs each shard on its own device with zero collectives
in the hot path. `solve_batched_sharded` runs the batch-native engine on
each device's shard inside `shard_map`, so its kernel route, which XLA's
partitioner does not split, runs once per shard.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from nmpc_tpu.ocp.problem import OCP, OCP_META
from nmpc_tpu.solver.alilqr import ALILQRConfig, solve

# leaves that vary per scenario (everything else stays replicated)
_BATCH_FIELDS = ("x0", "xref")


def batch_ocp(base: OCP, x0_batch: jax.Array, xref_batch: jax.Array | None = None) -> OCP:
    """Broadcast `base` into a batched OCP. x0_batch: [B, nx];
    xref_batch: [B, N, nx] (defaults to tiling base.xref)."""
    B = x0_batch.shape[0]
    if xref_batch is None:
        xref_batch = jnp.broadcast_to(base.xref[None], (B, *base.xref.shape))
    return dataclasses.replace(base, x0=x0_batch, xref=xref_batch)


def random_starts(base: OCP, key: jax.Array, B: int, spread: float = 1.0) -> OCP:
    """Randomized-scenario batch: jitter every robot's start pose."""
    noise = spread * jax.random.uniform(key, (B, base.nx), base.x0.dtype, -1.0, 1.0)
    # only perturb positions, keep headings within +-0.5 rad
    scale = jnp.tile(jnp.array([1.0, 1.0, 0.5], base.x0.dtype), base.nx // 3)
    return batch_ocp(base, base.x0[None] + noise * scale[None])


def batched_solve(ocp_batch: OCP, cfg: ALILQRConfig = ALILQRConfig(), warm=None):
    """vmap the solver over the batch axis of (x0, xref) [+ warm start]."""
    axes = dataclasses.replace(
        ocp_batch,
        **{f: 0 for f in _BATCH_FIELDS},
        **{
            f.name: None
            for f in dataclasses.fields(ocp_batch)
            if f.name not in _BATCH_FIELDS and f.name not in OCP_META
        },
    )
    fn = functools.partial(solve, cfg=cfg)
    if warm is None:
        return jax.vmap(lambda o: fn(o), in_axes=(axes,))(ocp_batch)
    return jax.vmap(lambda o, w: fn(o, w), in_axes=(axes, 0))(ocp_batch, warm)


def solve_batched_sharded(ocp_batch: OCP, mesh: Mesh, cfg: ALILQRConfig = ALILQRConfig(),
                          warm=None, axis: str = "data"):
    """The batch-native engine (solver.alilqr_batched.solve_batched) with
    the batch split over the mesh axis: each device solves its own shard on
    the route `choose_route` picks, and stops when its own elements are
    done. An element's result does not depend on the rest of the batch, so
    it is the unsharded solve's. B must divide by the axis size; call
    inside jax.jit."""
    from nmpc_tpu.solver.alilqr_batched import _batch_fields, solve_batched

    bf = _batch_fields(ocp_batch)
    specs = dataclasses.replace(ocp_batch, **{
        f.name: PartitionSpec(axis) if f.name in bf else PartitionSpec()
        for f in dataclasses.fields(ocp_batch) if f.name not in OCP_META})
    fn = functools.partial(solve_batched, cfg=cfg)
    if warm is None:
        return jax.shard_map(fn, mesh=mesh, in_specs=(specs,),
                             out_specs=PartitionSpec(axis), check_vma=False)(ocp_batch)
    return jax.shard_map(lambda o, w: fn(o, w), mesh=mesh,
                         in_specs=(specs, PartitionSpec(axis)),
                         out_specs=PartitionSpec(axis), check_vma=False)(ocp_batch, warm)


def shard_ocp_batch(ocp_batch: OCP, mesh: Mesh, axis: str = "data") -> OCP:
    """Place the batch leaves across the mesh 'data' axis, replicate the rest."""
    shard = NamedSharding(mesh, PartitionSpec(axis))
    repl = NamedSharding(mesh, PartitionSpec())

    def put(name, leaf):
        return jax.device_put(leaf, shard if name in _BATCH_FIELDS else repl)

    updates = {
        f.name: put(f.name, getattr(ocp_batch, f.name))
        for f in dataclasses.fields(ocp_batch)
        if isinstance(getattr(ocp_batch, f.name), jax.Array)
    }
    return dataclasses.replace(ocp_batch, **updates)
