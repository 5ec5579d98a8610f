"""Device-mesh helpers.

The reference's only 'distribution' is ROS topics over TCP (SURVEY.md §2.4 /
§5.8). Here distribution is a jax.sharding.Mesh: the scenario batch rides the
'data' axis (embarrassingly parallel, no collectives in the solve), and the
decentralized mode exchanges neighbor plans with XLA collectives
(all_gather/ppermute) between devices — never a host-side message-passing
layer. The mesh is 1-D: the cards of one host are joined all to all, so a
single axis is the whole topology.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def data_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    return Mesh(np.array(devs[:n]).reshape(n), (axis,))


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
