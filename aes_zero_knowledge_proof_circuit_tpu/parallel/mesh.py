"""Device mesh utilities (the stack's NCCL-equivalent layer).

The reference is single-process (SURVEY.md §2b: parallelism = rayon only);
scale-out here is first-class: a 1-D `jax.sharding.Mesh` over all devices,
XLA collectives between them (SURVEY.md §5 distributed-communication row). The mesh
axis shards MSM points, NTT columns, and independent block proofs
(SURVEY.md §2b parallelism components).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.config import CONFIG


def make_mesh(n_devices: Optional[int] = None, axis: Optional[str] = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    axis = axis or CONFIG.mesh_axis
    return Mesh(np.array(devices), (axis,))


def shard_leading(mesh: Mesh, arr, axis_name: Optional[str] = None):
    """Place an array sharded along its leading axis."""
    axis_name = axis_name or mesh.axis_names[0]
    spec = P(axis_name, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def replicated(mesh: Mesh, arr):
    return jax.device_put(arr, NamedSharding(mesh, P()))
