"""Device-mesh helpers for sharding ray batches.

The workload is embarrassingly parallel over rays (SURVEY.md §2: the reference
scales only via CPU thread ensembles). Scaling is one mesh axis ("rays"),
pixel tiles sharded across it with `shard_map`, `psum` only at reduction
points (histogram binning, image gather, parameter-gradient all-reduce). The
GPUs of one host are joined all to all, so a 1-D mesh in device order fits.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec

__all__ = ["ray_mesh", "P_RAYS", "P_NONE"]

P_RAYS = PartitionSpec("rays")
P_NONE = PartitionSpec()


def ray_mesh(n_devices: int | None = None) -> Mesh:
    """1D mesh over all (or the first n) devices with axis name 'rays'."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("rays",))
