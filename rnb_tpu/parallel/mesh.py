"""Device mesh helpers.

The reference is strictly single-GPU (`/root/reference/exp_runner.py:21,687`;
no torch.distributed anywhere — SURVEY.md §2.3), so this whole package is
greenfield: a 1-D ``ray`` mesh axis over the devices (a plain list of cards;
on one host every card reaches every other over NVLink) shards the ray batch;
gradients are combined with a mean over the axis, which XLA hands to NCCL
on GPUs. Multi-host extends the same mesh over all processes via
``jax.distributed.initialize`` (call
``maybe_initialize_distributed`` before device queries).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "ray"


def maybe_initialize_distributed() -> None:
    """Initialize jax.distributed when launched under a multi-host launcher
    (env-driven; no-op single-host)."""
    if os.environ.get("RNB_DISTRIBUTED", "0") == "1" and jax.process_count() == 1:
        jax.distributed.initialize()


def make_ray_mesh(n_devices: Optional[int] = None,
                  devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the ray-batch axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (ray) axis."""
    return NamedSharding(mesh, P(RAY_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
