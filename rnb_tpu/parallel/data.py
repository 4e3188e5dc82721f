"""View-sharded dataset placement (greenfield — SURVEY.md §2.3 "per-host data
loading of its view shard").

The maps (normals/albedos/masks) are the big tensors — [V, H, W, 3] f32 can
reach tens of GB for real captures. Replicating them on every device (the
round-2 design, `parallel/train.py`) caps dataset size at one device's HBM.
Here the VIEW axis is sharded across the mesh's devices:

  * every device holds V/n_dev views; per train step each device samples its
    ray batch from ITS OWN view (slot s on device d = global view
    d*V_local + s), so a step sees n_dev distinct views instead of the
    reference's one (`/root/reference/exp_runner.py:172-174`) — same
    expectation over an epoch, lower gradient variance per step, and ZERO
    cross-device data movement in the sampling path (only grad psums cross
    the interconnect).
  * multi-host: each process loads ONLY the view files its devices own
    (`host_local_view_indices` -> Dataset.from_conf(view_subset=...)), then
    `jax.make_array_from_process_local_data` assembles the global sharded
    array without any host ever materializing the full dataset.

Camera matrices / light frames are tiny and stay replicated.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rnb_tpu.data.dataset import DataArrays
from rnb_tpu.parallel.mesh import RAY_AXIS


def pad_views(n_views: int, n_dev: int) -> list[int]:
    """Global view index list, cyclically padded to a multiple of n_dev
    (padded entries are real views repeated — harmless oversampling)."""
    total = ((n_views + n_dev - 1) // n_dev) * n_dev
    return [i % n_views for i in range(total)]


def host_local_view_indices(n_views: int, mesh: Mesh) -> list[int]:
    """The global view indices THIS process's devices own (what a per-host
    loader should read from disk). Device d owns views
    [d*V_local, (d+1)*V_local)."""
    n_dev = mesh.devices.size
    order = pad_views(n_views, n_dev)
    v_local = len(order) // n_dev
    mine = []
    flat = list(mesh.devices.flat)
    for d, dev in enumerate(flat):
        if dev.process_index == jax.process_index():
            mine.extend(order[d * v_local:(d + 1) * v_local])
    return mine


def shard_views(arrays: DataArrays, mesh: Mesh) -> DataArrays:
    """Place every DataArrays leaf with its view axis sharded over the mesh
    (single-process path: the arrays hold all views; multi-host assembly from
    per-host shards goes through `assemble_from_host_shards`)."""
    n_dev = mesh.devices.size
    V = arrays.normals.shape[0]
    order = pad_views(V, n_dev)
    sharding = NamedSharding(mesh, P(RAY_AXIS))
    return DataArrays(*[
        jax.device_put(np.asarray(leaf)[order], sharding) for leaf in arrays])


def load_view_sharded_dataset(conf, mesh: Mesh, no_albedo: bool = False):
    """THE multi-host data path: this process loads ONLY its devices' view
    files, then the global view-sharded DataArrays is assembled across
    processes. Returns (local Dataset, global sharded DataArrays).

    Works identically single-process (then it is just shard_views with
    lazy loading)."""
    import numpy as np
    from rnb_tpu.data.dataset import Dataset

    # count global views from cameras.npz without loading any images
    # (fullmatch, not a prefix test: IDR-style files can also carry keys
    # like 'world_mat_inv_0' which would inflate the count)
    import os
    import re
    data_dir = conf.get_string("data_dir")
    cams = np.load(os.path.join(data_dir,
                                conf.get_string("render_cameras_name")))
    n_views_global = len([k for k in cams.files
                          if re.fullmatch(r"world_mat_\d+", k)])

    mine = host_local_view_indices(n_views_global, mesh)
    local = Dataset.from_conf(conf, no_albedo=no_albedo, view_subset=mine,
                              device_arrays=False)
    arrays = assemble_from_host_shards(local.arrays, n_views_global, mesh)
    return local, arrays


def assemble_from_host_shards(local_arrays: DataArrays, n_views_global: int,
                              mesh: Mesh) -> DataArrays:
    """Multi-host: build the globally view-sharded DataArrays from arrays
    holding only THIS process's views (in `host_local_view_indices` order)."""
    n_dev = mesh.devices.size
    total = len(pad_views(n_views_global, n_dev))
    sharding = NamedSharding(mesh, P(RAY_AXIS))
    # make_array_from_process_local_data lays local rows out over THIS
    # process's device positions in mesh order; host_local_view_indices
    # assumed those positions are a contiguous ascending run of
    # mesh.devices.flat — verify, or views would silently permute across
    # hosts on exotic mesh layouts
    mine_pos = [i for i, d in enumerate(mesh.devices.flat)
                if d.process_index == jax.process_index()]
    # a hard raise, not an assert: this guard prevents SILENT cross-host
    # view permutation and must survive python -O
    if not mine_pos or mine_pos != list(
            range(mine_pos[0], mine_pos[0] + len(mine_pos))):
        raise ValueError(
            "this process's devices are absent or not contiguous in "
            f"mesh.devices.flat; positions={mine_pos} — build the mesh with "
            "per-process device blocks (jax.devices() order) before "
            "view-sharded loading")
    out = []
    for leaf in local_arrays:
        local = np.asarray(leaf)
        global_shape = (total,) + local.shape[1:]
        out.append(jax.make_array_from_process_local_data(
            sharding, local, global_shape))
    return DataArrays(*out)
