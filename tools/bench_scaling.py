#!/usr/bin/env python
"""Scaling harness: rays/s of the data-parallel train step at mesh widths
1..N over the GPUs of one host (north-star: >=0.8 scaling efficiency,
BASELINE.json). Runs only on GPUs; the sharding semantics are tested on the
CPU's virtual devices by tests/test_parallel.py.

    python tools/bench_scaling.py

RNB_SCALING_MODE=weak scales the global batch with the mesh so per-device
work is constant; =strong keeps the global batch fixed.

Prints one JSON line per mesh width plus a summary line with efficiency
relative to 1 device and the device it ran on.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax
    import jax.numpy as jnp

    import rnb_tpu  # noqa: F401
    from bench import device_info
    device = device_info()
    from rnb_tpu.data import dataset as ds
    from rnb_tpu.models import fields
    from rnb_tpu.models.renderer import RendererConfig
    from rnb_tpu.parallel import mesh as meshlib
    from rnb_tpu.parallel.data import shard_views
    from rnb_tpu.parallel.train import (make_sharded_train_step,
                                        make_view_sharded_train_step)
    from rnb_tpu.train import step as steplib

    mode = os.environ.get("RNB_SCALING_MODE", "weak")  # weak | strong
    view_sharded = os.environ.get("RNB_SCALING_VIEW_SHARD", "0") == "1"
    per_dev_batch = int(os.environ.get("RNB_SCALING_BATCH", "512"))
    iters = int(os.environ.get("RNB_SCALING_ITERS", "40"))
    n_all = len(jax.devices())
    widths = [w for w in (1, 2, 4, 8, 16, 32) if w <= n_all]

    scene = ds.make_sphere_scene(n_views=8, H=128, W=128, radius=0.4)
    statics = fields.ModelStatics(sdf=fields.SDFConfig(),
                                  color=fields.RenderingConfig(),
                                  nerf=fields.NeRFConfig())
    params0 = fields.init_model_bundle(jax.random.PRNGKey(0), statics)
    key = jax.random.PRNGKey(1)

    rows = []
    for n_dev in widths:
        gbsz = per_dev_batch * n_dev if mode == "weak" else per_dev_batch
        if gbsz % n_dev:
            continue
        tcfg = steplib.resolve_runtime_flags(
            steplib.TrainConfig(batch_size=gbsz))
        rcfg = steplib.apply_runtime_flags(RendererConfig(), tcfg)
        mesh = meshlib.make_ray_mesh(n_dev)
        if view_sharded:
            arrays = shard_views(scene.arrays, mesh)
            fn = make_view_sharded_train_step(statics, rcfg, tcfg,
                                              warmup=False, no_albedo=False,
                                              mesh=mesh)
        else:
            arrays = scene.arrays
            fn = make_sharded_train_step(statics, rcfg, tcfg, warmup=False,
                                         no_albedo=False, mesh=mesh)
        state = steplib.init_train_state(
            jax.tree_util.tree_map(jnp.array, params0), tcfg)
        for i in range(3):
            state, m = fn(state, arrays, i % scene.n_images, key)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for i in range(iters):
            state, m = fn(state, arrays, i % scene.n_images, key)
        jax.block_until_ready(state)
        dt = time.perf_counter() - t0
        rows.append({"n_devices": n_dev, "global_batch": gbsz,
                     "rays_per_s": iters * gbsz / dt,
                     "ms_per_step": dt / iters * 1e3})
        print(json.dumps(rows[-1]), flush=True)

    if rows:
        base = rows[0]["rays_per_s"]
        eff = [r["rays_per_s"] / (base * r["n_devices"]) for r in rows]
        print(json.dumps({
            "mode": mode, "view_sharded": view_sharded,
            "scaling_efficiency_vs_1dev": dict(
                zip([r["n_devices"] for r in rows], eff)),
            "device": device,
        }))


if __name__ == "__main__":
    main()
