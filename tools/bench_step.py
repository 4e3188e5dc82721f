#!/usr/bin/env python
"""Ad-hoc train-step sweep on the GPU: ms/step and rays/s across two levers:

  * remat      — jax.checkpoint the field nets: recompute activations in the
                 backward pass instead of round-tripping them through device
                 memory
  * batch size — the reference's 512 (`/root/reference/confs/wmask_rnb.conf:26`)
                 against larger ray batches that amortize the up-sample chain

Usage:
    python tools/bench_step.py                  # default sweep
    RNB_SWEEP_ITERS=60 python tools/bench_step.py
Prints one JSON line per configuration, naming the device. Runs only on a
GPU.
"""

from __future__ import annotations

import dataclasses
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
    from rnb_tpu.data import dataset as ds
    from rnb_tpu.models import fields
    from rnb_tpu.models.renderer import RendererConfig
    from rnb_tpu.train import step as steplib

    device = device_info()
    iters = int(os.environ.get("RNB_SWEEP_ITERS", "60"))
    scene = ds.make_sphere_scene(n_views=6, H=256, W=256, radius=0.4)
    statics = fields.ModelStatics(sdf=fields.SDFConfig(),
                                  color=fields.RenderingConfig(),
                                  nerf=fields.NeRFConfig())
    params0 = fields.init_model_bundle(jax.random.PRNGKey(0), statics)
    key = jax.random.PRNGKey(1)

    batches = [int(b) for b in
               os.environ.get("RNB_SWEEP_BATCHES", "512,1024,2048,4096").split(",")]
    remats = [v == "1" for v in
              os.environ.get("RNB_SWEEP_REMAT", "0,1").split(",")]

    for remat in remats:
        for bsz in batches:
            tcfg = steplib.resolve_runtime_flags(
                steplib.TrainConfig(batch_size=bsz))
            tcfg = dataclasses.replace(tcfg, remat=remat)
            rcfg = steplib.apply_runtime_flags(RendererConfig(), tcfg)
            fn = steplib.make_train_step(statics, rcfg, tcfg, warmup=False,
                                         no_albedo=False)
            state = steplib.init_train_state(
                jax.tree_util.tree_map(jnp.array, params0), tcfg)
            t_c = time.perf_counter()
            for i in range(3):
                state, metrics = fn(state, scene.arrays, i % scene.n_images,
                                    key)
            loss0 = float(metrics["loss"])
            compile_s = time.perf_counter() - t_c
            t0 = time.perf_counter()
            for i in range(iters):
                state, metrics = fn(state, scene.arrays, i % scene.n_images,
                                    key)
            jax.block_until_ready(state)
            dt = time.perf_counter() - t0
            print(json.dumps({
                "remat": remat, "batch": bsz,
                "ms_per_step": dt / iters * 1e3,
                "rays_per_s": iters * bsz / dt,
                "compile_s": compile_s,
                "loss3": loss0,
                "device": device,
            }), flush=True)


if __name__ == "__main__":
    main()
