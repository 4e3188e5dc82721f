#!/usr/bin/env python
"""Accuracy validation for precision/perf settings: train the synthetic
sphere (radius 0.35 ≠ geometric-init 0.5, so training must actually move the
surface), extract a mesh, report radius error and final losses.

Run once per setting, e.g.:
    python tools/validate_precision.py                        # current env
    RNB_MATMUL_PRECISION=default python tools/validate_precision.py
    RNB_UPSAMPLE_PREC=f32 python tools/validate_precision.py

Prints one JSON line with the setting snapshot and the accuracy numbers.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    steps = int(os.environ.get("RNB_VALIDATE_STEPS", "400"))
    radius = 0.35

    import jax
    import numpy as np

    import rnb_tpu  # noqa: F401
    from rnb_tpu.data import dataset as ds
    from rnb_tpu.models import fields, renderer
    from rnb_tpu.models.renderer import RendererConfig
    from rnb_tpu.ops import marching_cubes as mc
    from rnb_tpu.train import step as train_step

    scene = ds.make_sphere_scene(n_views=6, H=64, W=64, radius=radius)
    statics = fields.ModelStatics(sdf=fields.SDFConfig(),
                                  color=fields.RenderingConfig(),
                                  nerf=fields.NeRFConfig())
    tcfg = train_step.resolve_runtime_flags(
        train_step.TrainConfig(end_iter=steps, warm_up_end=50, batch_size=512))
    rcfg = train_step.apply_runtime_flags(RendererConfig(), tcfg)
    state = train_step.init_train_state(
        fields.init_model_bundle(jax.random.PRNGKey(0), statics), tcfg)
    fn = train_step.make_train_step(statics, rcfg, tcfg,
                                    warmup=True, no_albedo=False)
    key = jax.random.PRNGKey(42)
    first_loss = None
    for i in range(steps):
        state, m = fn(state, scene.arrays, i % scene.n_images, key)
        if i == 0:
            first_loss = float(m["loss"])
    last_loss = float(m["loss"])
    psnr = float(m["psnr"])

    grid = renderer.extract_fields(statics, state.params, [-1.01] * 3,
                                   [1.01] * 3, 96)
    v, t = mc.extract_geometry(grid, [-1.01] * 3, [1.01] * 3, 0.0)
    r = np.linalg.norm(v, axis=-1)
    # report the EFFECTIVE settings (resolved conf+env), not raw env reads —
    # a run with no env set is labeled with the real package defaults
    flags = train_step.runtime_flags_dict(tcfg)
    print(json.dumps({
        "matmul_precision": flags["matmul_precision"],
        "upsample_prec": flags["upsample_precision"],
        "remat": flags["remat"],
        "steps": steps,
        "first_loss": round(first_loss, 4),
        "last_loss": round(last_loss, 4),
        "psnr": round(psnr, 2),
        "radius_err_mean": round(float(abs(r.mean() - radius)), 5),
        "radius_std": round(float(r.std()), 5),
    }))


if __name__ == "__main__":
    main()
