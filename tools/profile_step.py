#!/usr/bin/env python
"""Decompose main-phase train-step time into its pipeline stages on the
GPU, each stage timed to jax.block_until_ready. Runs only on a GPU.

Usage: [RNB_MATMUL_PRECISION=...] python tools/profile_step.py [iters]
"""

from __future__ import annotations

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def timeit(fn, iters=60):
    import jax
    jax.block_until_ready(fn())  # compile
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn()
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / iters * 1000.0  # ms


def main():
    import jax
    import jax.numpy as jnp

    import rnb_tpu  # noqa: F401
    from bench import device_info
    from rnb_tpu.data import dataset as ds
    from rnb_tpu.models import fields, renderer as rnd
    from rnb_tpu.models.renderer import RendererConfig
    from rnb_tpu.train import step as steplib

    device = device_info()
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 60

    scene = ds.make_sphere_scene(n_views=6, H=256, W=256, radius=0.4)
    statics = fields.ModelStatics(sdf=fields.SDFConfig(),
                                  color=fields.RenderingConfig(),
                                  nerf=fields.NeRFConfig())
    params = fields.init_model_bundle(jax.random.PRNGKey(0), statics)
    tcfg = steplib.resolve_runtime_flags(steplib.TrainConfig())
    rcfg = steplib.apply_runtime_flags(RendererConfig(), tcfg)
    state = steplib.init_train_state(params, tcfg)
    key = jax.random.PRNGKey(1)
    bsz = tcfg.batch_size

    # fixed ray batch for the sub-programs
    batch = ds.sample_rays_on_all_lights(scene.arrays, 0, key, bsz)
    lights = batch.lights.reshape(-1, bsz, 1, 3)

    # 1. ray sampling only
    samp = jax.jit(lambda k: ds.sample_rays_on_all_lights(
        scene.arrays, 0, k, bsz).rays_o)
    t_samp = timeit(lambda: samp(key), iters)

    # 2. z-init + up-sample loop (the 5 no-grad SDF sweeps)
    def ups(params, key):
        z = rnd.init_z_vals(rcfg, batch.near, batch.far, bsz, key)
        return rnd.upsampled_z_vals(statics, rcfg, params, batch.rays_o,
                                    batch.rays_d, z)
    ups_j = jax.jit(ups)
    t_ups = timeit(lambda: ups_j(params, key), iters)

    # 3. full forward render (includes up-sampling)
    fwd = jax.jit(partial(rnd.render_rnb, statics, rcfg, warmup=False))

    def fwd_loss(params):
        out = fwd(params, batch.rays_o, batch.rays_d, batch.near, batch.far,
                  lights, key)
        return out["color_fine"].sum() + out["gradient_error"]
    t_fwd = timeit(lambda: fwd_loss(params), iters)

    # 4. forward + backward (loss grad, incl. 2nd-order eikonal)
    def loss_fn(params):
        out = rnd.render_rnb(statics, rcfg, params, batch.rays_o, batch.rays_d,
                             batch.near, batch.far, lights, key, warmup=False)
        return (jnp.abs(out["color_fine"] - batch.rgb).mean()
                + 0.1 * out["gradient_error"])
    gr = jax.jit(jax.grad(loss_fn))
    t_bwd = timeit(lambda: gr(params), iters)

    # 5. the real full train step
    fn = steplib.make_train_step(statics, rcfg, tcfg, warmup=False,
                                 no_albedo=False, donate=False)
    t_full = timeit(lambda: fn(state, scene.arrays, 0, key), iters)

    print(f"device={device} batch={bsz} iters={iters}")
    print(f"ray sampling            {t_samp:8.2f} ms")
    print(f"up-sampling (5 sweeps)  {t_ups:8.2f} ms")
    print(f"forward (render+loss)   {t_fwd:8.2f} ms  (fwd core ~ {t_fwd - t_ups:.2f})")
    print(f"forward+backward        {t_bwd:8.2f} ms  (bwd ~ {t_bwd - t_fwd:.2f})")
    print(f"full train step         {t_full:8.2f} ms  (adam+misc ~ {t_full - t_bwd:.2f})")
    print(f"rays/s                  {bsz / t_full * 1000.0:8.0f}")


if __name__ == "__main__":
    main()
