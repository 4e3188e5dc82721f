#!/usr/bin/env python
"""Benchmark: RNb training throughput (rays/s) on the shipped wmask config.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...,
"device"}, the device naming platform, device_kind, count and nvidia-smi's
name and power limit. Runs only on a GPU.

Measures the main-phase jitted train step (the hottest program: 4-round
up-sampling + render_core_mvps with second-order eikonal backward + Adam) at
the reference's production shapes: batch 512 rays x 3 lights x 128 samples
(`/root/reference/confs/wmask_rnb.conf:26,84-88`).

Baseline: the reference publishes no throughput (SURVEY.md §6). Its compute
envelope is 300k iters in <=24h on one CUDA GPU (`jobs/run_job_bearPNG_001.job:5-9`)
=> >=3.47 it/s = 1778 rays/s floor; NeuS-class single-GPU trainers typically
reach ~5.5 it/s = ~2816 rays/s. We use 2816 rays/s as the CUDA-reference
baseline; vs_baseline = ours / 2816 (target >=5x, BASELINE.json).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

REFERENCE_RAYS_PER_S = 2816.0

# Published dense peaks per device_kind (NVIDIA H100 data sheet, SXM part,
# without sparsity, at its 700 W power limit). A device missing here is an
# error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "tf32_flops": 495e12, "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12},
}
# the f32 matmul rate each TrainConfig.matmul_precision runs at on these cards
PRECISION_PEAK = {"default": "tf32_flops", "high": "tf32_flops",
                  "highest": "fp32_flops"}


def device_peaks(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise ValueError(f"no published peaks for device_kind "
                         f"{device_kind!r}; add them to bench.PEAKS with "
                         f"their source")
    return PEAKS[device_kind]


def device_info() -> dict:
    """The device every result line names: JAX's view plus nvidia-smi's name
    and power limit (a card set below its maximum runs slower under load).
    Fails unless JAX runs on a GPU: no number is reported from another
    platform."""
    import subprocess

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {dev.platform!r}; device "
                         "numbers are only measured on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]}


def analytic_step_flops(params, statics, rcfg, bsz: int) -> dict:
    """Analytic matmul FLOPs of one main-phase train step, from the actual
    weight shapes. `model` is the recompute-free minimum of the
    formulation, the MFU numerator convention that does not reward
    rematerialization:
      SDF core  6 passes/pt (forward, the reverse sweep for ∇SDF, and the
                backward of both)
      albedo    3 passes/pt (forward; backward: dW, dx)
      up-sample 1 inference pass over the no-grad sweep points"""
    def pass_flops(layer_list):
        return 2.0 * sum(np.prod(_w_shape(l)) for l in layer_list)

    def _w_shape(layer):
        return (layer["v"] if "v" in layer else layer["w"]).shape

    f_sdf = pass_flops(params["sdf"])
    # sdf_only slices the head to 1 column
    last = _w_shape(params["sdf"][-1])
    f_sdf_only = f_sdf - 2.0 * last[0] * (last[1] - 1)
    f_alb = pass_flops(params["color"])

    n_core = bsz * (rcfg.total_samples if rcfg.n_importance > 0
                    else rcfg.n_samples)
    if rcfg.n_importance > 0:
        per_round = rcfg.n_importance // max(rcfg.up_sample_steps, 1)
        n_up = bsz * rcfg.n_samples + bsz * per_round * max(
            rcfg.up_sample_steps - 1, 0)
    else:
        n_up = 0   # the renderer skips up-sampling entirely

    return {"model": n_core * (6.0 * f_sdf + 3.0 * f_alb)
            + n_up * f_sdf_only}


def main():
    # measure the library's shipped defaults ('high' matmul precision + bf16
    # no-grad up-sampling — accuracy-validated in tools/validate_precision.py);
    # RNB_MATMUL_PRECISION / RNB_UPSAMPLE_PREC override for studies
    import jax

    import rnb_tpu  # noqa: F401
    device = device_info()
    peaks = device_peaks(device["kind"])
    from rnb_tpu.data import dataset as ds
    from rnb_tpu.models import fields
    from rnb_tpu.models.renderer import RendererConfig
    from rnb_tpu.train import step as steplib

    scene = ds.make_sphere_scene(n_views=6, H=256, W=256, radius=0.4)
    statics = fields.ModelStatics(sdf=fields.SDFConfig(),
                                  color=fields.RenderingConfig(),
                                  nerf=fields.NeRFConfig())
    params = fields.init_model_bundle(jax.random.PRNGKey(0), statics)
    tcfg = steplib.resolve_runtime_flags(
        steplib.TrainConfig())  # production schedule/shapes (batch 512)
    rcfg = steplib.apply_runtime_flags(RendererConfig(), tcfg)

    n_dev = len(jax.devices())

    def make_fn(warmup: bool):
        if n_dev > 1 and tcfg.batch_size % n_dev == 0:
            from rnb_tpu.parallel import mesh as meshlib
            from rnb_tpu.parallel.train import make_sharded_train_step
            mesh = meshlib.make_ray_mesh()
            return make_sharded_train_step(statics, rcfg, tcfg, warmup=warmup,
                                           no_albedo=False, mesh=mesh)
        return steplib.make_train_step(statics, rcfg, tcfg, warmup=warmup,
                                       no_albedo=False)

    key = jax.random.PRNGKey(1)
    iters = int(os.environ.get("RNB_BENCH_ITERS", "120"))

    def measure(warmup: bool) -> float:
        """rays/s for one phase program, timed to jax.block_until_ready."""
        fn = make_fn(warmup)
        # fresh param copies: the step donates its state buffers, so the two
        # phase measurements must not share array instances
        import jax.numpy as jnp
        state = steplib.init_train_state(
            jax.tree_util.tree_map(jnp.array, params), tcfg)
        for i in range(3):
            state, metrics = fn(state, scene.arrays, i % scene.n_images, key)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for i in range(iters):
            state, metrics = fn(state, scene.arrays, i % scene.n_images, key)
        jax.block_until_ready(state)
        assert np.isfinite(float(metrics["loss"]))
        return iters * tcfg.batch_size / (time.perf_counter() - t0)

    # the main-phase program is the headline metric; the warm-up program is
    # 2/3 of reference training wall-clock (SURVEY.md §3.4,
    # /root/reference/exp_runner.py:196-228) so it is reported alongside
    main_rps = measure(warmup=False)
    warm_rps = measure(warmup=True)

    # MFU from analytic FLOPs: step time vs the card's published peak at the
    # program's matmul precision, numerator from the weight shapes. Per-card
    # normalization: step_ms is the wall latency of one global step; FLOPs
    # are divided by n_dev so MFU is per card.
    step_ms = tcfg.batch_size / main_rps * 1000.0
    peak_name = PRECISION_PEAK[tcfg.matmul_precision]
    fl_chip = analytic_step_flops(params, statics, rcfg,
                                  tcfg.batch_size)["model"] / max(n_dev, 1)
    mfu = {
        "step_ms": step_ms,
        "analytic_model_flops_per_chip": fl_chip,
        "peak": peak_name,
        "mfu_model_pct": fl_chip / (step_ms * 1e-3) / peaks[peak_name] * 100,
    }

    # view-sharded placement throughput (VERDICT r4 weak #6): the designated
    # multi-host memory path, measured on the same mesh width (1-device mesh
    # on a single chip — the shard_map/psum program structure is identical,
    # only the axis size differs). Set RNB_BENCH_VIEW_SHARD=0 to skip.
    view_shard_rps = None
    if os.environ.get("RNB_BENCH_VIEW_SHARD", "1") == "1":
        import jax.numpy as jnp

        from rnb_tpu.parallel import mesh as meshlib
        from rnb_tpu.parallel.data import shard_views
        from rnb_tpu.parallel.train import make_view_sharded_train_step
        mesh = meshlib.make_ray_mesh()
        sharded_arrays = shard_views(scene.arrays, mesh)
        fn = make_view_sharded_train_step(statics, rcfg, tcfg, warmup=False,
                                          no_albedo=False, mesh=mesh)
        state = steplib.init_train_state(
            jax.tree_util.tree_map(jnp.array, params), tcfg)
        for i in range(3):
            state, metrics = fn(state, sharded_arrays, i, key)
        jax.block_until_ready(state)
        n3 = max(20, iters // 2)
        t0 = time.perf_counter()
        for i in range(n3):
            state, metrics = fn(state, sharded_arrays, i, key)
        jax.block_until_ready(state)
        assert np.isfinite(float(metrics["loss"]))
        view_shard_rps = (n3 * tcfg.batch_size
                          / (time.perf_counter() - t0) / max(n_dev, 1))

    # capability rows beyond the reference's fixed batch 512
    # (`/root/reference/confs/wmask_rnb.conf:26`): throughput headroom at
    # larger ray batches — the regime a multi-chip mesh runs in, where the
    # global batch grows with the mesh (set RNB_BENCH_BATCH_CURVE=0 to skip)
    batch_curve = []
    if os.environ.get("RNB_BENCH_BATCH_CURVE", "1") == "1":
        import dataclasses

        import jax.numpy as jnp
        for bsz in (2048, 8192):
            t2 = dataclasses.replace(tcfg, batch_size=bsz)
            r2 = steplib.apply_runtime_flags(RendererConfig(), t2)
            # same sharded-vs-single dispatch as the headline metric — a
            # single-device step divided by n_dev would understate
            # rays/s/chip by ~n_dev on multi-device hosts
            if n_dev > 1 and bsz % n_dev == 0:
                from rnb_tpu.parallel import mesh as meshlib
                from rnb_tpu.parallel.train import make_sharded_train_step
                fn = make_sharded_train_step(statics, r2, t2, warmup=False,
                                             no_albedo=False,
                                             mesh=meshlib.make_ray_mesh())
            else:
                fn = steplib.make_train_step(statics, r2, t2, warmup=False,
                                             no_albedo=False)
            state = steplib.init_train_state(
                jax.tree_util.tree_map(jnp.array, params), t2)
            for i in range(2):
                state, metrics = fn(state, scene.arrays, i % scene.n_images,
                                    key)
            jax.block_until_ready(state)
            n2 = max(8, (iters * 512) // bsz)
            t0 = time.perf_counter()
            for i in range(n2):
                state, metrics = fn(state, scene.arrays, i % scene.n_images,
                                    key)
            jax.block_until_ready(state)
            assert np.isfinite(float(metrics["loss"]))
            batch_curve.append({
                "batch": bsz,
                "rays_per_s_per_chip": (n2 * bsz / (time.perf_counter() - t0)
                                        / max(n_dev, 1)),
            })

    print(json.dumps({
        "metric": "train_rays_per_s_per_chip",
        "value": main_rps / max(n_dev, 1),
        "unit": "rays/s/chip (main phase, batch 512, 128 samples, 3 lights)",
        "vs_baseline": main_rps / max(n_dev, 1) / REFERENCE_RAYS_PER_S,
        "warmup_phase_rays_per_s_per_chip": warm_rps / max(n_dev, 1),
        "view_shard_rays_per_s_per_chip": view_shard_rps,
        "mfu": mfu,
        "batch_curve": batch_curve,
        "flags": steplib.runtime_flags_dict(tcfg),
        "device": device,
    }))


if __name__ == "__main__":
    main()
