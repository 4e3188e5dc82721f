"""The jitted RNb training step.

One fused device program per phase (SURVEY.md §7 "warm-up/main dual pipeline":
two jitted step functions, mode switch at ``warm_up_iter`` on the host instead
of branching inside one graph). Each step fuses, fully on device:

  pixel sampling + supervision synthesis (rnb_tpu.data.dataset)
  -> z init + 4-round hierarchical up-sampling (no-grad)
  -> render_core_mvps (SDF fwd + batched-vjp gradients + albedo net)
  -> per-light shading/compositing
  -> 3-term loss (`/root/reference/exp_runner.py:241-256`):
       L1 color / (mask_sum * n_lights) + igr_weight * eikonal
       + mask_weight * BCE(clip(weight_sum))
  -> reverse-mode grad (incl. second-order eikonal) -> Adam update.

Equivalences with the reference optimizer setup (`exp_runner.py:105-115`):
torch Adam(lr) over [nerf, sdf, variance, (color)] == optax.adam over the whole
bundle, because params excluded there (color when no_albedo; nerf when
n_outside==0) receive exactly zero gradient here, and Adam with zero grad and
zero moments produces a zero update.

RNG: the reference reseeds torch per iteration (`exp_runner.py:170`); we fold
the step index into a base key, so a resumed run replays the identical ray
stream (SURVEY.md §7 determinism).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from rnb_tpu.data import dataset as ds
from rnb_tpu.models import renderer as rnd
from rnb_tpu.models.fields import ModelStatics
from rnb_tpu.models.renderer import RendererConfig
from rnb_tpu.train import schedules


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Schema of the reference's `train` conf section
    (`confs/wmask_rnb.conf:20-39`) plus the numerics/runtime knobs (conf-first
    for reproducibility — the recorded conf fully determines a run's numerics;
    RNB_* env vars override, see resolve_runtime_flags)."""
    learning_rate: float = 5e-4
    learning_rate_alpha: float = 0.05
    end_iter: int = 300000
    warm_up_iter: int = 200000
    batch_size: int = 512
    validate_resolution_level: int = 4
    warm_up_end: float = 5000
    anneal_end: float = 0.0
    use_white_bkgd: bool = False
    save_freq: int = 10000
    val_freq: int = 5000
    val_mesh_freq: int = 25000
    report_freq: int = 500
    igr_weight: float = 0.1
    mask_weight: float = 0.1
    # runtime/precision knobs (formerly RNB_* env vars — VERDICT r2 weak #4)
    # The program's one matmul-precision setting, applied globally by
    # apply_runtime_flags. On an H100 an f32 dot at 'high' (like 'default')
    # runs in TF32 (10 mantissa bits, f32 accumulation); 'highest' runs full
    # f32. Contractions that must be exact pin HIGHEST themselves
    # (renderer.EXACT, data.lights.EXACT).
    matmul_precision: str = "high"      # 'default' | 'high' | 'highest'
    upsample_precision: str = "bf16"    # 'bf16' | 'f32' no-grad sweeps
    remat: bool = False                 # jax.checkpoint the field nets
    core_impl: str = "vjp"              # renderer.CORE_IMPLS
    view_shard: bool = False            # shard the dataset's view axis over
    #                                     the mesh (parallel.data; each device
    #                                     trains rays of its own view)

    def __post_init__(self):
        rnd.check_core_impl(self.core_impl)


def train_conf(conf) -> TrainConfig:
    if "train" not in conf:
        return resolve_runtime_flags(TrainConfig())
    d = dict(conf["train"].as_dict())
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        # loud, not fatal: a typo'd train.* key would otherwise silently
        # fall back to the schema default
        import logging
        logging.getLogger(__name__).warning(
            "ignoring unknown train conf keys %s (not in the TrainConfig "
            "schema — check for typos)", unknown)
    return resolve_runtime_flags(
        TrainConfig(**{k: v for k, v in d.items() if k in known}))


def _env_bool(name: str, default: bool) -> bool:
    import os
    v = os.environ.get(name)
    return default if v is None else v not in ("0", "false", "off", "")


def resolve_runtime_flags(tcfg: TrainConfig) -> TrainConfig:
    """Apply RNB_* env-var overrides on top of the conf values (env wins —
    the conf remains the recorded source of truth; tools echo the resolved
    values so a run dir is self-describing)."""
    import os
    return dataclasses.replace(
        tcfg,
        matmul_precision=os.environ.get("RNB_MATMUL_PRECISION",
                                        tcfg.matmul_precision),
        upsample_precision=os.environ.get("RNB_UPSAMPLE_PREC",
                                          tcfg.upsample_precision),
        remat=_env_bool("RNB_REMAT", tcfg.remat),
        core_impl=os.environ.get("RNB_CORE_IMPL", tcfg.core_impl),
        view_shard=_env_bool("RNB_VIEW_SHARD", tcfg.view_shard),
    )


def apply_runtime_flags(rcfg, tcfg: TrainConfig):
    """Copy the resolved runtime knobs into the RendererConfig (which is what
    the render functions actually read) and set the global matmul precision."""
    import jax as _jax
    _jax.config.update("jax_default_matmul_precision", tcfg.matmul_precision)
    return dataclasses.replace(rcfg,
                               upsample_prec=tcfg.upsample_precision,
                               remat=tcfg.remat,
                               core_impl=tcfg.core_impl)


def runtime_flags_dict(tcfg: TrainConfig) -> dict:
    """The resolved numerics knobs as a JSON-able dict (echoed into
    scalars.jsonl and the recording dir)."""
    return {
        "matmul_precision": tcfg.matmul_precision,
        "upsample_precision": tcfg.upsample_precision,
        "remat": tcfg.remat,
        "core_impl": tcfg.core_impl,
        "view_shard": tcfg.view_shard,
    }


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jnp.ndarray  # int32 scalar


# Metric scalars, in the fixed order they are packed into the metrics ring.
METRIC_KEYS = ("loss", "color_loss", "eikonal_loss", "mask_loss", "s_val",
               "cdf", "weight_max", "psnr", "lr")


def new_metrics_ring(n_steps: int = 64) -> jnp.ndarray:
    """Device-side [n_steps, n_metrics] ring the step writes its scalars
    into. The host fetches the WHOLE ring once per n_steps instead of
    fetching each scalar individually: every device->host fetch is a sync
    point that drains the dispatch queue, so per-step metric fetching would
    leave the device idle between steps."""
    return jnp.zeros((n_steps, len(METRIC_KEYS)), jnp.float32)


def with_metrics_ring(raw_step):
    """Wrap a (state, arrays, view, key) -> (state, metrics) step so it also
    maintains a metrics ring: row (state.step % K) <- packed metrics."""
    def fn(state, arrays, view_idx, base_key, ring):
        new_state, metrics = raw_step(state, arrays, view_idx, base_key)
        row = jnp.stack([metrics[k].reshape(()) for k in METRIC_KEYS])
        idx = jnp.mod(state.step, ring.shape[0])
        ring = jax.lax.dynamic_update_slice(
            ring, row[None].astype(ring.dtype), (idx, jnp.asarray(0)))
        return new_state, ring
    return fn


def make_optimizer(tcfg: TrainConfig) -> optax.GradientTransformation:
    sched = schedules.make_lr_schedule(tcfg.learning_rate, tcfg.warm_up_end,
                                       tcfg.end_iter, tcfg.learning_rate_alpha)
    # torch.optim.Adam defaults (`exp_runner.py:115`): betas (0.9, 0.999),
    # eps 1e-8 outside the sqrt — optax.adam matches (eps_root=0).
    return optax.adam(learning_rate=sched)


def init_train_state(params, tcfg: TrainConfig) -> TrainState:
    opt = make_optimizer(tcfg)
    return TrainState(params=params, opt_state=opt.init(params),
                      step=jnp.zeros((), jnp.int32))


def _loss_terms(statics: ModelStatics, rcfg: RendererConfig, tcfg: TrainConfig,
                params, batch: ds.RayBatch, true_rgb, lights_dir, key,
                step, warmup: bool, no_albedo: bool):
    background_rgb = jnp.ones((1, 3)) if tcfg.use_white_bkgd else None

    if tcfg.mask_weight > 0.0:
        mask = (batch.mask > 0.5).astype(jnp.float32)
    else:
        mask = jnp.ones_like(batch.mask)
    mask_sum = mask.sum() + 1e-5

    out = rnd.render_rnb(
        statics, rcfg, params, batch.rays_o, batch.rays_d, batch.near,
        batch.far, lights_dir, key,
        cos_anneal_ratio=schedules.cos_anneal_ratio(step, tcfg.anneal_end),
        background_rgb=background_rgb, no_albedo=no_albedo, warmup=warmup)

    n_lights = true_rgb.shape[0]
    color_error = (out["color_fine"] - true_rgb) * mask[None]
    color_loss = jnp.abs(color_error).sum() / (mask_sum * n_lights)

    eikonal_loss = out["gradient_error"]

    w = jnp.clip(out["weight_sum"], 1e-3, 1.0 - 1e-3)
    mask_loss = -(mask * jnp.log(w) + (1.0 - mask) * jnp.log(1.0 - w)).mean()

    loss = (color_loss + eikonal_loss * tcfg.igr_weight
            + mask_loss * tcfg.mask_weight)

    metrics = {
        "loss": loss,
        "color_loss": color_loss,
        "eikonal_loss": eikonal_loss,
        "mask_loss": mask_loss,
        "s_val": out["s_val"].mean(),
        "cdf": (out["cdf_fine"][:, :1] * mask).sum() / mask_sum,
        "weight_max": (out["weight_max"] * mask).sum() / mask_sum,
        "psnr": 20.0 * jnp.log10(
            1.0 / jnp.sqrt(jnp.maximum(
                ((out["color_fine"] - true_rgb) ** 2 * mask[None]).sum()
                / (mask_sum * 3.0 * n_lights), 1e-12))),
    }
    return loss, metrics


def _batch_update(statics: ModelStatics, rcfg: RendererConfig,
                  tcfg: TrainConfig, warmup: bool, no_albedo: bool,
                  state: TrainState, batch: ds.RayBatch, k_render):
    """Loss, gradient and Adam update on one sampled ray batch."""
    opt = make_optimizer(tcfg)
    if warmup:
        true_rgb = batch.rgb_warmup
        lights_dir = batch.lights_warmup.reshape(-1, 1, 1, 3)
    else:
        true_rgb = batch.rgb
        lights_dir = batch.lights.reshape(-1, batch.rays_o.shape[0], 1, 3)

    def loss_fn(params):
        return _loss_terms(statics, rcfg, tcfg, params, batch, true_rgb,
                           lights_dir, k_render, state.step, warmup,
                           no_albedo)

    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params)
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    new_state = TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1)
    metrics["lr"] = schedules.make_lr_schedule(
        tcfg.learning_rate, tcfg.warm_up_end, tcfg.end_iter,
        tcfg.learning_rate_alpha)(state.step)
    return new_state, metrics


def make_batch_train_step(statics: ModelStatics, rcfg: RendererConfig,
                          tcfg: TrainConfig, warmup: bool, no_albedo: bool):
    """The step of make_train_step on a given batch: jitted
    (state, batch: RayBatch, render_key) -> (state, metrics). It is the
    single-device reference the sharded steps are compared with, fed the
    union of the rays the shards sampled (parallel.train.shard_batches)."""
    return jax.jit(partial(_batch_update, statics, rcfg, tcfg, warmup,
                           no_albedo))


def make_train_step(statics: ModelStatics, rcfg: RendererConfig,
                    tcfg: TrainConfig, warmup: bool, no_albedo: bool,
                    batch_size: int | None = None, donate: bool = True,
                    metrics_ring: bool = False):
    """Build the jitted step for one phase.

    Returned fn: (state, arrays: DataArrays, view_idx scalar, base_key)
    -> (state, metrics dict of scalars); with metrics_ring=True the fn is
    (state, arrays, view_idx, base_key, ring) -> (state, ring) — see
    new_metrics_ring for why the training loop uses the ring form.
    """
    bsz = batch_size or tcfg.batch_size

    def step_fn(state: TrainState, arrays: ds.DataArrays, view_idx, base_key):
        key = jax.random.fold_in(base_key, state.step)
        k_ray, k_render = jax.random.split(key)
        batch = ds.sample_rays_on_all_lights(arrays, view_idx, k_ray, bsz)
        return _batch_update(statics, rcfg, tcfg, warmup, no_albedo, state,
                             batch, k_render)

    if metrics_ring:
        return jax.jit(with_metrics_ring(step_fn),
                       donate_argnums=(0, 4) if donate else (4,))
    return jax.jit(step_fn, donate_argnums=(0,) if donate else ())
