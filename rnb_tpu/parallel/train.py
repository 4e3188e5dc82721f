"""Data-parallel training over a 1-D ray mesh (greenfield — SURVEY.md §2.3).

Every ray is independent, so the natural scaling axis is the ray batch:
each device samples and renders ``batch/n_dev`` rays of the same view, local
loss partial-sums are combined with ``psum``, and each device then
holds the *global* loss; differentiating it yields per-device gradients whose
``pmean`` is the exact full-batch gradient (identical math to the reference's
single-GPU step — mask_sum, eikonal normalization and BCE mean are all
reassembled from psum'd numerators/denominators, `exp_runner.py:241-256`).

Built on jax.shard_map with explicit collectives (XLA hands them to NCCL on
GPUs; multi-host joins the same mesh via jax.distributed). Params stay replicated
(the nets are ~1M params). Two dataset placements:

  * make_sharded_train_step — maps replicated on every device (simple, but
    caps dataset size at one device's HBM);
  * make_view_sharded_train_step — the VIEW axis sharded across devices
    (rnb_tpu.parallel.data), each device training rays of its own view per
    step; scales dataset memory with the mesh and is the multi-host path
    (each process loads only its view shard).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from rnb_tpu.data import dataset as ds
from rnb_tpu.models import renderer as rnd
from rnb_tpu.models.fields import ModelStatics
from rnb_tpu.models.renderer import RendererConfig
from rnb_tpu.parallel.mesh import RAY_AXIS
from rnb_tpu.train import schedules
from rnb_tpu.train.step import (TrainConfig, TrainState, make_optimizer,
                                with_metrics_ring)


def _make_local_loss(statics: ModelStatics, rcfg: RendererConfig,
                     tcfg: TrainConfig, warmup: bool, no_albedo: bool,
                     local_bsz: int):
    """The per-device loss shared by both sharded steps (replicated-data and
    view-sharded): sample local rays, render, psum partial sums into the
    global loss (replicated across devices)."""
    def local_loss(params, arrays, view_idx, key, step):
        k_ray, k_render = jax.random.split(key)
        batch = ds.sample_rays_on_all_lights(arrays, view_idx, k_ray, local_bsz)
        if warmup:
            true_rgb = batch.rgb_warmup
            lights_dir = batch.lights_warmup.reshape(-1, 1, 1, 3)
        else:
            true_rgb = batch.rgb
            lights_dir = batch.lights.reshape(-1, local_bsz, 1, 3)

        background_rgb = jnp.ones((1, 3)) if tcfg.use_white_bkgd else None
        if tcfg.mask_weight > 0.0:
            mask = (batch.mask > 0.5).astype(jnp.float32)
        else:
            mask = jnp.ones_like(batch.mask)

        out = rnd.render_rnb(
            statics, rcfg, params, batch.rays_o, batch.rays_d, batch.near,
            batch.far, lights_dir, k_render,
            cos_anneal_ratio=schedules.cos_anneal_ratio(step, tcfg.anneal_end),
            background_rgb=background_rgb, no_albedo=no_albedo, warmup=warmup)

        n_lights = true_rgb.shape[0]
        # local partial sums -> global via psum
        local_sums = {
            "abs_err": jnp.abs((out["color_fine"] - true_rgb) * mask[None]).sum(),
            "sq_err": (((out["color_fine"] - true_rgb) ** 2) * mask[None]).sum(),
            "mask": mask.sum(),
            "eik_num": out["gradient_error_num"],
            "eik_den": out["gradient_error_den"],
            "bce": -(mask * jnp.log(jnp.clip(out["weight_sum"], 1e-3, 1 - 1e-3))
                     + (1 - mask) * jnp.log(1 - jnp.clip(out["weight_sum"],
                                                         1e-3, 1 - 1e-3))).sum(),
            "count": jnp.asarray(local_bsz, jnp.float32),
            "s_val": out["s_val"].sum(),
            "cdf": (out["cdf_fine"][:, :1] * mask).sum(),
            "weight_max": (out["weight_max"] * mask).sum(),
        }
        g = jax.lax.psum(local_sums, RAY_AXIS)

        mask_sum = g["mask"] + 1e-5
        color_loss = g["abs_err"] / (mask_sum * n_lights)
        eikonal_loss = g["eik_num"] / (g["eik_den"] + 1e-5)
        mask_loss = g["bce"] / g["count"]
        loss = (color_loss + eikonal_loss * tcfg.igr_weight
                + mask_loss * tcfg.mask_weight)
        metrics = {
            "loss": loss,
            "color_loss": color_loss,
            "eikonal_loss": eikonal_loss,
            "mask_loss": mask_loss,
            "s_val": g["s_val"] / (g["count"] * rnd_total_samples(rcfg)),
            "cdf": g["cdf"] / mask_sum,
            "weight_max": g["weight_max"] / mask_sum,
            "psnr": 20.0 * jnp.log10(1.0 / jnp.sqrt(jnp.maximum(
                g["sq_err"] / (mask_sum * 3.0 * n_lights), 1e-12))),
        }
        return loss, metrics

    return local_loss


def _global_grads(grads):
    """Full-batch gradient from the per-device gradients of the global
    (psum'd) loss. The transpose of psum is a psum of the cotangents, so
    device d holds n_dev x (its own rays' share of the gradient); the mean
    over the axis is therefore exactly the full-batch gradient (a psum would
    be n_dev times too large)."""
    return jax.lax.pmean(grads, RAY_AXIS)


def make_sharded_train_step(statics: ModelStatics, rcfg: RendererConfig,
                            tcfg: TrainConfig, warmup: bool, no_albedo: bool,
                            mesh: Mesh, batch_size: int | None = None,
                            donate: bool = True, metrics_ring: bool = False):
    """Returns jitted (state, arrays, view_idx, base_key) -> (state, metrics).

    The global batch (tcfg.batch_size) is split evenly across the mesh's ray
    axis; every device samples a disjoint pixel set via axis-indexed RNG fold.
    Dataset arrays are replicated (view-sharded variant below scales past
    one device's HBM).
    """
    opt = make_optimizer(tcfg)
    global_bsz = batch_size or tcfg.batch_size
    n_dev = mesh.shape[RAY_AXIS]
    assert global_bsz % n_dev == 0, (global_bsz, n_dev)
    local_bsz = global_bsz // n_dev
    local_loss = _make_local_loss(statics, rcfg, tcfg, warmup, no_albedo,
                                  local_bsz)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), P()),
             out_specs=(P(), P()),
             check_vma=False)
    def sharded_grads(params, arrays, view_idx, keystep):
        base_key, step = keystep
        key = jax.random.fold_in(jax.random.fold_in(base_key, step),
                                 jax.lax.axis_index(RAY_AXIS))
        (loss, metrics), grads = jax.value_and_grad(
            local_loss, has_aux=True)(params, arrays, view_idx, key, step)
        return _global_grads(grads), metrics

    def step_fn(state: TrainState, arrays: ds.DataArrays, view_idx, base_key):
        grads, metrics = sharded_grads(state.params, arrays, view_idx,
                                       (base_key, state.step))
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        metrics["lr"] = schedules.make_lr_schedule(
            tcfg.learning_rate, tcfg.warm_up_end, tcfg.end_iter,
            tcfg.learning_rate_alpha)(state.step)
        return TrainState(params, opt_state, state.step + 1), metrics

    if metrics_ring:
        return jax.jit(with_metrics_ring(step_fn),
                       donate_argnums=(0, 4) if donate else (4,))
    return jax.jit(step_fn, donate_argnums=(0,) if donate else ())


def shard_batches(arrays: ds.DataArrays, view_idx, base_key, step,
                  n_dev: int, local_bsz: int) -> ds.RayBatch:
    """The rays make_sharded_train_step samples at `step`, drawn on one
    device: device d's ray key is split from fold_in(fold_in(base_key,
    step), d), as in sharded_grads. Returns the union as one [n_dev *
    local_bsz] RayBatch, in device order."""
    def one(d):
        key = jax.random.fold_in(jax.random.fold_in(base_key, step), d)
        k_ray, _ = jax.random.split(key)
        return ds.sample_rays_on_all_lights(arrays, view_idx, k_ray,
                                            local_bsz)

    parts = [one(d) for d in range(n_dev)]
    # per-ray fields are batch-major except the [L, B, 3] light/color ones;
    # lights_warmup ([L, 3]) is per view, identical across shards
    axis = {"rgb_warmup": 1, "rgb": 1, "lights": 1}
    return ds.RayBatch(**{
        f: (parts[0].lights_warmup if f == "lights_warmup" else
            jnp.concatenate([getattr(p, f) for p in parts],
                            axis=axis.get(f, 0)))
        for f in ds.RayBatch._fields})


def rnd_total_samples(rcfg: RendererConfig) -> int:
    return rcfg.total_samples if rcfg.n_importance > 0 else rcfg.n_samples


def make_view_sharded_train_step(statics: ModelStatics, rcfg: RendererConfig,
                                 tcfg: TrainConfig, warmup: bool,
                                 no_albedo: bool, mesh: Mesh,
                                 batch_size: int | None = None,
                                 donate: bool = True,
                                 metrics_ring: bool = False):
    """Data-parallel step over a VIEW-SHARDED dataset (see parallel.data):
    arrays arrive with their view axis sharded over the ray mesh; device d
    samples its local ray batch from its own view at `view_slot`, so one
    step trains on n_dev distinct views with zero data movement (the
    reference trains one view/step, `exp_runner.py:172-174`; same
    expectation over an epoch). Loss/grad reassembly is identical psum math
    to make_sharded_train_step.

    Returned fn: (state, sharded_arrays, view_slot scalar, base_key)
    -> (state, metrics). view_slot indexes within each device's local views.
    """
    opt = make_optimizer(tcfg)
    global_bsz = batch_size or tcfg.batch_size
    n_dev = mesh.shape[RAY_AXIS]
    assert global_bsz % n_dev == 0, (global_bsz, n_dev)
    local_bsz = global_bsz // n_dev
    loss_fn = _make_local_loss(statics, rcfg, tcfg, warmup, no_albedo,
                               local_bsz)

    arrays_spec = P(RAY_AXIS)  # every DataArrays leaf is view-major

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), arrays_spec, P(), P()),
             out_specs=(P(), P()),
             check_vma=False)
    def sharded_grads(params, arrays, view_slot, keystep):
        base_key, step = keystep
        local_v = arrays.normals.shape[0]
        view_local = view_slot % local_v
        key = jax.random.fold_in(jax.random.fold_in(base_key, step),
                                 jax.lax.axis_index(RAY_AXIS))
        (loss, metrics), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, arrays, view_local, key, step)
        return _global_grads(grads), metrics

    def step_fn(state: TrainState, arrays: ds.DataArrays, view_slot, base_key):
        grads, metrics = sharded_grads(state.params, arrays, view_slot,
                                       (base_key, state.step))
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        metrics["lr"] = schedules.make_lr_schedule(
            tcfg.learning_rate, tcfg.warm_up_end, tcfg.end_iter,
            tcfg.learning_rate_alpha)(state.step)
        return TrainState(params, opt_state, state.step + 1), metrics

    if metrics_ring:
        return jax.jit(with_metrics_ring(step_fn),
                       donate_argnums=(0, 4) if donate else (4,))
    return jax.jit(step_fn, donate_argnums=(0,) if donate else ())
