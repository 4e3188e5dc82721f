"""Multi-device semantics on the 8-virtual-CPU mesh (SURVEY.md §4):
the sharded train step's psum-reassembled loss/grads must match an exact
single-device recomputation over the concatenated shard batches, and the
sharded grid query must match the serial one."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from rnb_tpu.data import dataset as ds
from rnb_tpu.models import fields, renderer as rnd
from rnb_tpu.models.renderer import RendererConfig
from rnb_tpu.parallel import mesh as meshlib
from rnb_tpu.parallel.grid import extract_fields_sharded
from rnb_tpu.parallel.train import make_sharded_train_step
from rnb_tpu.train import schedules, step as steplib


@pytest.fixture(scope="module")
def scene():
    return ds.make_sphere_scene(n_views=3, H=32, W=32, radius=0.4)


@pytest.fixture(scope="module")
def statics():
    return fields.ModelStatics(sdf=fields.SDFConfig(),
                               color=fields.RenderingConfig(),
                               nerf=fields.NeRFConfig())


@pytest.fixture(scope="module")
def params(statics):
    return fields.init_model_bundle(jax.random.PRNGKey(0), statics)


def test_eight_devices_available():
    assert len(jax.devices()) == 8, (
        "conftest must provide 8 virtual CPU devices")


def test_sharded_step_matches_manual_global_computation(scene, statics, params):
    """Exactness of the psum reassembly: replay each shard's sampling on one
    device, rebuild the global loss by the reference formulas
    (`exp_runner.py:241-256`), grad + adam, and compare to the sharded step."""
    # perturb=0 so rendering is deterministic given the sampled pixels
    rcfg = RendererConfig(n_samples=8, n_importance=8, up_sample_steps=2,
                          perturb=0.0)
    tcfg = steplib.TrainConfig(end_iter=100, warm_up_end=10, batch_size=128,
                               mask_weight=0.1)
    mesh = meshlib.make_ray_mesh()
    n_dev = 8
    local_bsz = tcfg.batch_size // n_dev

    state = steplib.init_train_state(params, tcfg)
    fn = make_sharded_train_step(statics, rcfg, tcfg, warmup=True,
                                 no_albedo=False, mesh=mesh, donate=False)
    base_key = jax.random.PRNGKey(7)
    new_state, metrics = fn(state, scene.arrays, 1, base_key)

    # ---- manual single-device replay -------------------------------------
    step0 = jnp.zeros((), jnp.int32)
    shard_keys = [
        jax.random.fold_in(jax.random.fold_in(base_key, step0), i)
        for i in range(n_dev)]
    batches = []
    for k in shard_keys:
        k_ray, k_render = jax.random.split(k)
        batches.append((ds.sample_rays_on_all_lights(scene.arrays, 1, k_ray,
                                                     local_bsz), k_render))

    def manual_loss(p):
        abs_err = sq = msum = eik_n = eik_d = bce = 0.0
        for batch, k_render in batches:
            lights_dir = batch.lights_warmup.reshape(-1, 1, 1, 3)
            mask = (batch.mask > 0.5).astype(jnp.float32)
            out = rnd.render_rnb(statics, rcfg, p, batch.rays_o, batch.rays_d,
                                 batch.near, batch.far, lights_dir, k_render,
                                 cos_anneal_ratio=1.0, warmup=True)
            abs_err += jnp.abs((out["color_fine"] - batch.rgb_warmup)
                               * mask[None]).sum()
            msum += mask.sum()
            eik_n += out["gradient_error_num"]
            eik_d += out["gradient_error_den"]
            w = jnp.clip(out["weight_sum"], 1e-3, 1 - 1e-3)
            bce += -(mask * jnp.log(w) + (1 - mask) * jnp.log(1 - w)).sum()
        mask_sum = msum + 1e-5
        return (abs_err / (mask_sum * 3)
                + (eik_n / (eik_d + 1e-5)) * tcfg.igr_weight
                + (bce / tcfg.batch_size) * tcfg.mask_weight)

    loss_manual, grads_manual = jax.jit(
        jax.value_and_grad(manual_loss))(state.params)

    np.testing.assert_allclose(float(metrics["loss"]), float(loss_manual),
                               rtol=2e-4)

    opt = steplib.make_optimizer(tcfg)
    updates, _ = opt.update(grads_manual, state.opt_state, state.params)
    params_manual = optax.apply_updates(state.params, updates)

    for a, b in zip(jax.tree_util.tree_leaves(new_state.params),
                    jax.tree_util.tree_leaves(params_manual)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=2e-6)


def test_sharded_step_runs_and_determinism(scene, statics, params):
    rcfg = RendererConfig(n_samples=8, n_importance=8, up_sample_steps=2)
    tcfg = steplib.TrainConfig(end_iter=50, warm_up_end=5, batch_size=64)
    mesh = meshlib.make_ray_mesh()
    fn = make_sharded_train_step(statics, rcfg, tcfg, warmup=False,
                                 no_albedo=False, mesh=mesh, donate=False)
    s0 = steplib.init_train_state(params, tcfg)
    s1, m1 = fn(s0, scene.arrays, 0, jax.random.PRNGKey(3))
    s0b = steplib.init_train_state(params, tcfg)
    s2, m2 = fn(s0b, scene.arrays, 0, jax.random.PRNGKey(3))
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(jax.tree_util.tree_leaves(s1.params),
                    jax.tree_util.tree_leaves(s2.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.isfinite(float(m1["loss"]))


def test_view_sharded_step_matches_manual_global_computation(scene, statics,
                                                             params):
    """The view-sharded step (each device trains rays of ITS OWN view from a
    view-sharded dataset, parallel/data.py): replay every device's sampling
    serially on the replicated arrays (device d's view = pad_views order at
    d*V_local + slot), rebuild the global loss by the psum formulas, and
    compare loss + updated params."""
    from rnb_tpu.parallel.data import pad_views, shard_views
    from rnb_tpu.parallel.train import make_view_sharded_train_step

    rcfg = RendererConfig(n_samples=8, n_importance=8, up_sample_steps=2,
                          perturb=0.0)
    tcfg = steplib.TrainConfig(end_iter=100, warm_up_end=10, batch_size=128,
                               mask_weight=0.1)
    mesh = meshlib.make_ray_mesh()
    n_dev = 8
    local_bsz = tcfg.batch_size // n_dev
    slot = 0

    arrays_sharded = shard_views(scene.arrays, mesh)
    order = pad_views(scene.n_images, n_dev)          # 3 views -> 8 slots
    v_local = len(order) // n_dev
    assert v_local == 1

    state = steplib.init_train_state(params, tcfg)
    fn = make_view_sharded_train_step(statics, rcfg, tcfg, warmup=True,
                                      no_albedo=False, mesh=mesh,
                                      donate=False)
    base_key = jax.random.PRNGKey(11)
    new_state, metrics = fn(state, arrays_sharded, slot, base_key)

    # ---- serial replay on the replicated arrays --------------------------
    step0 = jnp.zeros((), jnp.int32)
    batches = []
    for d in range(n_dev):
        k = jax.random.fold_in(jax.random.fold_in(base_key, step0), d)
        k_ray, k_render = jax.random.split(k)
        view = order[d * v_local + slot]
        batches.append((ds.sample_rays_on_all_lights(scene.arrays, view,
                                                     k_ray, local_bsz),
                        k_render))

    def manual_loss(p):
        abs_err = msum = eik_n = eik_d = bce = 0.0
        for batch, k_render in batches:
            lights_dir = batch.lights_warmup.reshape(-1, 1, 1, 3)
            mask = (batch.mask > 0.5).astype(jnp.float32)
            out = rnd.render_rnb(statics, rcfg, p, batch.rays_o, batch.rays_d,
                                 batch.near, batch.far, lights_dir, k_render,
                                 cos_anneal_ratio=1.0, warmup=True)
            abs_err += jnp.abs((out["color_fine"] - batch.rgb_warmup)
                               * mask[None]).sum()
            msum += mask.sum()
            eik_n += out["gradient_error_num"]
            eik_d += out["gradient_error_den"]
            w = jnp.clip(out["weight_sum"], 1e-3, 1 - 1e-3)
            bce += -(mask * jnp.log(w) + (1 - mask) * jnp.log(1 - w)).sum()
        mask_sum = msum + 1e-5
        return (abs_err / (mask_sum * 3)
                + (eik_n / (eik_d + 1e-5)) * tcfg.igr_weight
                + (bce / tcfg.batch_size) * tcfg.mask_weight)

    loss_manual, grads_manual = jax.jit(
        jax.value_and_grad(manual_loss))(state.params)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_manual),
                               rtol=2e-4)

    opt = steplib.make_optimizer(tcfg)
    updates, _ = opt.update(grads_manual, state.opt_state, state.params)
    params_manual = optax.apply_updates(state.params, updates)
    for a, b in zip(jax.tree_util.tree_leaves(new_state.params),
                    jax.tree_util.tree_leaves(params_manual)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=2e-6)


def test_host_local_view_indices_cover_all_views():
    """Single-process: the per-host loading plan must cover every device's
    shard, and shards tile the padded view order."""
    from rnb_tpu.parallel.data import host_local_view_indices, pad_views
    mesh = meshlib.make_ray_mesh()
    mine = host_local_view_indices(5, mesh)
    assert mine == pad_views(5, 8)  # one process owns all 8 devices
    assert set(mine) == set(range(5))


def test_sharded_grid_matches_serial(statics, params):
    mesh = meshlib.make_ray_mesh()
    bmin, bmax = np.array([-1.0] * 3), np.array([1.0] * 3)
    g_serial = rnd.extract_fields(statics, params, bmin, bmax, 24)
    g_shard = extract_fields_sharded(statics, params, bmin, bmax, 24, mesh,
                                     chunk=4096)
    np.testing.assert_allclose(g_shard, g_serial, atol=1e-5)


def test_lr_schedule_formula():
    """`exp_runner.py:320-332` exactly."""
    sched = schedules.make_lr_schedule(5e-4, 5000, 300000, 0.05)
    assert float(sched(0)) == 0.0
    np.testing.assert_allclose(float(sched(2500)), 5e-4 * 0.5, rtol=1e-6)
    np.testing.assert_allclose(float(sched(5000)), 5e-4, rtol=1e-6)
    # end: cos(pi)= -1 -> factor alpha
    np.testing.assert_allclose(float(sched(300000)), 5e-4 * 0.05, rtol=1e-5)
    # anneal ratio
    assert schedules.cos_anneal_ratio(10, 0.0) == 1.0
    np.testing.assert_allclose(float(schedules.cos_anneal_ratio(25000, 50000)),
                               0.5)
    np.testing.assert_allclose(float(schedules.cos_anneal_ratio(99999, 50000)),
                               1.0)


def test_sharded_step_equals_single_step_on_shard_batches(scene, statics):
    """The ray-sharded step against the single-device step fed the union of
    the rays the shards drew (parallel.train.shard_batches), from a state
    whose Adam moments are non-zero, so the parameter update is a smooth
    function of the gradient: the loss and every leaf's update agree up to
    the order of the sums. (A psum of the per-device gradients would make
    the sharded gradient n_dev times too large, which this catches.)"""
    from rnb_tpu.parallel.train import shard_batches

    small = fields.ModelStatics(sdf=fields.SDFConfig(d_hidden=64),
                                color=fields.RenderingConfig(d_hidden=32),
                                nerf=fields.NeRFConfig())
    params = fields.init_model_bundle(jax.random.PRNGKey(1), small)
    rcfg = RendererConfig(n_samples=8, n_importance=8, up_sample_steps=2,
                          perturb=0.0)
    tcfg = steplib.TrainConfig(end_iter=100, warm_up_end=0, batch_size=64,
                               matmul_precision="highest")
    mesh = meshlib.make_ray_mesh()
    key = jax.random.PRNGKey(9)
    single = steplib.make_train_step(small, rcfg, tcfg, False, False,
                                     donate=False)
    state = steplib.init_train_state(params, tcfg)
    for i in range(3):
        state, _ = single(state, scene.arrays, i % 3, key)

    s_sh, m_sh = make_sharded_train_step(small, rcfg, tcfg, False, False,
                                         mesh, donate=False)(
        state, scene.arrays, 1, key)
    batch = shard_batches(scene.arrays, 1, key, state.step, 8, 8)
    assert batch.rays_o.shape == (64, 3) and batch.rgb.shape == (3, 64, 3)
    s_1, m_1 = steplib.make_batch_train_step(small, rcfg, tcfg, False,
                                             False)(state, batch, key)
    np.testing.assert_allclose(float(m_sh["loss"]), float(m_1["loss"]),
                               rtol=1e-5)
    for a, b, p in zip(*(jax.tree_util.tree_leaves(s.params)
                         for s in (s_sh, s_1, state))):
        d_sh, d_1 = np.asarray(a) - np.asarray(p), np.asarray(b) - np.asarray(p)
        scale = np.abs(d_1).max()
        if scale > 0:
            assert np.abs(d_sh - d_1).max() < 2e-3 * scale
