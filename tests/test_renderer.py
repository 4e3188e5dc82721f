"""Renderer math tests against closed forms (SURVEY.md §4): sample_pdf
inverse-CDF, NeuS alpha properties, transmittance, up-sampling, and a full
render_rnb smoke on an analytic-ish SDF."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnb_tpu.models import fields, renderer
from rnb_tpu.models.fields import ModelStatics
from rnb_tpu.models.renderer import RendererConfig


def jit_render_rnb(statics, rcfg, warmup):
    return jax.jit(partial(renderer.render_rnb, statics, rcfg, warmup=warmup))


def jit_render(statics, rcfg):
    return jax.jit(partial(renderer.render, statics, rcfg))


@pytest.fixture(scope="module")
def statics():
    return ModelStatics(sdf=fields.SDFConfig(),
                        color=fields.RenderingConfig(),
                        nerf=fields.NeRFConfig())


@pytest.fixture(scope="module")
def params(statics):
    return fields.init_model_bundle(jax.random.PRNGKey(0), statics)


def test_sample_pdf_uniform_weights_gives_uniform_samples():
    """uniform weights ⇒ det samples are the midpoint-stratified quantiles of
    the bin range (`renderer.py:39-69`)."""
    bins = jnp.broadcast_to(jnp.linspace(0.0, 1.0, 9), (4, 9))
    weights = jnp.ones((4, 8))
    s = np.asarray(renderer.sample_pdf(bins, weights, 16, det=True))
    expected = np.linspace(0.5 / 16, 1 - 0.5 / 16, 16)
    np.testing.assert_allclose(s, np.broadcast_to(expected, (4, 16)), atol=1e-5)


def test_sample_pdf_concentrates_on_heavy_bin():
    bins = jnp.broadcast_to(jnp.linspace(0.0, 1.0, 11), (1, 11))
    weights = jnp.zeros((1, 10)).at[0, 4].set(100.0)
    s = np.asarray(renderer.sample_pdf(bins, weights, 32, det=True))
    frac_in_bin = np.mean((s >= 0.4) & (s <= 0.5))
    assert frac_in_bin > 0.9


def test_sample_pdf_monotone_and_in_range():
    key = jax.random.PRNGKey(1)
    bins = jnp.sort(jax.random.uniform(key, (3, 9)), axis=-1)
    weights = jax.random.uniform(jax.random.PRNGKey(2), (3, 8))
    s = np.asarray(renderer.sample_pdf(bins, weights, 12, det=True))
    assert np.all(np.diff(s, axis=-1) >= -1e-6)
    assert np.all(s >= np.asarray(bins[:, :1]) - 1e-6)
    assert np.all(s <= np.asarray(bins[:, -1:]) + 1e-6)


def test_transmittance_weights_sum_below_one():
    alpha = jax.random.uniform(jax.random.PRNGKey(3), (6, 20))
    w = np.asarray(renderer._exclusive_cumprod_transmittance(alpha))
    assert np.all(w >= 0)
    assert np.all(w.sum(-1) <= 1.0 + 1e-4)
    # opaque first sample takes (almost) all weight
    alpha2 = jnp.zeros((1, 5)).at[0, 0].set(1.0)
    w2 = np.asarray(renderer._exclusive_cumprod_transmittance(alpha2))
    np.testing.assert_allclose(w2[0, 0], 1.0, atol=1e-5)
    assert np.all(w2[0, 1:] < 1e-5)


def test_up_sample_concentrates_near_surface():
    """For a linear SDF crossing zero at z=1.5 along the ray, new samples must
    cluster near the crossing (`renderer.py:132-176`)."""
    batch = 2
    rays_o = jnp.asarray([[0.0, 0.0, -2.0]] * batch)
    rays_d = jnp.asarray([[0.0, 0.0, 1.0]] * batch)
    z_vals = jnp.broadcast_to(jnp.linspace(1.0, 3.0, 32), (batch, 32))
    # sphere of radius 0.5 at origin: along this ray sdf = |z-2| - 0.5
    pts_z = np.asarray(z_vals[0]) - 2.0
    sdf = jnp.broadcast_to(jnp.asarray(np.abs(pts_z) - 0.5, np.float32), (batch, 32))
    new_z = np.asarray(renderer.up_sample(rays_o, rays_d, z_vals, sdf, 16, 64.0))
    # surface crossings at z=1.5 and z=2.5; all new samples near them
    d = np.minimum(np.abs(new_z - 1.5), np.abs(new_z - 2.5))
    assert np.mean(d < 0.3) > 0.8


def test_upsampled_z_vals_static_width(statics, params):
    rcfg = RendererConfig(n_samples=16, n_importance=16, up_sample_steps=4)
    rays_o = jnp.asarray([[0.0, 0.0, -2.0]] * 3)
    rays_d = jnp.asarray([[0.0, 0.0, 1.0]] * 3)
    z_vals = jnp.broadcast_to(jnp.linspace(1.0, 3.0, 16), (3, 16))
    z = renderer.upsampled_z_vals(statics, rcfg, params, rays_o, rays_d, z_vals)
    assert z.shape == (3, 32)
    assert np.all(np.diff(np.asarray(z), axis=-1) >= 0)


def _ray_setup(batch=4):
    key = jax.random.PRNGKey(7)
    o = jnp.asarray([[0.0, 0.0, -2.5]] * batch)
    dirs = jax.random.normal(key, (batch, 3)) * 0.05 + jnp.asarray([0.0, 0.0, 1.0])
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    a = (dirs ** 2).sum(-1, keepdims=True)
    b = 2.0 * (o * dirs).sum(-1, keepdims=True)
    mid = 0.5 * (-b) / a
    return o, dirs, mid - 1.0, mid + 1.0


def test_render_rnb_shapes_and_finiteness(statics, params):
    rcfg = RendererConfig(n_samples=16, n_importance=16, up_sample_steps=4)
    o, d, near, far = _ray_setup(4)
    lights = jnp.asarray(np.random.default_rng(0).normal(size=(3, 1, 1, 3)),
                         jnp.float32)
    for warmup in (True, False):
        out = jit_render_rnb(statics, rcfg, warmup)(
            params, o, d, near, far, lights, jax.random.PRNGKey(0),
            cos_anneal_ratio=1.0)
        assert out["color_fine"].shape == (3, 4, 3)
        assert out["weight_sum"].shape == (4, 1)
        assert out["gradients"].shape == (4, 32, 3)
        assert out["gradient_error"].shape == ()
        for v in jax.tree_util.tree_leaves(out):
            assert np.all(np.isfinite(np.asarray(v)))


def test_render_rnb_grads_flow(statics, params):
    """loss -> params gradient (incl. second-order eikonal) is finite."""
    rcfg = RendererConfig(n_samples=8, n_importance=8, up_sample_steps=2)
    o, d, near, far = _ray_setup(2)
    lights = jnp.ones((3, 1, 1, 3)) / np.sqrt(3.0)

    def loss_fn(p):
        out = renderer.render_rnb(statics, rcfg, p, o, d, near, far, lights,
                                  jax.random.PRNGKey(1), warmup=True)
        return (out["color_fine"].mean()
                + 0.1 * out["gradient_error"]
                + out["weight_sum"].mean())

    grads = jax.jit(jax.grad(loss_fn))(params)
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(np.all(np.isfinite(np.asarray(g))) for g in leaves)
    # sdf net must receive nonzero gradient
    sdf_norm = sum(float(jnp.sum(jnp.abs(g)))
                   for g in jax.tree_util.tree_leaves(grads["sdf"]))
    assert sdf_norm > 0


def test_render_vanilla_path(statics, params):
    rcfg = RendererConfig(n_samples=8, n_importance=8, up_sample_steps=2)
    o, d, near, far = _ray_setup(2)
    out = jit_render(statics, rcfg)(params, o, d, near, far,
                                    jax.random.PRNGKey(2))
    assert out["color_fine"].shape == (2, 3)
    assert np.all(np.isfinite(np.asarray(out["color_fine"])))


def test_render_with_background_model(statics, params):
    """womask capability: n_outside>0 runs the NeRF++ background
    (`renderer.py:93-130,986-993`)."""
    rcfg = RendererConfig(n_samples=8, n_importance=8, up_sample_steps=2,
                          n_outside=4)
    o, d, near, far = _ray_setup(2)
    out = jit_render(statics, rcfg)(params, o, d, near, far,
                                    jax.random.PRNGKey(3))
    assert out["color_fine"].shape == (2, 3)
    assert np.all(np.isfinite(np.asarray(out["color_fine"])))
    lights = jnp.ones((3, 1, 1, 3)) / np.sqrt(3.0)
    out2 = jit_render_rnb(statics, rcfg, False)(
        params, o, d, near, far, lights, jax.random.PRNGKey(4))
    assert out2["color_fine"].shape == (3, 2, 3)
    assert np.all(np.isfinite(np.asarray(out2["color_fine"])))


def test_eikonal_zero_for_perfect_sdf():
    """A network replaced by an analytic unit-norm SDF has zero eikonal error.
    We emulate by checking the formula on analytic gradients directly."""
    g = np.random.default_rng(5).normal(size=(4, 16, 3))
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    err = (np.linalg.norm(g, axis=-1) - 1.0) ** 2
    assert err.max() < 1e-9


def _stable_merge(z, new, *vals):
    """Reference for _merge_sorted: stable argsort of concat([z, new]) (z
    entries first on ties), applied with take_along_axis."""
    order = np.argsort(np.concatenate([z, new], -1), axis=-1, kind="stable")
    return [np.take_along_axis(np.concatenate(pair, -1), order, -1)
            for pair in ((z, new),) + vals]


def _merge_case(kind, rng):
    if kind == "distinct":
        z, new = rng.uniform(0, 4, (64, 24)), rng.uniform(0, 4, (64, 8))
    elif kind == "ties_across":     # new repeats values of z
        z = rng.uniform(0, 4, (64, 24))
        new = z[:, rng.choice(24, 8, replace=False)]
    elif kind == "ties_within":     # duplicates inside each list
        z = np.repeat(rng.uniform(0, 4, (64, 12)), 2, axis=-1)
        new = np.repeat(rng.uniform(0, 4, (64, 4)), 2, axis=-1)
    else:                           # coarse grid: ties everywhere
        z = rng.integers(0, 5, (64, 24)).astype(np.float64)
        new = rng.integers(0, 5, (64, 8)).astype(np.float64)
    return (np.sort(z, -1).astype(np.float32),
            np.sort(new, -1).astype(np.float32))


@pytest.mark.parametrize("kind", ["distinct", "ties_across", "ties_within",
                                  "grid"])
def test_merge_sorted_equals_stable_argsort(kind):
    """_merge_sorted (rank counting + one-hot contractions) is bit-for-bit a
    stable argsort + take_along_axis, ties included, and carries the paired
    values through the same permutation."""
    rng = np.random.default_rng(7)
    z, new = _merge_case(kind, rng)
    vz = rng.normal(size=z.shape).astype(np.float32)
    vn = rng.normal(size=new.shape).astype(np.float32)
    got = jax.jit(renderer._merge_sorted)(jnp.asarray(z), jnp.asarray(new),
                                          (jnp.asarray(vz), jnp.asarray(vn)))
    for g, r in zip(got, _stable_merge(z, new, (vz, vn))):
        np.testing.assert_array_equal(np.asarray(g), r)


def _sample_pdf_reference(bins, weights, u):
    """Inverse-CDF sampling with searchsorted (`renderer.py:39-69`)."""
    w = weights + 1e-5
    cdf = np.cumsum(w / w.sum(-1, keepdims=True), -1)
    cdf = np.concatenate([np.zeros_like(cdf[:, :1]), cdf], -1)
    out = np.empty_like(u)
    for b in range(len(u)):
        inds = np.searchsorted(cdf[b], u[b], side="right")
        below = np.maximum(inds - 1, 0)
        above = np.minimum(inds, cdf.shape[-1] - 1)
        denom = cdf[b, above] - cdf[b, below]
        denom = np.where(denom < 1e-5, 1.0, denom)
        t = (u[b] - cdf[b, below]) / denom
        out[b] = bins[b, below] + t * (bins[b, above] - bins[b, below])
    return out


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_searchsorted(det):
    rng = np.random.default_rng(3)
    bins = np.sort(rng.uniform(0.5, 3.0, (32, 33)), -1).astype(np.float32)
    weights = (rng.uniform(0, 1, (32, 32)) ** 4).astype(np.float32)
    key = jax.random.PRNGKey(5)
    got = np.asarray(jax.jit(partial(renderer.sample_pdf, n_samples=16,
                                     det=det))(jnp.asarray(bins),
                                               jnp.asarray(weights), key=key))
    u = (np.broadcast_to(np.linspace(0.5 / 16, 1 - 0.5 / 16, 16), (32, 16))
         if det else np.asarray(jax.random.uniform(key, (32, 16))))
    ref = _sample_pdf_reference(bins.astype(np.float64),
                                weights.astype(np.float64),
                                u.astype(np.float64))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
