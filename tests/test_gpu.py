"""Card-only checks: the program's numerics and step on an NVIDIA GPU.

Run on the card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``;
elsewhere every test here skips through the ``gpu_device`` fixture.

The program runs its differentiable matmuls at TrainConfig.matmul_precision
('high'), which an H100 executes in TF32: operands keep 10 mantissa bits
(unit roundoff 2^-11 ~ 4.9e-4), products accumulate in f32. The tolerances
below compare that against the same functions at 'highest' (full f32) and
are set from that roundoff, compounded through the network's depth.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rnb_tpu import config as cfglib
from rnb_tpu.data import dataset as ds
from rnb_tpu.models import fields, renderer as rnd
from rnb_tpu.train import step as steplib

pytestmark = pytest.mark.gpu

PREC = steplib.TrainConfig().matmul_precision
N_POINTS = 512 * 128          # one step's core batch: 512 rays x 128 samples


@pytest.fixture(scope="module")
def prod(gpu_device):
    """The shipped model at full width (confs/wmask_rnb.conf) and one
    step's worth of points inside the unit sphere."""
    conf = cfglib.load_conf("confs/wmask_rnb.conf", "gpu")
    statics = fields.statics_from_conf(conf["model"])
    params = fields.init_model_bundle(jax.random.PRNGKey(0), statics)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(N_POINTS, 3))
    pts = (d / np.linalg.norm(d, axis=-1, keepdims=True)
           * rng.uniform(0, 1, (N_POINTS, 1)) ** (1 / 3))
    return conf, statics, params, jnp.asarray(pts, jnp.float32)


def _at(prec, fn, *args):
    with jax.default_matmul_precision(prec):
        return jax.jit(fn)(*args)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_sdf_core_at_program_precision(prod):
    """∇SDF core (sdf, feature, ∇SDF) and the eikonal loss's parameter
    gradients. Values: 9 TF32 layers, error ~ depth x 2^-11 of the output
    scale -> 1e-2. Parameter gradients pass through twice as many TF32
    contractions (reverse-over-reverse) -> 5e-2 of each leaf's scale."""
    _, statics, params, pts = prod

    def core(p):
        return fields.sdf_value_feat_grad(statics.sdf, p, pts)

    def eik_grads(p):
        def loss(p):
            sdf, _, g = core(p)
            return (((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2).mean()
                    + jnp.abs(sdf).mean())
        return jax.grad(loss)(p)

    lo, hi = _at(PREC, core, params["sdf"]), _at("highest", core, params["sdf"])
    errs = {n: _rel(a, b) for n, a, b in zip(("sdf", "feature", "grad"),
                                             lo, hi)}
    g_lo = jax.tree_util.tree_leaves(_at(PREC, eik_grads, params["sdf"]))
    g_hi = jax.tree_util.tree_leaves(_at("highest", eik_grads,
                                         params["sdf"]))
    errs["param_grads"] = max(_rel(a, b) for a, b in zip(g_lo, g_hi))
    print(f"sdf core {PREC} vs highest, relative errors: {errs}")
    assert max(errs["sdf"], errs["feature"], errs["grad"]) < 1e-2, errs
    assert errs["param_grads"] < 5e-2, errs


def test_albedo_net_at_program_precision(prod):
    """Albedo net (2x256, sigmoid output in [0, 1]) on the core's outputs:
    3 TF32 layers -> absolute error below 5e-3."""
    _, statics, params, pts = prod
    with jax.default_matmul_precision("highest"):
        _, feat, grad = jax.jit(fields.sdf_value_feat_grad, static_argnums=0)(
            statics.sdf, params["sdf"], pts)

    def albedo(p):
        return fields.rendering_apply(statics.color, p, pts, grad, None, feat)

    lo = np.asarray(_at(PREC, albedo, params["color"]))
    hi = np.asarray(_at("highest", albedo, params["color"]))
    err = float(np.abs(lo - hi).max())
    print(f"albedo net {PREC} vs highest, max abs error {err}")
    assert err < 5e-3


def test_one_hot_gathers_exact(gpu_device):
    """sample_pdf and _merge_sorted gather f32 values through one-hot
    contractions; on the card they must reproduce them exactly."""
    rng = np.random.default_rng(1)
    z = np.sort(rng.uniform(0.5, 3.0, (512, 80)), -1).astype(np.float32)
    new = np.sort(rng.uniform(0.5, 3.0, (512, 16)), -1).astype(np.float32)
    cat = np.concatenate([z, new], -1)
    ref = np.take_along_axis(cat, np.argsort(cat, -1, kind="stable"), -1)
    (merged,) = _at(PREC, rnd._merge_sorted, jnp.asarray(z), jnp.asarray(new))
    np.testing.assert_array_equal(np.asarray(merged), ref)

    w = rng.uniform(0, 1, (512, 79)).astype(np.float32)
    s = np.asarray(_at(PREC, lambda b, w: rnd.sample_pdf(b, w, 16),
                       jnp.asarray(z), jnp.asarray(w)))
    wp = w + 1e-5
    cdf = np.concatenate([np.zeros((512, 1)), np.cumsum(
        wp / wp.sum(-1, keepdims=True), -1)], -1).astype(np.float32)
    u = np.linspace(0.5 / 16, 1 - 0.5 / 16, 16, dtype=np.float32)
    for b in range(0, 512, 97):
        idx = np.searchsorted(cdf[b], u, side="right")
        lo_i, hi_i = np.maximum(idx - 1, 0), np.minimum(idx, 79)
        # the samples lie in the bins the reference's searchsorted selects
        assert np.all(s[b] >= z[b, lo_i]) and np.all(s[b] <= z[b, hi_i])


def test_ray_and_light_sampling_in_f32(gpu_device):
    """Rays, near/far, light directions and supervision colours are pinned to
    full f32 (data.lights.EXACT); at the program's precision they must match
    'highest' to f32 rounding (a TF32 run differs by ~1e-3)."""
    scene = ds.make_sphere_scene(n_views=3, H=128, W=128, radius=0.35)

    def sample(a, k):
        return ds.sample_rays_on_all_lights(a, 1, k, 512)

    lo = _at(PREC, sample, scene.arrays, jax.random.PRNGKey(0))
    hi = _at("highest", sample, scene.arrays, jax.random.PRNGKey(0))
    for f in ds.RayBatch._fields:
        np.testing.assert_allclose(np.asarray(getattr(lo, f)),
                                   np.asarray(getattr(hi, f)),
                                   atol=1e-6, err_msg=f)


def test_production_step_compiles_and_is_finite(prod):
    """Both phase programs of the shipped conf compile on the card and give a
    finite loss."""
    conf, statics, params, _ = prod
    tcfg = steplib.train_conf(conf)
    rcfg = steplib.apply_runtime_flags(rnd.renderer_conf(conf["model"]),
                                       tcfg)
    scene = ds.make_sphere_scene(n_views=3, H=128, W=128, radius=0.35)
    for warmup in (True, False):
        fn = steplib.make_train_step(statics, rcfg, tcfg, warmup, False,
                                     donate=False)
        state = steplib.init_train_state(params, tcfg)
        state, m = fn(state, scene.arrays, 0, jax.random.PRNGKey(1))
        assert np.isfinite(float(m["loss"])), warmup
