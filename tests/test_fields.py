"""Unit tests for embedder + neural fields (closed-form property checks,
SURVEY.md §4: "unit tests for pure math")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnb_tpu.models import fields
from rnb_tpu.models.embedder import make_embedder, embedder_out_dim


def test_embedder_layout_and_values():
    """[x, sin(f0 x), cos(f0 x), sin(f1 x), ...] with f_k = 2^k
    (`/root/reference/models/embedder.py:32-46`)."""
    embed, out_dim = make_embedder(4, 3)
    assert out_dim == 3 * (1 + 2 * 4) == embedder_out_dim(4, 3)
    x = jnp.asarray([[0.3, -0.7, 1.1]])
    e = np.asarray(embed(x))[0]
    xs = np.asarray(x)[0]
    np.testing.assert_allclose(e[:3], xs, rtol=1e-6)
    for k in range(4):
        f = 2.0 ** k
        np.testing.assert_allclose(e[3 + 6 * k: 6 + 6 * k], np.sin(xs * f), rtol=1e-5)
        np.testing.assert_allclose(e[6 + 6 * k: 9 + 6 * k], np.cos(xs * f), rtol=1e-5)


def test_embedder_identity_when_disabled():
    embed, out_dim = make_embedder(0, 3)
    assert out_dim == 3
    x = jnp.ones((5, 3))
    np.testing.assert_array_equal(np.asarray(embed(x)), np.ones((5, 3)))


@pytest.fixture(scope="module")
def sdf_cfg():
    return fields.SDFConfig()


@pytest.fixture(scope="module")
def sdf_params(sdf_cfg):
    return fields.init_sdf_network(jax.random.PRNGKey(0), sdf_cfg)


def test_sdf_geometric_init_approximates_sphere(sdf_cfg, sdf_params):
    """Geometric init ⇒ sdf(x) ≈ |x| - bias near the origin region
    (`fields.py:51-70`): check monotone radial growth and zero-level near r≈0.5."""
    rs = np.linspace(0.05, 1.2, 24)
    dirs = np.random.default_rng(0).normal(size=(16, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = (rs[:, None, None] * dirs[None, :, :]).reshape(-1, 3)
    sdf = np.asarray(fields.sdf_only(sdf_cfg, sdf_params, jnp.asarray(pts)))
    sdf = sdf.reshape(len(rs), len(dirs))
    mean_r = sdf.mean(axis=1)
    # strictly increasing in radius
    assert np.all(np.diff(mean_r) > 0)
    # zero crossing close to r = bias = 0.5
    zero_r = rs[np.argmin(np.abs(mean_r))]
    assert abs(zero_r - 0.5) < 0.15
    # approximate eikonal property of the init: |∇sdf| ≈ 1
    _, _, grad = fields.sdf_value_feat_grad(sdf_cfg, sdf_params, jnp.asarray(pts))
    gn = np.linalg.norm(np.asarray(grad), axis=-1)
    assert 0.5 < gn.mean() < 2.0


def test_sdf_output_shapes(sdf_cfg, sdf_params):
    x = jnp.zeros((7, 3))
    out = fields.sdf_apply(sdf_cfg, sdf_params, x)
    assert out.shape == (7, 257)
    sdf, feat, grad = fields.sdf_value_feat_grad(sdf_cfg, sdf_params, x)
    assert sdf.shape == (7,) and feat.shape == (7, 256) and grad.shape == (7, 3)


def test_sdf_scale_invariance_of_zero_level():
    """`scale` rescales input and divides the sdf back (`fields.py:84,104`)."""
    key = jax.random.PRNGKey(1)
    cfg1 = fields.SDFConfig(scale=1.0)
    cfg2 = fields.SDFConfig(scale=2.0)
    p = fields.init_sdf_network(key, cfg1)
    x = jax.random.normal(jax.random.PRNGKey(2), (11, 3)) * 0.4
    s1 = fields.sdf_only(cfg1, p, x)
    s2 = fields.sdf_only(cfg2, p, x / 2.0)  # same effective network input
    np.testing.assert_allclose(np.asarray(s1), np.asarray(2.0 * s2), rtol=1e-5)


def test_grad_matches_per_point_autodiff(sdf_cfg, sdf_params):
    """The batched-vjp gradient must equal per-point jax.grad (independent
    code path). Finite differences are unreliable here: Softplus(beta=100)
    concentrates curvature at the 0.01 scale, so central differences straddle
    near-kinks for any usable f32 epsilon."""
    pts = jnp.asarray(np.random.default_rng(3).normal(size=(5, 3)) * 0.4,
                      jnp.float32)
    _, _, grad = fields.sdf_value_feat_grad(sdf_cfg, sdf_params, pts)
    gref = jax.vmap(jax.grad(lambda x: fields.sdf_only(sdf_cfg, sdf_params,
                                                       x[None])[0]))(pts)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(gref), atol=5e-3)


def test_weight_norm_reparameterization_exact_at_init():
    """{w,b} -> {v,g,b} must reproduce the same effective weight."""
    layer = fields._torch_default_linear(jax.random.PRNGKey(4), 16, 8)
    wn = fields._to_weight_norm(dict(layer))
    x = jax.random.normal(jax.random.PRNGKey(5), (3, 16))
    np.testing.assert_allclose(np.asarray(fields.linear_apply(layer, x)),
                               np.asarray(fields.linear_apply(wn, x)), rtol=1e-5)


def test_rendering_network_shapes_and_range():
    cfg = fields.RenderingConfig()
    assert cfg.dims[0] == 310  # PE(pts) 27 + PE(normals) 27 + feature 256
    params = fields.init_rendering_network(jax.random.PRNGKey(6), cfg)
    pts = jnp.zeros((9, 3))
    out = fields.rendering_apply(cfg, params, pts, pts, pts, jnp.zeros((9, 256)))
    assert out.shape == (9, 3)
    o = np.asarray(out)
    assert np.all(o > 0) and np.all(o < 1)  # sigmoid squeeze


def test_rendering_network_ignores_view_dirs_in_no_view_dir_mode():
    cfg = fields.RenderingConfig(mode="no_view_dir")
    params = fields.init_rendering_network(jax.random.PRNGKey(7), cfg)
    pts = jnp.ones((4, 3)) * 0.2
    feat = jnp.ones((4, 256)) * 0.1
    a = fields.rendering_apply(cfg, params, pts, pts, jnp.ones((4, 3)), feat)
    b = fields.rendering_apply(cfg, params, pts, pts, -jnp.ones((4, 3)), feat)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_nerf_apply_shapes():
    cfg = fields.NeRFConfig()
    params = fields.init_nerf(jax.random.PRNGKey(8), cfg)
    alpha, rgb = fields.nerf_apply(cfg, params, jnp.zeros((5, 4)), jnp.zeros((5, 3)))
    assert alpha.shape == (5, 1) and rgb.shape == (5, 3)


def test_variance_network():
    p = fields.init_variance(0.3)
    np.testing.assert_allclose(float(fields.variance_inv_s(p)), np.exp(3.0), rtol=1e-5)


def test_param_pytree_is_optax_safe():
    """Param pytrees must contain only arrays (no strings/config leaves)."""
    import optax
    statics = fields.ModelStatics(sdf=fields.SDFConfig(),
                                  color=fields.RenderingConfig(),
                                  nerf=fields.NeRFConfig())
    params = fields.init_model_bundle(jax.random.PRNGKey(9), statics)
    for leaf in jax.tree_util.tree_leaves(params):
        assert hasattr(leaf, "dtype")
    opt = optax.adam(1e-3)
    state = opt.init(params)
    grads = jax.tree_util.tree_map(jnp.zeros_like, params)
    updates, _ = opt.update(grads, state, params)
    assert all(np.all(np.asarray(u) == 0) for u in jax.tree_util.tree_leaves(updates))


def test_sdf_only_lowp_close_to_f32(sdf_cfg, sdf_params):
    """bf16 inference path used by the up-sampling sweeps: must track the f32
    SDF to bf16 tolerance (values only place samples, never enter the loss)."""
    pts = jnp.asarray(np.random.default_rng(1).normal(size=(256, 3)) * 0.6,
                      jnp.float32)
    ref = np.asarray(fields.sdf_only(sdf_cfg, sdf_params, pts))
    low = np.asarray(fields.sdf_only_lowp(sdf_cfg, sdf_params, pts))
    assert low.dtype == np.float32
    np.testing.assert_allclose(low, ref, atol=0.02)
    # correlation-preserving: ordering of well-separated values is kept
    assert np.corrcoef(ref, low)[0, 1] > 0.999


def test_nerf_invalid_skip_raises_at_apply():
    """A skip at the final pts layer is invalid (breaks the head widths) but
    must fail only when the NeRF is EVALUATED — configs with an unused
    background net (n_outside=0) construct and train fine."""
    import jax
    import jax.numpy as jnp
    import pytest

    from rnb_tpu.models import fields

    cfg = fields.NeRFConfig(D=2, W=32, multires=4, multires_view=2,
                            skips=(1,))
    params = fields.init_nerf(jax.random.PRNGKey(0), cfg)  # must NOT raise
    pts = jnp.zeros((4, 4))
    views = jnp.zeros((4, 3))
    with pytest.raises(ValueError, match="skips"):
        fields.nerf_apply(cfg, params, pts, views)


@pytest.mark.parametrize("skip_in", [(4,), ()])
def test_fwdmode_core_matches_vjp_core(skip_in):
    """sdf_value_feat_grad_fwd (∇SDF as a primal output) equals the
    reverse-mode core in values and in the second-order parameter gradients
    of an eikonal loss, at f32 'highest'."""
    cfg = fields.SDFConfig(d_hidden=64, skip_in=skip_in)
    params = fields.init_sdf_network(jax.random.PRNGKey(1), cfg)
    pts = jax.random.uniform(jax.random.PRNGKey(2), (256, 3), minval=-0.9,
                             maxval=0.9)

    def eik_loss(core):
        def loss(p):
            sdf, feat, g = core(cfg, p, pts)
            return (((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2).mean()
                    + sdf.mean() + 1e-2 * feat.mean())
        return loss

    with jax.default_matmul_precision("highest"):
        a = fields.sdf_value_feat_grad(cfg, params, pts)
        b = fields.sdf_value_feat_grad_fwd(cfg, params, pts)
        ga = jax.grad(eik_loss(fields.sdf_value_feat_grad))(params)
        gb = jax.grad(eik_loss(fields.sdf_value_feat_grad_fwd))(params)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=1e-5,
                                   atol=1e-6)
    for x, y in zip(jax.tree_util.tree_leaves(ga),
                    jax.tree_util.tree_leaves(gb)):
        scale = float(np.abs(np.asarray(x)).max()) + 1e-12
        np.testing.assert_allclose(np.asarray(y) / scale,
                                   np.asarray(x) / scale, atol=1e-5)


@pytest.mark.parametrize("core", ["vjp", "fwdmode"])
def test_core_is_per_point_under_padding(sdf_cfg, sdf_params, core):
    """Each point's (sdf, feature, ∇SDF) depends on that point alone, so
    padding a batch (as validation and extraction do) leaves the real rows
    unchanged."""
    fn = {"vjp": fields.sdf_value_feat_grad,
          "fwdmode": fields.sdf_value_feat_grad_fwd}[core]
    pts = jax.random.uniform(jax.random.PRNGKey(3), (100, 3), minval=-1.0,
                             maxval=1.0)
    padded = jnp.concatenate([pts, jnp.zeros((28, 3))])
    with jax.default_matmul_precision("highest"):
        a = jax.jit(fn, static_argnums=0)(sdf_cfg, sdf_params, pts)
        b = jax.jit(fn, static_argnums=0)(sdf_cfg, sdf_params, padded)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(y)[:100], np.asarray(x),
                                   rtol=1e-5, atol=1e-6)


def test_check_grads_rendering_apply():
    """Reverse-mode gradients (and their gradients) of the albedo net match
    finite differences (the net computes in f32: linear_apply accumulates in
    f32, so the check uses check_grads' f32 tolerances)."""
    from jax.test_util import check_grads
    cfg = fields.RenderingConfig(d_hidden=32)
    params = fields.init_rendering_network(jax.random.PRNGKey(4), cfg)
    k = jax.random.split(jax.random.PRNGKey(5), 3)
    pts = jax.random.normal(k[0], (8, 3)) * 0.3
    nrm = jax.random.normal(k[1], (8, 3))
    feat = jax.random.normal(k[2], (8, cfg.d_feature))
    with jax.default_matmul_precision("highest"):
        check_grads(lambda p, x, n, f: fields.rendering_apply(cfg, p, x, n,
                                                              None, f),
                    (params, pts, nrm, feat), order=2, modes=["rev"])


def test_check_grads_nerf_apply():
    """Reverse-mode gradients of the background NeRF match finite
    differences (f32, as above)."""
    from jax.test_util import check_grads
    cfg = fields.NeRFConfig(D=4, W=32, skips=(2,), multires=3, multires_view=2)
    params = fields.init_nerf(jax.random.PRNGKey(6), cfg)
    k = jax.random.split(jax.random.PRNGKey(7), 2)
    pts = jax.random.normal(k[0], (8, 4)) * 0.3
    dirs = jax.random.normal(k[1], (8, 3))
    with jax.default_matmul_precision("highest"):
        check_grads(lambda p, x, d: jnp.concatenate(
            fields.nerf_apply(cfg, p, x, d), -1), (params, pts, dirs),
            order=1, modes=["rev"])
