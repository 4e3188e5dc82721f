"""Neural fields as pure-function param pytrees (no Module framework).

Re-designs the reference's four torch networks (`/root/reference/models/fields.py`)
as (static config, init, apply) triples over explicit param dicts — the shape
jit/grad/shard_map want. Param pytrees contain ONLY arrays (optax-safe); all
static hyperparameters live in frozen dataclasses that are hashable and can be
closed over / passed as static args.

Parity-critical details preserved:

  * SDFNetwork (`fields.py:8-127`): 8x256 MLP, skip concat at layer 4 divided by
    sqrt(2), Softplus(beta=100), geometric init to a unit sphere (last layer
    mean ±sqrt(pi)/sqrt(fan_in), PE channels zeroed at layer 0 and at the skip
    layer), weight normalization, input `scale`, output `[sdf/scale, feature]`.
  * RenderingNetwork (`fields.py:131-215`): modes idr/no_view_dir/no_normal/ps;
    PE(multires_view) applied to points *and* normals *and* view dirs; ReLU
    hidden; sigmoid squeeze. Interpreted as albedo by the RNb renderer.
  * NeRF background (`fields.py:219-314`): 8x256, skip [4] applied *after*
    layer 4, viewdirs head (feature -> cat views -> W/2 -> rgb).
  * SingleVarianceNetwork (`fields.py:317-325`): scalar param, inv_s=exp(10v).

∇SDF: two implementations replace torch's per-call double backprop
(`fields.py:114-127`): a batched jax.vjp (sdf_value_feat_grad, the
renderer's default, re-differentiated for the eikonal term) and a
forward-mode variant (sdf_value_feat_grad_fwd) that makes ∇SDF a primal
output; renderer.RendererConfig.core_impl picks one.

Weight layout: ``W`` is stored [in, out] so apply is ``x @ W + b`` (row-major
batch onto the matrix units). Weight-norm layers store ``{v: [in,out], g: [out], b}``
with effective ``W = v * g / ||v||_col`` (torch weight_norm dim=0 ≡ per-output
norm ≡ per-column here).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rnb_tpu.models.embedder import make_embedder

Params = Any


# ---------------------------------------------------------------------------
# linear layers (with optional weight norm)
# ---------------------------------------------------------------------------

def _torch_default_linear(key, fan_in: int, fan_out: int) -> Dict[str, jnp.ndarray]:
    """torch.nn.Linear default init: kaiming_uniform(a=sqrt(5)) == U(±1/sqrt(fan_in))
    for the weight, U(±1/sqrt(fan_in)) for the bias."""
    kw, kb = jax.random.split(key)
    bound = 1.0 / math.sqrt(fan_in)
    w = jax.random.uniform(kw, (fan_in, fan_out), jnp.float32, -bound, bound)
    b = jax.random.uniform(kb, (fan_out,), jnp.float32, -bound, bound)
    return {"w": w, "b": b}


def _to_weight_norm(layer: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
    """Reparameterize {w,b} -> {v,g,b} with w == v*g/||v||  (exact at init)."""
    w = layer["w"]
    g = jnp.linalg.norm(w, axis=0)  # per-output-column norm (torch dim=0)
    return {"v": w, "g": g, "b": layer["b"]}


def linear_apply(layer: Dict[str, jnp.ndarray], x: jnp.ndarray) -> jnp.ndarray:
    if "v" in layer:
        v = layer["v"]
        norm = jnp.linalg.norm(v, axis=0, keepdims=True)
        w = v * (layer["g"][None, :] / jnp.maximum(norm, 1e-12))
    else:
        w = layer["w"]
    return jnp.dot(x, w, preferred_element_type=jnp.float32) + layer["b"]


def softplus100(x: jnp.ndarray) -> jnp.ndarray:
    """Softplus with beta=100 (`fields.py:80`), numerically stable."""
    return jax.nn.softplus(x * 100.0) / 100.0


# ---------------------------------------------------------------------------
# SDF network
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SDFConfig:
    d_in: int = 3
    d_out: int = 257
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: Tuple[int, ...] = (4,)
    multires: int = 6
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = True
    weight_norm: bool = True
    inside_outside: bool = False

    @property
    def input_ch(self) -> int:
        return self.d_in * (1 + 2 * self.multires) if self.multires > 0 else self.d_in

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple([self.input_ch] + [self.d_hidden] * self.n_layers + [self.d_out])


def init_sdf_network(key, cfg: SDFConfig) -> List[Dict[str, jnp.ndarray]]:
    dims = cfg.dims
    num_layers = len(dims)
    layers = []
    keys = jax.random.split(key, num_layers - 1)
    for l in range(num_layers - 1):
        out_dim = dims[l + 1] - dims[0] if (l + 1) in cfg.skip_in else dims[l + 1]
        fan_in = dims[l]
        k = keys[l]
        if cfg.geometric_init:
            if l == num_layers - 2:
                mean = math.sqrt(math.pi) / math.sqrt(fan_in)
                b0 = -cfg.bias
                if cfg.inside_outside:
                    mean, b0 = -mean, cfg.bias
                w = mean + 1e-4 * jax.random.normal(k, (fan_in, out_dim))
                b = jnp.full((out_dim,), b0, jnp.float32)
            elif cfg.multires > 0 and l == 0:
                # only raw-coordinate rows get signal; PE rows start at zero
                w = jnp.zeros((fan_in, out_dim))
                w = w.at[:3, :].set(
                    math.sqrt(2.0) / math.sqrt(out_dim) * jax.random.normal(k, (3, out_dim))
                )
                b = jnp.zeros((out_dim,), jnp.float32)
            elif cfg.multires > 0 and l in cfg.skip_in:
                w = math.sqrt(2.0) / math.sqrt(out_dim) * jax.random.normal(k, (fan_in, out_dim))
                # zero the PE block of the concatenated skip input
                w = w.at[-(dims[0] - 3):, :].set(0.0)
                b = jnp.zeros((out_dim,), jnp.float32)
            else:
                w = math.sqrt(2.0) / math.sqrt(out_dim) * jax.random.normal(k, (fan_in, out_dim))
                b = jnp.zeros((out_dim,), jnp.float32)
            layer = {"w": w.astype(jnp.float32), "b": b}
        else:
            layer = _torch_default_linear(k, fan_in, out_dim)
        if cfg.weight_norm:
            layer = _to_weight_norm(layer)
        layers.append(layer)
    return layers


def sdf_apply(cfg: SDFConfig, params, x: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] -> [..., d_out]; channel 0 is the sdf (÷scale), rest is the
    geometry feature (`fields.py:82-104`)."""
    embed_fn, _ = make_embedder(cfg.multires, cfg.d_in)
    inputs = embed_fn(x * cfg.scale)
    h = inputs
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for l, layer in enumerate(params):
        if l in cfg.skip_in:
            h = jnp.concatenate([h, inputs], axis=-1) * inv_sqrt2
        h = linear_apply(layer, h)
        if l < len(params) - 1:
            h = softplus100(h)
    sdf = h[..., :1] / cfg.scale
    return jnp.concatenate([sdf, h[..., 1:]], axis=-1)


def sdf_only(cfg: SDFConfig, params, x: jnp.ndarray) -> jnp.ndarray:
    """SDF channel only. Slices the final layer to its first output column
    before the matmul (column-slicing commutes with per-column weight norm),
    skipping the 256-wide feature head — the reference's `sdf()` computes and
    discards it (`fields.py:106-108`), which costs ~12% of every up-sampling
    sweep and grid query."""
    last = params[-1]
    if "v" in last:
        sliced = {"v": last["v"][:, :1], "g": last["g"][:1], "b": last["b"][:1]}
    else:
        sliced = {"w": last["w"][:, :1], "b": last["b"][:1]}
    return sdf_apply(cfg, params[:-1] + [sliced], x)[..., 0]


def sdf_only_lowp(cfg: SDFConfig, params, x: jnp.ndarray) -> jnp.ndarray:
    """bf16 SDF inference for the no-grad up-sampling sweeps.

    The 5 per-step up-sampling sweeps (`/root/reference/models/renderer.py:
    965-984`) only *place samples* — their SDF values never enter the loss, so
    bf16 matmuls are safe there. Kept precise where it's cheap: weight-norm folding, positional
    encoding and softplus stay f32; only matmul operands are bf16 with f32
    accumulation. The differentiable path (sdf_value_feat_grad) is untouched.
    """
    embed_fn, _ = make_embedder(cfg.multires, cfg.d_in)
    inputs = embed_fn(x * cfg.scale).astype(jnp.bfloat16)
    # fold weight norm in f32, slice the sdf head, cast once
    dense = []
    for layer in params:
        if "v" in layer:
            v = layer["v"]
            norm = jnp.linalg.norm(v, axis=0, keepdims=True)
            w = v * (layer["g"][None, :] / jnp.maximum(norm, 1e-12))
        else:
            w = layer["w"]
        dense.append((w, layer["b"]))
    w_last, b_last = dense[-1]
    dense = dense[:-1] + [(w_last[:, :1], b_last[:1])]

    h = inputs
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for l, (w, b) in enumerate(dense):
        if l in cfg.skip_in:
            h = (jnp.concatenate([h, inputs], axis=-1) * inv_sqrt2)
        h = jnp.dot(h.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32) + b
        if l < len(dense) - 1:
            h = softplus100(h).astype(jnp.bfloat16)
    return h[..., 0] / cfg.scale


def sdf_value_feat_grad(cfg: SDFConfig, params, pts: jnp.ndarray):
    """One fused pass: sdf [N], feature [N,F], gradient d sdf/d pts [N,3].

    One batched reverse sweep (vjp with a cotangent selecting the sdf channel);
    jax re-differentiates through it for the second-order eikonal term.
    Replaces `fields.py:114-127`.
    """
    out, pullback = jax.vjp(lambda p: sdf_apply(cfg, params, p), pts)
    cot = jnp.zeros_like(out).at[..., 0].set(1.0)
    (grad,) = pullback(cot)
    return out[..., 0], out[..., 1:], grad


def sdf_value_feat_grad_fwd(cfg: SDFConfig, params, pts: jnp.ndarray):
    """Same outputs as sdf_value_feat_grad, restructured so ∇SDF comes from
    FORWARD-mode tangents carried as a [N, 3, C] tensor alongside the primal
    chain (one extra batched dot per layer instead of a reverse sweep).

    Why this exists: with the vjp formulation the eikonal term makes the
    training loss second-order in the SDF params — XLA differentiates a
    vjp-of-vjp program whose intermediates round-trip device memory. Here the
    gradient is a *primal* output of a plain feed-forward chain, so the loss
    is FIRST-order in it, at the price of a [N, 3, C] tangent per layer.
    Numerics: identical math in the same f32/matmul-precision regime
    (tests/test_fields.py::test_fwdmode_core_matches_vjp_core).
    """
    N = pts.shape[0]
    u = pts * cfg.scale
    # e = PE(u) [N, in]; T = de/du [N, 3, in] (dense; nonzeros sit in the
    # channel block of their own coordinate)
    e_parts = [u]
    t_parts = [jnp.broadcast_to(jnp.eye(3, dtype=pts.dtype), (N, 3, 3))]
    eye = jnp.eye(3, dtype=pts.dtype)
    for k in range(cfg.multires):
        f = 2.0 ** k
        s, c = jnp.sin(u * f), jnp.cos(u * f)
        e_parts += [s, c]
        # d sin(f u_j)/d u_d = f cos(f u_j) δ_jd  -> [N,3(dir),3(chan)]
        t_parts += [f * c[:, None, :] * eye[None],
                    -f * s[:, None, :] * eye[None]]
    e = jnp.concatenate(e_parts, axis=-1)          # [N, in]
    T = jnp.concatenate(t_parts, axis=-1)          # [N, 3, in]

    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    h, Th = e, T
    for l, layer in enumerate(params):
        if l in cfg.skip_in:
            h = jnp.concatenate([h, e], axis=-1) * inv_sqrt2
            Th = jnp.concatenate([Th, T], axis=-1) * inv_sqrt2
        if "v" in layer:
            v = layer["v"]
            norm = jnp.linalg.norm(v, axis=0, keepdims=True)
            w = v * (layer["g"][None, :] / jnp.maximum(norm, 1e-12))
        else:
            w = layer["w"]
        z = jnp.dot(h, w, preferred_element_type=jnp.float32) + layer["b"]
        Tz = jnp.einsum("ndi,io->ndo", Th, w,
                        preferred_element_type=jnp.float32)
        if l < len(params) - 1:
            s = jax.nn.sigmoid(z * 100.0)
            h = jax.nn.softplus(z * 100.0) / 100.0
            Th = Tz * s[:, None, :]
        else:
            sdf = z[:, 0] / cfg.scale
            feat = z[:, 1:]
            # d sdf/d x: the 1/scale and the PE input scale cancel
            grad = Tz[:, :, 0]
    return sdf, feat, grad


# ---------------------------------------------------------------------------
# Rendering (albedo) network
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RenderingConfig:
    d_feature: int = 256
    mode: str = "no_view_dir"
    d_in: int = 6
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 2
    weight_norm: bool = True
    multires_view: int = 4
    squeeze_out: bool = True

    @property
    def dims(self) -> Tuple[int, ...]:
        input_ch = 3 * (1 + 2 * self.multires_view) if self.multires_view > 0 else 3
        d0 = self.d_in + self.d_feature
        if self.multires_view > 0:
            if self.mode == "no_view_dir":
                d0 += 2 * (input_ch - 3)  # `fields.py:156-157`
            elif self.mode == "ps":
                d0 = input_ch             # `fields.py:158-159`
            elif self.mode == "idr":
                d0 += 3 * (input_ch - 3)
            elif self.mode == "no_normal":
                d0 += 2 * (input_ch - 3)
        return tuple([d0] + [self.d_hidden] * self.n_layers + [self.d_out])


def init_rendering_network(key, cfg: RenderingConfig) -> List[Dict[str, jnp.ndarray]]:
    dims = cfg.dims
    layers = []
    keys = jax.random.split(key, len(dims) - 1)
    for l in range(len(dims) - 1):
        layer = _torch_default_linear(keys[l], dims[l], dims[l + 1])
        if cfg.weight_norm:
            layer = _to_weight_norm(layer)
        layers.append(layer)
    return layers


def rendering_apply(cfg: RenderingConfig, params, points, normals, view_dirs,
                    feature_vectors) -> jnp.ndarray:
    if cfg.multires_view > 0:
        embed_fn, _ = make_embedder(cfg.multires_view, 3)
        points = embed_fn(points)
        normals = embed_fn(normals)
        if view_dirs is not None:
            view_dirs = embed_fn(view_dirs)
    if cfg.mode == "idr":
        h = jnp.concatenate([points, view_dirs, normals, feature_vectors], axis=-1)
    elif cfg.mode == "no_view_dir":
        h = jnp.concatenate([points, normals, feature_vectors], axis=-1)
    elif cfg.mode == "no_normal":
        h = jnp.concatenate([points, view_dirs, feature_vectors], axis=-1)
    elif cfg.mode == "ps":
        h = points
    else:
        raise ValueError(f"unknown rendering mode {cfg.mode!r}")

    want = cfg.dims[0]
    if h.shape[-1] != want:
        raise ValueError(
            f"rendering_network input is {h.shape[-1]}-d but the conf implies "
            f"{want}-d (d_in={cfg.d_in}, mode={cfg.mode!r}, "
            f"multires_view={cfg.multires_view}, d_feature={cfg.d_feature}); "
            f"for mode 'no_view_dir' d_in must count points+normals only (6, "
            f"`/root/reference/confs/wmask_rnb.conf:74`)")

    for l, layer in enumerate(params):
        h = linear_apply(layer, h)
        if l < len(params) - 1:
            h = jax.nn.relu(h)
    if cfg.squeeze_out:
        h = jax.nn.sigmoid(h)
    return h


# ---------------------------------------------------------------------------
# Background NeRF (inverted-sphere coords; only evaluated when n_outside>0)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    D: int = 8
    W: int = 256
    d_in: int = 4
    d_in_view: int = 3
    multires: int = 10
    multires_view: int = 4
    output_ch: int = 4
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True

    @property
    def input_ch(self) -> int:
        return self.d_in * (1 + 2 * self.multires) if self.multires > 0 else self.d_in

    @property
    def input_ch_view(self) -> int:
        return (self.d_in_view * (1 + 2 * self.multires_view)
                if self.multires_view > 0 else self.d_in_view)


def init_nerf(key, cfg: NeRFConfig) -> Dict[str, Any]:
    keys = jax.random.split(key, cfg.D + 4)
    pts_layers = [_torch_default_linear(keys[0], cfg.input_ch, cfg.W)]
    for i in range(cfg.D - 1):
        fan_in = cfg.W + cfg.input_ch if i in cfg.skips else cfg.W
        pts_layers.append(_torch_default_linear(keys[i + 1], fan_in, cfg.W))
    return {
        "pts_layers": pts_layers,
        "views_layer": _torch_default_linear(keys[cfg.D], cfg.input_ch_view + cfg.W, cfg.W // 2),
        "feature_layer": _torch_default_linear(keys[cfg.D + 1], cfg.W, cfg.W),
        "alpha_layer": _torch_default_linear(keys[cfg.D + 2], cfg.W, 1),
        "rgb_layer": _torch_default_linear(keys[cfg.D + 3], cfg.W // 2, 3),
    }


def nerf_apply(cfg: NeRFConfig, params, input_pts, input_views):
    """Returns (density_raw [N,1], rgb_raw [N,3]) like `fields.py:281-312`."""
    # a skip at the final pts layer would leave h at W+input_ch entering the
    # alpha/feature heads (which expect W) — invalid in the reference
    # architecture too (`fields.py:246-252`). Checked HERE (trace time, i.e.
    # only when the NeRF is actually evaluated, n_outside > 0) rather than
    # at init: configs with an invalid-but-unused background net trained
    # fine before and must keep doing so.
    if cfg.skips and max(cfg.skips) >= cfg.D - 1:
        raise ValueError(
            f"nerf skips {cfg.skips} must be < D-1 = {cfg.D - 1} (a skip at "
            "the final pts layer breaks the alpha/feature head widths)")
    if cfg.multires > 0:
        embed_fn, _ = make_embedder(cfg.multires, cfg.d_in)
        input_pts = embed_fn(input_pts)
    if cfg.multires_view > 0:
        embed_fn_view, _ = make_embedder(cfg.multires_view, cfg.d_in_view)
        input_views = embed_fn_view(input_views)

    h = input_pts
    for i, layer in enumerate(params["pts_layers"]):
        h = jax.nn.relu(linear_apply(layer, h))
        if i in cfg.skips:
            h = jnp.concatenate([input_pts, h], axis=-1)

    assert cfg.use_viewdirs, "reference only supports use_viewdirs=True (`fields.py:313-314`)"
    alpha = linear_apply(params["alpha_layer"], h)
    feature = linear_apply(params["feature_layer"], h)
    h = jnp.concatenate([feature, input_views], axis=-1)
    h = jax.nn.relu(linear_apply(params["views_layer"], h))
    rgb = linear_apply(params["rgb_layer"], h)
    return alpha, rgb


# ---------------------------------------------------------------------------
# Single-variance (deviation) network
# ---------------------------------------------------------------------------

def init_variance(init_val: float = 0.3) -> Dict[str, jnp.ndarray]:
    return {"variance": jnp.asarray(init_val, jnp.float32)}


def variance_inv_s(params) -> jnp.ndarray:
    """inv_s = exp(10*v); clipped at use sites to [1e-6, 1e6] (`renderer.py:228`)."""
    return jnp.exp(params["variance"] * 10.0)


# ---------------------------------------------------------------------------
# Model bundle (statics + params)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelStatics:
    sdf: SDFConfig
    color: RenderingConfig
    nerf: NeRFConfig
    variance_init: float = 0.3


def statics_from_conf(conf_model) -> ModelStatics:
    """Build static net configs from a `model` config section (same schema as
    the reference confs, `confs/wmask_rnb.conf:41-90`)."""
    def kw(section, cls, listfields=()):
        if section not in conf_model:
            return cls()
        d = dict(conf_model[section].as_dict())
        for f in listfields:
            if f in d:
                d[f] = tuple(d[f])
        return cls(**d)

    var_init = 0.3
    if "variance_network" in conf_model:
        var_init = float(conf_model["variance_network"].get("init_val", 0.3))
    return ModelStatics(
        sdf=kw("sdf_network", SDFConfig, ("skip_in",)),
        color=kw("rendering_network", RenderingConfig),
        nerf=kw("nerf", NeRFConfig, ("skips",)),
        variance_init=var_init,
    )


def init_model_bundle(key, statics: ModelStatics) -> Dict[str, Any]:
    knerf, ksdf, kcolor = jax.random.split(key, 3)
    return {
        "nerf": init_nerf(knerf, statics.nerf),
        "sdf": init_sdf_network(ksdf, statics.sdf),
        "variance": init_variance(statics.variance_init),
        "color": init_rendering_network(kcolor, statics.color),
    }


def param_count(params) -> int:
    return int(sum(np.prod(x.shape) for x in jax.tree_util.tree_leaves(params)))
