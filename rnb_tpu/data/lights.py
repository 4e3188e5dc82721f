"""Virtual photometric-stereo lights — the RNb core idea, on device.

The reference materializes per-pixel light directions by running a 3x3 SVD of
``n n^T`` at every pixel of every view at dataset-load time
(`/root/reference/models/dataset.py:255-298`) and keeps multi-GB
``[n_views, n_lights, H, W, 3]`` tensors resident on the host
(`dataset.py:219-223`), gathering+uploading per iteration.

Here the per-pixel rotation is a *closed-form deterministic function of the
normal* (SURVEY.md §7 "hard parts" notes the SVD is just a frame completion):
the SVD of the rank-1 matrix ``n n^T`` yields an orthonormal basis whose first
column is ±n; the reference then permutes/sign-fixes columns so column 3 has a
non-negative camera-z component (`dataset.py:277-287`). Any deterministic
orthonormal completion with the same column-3 is mathematically equivalent for
both supervision synthesis and rendering: the GT shading is
``max(n·l, 0) = ||n||·cos(slant)`` independent of the tangent roll, and the
roll only picks which two tangent directions the three tilts probe — an
isotropic choice. We build the frame with a branchless helper-axis cross
construction, entirely on device, fused into the sampling gather. No SVDs, no
materialized light tensors, no host->device traffic per step.

Light geometry (`dataset.py:255-266`): tilts {0°,120°,240°}; slant 30° for the
warm-up's three fixed camera-space lights, arctan(sqrt(2)) ≈ 54.74° for the
per-pixel main lights, base dirs ``u = -[sinσ cosτ, sinσ sinτ, cosσ]``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# The light and ray geometry contracts over 3 components; it runs in full f32
# whatever the program's matmul precision (a TF32 dot would round directions
# and supervision colors to 10 mantissa bits), at negligible cost.
EXACT = jax.lax.Precision.HIGHEST

TILT_DEG = (0.0, 120.0, 240.0)
SLANT_WARMUP_DEG = 30.0
SLANT_MAIN_DEG = 54.74  # arctan(sqrt(2)), the photometric-stereo optimal slant
N_LIGHTS = 3


def base_light_dirs(slant_deg: float) -> np.ndarray:
    """[n_lights, 3] camera-space base dirs u_k = -[sinσcosτ, sinσsinτ, cosσ]
    (`dataset.py:262-266`)."""
    tilt = np.radians(TILT_DEG)
    slant = np.radians(slant_deg)
    u = -np.stack([
        np.sin(slant) * np.cos(tilt),
        np.sin(slant) * np.sin(tilt),
        np.full_like(tilt, np.cos(slant)),
    ], axis=-1)
    return u.astype(np.float32)  # [3 lights, 3]


def warmup_light_dirs_cam() -> np.ndarray:
    return base_light_dirs(SLANT_WARMUP_DEG)


def normal_frames(normals: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] camera-space normals -> [..., 3, 3] rotations (columns b1,b2,b3)
    with b3 = ±n̂ chosen so b3_z ≥ 0 (the reference's R[2,2] fix-up,
    `dataset.py:286-287`) and det = +1.

    Zero normals (background pixels) produce a finite arbitrary frame; their
    shading is zero anyway.
    """
    n = normals
    nz = n[..., 2:3]
    s = jnp.where(nz > 0, 1.0, -1.0)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    b3 = s * n / jnp.maximum(norm, 1e-12)
    # guard degenerate zero-normal: fall back to +z
    b3 = jnp.where(norm > 1e-8, b3, jnp.asarray([0.0, 0.0, 1.0]))

    use_y = jnp.abs(b3[..., 0:1]) > 0.9
    h = jnp.where(use_y, jnp.asarray([0.0, 1.0, 0.0]), jnp.asarray([1.0, 0.0, 0.0]))
    b1 = jnp.cross(h, b3)
    b1 = b1 / jnp.maximum(jnp.linalg.norm(b1, axis=-1, keepdims=True), 1e-12)
    b2 = jnp.cross(b3, b1)
    return jnp.stack([b1, b2, b3], axis=-1)  # columns


def per_pixel_light_dirs_cam(normals: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] normals -> [n_lights, ..., 3] camera-space per-pixel main
    lights l_k = R(n) u_k (`dataset.py:290-292`)."""
    R = normal_frames(normals)                   # [..., 3, 3]
    u = jnp.asarray(base_light_dirs(SLANT_MAIN_DEG))  # [L, 3]
    l = jnp.einsum("...ij,lj->l...i", R, u, precision=EXACT)
    return l


def shade(normals: jnp.ndarray, light_dirs: jnp.ndarray,
          albedo: jnp.ndarray | None) -> jnp.ndarray:
    """Lambertian supervision synthesis (`dataset.py:153-182`):
    image = albedo ⊙ max(n·l, 0), or the shading tiled to RGB when no albedo.

    normals [..., 3]; light_dirs [L, ..., 3] or [L, 3]; returns [L, ..., 3].
    """
    if light_dirs.ndim == 2:  # fixed lights: broadcast over pixels
        shaded = jnp.einsum("...c,lc->l...", normals, light_dirs,
                            precision=EXACT)
    else:
        shaded = (normals[None] * light_dirs).sum(-1)
    shaded = jnp.maximum(shaded, 0.0)[..., None]        # [L, ..., 1]
    if albedo is None:
        return jnp.broadcast_to(shaded, shaded.shape[:-1] + (3,))
    return albedo[None] * shaded
