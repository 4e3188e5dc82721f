#!/usr/bin/env python
"""Emit a synthetic sphere scene to disk in the IDR data layout the loader
expects (`/root/reference/models/dataset.py:99-253`):

    data/<case>/cameras.npz   (world_mat_i, scale_mat_i)
    data/<case>/normal/NNN.png
    data/<case>/albedo/NNN.png
    data/<case>/mask/NNN.png

Lets the full CLI path (exp_runner.py --mode train_rnb --case <case>) run
without DiLiGenT-MV downloads; also the fixture for CLI-level tests.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rnb_tpu.data import dataset as ds  # noqa: E402
from rnb_tpu.utils import io  # noqa: E402


def degrade_capture(normals: np.ndarray, albedos: np.ndarray,
                    masks: np.ndarray, world_mats: list, H: int, W: int,
                    normal_noise_deg: float = 3.0, mask_morph_px: int = 2,
                    focal_err: float = 0.002, seed: int = 1):
    """Degrade a clean synthetic capture the way SDM-UniPS photometric-stereo
    estimates are degraded relative to ground truth (the reference consumes
    exactly such estimates, `/root/reference/models/dataset.py:141-151`,
    `README.md:84`):

      * per-pixel angular noise on the normals (~N(0, normal_noise_deg)
        rotation about a random tangent axis — SDM-UniPS residuals are a
        few degrees RMS);
      * mask boundary erosion/dilation up to mask_morph_px (segmentation
        masks never trace the silhouette exactly; alternating sign per view
        like real over/under-segmentation);
      * mild multiplicative albedo shading residual (PS albedo absorbs
        low-frequency shading errors);
      * +/-focal_err relative focal miscalibration per view (calibration is
        never perfect) — applied to the STORED camera matrices while the
        maps stay rendered with the true camera.

    8-bit quantization is applied downstream by writing the PNGs at
    bit_depth=8. Returns degraded (normals, albedos, masks, world_mats)."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    V = masks.shape[0]
    normals = normals.copy()
    albedos = albedos.copy()
    masks_out = np.empty_like(masks)
    world_out = []

    sigma = np.deg2rad(normal_noise_deg)
    for v in range(V):
        n = normals[v]
        m = masks[v] > 0.5
        # tangent-plane Gaussian perturbation: for unit n and tangent t,
        # normalize(n + tan(theta) t) rotates n by theta toward t; theta is
        # N(0, sigma) per pixel with a random tangent direction
        t = rng.normal(size=n.shape)
        t -= (t * n).sum(-1, keepdims=True) * n
        t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
        theta = rng.normal(0.0, sigma, size=n.shape[:2] + (1,))
        n_noisy = n + np.tan(theta) * t
        n_noisy /= np.maximum(np.linalg.norm(n_noisy, axis=-1, keepdims=True),
                              1e-12)
        normals[v] = np.where(m[..., None], n_noisy, 0.0)

        # boundary morphology: alternate erode/dilate across views, random
        # radius in [1, mask_morph_px]
        r = int(rng.integers(1, mask_morph_px + 1))
        if v % 2 == 0:
            m_new = ndimage.binary_erosion(m, iterations=r)
        else:
            m_new = ndimage.binary_dilation(m, iterations=r)
        masks_out[v] = m_new.astype(masks.dtype)

        # low-frequency multiplicative albedo residual (smooth field,
        # +/-5%): a coarse noise grid upsampled to full res
        g = 1.0 + rng.normal(0.0, 0.05, size=(6, 6))
        field = np.asarray(io.resize_image(
            np.repeat(g[..., None], 3, axis=-1).astype(np.float32), W, H))
        albedos[v] = np.clip(albedos[v] * np.clip(field, 0.8, 1.2), 0.0, 1.0)

        # focal miscalibration on the stored projection: P' = K' K^-1 P
        eps = rng.uniform(-focal_err, focal_err)
        focal = 1.2 * max(H, W)
        K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]])
        Kp = K.copy()
        Kp[0, 0] *= 1.0 + eps
        Kp[1, 1] *= 1.0 + eps
        wm = np.asarray(world_mats[v]).copy()
        wm[:3, :4] = Kp @ np.linalg.inv(K) @ wm[:3, :4]
        world_out.append(wm.astype(np.float32))

    return normals, albedos, masks_out, world_out


def write_case(out_dir: str, n_views: int = 8, H: int = 128, W: int = 128,
               radius: float = 0.4, seed: int = 0,
               shape: str = "sphere", degrade: bool = False,
               normal_noise_deg: float = 3.0, mask_morph_px: int = 2,
               focal_err: float = 0.002, center=(0.0, 0.0, 0.0),
               normalize: bool = False) -> str:
    """normalize=True: write the capture UN-normalized (identity scale mats,
    object possibly off-origin via `center`), then run our own scene
    normalization (preprocess/preprocess_cameras.py) on it — the resulting
    cameras.npz carries genuinely non-identity scale mats, exercising the L0
    preprocessing stage in the loop exactly as a real capture would
    (`/root/reference/models/dataset.py:197-205`)."""
    if shape == "torus":
        scene = ds.make_torus_scene(n_views=n_views, H=H, W=W, seed=seed,
                                    center=center)
    else:
        scene = ds.make_sphere_scene(n_views=n_views, H=H, W=W, radius=radius,
                                     seed=seed)
    os.makedirs(out_dir, exist_ok=True)

    normals = np.asarray(scene.arrays.normals)
    albedos = np.asarray(scene.arrays.albedos)
    masks = np.asarray(scene.arrays.masks)
    world_mats = scene.world_mats_np
    bit_depth = 16
    if degrade:
        normals, albedos, masks, world_mats = degrade_capture(
            normals, albedos, masks, world_mats, H, W,
            normal_noise_deg=normal_noise_deg, mask_morph_px=mask_morph_px,
            focal_err=focal_err, seed=seed + 1)
        bit_depth = 8   # SDM-UniPS exports 8-bit maps

    cams = {}
    for i in range(n_views):
        cams[f"world_mat_{i}"] = world_mats[i]
        cams[f"scale_mat_{i}"] = scene.scale_mats_np[i]
    np.savez(os.path.join(out_dir, "cameras.npz"), **cams)

    for i in range(n_views):
        io.save_normal(os.path.join(out_dir, "normal", f"{i:03d}.png"),
                       normals[i], bit_depth=bit_depth)
        io.save_image(os.path.join(out_dir, "albedo", f"{i:03d}.png"),
                      albedos[i], bit_depth=bit_depth)
        io.save_image(os.path.join(out_dir, "mask", f"{i:03d}.png"),
                      np.stack([masks[i]] * 3, axis=-1))

    if normalize:
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "preprocess"))
        from preprocess_cameras import get_normalization
        # refine_hull: the raw IDR epipolar estimate sets scale to the
        # flattened std of the interval-endpoint cloud — for this torus
        # geometry that is ~0.5x the object radius, which maps the object
        # OUTSIDE the unit sphere NeuS assumes (measured: scale 0.36 for a
        # 0.72-radius torus -> normalized radius 2.0, reconstruction
        # Chamfer 0.094). The visual-hull refinement (mean hull distance
        # x 3, `/root/reference/preprocess/preprocess_cameras.py:152-155`)
        # bounds the object at ~0.4-0.5 of the unit sphere instead.
        get_normalization(out_dir, seed=seed, refine_hull=True)
    return out_dir


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="./data/sphere")
    ap.add_argument("--n_views", type=int, default=8)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--width", type=int, default=0,
                    help="image width (default: --size; set W != H for "
                         "non-square captures like DiLiGenT's 612x512)")
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--center", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                    help="world-space object center (torus only)")
    ap.add_argument("--normalize", action="store_true",
                    help="write un-normalized, then run our scene "
                         "normalization (non-identity scale mats)")
    ap.add_argument("--radius", type=float, default=0.4)
    ap.add_argument("--shape", default="sphere", choices=["sphere", "torus"])
    ap.add_argument("--degrade", action="store_true",
                    help="apply SDM-UniPS-like capture degradation (normal "
                         "noise, mask morphology, 8-bit maps, focal error)")
    ap.add_argument("--normal_noise_deg", type=float, default=3.0)
    ap.add_argument("--mask_morph_px", type=int, default=2)
    ap.add_argument("--focal_err", type=float, default=0.002)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    path = write_case(args.out, args.n_views,
                      args.height or args.size, args.width or args.size,
                      args.radius, seed=args.seed, shape=args.shape,
                      degrade=args.degrade,
                      normal_noise_deg=args.normal_noise_deg,
                      mask_morph_px=args.mask_morph_px,
                      focal_err=args.focal_err, center=tuple(args.center),
                      normalize=args.normalize)
    print(f"wrote synthetic case to {path}"
          + (" (degraded capture)" if args.degrade else "")
          + (" (self-normalized)" if args.normalize else ""))
