#!/usr/bin/env python
"""Scene normalization (IDR preprocessing), reimplemented.

Equivalent of `/root/reference/preprocess/preprocess_cameras.py` (itself from
IDR): given per-view object masks and projection matrices ``world_mat_i =
K[R|t]``, estimate a 4x4 ``scale_mat`` placing the object inside the unit
sphere, and write it back into ``cameras.npz`` for every view.

Method (mirrors the reference pipeline, `preprocess_cameras.py:158-229`):
sample mask pixels in a reference view; for each, intersect the depth
intervals implied by every other view's silhouette along the epipolar line
(fundamental-matrix epipolar transfer + triangulation of silhouette points
near the line, `preprocess_cameras.py:53-83`); keep points observed in all
views; centroid + std of the surviving 3D points define the normalization.

Differences: triangulation is a vectorized numpy DLT (no OpenCV dependency),
and the sampling RNG is seedable for reproducibility.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np


def glob_imgs(path: str):
    imgs = []
    for ext in ("*.png", "*.jpg", "*.JPEG", "*.JPG"):
        imgs.extend(glob(os.path.join(path, ext)))
    return sorted(imgs)


def load_mask_points(masks_dir: str):
    """Per view: [3, N] homogeneous foreground pixel coordinates + binary mask."""
    from rnb_tpu.utils import io
    points_all, masks = [], []
    for path in glob_imgs(masks_dir):
        m = io.load_mask(path) > 0.5
        ys, xs = np.nonzero(m)
        points_all.append(
            np.stack([xs, ys, np.ones_like(xs)]).astype(np.float64))
        masks.append(m)
    return points_all, np.array(masks)


def camera_center(P: np.ndarray) -> np.ndarray:
    """Homogeneous right null vector of P."""
    _, _, vt = np.linalg.svd(P)
    C = vt[-1]
    return C / C[3]


def fundamental_matrix(P1: np.ndarray, P2: np.ndarray) -> np.ndarray:
    """F mapping points of camera-2's image to epipolar lines in camera-1's:
    F = [e]_x P1 P2^+ with e = P1 C2."""
    C2 = camera_center(P2)
    e = P1 @ C2
    ex = np.array([[0, -e[2], e[1]],
                   [e[2], 0, -e[0]],
                   [-e[1], e[0], 0]], dtype=np.float64)
    return ex @ P1 @ np.linalg.pinv(P2)


def triangulate_dlt(P0: np.ndarray, P1: np.ndarray, x0: np.ndarray,
                    x1: np.ndarray) -> np.ndarray:
    """Batched linear triangulation. x0 [2], x1 [2, N] -> X [4, N]."""
    n = x1.shape[1]
    A = np.empty((n, 4, 4), np.float64)
    A[:, 0] = x0[0] * P0[2] - P0[0]
    A[:, 1] = x0[1] * P0[2] - P0[1]
    A[:, 2] = x1[0][:, None] * P1[2][None] - P1[0][None]
    A[:, 3] = x1[1][:, None] * P1[2][None] - P1[1][None]
    _, _, vt = np.linalg.svd(A)
    X = vt[:, -1, :].T  # [4, N]
    return X


def depth_interval(curx: float, cury: float, P_j, sil_j, P_0, F_j0):
    """Min/max depth of ref-pixel (curx,cury) wrt camera 0, constrained by
    view j's silhouette (`preprocess_cameras.py:53-83`)."""
    line = F_j0 @ np.array([curx, cury, 1.0])
    line = line / np.linalg.norm(line[:2])
    dists = np.abs(sil_j.T @ line)
    candidates = sil_j[:, dists < 0.7]
    if candidates.shape[1] == 0:
        return 0.0, 0.0
    X = triangulate_dlt(P_0, P_j, np.array([curx, cury]), candidates[:2])
    with np.errstate(divide="ignore", invalid="ignore"):
        Xn = X / X[3]
    depths = P_0[2] @ Xn
    depths = depths[np.isfinite(depths) & (depths >= 0)]
    if depths.size == 0:
        return 0.0, 0.0
    return float(depths.min()), float(depths.max())


def estimate_normalization(Ps: np.ndarray, mask_points_all,
                           n_points: int = 100, seed: int = 0):
    """-> (scale_mat [4,4], kept 3D points [M,3])."""
    P0 = Ps[0]
    Fs = [fundamental_matrix(Ps[j], P0) for j in range(len(Ps))]
    C0 = camera_center(P0)

    xs = mask_points_all[0][0]
    ys = mask_points_all[0][1]
    rng = np.random.default_rng(seed)
    picks = rng.permutation(xs.shape[0])[:n_points]

    all_X = []
    for i in picks:
        curx, cury = xs[i], ys[i]
        min_all, max_all = 1e-10, 1e10
        ok = True
        for j in range(1, len(Ps)):
            dmin, dmax = depth_interval(curx, cury, Ps[j],
                                        mask_points_all[j], P0, Fs[j])
            if abs(dmin) < 1e-5:
                ok = False
                break
            min_all = max(min_all, dmin)
            max_all = min(max_all, dmax)
            if max_all < min_all + 1e-2:
                ok = False
                break
        if ok:
            direction = np.linalg.inv(P0[:3, :3]) @ np.array([curx, cury, 1.0])
            all_X.append(C0[:3] + direction * min_all)
            all_X.append(C0[:3] + direction * max_all)

    if not all_X:
        raise RuntimeError(
            "no mask point visible in all views; check masks/cameras")
    pts = np.asarray(all_X)
    print(f"Number of points: {len(pts) // 2}")
    centroid = pts.mean(axis=0)
    scale = pts.std()

    normalization = np.eye(4, dtype=np.float32)
    normalization[:3, 3] = centroid
    normalization[0, 0] = normalization[1, 1] = normalization[2, 2] = scale
    return normalization, pts


def refine_visual_hull(masks: np.ndarray, Ps: np.ndarray, scale: float,
                       center: np.ndarray, grid_size: int = 100,
                       min_views: int | None = None):
    """Visual-hull refinement of the normalization estimate
    (`/root/reference/preprocess/preprocess_cameras.py:125-155`; disabled by
    default there and here — opt in with --refine_visual_hull).

    Carve a grid_size³ lattice spanning [-scale, scale]³ around `center` by
    projecting every lattice point into every camera and counting silhouette
    hits; keep points inside >= min_views silhouettes, then recenter on the
    kept points and set the new scale to 3x their mean distance from the
    centroid.

    min_views defaults to ceil(0.9 * n_cam) (min 2) rather than the
    reference's hard-coded 20 'fitted for DTU': a point projecting OUTSIDE
    a view's image bounds counts as a miss for that view, so requiring ALL
    views would let a single tightly-cropped camera veto (and bias) the
    whole hull on real rigs.

    Returns (centroid [3], scale, kept_points [M,3]). Vectorized over the
    lattice; loops only over cameras."""
    n_cam, im_h, im_w = masks.shape[:3]
    if min_views is None:
        min_views = max(2, int(np.ceil(0.9 * n_cam)))
    lin = np.linspace(-scale, scale, grid_size)
    xx, yy, zz = np.meshgrid(lin, lin, lin)
    points = np.stack((xx.ravel(), yy.ravel(), zz.ravel()))  # [3, G]
    points = points + np.asarray(center, np.float64)[:, None]
    hom = np.concatenate([points, np.ones((1, points.shape[1]))], axis=0)

    appears = np.zeros(points.shape[1], np.int64)
    for i in range(n_cam):
        proj = Ps[i][:3] @ hom
        depths = proj[2]
        with np.errstate(divide="ignore", invalid="ignore"):
            px = np.round(proj[0] / depths).astype(np.int64)
            py = np.round(proj[1] / depths).astype(np.int64)
        ok = ((px >= 0) & (px < im_w) & (py >= 0) & (py < im_h)
              & (depths > 0))
        idx = np.nonzero(ok)[0]
        hit = masks[i][py[idx], px[idx]] > 0.5
        appears[idx[hit]] += 1

    kept = points[:, appears >= min_views]
    if kept.shape[1] == 0:
        raise RuntimeError(
            f"visual hull empty at min_views={min_views}; lower it or check "
            "masks/cameras")
    centroid = kept.mean(axis=1)
    rel = kept - centroid[:, None]
    new_scale = float(np.sqrt((rel ** 2).sum(axis=0)).mean() * 3.0)
    return centroid, new_scale, kept.T


def get_normalization(source_dir: str, use_linear_init: bool = False,
                      seed: int = 0, refine_hull: bool = False):
    print("Preprocessing", source_dir)
    n_points = 1000 if use_linear_init else 100
    cameras_filename = ("cameras_linear_init" if use_linear_init else "cameras")

    cameras = np.load(os.path.join(source_dir, cameras_filename + ".npz"))
    mask_points_all, masks_all = load_mask_points(
        os.path.join(source_dir, "mask"))
    n_cams = len(masks_all)
    Ps = np.array([cameras[f"world_mat_{i}"][:3, :].astype(np.float64)
                   for i in range(n_cams)])

    normalization, _ = estimate_normalization(Ps, mask_points_all, n_points,
                                              seed)
    if refine_hull:
        # carve over 3x the epipolar scale estimate: the reference spans
        # +/-scale around the (possibly biased) epipolar centroid
        # (`preprocess_cameras.py:131-135`), which can CLIP the hull when
        # the centroid sits off the true center — the clipped centroid then
        # inherits the bias. The wider lattice keeps grid_size, so its
        # cells are 3x coarser; the refined scale is re-derived from the
        # kept points, not from the input scale.
        centroid, scale, _ = refine_visual_hull(
            masks_all, Ps, 3.0 * float(normalization[0, 0]),
            normalization[:3, 3])
        normalization = np.eye(4, dtype=np.float32)
        normalization[:3, 3] = centroid
        normalization[0, 0] = normalization[1, 1] = normalization[2, 2] = scale

    cameras_new = {}
    for i in range(n_cams):
        cameras_new[f"scale_mat_{i}"] = normalization
        cameras_new[f"world_mat_{i}"] = np.concatenate(
            [Ps[i], np.array([[0, 0, 0, 1.0]])], axis=0).astype(np.float32)
    np.savez(os.path.join(source_dir, cameras_filename + ".npz"), **cameras_new)
    print(normalization)
    return normalization


if __name__ == "__main__":
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser = argparse.ArgumentParser()
    parser.add_argument("--source_dir", type=str, default="")
    parser.add_argument("--dtu", default=False, action="store_true",
                        help="apply to all ../data/DTU/scan* scenes")
    parser.add_argument("--use_linear_init", default=False, action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--refine_visual_hull", default=False,
                        action="store_true",
                        help="refine the estimate by silhouette carving "
                             "(disabled in the reference too)")
    opt = parser.parse_args()

    if opt.dtu:
        for scene_dir in sorted(glob(os.path.join("../data/DTU", "scan*"))):
            get_normalization(scene_dir, opt.use_linear_init, opt.seed,
                              opt.refine_visual_hull)
    else:
        get_normalization(opt.source_dir, opt.use_linear_init, opt.seed,
                          opt.refine_visual_hull)
    print("Done!")
