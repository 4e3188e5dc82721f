"""Marching-cubes wrapper: C++ native module with a vectorized numpy
marching-tetrahedra fallback.

Replaces the reference's PyMCubes call (`/root/reference/models/renderer.py:31`)
and the vertex-rescale convention (`renderer.py:35`): the native kernel emits
vertices in grid-index space; `extract_geometry` rescales into the bbox.

The C++ module is not shipped as a binary: it is built from
``native/marching_cubes.cpp`` with ``native/Makefile`` at first use, on the
machine that runs it (the library is git-ignored), and loaded via ctypes. If
it cannot be built, the numpy fallback keeps every feature working (slower,
denser triangulation) and a warning names the reason; `native_available`
tells callers which one runs.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmarching_cubes.so")
_lock = threading.Lock()
_lib = None
_native_failed = False


def _build_native() -> None:
    """make the library unless it is newer than its source. A file lock
    serializes concurrent first uses (test workers, several processes of one
    job), so no process loads a half-written library."""
    src = os.path.join(_NATIVE_DIR, "marching_cubes.cpp")
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src)):
            subprocess.run(["make", "-C", _NATIVE_DIR],
                           check=True, capture_output=True, text=True)


def _load_native():
    global _lib, _native_failed
    with _lock:
        if _lib is not None or _native_failed:
            return _lib
        try:
            _build_native()
            lib = ctypes.CDLL(_LIB_PATH)
            lib.mc_run.restype = ctypes.c_void_p
            lib.mc_run.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float]
            lib.mc_num_verts.restype = ctypes.c_long
            lib.mc_num_verts.argtypes = [ctypes.c_void_p]
            lib.mc_num_tris.restype = ctypes.c_long
            lib.mc_num_tris.argtypes = [ctypes.c_void_p]
            lib.mc_get.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.POINTER(ctypes.c_int32)]
            lib.mc_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception as e:
            detail = getattr(e, "stderr", "") or ""
            logger.warning("native marching cubes unavailable (%s%s); using "
                           "the numpy marching-tetrahedra fallback", e,
                           f": {detail.strip()}" if detail else "")
            _native_failed = True
            _lib = None
        return _lib


def native_available() -> bool:
    return _load_native() is not None


def marching_cubes(grid: np.ndarray, isolevel: float = 0.0):
    """grid [X,Y,Z] float32 -> (vertices [N,3] in index space, faces [M,3]).

    Surface where grid crosses `isolevel`; triangles wind so normals point
    toward increasing field values (grid = -sdf => outward)."""
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    lib = _load_native()
    if lib is not None:
        h = lib.mc_run(grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       grid.shape[0], grid.shape[1], grid.shape[2],
                       ctypes.c_float(isolevel))
        try:
            nv, nt = lib.mc_num_verts(h), lib.mc_num_tris(h)
            verts = np.empty((nv, 3), np.float32)
            tris = np.empty((nt, 3), np.int32)
            if nv:
                lib.mc_get(h,
                           verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        finally:
            lib.mc_free(h)
        return verts, tris
    return _marching_tetrahedra(grid, isolevel)


def extract_geometry(grid: np.ndarray, bound_min, bound_max,
                     threshold: float = 0.0):
    """Full reference-equivalent pipeline piece (`renderer.py:28-36`): polygonize
    then rescale vertices from index space into [bound_min, bound_max]."""
    resolution = grid.shape[0]
    vertices, triangles = marching_cubes(grid, threshold)
    b_min = np.asarray(bound_min, np.float32)
    b_max = np.asarray(bound_max, np.float32)
    if len(vertices):
        vertices = vertices / (resolution - 1.0) * (b_max - b_min)[None] + b_min[None]
    return vertices, triangles


# ---------------------------------------------------------------------------
# numpy fallback: vectorized marching tetrahedra
# ---------------------------------------------------------------------------

# each cube splits into 6 tetrahedra around the main diagonal (corners use the
# same layout as the C++ module)
_TETS = np.array([
    [0, 5, 1, 6],
    [0, 1, 2, 6],
    [0, 2, 3, 6],
    [0, 3, 7, 6],
    [0, 7, 4, 6],
    [0, 4, 5, 6],
], np.int32)

_CORNER_OFFSETS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32)

# triangulation per tetra sign case (4 bits; bit i = value[i] < iso).
# entries are pairs of tetra-vertex indices (edges) forming 0, 1, or 2 tris.
_TET_TRIS = {
    0x1: [(0, 1), (0, 2), (0, 3)],
    0xE: [(0, 1), (0, 3), (0, 2)],
    0x2: [(1, 0), (1, 3), (1, 2)],
    0xD: [(1, 0), (1, 2), (1, 3)],
    0x4: [(2, 0), (2, 1), (2, 3)],
    0xB: [(2, 0), (2, 3), (2, 1)],
    0x8: [(3, 0), (3, 2), (3, 1)],
    0x7: [(3, 0), (3, 1), (3, 2)],
    0x3: [(0, 2), (1, 3), (0, 3), (0, 2), (1, 2), (1, 3)],
    0xC: [(0, 2), (0, 3), (1, 3), (0, 2), (1, 3), (1, 2)],
    0x5: [(0, 1), (2, 3), (1, 2), (0, 1), (0, 3), (2, 3)],
    0xA: [(0, 1), (1, 2), (2, 3), (0, 1), (2, 3), (0, 3)],
    0x6: [(0, 1), (1, 3), (2, 3), (0, 1), (2, 3), (0, 2)],
    0x9: [(0, 1), (2, 3), (1, 3), (0, 1), (0, 2), (2, 3)],
}


def _marching_tetrahedra(grid: np.ndarray, isolevel: float):
    nx, ny, nz = grid.shape
    # cube base coordinates
    bx, by, bz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    base = np.stack([bx, by, bz], axis=-1).reshape(-1, 3)  # [C,3]

    corner_vals = np.stack(
        [grid[base[:, 0] + o[0], base[:, 1] + o[1], base[:, 2] + o[2]]
         for o in _CORNER_OFFSETS], axis=-1)  # [C,8]

    verts_out = []
    tris_out = []
    vert_count = 0
    edge_cache: dict = {}

    corner_pos = base[:, None, :] + _CORNER_OFFSETS[None, :, :]  # [C,8,3]

    for tet in _TETS:
        tvals = corner_vals[:, tet]                       # [C,4]
        tpos = corner_pos[:, tet]                         # [C,4,3]
        case = ((tvals < isolevel) * np.array([1, 2, 4, 8])).sum(-1)  # [C]
        for code, edges in _TET_TRIS.items():
            sel = np.nonzero(case == code)[0]
            if not len(sel):
                continue
            n_tri = len(edges) // 3
            for t in range(n_tri):
                tri_vids = []
                for e in range(3):
                    a, b = edges[t * 3 + e]
                    pa, pb = tpos[sel, a], tpos[sel, b]       # [S,3]
                    va, vb = tvals[sel, a], tvals[sel, b]
                    denom = vb - va
                    tt = np.where(np.abs(denom) > 1e-12,
                                  (isolevel - va) / np.where(denom == 0, 1, denom),
                                  0.5)
                    tt = np.clip(tt, 0.0, 1.0)
                    pts = pa + tt[:, None] * (pb - pa)
                    tri_vids.append(np.arange(vert_count, vert_count + len(sel)))
                    verts_out.append(pts.astype(np.float32))
                    vert_count += len(sel)
                tris_out.append(np.stack(tri_vids, axis=-1))

    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    verts = np.concatenate(verts_out, axis=0)
    tris = np.concatenate(tris_out, axis=0).astype(np.int32)

    # deduplicate vertices (quantize to 1e-5 grid units)
    keys = np.round(verts * 1e5).astype(np.int64)
    _, unique_idx, inverse = np.unique(keys, axis=0, return_index=True,
                                       return_inverse=True)
    verts_u = verts[unique_idx]
    tris_u = inverse[tris]
    # drop degenerates
    ok = ((tris_u[:, 0] != tris_u[:, 1]) & (tris_u[:, 1] != tris_u[:, 2])
          & (tris_u[:, 0] != tris_u[:, 2]))
    return verts_u, tris_u[ok].astype(np.int32)
