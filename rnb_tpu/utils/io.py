"""Image / normal-map / mesh I/O.

Mirrors the reference's bit-depth-aware loaders and sign conventions
(`/root/reference/models/dataset.py:48-96`):

  * images: uint8/uint16 PNG -> float [0,1] RGB
  * normal maps: image*2-1 with y and z components negated (camera space,
    z pointing *into* the scene for valid pixels)
  * savers are exact inverses

PNG is read and written here with numpy and zlib alone (8/16-bit gray, gray
+alpha, RGB, RGBA; non-interlaced; all five row filters on read), so the data
path needs no image library. Plus a bilinear resize and a dependency-free
binary-PLY writer (the reference uses trimesh for export only,
`exp_runner.py:576-578`).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# PNG codec
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> channels (0 gray, 2 RGB, 4 gray+alpha, 6 RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters -> [h, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:                                   # None
            cur = line.copy()
        elif ftype == 1:                                 # Sub: running sum
            cur = np.zeros(stride + bpp, np.int64)       # per channel lane
            cur[bpp:] = line
            cur = np.cumsum(cur.reshape(-1, bpp), axis=0).reshape(-1)[bpp:]
            cur = (cur & 0xFF).astype(np.uint8)
        elif ftype == 2:                                 # Up
            cur = line + prev
        elif ftype in (3, 4):                            # Average / Paeth
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """PNG -> uint8/uint16 array in the file's channel order: [H,W] gray,
    [H,W,2] gray+alpha, [H,W,3] RGB, [H,W,4] RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, color "
                         f"type {ctype}, interlace {interlace})")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """uint8/uint16 [H,W] or [H,W,C] (C = 1..4, file channel order) -> PNG,
    unfiltered rows, zlib at `level`."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = img.dtype.itemsize * 8
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rows.view(np.uint8)],
                          axis=1)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_SIG
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                  ctype, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _png_chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# images, normal maps, masks
# ---------------------------------------------------------------------------

def load_image(path: str) -> np.ndarray:
    """-> float32 [H,W,3] RGB in [0,1] (`dataset.py:48-57`)."""
    image = read_png(path)
    denom = np.float32(np.iinfo(image.dtype).max)
    if image.ndim == 3 and image.shape[2] == 2:   # gray + alpha
        image = image[..., 0]
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    return np.ascontiguousarray(image[..., :3], dtype=np.float32) / denom


def load_normal(path: str) -> np.ndarray:
    """-> float32 [H,W,3] camera-space normal in [-1,1] with y,z sign flips
    (`dataset.py:59-68`)."""
    normal = load_image(path) * 2.0 - 1.0
    normal[..., 1] = -normal[..., 1]
    normal[..., 2] = -normal[..., 2]
    return normal


def load_mask(path: str) -> np.ndarray:
    """-> float32 [H,W] binarized at 0.5 (`dataset.py:132-136`)."""
    img = read_png(path)
    if img.ndim == 3:
        img = img[..., 0]
    img = img.astype(np.float64) / 255.0
    return np.where(img > 0.5, 1.0, 0.0).astype(np.float32)


def save_image(path: str, image: np.ndarray, bit_depth: int = 8) -> None:
    """[H,W,3] RGB float [0,1] -> PNG (`dataset.py:70-85`)."""
    arr = np.clip(np.asarray(image, np.float64) * (2 ** bit_depth - 1),
                  0, 2 ** bit_depth - 1)
    write_png(path, arr.astype(np.uint8 if bit_depth == 8 else np.uint16))


def save_normal(path: str, normal: np.ndarray, bit_depth: int = 8) -> None:
    """Inverse of load_normal (`dataset.py:87-96`)."""
    n = np.array(normal, copy=True)
    n[..., 1] = -n[..., 1]
    n[..., 2] = -n[..., 2]
    save_image(path, (n + 1.0) / 2.0, bit_depth=bit_depth)


def _linear_taps(n_in: int, n_out: int):
    """Source indices and weights of a half-pixel-centered linear resize
    along one axis (OpenCV's INTER_LINEAR convention, edges clamped)."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(x)
    t = (x - x0).astype(np.float32)
    i0 = np.clip(x0, 0, n_in - 1).astype(np.int64)
    i1 = np.clip(x0 + 1, 0, n_in - 1).astype(np.int64)
    return i0, i1, t


def resize_image(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bilinear resize of a float [H,W(,C)] image to [h,w(,C)]."""
    img = np.asarray(img, np.float32)
    r0, r1, ty = _linear_taps(img.shape[0], h)
    c0, c1, tx = _linear_taps(img.shape[1], w)
    ty = ty.reshape((-1, 1) + (1,) * (img.ndim - 2))
    tx = tx.reshape((1, -1) + (1,) * (img.ndim - 2))
    rows = img[r0] * (1 - ty) + img[r1] * ty
    return rows[:, c0] * (1 - tx) + rows[:, c1] * tx


# ---------------------------------------------------------------------------
# PLY export (binary little-endian, optional per-vertex color)
# ---------------------------------------------------------------------------

def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              vertex_colors: np.ndarray | None = None) -> None:
    """Minimal binary PLY writer (replaces trimesh export,
    `exp_runner.py:576-578,620-622`). vertex_colors float [0,1] or uint8."""
    vertices = np.asarray(vertices, dtype="<f4")
    faces = np.asarray(faces, dtype="<i4")
    n_v, n_f = len(vertices), len(faces)

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n_v}",
              "property float x", "property float y", "property float z"]
    if vertex_colors is not None:
        vc = np.asarray(vertex_colors)
        if vc.dtype != np.uint8:
            vc = np.clip(vc * 255.0, 0, 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {n_f}", "property list uchar int vertex_indices",
               "end_header"]

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if vertex_colors is not None:
            vert_dt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec = np.empty(n_v, dtype=vert_dt)
            rec["xyz"] = vertices
            rec["rgb"] = vc
            rec.tofile(f)
        else:
            vertices.tofile(f)
        face_dt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        rec = np.empty(n_f, dtype=face_dt)
        rec["n"] = 3
        rec["idx"] = faces
        rec.tofile(f)


def read_ply(path: str):
    """Minimal reader for the files write_ply produces (tests/tools)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply"
        n_v = n_f = 0
        has_color = False
        while True:
            line = f.readline().strip().decode()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line.startswith("property uchar red"):
                has_color = True
            elif line == "end_header":
                break
        if has_color:
            vert_dt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec = np.fromfile(f, dtype=vert_dt, count=n_v)
            verts, colors = rec["xyz"].copy(), rec["rgb"].copy()
        else:
            verts = np.fromfile(f, dtype="<f4", count=n_v * 3).reshape(n_v, 3)
            colors = None
        face_dt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        faces = np.fromfile(f, dtype=face_dt, count=n_f)["idx"].copy()
    return verts, faces, colors
