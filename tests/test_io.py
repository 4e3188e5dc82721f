"""The numpy + zlib PNG codec and the bilinear resize of rnb_tpu.utils.io
(the data path reads and writes images with no image library)."""

import struct
import zlib

import numpy as np
import pytest

from rnb_tpu.utils import io


def _smooth(shape, dtype, seed=0):
    """A smooth image (cumulative noise), so encoders pick varied filters."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max + 1
    a = rng.integers(0, 8, shape).cumsum(axis=0).cumsum(axis=1)
    return (a % top).astype(dtype)


@pytest.mark.parametrize("shape,dtype", [
    ((17, 23, 3), np.uint8), ((17, 23, 3), np.uint16), ((9, 31), np.uint8),
    ((9, 31, 2), np.uint16), ((12, 5, 4), np.uint8)])
def test_png_round_trip(tmp_path, shape, dtype):
    """8- and 16-bit gray, gray+alpha, RGB and RGBA survive write -> read."""
    img = _smooth(shape, dtype)
    path = str(tmp_path / "x.png")
    io.write_png(path, img)
    back = io.read_png(path)
    assert back.dtype == dtype and back.shape == img.shape
    np.testing.assert_array_equal(back, img)


def _encode_with_filter(img: np.ndarray, ftype: int) -> bytes:
    """Reference PNG encoder applying one filter type to every row (8-bit
    RGB), written from the specification."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for y in range(h):
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out += bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_png_reads_every_filter_type(tmp_path, ftype):
    img = _smooth((11, 13, 3), np.uint8, seed=ftype)
    path = tmp_path / "f.png"
    path.write_bytes(_encode_with_filter(img, ftype))
    np.testing.assert_array_equal(io.read_png(str(path)), img)


@pytest.mark.parametrize("shape,dtype", [
    ((40, 52, 3), np.uint8), ((40, 52, 3), np.uint16), ((40, 52), np.uint8),
    ((40, 52, 4), np.uint16)])
def test_png_read_equals_cv2(tmp_path, shape, dtype):
    """Files OpenCV writes (adaptive filters, several compression levels)
    decode to OpenCV's own pixels, byte for byte."""
    cv2 = pytest.importorskip("cv2")
    img = _smooth(shape, dtype, seed=5)
    bgr = img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]
    for level in (0, 3, 9):
        path = str(tmp_path / f"c{level}.png")
        cv2.imwrite(path, bgr, [cv2.IMWRITE_PNG_COMPRESSION, level])
        ours = io.read_png(path)
        theirs = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if ours.ndim == 3:
            ours = ours[..., [2, 1, 0, 3][:ours.shape[2]]]
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def test_gray_mask_and_bit_depth_scaling(tmp_path):
    """A gray mask loads binarized; 8- and 16-bit images load to [0, 1] RGB
    (save_image truncates to the grid, as the reference's saver does, so
    the round trip is within one step of it)."""
    mask = np.zeros((8, 10), np.uint8)
    mask[2:6, 3:7] = 255
    io.write_png(str(tmp_path / "m.png"), mask)
    m = io.load_mask(str(tmp_path / "m.png"))
    assert m.dtype == np.float32 and m.shape == (8, 10)
    np.testing.assert_array_equal(m, mask / 255.0)

    rgb = np.random.default_rng(1).random((8, 10, 3)).astype(np.float32)
    for depth in (8, 16):
        p = str(tmp_path / f"i{depth}.png")
        io.save_image(p, rgb, bit_depth=depth)
        back = io.load_image(p)
        assert back.shape == rgb.shape
        np.testing.assert_allclose(back, rgb, atol=1.0 / (2 ** depth - 1))


def test_resize_matches_opencv_bilinear():
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(2).random((64, 48, 3)).astype(np.float32)
    for w, h in ((12, 16), (48, 64), (100, 37)):
        np.testing.assert_allclose(io.resize_image(img, w, h),
                                   cv2.resize(img, (w, h)), atol=1e-6)
