"""DepthImage tests (mirrors cpp/tests/test_depth_image.cpp)."""

import pathlib

import numpy as np
import pytest

from deplex_tpu.utils import DepthImage, read_intrinsics

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
TUM_PNG = str(DATA / "tum" / "1341848230.910894.png")


def test_dimensions():
    """test_depth_image.cpp:24-28."""
    img = DepthImage(TUM_PNG)
    assert img.width == 640
    assert img.height == 480


def test_invalid_path_raises():
    with pytest.raises(RuntimeError):
        DepthImage("/nonexistent/image.png")


def test_invalid_content_raises(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"this is not a png")
    with pytest.raises(RuntimeError):
        DepthImage(str(bad))


def test_golden_depth_range():
    """Raw sensor units, no TUM /5000 scaling (test_depth_image.cpp:45-51)."""
    img = DepthImage(TUM_PNG)
    K = read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K"))
    pcd = img.transform_to_pcd(K)
    assert pcd.shape == (640 * 480, 3)
    z = pcd[:, 2]
    assert int(z.max()) == 46655
    assert int(z.min()) == 0


def test_backprojection_pinhole():
    img = DepthImage(TUM_PNG)
    K = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]], np.float32)
    pcd = img.transform_to_pcd(K).reshape(480, 640, 3)
    v, u = 100, 200
    z = float(img.data[v, u])
    assert pcd[v, u, 2] == pytest.approx(z)
    assert pcd[v, u, 0] == pytest.approx((u - 319.5) * z / 525.0, rel=1e-5)
    assert pcd[v, u, 1] == pytest.approx((v - 239.5) * z / 525.0, rel=1e-5)


def test_reset():
    img = DepthImage(TUM_PNG)
    img.reset(str(DATA / "icl_nuim" / "0.png"))
    assert img.height == 480 and img.width == 640


def _png_bytes(rows: np.ndarray, colour: int, depth: int, filters) -> bytes:
    """A PNG written by hand: one filter type per row (PNG spec §9)."""
    import struct
    import zlib

    h = rows.shape[0]
    raw = rows.reshape(h, -1).astype(np.uint8)
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[colour] * depth // 8
    out, prev = [], np.zeros(raw.shape[1], np.int64)
    for y in range(h):
        cur = raw[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            enc = cur - pred
        out.append(bytes([f]) + bytes((enc % 256).astype(np.uint8)))
        prev = cur

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))

    width = raw.shape[1] // bpp
    ihdr = struct.pack(">IIBBBBB", width, h, depth, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("colour,depth", [(0, 16), (0, 8), (2, 8), (6, 16)])
def test_png_fallback_decoder_filters(colour, depth):
    """The numpy + zlib decoder reads every filter type, at both bit
    depths, and returns the first channel."""
    from deplex_tpu.utils.png import decode_png

    rng = np.random.default_rng(colour * 100 + depth)
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    hi = 65535 if depth == 16 else 255
    img = rng.integers(0, hi + 1, size=(10, 7, ch))
    if depth == 16:
        as_bytes = np.stack([img >> 8, img & 0xFF], -1).reshape(10, -1)
    else:
        as_bytes = img.reshape(10, -1)
    data = _png_bytes(as_bytes, colour, depth, filters=[0, 1, 2, 3, 4])
    got = decode_png(data)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, img[..., 0])


def test_png_fallback_matches_native_on_frames():
    """Without the native library DepthImage decodes the shipped frames
    to the same depths."""
    from deplex_tpu.utils.png import decode_png

    for png in (TUM_PNG, str(DATA / "icl_nuim" / "0.png")):
        got = decode_png(open(png, "rb").read())
        np.testing.assert_array_equal(got, DepthImage(png).data)


def test_png_fallback_rejects_garbage():
    from deplex_tpu.utils.png import decode_png

    with pytest.raises(RuntimeError):
        decode_png(b"\x89PNG\r\n\x1a\n" + b"\0" * 20)
