"""A small PNG decoder in numpy and the standard library's zlib.

The host-side fallback of DepthImage when the native loader cannot be built
(deplex_tpu/native needs a C++ compiler and zlib's headers). It reads
non-interlaced PNGs of bit depth 8 or 16 in grayscale, grayscale+alpha, RGB
or RGBA, and returns the first channel as uint16 — depth maps are 16-bit
grayscale.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # colour type -> samples per pixel


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec §9); returns (height, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:                         # None
            cur = line.copy()
        elif ftype == 2:                       # Up
            cur = line + prev
        elif ftype == 1:                       # Sub: running sum per byte lane
            cur = np.empty(stride, np.uint8)
            for k in range(bpp):
                cur[k::bpp] = np.cumsum(line[k::bpp], dtype=np.uint8)
        elif ftype in (3, 4):                  # Average, Paeth: sequential
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise RuntimeError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint16, the first channel. Raises RuntimeError on
    content it cannot read."""
    if data[:8] != _SIGNATURE:
        raise RuntimeError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise RuntimeError("PNG without IHDR or IDAT")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16) or interlace:
        raise RuntimeError(f"unsupported PNG (colour type {colour}, bit depth "
                           f"{depth}, interlace {interlace})")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise RuntimeError(f"corrupt PNG data: {e}") from e
    if len(raw) != height * (width * bpp + 1):
        raise RuntimeError("PNG data size does not match its header")
    pix = _unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        samples = pix.reshape(height, width * channels, 2)
        values = samples[..., 0].astype(np.uint16) << 8 | samples[..., 1]
    else:
        values = pix.astype(np.uint16)
    return values.reshape(height, width, channels)[..., 0]
