"""PNG decoding with the standard library's zlib (no OpenCV, no PIL).

The counterpart of ``cv2.imread(path, cv2.IMREAD_COLOR)`` for PNG files,
which the JAX package's ``LoadImage`` calls: 8-bit gray, gray + alpha, RGB,
RGBA and palette images, not interlaced, become an (H, W, 3) uint8 array in
BGR order. As in OpenCV's decoder, gray is copied into the three channels,
alpha (and a palette's ``tRNS``) is dropped and no gamma is applied. Any
other bit depth, interlaced files and corrupt chunks raise ``ValueError``.

Rows filtered with None, Sub or Up (OpenCV writes Sub) are undone with
whole-row NumPy operations; Average and Paeth rows, whose bytes depend on
the byte before them in the same row, are undone one byte at a time in
Python, which is far slower.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> bytes a pixel at bit depth 8
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes):
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} is truncated or fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG stream ends before its IEND chunk")


def _unfilter_slow(kind: int, row: bytearray, prior: bytes, bpp: int) -> None:
    """Average (3) or Paeth (4), in place: each byte needs the one ``bpp``
    before it, already reconstructed."""
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, {height * (stride + 1)} expected")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        kind, filt = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            out[r] = filt
        elif kind == 1:  # Sub: a running sum, modulo 256, over each byte of a pixel
            out[r] = np.cumsum(filt.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[r] = filt + prior
        elif kind in (3, 4):
            row = bytearray(filt.tobytes())
            _unfilter_slow(kind, row, prior.tobytes(), bpp)
            out[r] = np.frombuffer(row, np.uint8)
        else:
            raise ValueError(f"PNG row {r} has filter type {kind}")
        prior = out[r]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 BGR, as ``cv2.imdecode(..., IMREAD_COLOR)``."""
    if not is_png(data):
        raise ValueError("not a PNG stream")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG stream has no IHDR chunk")
    width, height, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(f"PNG bit depth {depth}, color type {color}: the port reads 8-bit gray, gray + alpha, "
                         "RGB, RGBA and palette images")
    if interlace or compression or filtering:
        raise ValueError("interlaced PNG (or an unknown compression or filter method) is not read by the port")
    bpp = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp).reshape(height, width, bpp)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        if int(pixels.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index beyond its PLTE chunk")
        rgb = palette[pixels[..., 0]]
    elif color in (0, 4):
        rgb = np.repeat(pixels[..., :1], 3, axis=2)
    else:
        rgb = pixels[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])
