"""Minimal image IO: PNG encode/decode via stdlib zlib (no PIL dependency).

After ``modal_examples_tpu/utils/images.py``: enough for a text-to-image
endpoint to return real image bytes, and for the OpenAI server to read the
PNG images a chat request sends (8-bit RGB, no interlace, any of the five
row filters); :func:`from_png` raises ``ValueError`` for anything else."""

from __future__ import annotations

import struct
import zlib

import numpy as np


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def to_png(img: np.ndarray) -> bytes:
    """[H, W, 3] uint8 (or float in [-1,1] / [0,1]) -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        arr = img.astype(np.float32)
        if arr.min() < 0:  # [-1, 1] convention
            arr = (arr + 1.0) / 2.0
        img = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    H, W, C = img.shape
    assert C == 3, f"expected RGB, got {C} channels"
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(H))
    return b"".join(
        [
            b"\x89PNG\r\n\x1a\n",
            _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)),
            _chunk(b"IDAT", zlib.compress(raw, 6)),
            _chunk(b"IEND", b""),
        ]
    )


def _unfilter(raw: bytes, H: int, W: int) -> np.ndarray:
    """Undo PNG's per-row filters (None, Sub, Up, Average, Paeth) of 8-bit
    RGB scanlines -> uint8 [H, W, 3]."""
    stride, bpp = W * 3, 3
    if len(raw) != H * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes; an {W}x{H} RGB image needs {H * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(H, stride + 1)
    out = np.zeros((H, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for r in range(H):
        f, line = rows[r, 0], rows[r, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 0xFF
        elif f in (1, 3, 4):  # these depend on the bytes to their left: one pixel at a time
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {r} has an unknown filter type {f}")
        out[r] = cur
        prev = cur
    return out.astype(np.uint8).reshape(H, W, 3)


def from_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB, not interlaced) -> uint8 [H, W, 3]. Raises
    ``ValueError`` for another kind of PNG or a damaged one."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG (bad signature)")
    pos = 8
    W = H = None
    idat = b""
    try:
        while pos < len(data):
            (length,) = struct.unpack(">I", data[pos : pos + 4])
            tag = data[pos + 4 : pos + 8]
            body = data[pos + 8 : pos + 8 + length]
            if tag == b"IHDR":
                W, H, depth, color, _comp, _filt, interlace = struct.unpack(">IIBBBBB", body[:13])
                if (depth, color, interlace) != (8, 2, 0):
                    raise ValueError(f"PNG of bit depth {depth}, color type {color}, interlace {interlace}: only "
                                     "8-bit RGB without interlace is read here")
            elif tag == b"IDAT":
                idat += body
            elif tag == b"IEND":
                break
            pos += 12 + length
        if W is None:
            raise ValueError("PNG has no IHDR chunk")
        raw = zlib.decompress(idat)
    except (struct.error, zlib.error) as e:
        raise ValueError(f"damaged PNG: {e}") from None
    return _unfilter(raw, H, W)
