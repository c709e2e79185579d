"""Minimal image IO: PNG encode/decode via stdlib zlib (no PIL dependency).

A copy of ``modal_examples_tpu/utils/images.py``: enough for a text-to-image
endpoint to return real image bytes."""

from __future__ import annotations

import struct
import zlib

import numpy as np


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


def from_png(data: bytes) -> np.ndarray:
    """PNG bytes (as produced by to_png: 8-bit RGB, no filters) -> uint8
    [H, W, 3]. Minimal decoder for round-trip tests."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    W = H = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            W, H = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = W * 3 + 1
    rows = []
    for r in range(H):
        row = raw[r * stride : (r + 1) * stride]
        assert row[0] == 0, "only filter 0 supported"
        rows.append(np.frombuffer(row[1:], np.uint8).reshape(W, 3))
    return np.stack(rows)
