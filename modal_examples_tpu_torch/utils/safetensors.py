"""Reader and writer of the safetensors format, for checkpoint loading.

The JAX package reads checkpoints with the ``safetensors`` package
(``safe_open``); the port keeps no dependency beyond torch and numpy, so it
carries the subset of the format that HF Llama checkpoints use:

- an 8-byte little-endian header length ``n``;
- ``n`` bytes of JSON: for each tensor ``{"dtype", "shape", "data_offsets"}``
  (offsets relative to the first byte after the header), and an optional
  ``"__metadata__"`` map of strings;
- the raw little-endian data of every tensor.

Dtypes: ``BF16``, ``F16``, ``F32``, ``I8``, ``I32`` and ``I64``; any other
dtype, a malformed header or offsets that do not match the shapes raise
``ValueError``. :class:`SafeFile` reads one tensor at a time by its offset
(bf16 through ``torch`` since numpy has none), so a loader that moves each
tensor on before it reads the next never holds a checkpoint twice in host
memory.
"""

from __future__ import annotations

import json
import math
import os
import struct
import sys
from pathlib import Path

import torch

DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "I8": torch.int8,
    "I32": torch.int32,
    "I64": torch.int64,
}
_NAMES = {v: k for k, v in DTYPES.items()}
#: a header larger than this is refused as malformed (the format's own limit)
MAX_HEADER = 100_000_000


def _parse_header(raw: bytes, data_len: int) -> tuple[dict, dict]:
    try:
        header = json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(f"safetensors header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise ValueError("safetensors header is not a JSON object")
    metadata = header.pop("__metadata__", None) or {}
    if not isinstance(metadata, dict) or not all(isinstance(v, str) for v in metadata.values()):
        raise ValueError("safetensors __metadata__ must map strings to strings")
    for name, info in header.items():
        try:
            dtype, shape, (begin, end) = info["dtype"], info["shape"], info["data_offsets"]
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"tensor {name!r}: header entry {info!r} lacks dtype/shape/data_offsets") from None
        if dtype not in DTYPES:
            raise ValueError(f"tensor {name!r}: dtype {dtype!r} is not one of {sorted(DTYPES)}")
        if not isinstance(shape, list) or not all(isinstance(d, int) and d >= 0 for d in shape):
            raise ValueError(f"tensor {name!r}: bad shape {shape!r}")
        nbytes = math.prod(shape) * DTYPES[dtype].itemsize
        if not (isinstance(begin, int) and isinstance(end, int) and 0 <= begin <= end <= data_len
                and end - begin == nbytes):
            raise ValueError(f"tensor {name!r}: data_offsets {[begin, end]} do not hold {nbytes} bytes "
                             f"of a {data_len}-byte data section")
    return header, metadata


class SafeFile:
    """One safetensors file, read tensor by tensor (use as a context
    manager): ``keys()``, ``metadata()``, ``get_tensor(name)`` (a CPU
    tensor of the stored dtype and shape)."""

    def __init__(self, path: str | os.PathLike):
        if sys.byteorder != "little":  # the data is little-endian and read as is
            raise RuntimeError("the safetensors reader needs a little-endian host")
        self.path = Path(path)
        self._f = open(self.path, "rb")
        try:
            size = os.fstat(self._f.fileno()).st_size
            head = self._f.read(8)
            if len(head) != 8:
                raise ValueError(f"{self.path}: shorter than the 8-byte header length")
            (n,) = struct.unpack("<Q", head)
            if n > min(MAX_HEADER, size - 8):
                raise ValueError(f"{self.path}: header length {n} exceeds the file ({size} bytes)")
            self._start = 8 + n
            self._tensors, self._metadata = _parse_header(self._f.read(n), size - self._start)
        except BaseException:
            self._f.close()
            raise

    def __enter__(self) -> "SafeFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._f.close()

    def keys(self) -> list[str]:
        return list(self._tensors)

    def metadata(self) -> dict:
        return dict(self._metadata)

    def get_tensor(self, name: str) -> torch.Tensor:
        info = self._tensors[name]
        begin, end = info["data_offsets"]
        buf = torch.empty(end - begin, dtype=torch.uint8)
        self._f.seek(self._start + begin)
        if self._f.readinto(buf.numpy()) != end - begin:
            raise ValueError(f"{self.path}: tensor {name!r} is truncated")
        return buf.view(DTYPES[info["dtype"]]).reshape(info["shape"])


def load_file(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Every tensor of one file."""
    with SafeFile(path) as f:
        return {name: f.get_tensor(name) for name in f.keys()}


def save_file(tensors: dict[str, torch.Tensor], path: str | os.PathLike, metadata: dict | None = None) -> None:
    """Write ``tensors`` (any device; stored little-endian, in name order)
    with an optional string ``metadata`` map. The header is padded with
    spaces to a multiple of 8 bytes, so every tensor's data stays aligned."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} is not one of {sorted(DTYPES)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            t = tensors[name].detach().contiguous().cpu()
            f.write(t.reshape(-1).view(torch.uint8).numpy().data)
