"""Tensor-aware state codec for memory snapshots; after
``modal_examples_tpu/snapshot/codec.py``.

Per-attribute serialization of a user object's ``__dict__``. The reference
walks each value as a jax pytree and stores ``jax.Array`` leaves as host
numpy. Here every ``torch.Tensor`` the pickler reaches, wherever it sits (a
dict, list, tuple, namedtuple, dataclass, any object pickled by its state,
an ``nn.Module``'s parameters and buffers), is written as its host bytes
with its dtype (bf16 included), shape, device, ``requires_grad`` and
whether it was an ``nn.Parameter``: a pickler's ``reducer_override`` takes
each tensor before torch's own reduction could, which would record the
storage's device and fail to load where that device is missing. On restore
each tensor is rebuilt from its bytes and put back on its device: a CUDA
tensor onto the container's card, never onto the CPU (no card with that
index raises :class:`CodecError`, and the restore falls back to a cold
boot). A view is stored as the contiguous tensor it shows.

Everything else round-trips through pickle, or cloudpickle for what plain
pickle cannot send. What crosses neither, and what must not cross (CUDA
streams, events and graphs; the ``ctypes`` handles of ``ops/_build.py``'s
kernel libraries; locks, sockets, threads, so a started ``LLMEngine``),
raises :class:`CodecError`; the capture layer records it as a
rebuild-on-restore marker instead of failing the snapshot.

This module imports torch only when a tensor is present, which implies
torch is already imported in this process.
"""

from __future__ import annotations

import ctypes
import io
import pickle
import sys


class CodecError(Exception):
    """Value cannot cross the snapshot boundary (record a rebuild marker)."""


#: classes whose instances are process-local handles: refused, never pickled
#: by their state (a CUDA stream's or a loaded library's address is
#: meaningless in another process)
_CUDA_HANDLES = ("Stream", "ExternalStream", "Event", "CUDAGraph")


def _refuse(obj) -> str | None:
    """Why ``obj`` must not cross the snapshot boundary, or None."""
    if isinstance(obj, (ctypes.CDLL, ctypes._CFuncPtr)):
        return f"a ctypes handle ({type(obj).__name__}) is only valid in the process that loaded it"
    cls = type(obj)
    if cls.__module__.startswith("torch.cuda") and any(
        k.__name__ in _CUDA_HANDLES for k in cls.__mro__
    ):
        return f"a CUDA {cls.__name__} belongs to the process that created it"
    return None


def _tensor_reduction(t):
    """``(rebuild, args)`` of a tensor as host bytes + dtype, shape, device."""
    import torch

    host = t.detach().to("cpu").contiguous()
    raw = host.reshape(-1).view(torch.uint8).numpy()
    device = str(t.device)
    is_param = isinstance(t, torch.nn.Parameter)
    return _rebuild_tensor, (
        pickle.PickleBuffer(raw), str(t.dtype).removeprefix("torch."), tuple(t.shape), device,
        bool(t.requires_grad), is_param,
    )


def _rebuild_tensor(buf, dtype: str, shape: tuple, device: str, requires_grad: bool, is_param: bool):
    """Inverse of :func:`_tensor_reduction`: the tensor on ``device``."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or (dev.index or 0) >= torch.cuda.device_count():
            raise CodecError(f"the snapshot holds a tensor on {device}, and this process has no such card")
    elif dev.type != "cpu":
        raise CodecError(f"the snapshot holds a tensor on {device}, which the codec does not restore")
    data = bytearray(buf) if not isinstance(buf, bytearray) else buf
    flat = torch.frombuffer(data, dtype=torch.uint8) if len(data) else torch.empty(0, dtype=torch.uint8)
    t = flat.view(getattr(torch, dtype)).reshape(shape).to(dev)
    if is_param:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _reduce(obj):
    if "torch" in sys.modules and isinstance(obj, sys.modules["torch"].Tensor):
        return _tensor_reduction(obj)
    why = _refuse(obj)
    if why is not None:
        raise CodecError(why)
    return NotImplemented


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        return _reduce(obj)


def _cloud_pickler():
    """A cloudpickle pickler with the same tensor and handle rules, or None
    when cloudpickle is not installed."""
    try:
        import cloudpickle
    except ImportError:
        return None

    class _CloudPickler(cloudpickle.Pickler):
        def reducer_override(self, obj):
            out = _reduce(obj)
            return super().reducer_override(obj) if out is NotImplemented else out

    return _CloudPickler


def encode_attr(value) -> bytes:
    buf = io.BytesIO()
    try:
        _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(value)
        return buf.getvalue()
    except CodecError:
        raise
    except Exception as first:
        cloud = _cloud_pickler()
        if cloud is None:
            raise CodecError(f"{type(value).__name__} is not snapshot-serializable: {first}") from first
        buf = io.BytesIO()
        try:
            cloud(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(value)
        except CodecError:
            raise
        except Exception as e:
            raise CodecError(f"{type(value).__name__} is not snapshot-serializable: {e}") from e
        return buf.getvalue()


def decode_attr(data: bytes):
    return pickle.loads(data)


def encode_state(state: dict) -> tuple[bytes, list[str]]:
    """Encode an object's ``__dict__``. Returns (payload, rebuild_attrs):
    attrs that cannot be serialized (kernel-library handles, CUDA streams,
    locks, threads, clients) are left out of the payload and listed for the
    restore path to rebuild."""
    blobs: dict[str, bytes] = {}
    rebuild: list[str] = []
    for name, value in state.items():
        try:
            blobs[name] = encode_attr(value)
        except CodecError:
            rebuild.append(name)
    return pickle.dumps(blobs, protocol=pickle.HIGHEST_PROTOCOL), rebuild


def decode_state(payload: bytes) -> dict:
    blobs = pickle.loads(payload)
    return {name: decode_attr(data) for name, data in blobs.items()}
