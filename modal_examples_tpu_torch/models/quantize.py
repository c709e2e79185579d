"""Weight-only int8 and int4 quantization for serving.

Counterpart of ``modal_examples_tpu/models/quantize.py``:
``QuantizedWeight``, ``SUPPORTED``, ``_qmax``, ``quantize_weight``,
``dequantize_weight``, ``LLAMA_TARGETS``, ``bits_of``, ``quantize_llama``,
``init_quantized_llama``, ``quantize_weight_host`` and ``param_bytes``.
Weights are symmetric per output channel with f32 scales ``[1, dout]`` (a
stack of experts ``[E, din, dout]`` has scales ``[E, 1, dout]``). int8 keeps
``q`` as int8 ``[din, dout]``; int4 packs two contraction rows a byte
(``ops.quantized_matmul.pack_int4``: uint8 ``[ceil(din/2), dout]``, the even
row in the low nibble), where the JAX package keeps ``jnp.int4``.
``layers.mm`` multiplies them through the int8 matmul kernel (K7) or the
int4 one (K7-int4), which read the packed bytes and never a bf16 copy (an
expert's ``q[e]`` and ``scale[e]`` are contiguous views, one launch each).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.quantized_matmul import pack_int4, unpack_int4
from ..utils import tree
from ..utils.device import resolve_device


@dataclasses.dataclass
class QuantizedWeight:
    q: torch.Tensor  # int8 [..., din, dout]; int4: uint8 [..., ceil(din/2), dout], two rows a byte
    scale: torch.Tensor  # f32 [..., 1, dout]
    #: 8 or 4; with ``rows`` (int4's ``din``) carried beside the tensors, never a leaf
    bits: int = dataclasses.field(default=8, metadata={"static": True})
    rows: int | None = dataclasses.field(default=None, metadata={"static": True})

    @property
    def din(self) -> int:
        if self.rows is not None:
            return self.rows
        return self.q.shape[-2] * (2 if self.bits == 4 else 1)

    @property
    def shape(self):
        """The logical ``[..., din, dout]`` (int4's packed rows unfolded)."""
        return torch.Size((*self.q.shape[:-2], self.din, self.q.shape[-1]))

    @property
    def dtype(self):
        return self.q.dtype

    def values(self):
        """The integer values as int8 ``[..., din, dout]``."""
        return unpack_int4(self.q, self.din) if self.bits == 4 else self.q


#: quantization modes every entry point accepts (engine, loaders)
SUPPORTED = (None, "int8", "int4")


def _qmax(bits: int) -> float:
    if bits == 8:
        return 127.0
    if bits == 4:
        return 7.0
    raise ValueError(f"unsupported quantization bits {bits!r} (4 or 8)")


def quantize_weight(w, bits: int = 8) -> QuantizedWeight:
    """Symmetric per-output-channel int8/int4 over the contraction dim (-2):
    ``scale = amax/qmax`` (1 for an all-zero column), ``q = round(w /
    scale)`` half to even, clipped to ``±qmax``. The divisors are tensors so
    that both divisions are IEEE quotients on the card too (see
    ``kv_quant.quantize_kv``). int4 values are packed (:func:`pack_int4`)."""
    qmax = _qmax(bits)
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, qmax), torch.ones_like(amax))
    q = torch.round(wf / scale).clamp_(-qmax, qmax).to(torch.int8)
    if bits == 4:
        return QuantizedWeight(q=pack_int4(q), scale=scale, bits=4, rows=w.shape[-2])
    return QuantizedWeight(q=q, scale=scale)


def dequantize_weight(qw: QuantizedWeight, dtype=torch.bfloat16):
    return (qw.values().float() * qw.scale).to(dtype)


#: the matmul weights a llama tree quantizes, dense and expert; norms,
#: embeddings and the MoE router stay in the model dtype
LLAMA_TARGETS = (
    "wq", "wk", "wv", "wo", "gate", "up", "down",
    "moe_gate", "moe_up", "moe_down",
)


def bits_of(quantization: str) -> int:
    if quantization not in ("int8", "int4"):
        raise ValueError(f"unknown quantization {quantization!r}")
    return 8 if quantization == "int8" else 4


def _quantize_layer(layer: dict, targets, bits: int) -> dict:
    return {name: quantize_weight(w, bits) if name in targets else w for name, w in layer.items()}


def quantize_llama(params: dict, targets=LLAMA_TARGETS, *, bits: int = 8) -> dict:
    """Quantize the layer matmuls and ``lm_head`` of a llama parameter dict
    (a new dict; ``params`` is not changed). Peak memory holds both trees:
    callers that own the weights outright use :func:`init_quantized_llama`."""
    _qmax(bits)
    out = dict(params)
    out["layers"] = [_quantize_layer(layer, targets, bits) for layer in params["layers"]]
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"], bits)
    return out


def init_quantized_llama(cfg, *, seed: int = 0, bits: int = 8, device=None) -> dict:
    """``quantize_llama(llama.init_params(cfg, seed=seed))`` quantized one
    layer at a time as it is drawn, so the model-dtype copy of the whole tree
    is never resident: the peak is the quantized tree plus one layer."""
    from . import llama

    _qmax(bits)
    params = llama.init_params(
        cfg, seed=seed, device=device, map_layer=lambda layer: _quantize_layer(layer, LLAMA_TARGETS, bits)
    )
    if "lm_head" in params:
        params["lm_head"] = quantize_weight(params["lm_head"], bits)
    return params


def quantize_weight_host(w, bits: int = 8, device=None) -> QuantizedWeight:
    """:func:`quantize_weight` on the host (a CPU tensor or numpy array),
    then only ``q`` and ``scale`` go to ``device``: the checkpoint-load path,
    where the model-dtype weight never reaches the card."""
    device = resolve_device(device)
    qw = quantize_weight(torch.as_tensor(w).cpu(), bits)
    return dataclasses.replace(qw, q=qw.q.to(device), scale=qw.scale.to(device))


def _weights(node):
    if isinstance(node, QuantizedWeight):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _weights(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _weights(v)


def param_bytes(params) -> int:
    """Device bytes of a parameter tree (int8 payloads plus f32 scales),
    with int4 counted at 4 bits an element as the JAX function counts it
    (``(size + 1) // 2`` of a leaf)."""
    total = sum(t.numel() * t.element_size() for t in tree.leaves(params) if isinstance(t, torch.Tensor))
    for w in _weights(params):
        if w.bits == 4:
            total += (w.shape.numel() + 1) // 2 - w.q.numel()
    return total
