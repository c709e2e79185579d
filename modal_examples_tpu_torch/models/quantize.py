"""Weight-only int8 quantization for serving.

Counterpart of ``modal_examples_tpu/models/quantize.py`` (int8 part):
``QuantizedWeight``, ``SUPPORTED``, ``_qmax``, ``quantize_weight``,
``dequantize_weight``, ``LLAMA_TARGETS``, ``bits_of``, ``quantize_llama``,
``init_quantized_llama`` and ``param_bytes``. Weights are int8 ``[din, dout]``
with per-output-channel f32 scales ``[1, dout]`` (symmetric), and
``layers.mm`` multiplies them through the int8 matmul kernel
(``ops/quantized_matmul.py``), which reads the int8 bytes and never a bf16
copy.

int4 (``bits=4``, ``"int4"``) raises ``NotImplementedError``: the kernel is
int8 only and the port has no packed int4 type yet (ROADMAP A2).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import tree


@dataclasses.dataclass
class QuantizedWeight:
    q: torch.Tensor  # int8 [din, dout]
    scale: torch.Tensor  # f32 [1, dout]

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype


#: quantization modes the engine accepts; "int4" is refused until packed
#: int4 is ported (ROADMAP A2)
SUPPORTED = (None, "int8", "int4")

_INT4 = "int4 weights are not ported yet (ROADMAP A2: packed int4 and its matmul kernel)"


def _qmax(bits: int) -> float:
    if bits == 8:
        return 127.0
    if bits == 4:
        raise NotImplementedError(_INT4)
    raise ValueError(f"unsupported quantization bits {bits!r} (4 or 8)")


def quantize_weight(w, bits: int = 8) -> QuantizedWeight:
    """Symmetric per-output-channel int8 over the contraction dim (-2):
    ``scale = amax/127`` (1 for an all-zero column), ``q = round(w / scale)``
    half to even, clipped. The divisors are tensors so that both divisions
    are IEEE quotients on the card too (see ``kv_quant.quantize_kv``)."""
    qmax = _qmax(bits)
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, qmax), torch.ones_like(amax))
    q = torch.round(wf / scale).clamp_(-qmax, qmax)
    return QuantizedWeight(q=q.to(torch.int8), scale=scale)


def dequantize_weight(qw: QuantizedWeight, dtype=torch.bfloat16):
    return (qw.q.float() * qw.scale).to(dtype)


#: the matmul weights a llama tree quantizes (the MoE names are kept for the
#: day MoE is ported); norms and embeddings stay in the model dtype
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
    is never resident: the peak is the int8 tree plus one layer."""
    from . import llama

    _qmax(bits)
    params = llama.init_params(
        cfg, seed=seed, device=device, map_layer=lambda layer: _quantize_layer(layer, LLAMA_TARGETS, bits)
    )
    if "lm_head" in params:
        params["lm_head"] = quantize_weight(params["lm_head"], bits)
    return params


def param_bytes(params) -> int:
    """Device bytes of a parameter tree (int8 payloads plus f32 scales)."""
    return sum(t.numel() * t.element_size() for t in tree.leaves(params) if isinstance(t, torch.Tensor))
