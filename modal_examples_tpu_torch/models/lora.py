"""LoRA: low-rank adapters as a pytree of their own beside the frozen base.

Counterpart of ``modal_examples_tpu/models/lora.py`` (``LoRAConfig``,
``DEFAULT_TARGETS``, ``init_lora``, ``delta``, ``merge``, ``param_count``).
Adapters keep the JAX layout: ``{"layers": {"<target>_a": [L, din, r],
"<target>_b": [L, r, dout]}}``, stacked over layers, in the base weight's
dtype (f32 over an int8 base). The forward applies them on the fly (``llama.forward(lora=...)``:
``x @ W + (x @ a) @ b * scale``, never materialising ``W + a b``); the
optimizer state covers only the adapters. :func:`lora_from_jax` carries the
JAX adapters across for the tests.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.device import resolve_device
from . import layers
from .quantize import QuantizedWeight

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: tuple[str, ...] = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def init_lora(generator: torch.Generator, params: dict, lcfg: LoRAConfig) -> dict:
    """Adapters for the base's layer weights: ``a ~ N(0, 1) / rank`` drawn in
    f32 on ``generator``'s device, ``b = 0`` (so the model starts exactly at
    the base), both in each base weight's dtype and on its device. Over an
    int8 :class:`~.quantize.QuantizedWeight` base the adapters take the
    scale's dtype (f32), as the reference's do: int8 adapters would round
    ``a`` to zeros."""
    out = {}
    n_layers = len(params["layers"])
    for name in lcfg.targets:
        w = params["layers"][0][name]
        if isinstance(w, QuantizedWeight):
            w = w.scale  # real-valued adapters, on the base's device
            din, dout = params["layers"][0][name].shape
        else:
            din, dout = w.shape
        a = torch.randn((n_layers, din, lcfg.rank), generator=generator, device=generator.device) / lcfg.rank
        out[f"{name}_a"] = a.to(device=w.device, dtype=w.dtype)
        out[f"{name}_b"] = torch.zeros((n_layers, lcfg.rank, dout), dtype=w.dtype, device=w.device)
    return {"layers": out}


def delta(x, a, b, scale: float):
    """(x @ a) @ b * scale in f32, ``x @ a`` rounded to x's dtype first."""
    xa = layers.mm(x, a).to(x.dtype)
    return layers.mm(xa, b) * scale


def merge(params: dict, lora_params: dict, lcfg: LoRAConfig) -> dict:
    """Fold adapters into a copy of the base weights (for serving)."""
    ad = lora_params["layers"]
    merged = []
    for li, layer in enumerate(params["layers"]):
        layer = dict(layer)
        for name in lcfg.targets:
            w = layer[name]
            ab = ad[f"{name}_a"][li].float() @ ad[f"{name}_b"][li].float()
            layer[name] = (w.float() + ab * lcfg.scale).to(w.dtype)
        merged.append(layer)
    return {**params, "layers": merged}


def param_count(lora_params: dict) -> int:
    return sum(t.numel() for t in lora_params["layers"].values())


def lora_from_jax(np_lora: dict, *, dtype=torch.float32, device=None) -> dict:
    """The JAX adapter tree (numpy leaves) as this module's adapters."""
    device = resolve_device(device)
    return {
        "layers": {
            k: torch.tensor(v, dtype=torch.float32).to(device=device, dtype=dtype)
            for k, v in np_lora["layers"].items()
        }
    }
