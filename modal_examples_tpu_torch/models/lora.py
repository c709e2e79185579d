"""LoRA: low-rank adapters as a pytree of their own beside the frozen base.

Counterpart of ``modal_examples_tpu/models/lora.py`` (``LoRAConfig``,
``DEFAULT_TARGETS``, ``init_lora``, ``delta``, ``merge``, ``param_count``,
and the generic tree LoRA of the diffusion models: ``DIT_TARGETS``,
``init_lora_tree``, ``merge_tree``).
Adapters keep the JAX layout: ``{"layers": {"<target>_a": [L, din, r],
"<target>_b": [L, r, dout]}}``, stacked over layers, in the base weight's
dtype (f32 over an int8 or int4 base: QLoRA). The forward applies them on the fly (``llama.forward(lora=...)``:
``x @ W + (x @ a) @ b * scale``, never materialising ``W + a b``); the
optimizer state covers only the adapters. :func:`lora_from_jax` and
:func:`lora_tree_from_jax` carry the JAX adapters across for the tests.

The tree LoRA puts an ``{"a": [..., din, r], "b": [..., r, dout]}`` pair in
place of every targeted leaf of any nested parameter dict (leading stack
dims kept, the base's dtype); training merges it into the weights inside the
loss (:func:`merge_tree`), so gradients reach only the adapters and the
model's forward is unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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
    int8 or int4 :class:`~.quantize.QuantizedWeight` base the adapters take
    the scale's dtype (f32) and the base's logical shape, as the reference's
    do: integer adapters would round ``a`` to zeros."""
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


# -- the generic tree LoRA (diffusion, any model) ------------------------------

#: the MMDiT's attention and MLP projections, the DreamBooth target set
#: (their names in ``diffusion.mmdit_init``)
DIT_TARGETS = (
    "img_wq", "img_wk", "img_wv", "img_wo",
    "ctx_wq", "ctx_wk", "ctx_wv", "ctx_wo",
    "img_fc1", "img_fc2", "ctx_fc1", "ctx_fc2",
)


def init_lora_tree(generator: torch.Generator, params: dict, lcfg: LoRAConfig) -> dict:
    """Adapters for any nested parameter dict: every tensor leaf whose key is
    in ``lcfg.targets`` and has at least 2 dims gets ``{"a", "b"}``, with
    ``[..., din, dout]`` giving ``a [..., din, r] ~ N(0, 1) / r`` (drawn in
    f32 on ``generator``'s device, in walk order) and ``b = 0``, both in the
    leaf's dtype and on its device. The tree mirrors the nesting; a
    ``ValueError`` names the targets when nothing matches."""
    found = []

    def walk(node: dict, out: dict) -> dict:
        for name, v in node.items():
            if isinstance(v, dict):
                sub = walk(v, {})
                if sub:
                    out[name] = sub
            elif name in lcfg.targets and isinstance(v, torch.Tensor) and v.dim() >= 2:
                found.append((out, name, v))
                out[name] = None  # filled below, in walk order
        return out

    tree = walk(params, {})
    if not found:
        raise ValueError(f"no leaves matched targets {lcfg.targets!r}; check the names against the model's tree")
    for parent, name, w in found:
        *stack, din, dout = w.shape
        a = torch.randn((*stack, din, lcfg.rank), generator=generator, device=generator.device) / lcfg.rank
        parent[name] = {
            "a": a.to(device=w.device, dtype=w.dtype),
            "b": torch.zeros((*stack, lcfg.rank, dout), dtype=w.dtype, device=w.device),
        }
    return tree


def merge_tree(params: dict, lora_tree: dict, lcfg: LoRAConfig) -> dict:
    """The base tree plus each adapter's ``(a @ b) * scale``, summed in f32
    and rounded to the base leaf's dtype, the structure kept (untargeted
    leaves are the base's own tensors). Differentiable in the adapters: the
    diffusion LoRA trains through it."""

    def walk(p_node: dict, l_node) -> dict:
        out = {}
        for name, v in p_node.items():
            l_v = l_node.get(name) if isinstance(l_node, dict) else None
            if isinstance(v, dict):
                out[name] = walk(v, l_v or {})
            elif isinstance(l_v, dict) and "a" in l_v:
                ab = torch.matmul(l_v["a"].float(), l_v["b"].float())
                out[name] = (v.float() + ab * lcfg.scale).to(v.dtype)
            else:
                out[name] = v
        return out

    return walk(params, lora_tree)


def lora_tree_from_jax(np_tree: dict, *, dtype=None, device=None) -> dict:
    """A JAX tree-LoRA (numpy leaves) as this module's: the nesting kept,
    each leaf in ``dtype`` (default: its own, bf16 leaves as bf16)."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        want = dtype or (torch.bfloat16 if str(node.dtype) == "bfloat16" else torch.float32)
        return torch.tensor(np.asarray(node, np.float32)).to(device=device, dtype=want)

    return conv(np_tree)
