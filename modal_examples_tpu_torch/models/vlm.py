"""Vision-language model: a CLIP-style ViT tower and a projector in front of
the llama decoder (the LLaVA family).

Counterpart of ``modal_examples_tpu/models/vlm.py`` (``ViTConfig``,
``VLMConfig``, ``init_vision_params``, ``patchify``, ``encode_image``,
``preprocess_image``, ``load_hf_vision_weights``): a pre-LN ViT over
non-overlapping patches (the patch embedding one product of [B, n_patches,
p*p*3] against [p*p*3, D]), a class token that takes part in attention and is
dropped before the projector, quick-GELU MLPs, and a two-layer exact-GELU
projector into the language model's embedding space. The language model is
``models.llama``: the projected patch states enter ``llama.prefill`` (or
``forward``) as ``input_embeds`` for the first ``n_image_tokens`` positions,
and decode is unchanged (image tokens are ordinary cache entries).

The tower's attention is the reference's plain products (f32 scores and
softmax, probabilities rounded to the value dtype; the JAX module writes
them as einsums, not a Pallas kernel). Its layer norms run in the tower's
dtype, as the reference's do. On the card the f32 products must stay f32:
:func:`encode_image` refuses to run an f32 tower while PyTorch lets its
matmuls take TF32 (``layers.check_exact_f32_matmuls``).

Parameters keep the JAX tree (per-layer leaves stacked on axis 0, weights
[in, out]). :func:`preprocess_image` resizes through PIL, imported only when
an image is not already at ``image_size`` (a ``ValueError`` without it).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import reference
from ..utils.device import resolve_device
from ..utils.safetensors import SafeFile
from . import layers


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    mlp_dim: int = 4096
    norm_eps: float = 1e-5
    dtype: str = "float32"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def clip_vit_l_14() -> "ViTConfig":
        """openai/clip-vit-large-patch14: the LLaVA-1.5 vision tower."""
        return ViTConfig()

    @staticmethod
    def tiny(image_size: int = 16, patch_size: int = 8) -> "ViTConfig":
        return ViTConfig(image_size=image_size, patch_size=patch_size, dim=32, n_layers=2, n_heads=2, mlp_dim=64)


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Vision tower + projector + the llama language model it feeds."""

    vision: ViTConfig
    llm_dim: int  # == LlamaConfig.dim of the paired language model

    @property
    def n_image_tokens(self) -> int:
        return self.vision.n_patches


def init_vision_params(cfg: VLMConfig, *, seed: int = 0, device=None) -> dict:
    """Random tower and projector weights drawn on the device in the tower's
    dtype from ``seed``, at the JAX init's scales: linears fan_in**-0.5, the
    class and position embeddings 0.02; biases zero, norms one."""
    v = cfg.vision
    r = layers.SeededInit(seed, resolve_device(device), v.torch_dtype)
    D, L, M = v.dim, v.n_layers, v.mlp_dim
    return {
        "patch_proj": r.dense(v.patch_size * v.patch_size * 3, D),
        "class_emb": r.dense(D, scale=0.02),
        "pos_emb": r.dense(v.n_patches + 1, D, scale=0.02),
        "pre_ln_scale": r.full(1.0, D),
        "pre_ln_bias": r.full(0.0, D),
        "layers": {
            "ln1_scale": r.full(1.0, L, D), "ln1_bias": r.full(0.0, L, D),
            "wq": r.dense(L, D, D), "bq": r.full(0.0, L, D),
            "wk": r.dense(L, D, D), "bk": r.full(0.0, L, D),
            "wv": r.dense(L, D, D), "bv": r.full(0.0, L, D),
            "wo": r.dense(L, D, D), "bo": r.full(0.0, L, D),
            "ln2_scale": r.full(1.0, L, D), "ln2_bias": r.full(0.0, L, D),
            "fc1": r.dense(L, D, M), "fc1_b": r.full(0.0, L, M),
            "fc2": r.dense(L, M, D), "fc2_b": r.full(0.0, L, D),
        },
        "proj1": r.dense(D, cfg.llm_dim),
        "proj1_b": r.full(0.0, cfg.llm_dim),
        "proj2": r.dense(cfg.llm_dim, cfg.llm_dim),
        "proj2_b": r.full(0.0, cfg.llm_dim),
    }


def vision_params_from_jax(np_params: dict, cfg: VLMConfig, device=None) -> dict:
    """The JAX tree (numpy leaves) as this module's tree, layouts unchanged."""
    return layers.from_numpy_tree(np_params, cfg.vision.torch_dtype, resolve_device(device))


def _ln(x, scale, bias, eps):
    """Layer norm in the input's dtype (the reference's ViT norm)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def patchify(images, patch: int):
    """[B, S, S, 3] -> [B, n_patches, patch*patch*3] (row-major patches,
    pixels row-major within a patch, channels innermost)."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def encode_image(params: dict, images, cfg: VLMConfig):
    """images [B, S, S, 3] in [0, 1] -> LLM-space prefix embeddings
    [B, n_patches, llm_dim] in f32."""
    v = cfg.vision
    dt = v.torch_dtype
    if dt == torch.float32:
        layers.check_exact_f32_matmuls(images.device)
    B = images.shape[0]
    x = layers.mm(patchify(images.to(dt), v.patch_size), params["patch_proj"]).to(dt)
    cls = params["class_emb"][None, None].expand(B, 1, v.dim)
    x = torch.cat([cls, x], dim=1) + params["pos_emb"][None]  # [B, 1 + n_patches, D]
    x = _ln(x, params["pre_ln_scale"], params["pre_ln_bias"], v.norm_eps)
    S, H = v.n_patches + 1, v.n_heads
    hd = v.dim // H
    stacked = params["layers"]
    for i in range(v.n_layers):
        l = {k: t[i] for k, t in stacked.items()}
        h = _ln(x, l["ln1_scale"], l["ln1_bias"], v.norm_eps)
        q, k, val = ((h @ l[w] + l[b]).reshape(B, S, H, hd).transpose(1, 2)
                     for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        o = reference.attention(q, k, val, causal=False)  # bidirectional
        x = x + (o.transpose(1, 2).reshape(B, S, v.dim) @ l["wo"] + l["bo"])
        h = _ln(x, l["ln2_scale"], l["ln2_bias"], v.norm_eps)
        x = x + (layers.quick_gelu(h @ l["fc1"] + l["fc1_b"]) @ l["fc2"] + l["fc2_b"])
    x = x[:, 1:]  # the class token goes: the projector eats patch states
    h = F.gelu(x @ params["proj1"] + params["proj1_b"], approximate="none")  # LLaVA's exact GELU
    return (h @ params["proj2"] + params["proj2_b"]).float()


def preprocess_image(img, image_size: int) -> np.ndarray:
    """A PIL image or an array -> [S, S, 3] float32 in [0, 1] (on the host).
    Integer arrays are 0..255; float arrays are taken as already in [0, 1].
    An image not at ``image_size`` is resized through PIL, imported here: a
    ``ValueError`` where PIL is not installed."""
    if hasattr(img, "convert"):  # PIL
        img = img.convert("RGB").resize((image_size, image_size))
        arr = np.asarray(img, dtype=np.float32) / 255.0
    else:
        src = np.asarray(img)
        arr = src.astype(np.float32)
        if np.issubdtype(src.dtype, np.integer):
            arr = arr / 255.0
        if arr.shape[:2] != (image_size, image_size):
            try:
                from PIL import Image

                arr = np.asarray(
                    Image.fromarray((arr * 255).astype(np.uint8)).resize((image_size, image_size)),
                    dtype=np.float32,
                ) / 255.0
            except Exception as e:
                raise ValueError(
                    f"image shape {arr.shape} != {(image_size, image_size, 3)} and PIL resize unavailable"
                ) from e
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    return arr[:, :, :3]


def load_hf_vision_weights(model_dir: str | Path, cfg: VLMConfig, dtype=None, device=None) -> dict:
    """A transformers CLIPVisionModel safetensors checkpoint (``vision_model.*``
    names) and a LLaVA-style projector (``multi_modal_projector.linear_1``/
    ``linear_2``; every ``*.safetensors`` of ``model_dir``) as this module's
    tree, read through the port's safetensors reader: the conv patch
    embedding [D, 3, p, p] flattened to the [p*p*3, D] product in
    :func:`patchify`'s order, linears transposed to [in, out], layers
    stacked, every leaf in ``dtype`` (default the tower's) on ``device``."""
    v = cfg.vision
    device = resolve_device(device)
    dt = dtype or v.torch_dtype
    raw: dict[str, torch.Tensor] = {}
    for f in sorted(Path(model_dir).glob("*.safetensors")):
        with SafeFile(f) as sf:
            for name in sf.keys():
                raw[name] = sf.get_tensor(name)

    def put(t):
        return t.to(device=device, dtype=dt).contiguous()

    def stack(fmt, transpose=True):
        mats = [raw.pop(fmt.format(i)) for i in range(v.n_layers)]
        return put(torch.stack([m.T if transpose else m for m in mats]))

    P = "vision_model."
    E = P + "encoder.layers.{}."
    conv = raw.pop(P + "embeddings.patch_embedding.weight")  # [D, 3, p, p] -> [p, p, 3, D]
    return {
        "patch_proj": put(conv.permute(2, 3, 1, 0).reshape(-1, v.dim)),
        "class_emb": put(raw.pop(P + "embeddings.class_embedding")),
        "pos_emb": put(raw.pop(P + "embeddings.position_embedding.weight")),
        "pre_ln_scale": put(raw.pop(P + "pre_layrnorm.weight")),
        "pre_ln_bias": put(raw.pop(P + "pre_layrnorm.bias")),
        "layers": {
            "ln1_scale": stack(E + "layer_norm1.weight", False),
            "ln1_bias": stack(E + "layer_norm1.bias", False),
            "wq": stack(E + "self_attn.q_proj.weight"),
            "bq": stack(E + "self_attn.q_proj.bias", False),
            "wk": stack(E + "self_attn.k_proj.weight"),
            "bk": stack(E + "self_attn.k_proj.bias", False),
            "wv": stack(E + "self_attn.v_proj.weight"),
            "bv": stack(E + "self_attn.v_proj.bias", False),
            "wo": stack(E + "self_attn.out_proj.weight"),
            "bo": stack(E + "self_attn.out_proj.bias", False),
            "ln2_scale": stack(E + "layer_norm2.weight", False),
            "ln2_bias": stack(E + "layer_norm2.bias", False),
            "fc1": stack(E + "mlp.fc1.weight"),
            "fc1_b": stack(E + "mlp.fc1.bias", False),
            "fc2": stack(E + "mlp.fc2.weight"),
            "fc2_b": stack(E + "mlp.fc2.bias", False),
        },
        "proj1": put(raw.pop("multi_modal_projector.linear_1.weight").T),
        "proj1_b": put(raw.pop("multi_modal_projector.linear_1.bias")),
        "proj2": put(raw.pop("multi_modal_projector.linear_2.weight").T),
        "proj2_b": put(raw.pop("multi_modal_projector.linear_2.bias")),
    }
