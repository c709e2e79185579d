"""Promptable segmentation (the SAM family's architecture at demo scale).

Counterpart of ``modal_examples_tpu/models/segmentation.py`` (``SAMConfig``,
``init_params``, ``encode_image``, ``decode_mask``, ``segmentation_loss``,
``synthetic_scene``, ``synthetic_batch``): an image encoder computes a
feature map once (three stride-2 convolutions and a position embedding);
each click prompt is embedded by sinusoid features; a light mask decoder
runs self-attention between a mask token and the prompt token, then
cross-attention from both to the image features, and predicts mask logits
(the features dotted with the mask token, refined to pixels by a
depth-to-space head) and the mask's IoU. One image embedding serves many
prompts, SAM's interactive contract.

Layouts are the reference's (NHWC images, HWIO kernels, XLA "SAME" padding
through ``layers.conv_same_nhwc``; convolutions with TF32 off). The
attentions are the reference's plain products (f32 scores and softmax),
its layer norms run in the model dtype. ``synthetic_scene`` and
``synthetic_batch`` draw from a ``torch.Generator`` where the reference
splits a JAX key: the same kind of scene, not the same numbers.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..ops import reference
from ..utils.device import resolve_device
from . import layers


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    image_size: int = 64
    stride: int = 8  # fixed by the encoder: three stride-2 convs
    dim: int = 128
    n_heads: int = 4
    n_decoder_layers: int = 2
    norm_eps: float = 1e-6
    dtype: str = "float32"

    def __post_init__(self):
        if self.stride != 8:
            raise ValueError("stride is fixed at 8 (the encoder is three stride-2 convs); change image_size to "
                             "change the grid")
        if self.image_size % 8:
            raise ValueError("image_size must be a multiple of 8")

    @property
    def grid(self) -> int:
        return self.image_size // self.stride

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_params(cfg: SAMConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights drawn on the device in the model dtype from ``seed``,
    at the JAX init's scales; biases zero, norms one."""
    r = layers.SeededInit(seed, resolve_device(device), cfg.torch_dtype)
    D, L = cfg.dim, cfg.n_decoder_layers

    def conv(k, cin, cout):
        return r.dense(k, k, cin, cout, scale=(k * k * cin) ** -0.5)

    return {
        "enc1": conv(3, 3, D // 4),
        "enc2": conv(3, D // 4, D // 2),
        "enc3": conv(3, D // 2, D),
        "enc_pos": r.dense(cfg.grid * cfg.grid, D, scale=0.02),
        "prompt_proj": r.dense(4 * 16, D),
        "mask_token": r.dense(D, scale=0.02),
        "dec": {
            "ln0_s": r.full(1.0, L, D), "ln0_b": r.full(0.0, L, D),
            "swq": r.dense(L, D, D), "swk": r.dense(L, D, D), "swv": r.dense(L, D, D), "swo": r.dense(L, D, D),
            "ln1_s": r.full(1.0, L, D), "ln1_b": r.full(0.0, L, D),
            "wq": r.dense(L, D, D), "wk": r.dense(L, D, D), "wv": r.dense(L, D, D), "wo": r.dense(L, D, D),
            "ln2_s": r.full(1.0, L, D), "ln2_b": r.full(0.0, L, D),
            "fc": r.dense(L, D, 2 * D), "fc_b": r.full(0.0, L, 2 * D),
            "proj": r.dense(L, 2 * D, D), "proj_b": r.full(0.0, L, D),
        },
        "mask_up": r.dense(D, cfg.stride * cfg.stride),
        "iou_head": r.dense(D, 1),
    }


def params_from_jax(np_params: dict, cfg: SAMConfig, device=None) -> dict:
    """The JAX tree (numpy leaves) as this module's tree, layouts unchanged."""
    return layers.from_numpy_tree(np_params, cfg.torch_dtype, resolve_device(device))


def _point_features(points):
    """[B, 2] click coordinates in [0, 1] -> [B, 64] sinusoid features."""
    freqs = 2.0 ** torch.arange(16, device=points.device, dtype=torch.float32)
    args = points[:, :, None].float() * freqs[None, None] * math.pi  # [B, 2, 16]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1).reshape(points.shape[0], -1)


def _norm(v, s, b, eps: float):
    mu = v.mean(dim=-1, keepdim=True)
    var = (v - mu).square().mean(dim=-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + eps) * s + b


def encode_image(params: dict, images, cfg: SAMConfig):
    """[B, S, S, 3] -> the feature map [B, grid*grid, D], computed once an
    image and reused by every prompt."""
    if cfg.torch_dtype == torch.float32:
        layers.check_exact_f32_matmuls(images.device)
    with layers.exact_f32_convs():
        x = F.relu(layers.conv_same_nhwc(images.to(cfg.torch_dtype), params["enc1"], 2))
        x = F.relu(layers.conv_same_nhwc(x, params["enc2"], 2))
        x = F.relu(layers.conv_same_nhwc(x, params["enc3"], 2))  # [B, grid, grid, D]
    return x.reshape(x.shape[0], cfg.grid * cfg.grid, cfg.dim) + params["enc_pos"][None]


def _heads(x, n_heads: int):
    B, S, D = x.shape
    return x.reshape(B, S, n_heads, D // n_heads).transpose(1, 2)


def _attend(q, k, v, n_heads: int):
    B, S, D = q.shape
    o = reference.attention(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads), causal=False)
    return o.transpose(1, 2).reshape(B, S, D)


def decode_mask(params: dict, image_features, points, cfg: SAMConfig):
    """One prompt a row: image_features [B, grid*grid, D] from
    :func:`encode_image`, points [B, 2] clicks (x, y) in [0, 1] -> (mask
    logits [B, S, S], the predicted IoU [B])."""
    B, D, H = image_features.shape[0], cfg.dim, cfg.n_heads
    prompt = _point_features(points).to(image_features.dtype) @ params["prompt_proj"]  # [B, D]
    tok = torch.stack([params["mask_token"][None].expand(B, D), prompt], dim=1)  # [B, 2, D]
    stacked = params["dec"]
    for i in range(cfg.n_decoder_layers):
        l = {k: t[i] for k, t in stacked.items()}
        # self-attention between the tokens: how the click conditions the mask
        a = _norm(tok, l["ln0_s"], l["ln0_b"], cfg.norm_eps)
        tok = tok + _attend(a @ l["swq"], a @ l["swk"], a @ l["swv"], H) @ l["swo"]
        # cross-attention: the tokens query the image features
        a = _norm(tok, l["ln1_s"], l["ln1_b"], cfg.norm_eps)
        tok = tok + _attend(a @ l["wq"], image_features @ l["wk"], image_features @ l["wv"], H) @ l["wo"]
        a = _norm(tok, l["ln2_s"], l["ln2_b"], cfg.norm_eps)
        tok = tok + (F.relu(a @ l["fc"] + l["fc_b"]) @ l["proj"] + l["proj_b"])
    mask_tok = tok[:, 0]
    iou = torch.sigmoid(tok[:, 1] @ params["iou_head"])[:, 0]
    # per-cell logits (feature . mask token) refined per pixel by a
    # depth-to-space head (each cell predicts its stride x stride block)
    cell = torch.einsum("bnd,bd->bn", image_features, mask_tok)
    logits = cell[:, :, None] + image_features @ params["mask_up"]
    G, st = cfg.grid, cfg.stride
    logits = logits.reshape(B, G, G, st, st).permute(0, 1, 3, 2, 4).reshape(B, cfg.image_size, cfg.image_size)
    return logits, iou


def segmentation_loss(params: dict, images, points, masks, cfg: SAMConfig):
    """Pixel BCE + 0.1 x the squared error of the IoU prediction against the
    IoU of the thresholded mask. masks [B, S, S] in {0, 1}."""
    logits, iou_pred = decode_mask(params, encode_image(params, images, cfg), points, cfg)
    masks = masks.to(logits.dtype)
    bce = (logits.clamp(min=0) - logits * masks + torch.log1p(torch.exp(-logits.abs()))).mean()
    pred_mask = (logits > 0).to(logits.dtype)
    inter = (pred_mask * masks).sum(dim=(1, 2))
    union = torch.maximum(pred_mask, masks).sum(dim=(1, 2))
    true_iou = inter / union.clamp(min=1.0)
    return bce + 0.1 * ((iou_pred - true_iou) ** 2).mean()


# -- synthetic promptable scenes ------------------------------------------------


def synthetic_scene(generator: torch.Generator, cfg: SAMConfig):
    """A scene of two shapes in disjoint horizontal bands (a red-ish disc, a
    blue-ish square) on noise; returns (image [S, S, 3], the click [2] on one
    shape, that shape's mask [S, S]). The same image with the other click
    must give the other mask."""
    S, dev = cfg.image_size, generator.device
    yy, xx = torch.meshgrid(torch.arange(S, device=dev), torch.arange(S, device=dev), indexing="ij")

    def randint(lo, hi):
        return int(torch.randint(lo, hi, (), generator=generator, device=dev))

    def shape_mask(kind, x_lo, x_hi):
        cx, cy, r = randint(x_lo, x_hi), randint(S // 5, 4 * S // 5), randint(S // 12, S // 10)
        if kind == 0:  # disc
            m = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
        else:  # square
            m = ((xx - cx).abs() <= r) & ((yy - cy).abs() <= r)
        return m.float(), torch.tensor([cx / S, cy / S], device=dev, dtype=torch.float32)

    m0, c0 = shape_mask(0, S // 6, 2 * S // 5)
    m1, c1 = shape_mask(1, 3 * S // 5, 5 * S // 6)
    img = 0.1 * torch.rand((S, S, 3), generator=generator, device=dev)
    col0 = torch.tensor([0.9, 0.2, 0.1], device=dev)
    col1 = torch.tensor([0.1, 0.3, 0.9], device=dev)
    img = img * (1 - m0[:, :, None]) + m0[:, :, None] * col0
    img = img * (1 - m1[:, :, None]) + m1[:, :, None] * col1
    pick = bool(torch.rand((), generator=generator, device=dev) < 0.5)
    return img, (c1 if pick else c0), (m1 if pick else m0)


def synthetic_batch(generator: torch.Generator, batch: int, cfg: SAMConfig):
    """(images [B, S, S, 3], points [B, 2], masks [B, S, S])."""
    scenes = [synthetic_scene(generator, cfg) for _ in range(batch)]
    return tuple(torch.stack([s[i] for s in scenes]) for i in range(3))
