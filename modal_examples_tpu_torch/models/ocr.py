"""Optical character recognition: a conv stem, a transformer encoder and CTC.

Counterpart of ``modal_examples_tpu/models/ocr.py`` (``CHARSET``,
``encode_text``, ``decode_labels``, ``OCRConfig``, ``init_params``,
``forward``, ``ctc_loss``, ``greedy_decode``, ``render_line``,
``synthetic_batch``): a strided conv stem collapses the line image's height
into a width-wise sequence of features, a bidirectional pre-LN transformer
contextualizes it, and CTC aligns the unsegmented characters (index 0 the
blank). Layouts are the reference's (NHWC images, HWIO kernels, XLA "SAME"
padding through ``layers.conv_same_nhwc``; convolutions with TF32 off). The
attention is the reference's plain products (f32 scores and softmax), its
layer norms run in the model dtype.

``ctc_loss`` is ``torch.nn.functional.ctc_loss`` (per-sequence negative log
likelihood, every frame valid, labels 0-padded), averaged over the batch as
the reference averages ``optax.ctc_loss``: the reference's CTC is a library
call, not a Pallas kernel. ``render_line`` and so ``synthetic_batch``
rasterize text through PIL, imported when called; ``forward`` and the loss
take any [B, H, W, 1] array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import reference
from ..utils.device import resolve_device
from . import layers

#: the recognized alphabet; label 0 is the CTC blank
CHARSET = " ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.$:-/#"


@dataclasses.dataclass(frozen=True)
class OCRConfig:
    height: int = 32
    width: int = 256
    channels: int = 1
    dim: int = 128  # encoder width
    n_layers: int = 2
    n_heads: int = 4
    n_classes: int = len(CHARSET) + 1  # + the blank at index 0
    norm_eps: float = 1e-6
    dtype: str = "float32"

    @property
    def seq_len(self) -> int:  # width positions after the conv stem
        return self.width // 4

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def encode_text(s: str) -> list[int]:
    """chars -> label ids (1-based; 0 is the CTC blank)."""
    return [CHARSET.index(c) + 1 for c in s.upper() if c in CHARSET]


def decode_labels(ids) -> str:
    return "".join(CHARSET[i - 1] for i in ids if 1 <= i <= len(CHARSET))


def init_params(cfg: OCRConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights drawn on the device in the model dtype from ``seed``,
    at the JAX init's scales (kernels (k*k*cin)**-0.5, linears
    fan_in**-0.5, the position embedding 0.02; biases zero, norms one)."""
    r = layers.SeededInit(seed, resolve_device(device), cfg.torch_dtype)
    D, L = cfg.dim, cfg.n_layers

    def conv(k, cin, cout):
        return r.dense(k, k, cin, cout, scale=(k * k * cin) ** -0.5)

    c1, c2, c3 = 32, 64, D
    return {
        "conv1": conv(3, cfg.channels, c1),  # stride (2, 2)
        "conv2": conv(3, c1, c2),  # stride (2, 2)
        "conv3": conv(3, c2, c3),  # stride (2, 1)
        "col_proj": r.dense((cfg.height // 8) * c3, D),
        "pos_emb": r.dense(cfg.seq_len, D, scale=0.02),
        "layers": {
            "ln1_s": r.full(1.0, L, D), "ln1_b": r.full(0.0, L, D),
            "wq": r.dense(L, D, D), "wk": r.dense(L, D, D), "wv": r.dense(L, D, D), "wo": r.dense(L, D, D),
            "ln2_s": r.full(1.0, L, D), "ln2_b": r.full(0.0, L, D),
            "fc": r.dense(L, D, 4 * D), "fc_b": r.full(0.0, L, 4 * D),
            "proj": r.dense(L, 4 * D, D), "proj_b": r.full(0.0, L, D),
        },
        "head": r.dense(D, cfg.n_classes),
        "head_b": r.full(0.0, cfg.n_classes),
    }


def params_from_jax(np_params: dict, cfg: OCRConfig, device=None) -> dict:
    """The JAX tree (numpy leaves) as this module's tree, layouts unchanged."""
    return layers.from_numpy_tree(np_params, cfg.torch_dtype, resolve_device(device))


def _norm(v, s, b, eps: float):
    mu = v.mean(dim=-1, keepdim=True)
    var = (v - mu).square().mean(dim=-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + eps) * s + b


def forward(params: dict, images, cfg: OCRConfig):
    """images [B, H, W, 1] in [0, 1] -> CTC logits [B, seq_len, n_classes]."""
    B, T, H = images.shape[0], cfg.seq_len, cfg.n_heads
    if cfg.torch_dtype == torch.float32:
        layers.check_exact_f32_matmuls(images.device)
    with layers.exact_f32_convs():
        x = F.relu(layers.conv_same_nhwc(images.to(cfg.torch_dtype), params["conv1"], (2, 2)))
        x = F.relu(layers.conv_same_nhwc(x, params["conv2"], (2, 2)))
        x = F.relu(layers.conv_same_nhwc(x, params["conv3"], (2, 1)))  # [B, H/8, W/4, D]
    # the width becomes the sequence; each glyph column flattens into features
    x = x.transpose(1, 2).reshape(B, T, -1)
    h = x @ params["col_proj"] + params["pos_emb"][None]
    hd = cfg.dim // H
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        l = {k: t[i] for k, t in stacked.items()}
        a = _norm(h, l["ln1_s"], l["ln1_b"], cfg.norm_eps)
        q, k, v = ((a @ l[w]).reshape(B, T, H, hd).transpose(1, 2) for w in ("wq", "wk", "wv"))
        o = reference.attention(q, k, v, causal=False)  # CTC wants context from both sides
        h = h + o.transpose(1, 2).reshape(B, T, cfg.dim) @ l["wo"]
        a = _norm(h, l["ln2_s"], l["ln2_b"], cfg.norm_eps)
        h = h + (F.relu(a @ l["fc"] + l["fc_b"]) @ l["proj"] + l["proj_b"])
    return h @ params["head"] + params["head_b"]


def ctc_loss(params: dict, images, labels, cfg: OCRConfig):
    """Mean over the batch of each line's CTC negative log likelihood;
    ``labels`` [B, N] integer, 0-padded (0 is also the blank), every logit
    frame valid."""
    logits = forward(params, images, cfg)
    B, T, _ = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # [T, B, C]
    labels = labels.to(device=logits.device, dtype=torch.int64)
    per_seq = F.ctc_loss(
        logp, labels, torch.full((B,), T, dtype=torch.int64, device=logits.device), (labels != 0).sum(dim=1),
        blank=0, reduction="none",
    )
    return per_seq.mean()


def greedy_decode(params: dict, images, cfg: OCRConfig) -> list[str]:
    """Argmax CTC decode: collapse repeats, drop blanks (on the host)."""
    best = torch.argmax(forward(params, images, cfg), dim=-1).cpu().tolist()
    out = []
    for row in best:
        chars, prev = [], -1
        for t in row:
            if t != prev and t != 0:
                chars.append(t)
            prev = t
        out.append(decode_labels(chars))
    return out


# -- synthetic rendered text ---------------------------------------------------


def render_line(text: str, cfg: OCRConfig, *, jitter_rng=None) -> np.ndarray:
    """Rasterize one text line through PIL -> [H, W, 1] float32 in [0, 1]
    (ink 1). ``jitter_rng`` (a numpy Generator) shifts it and adds noise."""
    from PIL import Image, ImageDraw, ImageFont

    img = Image.new("L", (cfg.width, cfg.height), 0)
    draw = ImageDraw.Draw(img)
    x, y = 4, cfg.height // 2 - 6
    if jitter_rng is not None:
        x += int(jitter_rng.integers(0, 8))
        y += int(jitter_rng.integers(-3, 4))
    draw.text((x, y), text.upper(), font=ImageFont.load_default(), fill=255)
    arr = np.asarray(img, np.float32) / 255.0
    if jitter_rng is not None:
        arr = np.clip(arr + jitter_rng.normal(0, 0.05, arr.shape).astype(np.float32), 0.0, 1.0)
    return arr[:, :, None]


def synthetic_batch(np_rng, batch: int, cfg: OCRConfig, *, max_len: int = 12):
    """Random rendered lines over the whole charset and their 0-padded
    labels: (images [B, H, W, 1], labels [B, max_len + 2] int32, texts)."""
    texts = []
    for _ in range(batch):
        n = int(np_rng.integers(3, max_len))
        # edge spaces render as nothing and are stripped; an all-space line becomes "A"
        texts.append("".join(CHARSET[int(np_rng.integers(0, len(CHARSET)))] for _ in range(n)).strip() or "A")
    images = np.stack([render_line(t, cfg, jitter_rng=np_rng) for t in texts])
    labels = np.zeros((batch, max_len + 2), np.int32)
    for i, t in enumerate(texts):
        ids = encode_text(t)
        labels[i, : len(ids)] = ids
    return images, labels, texts
