"""VAE: the latent-space autoencoder of the SD family (AutoencoderKL).

Counterpart of ``modal_examples_tpu/models/vae.py`` (``VAEConfig``,
``init_params``, ``encode``, ``decode``, ``load_hf_weights``), the
diffusers AutoencoderKL shape:
- encoder: conv_in -> down levels (2 resnets each, a stride-2 conv between
  levels) -> mid (resnet, single-head attention, resnet) -> group norm ->
  conv_out producing 2 x latent channels (mean, logvar);
- decoder: conv_in -> mid -> up levels (3 resnets each, nearest x2
  upsampling and a conv between levels) -> conv_out, clipped to [-1, 1];
- latents are ``(mean - shift_factor) * scaling_factor``.

``encode`` and ``decode`` keep the reference's NHWC images and latents at
their boundary; inside, the port runs NCHW (cuDNN's layout) with
convolution weights in PyTorch's OIHW. :func:`params_from_jax` transposes
the JAX tree's HWIO kernels; diffusers checkpoints already hold OIHW.
Padding is XLA's "SAME": (1, 1) for the 3x3 stride-1 convolutions, (0, 1)
for the stride-2 ones. Group norm follows the reference's ``_gn``: its mean
and variance (computed in f32) are rounded to the activation dtype before
they are used. f32 convolutions run without TF32. The attention (head dim =
channels = 512 at SD widths) stays the plain products, as in the reference.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from ..utils.safetensors import SafeFile
from . import layers


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    base: int = 128  # first-level width
    channel_mults: tuple = (1, 2, 4, 4)  # SD: 128/256/512/512, 8x down
    scaling_factor: float = 0.18215  # SD1/2; SD3 uses 1.5305 (+shift)
    shift_factor: float = 0.0  # SD3: 0.0609
    norm_groups: int = 32
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.channel_mults) - 1)

    @staticmethod
    def sd_shape() -> "VAEConfig":
        """The SD1/2/XL VAE shape (4-ch latents, 8x downsample)."""
        return VAEConfig()

    @staticmethod
    def sd3_shape() -> "VAEConfig":
        """SD3/Flux VAE: 16-channel latents."""
        return VAEConfig(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609)

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(base=32, channel_mults=(1, 2), norm_groups=8)


def init_params(cfg: VAEConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights drawn on the device in the model dtype from ``seed``,
    at the JAX init's scales: convolutions (k*k*cin)**-0.5 (OIHW), attention
    projections c**-0.5; biases zero, norms one."""
    r = layers.SeededInit(seed, resolve_device(device), cfg.torch_dtype)
    full = r.full

    def conv(k, cin, cout):
        return r.dense(cout, cin, k, k, scale=(k * k * cin) ** -0.5)

    def resnet(cin, cout):
        p = {
            "norm1_scale": full(1.0, cin), "norm1_bias": full(0.0, cin),
            "conv1": conv(3, cin, cout), "conv1_b": full(0.0, cout),
            "norm2_scale": full(1.0, cout), "norm2_bias": full(0.0, cout),
            "conv2": conv(3, cout, cout), "conv2_b": full(0.0, cout),
        }
        if cin != cout:
            p["shortcut"] = conv(1, cin, cout)
            p["shortcut_b"] = full(0.0, cout)
        return p

    def attn(c):
        p = {"norm_scale": full(1.0, c), "norm_bias": full(0.0, c)}
        for n in ("q", "k", "v", "o"):
            p[n] = r.dense(c, c, scale=c**-0.5)
            p[n + "_b"] = full(0.0, c)
        return p

    widths = [cfg.base * m for m in cfg.channel_mults]
    enc = {
        "conv_in": conv(3, cfg.in_channels, widths[0]), "conv_in_b": full(0.0, widths[0]),
        "down": [],
        "mid_res1": resnet(widths[-1], widths[-1]),
        "mid_attn": attn(widths[-1]),
        "mid_res2": resnet(widths[-1], widths[-1]),
        "norm_out_scale": full(1.0, widths[-1]), "norm_out_bias": full(0.0, widths[-1]),
        "conv_out": conv(3, widths[-1], 2 * cfg.latent_channels),
        "conv_out_b": full(0.0, 2 * cfg.latent_channels),
    }
    cin = widths[0]
    for i, w in enumerate(widths):
        blk = {"res1": resnet(cin, w), "res2": resnet(w, w)}
        if i < len(widths) - 1:
            blk["downsample"], blk["downsample_b"] = conv(3, w, w), full(0.0, w)
        enc["down"].append(blk)
        cin = w
    dec = {
        "conv_in": conv(3, cfg.latent_channels, widths[-1]), "conv_in_b": full(0.0, widths[-1]),
        "mid_res1": resnet(widths[-1], widths[-1]),
        "mid_attn": attn(widths[-1]),
        "mid_res2": resnet(widths[-1], widths[-1]),
        "up": [],
        "norm_out_scale": full(1.0, widths[0]), "norm_out_bias": full(0.0, widths[0]),
        "conv_out": conv(3, widths[0], cfg.in_channels), "conv_out_b": full(0.0, cfg.in_channels),
    }
    cin = widths[-1]
    for i, w in enumerate(reversed(widths)):
        blk = {"res1": resnet(cin, w), "res2": resnet(w, w), "res3": resnet(w, w)}
        if i < len(widths) - 1:
            blk["upsample"], blk["upsample_b"] = conv(3, w, w), full(0.0, w)
        dec["up"].append(blk)
        cin = w
    return {"encoder": enc, "decoder": dec}


def params_from_jax(np_params: dict, cfg: VAEConfig, device=None) -> dict:
    """The JAX tree (numpy leaves) as this module's tree: every HWIO kernel
    transposed to OIHW, every other layout kept."""
    return layers.from_numpy_tree(
        np_params, cfg.torch_dtype, resolve_device(device),
        transform=lambda a: a.transpose(3, 2, 0, 1) if a.ndim == 4 else a,
    )


def _conv(x, w, b, stride: int = 1):
    """XLA "SAME" convolution of NCHW ``x`` with an OIHW kernel: the total
    padding ``max((ceil(n/s) - 1) * s + k - n, 0)``, the smaller half first
    (cuDNN pads symmetric cases itself)."""
    halves = []
    for n, k in ((x.shape[2], w.shape[2]), (x.shape[3], w.shape[3])):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        halves.append((total // 2, total - total // 2))
    if all(lo == hi for lo, hi in halves):
        return F.conv2d(x, w, b, stride=stride, padding=tuple(lo for lo, _ in halves))
    (top, bottom), (left, right) = halves
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b, stride=stride)


def _gn(x, scale, bias, groups: int, eps: float = 1e-6):
    """Group norm as the reference's ``_gn``: statistics over (group channels,
    H, W) computed in f32 and rounded to ``x``'s dtype, then applied there."""
    B, C, H, W = x.shape
    xg = x.reshape(B, groups, C // groups, H, W)
    xf = xg.float()
    mu = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = (xf - mu).square().mean(dim=(2, 3, 4), keepdim=True)
    xg = (xg - mu.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + eps)
    return xg.reshape(B, C, H, W) * scale[:, None, None] + bias[:, None, None]


def _resnet(p, x, groups):
    h = F.silu(_gn(x, p["norm1_scale"], p["norm1_bias"], groups))
    h = _conv(h, p["conv1"], p["conv1_b"])
    h = F.silu(_gn(h, p["norm2_scale"], p["norm2_bias"], groups))
    h = _conv(h, p["conv2"], p["conv2_b"])
    if "shortcut" in p:
        x = _conv(x, p["shortcut"], p["shortcut_b"])
    return x + h


def _attn(p, x, groups):
    """Single-head attention over the H*W positions (head dim = channels)."""
    B, C, H, W = x.shape
    flat = _gn(x, p["norm_scale"], p["norm_bias"], groups).reshape(B, C, H * W).transpose(1, 2)
    q = flat @ p["q"] + p["q_b"]
    k = flat @ p["k"] + p["k_b"]
    v = flat @ p["v"] + p["v_b"]
    s = torch.einsum("bqc,bkc->bqk", q.float(), k.float())
    a = torch.softmax(s * C**-0.5, dim=-1).to(v.dtype)
    o = torch.einsum("bqk,bkc->bqc", a, v) @ p["o"] + p["o_b"]
    return x + o.transpose(1, 2).reshape(B, C, H, W)


def _mid(p, x, g):
    x = _resnet(p["mid_res1"], x, g)
    x = _attn(p["mid_attn"], x, g)
    return _resnet(p["mid_res2"], x, g)


def encode(params: dict, images, cfg: VAEConfig, *, generator: torch.Generator | None = None):
    """images [B, H, W, C] in [-1, 1] -> scaled latents [B, H/8, W/8, Cl].
    With ``generator`` the posterior is sampled (noise from that generator);
    without, the mean is returned."""
    g = cfg.norm_groups
    p = params["encoder"]
    with layers.exact_f32_convs():
        x = _conv(images.to(cfg.torch_dtype).permute(0, 3, 1, 2), p["conv_in"], p["conv_in_b"])
        for blk in p["down"]:
            x = _resnet(blk["res1"], x, g)
            x = _resnet(blk["res2"], x, g)
            if "downsample" in blk:
                x = _conv(x, blk["downsample"], blk["downsample_b"], stride=2)
        x = _mid(p, x, g)
        x = F.silu(_gn(x, p["norm_out_scale"], p["norm_out_bias"], g))
        x = _conv(x, p["conv_out"], p["conv_out_b"])
        if "quant_conv" in params:  # SD1/2 checkpoints; SD3/Flux drop it
            x = _conv(x, params["quant_conv"], params["quant_conv_b"])
    mean, logvar = x.permute(0, 2, 3, 1).chunk(2, dim=-1)
    if generator is not None:
        std = torch.exp(0.5 * logvar.clamp(-30, 20))
        mean = mean + std * torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return (mean - cfg.shift_factor) * cfg.scaling_factor


def decode(params: dict, latents, cfg: VAEConfig):
    """Scaled latents [B, h, w, Cl] -> images [B, H, W, C] in [-1, 1]."""
    g = cfg.norm_groups
    p = params["decoder"]
    z = latents.to(cfg.torch_dtype) / cfg.scaling_factor + cfg.shift_factor
    z = z.permute(0, 3, 1, 2)
    with layers.exact_f32_convs():
        if "post_quant_conv" in params:
            z = _conv(z, params["post_quant_conv"], params["post_quant_conv_b"])
        x = _mid(p, _conv(z, p["conv_in"], p["conv_in_b"]), g)
        for blk in p["up"]:
            x = _resnet(blk["res1"], x, g)
            x = _resnet(blk["res2"], x, g)
            x = _resnet(blk["res3"], x, g)
            if "upsample" in blk:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
                x = _conv(x, blk["upsample"], blk["upsample_b"])
        x = F.silu(_gn(x, p["norm_out_scale"], p["norm_out_bias"], g))
        x = _conv(x, p["conv_out"], p["conv_out_b"])
    return x.permute(0, 2, 3, 1).clamp(-1.0, 1.0)


def load_hf_weights(model_dir: str | Path, cfg: VAEConfig, dtype=None, device=None) -> dict:
    """A diffusers AutoencoderKL safetensors checkpoint
    (``vae/diffusion_pytorch_model.safetensors`` naming; every
    ``*.safetensors`` of ``model_dir``) as this module's tree, read through
    the port's safetensors reader: convolutions kept OIHW, attention linears
    transposed to [in, out]; the SD1/2 quant convolutions when present.
    Every leaf in ``dtype`` (default ``cfg.dtype``) on ``device``."""
    device = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    raw: dict[str, torch.Tensor] = {}
    for f in sorted(Path(model_dir).glob("*.safetensors")):
        with SafeFile(f) as sf:
            for name in sf.keys():
                raw[name] = sf.get_tensor(name)

    def vec(name):
        return raw.pop(name).to(device=device, dtype=dt).contiguous()

    def conv(name):
        return vec(name + ".weight")

    def bias(name):
        return vec(name + ".bias")

    def resnet(prefix):
        p = {
            "norm1_scale": vec(f"{prefix}.norm1.weight"), "norm1_bias": vec(f"{prefix}.norm1.bias"),
            "conv1": conv(f"{prefix}.conv1"), "conv1_b": bias(f"{prefix}.conv1"),
            "norm2_scale": vec(f"{prefix}.norm2.weight"), "norm2_bias": vec(f"{prefix}.norm2.bias"),
            "conv2": conv(f"{prefix}.conv2"), "conv2_b": bias(f"{prefix}.conv2"),
        }
        if f"{prefix}.conv_shortcut.weight" in raw:
            p["shortcut"] = conv(f"{prefix}.conv_shortcut")
            p["shortcut_b"] = bias(f"{prefix}.conv_shortcut")
        return p

    def attn(prefix):
        p = {"norm_scale": vec(f"{prefix}.group_norm.weight"), "norm_bias": vec(f"{prefix}.group_norm.bias")}
        for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out.0")):
            p[ours] = raw.pop(f"{prefix}.{theirs}.weight").T.to(device=device, dtype=dt).contiguous()
            p[ours + "_b"] = vec(f"{prefix}.{theirs}.bias")
        return p

    def side(name: str, levels: str, n_res: int, resampler: str) -> dict:
        out = {
            "conv_in": conv(f"{name}.conv_in"), "conv_in_b": bias(f"{name}.conv_in"),
            levels: [],
            "mid_res1": resnet(f"{name}.mid_block.resnets.0"),
            "mid_attn": attn(f"{name}.mid_block.attentions.0"),
            "mid_res2": resnet(f"{name}.mid_block.resnets.1"),
            "norm_out_scale": vec(f"{name}.conv_norm_out.weight"),
            "norm_out_bias": vec(f"{name}.conv_norm_out.bias"),
            "conv_out": conv(f"{name}.conv_out"), "conv_out_b": bias(f"{name}.conv_out"),
        }
        block = "down_blocks" if levels == "down" else "up_blocks"
        for i in range(len(cfg.channel_mults)):
            blk = {f"res{j + 1}": resnet(f"{name}.{block}.{i}.resnets.{j}") for j in range(n_res)}
            if i < len(cfg.channel_mults) - 1:
                where = f"{name}.{block}.{i}.{resampler}rs.0.conv"  # downsamplers / upsamplers
                blk[resampler], blk[resampler + "_b"] = conv(where), bias(where)
            out[levels].append(blk)
        return out

    params = {"encoder": side("encoder", "down", 2, "downsample"), "decoder": side("decoder", "up", 3, "upsample")}
    if "quant_conv.weight" in raw:  # SD1/2 checkpoints; SD3/Flux drop them
        params["quant_conv"] = conv("quant_conv")
        params["quant_conv_b"] = bias("quant_conv")
        params["post_quant_conv"] = conv("post_quant_conv")
        params["post_quant_conv_b"] = bias("post_quant_conv")
    return params
