"""Text-to-image diffusion: a DiT and the SD3-family MMDiT, both
rectified-flow models sampled by Euler steps with classifier-free guidance
and trained by flow matching.

Counterpart of ``modal_examples_tpu/models/diffusion.py``:
- ``DiTConfig``, ``timestep_embedding``, ``patchify``/``unpatchify``,
  ``init_params``, ``forward`` (adaLN-zero blocks with self-attention,
  cross-attention to text states and an optional ControlNet-style
  ``control``/``control_tokens``) and ``sample``;
- ``MMDiTConfig``, ``mmdit_init``, ``mmdit_forward`` (two token streams with
  their own modulation and projections, RMS q/k norms, JOINT attention over
  [context; image]; ``context_pre_only_last`` builds the final block as
  diffusers' ``context_pre_only`` block, whose continuous norm chunks are
  (scale, shift)), ``mmdit_sample`` and ``load_mmdit_hf_weights``;
- the rectified-flow losses ``flow_loss`` (the DiT, with classifier-free
  guidance dropout onto the null text and ControlNet's ``control=``) and
  ``mmdit_flow_loss``, differentiable end to end: the MMDiT's bf16 joint
  attention trains through the flash kernel's ``autograd.Function`` (the
  forward kernel, then the dQ and dK/dV kernels in the backward). The
  diffusion LoRA is ``models/lora.py``'s tree LoRA, merged inside the loss.

Attention, chosen by dtype and nothing else: the MMDiT's joint attention in
bf16 goes through ``ops.flash_attention.flash_attention(causal=False)``,
which launches the flash kernel on a CUDA tensor (its plain twin on the
CPU); at any other dtype it is the reference's plain products (f32 scores
and softmax, probabilities rounded to the value dtype), as are the DiT's
attentions at every dtype. The flash kernel rounds its unnormalised
probabilities to bf16 and divides by their sum at the end, where the
reference normalises in f32 first.

The samplers draw their starting noise from ``generator`` (a
``torch.Generator`` on the latents' device) or take it as ``noise=``; the
losses draw ``t``, ``eps`` (and the DiT's dropout ``drop``) from
``generator`` or take them as arguments, where the reference splits a
``jax.random`` key (the tests hand both the same numbers); each
Euler step runs the conditional forward, then the unconditional one, as
the reference does. Layer norms and RMS norms compute their statistics in
f32 and round them to the activation dtype, as ``jnp.mean``/``jnp.var`` do
for bf16. Parameters keep the JAX tree (per-layer leaves stacked on axis 0,
weights [in, out]).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import flash_attention as _flash
from ..ops import reference
from ..utils.device import resolve_device
from ..utils.safetensors import SafeFile
from . import layers


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    img_size: int = 32
    channels: int = 3
    patch: int = 2
    dim: int = 256
    n_layers: int = 6
    n_heads: int = 8
    text_dim: int = 64
    text_len: int = 16
    norm_eps: float = 1e-6
    dtype: str = "float32"
    # ControlNet-style spatial conditioning: adds the zero-init control_proj leaf
    control: bool = False

    @property
    def n_patches(self) -> int:
        return (self.img_size // self.patch) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * self.channels

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def tiny() -> "DiTConfig":
        return DiTConfig(img_size=16, patch=2, dim=128, n_layers=4, n_heads=4)


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """SD3-family MMDiT: joint attention over [context; image] streams.
    ``sd3_shape()`` is SD3-Medium's dimensions (diffusers
    SD3Transformer2DModel); ``tiny()`` the test shape."""

    img_size: int = 32  # latent H=W
    channels: int = 16  # latent channels (SD3 VAE)
    patch: int = 2
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 4
    text_dim: int = 64  # per-token text-state width
    pooled_dim: int = 64  # pooled text embedding width
    qk_norm: bool = True  # RMS q/k norm (SD3.5)
    norm_eps: float = 1e-6
    dtype: str = "float32"
    # the last block as diffusers' context_pre_only block (real SD3/SD3.5
    # checkpoints): its own leaves under "last_block"
    context_pre_only_last: bool = False

    @property
    def n_patches(self) -> int:
        return (self.img_size // self.patch) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * self.channels

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def sd3_shape() -> "MMDiTConfig":
        """SD3-Medium dims: 24 blocks, width 1536, 16-ch latents, CLIP-L+G
        pooled (2048) and 4096-wide joint text states."""
        return MMDiTConfig(
            img_size=64, channels=16, patch=2, dim=1536, n_layers=24,
            n_heads=24, text_dim=4096, pooled_dim=2048, dtype="bfloat16",
            context_pre_only_last=True,
        )

    @staticmethod
    def tiny() -> "MMDiTConfig":
        return MMDiTConfig()


# -- shared pieces -------------------------------------------------------------


def params_from_jax(np_params: dict, cfg, device=None) -> dict:
    """A DiT or MMDiT JAX tree (numpy leaves) as this module's tree in
    ``cfg.dtype``, layouts unchanged."""
    return layers.from_numpy_tree(np_params, cfg.torch_dtype, resolve_device(device))


def timestep_embedding(t, dim: int):
    """Sinusoidal embedding of t in [0, 1] ([B]) -> [B, dim] f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * 1000.0 * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def patchify(x, cfg):
    """[B, H, W, C] -> [B, n_patches, patch * patch * C] (row-major (ph, pw, c))."""
    B, H, W, C = x.shape
    p = cfg.patch
    x = x.reshape(B, H // p, p, W // p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(x, cfg):
    B = x.shape[0]
    p, C = cfg.patch, cfg.channels
    hw = cfg.img_size // p
    x = x.reshape(B, hw, hw, p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, cfg.img_size, cfg.img_size, C)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _norm(v, eps: float):
    """Layer norm without affine over the last axis; mean and variance in
    f32, rounded to ``v``'s dtype (``jnp.mean``/``jnp.var`` on bf16)."""
    vf = v.float()
    mu = vf.mean(dim=-1, keepdim=True)
    var = (vf - mu).square().mean(dim=-1, keepdim=True)
    return (v - mu.to(v.dtype)) * torch.rsqrt(var.to(v.dtype) + eps)


def _rms(x, scale, eps: float = 1e-6):
    ms = (x * x).float().mean(dim=-1, keepdim=True).to(x.dtype)
    return x * torch.rsqrt(ms + eps) * scale


def _heads(x, n_heads: int):
    B, S, D = x.shape
    return x.reshape(B, S, n_heads, D // n_heads).transpose(1, 2)


def _merge(o):
    B, H, S, hd = o.shape
    return o.transpose(1, 2).reshape(B, S, H * hd)


def _mha(q, k, v, n_heads: int):
    """The DiT's attention: plain products over [B, S, D] projections."""
    return _merge(reference.attention(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads), causal=False))


def _initial_noise(shape, device, generator, noise):
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise has shape {tuple(noise.shape)}; the sampler wants {tuple(shape)}")
        return noise.to(device=device, dtype=torch.float32)
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


# -- DiT -----------------------------------------------------------------------


def init_params(cfg: DiTConfig, *, seed: int = 0, device=None) -> dict:
    """Random DiT weights drawn on the device in the model dtype; the
    reference's zero-init leaves (modulation, the cross-attention output,
    the final projection, ``control_proj``) are zero."""
    r = layers.SeededInit(seed, resolve_device(device), cfg.torch_dtype)
    D, L = cfg.dim, cfg.n_layers
    return {
        "patch_proj": r.dense(cfg.patch_dim, D, scale=0.02),
        **({"control_proj": r.full(0.0, cfg.patch_dim, D)} if cfg.control else {}),
        "pos_emb": r.dense(cfg.n_patches, D, scale=0.02),
        "t_mlp1": r.dense(D, D),
        "t_mlp2": r.dense(D, D),
        "text_proj": r.dense(cfg.text_dim, D, scale=0.02),
        "null_text": r.dense(cfg.text_len, cfg.text_dim, scale=0.02),
        "layers": {
            "mod_w": r.full(0.0, L, D, 6 * D), "mod_b": r.full(0.0, L, 6 * D),
            "wq": r.dense(L, D, D), "wk": r.dense(L, D, D), "wv": r.dense(L, D, D), "wo": r.dense(L, D, D),
            "xwq": r.dense(L, D, D), "xwk": r.dense(L, D, D), "xwv": r.dense(L, D, D),
            "xwo": r.full(0.0, L, D, D),
            "fc_w": r.dense(L, D, 4 * D), "fc_b": r.full(0.0, L, 4 * D),
            "proj_w": r.dense(L, 4 * D, D), "proj_b": r.full(0.0, L, D),
        },
        "final_mod_w": r.full(0.0, D, 2 * D),
        "final_mod_b": r.full(0.0, 2 * D),
        "final_proj": r.full(0.0, D, cfg.patch_dim),
    }


def _control_tokens(params: dict, control, cfg: DiTConfig):
    if "control_proj" not in params:
        raise ValueError("control= given but params have no control_proj leaf — train with DiTConfig(control=True)")
    return patchify(control, cfg) @ params["control_proj"]


def forward(params: dict, x_t, t, text_states, cfg: DiTConfig, control=None, control_tokens=None):
    """x_t [B, H, W, C] noised image, t [B] in [0, 1], text_states
    [B, S, text_dim] -> predicted velocity [B, H, W, C]. ``control`` (an
    image like x_t) or its precomputed ``control_tokens`` add spatial
    conditioning."""
    h = patchify(x_t, cfg) @ params["patch_proj"] + params["pos_emb"][None]
    if control_tokens is not None:
        h = h + control_tokens
    elif control is not None:
        h = h + _control_tokens(params, control, cfg)
    temb = timestep_embedding(t, cfg.dim)
    temb = F.silu(temb @ params["t_mlp1"]) @ params["t_mlp2"]
    text = text_states @ params["text_proj"]  # [B, S, D]
    cond = temb + text.mean(dim=1)  # pooled text joins the adaLN signal
    eps = cfg.norm_eps
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        l = {k: v[i] for k, v in stacked.items()}
        s1, sc1, g1, s2, sc2, g2 = (F.silu(cond) @ l["mod_w"] + l["mod_b"]).chunk(6, dim=-1)
        a = _modulate(_norm(h, eps), s1, sc1)
        a = _mha(a @ l["wq"], a @ l["wk"], a @ l["wv"], cfg.n_heads)
        h = h + g1[:, None, :] * (a @ l["wo"])
        xq = _norm(h, eps) @ l["xwq"]
        h = h + _mha(xq, text @ l["xwk"], text @ l["xwv"], cfg.n_heads) @ l["xwo"]
        m = _modulate(_norm(h, eps), s2, sc2)
        m = F.gelu(m @ l["fc_w"] + l["fc_b"], approximate="tanh") @ l["proj_w"] + l["proj_b"]
        h = h + g2[:, None, :] * m
    shift, scale = (F.silu(cond) @ params["final_mod_w"] + params["final_mod_b"]).chunk(2, dim=-1)
    h = _modulate(_norm(h, eps), shift, scale) @ params["final_proj"]
    return unpatchify(h, cfg)


def _null_text(params: dict, shape: tuple):
    """The learned null embedding broadcast to [B, S, text_dim] for any S."""
    B, S, Dt = shape
    stored = params["null_text"]
    n = min(S, stored.shape[0])
    base = torch.zeros((S, Dt), dtype=stored.dtype, device=stored.device)
    base[:n] = stored[:n]
    return base[None].expand(B, S, Dt)


@torch.no_grad()
def sample(params: dict, text_states, cfg: DiTConfig, *, steps: int = 8, guidance: float = 3.0, control=None,
           generator: torch.Generator | None = None, noise=None):
    """Euler integration of the flow from noise (t=1) to data (t=0) with
    classifier-free guidance against the null text -> [B, H, W, C] in
    [-1, 1]. The starting noise is ``noise`` or drawn from ``generator``."""
    B = text_states.shape[0]
    dev = text_states.device
    x = _initial_noise((B, cfg.img_size, cfg.img_size, cfg.channels), dev, generator, noise)
    null = _null_text(params, text_states.shape)
    ts = torch.linspace(1.0, 0.0, steps + 1, device=dev)
    ctrl = None if control is None else _control_tokens(params, control, cfg)  # loop-invariant
    for i in range(steps):
        tb = ts[i].expand(B)
        v_cond = forward(params, x, tb, text_states, cfg, control_tokens=ctrl)
        v_null = forward(params, x, tb, null, cfg, control_tokens=ctrl)
        v = v_null + guidance * (v_cond - v_null)
        x = x + (ts[i + 1] - ts[i]) * v  # dx/dt = v; integrating t: 1 -> 0
    return x.clamp(-1.0, 1.0)


def _flow_draws(x, generator, t, eps):
    B, dev = x.shape[0], x.device
    if t is None:
        t = torch.rand((B,), generator=generator, device=dev)
    if eps is None:
        eps = torch.randn(x.shape, generator=generator, device=dev)
    return t.to(device=dev, dtype=torch.float32), eps.to(device=dev, dtype=torch.float32)


def flow_loss(params: dict, images, text_states, cfg: DiTConfig, *, null_prob: float = 0.1, control=None,
              generator: torch.Generator | None = None, t=None, eps=None, drop=None):
    """Rectified-flow matching loss with classifier-free-guidance dropout:
    ``x_t = (1 - t) images + t eps``, the velocity target ``eps - images``,
    and each row's text replaced by the null embedding where ``drop`` (drawn
    with probability ``null_prob``) is set. ``t`` [B] uniform, ``eps`` like
    ``images`` and ``drop`` [B] bool come from ``generator`` unless given.
    ``control`` conditions every row (ControlNet). Returns the mean squared
    error, a scalar."""
    t, eps = _flow_draws(images, generator, t, eps)
    if drop is None:
        drop = torch.rand((images.shape[0],), generator=generator, device=images.device) < null_prob
    tb = t[:, None, None, None]
    x_t = (1 - tb) * images + tb * eps
    target_v = eps - images
    null = _null_text(params, text_states.shape)
    text_in = torch.where(drop.to(text_states.device)[:, None, None], null, text_states)
    pred = forward(params, x_t, t, text_in, cfg, control=control)
    return ((pred - target_v) ** 2).mean()


# -- MMDiT ---------------------------------------------------------------------


def _mmdit_block_init(r: layers.SeededInit, cfg: MMDiTConfig, lead: tuple, pre_only: bool) -> dict:
    D, hd = cfg.dim, cfg.head_dim
    p = {
        # per-stream adaLN, zero-init; the pre-only context norm has (scale, shift) only
        "img_mod_w": r.full(0.0, *lead, D, 6 * D), "img_mod_b": r.full(0.0, *lead, 6 * D),
        "ctx_mod_w": r.full(0.0, *lead, D, (2 if pre_only else 6) * D),
        "ctx_mod_b": r.full(0.0, *lead, (2 if pre_only else 6) * D),
    }
    for side in ("img", "ctx"):
        for n in ("q", "k", "v", "o"):
            if side == "ctx" and n == "o" and pre_only:
                continue
            p[f"{side}_w{n}"] = r.dense(*lead, D, D)
            p[f"{side}_b{n}"] = r.full(0.0, *lead, D)
    for n in ("img_qnorm", "img_knorm", "ctx_qnorm", "ctx_knorm"):
        p[n] = r.full(1.0, *lead, hd)
    for side in ("img",) if pre_only else ("img", "ctx"):
        p[f"{side}_fc1"], p[f"{side}_fc1_b"] = r.dense(*lead, D, 4 * D), r.full(0.0, *lead, 4 * D)
        p[f"{side}_fc2"], p[f"{side}_fc2_b"] = r.dense(*lead, 4 * D, D), r.full(0.0, *lead, D)
    return p


def mmdit_init(cfg: MMDiTConfig, *, seed: int = 0, device=None) -> dict:
    """Random MMDiT weights drawn on the device in the model dtype (an
    SD3-shape init never holds an f32 copy). As in the reference, every
    modulation leaf and the final projection are zero: a fresh model's
    blocks are the identity and its velocity is exactly zero."""
    r = layers.SeededInit(seed, resolve_device(device), cfg.torch_dtype)
    D = cfg.dim
    L = cfg.n_layers - int(cfg.context_pre_only_last)
    tree = {
        "patch_proj": r.dense(cfg.patch_dim, D, scale=0.02),
        "patch_bias": r.full(0.0, D),
        "pos_emb": r.dense(cfg.n_patches, D, scale=0.02),
        "t_mlp1": r.dense(256, D), "t_mlp1_b": r.full(0.0, D),
        "t_mlp2": r.dense(D, D), "t_mlp2_b": r.full(0.0, D),
        "pool_mlp1": r.dense(cfg.pooled_dim, D), "pool_mlp1_b": r.full(0.0, D),
        "pool_mlp2": r.dense(D, D), "pool_mlp2_b": r.full(0.0, D),
        "ctx_proj": r.dense(cfg.text_dim, D), "ctx_proj_b": r.full(0.0, D),
        "blocks": _mmdit_block_init(r, cfg, (L,), pre_only=False),
        "final_mod_w": r.full(0.0, D, 2 * D),
        "final_mod_b": r.full(0.0, 2 * D),
        "final_proj": r.full(0.0, D, cfg.patch_dim),
        "final_proj_b": r.full(0.0, cfg.patch_dim),
    }
    if cfg.context_pre_only_last:
        tree["last_block"] = _mmdit_block_init(r, cfg, (), pre_only=True)
    return tree


def _joint_attention(q, k, v):
    """Full attention over the joint [context; image] heads [B, H, S, hd]:
    bf16 through the flash kernel's entry point (the kernel on a CUDA
    tensor), any other dtype through the plain products."""
    if q.dtype == torch.bfloat16:
        return _flash.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=False)
    return reference.attention(q, k, v, causal=False)


def _joint_block(img, ctx, l: dict, cond, cfg: MMDiTConfig, pre_only: bool):
    """One MMDiT block. ``pre_only`` is diffusers' ``context_pre_only``
    block (SD3's last): the context stream is normed by a continuous adaLN
    whose chunks are (scale, shift), gives q/k/v to the joint attention,
    and its output is discarded."""
    eps, H = cfg.norm_eps, cfg.n_heads
    i_s1, i_sc1, i_g1, i_s2, i_sc2, i_g2 = (cond @ l["img_mod_w"] + l["img_mod_b"]).chunk(6, dim=-1)
    cm = cond @ l["ctx_mod_w"] + l["ctx_mod_b"]
    if pre_only:
        c_sc1, c_s1 = cm.chunk(2, dim=-1)  # AdaLayerNormContinuous: (scale, shift)
    else:
        c_s1, c_sc1, c_g1, c_s2, c_sc2, c_g2 = cm.chunk(6, dim=-1)
    ia = _modulate(_norm(img, eps), i_s1, i_sc1)
    ca = _modulate(_norm(ctx, eps), c_s1, c_sc1)
    qi, ki, vi = (_heads(ia @ l[f"img_w{n}"] + l[f"img_b{n}"], H) for n in "qkv")
    qc, kc, vc = (_heads(ca @ l[f"ctx_w{n}"] + l[f"ctx_b{n}"], H) for n in "qkv")
    if cfg.qk_norm:
        qi, ki = _rms(qi, l["img_qnorm"]), _rms(ki, l["img_knorm"])
        qc, kc = _rms(qc, l["ctx_qnorm"]), _rms(kc, l["ctx_knorm"])
    o = _merge(_joint_attention(torch.cat([qc, qi], dim=2), torch.cat([kc, ki], dim=2), torch.cat([vc, vi], dim=2)))
    Si = img.shape[1]
    oc, oi = o[:, :-Si], o[:, -Si:]
    img = img + i_g1[:, None] * (oi @ l["img_wo"] + l["img_bo"])
    m = _modulate(_norm(img, eps), i_s2, i_sc2)
    m = F.gelu(m @ l["img_fc1"] + l["img_fc1_b"], approximate="tanh")
    img = img + i_g2[:, None] * (m @ l["img_fc2"] + l["img_fc2_b"])
    if pre_only:
        return img, ctx  # context output discarded
    ctx = ctx + c_g1[:, None] * (oc @ l["ctx_wo"] + l["ctx_bo"])
    m = _modulate(_norm(ctx, eps), c_s2, c_sc2)
    m = F.gelu(m @ l["ctx_fc1"] + l["ctx_fc1_b"], approximate="tanh")
    ctx = ctx + c_g2[:, None] * (m @ l["ctx_fc2"] + l["ctx_fc2_b"])
    return img, ctx


def mmdit_forward(params: dict, x_t, t, text_states, pooled, cfg: MMDiTConfig):
    """x_t [B, H, W, C] noised latents, t [B] in [0, 1], text_states
    [B, S, text_dim], pooled [B, pooled_dim] -> f32 velocity [B, H, W, C]."""
    dt = cfg.torch_dtype
    img = patchify(x_t.to(dt), cfg) @ params["patch_proj"]
    img = img + params["patch_bias"] + params["pos_emb"][None]
    ctx = text_states.to(dt) @ params["ctx_proj"] + params["ctx_proj_b"]
    temb = timestep_embedding(t, 256).to(dt)
    temb = F.silu(temb @ params["t_mlp1"] + params["t_mlp1_b"]) @ params["t_mlp2"] + params["t_mlp2_b"]
    pvec = F.silu(pooled.to(dt) @ params["pool_mlp1"] + params["pool_mlp1_b"]) @ params["pool_mlp2"]
    pvec = pvec + params["pool_mlp2_b"]
    cond = F.silu(temb + pvec)  # [B, D]
    blocks = params["blocks"]
    for i in range(cfg.n_layers - int(cfg.context_pre_only_last)):
        img, ctx = _joint_block(img, ctx, {k: v[i] for k, v in blocks.items()}, cond, cfg, pre_only=False)
    if cfg.context_pre_only_last:
        img, _ = _joint_block(img, ctx, params["last_block"], cond, cfg, pre_only=True)
    # norm_out is AdaLayerNormContinuous: chunk order (scale, shift)
    scale, shift = (cond @ params["final_mod_w"] + params["final_mod_b"]).chunk(2, dim=-1)
    out = _modulate(_norm(img, cfg.norm_eps), shift, scale) @ params["final_proj"] + params["final_proj_b"]
    return unpatchify(out, cfg).float()


@torch.no_grad()
def mmdit_sample(params: dict, text_states, pooled, null_states, null_pooled, cfg: MMDiTConfig, *,
                 steps: int = 8, guidance: float = 4.0, generator: torch.Generator | None = None, noise=None):
    """Euler rectified-flow sampler with CFG over the MMDiT -> f32 latents
    [B, H, W, C]. The starting noise is ``noise`` or drawn from
    ``generator``; each step runs the conditional forward, then the
    unconditional one."""
    B = text_states.shape[0]
    dev = text_states.device
    x = _initial_noise((B, cfg.img_size, cfg.img_size, cfg.channels), dev, generator, noise)
    ts = torch.linspace(1.0, 0.0, steps + 1, device=dev)
    for i in range(steps):
        tb = ts[i].expand(B)
        v_c = mmdit_forward(params, x, tb, text_states, pooled, cfg)
        v_u = mmdit_forward(params, x, tb, null_states, null_pooled, cfg)
        v = v_u + guidance * (v_c - v_u)
        x = x + (ts[i + 1] - ts[i]) * v
    return x


def mmdit_flow_loss(params: dict, latents, text_states, pooled, cfg: MMDiTConfig, *,
                    generator: torch.Generator | None = None, t=None, eps=None):
    """Rectified-flow matching loss for the MMDiT (training and DreamBooth
    fine-tuning): ``x_t = (1 - t) latents + t eps`` against the velocity
    ``eps - latents``, in f32 over the f32 prediction. ``t`` [B] and ``eps``
    come from ``generator`` unless given."""
    t, eps = _flow_draws(latents, generator, t, eps)
    tb = t[:, None, None, None]
    x_t = (1 - tb) * latents + tb * eps
    pred = mmdit_forward(params, x_t, t, text_states, pooled, cfg)
    return ((pred - (eps - latents)) ** 2).mean()


def load_mmdit_hf_weights(model_dir, cfg: MMDiTConfig, dtype=None, device=None) -> dict:
    """A diffusers SD3Transformer2DModel safetensors checkpoint
    (``transformer/diffusion_pytorch_model.safetensors`` naming; every
    ``*.safetensors`` of ``model_dir``) as the MMDiT tree, read through the
    port's safetensors reader: linears transposed to [in, out], the patch
    convolution [D, C, p, p] as the [p*p*C, D] matrix of ``patchify``'s
    order, blocks stacked. With ``cfg.context_pre_only_last`` (real
    SD3/SD3.5 checkpoints) the last block loads as the pre-only block; a
    checkpoint that does not match the config raises ``KeyError`` or
    ``ValueError``, as the reference's loader does."""
    device = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    raw: dict[str, torch.Tensor] = {}
    for f in sorted(Path(model_dir).glob("*.safetensors")):
        with SafeFile(f) as sf:
            for name in sf.keys():
                raw[name] = sf.get_tensor(name)
    L = cfg.n_layers - int(cfg.context_pre_only_last)

    def put(t):
        return t.to(device=device, dtype=dt).contiguous()

    def lin(name):
        return put(raw.pop(name + ".weight").T)

    def b(name):
        return put(raw.pop(name + ".bias"))

    def vec(name):
        return put(raw.pop(name))

    def stack(fn, fmt):
        mats = [fn(fmt.format(i)) for i in range(L)]
        if len({m.shape for m in mats}) > 1:
            raise ValueError(f"{fmt}: blocks differ in shape ({[tuple(m.shape) for m in mats]}); a "
                             "context_pre_only last block wants MMDiTConfig(context_pre_only_last=True)")
        return torch.stack(mats)

    # (ours, diffusers module, kind): kind "lin" gives the weight and its bias
    block_names = [
        ("img_mod", "norm1.linear"), ("ctx_mod", "norm1_context.linear"),
        ("img_q", "attn.to_q"), ("img_k", "attn.to_k"), ("img_v", "attn.to_v"), ("img_o", "attn.to_out.0"),
        ("ctx_q", "attn.add_q_proj"), ("ctx_k", "attn.add_k_proj"), ("ctx_v", "attn.add_v_proj"),
        ("ctx_o", "attn.to_add_out"),
        ("img_qnorm", "attn.norm_q.weight"), ("img_knorm", "attn.norm_k.weight"),
        ("ctx_qnorm", "attn.norm_added_q.weight"), ("ctx_knorm", "attn.norm_added_k.weight"),
        ("img_fc1", "ff.net.0.proj"), ("img_fc2", "ff.net.2"),
        ("ctx_fc1", "ff_context.net.0.proj"), ("ctx_fc2", "ff_context.net.2"),
    ]

    def block(prefix: str, pre_only: bool, read) -> dict:
        out = {}
        for ours, theirs in block_names:
            if pre_only and ours in ("ctx_o", "ctx_fc1", "ctx_fc2"):
                continue
            if ours.endswith("norm"):
                out[ours] = read(vec, prefix + theirs)
            elif ours.endswith(("_mod", "fc1", "fc2")):
                w, bias = (ours + "_w", ours + "_b") if ours.endswith("_mod") else (ours, ours + "_b")
                out[w], out[bias] = read(lin, prefix + theirs), read(b, prefix + theirs)
            else:  # a q/k/v/o projection: img_q -> img_wq, img_bq
                side, n = ours.split("_")
                out[f"{side}_w{n}"], out[f"{side}_b{n}"] = read(lin, prefix + theirs), read(b, prefix + theirs)
        return out

    pw = raw.pop("pos_embed.proj.weight")  # [D, C, p, p]
    D_, C_, p_, _ = pw.shape
    tree = {
        "patch_proj": put(pw.permute(2, 3, 1, 0).reshape(p_ * p_ * C_, D_)),
        "patch_bias": vec("pos_embed.proj.bias"),
        "pos_emb": put(raw.pop("pos_embed.pos_embed")[0]),
        "t_mlp1": lin("time_text_embed.timestep_embedder.linear_1"),
        "t_mlp1_b": b("time_text_embed.timestep_embedder.linear_1"),
        "t_mlp2": lin("time_text_embed.timestep_embedder.linear_2"),
        "t_mlp2_b": b("time_text_embed.timestep_embedder.linear_2"),
        "pool_mlp1": lin("time_text_embed.text_embedder.linear_1"),
        "pool_mlp1_b": b("time_text_embed.text_embedder.linear_1"),
        "pool_mlp2": lin("time_text_embed.text_embedder.linear_2"),
        "pool_mlp2_b": b("time_text_embed.text_embedder.linear_2"),
        "ctx_proj": lin("context_embedder"),
        "ctx_proj_b": b("context_embedder"),
        "blocks": block("transformer_blocks.{}.", False, stack),
        "final_mod_w": lin("norm_out.linear"),
        "final_mod_b": b("norm_out.linear"),
        "final_proj": lin("proj_out"),
        "final_proj_b": b("proj_out"),
    }
    if cfg.context_pre_only_last:
        tree["last_block"] = block(f"transformer_blocks.{cfg.n_layers - 1}.", True, lambda fn, name: fn(name))
    return tree
