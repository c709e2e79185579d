"""Latent video generation: a factorized space-time DiT with first-frame
conditioning.

Counterpart of ``modal_examples_tpu/models/video.py`` (``VideoDiTConfig``,
``init_params``, ``patchify``, ``unpatchify``, ``forward``, ``flow_loss``,
``sample``): video lives as latents [B, T, S, S, C]; each block runs spatial
attention (tokens within a frame, frames batched), temporal attention (one
patch position across frames, positions batched) and cross-attention to the
text over the flattened space-time tokens, under adaLN-zero modulation per
frame (9 vectors a block). A per-frame indicator joins the conditioning, so
frame 0 can be pinned to a clean keyframe in training and sampling (the
image-to-video and two-stage recipes). Training is rectified flow; sampling
is Euler steps with classifier-free guidance against the learned null text.

The attentions are the reference's plain products (f32 scores and softmax,
``_mha``; none is a Pallas kernel there), the timestep embedding is
``diffusion.timestep_embedding``. Randomness comes from a
``torch.Generator`` or is passed in, as the port's other samplers take it:
``flow_loss`` takes ``t``, ``eps``, ``pin`` and ``drop`` (else draws them,
where the reference splits a key), ``sample`` its starting ``noise``.
Parameters keep the JAX tree (per-layer leaves stacked on axis 0, weights
[in, out]).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops import reference
from ..utils.device import resolve_device
from . import layers
from .diffusion import _initial_noise, _null_text, timestep_embedding


@dataclasses.dataclass(frozen=True)
class VideoDiTConfig:
    frames: int = 8  # T
    img_size: int = 16  # latent spatial side
    channels: int = 4  # latent channels (VAE z)
    patch: int = 2
    dim: int = 256
    n_layers: int = 6
    n_heads: int = 8
    text_dim: int = 64
    text_len: int = 16
    norm_eps: float = 1e-6
    dtype: str = "float32"

    @property
    def n_patches(self) -> int:  # spatial tokens a frame
        return (self.img_size // self.patch) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * self.channels

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def tiny() -> "VideoDiTConfig":
        return VideoDiTConfig(frames=4, img_size=8, channels=4, patch=2, dim=96, n_layers=3, n_heads=4,
                              text_dim=32, text_len=8)


def init_params(cfg: VideoDiTConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights drawn on the device in the model dtype from ``seed``;
    the reference's zero-init leaves (modulation, the cross-attention output,
    the final projection) are zero."""
    r = layers.SeededInit(seed, resolve_device(device), cfg.torch_dtype)
    D, L = cfg.dim, cfg.n_layers
    return {
        "patch_proj": r.dense(cfg.patch_dim, D, scale=0.02),
        "pos_emb": r.dense(cfg.n_patches, D, scale=0.02),
        "frame_emb": r.dense(cfg.frames, D, scale=0.02),
        "t_mlp1": r.dense(D, D),
        "t_mlp2": r.dense(D, D),
        "cond_emb": r.dense(2, D, scale=0.02),
        "text_proj": r.dense(cfg.text_dim, D, scale=0.02),
        "null_text": r.dense(cfg.text_len, cfg.text_dim, scale=0.02),
        "layers": {
            "mod_w": r.full(0.0, L, D, 9 * D), "mod_b": r.full(0.0, L, 9 * D),
            "s_wq": r.dense(L, D, D), "s_wk": r.dense(L, D, D), "s_wv": r.dense(L, D, D), "s_wo": r.dense(L, D, D),
            "t_wq": r.dense(L, D, D), "t_wk": r.dense(L, D, D), "t_wv": r.dense(L, D, D), "t_wo": r.dense(L, D, D),
            "xwq": r.dense(L, D, D), "xwk": r.dense(L, D, D), "xwv": r.dense(L, D, D),
            "xwo": r.full(0.0, L, D, D),
            "fc_w": r.dense(L, D, 4 * D), "fc_b": r.full(0.0, L, 4 * D),
            "proj_w": r.dense(L, 4 * D, D), "proj_b": r.full(0.0, L, D),
        },
        "final_mod_w": r.full(0.0, D, 2 * D),
        "final_mod_b": r.full(0.0, 2 * D),
        "final_proj": r.full(0.0, D, cfg.patch_dim),
    }


def params_from_jax(np_params: dict, cfg: VideoDiTConfig, device=None) -> dict:
    """The JAX tree (numpy leaves) as this module's tree, layouts unchanged."""
    return layers.from_numpy_tree(np_params, cfg.torch_dtype, resolve_device(device))


def patchify(x, cfg: VideoDiTConfig):
    """[B, T, H, W, C] -> [B, T, n_patches, patch_dim]."""
    B, T, H, W, C = x.shape
    p = cfg.patch
    x = x.reshape(B, T, H // p, p, W // p, p, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, T, (H // p) * (W // p), p * p * C)


def unpatchify(x, cfg: VideoDiTConfig):
    B, T = x.shape[:2]
    p, C = cfg.patch, cfg.channels
    hw = cfg.img_size // p
    x = x.reshape(B, T, hw, hw, p, p, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, T, cfg.img_size, cfg.img_size, C)


def _mha(q, k, v, n_heads: int):
    """The reference's attention over [B, S, D] projections (no mask)."""
    B, Sq, D = q.shape
    Sk, hd = k.shape[1], D // n_heads
    o = reference.attention(q.reshape(B, Sq, n_heads, hd).transpose(1, 2), k.reshape(B, Sk, n_heads, hd).transpose(1, 2),
                            v.reshape(B, Sk, n_heads, hd).transpose(1, 2), causal=False)
    return o.transpose(1, 2).reshape(B, Sq, D)


def _norm(v, eps: float):
    mu = v.mean(dim=-1, keepdim=True)
    var = (v - mu).square().mean(dim=-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + eps)


def forward(params: dict, x_t, t, cond_mask, text_states, cfg: VideoDiTConfig):
    """x_t [B, T, S, S, C] noised latents (frame 0 may be clean), t [B] flow
    time in [0, 1], cond_mask [B, T] 1.0 where a frame is pinned,
    text_states [B, S_text, text_dim] -> the predicted velocity like x_t."""
    if cfg.torch_dtype == torch.float32:
        layers.check_exact_f32_matmuls(x_t.device)
    B, T = x_t.shape[:2]
    N, D, eps = cfg.n_patches, cfg.dim, cfg.norm_eps
    h = patchify(x_t, cfg) @ params["patch_proj"]  # [B, T, N, D]
    h = h + params["pos_emb"][None, None] + params["frame_emb"][None, :, None]
    temb = timestep_embedding(t, D).to(h.dtype)
    temb = F.silu(temb @ params["t_mlp1"]) @ params["t_mlp2"]
    text = text_states @ params["text_proj"]  # [B, S_text, D]
    cemb = params["cond_emb"][cond_mask.to(torch.int64)]  # [B, T, D]: the pinned frames' row
    cond = temb[:, None] + text.mean(dim=1)[:, None] + cemb  # [B, T, D]

    def modulate(v, shift, scale):
        return v * (1 + scale[:, :, None]) + shift[:, :, None]

    stacked = params["layers"]
    for i in range(cfg.n_layers):
        l = {k: w[i] for k, w in stacked.items()}
        s1, sc1, g1, s2, sc2, g2, s3, sc3, g3 = (F.silu(cond) @ l["mod_w"] + l["mod_b"]).chunk(9, dim=-1)
        # spatial attention: tokens within a frame, frames batched
        a = modulate(_norm(h, eps), s1, sc1).reshape(B * T, N, D)
        a = _mha(a @ l["s_wq"], a @ l["s_wk"], a @ l["s_wv"], cfg.n_heads).reshape(B, T, N, D) @ l["s_wo"]
        h = h + g1[:, :, None] * a
        # temporal attention: one patch position across frames, positions batched
        a = modulate(_norm(h, eps), s2, sc2).transpose(1, 2).reshape(B * N, T, D)
        a = _mha(a @ l["t_wq"], a @ l["t_wk"], a @ l["t_wv"], cfg.n_heads)
        h = h + g2[:, :, None] * (a.reshape(B, N, T, D).transpose(1, 2) @ l["t_wo"])
        # cross-attention to the text over the flattened space-time tokens
        xq = _norm(h, eps).reshape(B, T * N, D) @ l["xwq"]
        h = h + _mha(xq, text @ l["xwk"], text @ l["xwv"], cfg.n_heads).reshape(B, T, N, D) @ l["xwo"]
        m = modulate(_norm(h, eps), s3, sc3)
        m = F.gelu(m @ l["fc_w"] + l["fc_b"], approximate="tanh") @ l["proj_w"] + l["proj_b"]
        h = h + g3[:, :, None] * m
    shift, scale = (F.silu(cond) @ params["final_mod_w"] + params["final_mod_b"]).chunk(2, dim=-1)
    h = modulate(_norm(h, eps), shift, scale) @ params["final_proj"]
    return unpatchify(h, cfg)


def flow_loss(params: dict, video, text_states, cfg: VideoDiTConfig, *, null_prob: float = 0.1,
              first_frame_prob: float = 0.7, generator: torch.Generator | None = None, t=None, eps=None, pin=None,
              drop=None):
    """Rectified-flow loss with first-frame conditioning: where ``pin`` [B]
    (drawn with probability ``first_frame_prob``) is set, frame 0 is shown
    clean (cond_mask 1) and left out of the loss; ``drop`` [B] (probability
    ``null_prob``) swaps the text for the null embedding. ``t`` [B] uniform,
    ``eps`` like ``video``, ``pin`` and ``drop`` come from ``generator``
    unless given. video [B, T, S, S, C] clean latents -> the scalar loss."""
    B, T = video.shape[:2]
    dev = video.device
    if t is None:
        t = torch.rand((B,), generator=generator, device=dev)
    if eps is None:
        eps = torch.randn(video.shape, generator=generator, device=dev)
    if pin is None:
        pin = torch.rand((B,), generator=generator, device=dev) < first_frame_prob
    if drop is None:
        drop = torch.rand((B,), generator=generator, device=dev) < null_prob
    t, eps = t.to(device=dev, dtype=torch.float32), eps.to(device=dev, dtype=torch.float32)
    pin, drop = pin.to(dev).bool(), drop.to(dev).bool()
    tb = t[:, None, None, None, None]
    x_t = (1 - tb) * video + tb * eps
    target_v = eps - video
    cond_mask = torch.zeros((B, T), device=dev)
    cond_mask[:, 0] = pin.float()
    x_t = torch.cat([torch.where(pin[:, None, None, None], video[:, 0], x_t[:, 0])[:, None], x_t[:, 1:]], dim=1)
    null = _null_text(params, text_states.shape)
    text_in = torch.where(drop[:, None, None], null, text_states)
    pred = forward(params, x_t, t, cond_mask, text_in, cfg)
    w = 1.0 - cond_mask[:, :, None, None, None]  # pinned frames carry no loss
    return (w * (pred - target_v) ** 2).sum() / (w.sum() * video[0, 0].numel()).clamp(min=1.0)


@torch.no_grad()
def sample(params: dict, text_states, cfg: VideoDiTConfig, *, first_frame=None, steps: int = 8,
           guidance: float = 3.0, generator: torch.Generator | None = None, noise=None):
    """Euler flow sampling from noise (t = 1) to data (t = 0) with
    classifier-free guidance; with ``first_frame`` [B, S, S, C] frame 0 is
    held at it before and after every step (the two-stage text -> image ->
    video chain). The starting noise is ``noise`` or drawn from
    ``generator``. Returns [B, T, S, S, C]."""
    B, dev = text_states.shape[0], text_states.device
    x = _initial_noise((B, cfg.frames, cfg.img_size, cfg.img_size, cfg.channels), dev, generator, noise)
    cond_mask = torch.zeros((B, cfg.frames), device=dev)
    if first_frame is not None:
        first_frame = first_frame.to(device=dev, dtype=x.dtype)
        x[:, 0] = first_frame
        cond_mask[:, 0] = 1.0
    null = _null_text(params, text_states.shape)
    ts = torch.linspace(1.0, 0.0, steps + 1, device=dev)
    for i in range(steps):
        tb = ts[i].expand(B)
        v_cond = forward(params, x, tb, cond_mask, text_states, cfg)
        v_null = forward(params, x, tb, cond_mask, null, cfg)
        x = x + (ts[i + 1] - ts[i]) * (v_null + guidance * (v_cond - v_null))
        if first_frame is not None:
            x[:, 0] = first_frame  # re-pinned after the step
    return x
