"""Whisper-family encoder-decoder ASR.

Counterpart of ``modal_examples_tpu/models/whisper.py`` (``WhisperConfig``,
``init_params``, ``encode``, ``decode``, ``forward``, ``greedy_transcribe``,
``dtw_path``, ``align_tokens``, ``words_with_times``, ``load_hf_weights``).
Audio encoder: two erf-GELU convolutions (stride 1, then 2, explicit
padding (1, 1)) over the log-mel frames, sinusoidal positions, a pre-LN
transformer (no bias on the key projection). Text decoder: learned
positions, causal self-attention, cross-attention to the audio states, the
output head tied to the token embedding.

Parameters keep the JAX tree (per-layer leaves stacked on axis 0, linear
weights [in, out]) except the two convolutions, which are stored in
PyTorch's ``[out, in, k]`` (the JAX tree's ``[k, in, out]`` transposed by
:func:`params_from_jax`; HF checkpoints already hold it). The attentions
are the plain products, as in the reference (XLA einsums there); f32
convolutions run without TF32 (:func:`layers.exact_f32_convs`).

Greedy decoding is the reference's fixed-length loop: every position
re-runs the whole decoder over the token buffer, finished rows pinned to
EOS.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import reference
from ..utils.device import resolve_device
from ..utils.safetensors import SafeFile
from . import layers


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_audio_ctx: int = 1500  # encoder frames after stride-2 conv
    n_text_ctx: int = 448
    vocab_size: int = 51865
    dim: int = 512
    n_heads: int = 8
    n_audio_layers: int = 6
    n_text_layers: int = 6
    norm_eps: float = 1e-5
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def base() -> "WhisperConfig":
        return WhisperConfig()

    @staticmethod
    def tiny_en() -> "WhisperConfig":
        return WhisperConfig(dim=384, n_heads=6, n_audio_layers=4, n_text_layers=4)

    @staticmethod
    def test_tiny() -> "WhisperConfig":
        return WhisperConfig(
            n_mels=80, n_audio_ctx=100, n_text_ctx=32, vocab_size=300,
            dim=64, n_heads=2, n_audio_layers=2, n_text_layers=2,
        )


def _sinusoids(length: int, channels: int, device) -> torch.Tensor:
    """Fixed sinusoidal position table [length, channels] (f32)."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def init_params(cfg: WhisperConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights drawn on the device in the model dtype from ``seed``,
    at the JAX init's scales: linears fan_in**-0.5, convolutions,
    embeddings and positions 0.02; biases zero, norms one."""
    r = layers.SeededInit(seed, resolve_device(device), cfg.torch_dtype)
    D, F_ = cfg.dim, 4 * cfg.dim

    def stack(L, cross: bool):
        p = {
            "ln1_w": r.full(1.0, L, D), "ln1_b": r.full(0.0, L, D),
            "wq": r.dense(L, D, D), "bq": r.full(0.0, L, D),
            "wk": r.dense(L, D, D),
            "wv": r.dense(L, D, D), "bv": r.full(0.0, L, D),
            "wo": r.dense(L, D, D), "bo": r.full(0.0, L, D),
            "ln2_w": r.full(1.0, L, D), "ln2_b": r.full(0.0, L, D),
            "fc_w": r.dense(L, D, F_), "fc_b": r.full(0.0, L, F_),
            "proj_w": r.dense(L, F_, D), "proj_b": r.full(0.0, L, D),
        }
        if cross:
            p.update({
                "xln_w": r.full(1.0, L, D), "xln_b": r.full(0.0, L, D),
                "xwq": r.dense(L, D, D), "xbq": r.full(0.0, L, D),
                "xwk": r.dense(L, D, D),
                "xwv": r.dense(L, D, D), "xbv": r.full(0.0, L, D),
                "xwo": r.dense(L, D, D), "xbo": r.full(0.0, L, D),
            })
        return p

    return {
        "conv1_w": r.dense(D, cfg.n_mels, 3, scale=0.02),  # [out, in, k]
        "conv1_b": r.full(0.0, D),
        "conv2_w": r.dense(D, D, 3, scale=0.02),
        "conv2_b": r.full(0.0, D),
        "enc": stack(cfg.n_audio_layers, cross=False),
        "enc_ln_w": r.full(1.0, D),
        "enc_ln_b": r.full(0.0, D),
        "tok_emb": r.dense(cfg.vocab_size, D, scale=0.02),
        "pos_emb": r.dense(cfg.n_text_ctx, D, scale=0.02),
        "dec": stack(cfg.n_text_layers, cross=True),
        "dec_ln_w": r.full(1.0, D),
        "dec_ln_b": r.full(0.0, D),
    }


def params_from_jax(np_params: dict, cfg: WhisperConfig, device=None) -> dict:
    """The JAX tree (numpy leaves) as this module's tree: the convolutions'
    ``[k, in, out]`` transposed to ``[out, in, k]``, every other layout kept."""
    out = layers.from_numpy_tree(np_params, cfg.torch_dtype, resolve_device(device))
    for k in ("conv1_w", "conv2_w"):
        out[k] = out[k].permute(2, 1, 0).contiguous()
    return out


def _heads(x, n_heads: int):
    B, S, D = x.shape
    return x.reshape(B, S, n_heads, D // n_heads).transpose(1, 2)


def _merge(o):
    B, H, S, hd = o.shape
    return o.transpose(1, 2).reshape(B, S, H * hd)


def encode(params: dict, mel, cfg: WhisperConfig):
    """log-mel [B, T, n_mels] -> audio states [B, T//2, D]."""
    x = mel.to(cfg.torch_dtype).transpose(1, 2)  # [B, n_mels, T]
    with layers.exact_f32_convs():
        # explicit (1, 1) padding, as the reference insists: "SAME" on the
        # stride-2 convolution would shift every window by one frame
        x = F.gelu(F.conv1d(x, params["conv1_w"], params["conv1_b"], stride=1, padding=1), approximate="none")
        x = F.gelu(F.conv1d(x, params["conv2_w"], params["conv2_b"], stride=2, padding=1), approximate="none")
    x = x.transpose(1, 2)
    x = x + _sinusoids(x.shape[1], cfg.dim, x.device).to(x.dtype)[None]
    enc = params["enc"]
    for i in range(cfg.n_audio_layers):
        l = {k: v[i] for k, v in enc.items()}
        h = layers.layer_norm(x, l["ln1_w"], l["ln1_b"], cfg.norm_eps)
        q = h @ l["wq"] + l["bq"]
        k = h @ l["wk"]  # whisper: no bias on key
        v = h @ l["wv"] + l["bv"]
        o = reference.attention(*(_heads(t, cfg.n_heads) for t in (q, k, v)), causal=False)
        x = x + _merge(o) @ l["wo"] + l["bo"]
        h = layers.layer_norm(x, l["ln2_w"], l["ln2_b"], cfg.norm_eps)
        x = x + layers.gelu_mlp(l, h, exact=True)  # whisper uses erf-GELU
    return layers.layer_norm(x, params["enc_ln_w"], params["enc_ln_b"], cfg.norm_eps)


def decode(params: dict, tokens, audio_states, cfg: WhisperConfig, *, return_cross_attn: bool = False):
    """Teacher-forced decoder: tokens [B, S] over audio states [B, Ta, D] ->
    f32 logits [B, S, vocab]; with ``return_cross_attn`` also the per-layer
    head-mean cross-attention [L, B, S, Ta] (f32), reduced layer by layer."""
    B, S = tokens.shape
    x = params["tok_emb"][tokens] + params["pos_emb"][:S][None]
    H, hd = cfg.n_heads, cfg.head_dim
    dec = params["dec"]
    attn = []
    for i in range(cfg.n_text_layers):
        l = {k: v[i] for k, v in dec.items()}
        h = layers.layer_norm(x, l["ln1_w"], l["ln1_b"], cfg.norm_eps)
        q = h @ l["wq"] + l["bq"]
        k = h @ l["wk"]
        v = h @ l["wv"] + l["bv"]
        o = reference.attention(*(_heads(t, H) for t in (q, k, v)), causal=True)
        x = x + _merge(o) @ l["wo"] + l["bo"]
        h = layers.layer_norm(x, l["xln_w"], l["xln_b"], cfg.norm_eps)
        qh = _heads(h @ l["xwq"] + l["xbq"], H)
        kh = _heads(audio_states @ l["xwk"], H)
        vh = _heads(audio_states @ l["xwv"] + l["xbv"], H)
        s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * hd**-0.5
        p = torch.softmax(s, dim=-1)  # [B, H, S, Ta] f32
        o = torch.einsum("bhqk,bhkd->bhqd", p.to(vh.dtype), vh)
        x = x + _merge(o) @ l["xwo"] + l["xbo"]
        h = layers.layer_norm(x, l["ln2_w"], l["ln2_b"], cfg.norm_eps)
        x = x + layers.gelu_mlp(l, h, exact=True)
        if return_cross_attn:
            attn.append(p.mean(dim=1))
    x = layers.layer_norm(x, params["dec_ln_w"], params["dec_ln_b"], cfg.norm_eps)
    logits = layers.mm(x, params["tok_emb"].T)
    if return_cross_attn:
        return logits, torch.stack(attn)
    return logits


def forward(params: dict, mel, tokens, cfg: WhisperConfig):
    """Teacher-forced forward: logits [B, S, vocab]."""
    return decode(params, tokens, encode(params, mel, cfg), cfg)


def greedy_transcribe(params: dict, mel, cfg: WhisperConfig, *, bos_id: int, eos_id: int,
                      max_tokens: int | None = None):
    """Greedy decode of mel [B, T, n_mels] -> tokens [B, max_tokens - 1]
    (int32, EOS-padded; BOS stripped). Every position re-runs the decoder
    over the whole buffer, as the reference's fixed-length scan does; the
    loop reads nothing back to the host."""
    B = mel.shape[0]
    S = max_tokens or cfg.n_text_ctx
    audio_states = encode(params, mel, cfg)
    buf = torch.full((B, S), eos_id, dtype=torch.int32, device=mel.device)
    buf[:, 0] = bos_id
    done = torch.zeros(B, dtype=torch.bool, device=mel.device)
    eos = torch.full((B,), eos_id, dtype=torch.int32, device=mel.device)
    for pos in range(1, S):
        logits = decode(params, buf, audio_states, cfg)
        nxt = torch.where(done, eos, logits[:, pos - 1].argmax(dim=-1).to(torch.int32))
        buf[:, pos] = nxt
        done = done | (nxt == eos_id)
    return buf[:, 1:]


# -- word-level timestamp alignment ------------------------------------------
# The decoder's cross-attention concentrates on the frames a token was read
# from, so a monotonic DTW path through the token x frame attention matrix
# gives each token a frame span (openai/whisper's word_timestamps design).


def dtw_path(cost) -> np.ndarray:  # [S] -> frame index per row
    """Monotonic DTW through a [S, T] cost matrix (lower = better match);
    returns, per token row, the last audio frame on the optimal path (the
    token's end frame). Plain numpy."""
    S, T = cost.shape
    D = np.full((S + 1, T + 1), np.inf, np.float64)
    D[0, 0] = 0.0  # path runs corner to corner: the tokens cover the audio
    step = np.zeros((S + 1, T + 1), np.int8)
    for i in range(1, S + 1):
        for j in range(1, T + 1):
            # moves: down (next token, same frame), diagonal, right (same
            # token, next frame)
            opts = (D[i - 1, j], D[i - 1, j - 1], D[i, j - 1])
            a = int(np.argmin(opts))
            D[i, j] = cost[i - 1, j - 1] + opts[a]
            step[i, j] = a
    ends = np.zeros((S,), np.int64)
    i, j = S, T  # backtrack from the corner
    while i > 0:
        ends[i - 1] = max(ends[i - 1], j - 1)
        a = step[i, j]
        if a == 0:
            i -= 1
        elif a == 1:
            i -= 1
            j -= 1
        else:
            j -= 1
    return ends


@torch.no_grad()
def align_tokens(params: dict, mel, tokens, cfg: WhisperConfig, *, frame_seconds: float = 0.02,
                 bos_id: int | None = None) -> np.ndarray:
    """Per-token (start_s, end_s) via cross-attention DTW: ``times`` [B, S, 2]
    float32 seconds, row i for ``tokens[:, i]``. Token i is aligned by the
    attention at the position that predicted it; ``tokens`` start with BOS,
    or pass ``bos_id=`` for sequences without it (as ``greedy_transcribe``
    returns them) and it is prepended, every returned row still matching
    the input. The signal is the head mean of the top half of the decoder
    layers; adjacent spans touch (end_k == start_{k+1})."""
    stripped = bos_id is not None
    if stripped:
        bos = torch.full((tokens.shape[0], 1), bos_id, dtype=tokens.dtype, device=tokens.device)
        tokens = torch.cat([bos, tokens], dim=1)
    _, attn = decode(params, tokens, encode(params, mel, cfg), cfg, return_cross_attn=True)
    L = attn.shape[0]
    w = attn[L // 2:].mean(dim=0).cpu().numpy().astype(np.float64)  # [B, S, Ta]
    B, S, _ = w.shape
    times = np.zeros((B, S, 2), np.float32)
    for b in range(B):
        # rows 0..S-2 predicted tokens 1..S-1; normalize, cost = -log p
        rows = w[b, :-1]
        rows = rows / np.maximum(rows.sum(-1, keepdims=True), 1e-9)
        ends = dtw_path(-np.log(np.maximum(rows, 1e-9)))
        starts = np.concatenate([[0], ends[:-1] + 1])  # touching boundaries
        times[b, 1:, 0] = starts * frame_seconds
        times[b, 1:, 1] = (ends + 1) * frame_seconds
        times[b, 0] = 0.0  # BOS carries no audio span
    return times[:, 1:] if stripped else times


def words_with_times(token_ids, times, decode_fn, *, space_ids=(32,), eos_ids=()) -> list[dict]:
    """Group one sequence's token times into ``[{"word", "start", "end"}]``.
    ``decode_fn(ids) -> str`` is the tokenizer, ``space_ids`` mark word
    boundaries, and processing stops at the first id in ``eos_ids``."""
    words: list[dict] = []
    cur: list[int] = []
    t0 = None
    last = len(token_ids)
    for i, tok in enumerate(token_ids):
        tok = int(tok)
        if tok in eos_ids:
            last = i
            break
        if tok in space_ids:
            if cur:
                words.append({"word": decode_fn(cur), "start": float(t0), "end": float(times[i - 1][1])})
                cur, t0 = [], None
            continue
        if t0 is None:
            t0 = times[i][0]
        cur.append(tok)
    if cur:
        words.append({"word": decode_fn(cur), "start": float(t0), "end": float(times[last - 1][1])})
    return words


def load_hf_weights(model_dir, cfg: WhisperConfig, dtype=None, device=None) -> dict:
    """An HF openai/whisper-* safetensors checkpoint (every ``*.safetensors``
    of ``model_dir``, names with or without the ``model.`` prefix) as this
    module's tree, read through the port's safetensors reader: linears
    transposed to [in, out], layers stacked, the convolutions kept in
    PyTorch's [out, in, k]; every leaf in ``dtype`` (default ``cfg.dtype``)
    on ``device``. Tensors are dropped from the host as they are converted."""
    device = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    files = sorted(Path(model_dir).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors under {model_dir}")
    raw: dict[str, torch.Tensor] = {}
    for f in files:
        with SafeFile(f) as sf:
            for name in sf.keys():
                raw[name.removeprefix("model.")] = sf.get_tensor(name)

    def g(name):
        return raw.pop(name).to(device=device, dtype=dt).contiguous()

    def stack(side: str, fmt: str, L: int, transpose=False):
        mats = [raw.pop(f"{side}.layers.{i}.{fmt}") for i in range(L)]
        return torch.stack([m.T if transpose else m for m in mats]).to(device=device, dtype=dt).contiguous()

    def block(side: str, L: int, cross: bool) -> dict:
        p = {
            "ln1_w": stack(side, "self_attn_layer_norm.weight", L),
            "ln1_b": stack(side, "self_attn_layer_norm.bias", L),
            "wq": stack(side, "self_attn.q_proj.weight", L, True),
            "bq": stack(side, "self_attn.q_proj.bias", L),
            "wk": stack(side, "self_attn.k_proj.weight", L, True),
            "wv": stack(side, "self_attn.v_proj.weight", L, True),
            "bv": stack(side, "self_attn.v_proj.bias", L),
            "wo": stack(side, "self_attn.out_proj.weight", L, True),
            "bo": stack(side, "self_attn.out_proj.bias", L),
            "ln2_w": stack(side, "final_layer_norm.weight", L),
            "ln2_b": stack(side, "final_layer_norm.bias", L),
            "fc_w": stack(side, "fc1.weight", L, True),
            "fc_b": stack(side, "fc1.bias", L),
            "proj_w": stack(side, "fc2.weight", L, True),
            "proj_b": stack(side, "fc2.bias", L),
        }
        if cross:
            p.update({
                "xln_w": stack(side, "encoder_attn_layer_norm.weight", L),
                "xln_b": stack(side, "encoder_attn_layer_norm.bias", L),
                "xwq": stack(side, "encoder_attn.q_proj.weight", L, True),
                "xbq": stack(side, "encoder_attn.q_proj.bias", L),
                "xwk": stack(side, "encoder_attn.k_proj.weight", L, True),
                "xwv": stack(side, "encoder_attn.v_proj.weight", L, True),
                "xbv": stack(side, "encoder_attn.v_proj.bias", L),
                "xwo": stack(side, "encoder_attn.out_proj.weight", L, True),
                "xbo": stack(side, "encoder_attn.out_proj.bias", L),
            })
        return p

    return {
        "conv1_w": g("encoder.conv1.weight"),  # [out, in, k], as stored
        "conv1_b": g("encoder.conv1.bias"),
        "conv2_w": g("encoder.conv2.weight"),
        "conv2_b": g("encoder.conv2.bias"),
        "enc": block("encoder", cfg.n_audio_layers, cross=False),
        "enc_ln_w": g("encoder.layer_norm.weight"),
        "enc_ln_b": g("encoder.layer_norm.bias"),
        "tok_emb": g("decoder.embed_tokens.weight"),
        "pos_emb": g("decoder.embed_positions.weight"),
        "dec": block("decoder", cfg.n_text_layers, cross=True),
        "dec_ln_w": g("decoder.layer_norm.weight"),
        "dec_ln_b": g("decoder.layer_norm.bias"),
    }
