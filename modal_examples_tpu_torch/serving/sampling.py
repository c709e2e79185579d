"""Token sampling, with JAX's threefry PRNG reproduced bit for bit.

Counterpart of ``modal_examples_tpu/serving/sampling.py``: ``SamplingParams``,
``seeded_row_keys`` and ``sample``. A seeded row's key is
``fold_in(fold_in(PRNGKey(0), seed), position)``, a function of the request's
seed and its decode position only. That (seed, position) contract is what
makes a request's tokens independent of batch composition and dispatch
shape, so this module reproduces JAX's keys and its categorical draw exactly:
threefry2x32 in integer tensors, the partitionable (``jax_threefry_
partitionable=True``) derivation of ``split`` and ``random_bits``, and the
uniform -> gumbel -> argmax path of ``jax.random.categorical``.

A key is an int64 tensor [..., 2] holding two uint32 words.
"""

from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    max_tokens: int = 128
    stop: tuple[str, ...] = ()
    seed: int | None = None  # per-request determinism (OpenAI `seed`)


# -- threefry2x32 ---------------------------------------------------------------


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) on int64 tensors of uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = ((b << r) | (b >> (32 - r))) & _M32
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def prng_key(seed: int, device=None):
    """``jax.random.PRNGKey(seed)`` for a non-negative 32-bit seed."""
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64, device=device)


def fold_in(keys, data):
    """``jax.random.fold_in`` row-wise: keys [..., 2], data [...] (ints, taken mod 2**32)."""
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & _M32
    a, b = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack([a, b], dim=-1)


def split(key, num: int):
    """``jax.random.split(key, num)`` -> [num, 2] (partitionable derivation)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([a, b], dim=-1)


def random_bits32(keys, n: int):
    """``jax.random.bits(key, (n,), uint32)`` for each key of keys [R, 2] -> [R, n]."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    a, b = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return a ^ b


def gumbel(keys, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") per key -> [R, n]."""
    bits = random_bits32(keys, n)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    u = (mant - 1.0) + _F32_TINY  # floats * (1 - tiny) + tiny; 1 - tiny == 1 in f32
    u = torch.clamp(u, min=_F32_TINY)
    return -torch.log(-torch.log(u))


# -- sampling -------------------------------------------------------------------


def seeded_row_keys(key, seeds, step_ids):
    """Per-row keys [B, 2]: ``fold_in(fold_in(PRNGKey(0), seed), step_id)`` for
    rows with ``seeds >= 0``, else row i of ``split(key, B)``."""
    B = seeds.shape[0]
    base = split(key, B)
    zero = torch.zeros((B, 2), dtype=torch.int64, device=key.device)
    seeded = fold_in(fold_in(zero, seeds), step_ids)
    return torch.where((seeds >= 0)[:, None], seeded, base)


def _mask_topk_topp(scaled, top_p, top_k):
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = torch.clamp(torch.where(top_k > 0, top_k, torch.full_like(top_k, V)) - 1, 0, V - 1)
    kth = torch.gather(sorted_desc, 1, k_idx.long()[:, None])
    scaled = torch.where(scaled >= kth, scaled, torch.full_like(scaled, float("-inf")))
    # nucleus: the smallest prefix of the sorted distribution with mass >= top_p
    sort_idx = torch.flip(torch.argsort(scaled, dim=-1, stable=True), dims=[-1])
    sorted_scaled = torch.gather(scaled, 1, sort_idx)
    probs = torch.softmax(sorted_scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p[:, None]
    keep_sorted[:, 0] = True
    keep = torch.zeros_like(keep_sorted).scatter(1, sort_idx, keep_sorted)
    return torch.where(keep, scaled, torch.full_like(scaled, float("-inf")))


def sample(logits, key, temperature, top_p, top_k, seeds=None, step_ids=None, *, needs_filter: bool | None = None):
    """Per-row sampling of logits [B, V] (f32); temperature 0 is greedy.
    Returns int32 tokens [B]. Rows with ``seeds >= 0`` draw with their
    (seed, step_id) key; the others with splits of ``key``. ``needs_filter``
    (whether any row has top_p < 1 or top_k > 0) lets a caller that knows it
    on the host skip the device read; None computes it from the tensors."""
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    if needs_filter is None:
        needs_filter = bool(((top_p < 1.0) | (top_k > 0)).any())
    if needs_filter:
        scaled = _mask_topk_topp(scaled, top_p, top_k)
    if seeds is not None:
        if step_ids is None:
            step_ids = torch.zeros_like(seeds)
        noise = gumbel(seeded_row_keys(key, seeds, step_ids), V)
    else:
        noise = gumbel(key[None], B * V).reshape(B, V)
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
