"""The 3xTF32 split of the f32 flash kernels on the tensor cores
(``csrc/flash_fwd_f32.cu``, ``csrc/flash_bwd_dq_f32.cu``,
``csrc/flash_bwd_dkv_f32.cu``), emulated in torch on the CPU and held against the JAX package's Pallas kernels (in
interpret mode, as ``tests/test_torch_gpt.py`` runs them).

The emulation does the kernels' arithmetic: each f32 operand x is split
into big = rna(x), x rounded to TF32 (10 mantissa bits, nearest, ties away
from zero, as ``cvt.rna.tf32.f32``), and small = rna(x - big); a product
takes, per depth step of 8, small.big, then big.small, then big.big,
summed in f32 (a TF32 product of two such parts is exact in f32). The
scores are scaled by sm_scale*log2(e) and exponentiated with exp2, lse =
(m + log2(l))*ln(2), and the backward's P^T and dS^T come from K.Q^T and
V.dO^T with the forward's lse and delta = rowsum(dO*O); the softmax is
taken whole where the kernel takes it tile by tile (they differ by f32
rounding). dQ takes P and dS from S = Q.K^T and dP = dO.V^T, then dS.K,
every one of the three products in three passes. Forward (o, lse), dQ and
dK/dV (dS^T.Q and P^T.dO summed over each kv head's query heads) must
agree with the Pallas kernels within ``chip_smoke.F32_TOL`` of the largest
value, and one TF32 pass (big.big alone: the "one TF32 pass" fault of
``chip_smoke.F32_FAULTS``) on the same inputs must not, in each of o, dQ
and dK/dV.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from test_torch_time_limit import share_cores

share_cores()

jfa = importlib.import_module("modal_examples_tpu.ops.flash_attention")

# (B, Hq, Hkv, S, D, causal, nonzero dlse)
CASES = [
    (1, 2, 2, 128, 64, True, False),    # GPT's head dim
    (1, 2, 2, 64, 32, True, False),     # GPT's tiny head dim
    (1, 2, 2, 64, 128, True, True),     # D = 128 with an lse cotangent
    (1, 4, 2, 96, 64, True, False),     # GQA, S ragged against 64-row tiles
    (1, 2, 2, 80, 64, False, True),     # full attention, ragged, an lse cotangent
    (1, 4, 1, 72, 128, False, False),   # GQA 4:1, full, ragged, D = 128
]


def rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 kept in f32: the low 13 mantissa bits rounded away to
    nearest, ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = rna(x)
    return big, rna(x - big)


def mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b over the last/first-but-batch dims as the kernels take it: per
    8-deep step, small.big, big.small, big.big (``passes`` 1: big.big)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    out = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        sl = slice(k0, k0 + 8)
        if passes == 3:
            out = out + as_[..., sl] @ bb[..., sl, :]
            out = out + ab[..., sl] @ bs[..., sl, :]
        out = out + ab[..., sl] @ bb[..., sl, :]
    return out


def mask(S: int, causal: bool) -> torch.Tensor:
    """[S(query), S(key)] True where a key is visible."""
    rows, cols = torch.arange(S)[:, None], torch.arange(S)[None, :]
    return rows >= cols if causal else torch.ones(S, S, dtype=torch.bool)


def emulated_forward(q, k, v, causal: bool, scale: float, passes: int):
    G = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    s = mm(q, kr.transpose(-1, -2), passes) * (scale * math.log2(math.e))
    s = s.masked_fill(~mask(q.shape[2], causal), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = mm(p, vr, passes) * (1.0 / l)
    lse = (m + torch.log2(l))[..., 0] * math.log(2.0)
    return o, lse


def emulated_dkv(q, k, v, do, lse, delta, dlse, causal: bool, scale: float, passes: int):
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    kr, vr = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    st = mm(kr, q.transpose(-1, -2), passes)      # [B, Hq, key, query]
    dpt = mm(vr, do.transpose(-1, -2), passes)
    lse2 = (lse * math.log2(math.e))[:, :, None, :]
    pt = torch.exp2(st * (scale * math.log2(math.e)) - lse2)
    pt = torch.where(mask(S, causal).T & torch.isfinite(lse2), pt, torch.zeros_like(pt))
    dst = pt * (dpt + (dlse - delta)[:, :, None, :])
    dv = mm(pt, do, passes).reshape(B, Hkv, G, S, D).sum(dim=2)
    dk = (mm(dst, q, passes) * scale).reshape(B, Hkv, G, S, D).sum(dim=2)
    return dk, dv


def emulated_dq(q, k, v, do, lse, delta, dlse, causal: bool, scale: float, passes: int):
    G = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    s = mm(q, kr.transpose(-1, -2), passes)       # [B, Hq, query, key]
    dp = mm(do, vr.transpose(-1, -2), passes)
    lse2 = (lse * math.log2(math.e))[..., None]
    p = torch.exp2(s * (scale * math.log2(math.e)) - lse2)
    p = torch.where(mask(q.shape[2], causal) & torch.isfinite(lse2), p, torch.zeros_like(p))
    ds = p * (dp + (dlse - delta)[..., None])
    return mm(ds, kr, passes) * scale


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}-Hq{}-Hkv{}-S{}-D{}-causal{}-dlse{}".format(*c))
def test_3xtf32_split_matches_the_pallas_kernels_and_one_pass_does_not(case):
    B, Hq, Hkv, S, D, causal, nz = case
    rng = np.random.default_rng(25)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    do = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    dlse = rng.standard_normal((B, Hq, S)).astype(np.float32) if nz else np.zeros((B, Hq, S), np.float32)
    (want_o, want_lse), vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_with_lse(q, k, v, causal=causal),
                                      *map(jnp.asarray, (q, k, v)))
    want_dq, want_dk, want_dv = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv, tdo, tdlse = map(torch.from_numpy, (q, k, v, do, dlse))
    scale = D**-0.5
    errs = {}
    for passes in (3, 1):
        o, lse = emulated_forward(tq, tk, tv, causal, scale, passes)
        delta = (tdo * o).sum(dim=-1)
        dq = emulated_dq(tq, tk, tv, tdo, lse, delta, tdlse, causal, scale, passes)
        dk, dv = emulated_dkv(tq, tk, tv, tdo, lse, delta, tdlse, causal, scale, passes)
        errs[passes] = {"o": rel(o, want_o), "lse": rel(lse, want_lse), "dq": rel(dq, want_dq),
                        "dk": rel(dk, want_dk), "dv": rel(dv, want_dv)}
    assert all(e <= cs.F32_TOL for e in errs[3].values()), errs
    assert max(errs[1].values()) > cs.F32_TOL, errs
    assert errs[1]["o"] > cs.F32_TOL and max(errs[1]["dk"], errs[1]["dv"]) > cs.F32_TOL, errs
    assert errs[1]["dq"] > cs.F32_TOL, errs
