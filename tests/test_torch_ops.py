"""The port's attention and paged-cache ops against the JAX package's.

Inputs are made with numpy from a seed and go through both; the JAX
functions run as their own CPU tests run them (Pallas in interpret mode).
The port's CPU path is each kernel's plain version. Tolerances: 2e-5 in f32
(accumulation order differs), exact for the scatter (a copy).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modal_examples_tpu.ops import reference as jref
from modal_examples_tpu_torch.ops import flash_attention as tfa
from modal_examples_tpu_torch.ops import paged_attention as tpa
from modal_examples_tpu_torch.ops import reference as tref

# the JAX package's ops/__init__ re-exports functions under their modules' names
jfa = importlib.import_module("modal_examples_tpu.ops.flash_attention")
jpa = importlib.import_module("modal_examples_tpu.ops.paged_attention")

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,s", [(4, 2, 32), (4, 4, 40)])
def test_flash_attention_matches_jax(causal, hq, hkv, s):
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, 2, hq, s, 32), _rand(rng, 2, hkv, s, 32), _rand(rng, 2, hkv, s, 32)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    _close(out, ref)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_with_lse_matches_jax(causal):
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, 2, 4, 32, 32), _rand(rng, 2, 2, 32, 32), _rand(rng, 2, 2, 32, 32)
    o_ref, lse_ref = jfa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    o, lse = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    )
    _close(o, o_ref)
    _close(lse, lse_ref)
    # and the dense twins agree with the JAX reference module
    o2, lse2 = tref.attention_with_lse(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
    o2_ref, lse2_ref = jref.attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    _close(o2, o2_ref)
    _close(lse2, lse2_ref)


@pytest.mark.parametrize("q_offset", [0, 16, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_chunked_matches_jax(q_offset, causal):
    rng = np.random.default_rng(2 + q_offset)
    sq, skv = 16, q_offset + 16
    q, k, v = _rand(rng, 2, 4, sq, 32), _rand(rng, 2, 2, skv, 32), _rand(rng, 2, 2, skv, 32)
    ref = jfa.flash_attention_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=q_offset, causal=causal
    )
    out = tfa.flash_attention_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), q_offset=q_offset, causal=causal
    )
    _close(out, ref)
    if causal:
        twin = tref.attention_chunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), q_offset=q_offset)
        _close(twin, jref.attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=q_offset))


def test_flash_rejects_what_jax_rejects():
    q, k = torch.zeros(1, 3, 8, 16), torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, k, k)
    q, k = torch.zeros(1, 2, 16, 16), torch.zeros(1, 2, 24, 16)
    with pytest.raises(ValueError, match="exceeds"):
        tfa.flash_attention_chunked(q, k, k, q_offset=16)


def _paged_case(seed, hq=4, hkv=2, d=32, ps=16, layers=2):
    """Ragged prefix lengths 0, 1, ps-1, ps, ps+1 over shuffled pages."""
    rng = np.random.default_rng(seed)
    lens = np.array([0, 1, ps - 1, ps, ps + 1, 3 * ps + 5], np.int32)
    B, pps = len(lens), 4
    n_pages = 1 + B * pps
    tables = (rng.permutation(n_pages - 1)[: B * pps] + 1).reshape(B, pps).astype(np.int32)
    return dict(
        q=_rand(rng, B, hq, d),
        k_pages=_rand(rng, layers, n_pages, ps, hkv, d),
        v_pages=_rand(rng, layers, n_pages, ps, hkv, d),
        tables=tables,
        lens=lens,
        k_new=_rand(rng, B, hkv, d),
        v_new=_rand(rng, B, hkv, d),
    )


@pytest.mark.parametrize("layer", [0, 1])
def test_paged_decode_matches_inflight_reference(layer):
    c = _paged_case(3 + layer)
    ks = c["k_pages"][layer][c["tables"]]
    vs = c["v_pages"][layer][c["tables"]]
    ref = jpa.paged_decode_attention_inflight(
        jnp.asarray(c["q"]), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(c["lens"]),
        jnp.asarray(c["k_new"]), jnp.asarray(c["v_new"]),
    )
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    out = tpa.paged_decode_attention_ragged(
        t["q"], t["k_pages"], t["v_pages"], layer, t["tables"], t["lens"], t["k_new"], t["v_new"]
    )
    _close(out, ref)
    twin = tref.paged_decode_attention_inflight(
        t["q"], torch.from_numpy(ks), torch.from_numpy(vs), t["lens"], t["k_new"], t["v_new"]
    )
    _close(twin, ref)


def test_paged_decode_matches_flat_ragged_kernel_interpret():
    # hkv=16 so the JAX "flat" variant is legal; interpret mode on the CPU
    c = _paged_case(7, hq=16, hkv=16, d=32)
    ref = jpa.paged_decode_attention_ragged(
        jnp.asarray(c["q"]), jnp.asarray(c["k_pages"]), jnp.asarray(c["v_pages"]), jnp.int32(1),
        jnp.asarray(c["tables"]), jnp.asarray(c["lens"]), jnp.asarray(c["k_new"]), jnp.asarray(c["v_new"]),
        variant="flat",
    )
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    out = tpa.paged_decode_attention_ragged(
        t["q"], t["k_pages"], t["v_pages"], 1, t["tables"], t["lens"], t["k_new"], t["v_new"]
    )
    _close(out, ref)


def test_ragged_variant_label_matches_jax():
    for hkv in (1, 2, 8, 16, 32):
        assert tpa.ragged_variant_for(hkv) == jpa.ragged_variant_for(hkv)


def test_scatter_matches_jax_exactly():
    rng = np.random.default_rng(11)
    L, P, ps, hkv, d = 2, 9, 16, 2, 32
    k_pages, v_pages = _rand(rng, L, P, ps, hkv, d), _rand(rng, L, P, ps, hkv, d)
    k_all, v_all = _rand(rng, L, 6, hkv, d), _rand(rng, L, 6, hkv, d)
    page_idx = np.array([3, 0, 5, 8, 0, 1], np.int32)  # two dead slots on trash page 0
    slot = np.array([2, 0, 15, 0, 0, 7], np.int32)
    # dead slots race on page 0 slot 0 in both versions; equal rows make the
    # winner irrelevant so the whole cache can be compared exactly
    k_all[:, 4], v_all[:, 4] = k_all[:, 1], v_all[:, 1]
    jk, jv = jpa.scatter_kv_pages(
        jnp.asarray(k_pages), jnp.asarray(v_pages), jnp.asarray(k_all), jnp.asarray(v_all),
        jnp.asarray(page_idx), jnp.asarray(slot),
    )
    tk, tv = torch.from_numpy(k_pages.copy()), torch.from_numpy(v_pages.copy())
    out_k, out_v = tpa.scatter_kv_pages(
        tk, tv, torch.from_numpy(k_all), torch.from_numpy(v_all),
        torch.from_numpy(page_idx), torch.from_numpy(slot),
    )
    assert out_k is tk and out_v is tv  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_cuda_wrappers_refuse_cpu_tensors():
    # the CPU path is chosen by the tensor's device; the kernel launchers
    # themselves only take CUDA tensors and raise on anything else
    before = (tfa.launches, tpa.scatter_launches)
    q = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_forward_cuda(q, q, q, causal=True, sm_scale=1.0)
    pages = torch.zeros(1, 2, 16, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.scatter_cuda(pages, pages, torch.zeros(1, 1, 2, 32, dtype=torch.bfloat16),
                         torch.zeros(1, 1, 2, 32, dtype=torch.bfloat16),
                         torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    assert (tfa.launches, tpa.scatter_launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,hq,hkv,s,skv,q_offset,causal,d,o_tol",
    [
        (2, 4, 4, 70, 70, 0, True, 64, 1e-2),
        # chip_smoke.py's K1 limit: o is bf16, and P is rounded to bf16 for
        # P.V, so rows with few keys (|o| up to ~4) may differ by a bf16 ulp
        (2, 8, 2, 300, 300, 0, True, 128, 2e-2),  # ragged, GQA
        (1, 4, 4, 204, 700, 496, True, 128, 2e-2),  # a chunk off the tile grid, ragged Skv
        (2, 4, 4, 70, 70, 0, False, 64, 1e-2),  # full attention
    ],
    ids=["causal", "ragged-gqa", "chunk-q_offset-496", "non-causal"],
)
def test_kernels_match_plain_versions_on_card(B, hq, hkv, s, skv, q_offset, causal, d, o_tol):
    """Run on the card (``python3 chip_smoke.py`` covers the same at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, hq, s, d, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(B, hkv, skv, d, generator=g, device=dev).bfloat16() for _ in range(2))
    o, lse = tfa.flash_forward_cuda(q, k, v, causal=causal, sm_scale=d**-0.5, q_offset=q_offset)
    o2, lse2 = tfa.flash_forward_plain(q, k, v, causal=causal, sm_scale=d**-0.5, q_offset=q_offset)
    assert (o.float() - o2.float()).abs().max().item() < o_tol
    assert (lse - lse2).abs().max().item() < 1e-4
