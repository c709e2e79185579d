"""The port's Llama layers and serving functions against the JAX package's.

Same weights (the JAX ``init_params`` tree through ``params_from_jax``), same
numpy inputs, tiny f32 config with GQA (Hq=4, Hkv=2). Logits and written
pages must agree within 1e-4 x max|logit| (accumulation order differs
between XLA and PyTorch); page 0, the trash page, is excluded.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import layers as jlayers
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu_torch.models import layers as tlayers
from modal_examples_tpu_torch.models import llama as tllama
from test_torch_time_limit import share_cores

share_cores()

PS = 16


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tllama.params_from_jax(np_params, tcfg, device="cpu")


def _cache(cfg, n_pages):
    shape = (cfg.n_layers, n_pages, PS, cfg.n_kv_heads, cfg.head_dim)
    return np.zeros(shape, np.float32), np.zeros(shape, np.float32)


def _assert_logits(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def _assert_pages(port_k, port_v, ref_k, ref_v, scale):
    for p, r in ((port_k, ref_k), (port_v, ref_v)):
        np.testing.assert_allclose(p.numpy()[:, 1:], np.asarray(r)[:, 1:], rtol=0, atol=1e-4 * scale)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))), atol=1e-6, rtol=1e-6,
    )
    pos = np.arange(40, dtype=np.int32).reshape(2, 20)
    for cfg in (jllama.LlamaConfig.llama2_7b(), jllama.LlamaConfig.llama31_8b()):
        scaling = dict(cfg.rope_scaling) if cfg.rope_scaling else None
        jc, js = jlayers.rotary_embedding(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta, rope_scaling=scaling)
        tc, ts = tlayers.rotary_embedding(torch.from_numpy(pos), cfg.head_dim, cfg.rope_theta, rope_scaling=scaling)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5)
    q = rng.standard_normal((2, 4, 20, 128)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(q), tc, ts).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(q), jc, js)), atol=1e-5,
    )


def test_params_from_jax_keeps_every_leaf(model):
    jcfg, tcfg, jparams, tparams = model
    n_jax = sum(x.size for x in jax.tree.leaves(jparams))
    n_port = sum(t.numel() for t in jax.tree.leaves(tparams))
    assert n_port == n_jax == tcfg.param_count == jcfg.param_count
    assert len(jax.tree.leaves(tparams)) == 3 + tcfg.n_layers * 9
    assert len(tparams["layers"]) == tcfg.n_layers
    # a 7B-shaped count agrees with the reference config's arithmetic
    assert tllama.LlamaConfig.llama2_7b().param_count == jllama.LlamaConfig.llama2_7b().param_count


def test_prefill_then_decode_match_jax(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(1)
    B, S, pps = 2, 32, 8
    n_pages = 1 + 3 * pps
    tables = (rng.permutation(n_pages - 1)[: 3 * pps] + 1).reshape(3, pps).astype(np.int32)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    seq_lens = np.array([20, 32], np.int32)
    kp, vp = _cache(tcfg, n_pages)
    j_logits, jk, jv = jllama.prefill(
        jparams, jnp.asarray(tokens), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables[:B]), jnp.asarray(seq_lens), jcfg,
    )
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t_logits, _, _ = tllama.prefill(
        tparams, torch.from_numpy(tokens), tk, tv, torch.from_numpy(tables[:B]),
        torch.from_numpy(seq_lens), tcfg,
    )
    _assert_logits(t_logits, j_logits)
    _assert_pages(tk, tv, jk, jv, np.abs(np.asarray(jk)).max())

    # three decode steps, third slot dead (writes trash page 0)
    toks = np.array([5, 9, 0], np.int32)
    positions = np.array([20, 32, 7], np.int32)
    active = np.array([True, True, False])
    for _ in range(3):
        j_logits, jk, jv = jllama.decode_step(
            jparams, jnp.asarray(toks), jnp.asarray(positions), jk, jv,
            jnp.asarray(tables), jnp.asarray(active), jcfg,
        )
        t_logits, _, _ = tllama.decode_step(
            tparams, torch.from_numpy(toks), torch.from_numpy(positions), tk, tv,
            torch.from_numpy(tables), torch.from_numpy(active), tcfg,
        )
        _assert_logits(t_logits, j_logits)
        toks = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
        positions = positions + 1
    _assert_pages(tk, tv, jk, jv, np.abs(np.asarray(jk)).max())


def test_prefill_chunk_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(2)
    C, n_prompt, pps = 32, 45, 4
    n_pages = 1 + pps
    table = (rng.permutation(pps) + 1).astype(np.int32)[None, :]
    prompt = rng.integers(0, tcfg.vocab_size, n_prompt).astype(np.int32)
    kp, vp = _cache(tcfg, n_pages)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    for offset in (0, C):
        chunk = np.zeros((1, C), np.int32)
        part = prompt[offset : offset + C]
        chunk[0, : len(part)] = part
        lens = np.array([len(part)], np.int32)
        j_logits, jk, jv = jllama.prefill_chunk(
            jparams, jnp.asarray(chunk), jk, jv, jnp.asarray(table), jnp.asarray(lens), jcfg,
            q_offset=offset,
        )
        t_logits, _, _ = tllama.prefill_chunk(
            tparams, torch.from_numpy(chunk), tk, tv, torch.from_numpy(table), torch.from_numpy(lens),
            tcfg, q_offset=offset,
        )
        _assert_logits(t_logits, j_logits)
    _assert_pages(tk, tv, jk, jv, np.abs(np.asarray(jk)).max())


def test_paged_impl_plan_reports_what_runs():
    cfg = tllama.LlamaConfig.llama2_7b()
    plan = tllama.paged_impl_plan(cfg, "cpu")
    assert plan["impl"] == "plain" and plan["attention"] == "ragged"
    assert plan["ragged_variant"] == jllama.paged_impl_plan(jllama.LlamaConfig.llama2_7b(), 16, "pallas")["ragged_variant"]
    assert tllama.paged_impl_plan(tllama.LlamaConfig.llama31_8b(), "cpu")["ragged_variant"] == "grouped"


def test_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.init_params(tllama.LlamaConfig.tiny())
