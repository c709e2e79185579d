"""The port's int8 KV cache against the JAX package's.

- ``quantize_kv``, ``dequantize_kv``, ``kv_gather(dtype=)``, ``kv_scatter`` and
  the scatter's plain version on int8 pages: bitwise the JAX values (same IEEE
  divisions, round half to even), all-zero rows exact.
- The ragged decode's plain version on int8 pages: against the XLA form
  (``kv_gather`` + ``paged_decode_attention_inflight``, the lower-level
  oracle) at 1e-5 in f32, and against both Pallas variants in interpret mode
  at the bound the JAX package holds its own int8 kernels to (5e-3: they
  enter the products in another order and precision).
- The ragged decode kernels' split algorithm (``test_torch_ops.
  split_decode_model``) over int8 pages dequantized by JAX, against JAX's
  ``paged_decode_attention_inflight`` at the kernels' split edges, at the
  model's stated bound.
- ``PagedKVCache`` int8: bytes, ``kv_dtype`` and ``quantized`` as in JAX.
- Tiny f32 ``prefill`` / ``prefill_chunk`` / ``decode_step`` with int8 weights
  and an int8 cache against the JAX functions: logits within 1e-4 x
  max|logit|; written pages within one int8 step (a row whose f32 value sits
  on a rounding boundary may round the other way when the K/V projections
  sum in another order).
- The tiny f32 engine with ``quantization="int8", kv_dtype="int8"`` against
  the JAX engine: finish reasons, token counts and pages exactly; tokens
  identical wherever the reference's top-2 margin exceeds 1e-3.

The CUDA kernels run only on the card (the ``gpu``-marked tests;
``chip_smoke.py`` at full size).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.models import quantize as jquant
from modal_examples_tpu.ops import kv_quant as jkv
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.kv_cache import PagedKVCache as JaxCache
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu_torch import LLMEngine, SamplingParams
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.models import quantize as tquant
from modal_examples_tpu_torch.ops import kv_quant as tkv
from modal_examples_tpu_torch.ops import paged_attention as tpa
from modal_examples_tpu_torch.serving.kv_cache import PagedKVCache
from test_torch_ops import assert_split_model_matches, row_rel_err, split_edge_case
from test_torch_time_limit import share_cores

share_cores()

# the JAX package's ops/__init__ re-exports functions under their modules' names
jpa = importlib.import_module("modal_examples_tpu.ops.paged_attention")

PS = 16
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _rows(seed, *shape):
    """Random rows of mixed magnitude, every seventh row all zero."""
    rng = np.random.default_rng(seed)
    x = _rand(rng, *shape) * rng.choice([1e-3, 1.0, 30.0], shape[:-1]).astype(np.float32)[..., None]
    x.reshape(-1, shape[-1])[::7] = 0.0
    return x


def _t(a):
    return torch.tensor(np.asarray(a))


def _tkv(jq):
    """A JAX QuantizedKV as the port's (same values)."""
    return tkv.QuantizedKV(data=_t(jq.data), scale=_t(jq.scale))


def _assert_same_kv(port, ref):
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(port.scale.numpy(), np.asarray(ref.scale))


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_and_dequantize_kv_are_bitwise_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _rows(0, 3, 40, 4, 32)
    ref = jkv.quantize_kv(jnp.asarray(x, jdt))
    port = tkv.quantize_kv(torch.from_numpy(x).to(tdt))
    _assert_same_kv(port, ref)
    zero = x.reshape(-1, 32)[::7]
    assert not zero.any() and (port.scale.reshape(-1)[::7] == 1).all()
    for jd, td in DTYPES.values():
        got = tkv.dequantize_kv(port, td)
        assert got.dtype == td
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(jkv.dequantize_kv(ref, jd), np.float32))
    assert port.shape == port.data.shape and port.dtype == torch.int8 and port.ndim == 4
    assert port.nbytes == ref.nbytes
    _assert_same_kv(port[1:, 3], ref[1:, 3])


def test_resolve_and_name_kv_dtypes_as_jax():
    for spec in ("int8", "i8", "INT8"):
        assert tkv.resolve_kv_dtype(spec) == "int8" == jkv.resolve_kv_dtype(spec)
    assert tkv.resolve_kv_dtype(torch.int8) == "int8"
    assert tkv.resolve_kv_dtype("bf16") == torch.bfloat16
    shape = (2, 3, PS, 2, 8)
    assert tkv.kv_dtype_name(tkv.kv_empty(shape, "int8", "cpu")) == jkv.kv_dtype_name(jkv.kv_empty(shape, "int8"))
    assert tkv.kv_dtype_name(tkv.kv_empty(shape, "bf16", "cpu")) == jkv.kv_dtype_name(jkv.kv_empty(shape, "bf16"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layer", [None, 1])
def test_kv_gather_dequantizes_bitwise_as_jax(dtype, layer):
    jdt, tdt = DTYPES[dtype]
    jpages = jkv.quantize_kv(jnp.asarray(_rows(1, 2, 9, PS, 2, 32)))
    if layer is None:  # one layer's [P, ps, Hkv, D] pages
        jpages = jpages[1]
    tables = np.array([[3, 1, 8], [0, 5, 2]], np.int32)
    ref = jkv.kv_gather(jpages, jnp.asarray(tables), layer, dtype=jdt)
    got = tkv.kv_gather(_tkv(jpages), torch.from_numpy(tables).long(), layer, dtype=tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def _scatter_case(seed, L=2, P=9, hkv=2, d=32, n=6):
    """Rows for n tokens (two of them dead, on trash page 0 slot 0, given
    equal rows so their race has one result) into an int8 cache."""
    x = _rows(seed, 2, L, n, hkv, d)
    x[:, :, 4] = x[:, :, 1]
    page_idx = np.array([3, 0, 5, 8, 0, 1], np.int32)[:n]
    slot = np.array([2, 0, 15, 0, 0, 7], np.int32)[:n]
    pages = [jkv.quantize_kv(jnp.asarray(_rows(seed + 1, L, P, PS, hkv, d))) for _ in range(2)]
    return x[0], x[1], page_idx, slot, pages


def test_kv_scatter_int8_is_bitwise_jax():
    k_all, _, page_idx, slot, (jpages, _) = _scatter_case(2)
    ref = jkv.kv_scatter(jpages, jnp.asarray(k_all), jnp.asarray(page_idx), jnp.asarray(slot))
    port = _tkv(jpages)
    out = tkv.kv_scatter(port, torch.from_numpy(k_all), torch.from_numpy(page_idx).long(), torch.from_numpy(slot).long())
    assert out is port  # in place
    _assert_same_kv(port, ref)


def test_scatter_plain_int8_is_bitwise_jax_scatter_kv_pages():
    k_all, v_all, page_idx, slot, (jk, jv) = _scatter_case(3)
    rk, rv = jpa.scatter_kv_pages(
        jk, jv, jnp.asarray(k_all), jnp.asarray(v_all), jnp.asarray(page_idx), jnp.asarray(slot)
    )
    tk, tv = _tkv(jk), _tkv(jv)
    out_k, out_v = tpa.scatter_kv_pages(
        tk, tv, torch.from_numpy(k_all), torch.from_numpy(v_all), torch.from_numpy(page_idx), torch.from_numpy(slot)
    )
    assert out_k is tk and out_v is tv
    _assert_same_kv(tk, rk)
    _assert_same_kv(tv, rv)


def _decode_case(seed, hq, hkv, d=32, layers=2):
    """Ragged prefixes 0, 1, ps-1, ps, ps+1, 3ps+5 over shuffled int8 pages."""
    rng = np.random.default_rng(seed)
    lens = np.array([0, 1, PS - 1, PS, PS + 1, 3 * PS + 5], np.int32)
    B, pps = len(lens), 4
    n_pages = 1 + B * pps
    tables = (rng.permutation(n_pages - 1)[: B * pps] + 1).reshape(B, pps).astype(np.int32)
    kp = jkv.quantize_kv(jnp.asarray(_rand(rng, layers, n_pages, PS, hkv, d)))
    vp = jkv.quantize_kv(jnp.asarray(_rand(rng, layers, n_pages, PS, hkv, d)))
    return dict(q=_rand(rng, B, hq, d), kp=kp, vp=vp, tables=tables, lens=lens,
                k_new=_rand(rng, B, hkv, d), v_new=_rand(rng, B, hkv, d))


def _port_decode(c, layer):
    return tpa.paged_decode_attention_ragged(
        torch.from_numpy(c["q"]), _tkv(c["kp"]), _tkv(c["vp"]), layer, torch.from_numpy(c["tables"]),
        torch.from_numpy(c["lens"]), torch.from_numpy(c["k_new"]), torch.from_numpy(c["v_new"]),
    )


@pytest.mark.parametrize("hq,hkv", [(4, 2), (32, 32)])
def test_int8_decode_matches_jax_xla_form(hq, hkv):
    c = _decode_case(4, hq, hkv)
    j = {k: jnp.asarray(v) for k, v in c.items() if k not in ("kp", "vp")}
    ks = jkv.kv_gather(c["kp"], j["tables"], 1, dtype=jnp.float32)
    vs = jkv.kv_gather(c["vp"], j["tables"], 1, dtype=jnp.float32)
    ref = np.asarray(jpa.paged_decode_attention_inflight(j["q"], ks, vs, j["lens"], j["k_new"], j["v_new"]))
    np.testing.assert_allclose(_port_decode(c, 1).numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant,hq,hkv", [("flat", 32, 32), ("grouped", 4, 2)])
def test_int8_decode_matches_jax_ragged_kernels_interpret(variant, hq, hkv):
    c = _decode_case(5, hq, hkv)
    j = {k: jnp.asarray(v) for k, v in c.items() if k not in ("kp", "vp")}
    ref = np.asarray(jpa.paged_decode_attention_ragged(
        j["q"], c["kp"], c["vp"], jnp.int32(0), j["tables"], j["lens"], j["k_new"], j["v_new"],
        variant=variant, interpret=True,
    ))
    np.testing.assert_allclose(_port_decode(c, 0).numpy(), ref, atol=5e-3)


@pytest.mark.parametrize("hq,hkv", [(2, 2), (8, 2)], ids=["G=1", "G=4"])
def test_split_decode_model_over_int8_pages_matches_jax_inflight(hq, hkv):
    c = split_edge_case(31, hq, hkv)
    tables = jnp.asarray(c["tables"])
    ks, vs = (np.asarray(jkv.kv_gather(jkv.quantize_kv(jnp.asarray(c[n])), tables, dtype=jnp.bfloat16), np.float32)
              for n in ("k_pages", "v_pages"))
    assert_split_model_matches(c, ks, vs)


def test_paged_kv_cache_int8_as_jax():
    kw = dict(n_layers=2, n_kv_heads=2, head_dim=128, n_pages=9, page_size=PS)
    ref = JaxCache.create(kv_dtype="int8", **kw)
    cache = PagedKVCache.create(kv_dtype="int8", device="cpu", **kw)
    assert cache.quantized and ref.quantized
    assert cache.kv_dtype == ref.kv_dtype == "int8"
    assert cache.bytes() == ref.bytes()
    assert cache.n_pages == ref.n_pages == 9
    plain = PagedKVCache.create(kv_dtype="bfloat16", device="cpu", **kw)
    assert not plain.quantized and plain.kv_dtype == JaxCache.create(kv_dtype="bfloat16", **kw).kv_dtype
    assert plain.bytes() == JaxCache.create(kv_dtype="bfloat16", **kw).bytes()
    assert cache.bytes() / plain.bytes() < 0.52  # (128 + 4) / 256 bytes a row at D=128


@pytest.fixture(scope="module")
def qmodel():
    """The tiny f32 llama quantized by JAX, and the same tree through
    ``params_from_jax``."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jq = jquant.quantize_llama(jllama.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, jq, tllama.params_from_jax(jax.tree.map(np.asarray, jq), tcfg, device="cpu")


def _empty_caches(cfg, n_pages):
    shape = (cfg.n_layers, n_pages, PS, cfg.n_kv_heads, cfg.head_dim)
    return ((jkv.kv_empty(shape, "int8"), jkv.kv_empty(shape, "int8")),
            (tkv.kv_empty(shape, "int8", "cpu"), tkv.kv_empty(shape, "int8", "cpu")))


def _assert_logits(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def _assert_pages(port, ref):
    """Pages past trash page 0 within one int8 step, scales at f32 rtol 1e-5."""
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.scale.numpy()[:, 1:], np.asarray(r.scale)[:, 1:], rtol=1e-5)
        diff = np.abs(p.data.numpy()[:, 1:].astype(np.int32) - np.asarray(r.data)[:, 1:].astype(np.int32))
        assert diff.max() <= 1 and diff.mean() < 1e-3


def test_prefill_then_decode_int8_match_jax(qmodel):
    jcfg, tcfg, jq, tq = qmodel
    rng = np.random.default_rng(1)
    B, S, pps = 2, 32, 8
    n_pages = 1 + 3 * pps
    tables = (rng.permutation(n_pages - 1)[: 3 * pps] + 1).reshape(3, pps).astype(np.int32)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    seq_lens = np.array([20, 32], np.int32)
    (jk, jv), (tk, tv) = _empty_caches(tcfg, n_pages)
    j_logits, jk, jv = jllama.prefill(
        jq, jnp.asarray(tokens), jk, jv, jnp.asarray(tables[:B]), jnp.asarray(seq_lens), jcfg,
    )
    t_logits, _, _ = tllama.prefill(
        tq, torch.from_numpy(tokens), tk, tv, torch.from_numpy(tables[:B]), torch.from_numpy(seq_lens), tcfg,
    )
    _assert_logits(t_logits, j_logits)
    _assert_pages((tk, tv), (jk, jv))
    toks = np.array([5, 9, 0], np.int32)
    positions = np.array([20, 32, 7], np.int32)
    active = np.array([True, True, False])  # the third slot is dead: trash page 0
    for _ in range(3):
        j_logits, jk, jv = jllama.decode_step(
            jq, jnp.asarray(toks), jnp.asarray(positions), jk, jv, jnp.asarray(tables), jnp.asarray(active), jcfg,
        )
        t_logits, _, _ = tllama.decode_step(
            tq, torch.from_numpy(toks), torch.from_numpy(positions), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(active), tcfg,
        )
        _assert_logits(t_logits, j_logits)
        toks = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
        positions = positions + 1
    _assert_pages((tk, tv), (jk, jv))


def test_prefill_chunk_int8_matches_jax(qmodel):
    jcfg, tcfg, jq, tq = qmodel
    rng = np.random.default_rng(2)
    C, n_prompt, pps = 32, 45, 4
    table = (rng.permutation(pps) + 1).astype(np.int32)[None, :]
    prompt = rng.integers(0, tcfg.vocab_size, n_prompt).astype(np.int32)
    (jk, jv), (tk, tv) = _empty_caches(tcfg, 1 + pps)
    for offset in (0, C):
        chunk = np.zeros((1, C), np.int32)
        part = prompt[offset : offset + C]
        chunk[0, : len(part)] = part
        lens = np.array([len(part)], np.int32)
        j_logits, jk, jv = jllama.prefill_chunk(
            jq, jnp.asarray(chunk), jk, jv, jnp.asarray(table), jnp.asarray(lens), jcfg, q_offset=offset,
        )
        t_logits, _, _ = tllama.prefill_chunk(
            tq, torch.from_numpy(chunk), tk, tv, torch.from_numpy(table), torch.from_numpy(lens), tcfg,
            q_offset=offset,
        )
        _assert_logits(t_logits, j_logits)
    _assert_pages((tk, tv), (jk, jv))


def test_paged_impl_plan_reports_int8():
    cfg = tllama.LlamaConfig.llama2_7b()
    plan = tllama.paged_impl_plan(cfg, "cpu", "int8", "int8")
    assert plan["kv_dtype"] == "int8" and plan["weights"] == "int8"
    assert plan["ragged_variant"] == jllama.paged_impl_plan(
        jllama.LlamaConfig.llama2_7b(), 16, "pallas", kv_dtype="int8")["ragged_variant"]
    assert tllama.paged_impl_plan(cfg, "cpu")["weights"] == "bfloat16"


MARGIN = 1e-3
ENGINE_KW = dict(
    max_slots=4, max_model_len=256, page_size=PS, prefill_buckets=(32, 64),
    seed=0, quantization="int8", kv_dtype="int8", decode_block=4,
)
REQUESTS = [  # (prompt, params): prompt lengths 11, 41, 64, 101 and 151 tokens
    ("a" * 10, dict(max_tokens=9, temperature=0.0)),
    ("the quick brown fox jumps over a lazy dog", dict(max_tokens=12, temperature=0.8, seed=7)),
    ("b" * 63, dict(max_tokens=6, temperature=1.0)),  # engine-assigned seed
    ("c" * 100, dict(max_tokens=10, temperature=0.0, stop=("zz",))),
    ("0123456789" * 15, dict(max_tokens=8, temperature=0.7, seed=123)),
]


def _run(engine, params_cls):
    reqs = [engine.submit(prompt, params_cls(**kw)) for prompt, kw in REQUESTS]
    pieces = [list(engine.stream(r)) for r in reqs]
    return reqs, pieces


def _ref_margin(jparams, jcfg, req, j):
    """Top-2 margin of the reference's generated token j: the JAX engine's
    own quantized forward over the same tokens (int8 weights, dense
    attention), plus the row's gumbel noise for sampled rows."""
    toks = list(req.prompt_tokens) + list(req.generated_tokens[:j])
    logits = jllama.forward(jparams, jnp.asarray([toks], jnp.int32), jcfg, attn_impl="xla")[0, -1]
    p = req.params
    if p.temperature > 0:
        seed = p.seed if p.seed is not None else req.auto_seed
        step = len(req.prompt_tokens) + max(0, j - 1)
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), seed), step)
        logits = logits / p.temperature + jax.random.gumbel(key, logits.shape)
    top2 = np.sort(np.asarray(logits))[-2:]
    return float(top2[1] - top2[0])


def test_int8_engine_matches_jax_engine(qmodel):
    jcfg, tcfg, _, _ = qmodel
    # both engines get the float weights and quantize them themselves
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    jeng = JaxEngine(jcfg, jparams, enable_prefix_cache=False, **ENGINE_KW)
    teng = LLMEngine(tcfg, tparams, device="cpu", enable_prefix_cache=False, **ENGINE_KW)
    assert teng.cache.quantized and teng.impl_plan["kv_dtype"] == "int8" and teng.impl_plan["weights"] == "int8"
    assert tquant.param_bytes(teng.params) == jquant.param_bytes(jeng.params)
    try:
        jreqs, jpieces = _run(jeng, JaxParams)
        treqs, tpieces = _run(teng, SamplingParams)
        assert jeng.cache.allocator.available == jeng.cache.n_pages - 1
        assert teng.cache.allocator.available == teng.cache.n_pages - 1
    finally:
        jeng.stop()
        teng.stop()
    assert any(len(r.prompt_tokens) > 64 for r in treqs)  # chunked prefill ran
    for jr, tr, jp, tp in zip(jreqs, treqs, jpieces, tpieces):
        assert tr.finish_reason == jr.finish_reason
        assert tr.n_generated == jr.n_generated
        assert len(tr.generated_tokens) == len(jr.generated_tokens)
        if tr.generated_tokens == jr.generated_tokens:
            assert tp == jp
            continue
        j = next(i for i, (a, b) in enumerate(zip(tr.generated_tokens, jr.generated_tokens)) if a != b)
        assert _ref_margin(jeng.params, jcfg, jr, j) <= MARGIN, f"token {j} differs past the margin"


def test_int8_wrappers_refuse_cpu_tensors():
    before = (tpa.decode_int8_launches, tpa.scatter_int8_launches)
    shape = (1, 3, PS, 2, 32)
    pages = tkv.kv_empty(shape, "int8", "cpu")
    rows = torch.zeros(1, 1, 2, 32, dtype=torch.bfloat16)
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.scatter_int8_cuda(pages, pages, rows, rows, idx, idx)
    q = torch.zeros(1, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_int8_cuda(q, pages, pages, 0, idx[None], idx, q, q, sm_scale=1.0)
    assert (tpa.decode_int8_launches, tpa.scatter_int8_launches) == before


@pytest.mark.gpu
def test_int8_kernels_match_plain_versions_on_card():
    """Run on the card (``python3 chip_smoke.py`` covers the same at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    L, P, hkv, hq, d = 2, 9, 2, 4, 64
    kp = tkv.quantize_kv(torch.randn(L, P, PS, hkv, d, generator=g, device=dev))
    vp = tkv.quantize_kv(torch.randn(L, P, PS, hkv, d, generator=g, device=dev))
    q = torch.randn(3, hq, d, generator=g, device=dev).bfloat16()
    k_new, v_new = (torch.randn(3, hkv, d, generator=g, device=dev).bfloat16() for _ in range(2))
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [2, 4, 6, 8]], dtype=torch.int32, device=dev)
    lens = torch.tensor([0, 17, 60], dtype=torch.int32, device=dev)
    args = (q, kp, vp, 1, tables, lens, k_new, v_new)
    out = tpa.paged_decode_int8_cuda(*args, sm_scale=d**-0.5)
    torch.cuda.synchronize()
    assert (out.float() - tpa.paged_decode_int8_plain(*args, sm_scale=d**-0.5).float()).abs().max().item() < 6e-2
    # the split edges, G = 1 and 4: per (sequence, head) row at chip_smoke.py's
    # limit, and bitwise equal from run to run
    for g_hkv in (4, 1):
        c = split_edge_case(37, 4, g_hkv, d=128)
        pages = [tkv.quantize_kv(torch.from_numpy(np.stack([c[n]] * 2)).to(dev)) for n in ("k_pages", "v_pages")]
        dargs = (torch.from_numpy(c["q"]).to(dev, torch.bfloat16), *pages, 1, torch.from_numpy(c["tables"]).to(dev),
                 torch.from_numpy(c["lens"]).to(dev), torch.from_numpy(c["k_new"]).to(dev, torch.bfloat16),
                 torch.from_numpy(c["v_new"]).to(dev, torch.bfloat16))
        got, again = (tpa.paged_decode_int8_cuda(*dargs, sm_scale=128**-0.5) for _ in range(2))
        torch.cuda.synchronize()
        assert row_rel_err(got, tpa.paged_decode_int8_plain(*dargs, sm_scale=128**-0.5)) <= 1e-2
        assert torch.equal(got, again)
    rows_k, rows_v = (torch.randn(L, 3, hkv, d, generator=g, device=dev).bfloat16() for _ in range(2))
    idx, slot = torch.tensor([3, 0, 7], dtype=torch.int32, device=dev), torch.tensor([5, 0, 15], dtype=torch.int32, device=dev)
    ck, cv = tkv.QuantizedKV(kp.data.clone(), kp.scale.clone()), tkv.QuantizedKV(vp.data.clone(), vp.scale.clone())
    tpa.scatter_int8_cuda(kp, vp, rows_k, rows_v, idx, slot)
    torch.cuda.synchronize()
    tpa.scatter_int8_plain(ck, cv, rows_k, rows_v, idx.long(), slot.long())
    for got, want in ((kp, ck), (vp, cv)):
        assert torch.equal(got.data, want.data) and torch.equal(got.scale, want.scale)
