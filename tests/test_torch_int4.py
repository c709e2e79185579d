"""The port's int4 weights (packed nibbles), the int4 matmul's plain version
and QLoRA against the JAX package's int4 path (``jnp.int4`` under XLA's dot).

Quantization must give bitwise the JAX int4 values and f32 scales (ties at
exact .5 steps round half to even, all-zero columns get scale 1), packed two
contraction rows a byte and unpacked back; ``param_bytes`` counts 4 bits an
element as the JAX function does. Products over an int4 weight are held in
f32 at rtol 1e-5 of the largest value (the same products, another summation
order); a whole tiny model's logits at 1e-4 of the largest logit in f32 and
within the logit contract (cosine > 0.999, max rel < 5e-2) in bf16; QLoRA's
loss at rtol 1e-5 and adapter gradients at ``test_torch_lora_int8.py``'s
rtol 1e-4 (atol 1e-6). The engine's greedy stream over its own int4 tree
equals the dense forward's argmax continuation (exact tokens).
``chip_smoke.plain_moe`` over int4 experts matches the JAX
``moe_swiglu_nodrop`` at 1e-4 of the largest value, and K7-int4's path rule
(mirrored in Python) is held on shapes and alignments. The CUDA
kernel runs only on the card: ``tests/test_torch_int4_card.py`` (marked
``gpu``) and ``chip_smoke.py`` phase 17 at Llama-2-7B's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import layers as jlayers
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.models import lora as jlora
from modal_examples_tpu.models import quantize as jquant
from modal_examples_tpu.training import trainer as jtrainer
from modal_examples_tpu_torch import LLMEngine, SamplingParams
from modal_examples_tpu_torch.models import layers as tlayers
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.models import lora as tlora
from modal_examples_tpu_torch.models import moe as tmoe
from modal_examples_tpu_torch.models import quantize as tquant
from modal_examples_tpu_torch.observability import canary
from modal_examples_tpu_torch.ops import quantized_matmul as tqmm
from modal_examples_tpu_torch.training import cross_entropy_loss
from test_torch_checkpoint import _assert_tree_equal, _hf_config, write_checkpoint
from test_torch_time_limit import share_cores

share_cores()

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = 1e-5
LOGIT_TOL = 1e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
RANK = 8


def _weight(seed, shape):
    """Random weights of mixed magnitude with an all-zero column and a
    column of exact ties: amax 7 makes the scale 1, so 0.5, 1.5, -2.5 and
    3.5 sit halfway between two int4 values."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * rng.choice([1e-3, 0.1, 3.0], shape[-1]).astype(np.float32)
    w[..., 5] = 0.0
    ties = np.resize(np.array([0.5, 1.5, -2.5, 3.5, -0.5, 6.5, 7.0], np.float32), shape[-2])
    w[..., 6] = ties
    return w


def _assert_same(port: tquant.QuantizedWeight, ref, rows: int):
    assert port.bits == 4 and port.q.dtype == torch.uint8 and port.scale.dtype == torch.float32
    assert port.q.shape[-2] == (rows + 1) // 2 and port.shape == tuple(ref.q.shape)
    assert str(ref.q.dtype) == "int4"
    np.testing.assert_array_equal(port.values().numpy(), np.asarray(ref.q).astype(np.int8))
    np.testing.assert_array_equal(port.scale.numpy(), np.asarray(ref.scale))


# -- quantization -------------------------------------------------------------------


@pytest.mark.parametrize("rows", [96, 33], ids=["even-K", "odd-K"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_weight_int4_is_bitwise_jax(dtype, rows):
    jdt, tdt = DTYPES[dtype]
    w = _weight(0, (rows, 40))
    ref = jquant.quantize_weight(jnp.asarray(w, jdt), bits=4)
    port = tquant.quantize_weight(torch.from_numpy(w).to(tdt), bits=4)
    _assert_same(port, ref, rows)
    assert (port.scale[0, 5] == 1.0).item() and not port.values()[:, 5].any()  # the zero column
    if dtype == "float32":  # the ties column: amax 7, scale 1, halves to even
        assert port.scale[0, 6].item() == 1.0
        assert sorted(set(port.values()[:, 6].tolist())) == [-2, 0, 2, 4, 6, 7]
    np.testing.assert_array_equal(
        tquant.dequantize_weight(port, torch.float32).numpy(),
        np.asarray(jquant.dequantize_weight(ref, jnp.float32)),
    )


@pytest.mark.parametrize("rows", [32, 33], ids=["even-K", "odd-K"])
def test_quantize_weight_host_int4_is_bitwise_jax(rows):
    w = _weight(1, (rows, 24))
    ref = jquant.quantize_weight_host(w, bits=4)
    port = tquant.quantize_weight_host(w, bits=4, device="cpu")
    _assert_same(port, ref, rows)
    dev = tquant.quantize_weight(torch.from_numpy(w), bits=4)
    assert torch.equal(port.q, dev.q) and torch.equal(port.scale, dev.scale) and port.rows == dev.rows


@pytest.mark.parametrize("shape", [(8, 5), (9, 7), (3, 16, 4)], ids=["even", "odd-K", "stacked"])
def test_pack_unpack_round_trip(shape):
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.integers(-8, 8, shape).astype(np.int8))
    packed = tqmm.pack_int4(q)
    assert packed.dtype == torch.uint8 and packed.shape == (*shape[:-2], (shape[-2] + 1) // 2, shape[-1])
    assert torch.equal(tqmm.unpack_int4(packed, shape[-2]), q)
    # row 2k in the low nibble, row 2k + 1 in the high one
    b = q.view(torch.uint8) & 0xF
    assert torch.equal(packed[..., : shape[-2] // 2, :], b[..., 0 : 2 * (shape[-2] // 2) : 2, :]
                       | (b[..., 1 : 2 * (shape[-2] // 2) : 2, :] << 4))
    if shape[-2] % 2:  # the padding nibble is zero
        assert not (packed[..., -1, :] >> 4).any()


def test_quantized_weight_reports_its_logical_shape_and_bits():
    w = tquant.quantize_weight(torch.from_numpy(_weight(3, (4, 33, 16))), bits=4)
    assert w.bits == 4 and w.rows == 33 and w.shape == (4, 33, 16) and w.q.shape == (4, 17, 16)
    e = tmoe._expert(w, 2)
    assert e.shape == (33, 16) and e.bits == 4 and e.q.is_contiguous() and e.q.data_ptr() == w.q[2].data_ptr()
    w8 = tquant.quantize_weight(torch.from_numpy(_weight(3, (33, 16))))
    assert w8.bits == 8 and w8.shape == (33, 16) and w8.q.dtype == torch.int8
    # bits and rows ride with the node through tree maps, never as leaves
    assert len(tquant.tree.leaves({"w": w})) == 2
    moved = tquant.tree.map(lambda t: t.clone(), {"w": w})["w"]
    assert moved.bits == 4 and moved.rows == 33 and torch.equal(moved.q, w.q)


@pytest.fixture(scope="module", params=list(DTYPES))
def int4_trees(request):
    """The tiny llama in the given dtype: the JAX tree quantized to int4 by
    JAX, and the same weights through ``params_from_jax`` quantized by the
    port."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=request.param)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=request.param)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tcfg, device="cpu")
    return jcfg, tcfg, jquant.quantize_llama(jparams, bits=4), tquant.quantize_llama(tparams, bits=4), tparams


def test_quantize_llama_int4_is_bitwise_jax(int4_trees):
    _, tcfg, jq, tq, tparams = int4_trees
    for li, layer in enumerate(tq["layers"]):
        for name in tllama._LAYER_KEYS:
            ref = jq["layers"][name]
            if name in tquant.LLAMA_TARGETS:
                _assert_same(layer[name], jquant.QuantizedWeight(q=ref.q[li], scale=ref.scale[li]),
                             ref.q.shape[-2])
            else:
                assert layer[name] is tparams["layers"][li][name]
    _assert_same(tq["lm_head"], jq["lm_head"], tcfg.dim)


def test_param_bytes_int4_equal_jax(int4_trees):
    _, _, jq, tq, tparams = int4_trees
    assert tquant.param_bytes(tq) == jquant.param_bytes(jq)
    q8 = tquant.quantize_llama(tparams, bits=8)
    payload4 = sum(w.q.numel() for w in tquant._weights(tq))
    payload8 = sum(w.q.numel() for w in tquant._weights(q8))
    assert 2 * payload4 == payload8 and tquant.param_bytes(tq) < tquant.param_bytes(q8)


def test_params_from_jax_packs_int4_bit_for_bit(int4_trees):
    jcfg, tcfg, jq, tq, _ = int4_trees
    from_jax = tllama.params_from_jax(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    _assert_tree_equal(from_jax, tq)
    for li in range(tcfg.n_layers):
        for name in tquant.LLAMA_TARGETS:
            if name in from_jax["layers"][li]:
                got, want = from_jax["layers"][li][name], tq["layers"][li][name]
                assert got.bits == 4 and got.rows == want.rows
    assert tquant.param_bytes(from_jax) == jquant.param_bytes(jq)


def test_init_quantized_llama_int4_equals_quantize_of_init():
    cfg = tllama.LlamaConfig.tiny()
    fused = tquant.init_quantized_llama(cfg, seed=3, bits=4, device="cpu")
    ref = tquant.quantize_llama(tllama.init_params(cfg, seed=3, device="cpu"), bits=4)
    _assert_tree_equal(fused, ref)
    assert fused["lm_head"].bits == 4 and fused["layers"][1]["down"].bits == 4


# -- the product --------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N", [(8, 64, 48), (5, 33, 24), (1, 128, 40), (70, 96, 16)],
                         ids=["decode", "odd-K", "one-row", "prefill"])
def test_qmm_int4_plain_matches_jax_mm(M, K, N):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # values bf16 holds exactly
    jw = jquant.quantize_weight(jnp.asarray(_weight(5, (K, N))), bits=4)
    tw = tquant.quantize_weight(torch.from_numpy(_weight(5, (K, N))), bits=4)
    ref = np.asarray(jlayers.mm(jnp.asarray(x), jw))
    tol = dict(rtol=F32_TOL, atol=F32_TOL * np.abs(ref).max())
    np.testing.assert_allclose(tqmm.qmm_int4_plain(torch.from_numpy(x), tw.q, tw.scale).numpy(), ref, **tol)
    np.testing.assert_allclose(tqmm.qmm_int4_plain(torch.from_numpy(x).bfloat16(), tw.q, tw.scale).numpy(), ref,
                               **tol)
    out = tlayers.mm(torch.from_numpy(x).reshape(1, M, K), tw)
    assert out.dtype == torch.float32 and out.shape == (1, M, N)
    np.testing.assert_allclose(out[0].numpy(), ref, **tol)


def _aligned_by(nbytes, shape, dtype):
    """A contiguous tensor whose first element sits ``nbytes`` past a
    16-byte aligned base."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    flat = torch.zeros(int(np.prod(shape)) + 16, dtype=dtype)
    skip = (-flat.data_ptr() % 16 + nbytes) // itemsize
    return flat[skip: skip + int(np.prod(shape))].view(shape)


@pytest.mark.parametrize("M,K,N,x_off,w_off,want", [
    (8, 64, 48, 0, 0, "ring"), (1, 64, 48, 0, 0, "ring"), (64, 128, 32, 0, 0, "ring"),
    (65, 64, 48, 0, 0, "wgmma"), (2048, 64, 16, 0, 0, "wgmma"),
    (8, 64, 40, 0, 0, "masked"), (70, 96, 24, 0, 0, "masked"), (5, 33, 16, 0, 0, "masked"),
    (300, 36, 16, 0, 0, "masked"), (8, 64, 48, 2, 0, "masked"), (70, 64, 48, 0, 4, "masked"),
], ids=["decode", "one-row", "m64", "m65", "prefill", "ragged-N", "ragged-N-prefill", "odd-K", "K%8",
        "x-unaligned", "w-unaligned"])
def test_int4_path_rule(M, K, N, x_off, w_off, want):
    """K7-int4's path rule, mirrored in Python (``int4_path_rule``; the
    card's ``int4_kernel_path`` asks the kernel's plan and the card tests
    and ``chip_smoke.py`` 17a hold the two equal): the TMA paths need
    16-byte aligned bases, N % 16 == 0 and K % 8 == 0; "ring" at M <= 64,
    "wgmma" above; anything else "masked"."""
    x = _aligned_by(x_off, (M, K), torch.bfloat16)
    w = _aligned_by(w_off, ((K + 1) // 2, N), torch.uint8)
    assert (x.data_ptr() % 16 == 0) == (x_off == 0) and (w.data_ptr() % 16 == 0) == (w_off == 0)
    assert tqmm.int4_path_rule(x, w) == want


def test_qmm_int4_cuda_refuses_cpu_tensors():
    before = tqmm.qmm_int4_launches
    w = tquant.quantize_weight(torch.from_numpy(_weight(6, (32, 16))), bits=4)
    with pytest.raises(ValueError, match="CUDA"):
        tqmm.qmm_int4_cuda(torch.zeros(4, 32, dtype=torch.bfloat16), w.q, w.scale)
    assert tqmm.qmm_int4_launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int4_mm_backward_is_the_closed_form(dtype):
    """``dX = (dY * scale) @ q^T`` in x's dtype over the unpacked values; no
    gradient to the packed bytes or the scale."""
    w = tquant.quantize_weight(torch.from_numpy(_weight(7, (33, 40))), bits=4)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 5, 33)).astype(np.float32)).to(dtype).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal((2, 5, 40)).astype(np.float32))
    y = tlayers.mm(x, w)
    np.testing.assert_array_equal(y.detach().numpy(), tqmm.qmm_int4_plain(x.detach().reshape(10, 33), w.q, w.scale)
                                  .reshape(2, 5, 40).numpy())
    (y * dy).sum().backward()
    want = (dy * w.scale).to(dtype) @ w.values().to(dtype).T
    assert x.grad.dtype == dtype
    np.testing.assert_array_equal(x.grad.float().numpy(), want.float().numpy())
    assert not w.q.requires_grad and not w.scale.requires_grad


def test_int4_mm_backward_matches_jax_vjp():
    w = _weight(9, (64, 48))
    jw = jquant.quantize_weight(jnp.asarray(w), bits=4)
    tw = tquant.quantize_weight(torch.from_numpy(w), bits=4)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((7, 64)).astype(np.float32)
    dy = rng.standard_normal((7, 48)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jlayers.mm(a, jw), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    tlayers.mm(xt, tw).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL * np.abs(want).max())


# -- the model ----------------------------------------------------------------------


def _cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_forward_over_a_jax_int4_tree_matches_jax(int4_trees, attn_impl):
    """``llama.forward`` over the JAX int4 tree carried across: f32 within
    1e-4 of the largest logit; bf16 within the logit contract."""
    jcfg, tcfg, jq, _, _ = int4_trees
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    tokens = np.random.default_rng(11).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    ref = np.asarray(jllama.forward(jq, jnp.asarray(tokens), jcfg, attn_impl="xla"), np.float32)
    got = tllama.forward(tparams, torch.from_numpy(tokens).long(), tcfg, attn_impl=attn_impl).float().numpy()
    if jcfg.dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_TOL * np.abs(ref).max())
    else:
        assert _cosine(got, ref) > 0.999
        assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_int4_greedy_equals_the_dense_argmax(dtype):
    """The port's copy of ``tests/test_quantize.py::test_engine_int4_generates_deterministically``,
    over that test's weights (``init_params(PRNGKey(3))`` carried across):
    greedy paged decode over the engine's own int4 tree equals the dense
    forward's argmax continuation, token for token."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=dtype)
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=dtype)
    jparams = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    params = tllama.params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), cfg, device="cpu")
    eng = LLMEngine(cfg, params=params, max_slots=2, max_model_len=64, page_size=16, prefill_buckets=(32,),
                    quantization="int4", seed=0, device="cpu", kv_dtype=dtype)
    try:
        req = eng.submit("hello world", SamplingParams(max_tokens=6, temperature=0.0))
        out = "".join(eng.stream(req))
        qparams = eng.params
        assert qparams["layers"][0]["wq"].bits == 4 and qparams["lm_head"].bits == 4
        seq = list(eng.tokenizer.encode("hello world"))
        got = []
        for _ in range(6):
            logits = tllama.forward(qparams, torch.tensor([seq]), cfg, attn_impl="xla")
            nxt = int(logits[0, -1].argmax())
            if nxt == eng.tokenizer.eos_id:
                break
            got.append(nxt)
            seq.append(nxt)
        assert list(req.generated_tokens) == got
        assert out == eng.tokenizer.decode(got) and out
    finally:
        eng.stop()


def test_engine_int4_plan_bytes_and_canary_key():
    """``impl_plan["weights"]`` says int4, the usage meter's weight bytes
    are the 4-bit ``param_bytes``, the canary's kernels name the int4
    matmul and its fingerprint tells int4 from int8."""
    cfg = tllama.LlamaConfig.tiny()
    kw = dict(max_slots=2, max_model_len=64, device="cpu")
    e4 = LLMEngine(cfg, quantization="int4", **kw)
    e8 = LLMEngine(cfg, quantization="int8", **kw)
    given = LLMEngine(cfg, params=tquant.init_quantized_llama(cfg, bits=4, device="cpu"), **kw)
    try:
        assert e4.impl_plan["weights"] == given.impl_plan["weights"] == "int4"
        assert e8.impl_plan["weights"] == "int8"
        assert e4.usage.model.weight_bytes == tquant.param_bytes(e4.params) < tquant.param_bytes(e8.params)
        assert "quantized_matmul_int4" in canary.plan_kernels(e4.impl_plan)
        assert "quantized_matmul" not in canary.plan_kernels(e4.impl_plan)
        f4, f8 = canary.fingerprint(e4), canary.fingerprint(e8)
        assert f4["weights"] == "int4" and canary.fingerprint_hash(f4) != canary.fingerprint_hash(f8)
    finally:
        for e in (e4, e8, given):
            e.stop()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_hf_weights_int4_is_bitwise_the_jax_loader(tmp_path, dtype):
    write_checkpoint(tmp_path, _hf_config())
    jcfg = dataclasses.replace(jllama.LlamaConfig.from_hf_config(tmp_path / "config.json"), dtype=dtype)
    tcfg = dataclasses.replace(tllama.LlamaConfig.from_hf_config(tmp_path / "config.json"), dtype=dtype)
    jparams = jllama.load_hf_weights(tmp_path, jcfg, quantization="int4")
    want = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    got = tllama.load_hf_weights(tmp_path, tcfg, quantization="int4", device="cpu")
    _assert_tree_equal(got, want)
    assert got["layers"][1]["down"].bits == 4 and got["lm_head"].bits == 4
    assert tquant.param_bytes(got) == jquant.param_bytes(jparams)


def test_mixtral_tiny_int4_forward_matches_jax():
    """Expert stacks quantized to int4 ([E, ceil(D/2), F] packed bytes,
    scales [E, 1, F]) through ``moe_swiglu_nodrop``: each expert's product
    over a contiguous view, f32 within 1e-4 of the largest logit."""
    kw = dict(vocab_size=64, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64, max_seq_len=128,
              dtype="float32", n_experts=4, top_k_experts=2)
    jcfg, tcfg = jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)
    jq = jquant.quantize_llama(jllama.init_params(jax.random.PRNGKey(5), jcfg), bits=4)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    gate = tparams["layers"][0]["moe_gate"]
    assert gate.bits == 4 and gate.shape == (4, 32, 64) and gate.q.shape == (4, 16, 64)
    tokens = np.random.default_rng(12).integers(0, 64, (2, 16)).astype(np.int32)
    ref = np.asarray(jllama.forward(jq, jnp.asarray(tokens), jcfg, attn_impl="xla"), np.float32)
    got = tllama.forward(tparams, torch.from_numpy(tokens).long(), tcfg, attn_impl="xla").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_TOL * np.abs(ref).max())


def test_chip_smoke_plain_moe_over_int4_experts_matches_jax():
    """``chip_smoke.plain_moe``, the card's reference for the served
    experts, over a Mixtral-tiny layer quantized to int4 by each package:
    each expert's view keeps ``bits`` and ``rows``, so its products go
    through ``qmm_int4_plain``. f32 within 1e-4 of the largest output value
    of the JAX ``moe_swiglu_nodrop`` (the same products, another summation
    order)."""
    import chip_smoke

    from modal_examples_tpu.models import moe as jmoe

    kw = dict(vocab_size=64, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64, max_seq_len=128,
              dtype="float32", n_experts=4, top_k_experts=2)
    jcfg, tcfg = jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)
    jparams = jllama.init_params(jax.random.PRNGKey(6), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tcfg, device="cpu")
    jlayer = jax.tree.map(lambda a: a[0], jquant.quantize_llama(jparams, bits=4)["layers"])
    tlayer = tquant.quantize_llama(tparams, bits=4)["layers"][0]
    assert tlayer["moe_down"].bits == 4 and tlayer["moe_down"].q.shape == (4, 32, 32)
    h = np.random.default_rng(13).standard_normal((12, 32)).astype(np.float32)
    ref, _ = jmoe.moe_swiglu_nodrop(jlayer["router"], jlayer["moe_gate"], jlayer["moe_up"], jlayer["moe_down"],
                                    jnp.asarray(h), jcfg.top_k_experts)
    ref = np.asarray(ref)
    got = chip_smoke.plain_moe(tlayer, torch.from_numpy(h), tcfg, tlayers).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_TOL * np.abs(ref).max())


# -- QLoRA --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qlora():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jbase = jquant.init_quantized_llama(jax.random.PRNGKey(0), jcfg, bits=4)
    tbase = tllama.params_from_jax(jax.tree.map(np.asarray, jbase), tcfg, device="cpu")
    adapters = jlora.init_lora(jax.random.PRNGKey(1), jbase, jlora.LoRAConfig(rank=RANK))
    rng = np.random.default_rng(2)  # b = 0 at init zeroes every a-gradient: give b values
    np_lora = {"layers": {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.05 if k.endswith("_b")
                              else np.asarray(v, np.float32)) for k, v in adapters["layers"].items()}}
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jbase=jbase, tbase=tbase, np_lora=np_lora, tokens=tokens,
                scale=jlora.LoRAConfig(rank=RANK).scale)


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_qlora_adapter_grads_match_jax(qlora, attn_impl):
    m = qlora
    mask = np.ones_like(m["tokens"], np.float32)

    def jloss(lora):
        logits = jllama.forward(m["jbase"], m["tokens"], m["jcfg"], attn_impl="xla", lora=lora,
                                lora_scale=m["scale"])
        return jtrainer.cross_entropy_loss(logits[:, :-1], m["tokens"][:, 1:], mask[:, 1:])

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, m["np_lora"]))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tlora.lora_from_jax(m["np_lora"], device="cpu")
              ["layers"].items()}
    t = torch.from_numpy(m["tokens"]).long()
    logits = tllama.forward(m["tbase"], t, m["tcfg"], attn_impl=attn_impl, lora={"layers": leaves},
                            lora_scale=m["scale"])
    loss = cross_entropy_loss(logits[:, :-1], t[:, 1:], torch.from_numpy(mask)[:, 1:])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=F32_TOL)
    for k, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg["layers"][k]), err_msg=k, **GRAD_TOL)
        assert v.grad.abs().max() > 0, k


def test_init_lora_over_an_int4_base_is_real_valued(qlora):
    """QLoRA: adapters over the packed base take f32 and the base's logical
    shapes, as the reference's ``init_lora`` does over ``jnp.int4``."""
    jl = jlora.init_lora(jax.random.PRNGKey(1), qlora["jbase"], jlora.LoRAConfig(rank=RANK))["layers"]
    tl = tlora.init_lora(torch.Generator().manual_seed(1), qlora["tbase"], tlora.LoRAConfig(rank=RANK))["layers"]
    assert tl.keys() == jl.keys()
    for k, v in tl.items():
        assert v.dtype == torch.float32 and tuple(v.shape) == jl[k].shape, k
        assert (v.abs().max() == 0) if k.endswith("_b") else (0.06 < v.std().item() < 0.2), k
