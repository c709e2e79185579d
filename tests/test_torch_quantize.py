"""The port's int8 weights and int8 matmul against the JAX package's.

``quantize_weight``/``quantize_llama``/``quantize_int8`` must give bitwise the
JAX int8 values and f32 scales (same IEEE divisions, round half to even).
The matmul's plain version and ``layers.mm`` over a ``QuantizedWeight`` are
held to the JAX functions in f32 at rtol 1e-5 (the products are the same,
only the f32 summation order differs); the JAX ``quantized_matmul`` runs in
interpret mode as its own CPU tests run it, at a shape that tiles (two K
steps) and one that takes its XLA fallback. The CUDA kernel itself runs only
on the card (the ``gpu``-marked test; ``chip_smoke.py`` at full size).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import layers as jlayers
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.models import quantize as jquant
from modal_examples_tpu_torch import LLMEngine
from modal_examples_tpu_torch.models import layers as tlayers
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.models import quantize as tquant
from modal_examples_tpu_torch.ops import quantized_matmul as tqmm
from test_torch_time_limit import share_cores

share_cores()

# the JAX package's ops/__init__ re-exports functions under their modules' names
jqmm = importlib.import_module("modal_examples_tpu.ops.quantized_matmul")

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _weight(seed, shape):
    """Random weights of mixed magnitude with an all-zero output column."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * rng.choice([1e-3, 0.1, 3.0], shape[-1]).astype(np.float32)
    w[..., 5] = 0.0
    return w


def _assert_same(port: tquant.QuantizedWeight, ref):
    assert port.q.dtype == torch.int8 and port.scale.dtype == torch.float32
    np.testing.assert_array_equal(port.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(port.scale.numpy(), np.asarray(ref.scale))


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_weight_is_bitwise_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    w = _weight(0, (96, 40))
    ref = jquant.quantize_weight(jnp.asarray(w, jdt))
    port = tquant.quantize_weight(torch.from_numpy(w).to(tdt))
    _assert_same(port, ref)
    assert (port.scale[0, 5] == 1.0).item() and not port.q[:, 5].any()  # the zero column
    np.testing.assert_array_equal(
        tquant.dequantize_weight(port, torch.float32).numpy(),
        np.asarray(jquant.dequantize_weight(ref, jnp.float32)),
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_int8_is_bitwise_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    w = _weight(1, (64, 48))
    jq, js = jqmm.quantize_int8(jnp.asarray(w, jdt))
    tq, ts = tqmm.quantize_int8(torch.from_numpy(w).to(tdt))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tqmm.dequantize_int8(tq, ts).numpy(), np.asarray(jqmm.dequantize_int8(jq, js)))


@pytest.fixture(scope="module", params=list(DTYPES))
def quantized_trees(request):
    """The tiny llama in the given dtype: the JAX tree quantized by JAX, and
    the same weights through ``params_from_jax`` quantized by the port."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=request.param)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=request.param)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    tparams = tllama.params_from_jax(np_params, tcfg, device="cpu")
    return tcfg, jquant.quantize_llama(jparams), tquant.quantize_llama(tparams), tparams


def test_quantize_llama_is_bitwise_jax(quantized_trees):
    tcfg, jq, tq, tparams = quantized_trees
    for li, layer in enumerate(tq["layers"]):
        for name in tllama._LAYER_KEYS:
            ref = jq["layers"][name]
            if name in tquant.LLAMA_TARGETS:
                _assert_same(layer[name], jquant.QuantizedWeight(q=ref.q[li], scale=ref.scale[li]))
            else:  # norms stay in the model dtype, untouched
                assert layer[name] is tparams["layers"][li][name]
    _assert_same(tq["lm_head"], jq["lm_head"])
    assert tq["embed"] is tparams["embed"] and tq["embed"].dtype == tcfg.torch_dtype
    assert isinstance(tparams["layers"][0]["wq"], torch.Tensor)  # the input is not changed


def test_param_bytes_equal_jax(quantized_trees):
    _, jq, tq, tparams = quantized_trees
    assert tquant.param_bytes(tq) == jquant.param_bytes(jq)
    assert tquant.param_bytes(tq) < tquant.param_bytes(tparams)


def test_params_from_jax_takes_the_quantized_tree(quantized_trees):
    tcfg, jq, tq, _ = quantized_trees
    from_jax = tllama.params_from_jax(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    for li in range(tcfg.n_layers):
        for name in ("wq", "down"):
            np.testing.assert_array_equal(from_jax["layers"][li][name].q.numpy(), tq["layers"][li][name].q.numpy())
            np.testing.assert_array_equal(
                from_jax["layers"][li][name].scale.numpy(), tq["layers"][li][name].scale.numpy()
            )
    assert tquant.param_bytes(from_jax) == tquant.param_bytes(tq)


def test_init_quantized_llama_equals_quantize_of_init():
    cfg = tllama.LlamaConfig.tiny()
    fused = tquant.init_quantized_llama(cfg, seed=3, device="cpu")
    ref = tquant.quantize_llama(tllama.init_params(cfg, seed=3, device="cpu"))
    for a, b in zip(tquant.tree.leaves(fused), tquant.tree.leaves(ref)):
        assert torch.equal(a, b)
    assert isinstance(fused["lm_head"], tquant.QuantizedWeight)


def _qmm_inputs(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # values bf16 holds exactly
    wq, ws = jqmm.quantize_int8(jnp.asarray(_weight(seed + 1, (K, N))))
    return x, np.asarray(wq), np.asarray(ws)


@pytest.mark.parametrize("M,K,N", [(8, 1024, 256), (8, 1000, 200)], ids=["tiles-two-k-steps", "xla-fallback"])
def test_quantized_matmul_matches_jax(M, K, N):
    x, wq, ws = _qmm_inputs(2, M, K, N)
    ref = np.asarray(jqmm.quantized_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), interpret=True))
    tx, twq, tws = torch.tensor(x), torch.tensor(wq), torch.tensor(ws)
    tol = dict(rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(tqmm.quantized_matmul(tx, twq, tws).numpy(), ref, **tol)
    np.testing.assert_allclose(tqmm.qmm_plain(tx.bfloat16(), twq, tws).numpy(), ref, **tol)
    out = tqmm.quantized_matmul(tx.bfloat16(), twq, tws)
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)


def test_mm_over_quantized_weight_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 96)).astype(np.float32)
    w = _weight(5, (96, 40))
    jw = jquant.quantize_weight(jnp.asarray(w))
    tw = tquant.quantize_weight(torch.from_numpy(w))
    ref = np.asarray(jlayers.mm(jnp.asarray(x), jw))
    out = tlayers.mm(torch.from_numpy(x), tw)
    assert out.dtype == torch.float32 and out.shape == (2, 5, 40)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_quantized_mm_is_forward_only():
    """Named for the product before the int8 LoRA base landed: ``mm`` over a
    ``QuantizedWeight`` now takes a gradient in x (``dX = (dY * scale) @
    q^T``; ``tests/test_torch_lora_int8.py`` holds it against JAX) and its
    forward is the same with or without one."""
    tw = tquant.quantize_weight(torch.from_numpy(_weight(6, (32, 16))))
    x = torch.randn(3, 32, requires_grad=True)
    y = tlayers.mm(x, tw)
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), (torch.ones(3, 16) * tw.scale).float() @ tw.q.float().T)
    with torch.no_grad():
        assert torch.equal(tlayers.mm(x, tw), y.detach()) and y.shape == (3, 16)


def test_int4_and_unknown_modes_raise():
    w = torch.from_numpy(_weight(7, (32, 16)))
    with pytest.raises(NotImplementedError, match="A2"):
        tquant.quantize_weight(w, bits=4)
    cfg = tllama.LlamaConfig.tiny()
    with pytest.raises(NotImplementedError, match="A2"):
        LLMEngine(cfg, quantization="int4", device="cpu", max_slots=2, max_model_len=64)
    with pytest.raises(ValueError, match="unknown quantization"):
        LLMEngine(cfg, quantization="int3", device="cpu", max_slots=2, max_model_len=64)
    eng = LLMEngine(cfg, quantization="int8", device="cpu", max_slots=2, max_model_len=64)
    assert eng.impl_plan["weights"] == "int8" and isinstance(eng.params["layers"][1]["up"], tquant.QuantizedWeight)


def test_kernel_wrapper_refuses_cpu_tensors():
    before = tqmm.qmm_launches
    x = torch.zeros(4, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tqmm.qmm_cuda(x, torch.zeros(32, 16, dtype=torch.int8), torch.ones(1, 16))
    assert tqmm.qmm_launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 64, 65, 300, 2048])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000), (4000, 11000), (512, 384)])
def test_quantized_matmul_kernel_matches_plain_on_card(M, K, N):
    """Run on the card (``python3 chip_smoke.py`` covers the path's shapes):
    one launch on the path the shape picks (TMA ones where N % 16 == 0),
    within 1e-3 of the plain version's largest value, the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
    qw = tquant.quantize_weight(torch.randn(K, N, generator=g, device="cuda"))
    assert tqmm.kernel_path(x, qw.q) == ("mma.sync" if N % 16 else "ring" if M <= 64 else "wgmma")
    before = tqmm.qmm_launches
    out = tqmm.qmm_cuda(x, qw.q, qw.scale)
    torch.cuda.synchronize()
    want = tqmm.qmm_plain(x, qw.q, qw.scale)
    assert tqmm.qmm_launches == before + 1
    assert ((out - want).abs().max() / want.abs().max()).item() < 1e-3
    assert torch.equal(out, tqmm.qmm_cuda(x, qw.q, qw.scale))


@pytest.mark.gpu
def test_int8_mm_backward_on_card():
    """The int8 LoRA base's product on the card: the forward is one K7
    launch, within 1e-3 of the plain version's largest value, and the
    backward is the closed form ``(dY * scale) @ q^T`` in bf16 within 1e-2
    (``chip_smoke.py`` phase 12 runs it at 7B; ``test_torch_lora_int8.py``
    holds it against JAX on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    w = tquant.quantize_weight(torch.randn(512, 384, generator=g, device="cuda"))
    x = torch.randn(64, 512, generator=g, device="cuda").bfloat16().requires_grad_(True)
    before = tqmm.qmm_launches
    y = tlayers.mm(x, w)
    assert tqmm.qmm_launches == before + 1
    want = tqmm.qmm_plain(x.detach(), w.q, w.scale)
    assert ((y.detach() - want).abs().max() / want.abs().max()).item() < 1e-3
    dy = torch.randn(64, 384, generator=g, device="cuda")
    y.backward(dy)
    ref = (dy * w.scale).bfloat16() @ w.q.bfloat16().T
    assert ((x.grad.float() - ref.float()).abs().max() / ref.float().abs().max()).item() < 1e-2
