"""LoRA on an int8 base: the port's ``layers.mm`` over a ``QuantizedWeight``
is differentiable in ``x``, as the JAX ``mm`` (a plain dot over
``q.astype(x.dtype)`` times the scale) is, so adapters train against a
frozen int8 Llama (``bench.py``'s int8 LoRA step).

The JAX base is ``init_quantized_llama(key, cfg, bits=8)`` on the tiny f32
config (GQA, head dim 32); the port gets the same int8 values and scales
through ``params_from_jax``. Tolerances are ``test_torch_training.py``'s:
losses, adapter gradients and grad norms within rtol 1e-4 (atol 1e-6 for
entries near zero); adapters after optimizer steps within rtol 1e-4 and
atol 1e-3 x lr for 99.9% of the entries and atol lr / 10 for every entry:
Adam's normalised step turns GRAD_TOL's 1e-6 on a gradient of a few 1e-5
whose sign flips between the steps into a few percent of lr (the int8 base
has two such entries in ``down_a`` and one near eps in ``wq_a``). The closed form of the backward, ``dX = (dY * scale) @
q^T``, holds exactly in f32 and to one bf16 rounding in bf16.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.models import lora as jlora
from modal_examples_tpu.models import quantize as jquant
from modal_examples_tpu.training import trainer as jtrainer
from modal_examples_tpu_torch.models import layers as tlayers
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.models import lora as tlora
from modal_examples_tpu_torch.models import quantize as tquant
from modal_examples_tpu_torch.ops import quantized_matmul as tqmm
from modal_examples_tpu_torch.training import Trainer, cross_entropy_loss, make_optimizer
from test_torch_time_limit import share_cores

share_cores()

B, S = 2, 32
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LR = 1e-2
ADAPTER_TOL = dict(rtol=1e-4, atol=1e-3 * LR)
RANK = 16


def _weight(k=96, n=80, seed=0):
    rng = np.random.default_rng(seed)
    return tquant.quantize_weight(torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_mm_backward_is_the_closed_form(dtype):
    """``mm`` over an int8 weight takes a gradient in x and gives none to
    ``q`` or ``scale``; ``dX = (dY * scale) @ q^T`` in x's dtype."""
    w = _weight()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 96)).astype(np.float32)).to(dtype).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal((2, 5, 80)).astype(np.float32))
    y = tlayers.mm(x, w)
    assert y.dtype == torch.float32 and y.shape == (2, 5, 80)
    np.testing.assert_array_equal(y.detach().numpy(), tqmm.qmm_plain(x.detach().reshape(10, 96), w.q, w.scale)
                                  .reshape(2, 5, 80).numpy())
    (y * dy).sum().backward()
    want = ((dy * w.scale).to(dtype) @ w.q.to(dtype).T)
    assert x.grad.dtype == dtype
    np.testing.assert_array_equal(x.grad.float().numpy(), want.float().numpy())
    assert not w.q.requires_grad and not w.scale.requires_grad


def test_int8_mm_backward_matches_jax_vjp():
    w = _weight(seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((7, 96)).astype(np.float32)
    dy = rng.standard_normal((7, 80)).astype(np.float32)
    jw = jquant.QuantizedWeight(q=jnp.asarray(w.q.numpy()), scale=jnp.asarray(w.scale.numpy()))
    from modal_examples_tpu.models import layers as jlayers

    _, vjp = jax.vjp(lambda a: jlayers.mm(a, jw), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    tlayers.mm(xt, w).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_int8_mm_without_grad_is_the_plain_product():
    w = _weight(seed=5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 96)).astype(np.float32))
    with torch.no_grad():
        got = tlayers.mm(x, w)
    np.testing.assert_array_equal(got.numpy(), tqmm.qmm_plain(x, w.q, w.scale).numpy())


def test_promoted_mm_saves_bf16_inputs_and_matches_the_jax_vjp():
    """A bf16 x f32 product (an f32 adapter over bf16 activations) is f32,
    its VJP the reference's (``jnp.dot`` promotes x), and autograd keeps the
    bf16 ``x`` itself for the backward, not an f32 copy of it."""
    from modal_examples_tpu.models import layers as jlayers

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 96)).astype(np.float32)
    a = rng.standard_normal((96, RANK)).astype(np.float32)
    dy = rng.standard_normal((2, 5, RANK)).astype(np.float32)
    jy, vjp = jax.vjp(jlayers.mm, jnp.asarray(x, jnp.bfloat16), jnp.asarray(a))
    jdx, jda = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    at = torch.from_numpy(a).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = tlayers.mm(xt, at)
    assert y.dtype == torch.float32 and y.shape == (2, 5, RANK)
    assert sorted(str(t.dtype) for t in saved) == ["torch.bfloat16", "torch.float32"]
    assert [tuple(t.shape) for t in saved if t.dtype == torch.float32] == [(96, RANK)]  # the adapter only
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    y.backward(torch.from_numpy(dy))
    assert xt.grad.dtype == torch.bfloat16 and at.grad.dtype == torch.float32
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(jda), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(jdx, np.float32), rtol=1e-2, atol=1e-2)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jbase = jquant.init_quantized_llama(jax.random.PRNGKey(0), jcfg, bits=8)
    tbase = tllama.params_from_jax(jax.tree.map(np.asarray, jbase), tcfg, device="cpu")
    assert all(isinstance(tbase["layers"][0][k], tquant.QuantizedWeight) for k in tlora.DEFAULT_TARGETS)
    jl = jlora.LoRAConfig(rank=RANK)
    adapters = jlora.init_lora(jax.random.PRNGKey(1), jbase, jl)
    # b = 0 at init makes every a-gradient zero; give b values so both move
    rng = np.random.default_rng(2)
    np_lora = {"layers": {
        k: (rng.standard_normal(v.shape).astype(np.float32) * 0.05 if k.endswith("_b") else np.asarray(v, np.float32))
        for k, v in adapters["layers"].items()
    }}
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jbase=jbase, tbase=tbase, lcfg=tlora.LoRAConfig(rank=RANK),
                np_lora=np_lora, batch={"tokens": tokens, "mask": mask})


def _jloss(m):
    def loss(lora, batch):
        logits = jllama.forward(m["jbase"], batch["tokens"], m["jcfg"], attn_impl="xla",
                                lora=lora, lora_scale=m["lcfg"].scale)
        return jtrainer.cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:], batch["mask"][:, 1:])
    return loss


def _tloss(m, attn_impl):
    def loss(lora, batch):
        logits = tllama.forward(m["tbase"], batch["tokens"], m["tcfg"], attn_impl=attn_impl,
                                lora=lora, lora_scale=m["lcfg"].scale)
        return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:], batch["mask"][:, 1:])
    return loss


def _tbatch(m):
    return {k: torch.from_numpy(v) for k, v in m["batch"].items()}


def _assert_tree_close(port: dict, ref: dict, **tol):
    assert port.keys() == ref.keys()
    for k in port:
        np.testing.assert_allclose(port[k].detach().numpy(), np.asarray(ref[k]), err_msg=k, **tol)


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_adapter_grads_through_the_int8_base_match_jax(model, attn_impl):
    """``bench.py``'s int8 LoRA loss (rank 16, the shifted tokens) and its
    adapter gradients, against ``jax.value_and_grad`` of the JAX step."""
    jloss, jgrads = jax.value_and_grad(_jloss(model))(jax.tree.map(jnp.asarray, model["np_lora"]), model["batch"])
    tl = tlora.lora_from_jax(model["np_lora"], device="cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in tl["layers"].items()}
    tloss = _tloss(model, attn_impl)({"layers": leaves}, _tbatch(model))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    _assert_tree_close({k: v.grad for k, v in leaves.items()}, jgrads["layers"], **GRAD_TOL)
    assert all(v.grad.abs().max() > 0 for v in leaves.values())
    # the frozen base took no gradient
    assert not any(t.requires_grad for layer in model["tbase"]["layers"] for w in layer.values()
                   for t in ((w.q, w.scale) if isinstance(w, tquant.QuantizedWeight) else (w,)))


def test_two_trainer_steps_on_the_int8_base_match_jax(model):
    jt = jtrainer.Trainer(_jloss(model), jtrainer.make_optimizer(LR))
    tt = Trainer(_tloss(model, "flash"), make_optimizer(LR))
    jstate = jt.init_state(jax.tree.map(jnp.asarray, model["np_lora"]))
    tstate = tt.init_state(tlora.lora_from_jax(model["np_lora"], device="cpu"))
    for step in range(2):
        jstate, jm = jt.train_step(jstate, model["batch"])
        tstate, tm = tt.train_step(tstate, _tbatch(model))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4, err_msg=f"step {step}")
        _assert_tree_close(tstate.params["layers"], jstate.params["layers"], rtol=1e-4, atol=LR / 10)
        outside = total = 0
        for k, ref in jstate.params["layers"].items():
            got, ref = tstate.params["layers"][k].numpy(), np.asarray(ref)
            outside += int((np.abs(got - ref) > ADAPTER_TOL["atol"] + ADAPTER_TOL["rtol"] * np.abs(ref)).sum())
            total += ref.size
        assert outside <= 1e-3 * total, (step, outside, total)
    assert tstate.step == int(jstate.step) == 2


def test_init_lora_over_an_int8_base_is_real_valued(model):
    """Adapters over a quantized base take the scale's dtype (f32), as the
    reference's ``init_lora`` gives them, with its shapes and b = 0."""
    jl = jlora.init_lora(jax.random.PRNGKey(1), model["jbase"], jlora.LoRAConfig(rank=RANK))["layers"]
    tl = tlora.init_lora(torch.Generator().manual_seed(1), model["tbase"], tlora.LoRAConfig(rank=RANK))["layers"]
    assert tl.keys() == jl.keys()
    for k, v in tl.items():
        assert v.dtype == torch.float32 and np.asarray(jl[k]).dtype == np.float32, k
        assert tuple(v.shape) == jl[k].shape, k
        if k.endswith("_b"):
            assert v.abs().max() == 0
        else:
            assert 0.03 < v.std().item() < 0.1  # N(0, 1) / rank


def test_bf16_activations_over_the_int8_base_match_jax():
    """``bench.py``'s mixed case: a bf16 model over an int8 base with f32
    adapters. The f32 adapter products promote as ``jnp.dot`` does; the
    int8 products round the cotangent to bf16 before ``q^T``. Held to the
    reference at bf16's resolution: the loss within 1e-2 relative, each
    adapter gradient at cosine >= 0.999."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    assert jcfg.dtype == "bfloat16" and tcfg.torch_dtype == torch.bfloat16
    jbase = jquant.init_quantized_llama(jax.random.PRNGKey(0), jcfg, bits=8)
    tbase = tllama.params_from_jax(jax.tree.map(np.asarray, jbase), tcfg, device="cpu")
    adapters = jlora.init_lora(jax.random.PRNGKey(1), jbase, jlora.LoRAConfig(rank=RANK))
    rng = np.random.default_rng(2)
    np_lora = {"layers": {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.05 if k.endswith("_b")
                              else np.asarray(v, np.float32)) for k, v in adapters["layers"].items()}}
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    scale = tlora.LoRAConfig(rank=RANK).scale

    def jloss(lora):
        logits = jllama.forward(jbase, tokens, jcfg, attn_impl="xla", lora=lora, lora_scale=scale)
        return jtrainer.cross_entropy_loss(logits[:, :-1], tokens[:, 1:], mask[:, 1:])

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, np_lora))
    leaves = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in np_lora["layers"].items()}
    t = torch.from_numpy(tokens)
    logits = tllama.forward(tbase, t, tcfg, attn_impl="flash", lora={"layers": leaves}, lora_scale=scale)
    tl = cross_entropy_loss(logits[:, :-1], t[:, 1:], torch.from_numpy(mask)[:, 1:])
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-2)
    for k, v in leaves.items():
        want = np.asarray(jg["layers"][k], np.float64).ravel()
        got = v.grad.double().numpy().ravel()
        assert v.grad.dtype == torch.float32
        cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
        assert cos >= 0.999, (k, cos)
