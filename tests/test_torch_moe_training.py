"""Training through the capacity-routed experts against the JAX package, on
the CPU.

- ``moe.CapacityExperts`` (the expert products with a memory plan: one
  expert's f32 matrices at a time, nothing widened saved) inside
  ``moe_swiglu_capacity``: its value and its VJP against the JAX
  ``moe_swiglu_capacity`` under ``jax.vjp`` (the cotangent of the output and
  of the aux loss; gradients in ``x``, the router and, for f32 stacks, the
  stacks), over f32, int8 and int4 stacks (int4 packed two rows a byte, the
  same values as JAX's ``jnp.int4``), at a capacity factor that keeps every
  token and at one that drops tokens: within 1e-5 of each result's largest
  value. The Function also against the unplanned formula
  (``capacity_experts_plain``) under autograd.
- One attention-only LoRA step (rank 16, ``wq/wk/wv/wo``) over the tiny
  Mixtral-shape config with an int8 and an int4 base, the loss of the
  reference's MoE tests (cross entropy + 0.01 x aux from
  ``forward(moe_impl="capacity", return_aux=True)``): loss, aux and every
  adapter gradient against ``jax.value_and_grad`` of the same loss over the
  same JAX adapters, within 1e-5 of the largest value; then one
  ``Trainer`` step of each, losses within 1e-5.
- The saved tensors of that step (``torch.autograd.graph.saved_tensors_hooks``):
  no floating tensor of an expert stack's shape or of one expert's matrix is
  saved, while the unplanned formula saves the three widened stacks.
- The port copy of the reference's full-parameter MoE training test
  (``tests/test_moe.py::test_moe_llama_trains``), with the reference's
  no-drop path and with the capacity path: eight ``Trainer`` steps over the
  f32 tree lower the loss; the capacity path's first gradient of every
  leaf against ``jax.grad`` of the reference's loss at 1e-5.

The card runs the same step at Mixtral-8x7B width (``python3 chip_smoke.py``
phase 18).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.models import lora as jlora
from modal_examples_tpu.models import moe as jmoe
from modal_examples_tpu.models import quantize as jquant
from modal_examples_tpu.training import trainer as jtrainer
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.models import lora as tlora
from modal_examples_tpu_torch.models import moe as tmoe
from modal_examples_tpu_torch.models import quantize as tquant
from modal_examples_tpu_torch.training import Trainer, cross_entropy_loss, make_optimizer
from modal_examples_tpu_torch.utils import tree
from test_torch_time_limit import share_cores

share_cores()

TOL = 1e-5  # of each result's largest value
E, D, F, T, K = 8, 32, 64, 64, 2
AUX_WEIGHT = 0.01  # the reference tests' loss: cross entropy + 0.01 x aux
TARGETS = ("wq", "wk", "wv", "wo")


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def experts():
    rng = np.random.default_rng(0)
    return dict(
        router=rng.standard_normal((D, E)).astype(np.float32) * D**-0.5,
        w_gate=rng.standard_normal((E, D, F)).astype(np.float32) * D**-0.5,
        w_up=rng.standard_normal((E, D, F)).astype(np.float32) * D**-0.5,
        w_down=rng.standard_normal((E, F, D)).astype(np.float32) * F**-0.5,
        x=rng.standard_normal((T, D)).astype(np.float32),
        dy=rng.standard_normal((T, D)).astype(np.float32),
        daux=np.float32(rng.standard_normal()),
    )


def _stacks(c, weights):
    """(JAX stacks, port stacks) of one dtype: f32, or int8/int4 quantized on
    each side from the same f32 values (bitwise equal quantizations,
    ``tests/test_torch_int4.py``, ``test_torch_quantize.py``)."""
    names = ("w_gate", "w_up", "w_down")
    if weights == "float32":
        return [jnp.asarray(c[n]) for n in names], [_t(c[n]) for n in names]
    bits = 8 if weights == "int8" else 4
    return ([jquant.quantize_weight(jnp.asarray(c[n]), bits=bits) for n in names],
            [tquant.quantize_weight(_t(c[n]), bits=bits) for n in names])


# -- (a) the capacity experts' Function against the JAX function -----------------------


@pytest.mark.parametrize("factor", [1.5, 0.25], ids=["keeps-all", "drops"])
@pytest.mark.parametrize("weights", ["float32", "int8", "int4"])
def test_capacity_experts_value_and_vjp_match_jax(experts, weights, factor):
    c = experts
    jw, tw = _stacks(c, weights)
    wrt_stacks = weights == "float32"

    def jfn(x, router, *stacks):
        return jmoe.moe_swiglu_capacity(router, *(stacks if wrt_stacks else jw), x, K, factor)

    primals = (jnp.asarray(c["x"]), jnp.asarray(c["router"]), *(jw if wrt_stacks else ()))
    (jout, jaux), vjp = jax.vjp(jfn, *primals)
    jgrads = vjp((jnp.asarray(c["dy"]), jnp.asarray(c["daux"])))

    x, router = _t(c["x"]).requires_grad_(True), _t(c["router"]).requires_grad_(True)
    stacks = [w.clone().requires_grad_(True) for w in tw] if wrt_stacks else tw
    tout, taux = tmoe.moe_swiglu_capacity(router, *stacks, x, K, factor)
    _close(tout, jout, what="out")
    _close(taux, jaux, what="aux")
    torch.autograd.backward((tout, taux), (_t(c["dy"]), torch.tensor(float(c["daux"]))))
    got = [x.grad, router.grad] + ([w.grad for w in stacks] if wrt_stacks else [])
    for name, g, want in zip(("x", "router", "w_gate", "w_up", "w_down"), got, jgrads):
        assert g is not None and g.abs().max() > 0, name
        _close(g, want, what=name)
    if factor == 0.25:  # the capacity drops tokens at this factor
        cfg = tmoe.MoEConfig(n_experts=E, top_k=K, capacity_factor=factor, d_model=D, d_ff=F)
        dispatch, _, _ = tmoe._route(_t(c["x"]), _t(c["router"]), cfg, cfg.capacity(T))
        assert dispatch.sum() < T * K


@pytest.mark.parametrize("weights", ["float32", "int8", "int4"])
def test_capacity_experts_function_matches_the_unplanned_formula(experts, weights):
    """The Function's output and its gradients in ``expert_in`` (and in f32
    stacks) against autograd through ``capacity_experts_plain``."""
    c = experts
    _, tw = _stacks(c, weights)
    rng = np.random.default_rng(1)
    expert_in = _t(rng.standard_normal((E, 12, D)))
    g = _t(rng.standard_normal((E, 12, D)))
    results = []
    for fn in (tmoe.CapacityExperts.apply, tmoe.capacity_experts_plain):
        xin = expert_in.clone().requires_grad_(True)
        ws = [w.clone().requires_grad_(True) for w in tw] if weights == "float32" else tw
        out = fn(xin, *ws)
        out.backward(g)
        results.append([out, xin.grad] + ([w.grad for w in ws] if weights == "float32" else []))
    for got, want in zip(*results):
        _close(got, want.detach().numpy())


# -- (b) an attention-only LoRA step over a quantized tiny Mixtral ---------------------


def _model(bits: int):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny_moe(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny_moe(), dtype="float32")
    jbase = jquant.quantize_llama(jllama.init_params(jax.random.PRNGKey(0), jcfg), bits=bits)
    tbase = tllama.params_from_jax(jax.tree.map(np.asarray, jbase), tcfg, device="cpu")
    lcfg = jlora.LoRAConfig(rank=16, targets=TARGETS)
    adapters = jlora.init_lora(jax.random.PRNGKey(1), jbase, lcfg)
    rng = np.random.default_rng(2)  # b = 0 at init makes every a-gradient zero: give b values
    np_lora = {"layers": {
        k: (rng.standard_normal(v.shape).astype(np.float32) * 0.05 if k.endswith("_b") else np.asarray(v, np.float32))
        for k, v in adapters["layers"].items()
    }}
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jbase=jbase, tbase=tbase, scale=lcfg.scale, np_lora=np_lora, tokens=tokens)


@pytest.fixture(scope="module", params=[8, 4], ids=["int8", "int4"])
def moe_lora(request):
    return _model(request.param)


def _jloss(m, with_aux=False):
    def loss(lora, tokens):
        lg, aux = jllama.forward(m["jbase"], tokens, m["jcfg"], attn_impl="xla", lora=lora, lora_scale=m["scale"],
                                 moe_impl="capacity", return_aux=True)
        total = jtrainer.cross_entropy_loss(lg[:, :-1], tokens[:, 1:]) + AUX_WEIGHT * aux
        return (total, aux) if with_aux else total
    return loss


def _tloss(m, aux_out=None):
    def loss(lora, batch):
        tokens = batch["tokens"]
        lg, aux = tllama.forward(m["tbase"], tokens, m["tcfg"], attn_impl="flash", lora=lora, lora_scale=m["scale"],
                                 moe_impl="capacity", return_aux=True)
        if aux_out is not None:
            aux_out.append(aux.detach())
        return cross_entropy_loss(lg[:, :-1], tokens[:, 1:]) + AUX_WEIGHT * aux
    return loss


def test_lora_step_over_a_quantized_moe_base_matches_jax(moe_lora):
    m = moe_lora
    tokens = jnp.asarray(m["tokens"])
    (jl, jaux), jg = jax.value_and_grad(_jloss(m, with_aux=True), has_aux=True)(
        jax.tree.map(jnp.asarray, m["np_lora"]), tokens)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tlora.lora_from_jax(m["np_lora"], device="cpu")["layers"]
              .items()}
    auxes = []
    tl = _tloss(m, auxes)({"layers": leaves}, {"tokens": torch.from_numpy(m["tokens"]).long()})
    tl.backward()
    _close(tl, jl, what="loss")
    _close(auxes[0], jaux, what="aux")
    assert float(auxes[0]) > 0
    assert sorted(leaves) == sorted(f"{t}_{ab}" for t in TARGETS for ab in "ab")
    for k, v in leaves.items():
        assert v.grad is not None and v.grad.abs().max() > 0, k
        _close(v.grad, jg["layers"][k], what=k)
    # the frozen base took no gradient
    assert not any(t.requires_grad for t in tree.leaves(m["tbase"]))


def test_trainer_step_over_a_quantized_moe_base_matches_jax(moe_lora):
    m = moe_lora
    jt = jtrainer.Trainer(lambda p, b: _jloss(m)(p, b["tokens"]), jtrainer.make_optimizer(1e-2))
    tt = Trainer(_tloss(m), make_optimizer(1e-2))
    js, jm = jt.train_step(jt.init_state(jax.tree.map(jnp.asarray, m["np_lora"])), {"tokens": jnp.asarray(m["tokens"])})
    ts, tm = tt.train_step(tt.init_state(tlora.lora_from_jax(m["np_lora"], device="cpu")),
                           {"tokens": torch.from_numpy(m["tokens"]).long()})
    _close(tm["loss"], jm["loss"], what="loss")
    _close(tm["grad_norm"], jm["grad_norm"], what="grad_norm")
    assert ts.step == 1


# -- (c) what the step saves for its backward --------------------------------------------


def _saved_during(fn):
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        out = fn()
    return out, saved


def _widened_shapes(cfg):
    Dm, Fm, Em = cfg.dim, cfg.ffn_dim, cfg.n_experts
    return {(Em, Dm, Fm), (Em, Fm, Dm), (Dm, Fm), (Fm, Dm)}


def test_lora_step_saves_no_widened_expert_matrix(moe_lora):
    """No floating tensor shaped like an expert stack or one expert's matrix
    is saved for the backward; the unplanned formula, swapped in, saves the
    three widened stacks of each layer (the hook sees them)."""
    m = moe_lora
    leaves = {k: v.clone().requires_grad_(True) for k, v in tlora.lora_from_jax(m["np_lora"], device="cpu")["layers"]
              .items()}
    batch = {"tokens": torch.from_numpy(m["tokens"]).long()}
    shapes = _widened_shapes(m["tcfg"])

    def widened(saved):
        return [tuple(t.shape) for t in saved if t.is_floating_point() and tuple(t.shape) in shapes]

    loss, saved = _saved_during(lambda: _tloss(m)({"layers": leaves}, batch))
    assert widened(saved) == []
    loss.backward()
    assert all(v.grad is not None for v in leaves.values())

    apply = tmoe.CapacityExperts.apply
    try:
        tmoe.CapacityExperts.apply = tmoe.capacity_experts_plain
        _, saved = _saved_during(lambda: _tloss(m)({"layers": leaves}, batch))
    finally:
        tmoe.CapacityExperts.apply = apply
    cfg = m["tcfg"]
    assert sorted(widened(saved)) == sorted([(cfg.n_experts, cfg.dim, cfg.ffn_dim)] * 2 * cfg.n_layers
                                            + [(cfg.n_experts, cfg.ffn_dim, cfg.dim)] * cfg.n_layers)


@pytest.mark.parametrize("weights", ["int8", "int4", "bfloat16"])
def test_capacity_experts_save_their_input_and_the_stacks_as_held(experts, weights):
    """The Function saves ``expert_in`` and, of the stacks, the tensors it
    was given (bf16 here: no f32 copy); a quantized stack rides on the
    context as it is held and reaches no hook."""
    c = experts
    if weights == "bfloat16":
        tw = [_t(c[n]).to(torch.bfloat16) for n in ("w_gate", "w_up", "w_down")]
    else:
        _, tw = _stacks(c, weights)
    xin = _t(np.random.default_rng(4).standard_normal((E, 12, D))).requires_grad_(True)
    out, saved = _saved_during(lambda: tmoe.CapacityExperts.apply(xin, *tw))
    held = tw if weights == "bfloat16" else []
    assert len(saved) == 1 + len(held) and all(a is b for a, b in zip(saved, [xin, *held]))
    out.sum().backward()
    assert xin.grad.shape == xin.shape


# -- (d) the reference's full-parameter MoE training test, ported ------------------------


REF_CFG = dict(vocab_size=64, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64, max_seq_len=64,
               dtype="float32", n_experts=4, top_k_experts=2)


@pytest.mark.parametrize("moe_impl", ["nodrop", "capacity"])
def test_moe_llama_trains(moe_impl):
    """``tests/test_moe.py::test_moe_llama_trains`` over the port, with the
    reference's weights: forward with aux, then eight Trainer steps of
    cross entropy + 0.01 x aux lower the loss. On the capacity path the
    first gradient of every leaf (the f32 expert stacks through
    ``CapacityExperts``) matches ``jax.grad`` of the reference's loss."""
    jcfg, tcfg = jllama.LlamaConfig(**REF_CFG), tllama.LlamaConfig(**REF_CFG)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    params = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tokens_np = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0, 64))
    tokens = torch.from_numpy(tokens_np).long()
    logits, aux = tllama.forward(params, tokens, tcfg, attn_impl="xla", return_aux=True, moe_impl=moe_impl)
    assert logits.shape == (2, 32, 64) and float(aux) > 0

    def loss_fn(p, batch):
        lg, a = tllama.forward(p, batch["tokens"], tcfg, attn_impl="xla", return_aux=True, moe_impl=moe_impl)
        return cross_entropy_loss(lg[:, :-1], batch["tokens"][:, 1:]) + AUX_WEIGHT * a

    if moe_impl == "capacity":
        def jloss(p):
            lg, a = jllama.forward(p, jnp.asarray(tokens_np), jcfg, attn_impl="xla", return_aux=True,
                                   moe_impl=moe_impl)
            return jtrainer.cross_entropy_loss(lg[:, :-1], jnp.asarray(tokens_np)[:, 1:]) + AUX_WEIGHT * a

        jg = tllama.params_from_jax(jax.tree.map(np.asarray, jax.grad(jloss)(jparams)), tcfg, device="cpu")
        _, grads = Trainer(loss_fn, make_optimizer(1e-2))._value_and_grad(params, {"tokens": tokens})
        for got, want in zip(tree.leaves(grads), tree.leaves(jg)):
            _close(got, want.numpy())
        assert all(g.abs().max() > 0 for layer in grads["layers"] for k, g in layer.items() if k.startswith("moe_"))

    t = Trainer(loss_fn, make_optimizer(1e-2))
    state = t.init_state(params)
    first = None
    for _ in range(8):
        state, m = t.train_step(state, {"tokens": tokens})
        first = first if first is not None else float(m["loss"])
    assert float(m["loss"]) < first
