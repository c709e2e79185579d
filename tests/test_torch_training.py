"""The port's LoRA fine-tuning path against the JAX package's: adapters,
the LoRA forward and its gradients, ``Trainer`` steps, the optimizer and
schedule against optax, checkpoints and the run logger.

Same base weights (JAX ``init_params`` through ``params_from_jax``), same
adapters (JAX ``init_lora`` through ``lora_from_jax``), same numpy tokens;
tiny f32 config with GQA (Hq=4, Hkv=2, head dim 32). The JAX forward runs
``attn_impl="flash"`` as its own CPU tests run it (Pallas in interpret
mode); the port's CPU path is the flash kernels' plain versions.
Tolerances: logits within 1e-4 x max|logit| (accumulation order differs
between XLA and PyTorch); gradients, losses and grad norms within rtol 1e-4
(atol 1e-6 for entries near zero); adapters after optimizer steps within
rtol 1e-4 and atol 1e-3 x lr (Adam's normalised update turns the relative
error of a near-zero gradient entry into an absolute one of up to lr); the
optimizer alone within rtol 1e-6 in f32 and one bf16 ulp (rtol 2**-7) in
bf16 (the port rounds constants to the leaf dtype as JAX's weak types do,
and is bitwise equal to eager optax in this test; the ulp allows for the
bias correction's power taken in f64 here and in f32 there).
"""

import dataclasses
import json
import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.models import lora as jlora
from modal_examples_tpu.training import trainer as jtrainer
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.models import lora as tlora
from modal_examples_tpu_torch.training import CheckpointManager, Trainer, cross_entropy_loss, make_optimizer
from modal_examples_tpu_torch.training import trainer as ttrainer
from modal_examples_tpu_torch.training.resilience import device_health, run_resilient
from modal_examples_tpu_torch.utils.tracking import RunLogger
from test_torch_time_limit import share_cores

share_cores()

B, S = 2, 32
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LR = 1e-2
ADAPTER_TOL = dict(rtol=1e-4, atol=1e-3 * LR)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jbase = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tbase = tllama.params_from_jax(jax.tree.map(np.asarray, jbase), tcfg, device="cpu")
    lcfg = tlora.LoRAConfig(rank=4, alpha=8.0)
    jl = jlora.LoRAConfig(rank=4, alpha=8.0)
    adapters = jlora.init_lora(jax.random.PRNGKey(1), jbase, jl)
    # b = 0 at init makes every a-gradient zero; give b values so both move
    rng = np.random.default_rng(2)
    np_lora = {"layers": {
        k: (rng.standard_normal(v.shape).astype(np.float32) * 0.05 if k.endswith("_b") else np.asarray(v))
        for k, v in adapters["layers"].items()
    }}
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, -5:] = 0.0
    return dict(jcfg=jcfg, tcfg=tcfg, jbase=jbase, tbase=tbase, lcfg=lcfg, np_lora=np_lora,
                batch={"tokens": tokens, "mask": mask})


def _jloss(m):
    def loss(lora, batch):
        logits = jllama.forward(m["jbase"], batch["tokens"], m["jcfg"], attn_impl="flash",
                                lora=lora, lora_scale=m["lcfg"].scale)
        return jtrainer.cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:], batch["mask"][:, 1:])
    return loss


def _tloss(m, attn_impl="flash"):
    def loss(lora, batch):
        logits = tllama.forward(m["tbase"], batch["tokens"], m["tcfg"], attn_impl=attn_impl,
                                lora=lora, lora_scale=m["lcfg"].scale)
        return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:], batch["mask"][:, 1:])
    return loss


def _jlora(np_lora):
    return jax.tree.map(jnp.asarray, np_lora)


def _tbatch(m):
    return {k: torch.from_numpy(v) for k, v in m["batch"].items()}


def _assert_tree_close(port: dict, ref: dict, **tol):
    assert port.keys() == ref.keys()
    for k in port:
        np.testing.assert_allclose(port[k].detach().numpy(), np.asarray(ref[k]), err_msg=k, **(tol or GRAD_TOL))


def test_lora_delta_and_merge_match_jax(model):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 128)).astype(np.float32)
    a = rng.standard_normal((128, 4)).astype(np.float32)
    b = rng.standard_normal((4, 96)).astype(np.float32)
    ref = np.asarray(jlora.delta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), 2.0))
    np.testing.assert_allclose(
        tlora.delta(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b), 2.0).numpy(),
        ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
    )
    jl = jlora.LoRAConfig(rank=4, alpha=8.0)
    jmerged = jlora.merge(model["jbase"], _jlora(model["np_lora"]), jl)
    tmerged = tlora.merge(model["tbase"], tlora.lora_from_jax(model["np_lora"], device="cpu"), model["lcfg"])
    for name in tlora.DEFAULT_TARGETS:
        for li, layer in enumerate(tmerged["layers"]):
            np.testing.assert_allclose(layer[name].numpy(), np.asarray(jmerged["layers"][name][li]), rtol=1e-6, atol=1e-6)
    assert tlora.param_count(tlora.lora_from_jax(model["np_lora"], device="cpu")) == jlora.param_count(model["np_lora"])


def test_init_lora_shapes_dtypes_and_zero_b():
    cfg = tllama.LlamaConfig.tiny()
    base = tllama.init_params(cfg, device="cpu")
    adapters = tlora.init_lora(torch.Generator().manual_seed(0), base, tlora.LoRAConfig(rank=8))
    a, b = adapters["layers"]["gate_a"], adapters["layers"]["gate_b"]
    assert a.shape == (2, 128, 8) and b.shape == (2, 8, 256)
    assert a.dtype == b.dtype == torch.bfloat16
    assert b.abs().max() == 0 and 0.05 < a.float().std() < 0.2  # N(0, 1) / rank


def test_lora_forward_logits_and_adapter_grads_match_jax(model):
    """The forward with adapters through the flash path, and the adapter
    gradients of the masked next-token loss through the flash backward."""
    jl, tl = _jlora(model["np_lora"]), tlora.lora_from_jax(model["np_lora"], device="cpu")
    tokens = model["batch"]["tokens"]
    ref = np.asarray(jllama.forward(model["jbase"], jnp.asarray(tokens), model["jcfg"], lora=jl,
                                    lora_scale=model["lcfg"].scale))
    got = tllama.forward(model["tbase"], torch.from_numpy(tokens), model["tcfg"], lora=tl,
                         lora_scale=model["lcfg"].scale)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    jloss, jgrads = jax.value_and_grad(_jloss(model))(jl, model["batch"])
    leaves = {k: v.clone().requires_grad_(True) for k, v in tl["layers"].items()}
    tloss = _tloss(model)({"layers": leaves}, _tbatch(model))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    _assert_tree_close({k: v.grad for k, v in leaves.items()}, jgrads["layers"])
    assert all(v.grad.abs().max() > 0 for v in leaves.values())


def test_three_train_steps_match_jax_trainer(model):
    jt = jtrainer.Trainer(_jloss(model), jtrainer.make_optimizer(LR))
    tt = Trainer(_tloss(model), make_optimizer(LR))
    jstate = jt.init_state(_jlora(model["np_lora"]))
    tstate = tt.init_state(tlora.lora_from_jax(model["np_lora"], device="cpu"))
    for step in range(3):
        jstate, jm = jt.train_step(jstate, model["batch"])
        tstate, tm = tt.train_step(tstate, _tbatch(model))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4, err_msg=f"step {step}")
        _assert_tree_close(tstate.params["layers"], jstate.params["layers"], **ADAPTER_TOL)
    assert tstate.step == int(jstate.step) == 3


def test_grad_accum_and_remat_match_the_plain_step(model):
    tl = tlora.lora_from_jax(model["np_lora"], device="cpu")
    states = {}
    for name, kw in {"plain": {}, "accum2": {"grad_accum": 2}, "remat": {"remat": True}}.items():
        t = Trainer(_tloss(model), make_optimizer(LR), **kw)
        states[name] = t.train_step(t.init_state(tl), _tbatch(model))
    plain, pm = states["plain"]
    # accum: mean of two microbatch losses (each masked mean over its row)
    losses = [_tloss(model)(tl, {k: v[i:i + 1] for k, v in _tbatch(model).items()}) for i in range(B)]
    np.testing.assert_allclose(states["accum2"][1]["loss"].item(), (sum(losses) / B).item(), rtol=1e-6)
    assert states["accum2"][0].step == 1
    remat, rm = states["remat"]
    np.testing.assert_allclose(rm["loss"].item(), pm["loss"].item(), rtol=1e-6)
    np.testing.assert_allclose(rm["grad_norm"].item(), pm["grad_norm"].item(), rtol=1e-6)
    _assert_tree_close(remat.params["layers"], {k: v.numpy() for k, v in plain.params["layers"].items()}, rtol=1e-6)


def test_grad_accum_sums_then_divides_like_jax(model):
    """Accumulation over two equal-mask microbatches against the JAX scan."""
    batch = dict(model["batch"], mask=np.ones((B, S), np.float32))
    jt = jtrainer.Trainer(_jloss(model), jtrainer.make_optimizer(LR), grad_accum=2)
    tt = Trainer(_tloss(model), make_optimizer(LR), grad_accum=2)
    jstate, jm = jt.train_step(jt.init_state(_jlora(model["np_lora"])), batch)
    tstate, tm = tt.train_step(tt.init_state(tlora.lora_from_jax(model["np_lora"], device="cpu")),
                               {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    _assert_tree_close(tstate.params["layers"], jstate.params["layers"], **ADAPTER_TOL)


def _opt_inputs(dtype, scale):
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32), "v": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: (rng.standard_normal(p.shape) * scale).astype(np.float32) for k, p in params.items()}
             for _ in range(3)]
    to_t = lambda tree: {k: torch.from_numpy(v).to(dtype) for k, v in tree.items()}  # noqa: E731
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    to_j = lambda tree: {k: jnp.asarray(v, jdt) for k, v in tree.items()}  # noqa: E731
    return params, grads, to_t, to_j


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below-clip", "above-clip"])
def test_optimizer_matches_optax(dtype, scale):
    """Three updates of clip_by_global_norm + adamw with a schedule; bf16
    parameters keep bf16 moments, as optax gives them."""
    params, grads, to_t, to_j = _opt_inputs(dtype, scale)
    sched = ttrainer.warmup_cosine(0.1, 1, 5)
    jopt = jtrainer.make_optimizer(jtrainer.warmup_cosine(0.1, 1, 5))
    topt = make_optimizer(sched)
    jp, tp = to_j(params), to_t(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(to_j(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(to_t(g), ts, tp)
        tp = ttrainer.apply_updates(tp, tu)
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == torch.float32 else dict(rtol=2**-7, atol=0)
    adam_state = js[1][0]
    for k in params:
        assert tp[k].dtype == ts["mu"][k].dtype == ts["nu"][k].dtype == dtype
        assert adam_state.mu[k].dtype == jnp.dtype(jp[k].dtype)
        np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(jp[k], np.float32), err_msg=k, **tol)
        np.testing.assert_allclose(ts["mu"][k].float().numpy(), np.asarray(adam_state.mu[k], np.float32), **tol)
        np.testing.assert_allclose(ts["nu"][k].float().numpy(), np.asarray(adam_state.nu[k], np.float32), **tol)


def test_global_norm_and_clip_threshold():
    g = {"a": torch.full((4,), 0.5)}  # norm exactly 1.0 = max_norm: clipped branch (no eps)
    np.testing.assert_allclose(ttrainer.global_norm(g).item(), 1.0)
    upd, _ = make_optimizer(1.0, weight_decay=0.0, grad_clip=1.0).update(
        g, make_optimizer(1.0).init(g), {"a": torch.zeros(4)})
    ju, _ = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1.0, b1=0.9, b2=0.95, weight_decay=0.0)).update(
        {"a": jnp.full((4,), 0.5)}, optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1.0)).init(
            {"a": jnp.zeros(4)}), {"a": jnp.zeros(4)})
    np.testing.assert_allclose(upd["a"].numpy(), np.asarray(ju["a"]), rtol=1e-6)


def test_warmup_cosine_matches_optax():
    port = ttrainer.warmup_cosine(1.0, 2, 10, floor=0.1)
    ref = jtrainer.warmup_cosine(1.0, 2, 10, floor=0.1)
    got = [port(c) for c in range(12)]
    np.testing.assert_allclose(got, [float(ref(c)) for c in range(12)], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[:4], [0.0, 0.5, 1.0, 0.9657457], rtol=1e-6)
    assert got[10] == got[11] == pytest.approx(0.1)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    tgt = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jtrainer.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(tgt), None if m is None else jnp.asarray(m))
        got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(tgt), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_unported_options_raise():
    cfg = tllama.LlamaConfig.tiny()
    tokens = torch.zeros((1, 4), dtype=torch.long)
    mesh = types.SimpleNamespace(mesh_dim_names=("tensor",), shape=(2,))
    # input_embeds is ported (the multimodal prefix); under a mesh it waits for A10b
    with pytest.raises(NotImplementedError, match="A10b"):
        tllama.forward({}, tokens, cfg, input_embeds=torch.zeros((1, 2, cfg.dim)), mesh=mesh)
    # LoRA adapters over a tensor-parallel base wait for A10c
    with pytest.raises(NotImplementedError, match="A10c"):
        tllama.forward({}, tokens, cfg, lora={"layers": {}}, mesh=mesh)


def test_param_specs_without_a_mesh_place_nothing():
    """As in the JAX trainer, placements need a mesh: without one the state
    holds the whole leaves and the step is the one-card step (the placed
    training is ``tests/test_torch_tp_training.py`` and
    ``tests/test_torch_fsdp.py``)."""
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    params = tllama.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))

    def loss_fn(p, b):
        return cross_entropy_loss(tllama.forward(p, b["tokens"], cfg, attn_impl="xla")[:, :-1], b["tokens"][:, 1:])

    placed = Trainer(loss_fn, make_optimizer(1e-3), param_specs=tllama.partition_specs(cfg))
    plain = Trainer(loss_fn, make_optimizer(1e-3))
    state = placed.init_state(params)
    assert state.params is params and placed.placement(params) is None
    got = placed.train_step(state, {"tokens": tokens})[1]
    want = plain.train_step(plain.init_state(params), {"tokens": tokens})[1]
    assert float(got["loss"]) == float(want["loss"]) and float(got["grad_norm"]) == float(want["grad_norm"])


class _Volume:
    def __init__(self):
        self.commits = 0

    def commit(self):
        self.commits += 1


def test_checkpoint_round_trip_keep_n_and_commit(tmp_path, model):
    t = Trainer(_tloss(model), make_optimizer(LR))
    state = t.init_state(tlora.lora_from_jax(model["np_lora"], device="cpu"))
    state, _ = t.train_step(state, _tbatch(model))
    vol = _Volume()
    mgr = CheckpointManager(tmp_path / "ckpt", keep_n=2, volume=vol)
    for step in (1, 2, 3):
        path = mgr.save(step, {"state": state})
    assert path.name == "step_00000003" and mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert vol.commits == 3
    fresh = t.init_state(tlora.lora_from_jax(model["np_lora"], device="cpu", dtype=torch.bfloat16))
    restored = mgr.restore({"state": fresh})["state"]
    assert isinstance(restored, ttrainer.TrainState) and restored.step == 1
    assert restored.opt_state["count"] == 1
    for k, v in state.params["layers"].items():
        got = restored.params["layers"][k]
        assert got.dtype == torch.bfloat16  # the target's dtype and device
        torch.testing.assert_close(got, v.to(torch.bfloat16))
        torch.testing.assert_close(restored.opt_state["mu"]["layers"][k].float(),
                                   state.opt_state["mu"]["layers"][k].to(torch.bfloat16).float())
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"state": fresh})


def test_fit_logs_jsonl_and_run_resilient_checkpoints(tmp_path, model):
    t = Trainer(_tloss(model), make_optimizer(LR))
    tl = tlora.lora_from_jax(model["np_lora"], device="cpu")
    vol = _Volume()
    state = t.fit(t.init_state(tl), [_tbatch(model)] * 2, run_dir=tmp_path / "run", volume=vol)
    assert state.step == 2 and vol.commits == 1
    rows = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2] and all(np.isfinite(r["loss"]) and "grad_norm" in r for r in rows)
    assert RunLogger(tmp_path / "run", tensorboard=False).history() == rows
    mgr = CheckpointManager(tmp_path / "ckpt")
    state, last, preempted = run_resilient(t, t.init_state(tl), iter([_tbatch(model)] * 3), mgr,
                                           total_steps=3, save_every=2)
    assert (last, preempted, mgr.steps()) == (3, False, [2, 3])


def test_device_health_needs_a_card():
    if torch.cuda.is_available():
        assert all(v == "ok" for v in device_health().values())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_health()
