"""The port's training paths of the diffusion models and Whisper against the
JAX package's, on the CPU: the rectified-flow losses (``flow_loss`` with and
without ControlNet's ``control=``, ``mmdit_flow_loss``), the tree LoRA of
DreamBooth (``init_lora_tree``, ``merge_tree``, ``lora_tree_from_jax``),
and ``Trainer`` steps over ``flow_loss`` and over ``whisper.forward`` with
``cross_entropy_loss`` (``fine_tune_asr.py``'s loss).

Same weights (the JAX tree with every leaf perturbed by a seeded N(0, 0.02),
as ``test_torch_diffusion.py`` does: the reference's zero-initialised
modulation makes each block the identity), same numpy inputs, and the
losses' randomness derived from the JAX key exactly as the JAX function
splits it, then handed to the port as ``t=``, ``eps=`` and ``drop=``.
Tolerances, f32: losses at rtol 1e-5; gradients per leaf within 1e-4 of
that leaf's largest gradient (the same sums in another order through a few
layers); parameters after optimizer steps at ``test_torch_lora_int8.py``'s
rule (99.9% of entries within rtol 1e-4 and atol 1e-3 x lr; every entry
within lr, what Adam moves an entry whose tiny gradient flips sign). The
bf16 MMDiT (whose joint attention runs the flash entry, plain twins here)
is held at cosine >= 0.999 per leaf.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import diffusion as jdiff
from modal_examples_tpu.models import lora as jlora
from modal_examples_tpu.models import whisper as jwhisper
from modal_examples_tpu.training import trainer as jtrainer
from modal_examples_tpu_torch.models import diffusion as tdiff
from modal_examples_tpu_torch.models import lora as tlora
from modal_examples_tpu_torch.models import whisper as twhisper
from modal_examples_tpu_torch.ops import flash_attention as tflash
from modal_examples_tpu_torch.training import Trainer, cross_entropy_loss, make_optimizer
from modal_examples_tpu_torch.utils import tree
from test_torch_time_limit import share_cores

share_cores()

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LR = 1e-3


def _perturbed(tree_, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + rng.normal(0, 0.02, a.shape)).astype(np.float32),
                        tree_)


def _rng_np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flat(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, node


def _grads(loss_fn, params):
    """(loss, gradient tree) of ``loss_fn(params)`` through autograd."""
    leaves = [p.detach().clone().requires_grad_(True) for p in tree.leaves(params)]
    loss = loss_fn(tree.unflatten(params, leaves))
    return loss, tree.unflatten(params, list(torch.autograd.grad(loss, leaves)))


def _assert_grads_close(port, ref):
    """Per leaf: within ``GRAD_TOL`` of the leaf's largest reference gradient."""
    got, want = dict(_flat(port)), dict(_flat(ref))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = np.asarray(want[path], np.float32)
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=0, atol=GRAD_TOL * max(np.abs(w).max(), 1e-6),
                                   err_msg=path)


def _jax_flow_draws(key, shape, null_prob=None):
    """The numbers the JAX losses draw from ``key``, split as they split it."""
    if null_prob is None:
        k1, k2 = jax.random.split(key)
        return np.array(jax.random.uniform(k1, shape[:1])), np.array(jax.random.normal(k2, shape)), None
    k1, k2, k3 = jax.random.split(key, 3)
    return (np.array(jax.random.uniform(k1, shape[:1])), np.array(jax.random.normal(k2, shape)),
            np.array(jax.random.bernoulli(k3, null_prob, shape[:1])))


# -- the DiT's flow loss ----------------------------------------------------------------


def _dit(control: bool, seed=0, jcfg=None):
    jcfg = jcfg or dataclasses.replace(jdiff.DiTConfig.tiny(), control=control)
    np_params = _perturbed(jdiff.init_params(jax.random.PRNGKey(seed), jcfg), seed + 40)
    tcfg = tdiff.DiTConfig(**dataclasses.asdict(jcfg))
    return jcfg, tcfg, np_params, tdiff.params_from_jax(np_params, tcfg, device="cpu")


@pytest.mark.parametrize("control", [False, True], ids=["plain", "controlnet"])
def test_flow_loss_and_grads_match_jax(control):
    jcfg, tcfg, np_params, tp = _dit(control)
    B, hw = 4, jcfg.img_size
    images, text = _rng_np(1, B, hw, hw, 3), _rng_np(2, B, 6, jcfg.text_dim)
    ctrl = _rng_np(3, B, hw, hw, 3) if control else None
    key = jax.random.PRNGKey(7)
    t, eps, drop = _jax_flow_draws(key, images.shape, 0.5)
    assert drop.any() and not drop.all()  # both the null and the conditional text are exercised
    kw_j = {"control": jnp.asarray(ctrl)} if control else {}
    kw_t = {"control": torch.from_numpy(ctrl)} if control else {}
    jl, jg = jax.value_and_grad(lambda p: jdiff.flow_loss(p, key, jnp.asarray(images), jnp.asarray(text), jcfg,
                                                          null_prob=0.5, **kw_j))(jax.tree.map(jnp.asarray, np_params))
    tl, tg = _grads(lambda p: tdiff.flow_loss(p, torch.from_numpy(images), torch.from_numpy(text), tcfg,
                                              null_prob=0.5, t=torch.from_numpy(t), eps=torch.from_numpy(eps),
                                              drop=torch.from_numpy(drop), **kw_t), tp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    _assert_grads_close(tg, jg)
    if control:  # the zero-init control projection learns from the first step
        assert tg["control_proj"].abs().max() > 0


def test_flow_loss_draws_from_the_generator():
    """Without ``t``/``eps``/``drop`` the loss draws them from ``generator``:
    the same seed gives the same loss; it equals the loss given the same
    draws made by hand in the same order."""
    _, tcfg, _, tp = _dit(False)
    images, text = torch.from_numpy(_rng_np(4, 2, 16, 16, 3)), torch.from_numpy(_rng_np(5, 2, 6, tcfg.text_dim))
    a = tdiff.flow_loss(tp, images, text, tcfg, generator=torch.Generator().manual_seed(3))
    b = tdiff.flow_loss(tp, images, text, tcfg, generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    t, eps = torch.rand((2,), generator=g), torch.randn(images.shape, generator=g)
    drop = torch.rand((2,), generator=g) < 0.1
    c = tdiff.flow_loss(tp, images, text, tcfg, t=t, eps=eps, drop=drop)
    assert torch.isfinite(a) and a.dim() == 0 and torch.equal(a, b) and torch.equal(a, c)


def test_controlnet_trainer_steps_match_jax():
    """``controlnet.py``'s DiT config trained by ``Trainer`` (the port's
    AdamW) against the JAX ``Trainer`` for two steps, ``null_prob=0`` as the
    example trains: losses, grad norms and every parameter."""
    jcfg = jdiff.DiTConfig(img_size=16, patch=2, dim=96, n_layers=3, n_heads=4, text_dim=16, text_len=4, control=True)
    _, tcfg, np_params, tp = _dit(True, jcfg=jcfg)
    B = 4
    rng = np.random.default_rng(6)
    batches = []
    for step in range(2):
        key = jax.random.PRNGKey(20 + step)
        images = rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
        ctrl = (rng.random((B, 16, 16, 3)) > 0.7).astype(np.float32)
        t, eps, drop = _jax_flow_draws(key, images.shape, 0.0)
        batches.append(dict(key=key, images=images, control=ctrl, t=t, eps=eps, drop=drop))
    txt = np.zeros((B, 4, 16), np.float32)

    def jloss(p, b):
        return jdiff.flow_loss(p, b["key"], b["images"], txt, jcfg, control=b["control"], null_prob=0.0)

    def tloss(p, b):
        return tdiff.flow_loss(p, b["images"], torch.from_numpy(txt), tcfg, control=b["control"], null_prob=0.0,
                               t=b["t"], eps=b["eps"], drop=b["drop"])

    jt, tt = jtrainer.Trainer(jloss, jtrainer.make_optimizer(LR)), Trainer(tloss, make_optimizer(LR))
    js, ts = jt.init_state(jax.tree.map(jnp.asarray, np_params)), tt.init_state(tp)
    for b in batches:
        js, jm = jt.train_step(js, {k: (v if k == "key" else jnp.asarray(v)) for k, v in b.items()})
        ts, tm = tt.train_step(ts, {k: torch.from_numpy(v) for k, v in b.items() if k != "key"})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    _assert_params_close(dict(_flat(ts.params)), dict(_flat(js.params)), LR)


def _assert_params_close(got: dict, want: dict, lr: float):
    """``test_torch_lora_int8.py``'s rule for parameters after Adam steps:
    99.9% of the entries within rtol 1e-4 and atol 1e-3 x lr, every entry
    within lr (one Adam step: a gradient of a few 1e-5 whose sign the
    summation order flips moves its entry by up to lr the other way)."""
    outside = total = 0
    for path, v in got.items():
        g, w = v.detach().float().numpy(), np.asarray(want[path], np.float32)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=lr, err_msg=path)
        outside += int((np.abs(g - w) > 1e-3 * lr + 1e-4 * np.abs(w)).sum())
        total += w.size
    assert outside <= 1e-3 * total, (outside, total)


# -- the MMDiT's flow loss --------------------------------------------------------------


def _mmdit(jcfg, seed=0):
    np_params = _perturbed(jdiff.mmdit_init(jax.random.PRNGKey(seed), jcfg), seed + 50)
    tcfg = tdiff.MMDiTConfig(**dataclasses.asdict(jcfg))
    return tcfg, np_params, tdiff.params_from_jax(np_params, tcfg, device="cpu")


def _mmdit_batch(cfg, B=2, S=6, seed=1):
    return (_rng_np(seed, B, cfg.img_size, cfg.img_size, cfg.channels), _rng_np(seed + 1, B, S, cfg.text_dim),
            _rng_np(seed + 2, B, cfg.pooled_dim))


@pytest.mark.parametrize("pre_only", [False, True], ids=["uniform", "pre-only-last"])
def test_mmdit_flow_loss_and_grads_match_jax(pre_only):
    jcfg = jdiff.MMDiTConfig(context_pre_only_last=pre_only)
    tcfg, np_params, tp = _mmdit(jcfg)
    lat, text, pooled = _mmdit_batch(jcfg)
    key = jax.random.PRNGKey(8)
    t, eps, _ = _jax_flow_draws(key, lat.shape)
    jl, jg = jax.value_and_grad(lambda p: jdiff.mmdit_flow_loss(p, key, *map(jnp.asarray, (lat, text, pooled)), jcfg))(
        jax.tree.map(jnp.asarray, np_params))
    tl, tg = _grads(lambda p: tdiff.mmdit_flow_loss(p, *map(torch.from_numpy, (lat, text, pooled)), tcfg,
                                                    t=torch.from_numpy(t), eps=torch.from_numpy(eps)), tp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    _assert_grads_close(tg, jg)


def test_bf16_mmdit_trains_through_the_flash_entry(monkeypatch):
    """In bf16 the joint attention goes through ``flash_attention``'s
    autograd function: its backward runs once a block (the plain twin of
    K5/K6 here, the kernels on the card), and the loss and gradients agree
    with the JAX bf16 model at cosine >= 0.999 per leaf."""
    jcfg = dataclasses.replace(jdiff.MMDiTConfig(context_pre_only_last=True), dtype="bfloat16")
    tcfg, np_params, tp = _mmdit(jcfg, seed=2)
    lat, text, pooled = _mmdit_batch(jcfg, seed=3)
    key = jax.random.PRNGKey(9)
    t, eps, _ = _jax_flow_draws(key, lat.shape)
    calls = []
    real = tflash.flash_backward_plain
    monkeypatch.setattr(tflash, "flash_backward_plain", lambda *a, **k: calls.append(1) or real(*a, **k))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), np_params)
    jl, jg = jax.value_and_grad(lambda p: jdiff.mmdit_flow_loss(p, key, *map(jnp.asarray, (lat, text, pooled)), jcfg))(jp)
    tl, tg = _grads(lambda p: tdiff.mmdit_flow_loss(p, *map(torch.from_numpy, (lat, text, pooled)), tcfg,
                                                    t=torch.from_numpy(t), eps=torch.from_numpy(eps)), tp)
    assert len(calls) == jcfg.n_layers
    np.testing.assert_allclose(tl.item(), float(jl), rtol=2e-2)
    want = dict(_flat(jg))
    for path, g in _flat(tg):
        a, b = g.float().numpy().ravel().astype(np.float64), np.asarray(want[path], np.float64).ravel()
        if np.abs(b).max() == 0:
            continue
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.999, path


# -- the tree LoRA --------------------------------------------------------------------


def test_init_lora_tree_mirrors_the_jax_structure():
    jcfg = jdiff.MMDiTConfig(context_pre_only_last=True)
    tcfg, np_params, tp = _mmdit(jcfg)
    lcfg = tlora.LoRAConfig(rank=4, alpha=8, targets=tlora.DIT_TARGETS)
    assert tlora.DIT_TARGETS == jlora.DIT_TARGETS
    jt = jlora.init_lora_tree(jax.random.PRNGKey(1), jax.tree.map(jnp.asarray, np_params),
                              jlora.LoRAConfig(rank=4, alpha=8, targets=jlora.DIT_TARGETS))
    tt = tlora.init_lora_tree(torch.Generator().manual_seed(1), tp, lcfg)
    got, want = dict(_flat(tt)), dict(_flat(jt))
    assert sorted(got) == sorted(want)
    for path, v in got.items():
        assert tuple(v.shape) == want[path].shape and v.dtype == torch.float32, path
        if path.endswith("/b"):
            assert v.abs().max() == 0, path
    # stacked blocks keep their leading dim; the pre-only last block has no ctx_wo / ctx_fc*
    assert tt["blocks"]["img_wq"]["a"].shape == (jcfg.n_layers - 1, jcfg.dim, 4)
    assert "ctx_wo" not in tt["last_block"] and "img_fc2" in tt["last_block"]
    assert 0.15 < tt["blocks"]["img_fc1"]["a"].std().item() < 0.35  # N(0, 1) / rank


def test_init_lora_tree_refuses_a_tree_without_targets():
    with pytest.raises(ValueError, match="no leaves matched"):
        tlora.init_lora_tree(torch.Generator(), {"w": torch.zeros(4, 4), "n": {"v": torch.zeros(3)}},
                             tlora.LoRAConfig(targets=("wq",)))
    # 1-d leaves are never targets
    with pytest.raises(ValueError, match="no leaves matched"):
        tlora.init_lora_tree(torch.Generator(), {"wq": torch.zeros(4)}, tlora.LoRAConfig(targets=("wq",)))


def test_merge_tree_matches_jax_and_keeps_the_structure():
    jcfg = jdiff.MMDiTConfig()
    tcfg, np_params, tp = _mmdit(jcfg)
    jl = jlora.init_lora_tree(jax.random.PRNGKey(2), jax.tree.map(jnp.asarray, np_params),
                              jlora.LoRAConfig(rank=4, alpha=8, targets=jlora.DIT_TARGETS))
    rng = np.random.default_rng(3)  # b = 0 merges to the base: give b values
    np_lora = jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.0, jl)
    for entry in np_lora["blocks"].values():
        entry["b"] = rng.standard_normal(entry["b"].shape).astype(np.float32) * 0.1
    lcfg = tlora.LoRAConfig(rank=4, alpha=8, targets=tlora.DIT_TARGETS)
    want = jlora.merge_tree(jax.tree.map(jnp.asarray, np_params), jax.tree.map(jnp.asarray, np_lora),
                            jlora.LoRAConfig(rank=4, alpha=8, targets=jlora.DIT_TARGETS))
    got = tlora.merge_tree(tp, tlora.lora_tree_from_jax(np_lora, device="cpu"), lcfg)
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w)
    for path, v in g.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(w[path]), rtol=0, atol=1e-6, err_msg=path)
    assert got["pos_emb"] is tp["pos_emb"]  # untargeted leaves are the base's own


def test_merge_tree_with_zero_b_is_the_base_bitwise():
    jcfg = dataclasses.replace(jdiff.MMDiTConfig(), dtype="bfloat16")
    tcfg, _, tp = _mmdit(jcfg)
    lt = tlora.init_lora_tree(torch.Generator().manual_seed(4), tp, tlora.LoRAConfig(rank=4, targets=tlora.DIT_TARGETS))
    merged = tlora.merge_tree(tp, lt, tlora.LoRAConfig(rank=4, targets=tlora.DIT_TARGETS))
    for (path, a), (_, b) in zip(_flat(merged), _flat(tp)):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b), path


def test_lora_tree_from_jax_keeps_nesting_and_dtypes():
    np_tree = {"blocks": {"img_wq": {"a": np.ones((2, 4, 3), np.float32),
                                      "b": np.zeros((2, 3, 4), jnp.bfloat16)}}}
    t = tlora.lora_tree_from_jax(np_tree, device="cpu")
    assert t["blocks"]["img_wq"]["a"].dtype == torch.float32 and t["blocks"]["img_wq"]["b"].dtype == torch.bfloat16
    assert t["blocks"]["img_wq"]["a"].shape == (2, 4, 3)
    assert tlora.lora_tree_from_jax(np_tree, dtype=torch.float32, device="cpu")["blocks"]["img_wq"]["b"].dtype \
        == torch.float32


def test_dreambooth_adapter_grads_match_jax():
    """DreamBooth's loss: the base frozen, ``mmdit_flow_loss`` over
    ``merge_tree(base, adapters)``, gradients only to the adapters."""
    jcfg = jdiff.MMDiTConfig(context_pre_only_last=True)
    tcfg, np_params, tp = _mmdit(jcfg, seed=4)
    jlc = jlora.LoRAConfig(rank=4, alpha=8, targets=jlora.DIT_TARGETS)
    tlc = tlora.LoRAConfig(rank=4, alpha=8, targets=tlora.DIT_TARGETS)
    jbase = jax.tree.map(jnp.asarray, np_params)
    np_lora = jax.tree.map(lambda a: np.asarray(a, np.float32), jlora.init_lora_tree(jax.random.PRNGKey(5), jbase, jlc))
    rng = np.random.default_rng(6)
    for node in (np_lora["blocks"], np_lora["last_block"]):
        for entry in node.values():
            entry["b"] = rng.standard_normal(entry["b"].shape).astype(np.float32) * 0.05
    lat, text, pooled = _mmdit_batch(jcfg, seed=7)
    key = jax.random.PRNGKey(10)
    t, eps, _ = _jax_flow_draws(key, lat.shape)

    def jloss(ad):
        return jdiff.mmdit_flow_loss(jlora.merge_tree(jbase, ad, jlc), key, *map(jnp.asarray, (lat, text, pooled)),
                                     jcfg)

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, np_lora))
    tl, tg = _grads(lambda ad: tdiff.mmdit_flow_loss(tlora.merge_tree(tp, ad, tlc), *map(torch.from_numpy,
                    (lat, text, pooled)), tcfg, t=torch.from_numpy(t), eps=torch.from_numpy(eps)),
                    tlora.lora_tree_from_jax(np_lora, device="cpu"))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    _assert_grads_close(tg, jg)
    assert all(not v.requires_grad for v in tree.leaves(tp))


# -- Whisper fine-tuning --------------------------------------------------------------


@pytest.fixture(scope="module")
def whisper_case():
    """``fine_tune_asr.py``'s setup at ``WhisperConfig.test_tiny``: mels,
    tokens padded with EOS and a mask of the real tokens."""
    cfg = jwhisper.WhisperConfig.test_tiny()
    np_params = _perturbed(jwhisper.init_params(jax.random.PRNGKey(0), cfg), 10)
    tcfg = twhisper.WhisperConfig(**dataclasses.asdict(cfg))
    B, S = 3, cfg.n_text_ctx // 4
    rng = np.random.default_rng(11)
    mel = rng.standard_normal((B, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(np.float32)
    toks = np.full((B, S), cfg.vocab_size - 1, np.int32)
    mask = np.zeros((B, S), np.float32)
    for i, n in enumerate((S, S - 3, 4)):
        toks[i, :n] = rng.integers(0, cfg.vocab_size - 1, n)
        mask[i, :n] = 1.0
    return cfg, tcfg, np_params, {"mel": mel, "tokens": toks, "mask": mask}


def _whisper_losses(cfg, tcfg):
    def jloss(p, b):
        logits = jwhisper.forward(p, b["mel"], b["tokens"], cfg)
        return jtrainer.cross_entropy_loss(logits[:, :-1], b["tokens"][:, 1:], b["mask"][:, 1:])

    def tloss(p, b):
        logits = twhisper.forward(p, b["mel"], b["tokens"], tcfg)
        return cross_entropy_loss(logits[:, :-1], b["tokens"][:, 1:], b["mask"][:, 1:])

    return jloss, tloss


def test_whisper_loss_and_grads_match_jax(whisper_case):
    cfg, tcfg, np_params, batch = whisper_case
    jloss, tloss = _whisper_losses(cfg, tcfg)
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, np_params), batch)
    tp = twhisper.params_from_jax(np_params, tcfg, device="cpu")
    tl, tg = _grads(lambda p: tloss(p, {k: torch.from_numpy(v) for k, v in batch.items()}), tp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    # the JAX gradients in the port's layouts (the convolutions transposed)
    _assert_grads_close(tg, twhisper.params_from_jax(jax.tree.map(np.asarray, jg), tcfg, device="cpu"))


def test_whisper_trainer_steps_match_jax(whisper_case):
    """Two ``Trainer`` steps of ``fine_tune_asr.py`` (``make_optimizer(3e-3)``):
    losses, grad norms and every parameter against the JAX ``Trainer``."""
    cfg, tcfg, np_params, batch = whisper_case
    jloss, tloss = _whisper_losses(cfg, tcfg)
    lr = 3e-3
    jt, tt = jtrainer.Trainer(jloss, jtrainer.make_optimizer(lr)), Trainer(tloss, make_optimizer(lr))
    js = jt.init_state(jax.tree.map(jnp.asarray, np_params))
    ts = tt.init_state(twhisper.params_from_jax(np_params, tcfg, device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for step in range(2):
        js, jm = jt.train_step(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tt.train_step(ts, tb)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4, err_msg=f"step {step}")
    want = twhisper.params_from_jax(jax.tree.map(np.asarray, js.params), tcfg, device="cpu")
    _assert_params_close(dict(_flat(ts.params)), dict(_flat(want)), lr)
    assert tm["loss"].item() < float(jax.device_get(jloss(jax.tree.map(jnp.asarray, np_params), batch)))
