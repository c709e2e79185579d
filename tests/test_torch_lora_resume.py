"""The training path through the platform layer: ``chip_smoke.py``'s
resumable LoRA fine-tune app (``APP_LORA``, after the JAX package's
``examples/06_gpu_and_ml/llm-finetuning/lora_finetune.py``) at that
example's tiny f32 config, in spawned containers without ``gpu=``, with a
``Volume`` and ``Retries``: the first attempt raises after its step-k
commit, the retry (a fresh container) resumes at k with the adapters the
first saved, and the final adapters and every step's loss equal an
uninterrupted run's, bitwise (each container trains on one CPU thread: under
load a multi-threaded CPU GEMM may split its sums otherwise from one process
to the next, which moves the last bit). Then the port's ``Trainer`` against the JAX
example's loop in-process, weights and batches carried across: losses and
gradient norms within rtol 1e-4 in f32 (``tests/test_torch_training.py``'s
step tolerance: XLA and PyTorch sum in different orders).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import modal_examples_tpu_torch as mtpu
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.models import lora as jlora
from modal_examples_tpu.training import trainer as jtrainer
from modal_examples_tpu.utils.tokenizer import ByteTokenizer
from modal_examples_tpu_torch.core.app import load_module_from_path
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.models import lora as tlora
from modal_examples_tpu_torch.training import Trainer, cross_entropy_loss, make_optimizer
from test_torch_time_limit import share_cores, time_limits

share_cores()

#: three training containers (a second or two each on the tiny config)
_limit_module, _limit_test = time_limits(test_s=120, module_s=120)

#: the example's model (lora_finetune.py:57-60), rank, batch and rate
TINY = dict(vocab_size=512, dim=128, n_layers=4, n_heads=4, n_kv_heads=2, ffn_dim=256, max_seq_len=128,
            dtype="float32")
RANK, BATCH, SEQ, LR = 8, 4, 96, 1e-3
FAIL_AFTER, STEPS = 2, 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The resumed run and the uninterrupted one, and the progress Dict."""
    d = tmp_path_factory.mktemp("lora-resume")
    progress = mtpu.Dict.from_name(f"lora-resume-{os.getpid()}")
    volume = f"lora-resume-{os.getpid()}"
    path = chip_smoke.write_app(d, "lora_resume_app", chip_smoke.APP_LORA, SETUP={
        "config": TINY, "rank": RANK, "batch": (BATCH, SEQ), "lr": LR, "device": "cpu", "gpu": None, "threads": 1,
        "mount": str(d / "ckpts"), "volume": volume, "progress": progress.name})
    mod = load_module_from_path(str(path))
    try:
        with mod.app.run():
            resumed = mod.finetune.remote("resumed", STEPS, FAIL_AFTER)
            straight = mod.finetune.remote("straight", STEPS)
        yield {"resumed": resumed, "straight": straight, "first": progress["resumed/interrupted"],
               "progress": dict(progress.items()), "ckpts": d / "ckpts"}
    finally:
        mtpu.Dict.delete(progress.name)
        mtpu.Volume.delete(volume)


def test_the_first_attempt_raises_after_its_commit(runs):
    first = runs["first"]
    assert first["step"] == FAIL_AFTER and sorted(first["losses"]) == [1, 2]
    assert first["bytes"] > 0 and first["save_s"] > 0


def test_the_retry_resumes_at_k_with_the_saved_adapters(runs):
    resumed = runs["resumed"]
    assert resumed["resumed_from"] == FAIL_AFTER
    assert resumed["loaded_digest"] == runs["first"]["digest"]
    assert sorted(resumed["losses"]) == list(range(FAIL_AFTER + 1, STEPS + 1))
    assert runs["progress"]["resumed/step"] == STEPS


def test_the_final_adapters_equal_an_uninterrupted_runs(runs):
    resumed, straight = runs["resumed"], runs["straight"]
    assert straight["resumed_from"] == 0 and straight["loaded_digest"] is None
    assert resumed["final_digest"] == straight["final_digest"]
    assert {**runs["first"]["losses"], **resumed["losses"]} == straight["losses"]  # bitwise


def test_checkpoints_on_the_volume(runs):
    """Both runs' last step on the volume, keep_n=2 pruning the rest."""
    from modal_examples_tpu_torch.training import CheckpointManager

    for run, steps in (("resumed", [FAIL_AFTER, STEPS]), ("straight", [STEPS])):
        assert CheckpointManager(runs["ckpts"] / run).steps() == steps


# -- the port's Trainer against the JAX example's loop ------------------------------

#: the example's synthetic dataset (lora_finetune.py:28-35)
DATASET = [
    ("What is the MXU?", "The MXU is the TPU's 128x128 systolic matrix unit."),
    ("What feeds the MXU?", "VMEM feeds the MXU with operand tiles."),
    ("What is ICI?", "ICI is the inter-chip interconnect linking TPU chips."),
    ("What is HBM?", "HBM is the high-bandwidth memory attached to each chip."),
    ("What is XLA?", "XLA compiles JAX programs into fused TPU executables."),
    ("What is a mesh?", "A mesh names axes over devices for sharded arrays."),
] * 4


def _example_batches(n: int) -> list:
    """The example's ``batch_at`` over its key chain, as numpy."""
    tok = ByteTokenizer()

    def encode(q, a):
        ids = tok.encode(f"Q: {q}\nA: {a}")[:SEQ]
        arr = np.full((SEQ,), tok.pad_id, np.int32)
        arr[: len(ids)] = ids
        mask = np.zeros((SEQ,), np.float32)
        mask[: len(ids)] = 1.0
        return arr, mask

    encoded = [encode(q, a) for q, a in DATASET]
    key, out = jax.random.PRNGKey(2), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        ix = np.asarray(jax.random.randint(sub, (BATCH,), 0, len(encoded)))
        out.append({"tokens": np.stack([encoded[i][0] for i in ix]), "mask": np.stack([encoded[i][1] for i in ix])})
    return out


def test_trainer_steps_match_the_jax_examples_loop():
    jcfg = jllama.LlamaConfig(**TINY)
    tcfg = tllama.LlamaConfig(**TINY)
    jbase = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    jl = jlora.LoRAConfig(rank=RANK)
    np_lora = jax.tree.map(np.asarray, jlora.init_lora(jax.random.PRNGKey(1), jbase, jl))
    tbase = tllama.params_from_jax(jax.tree.map(np.asarray, jbase), tcfg, device="cpu")
    tl = tlora.LoRAConfig(rank=RANK)
    assert tl.scale == jl.scale

    def jloss(adapters, batch):
        logits = jllama.forward(jbase, batch["tokens"], jcfg, attn_impl="xla", lora=adapters, lora_scale=jl.scale)
        return jtrainer.cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:], batch["mask"][:, 1:])

    def tloss(adapters, batch):
        logits = tllama.forward(tbase, batch["tokens"], tcfg, attn_impl="xla", lora=adapters, lora_scale=tl.scale)
        return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:], batch["mask"][:, 1:])

    jt = jtrainer.Trainer(jloss, jtrainer.make_optimizer(LR))
    tt = Trainer(tloss, make_optimizer(LR))
    jstate = jt.init_state(jax.tree.map(jnp.asarray, np_lora))
    tstate = tt.init_state(tlora.lora_from_jax(np_lora, device="cpu"))
    for step, batch in enumerate(_example_batches(3)):
        jstate, jm = jt.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tt.train_step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4, err_msg=f"step {step}")
    assert tstate.step == int(jstate.step) == 3
    assert dataclasses.asdict(tcfg).items() >= {k: v for k, v in TINY.items()}.items()

