"""Data-parallel LoRA fine-tuning through the port's ``Trainer(mesh=)``
against the JAX ``Trainer`` on a ``data`` mesh of 2.

Two CPU rank processes over gloo each take their block of every
microbatch of the global batch, run the LoRA forward and backward through
the flash kernels' plain versions, and sum the adapter gradients over the
``data`` axis before the optimizer. The JAX trainer runs here with the
batch placed ``P("data")`` on 2 devices (its forward on the ``xla``
attention: a Pallas kernel is not auto-partitioned). Tiny f32 config, GQA
(Hq=4, Hkv=2, head dim 32), LoRA rank 4 on the seven projections. Three
cases: every token counted (B=2); padded rows whose token counts differ
across the ranks (B=2), where only the global token count gives the JAX
loss; and the same with ``grad_accum=2`` (B=4), where each microbatch is a
block of the global batch split over the ranks. Held: the first step's
gradients (``Trainer.loss_and_grads``, summed over the ranks) within 1e-5
of their largest value against ``jax.grad`` of the JAX trainer's loss over
the global batch; after each of 2 steps, the losses and grad norms within
1e-5 relative of the JAX trainer's; and all of it against the port's
one-rank trainer over the whole batch. The adapters after the 2 Adam steps
are held within 1e-5 of their largest value where every token counts. On
padded rows they are not: there the JAX trainer's own mesh and
one-device runs differ by 1.2e-5 on one element of ``wv_a`` (2.2e-6 of
gradient noise divided by a second moment near zero), so that tolerance
would hold float noise, not the port. A mesh without the batch axis
raises.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_time_limit import share_cores, time_limits
import torch_rank_cases as cases

share_cores()

_limit_module, _limit_test = time_limits(test_s=120, module_s=180)
gang = cases.gang_fixture(2)

S, LR, STEPS = 32, 1e-2, 2

#: case -> (tokens counted in each row of the global batch, grad_accum)
CASES = {
    "every_token": ((S, S), 1),
    "uneven_masks": ((30, 9), 1),
    "uneven_masks_accum": ((31, 4, 12, 25), 2),
}


@pytest.fixture(scope="module")
def jax(jax_cpu):
    return jax_cpu


@pytest.fixture(scope="module")
def runs(jax, gang):
    import jax.numpy as jnp

    from modal_examples_tpu.models import llama as jllama
    from modal_examples_tpu.models import lora as jlora
    from modal_examples_tpu.parallel import make_mesh
    from modal_examples_tpu.training import trainer as jtrainer

    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    jbase = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    jl = jlora.LoRAConfig(rank=4, alpha=8.0)
    adapters = jlora.init_lora(jax.random.PRNGKey(1), jbase, jl)
    rng = np.random.default_rng(2)  # b = 0 at init makes every a-gradient zero: give b values
    np_lora = {"layers": {
        k: (rng.standard_normal(v.shape).astype(np.float32) * 0.05 if k.endswith("_b") else np.asarray(v))
        for k, v in adapters["layers"].items()
    }}

    def loss(lora, b):
        logits = jllama.forward(jbase, b["tokens"], jcfg, attn_impl="xla", lora=lora, lora_scale=jl.scale)
        return jtrainer.cross_entropy_loss(logits[:, :-1], b["tokens"][:, 1:], b["mask"][:, 1:])

    mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    cfg_kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    results = {}
    for name, (lens, accum) in CASES.items():
        B = len(lens)
        batch = {"tokens": np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
                 "mask": (np.arange(S)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)}
        jt = jtrainer.Trainer(loss, jtrainer.make_optimizer(LR), mesh=mesh, grad_accum=accum)
        state = jt.init_state(jax.tree.map(jnp.asarray, np_lora))
        want = {"loss": [], "grad_norm": [], "adapters": []}
        micros = [jax.tree.map(lambda x: x.reshape(accum, B // accum, *x.shape[1:])[i], batch) for i in range(accum)]
        grads = [jax.grad(loss)(state.params, m) for m in micros]
        want["grads"] = {k: np.mean([np.asarray(g["layers"][k]) for g in grads], axis=0) for k in np_lora["layers"]}
        for _ in range(STEPS):
            state, m = jt.train_step(state, batch)
            want["loss"].append(float(m["loss"]))
            want["grad_norm"].append(float(m["grad_norm"]))
        want["adapters"] = {k: np.asarray(v) for k, v in state.params["layers"].items()}
        out = gang.run(cases.dp_train, jax.tree.map(np.asarray, jbase), cfg_kw, np_lora, {"rank": 4, "alpha": 8.0},
                       batch, LR, STEPS, accum)
        results[name] = (want, out)
    return results


@pytest.fixture(params=list(CASES))
def run(request, runs):
    return runs[request.param]


def _leaves_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * np.abs(want[k]).max(), err_msg=k)


def test_gradients_match_the_jax_trainer_over_the_global_batch(run):
    want, out = run
    for o in out:
        _leaves_close(o["dp"]["grads"], want["grads"])
        _leaves_close(o["one"]["grads"], want["grads"])


def test_losses_match_the_jax_data_parallel_trainer(run):
    want, out = run
    for o in out:
        np.testing.assert_allclose(o["dp"]["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(o["dp"]["grad_norm"], want["grad_norm"], rtol=1e-5)


def test_adapters_match_the_jax_data_parallel_trainer(runs):
    want, out = runs["every_token"]
    for o in out:
        _leaves_close(o["dp"]["adapters"], want["adapters"])


def test_ranks_stay_replicated(run):
    _, (r0, r1) = run
    assert r0["dp"]["loss"] == r1["dp"]["loss"]
    for k in r0["dp"]["adapters"]:
        np.testing.assert_array_equal(r0["dp"]["adapters"][k], r1["dp"]["adapters"][k])


def test_data_parallel_equals_the_one_rank_trainer(run):
    _, out = run
    for o in out:
        np.testing.assert_allclose(o["dp"]["loss"], o["one"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(o["dp"]["grad_norm"], o["one"]["grad_norm"], rtol=1e-5)
        _leaves_close(o["dp"]["grads"], o["one"]["grads"])


def test_param_specs_and_a_mesh_without_the_batch_axis_raise():
    """A mesh without the batch spec's axis raises, and so do placements
    over an axis the mesh lacks (``param_specs`` itself trains:
    ``tests/test_torch_tp_training.py``, ``tests/test_torch_fsdp.py``)."""
    import types

    from modal_examples_tpu_torch.parallel.mesh import P
    from modal_examples_tpu_torch.training import Trainer, make_optimizer

    tensor_only = types.SimpleNamespace(mesh_dim_names=("tensor",), shape=(2,))
    with pytest.raises(ValueError, match="lacks"):
        Trainer(lambda p, b: 0.0, make_optimizer(), mesh=tensor_only, batch_spec=P(), param_specs={"w": P("fsdp")})
    with pytest.raises(ValueError, match="no 'data' axis"):
        Trainer(lambda p, b: 0.0, make_optimizer(), mesh=tensor_only)
