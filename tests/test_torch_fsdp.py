"""ZeRO-3/FSDP training through the port's ``Trainer(param_specs=
fsdp_specs(params, mesh), batch_spec=P("fsdp"))``: the reference's
``tests/test_parallel.py::TestFSDP`` on the port, against the JAX trainer.

CPU rank processes over gloo at 1, 2 and 4 ranks (an ``fsdp`` axis of the
whole gang) each keep their block of every placed leaf and of its Adam
moments, all-gather a leaf on use and reduce-scatter its gradient back to
the block, and take their block of the batch (B=8 x S=32, split over
``fsdp``). The JAX trainer runs here on the same axis over the 8 host
devices, with the reference's configuration (f32, vocab 512, dim 128, 2
layers), its loss function and learning rate (1e-2). Held: per-rank bytes
of parameters plus moments shrink more than 1.6x at 2 ranks and 3.2x at 4
(the small replicated leaves keep them from 2x and 4x); the 3 steps' losses
within rtol 2e-3 of the one-rank run and of the JAX trainer's (the
reference's tolerance); the first step's gradients within 1e-5 of each
leaf's largest value against ``jax.grad``; the moments' blocks are their
parameters'; ``fsdp_specs`` places the leaves the JAX ``fsdp_specs`` places
(its rule reads the JAX tree's layer-stacked sizes); the replicated leaves'
gradients are bitwise equal on every rank.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_time_limit import share_cores, time_limits
import torch_rank_cases as cases

share_cores()

_limit_module, _limit_test = time_limits(test_s=120, module_s=300)

LR, STEPS = 1e-2, 3
CFG = dict(vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=256, max_seq_len=64,
           dtype="float32")
SHARDS = (1, 2, 4)


@pytest.fixture(scope="module")
def jax(jax_cpu):
    return jax_cpu


def _named(jtree, n_layers: int) -> dict:
    out = {k: v for k, v in jtree.items() if k != "layers"}
    for k, v in jtree["layers"].items():
        out.update({f"layers.{i}.{k}": v[i] if hasattr(v, "shape") else v for i in range(n_layers)})
    return out


@pytest.fixture(scope="module")
def runs(jax, tmp_path_factory):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from modal_examples_tpu.models import llama as jllama
    from modal_examples_tpu.parallel import fsdp_specs, make_mesh
    from modal_examples_tpu.training import trainer as jtrainer

    jcfg = jllama.LlamaConfig(**CFG)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0, 512)).astype(np.int32)
    batch = {"tokens": tokens}

    def loss(p, b):
        lg = jllama.forward(p, b["tokens"], jcfg, attn_impl="xla")
        return jtrainer.cross_entropy_loss(lg[:, :-1], b["tokens"][:, 1:])

    want_grads = {k: np.asarray(v) for k, v in _named(jax.grad(loss)(params, batch), jcfg.n_layers).items()}
    cfg_kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    results = {}
    for n in SHARDS:
        mesh = make_mesh({"fsdp": n}, devices=jax.devices()[:n])
        specs = fsdp_specs(params, mesh)
        jt = jtrainer.Trainer(loss, jtrainer.make_optimizer(LR), mesh=mesh, param_specs=specs, batch_spec=JP("fsdp"))
        state = jt.init_state(jax.tree.map(jnp.array, params))  # a copy: the step donates it
        losses = []
        for _ in range(STEPS):
            state, m = jt.train_step(state, jt.shard_batch(batch))
            losses.append(float(m["loss"]))
        with cases.open_gang(n, tmp_path_factory) as gang:  # one gang at a time
            out = gang.run(cases.parallel_train, jax.tree.map(np.asarray, params), cfg_kw, {"fsdp": n}, "fsdp",
                           batch, LR, STEPS, {"batch_spec": ("fsdp",)})
        results[n] = {"jax_loss": losses, "jax_specs": {k: tuple(v) for k, v in _named(specs, jcfg.n_layers).items()},
                      "out": out}
    return want_grads, results


@pytest.fixture(params=SHARDS)
def shards(request, runs):
    want_grads, results = runs
    return request.param, want_grads, results[request.param]


def test_memory_shrinks_with_the_shards(runs):
    _, results = runs
    one = results[1]["out"][0]["mesh"]["bytes"]
    assert one == results[1]["out"][0]["one"]["bytes"]
    for n, factor in ((2, 1.6), (4, 3.2)):
        for o in results[n]["out"]:
            assert o["mesh"]["bytes"] < one / factor, (n, one, o["mesh"]["bytes"])


def test_losses_match_one_rank_and_the_jax_trainer(shards):
    _, _, r = shards
    for o in r["out"]:
        np.testing.assert_allclose(o["mesh"]["loss"], o["one"]["loss"], rtol=2e-3)
        np.testing.assert_allclose(o["mesh"]["loss"], r["jax_loss"], rtol=2e-3)


def test_first_step_gradients_match_jax_grad(shards):
    _, want, r = shards
    for o in r["out"]:
        assert o["mesh"]["grads"].keys() == want.keys()
        for k, g in o["mesh"]["grads"].items():
            np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-5 * np.abs(want[k]).max(), err_msg=k)


def test_moments_are_placed_like_their_parameters(shards):
    n, _, r = shards
    for o in r["out"]:
        m = o["mesh"]
        assert m["moment_shapes"] == m["shapes"]
        for k, spec in m["placement"].items():
            whole = o["one"]["shapes"][k]
            want = tuple(s // n if e == "fsdp" else s for s, e in zip(whole, spec))
            assert m["shapes"][k] == want + tuple(whole[len(spec):]), k


def test_fsdp_specs_place_what_the_jax_specs_place(shards):
    """The port's per-layer placements are the JAX tree's stacked ones with
    the layer axis dropped: the rule reads the stacked sizes."""
    _, _, r = shards
    placement = r["out"][0]["mesh"]["placement"]
    assert placement.keys() == r["jax_specs"].keys()
    for k, spec in placement.items():
        jspec = r["jax_specs"][k]
        if k.startswith("layers.") and jspec:
            assert jspec[0] is None, k  # the layer axis is never the one split here
            jspec = jspec[1:]
        assert spec == jspec, (k, spec, jspec)


def test_replicated_gradients_are_bitwise_equal_on_every_rank(shards):
    _, _, r = shards
    first = r["out"][0]["mesh"]["replicated_grads"]
    assert "final_norm" in first
    for o in r["out"][1:]:
        assert o["mesh"]["replicated_grads"].keys() == first.keys()
        for k in first:
            np.testing.assert_array_equal(o["mesh"]["replicated_grads"][k], first[k], err_msg=k)
