"""Tensor-parallel training through the port's ``Trainer(param_specs=
llama.partition_specs(cfg))`` against the JAX ``Trainer`` on the same mesh.

CPU rank processes over gloo each hold their blocks of the tree (the
column-parallel in-projections, the row-parallel out-projections, the
vocabulary-split embedding, each expert's ffn block) and train them with
the reference's own loss function, which calls ``llama.forward`` without a
mesh: the trainer enters its mesh around the step, as the JAX trainer does.
The JAX trainer runs here over the 8 host devices, f32, on the same mesh
and placements. Cases:

- ``data_tensor_*``: the reference's ``tests/test_training.py`` case, a
  ``{"data": 2, "tensor": 2}`` mesh on a gang of 4 (B=8 x S=64 split over
  ``data``), with the ``xla`` attention and with ``flash`` (the flash
  kernels' plain versions here). The JAX side runs ``xla`` for both: a
  Pallas kernel is not auto-partitioned, and the two attentions compute the
  same function.
- ``tensor_*``: ``{"tensor": 2}`` on a gang of 2 (B=2 x S=32 on both
  ranks): ``LlamaConfig.tiny`` (GQA), the same with a tied head (also
  under ``remat``, the forward recomputed in the backward), and
  ``tiny_moe`` on the capacity experts (the load-balance loss weighted
  0.01) and on the no-drop experts. ``tensor_dense_clip_off`` trains the dense case with a clip above
  the norm.

The learning rate is the reference's, 1e-3 (:data:`LR`). Held: the first step's gradients (``Trainer.loss_and_grads``, each rank's
blocks gathered) within 1e-5 of each leaf's largest value against
``jax.grad`` of the JAX trainer's loss, the first loss and grad norm within
1e-5 relative of the JAX trainer's and the second within 1e-3
(:data:`AFTER_UPDATE_RTOL` says why), both also against the port's one-rank
trainer; ``wq``'s block on each rank is the shape ``P(None, None,
"tensor")`` implies, and the Adam moments' blocks are the parameters';
replicated leaves' gradients (the norms, the router) are bitwise equal on
every rank; the first moments after one step are ``(1 - b1)`` times the
JAX gradients scaled by ``clip / norm`` with the JAX norm where the norm is
above the clip, and unscaled where it is not (the clip engages, by the
one-card norm). ``test_..._on_card`` (marked ``gpu``) trains at
TP=2 on the card through the flash kernels.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_time_limit import share_cores, time_limits
import torch_rank_cases as cases

share_cores()

_limit_module, _limit_test = time_limits(test_s=120, module_s=300)

#: the reference's learning rate (tests/test_training.py) and the steps held
LR, STEPS = 1e-3, 2
#: the loss and norm after the first update, against the JAX trainer's and
#: the one-rank trainer's (relative). Adam's first step moves every element
#: by about the rate whatever its gradient's size, so an element whose
#: gradient is float noise moves by +-LR on the noise's sign: in
#: ``tensor_dense`` one embedding element (gradient 1.8e-7, of a leaf whose
#: largest is 0.89) takes the other sign at TP=2, and the second step's loss
#: moves by 2e-5 and its norm by 3.6e-4 relative. With that one element
#: (parameter and moments) set to the one-rank trainer's, the second step
#: agrees within 1e-7 (loss) and 3e-7 (norm). The JAX trainer's own TP=2
#: and one-device runs differ by 3.5e-5 in that norm. The first step's
#: gradients, loss, norm and moments are held at 1e-5.
AFTER_UPDATE_RTOL = 1e-3
#: the reference's configuration (tests/test_training.py)
REFERENCE_CFG = dict(vocab_size=64, dim=64, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                     dtype="float32")

#: case -> (config, mesh axes, global batch (B, S), options of cases.parallel_train)
CASES = {
    "data_tensor_xla": ("reference", {"data": 2, "tensor": 2}, (8, 64), {"attn_impl": "xla"}),
    "data_tensor_flash": ("reference", {"data": 2, "tensor": 2}, (8, 64), {"attn_impl": "flash"}),
    "tensor_dense": ("tiny", {"tensor": 2}, (2, 32), {"batch_spec": ()}),
    "tensor_dense_clip_off": ("tiny", {"tensor": 2}, (2, 32), {"batch_spec": (), "grad_clip": 1e3}),
    "tensor_tied": ("tiny_tied", {"tensor": 2}, (2, 32), {"batch_spec": ()}),
    "tensor_tied_remat": ("tiny_tied", {"tensor": 2}, (2, 32), {"batch_spec": (), "remat": True}),
    "tensor_moe_capacity": ("tiny_moe", {"tensor": 2}, (2, 32),
                            {"batch_spec": (), "moe_impl": "capacity", "aux_weight": 0.01}),
    "tensor_moe_nodrop": ("tiny_moe", {"tensor": 2}, (2, 32), {"batch_spec": (), "moe_impl": "nodrop"}),
}


@pytest.fixture(scope="module")
def jax(jax_cpu):
    return jax_cpu


def _jax_cfg(jllama, name: str):
    if name == "reference":
        return jllama.LlamaConfig(**REFERENCE_CFG)
    base = jllama.LlamaConfig.tiny_moe() if name == "tiny_moe" else jllama.LlamaConfig.tiny()
    return dataclasses.replace(base, dtype="float32", tie_embeddings=name == "tiny_tied")


def _named(jgrads, n_layers: int) -> dict:
    out = {k: np.asarray(v) for k, v in jgrads.items() if k != "layers"}
    for k, v in jgrads["layers"].items():
        out.update({f"layers.{i}.{k}": np.asarray(v[i]) for i in range(n_layers)})
    return out


def _world(axes: dict) -> int:
    return int(np.prod(list(axes.values())))


def _jax_run(jax, case: str):
    """The JAX side of a case: its config, params and batch, ``jax.grad``
    of the loss, and the JAX trainer's 2 steps on the case's mesh."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from modal_examples_tpu.models import llama as jllama
    from modal_examples_tpu.parallel import make_mesh
    from modal_examples_tpu.training import trainer as jtrainer

    cfg_name, axes, (B, S), opts = CASES[case]
    jcfg = _jax_cfg(jllama, cfg_name)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, jcfg.vocab_size)).astype(np.int32)
    o = {**cases.TRAIN_OPTS, **opts}
    capacity = o["moe_impl"] == "capacity"

    def loss(p, b):
        out = jllama.forward(p, b["tokens"], jcfg, attn_impl="xla", moe_impl=o["moe_impl"], return_aux=capacity)
        logits, aux = out if capacity else (out, 0.0)
        return jtrainer.cross_entropy_loss(logits[:, :-1], b["tokens"][:, 1:]) + o["aux_weight"] * aux

    mesh = make_mesh(axes, devices=jax.devices()[:_world(axes)])
    jt = jtrainer.Trainer(loss, jtrainer.make_optimizer(LR, grad_clip=o["grad_clip"]), mesh=mesh,
                          param_specs=jllama.partition_specs(jcfg), batch_spec=JP(*o["batch_spec"]),
                          remat=o["remat"])
    batch = {"tokens": tokens}
    want = {"grads": _named(jax.grad(loss)(params, batch), jcfg.n_layers), "loss": [], "grad_norm": []}
    state = jt.init_state(jax.tree.map(jnp.array, params))  # a copy: the step donates it
    for _ in range(STEPS):
        state, m = jt.train_step(state, batch)
        want["loss"].append(float(m["loss"]))
        want["grad_norm"].append(float(m["grad_norm"]))
    want["wq_spec"] = tuple(state.params["layers"]["wq"].sharding.spec)
    return jcfg, jax.tree.map(np.asarray, params), batch, want


@pytest.fixture(scope="module")
def runs(jax, tmp_path_factory):
    results = {}
    for world in sorted({_world(axes) for _, axes, _, _ in CASES.values()}):  # one gang at a time
        with cases.open_gang(world, tmp_path_factory) as gang:
            for case, (_, axes, _, opts) in CASES.items():
                if _world(axes) != world:
                    continue
                jcfg, params, batch, want = _jax_run(jax, case)
                cfg_kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
                out = gang.run(cases.parallel_train, params, cfg_kw, axes, "tp", batch, LR, STEPS, opts)
                results[case] = (jcfg, want, out)
    return results


@pytest.fixture(params=list(CASES))
def run(request, runs):
    return (request.param, *runs[request.param])


def _leaves_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * np.abs(want[k]).max(), err_msg=k)


def test_first_step_gradients_match_jax_grad(run):
    _, _, want, out = run
    for o in out:
        _leaves_close(o["mesh"]["grads"], want["grads"])


def _steps_close(got: dict, want: dict):
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key][0], want[key][0], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(got[key][1:], want[key][1:], rtol=AFTER_UPDATE_RTOL, err_msg=key)


def test_losses_and_norms_match_the_jax_trainer(run):
    _, _, want, out = run
    for o in out:
        _steps_close(o["mesh"], want)


def test_tensor_parallel_equals_the_one_rank_trainer(run):
    _, _, _, out = run
    for o in out:
        _steps_close(o["mesh"], o["one"])
        _leaves_close(o["mesh"]["grads"], o["one"]["grads"])


def test_blocks_follow_the_partition_specs(run):
    _, jcfg, want, out = run
    assert want["wq_spec"] == (None, None, "tensor")
    q_cols = jcfg.n_heads * (jcfg.dim // jcfg.n_heads)
    for o in out:
        m = o["mesh"]
        for i in range(jcfg.n_layers):
            assert m["placement"][f"layers.{i}.wq"] == (None, "tensor")
            assert m["shapes"][f"layers.{i}.wq"] == (jcfg.dim, q_cols // 2)
        assert m["shapes"]["embed"] == (jcfg.vocab_size // 2, jcfg.dim)
        assert m["moment_shapes"] == m["shapes"]
        assert m["bytes"] < 0.55 * o["one"]["bytes"]


def test_replicated_gradients_are_bitwise_equal_on_every_rank(run):
    name, jcfg, _, out = run
    keys = out[0]["mesh"]["replicated_grads"].keys()
    assert {"final_norm", "layers.0.attn_norm", "layers.0.mlp_norm"} <= set(keys)
    if jcfg.n_experts:
        assert "layers.0.router" in keys
    for o in out[1:]:
        assert o["mesh"]["replicated_grads"].keys() == keys
        for k in keys:
            np.testing.assert_array_equal(o["mesh"]["replicated_grads"][k], out[0]["mesh"]["replicated_grads"][k],
                                          err_msg=f"{name} {k}")


def test_the_clip_engages_by_the_one_card_norm(run):
    """After one step the first moments are (1 - b1) times the clipped
    gradients: the JAX gradients times ``clip / norm`` (the JAX trainer's
    norm) where the norm is above the clip, as they are where it is not."""
    name, _, want, out = run
    clip = {**cases.TRAIN_OPTS, **CASES[name][3]}["grad_clip"]
    norm = want["grad_norm"][0]
    assert (norm > clip) == (name != "tensor_dense_clip_off")
    scale = (1 - 0.9) * min(1.0, clip / norm)
    for o in out:
        _leaves_close(o["mesh"]["mu_1"], {k: scale * g for k, g in want["grads"].items()})


#: the card test's model: one layer, so a step launches each flash kernel once
CARD_CFG = dict(vocab_size=512, dim=256, n_layers=1, n_heads=4, n_kv_heads=2, ffn_dim=512, max_seq_len=256,
                dtype="bfloat16")
CARD_BATCH, CARD_STEPS = (2, 128), 2


@pytest.mark.gpu
def test_tp_training_launches_each_flash_kernel_once_a_step_on_the_rank_heads_on_card():
    """Two gloo ranks sharing the card train a one-layer bf16 model at TP=2
    with the flash kernels: each step launches K1, K5 and K6 once, at the
    rank's heads (2 of 4 query heads, 1 of 2 kv heads, D=64)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    from modal_examples_tpu_torch.ops import _build
    from modal_examples_tpu_torch.parallel.cluster import RankGang

    _build.build()
    with RankGang(2, backend="gloo", device="cuda", env=cases.RANK_ENV) as g:
        out = g.run(cases.tp_train_on_card, CARD_CFG, CARD_BATCH, CARD_STEPS)
    B, S = CARD_BATCH
    D = CARD_CFG["dim"] // CARD_CFG["n_heads"]
    q, kv = (B, CARD_CFG["n_heads"] // 2, S, D), (B, CARD_CFG["n_kv_heads"] // 2, S, D)
    for o in out:
        assert o["per_step"] == [[1, 1, 1]] * CARD_STEPS
        assert o["shapes"] == sorted((name, q, kv) for name in
                                     ("flash_bwd_dkv_cuda", "flash_bwd_dq_cuda", "flash_forward_cuda"))
        assert all(np.isfinite(o["losses"]))
    assert out[0]["losses"] == out[1]["losses"]
