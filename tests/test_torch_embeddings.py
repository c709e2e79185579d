"""The port's embedding path (``models/bert.py`` and the layer helpers it
uses) against the JAX package's, on the CPU.

Same weights (the JAX tree, every leaf perturbed by a seeded N(0, 0.02) so
zero biases and unit norms hide nothing, carried across by
``params_from_jax``), same numpy inputs. Tolerances: 1e-6 max abs for the
elementwise helpers, 1e-5 for the two-product MLP, 1e-4 for whole f32
encoders (XLA and PyTorch sum in other orders). Loaders: bitwise to the JAX
loader followed by ``params_from_jax`` on a synthetic HF checkpoint.
"""

import dataclasses

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import bert as jbert
from modal_examples_tpu.models import layers as jlayers
from modal_examples_tpu_torch.models import bert as tbert
from modal_examples_tpu_torch.models import layers as tlayers
from test_torch_time_limit import share_cores

share_cores()


def _perturbed(tree, seed: int):
    """Every leaf of a JAX tree as numpy, plus a seeded N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + rng.normal(0, 0.02, a.shape)).astype(np.float32), tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def assert_trees_bitwise(port, ref):
    """Same paths, dtypes and shapes; values equal bit for bit."""
    got, want = dict(_flat(port)), dict(_flat(ref))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        w = want[path]
        assert t.dtype == w.dtype and t.shape == w.shape, path
        assert torch.equal(t.view(torch.int16) if t.dtype == torch.bfloat16 else t,
                           w.view(torch.int16) if w.dtype == torch.bfloat16 else w), path


def _close(port, ref, atol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=atol)


# -- layer helpers ---------------------------------------------------------------


def test_layer_norm_and_quick_gelu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 96)).astype(np.float32) * 3 + 1
    w, b = (rng.standard_normal(96).astype(np.float32) for _ in range(2))
    _close(tlayers.layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-5),
           jlayers.layer_norm(*map(jnp.asarray, (x, w, b)), 1e-5), 1e-6)
    _close(tlayers.quick_gelu(torch.from_numpy(x)), jlayers.quick_gelu(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("exact", [True, False], ids=["erf", "tanh"])
def test_gelu_mlp_matches_jax(exact):
    rng = np.random.default_rng(1)
    p = {"fc_w": rng.standard_normal((64, 256)) * 0.1, "fc_b": rng.standard_normal(256) * 0.1,
         "proj_w": rng.standard_normal((256, 64)) * 0.1, "proj_b": rng.standard_normal(64) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    port = tlayers.gelu_mlp({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), exact=exact)
    ref = jlayers.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), exact=exact)
    _close(port, ref, 1e-5)
    # the two flavours differ by far more than the tolerance: the flag is seen
    other = tlayers.gelu_mlp({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), exact=not exact)
    assert (other - port).abs().max().item() > 1e-4


# -- bert -------------------------------------------------------------------------


def _bert(cfg_j, seed=0):
    np_params = _perturbed(jbert.init_params(jax.random.PRNGKey(seed), cfg_j), seed + 100)
    tcfg = tbert.BertConfig(**dataclasses.asdict(cfg_j))
    return np_params, tcfg, tbert.params_from_jax(np_params, tcfg, device="cpu")


def _tokens(cfg, B, S, seed=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for b in range(B):  # row b keeps S - 3b real tokens
        mask[b, S - 3 * b:] = 0
    return toks, mask


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_bert_forward_and_embed_match_jax(pooling):
    cfg = dataclasses.replace(jbert.BertConfig.tiny(), pooling=pooling)
    np_params, tcfg, tparams = _bert(cfg)
    toks, mask = _tokens(cfg, 3, 24)
    jp = jax.tree.map(jnp.asarray, np_params)
    h_ref = jbert.forward(jp, jnp.asarray(toks), jnp.asarray(mask), cfg)
    h = tbert.forward(tparams, torch.from_numpy(toks).long(), torch.from_numpy(mask), tcfg)
    _close(h, h_ref, 1e-4)
    e_ref = jbert.embed(jp, jnp.asarray(toks), jnp.asarray(mask), cfg)
    e = tbert.embed(tparams, torch.from_numpy(toks).long(), torch.from_numpy(mask), tcfg)
    assert e.dtype == torch.float32 and e.shape == (3, cfg.dim)
    _close(e, e_ref, 1e-5)
    np.testing.assert_allclose(torch.linalg.vector_norm(e, dim=-1).numpy(), 1.0, atol=1e-5)
    # without a mask every token is real
    _close(tbert.embed(tparams, torch.from_numpy(toks).long(), None, tcfg),
           jbert.embed(jp, jnp.asarray(toks), None, cfg), 1e-5)


def test_bert_padding_is_ignored_and_the_mask_is_seen():
    cfg = dataclasses.replace(jbert.BertConfig.tiny(), pooling="mean")
    _, tcfg, tparams = _bert(cfg)
    toks, mask = _tokens(cfg, 3, 24)
    t, m = torch.from_numpy(toks).long(), torch.from_numpy(mask)
    e = tbert.embed(tparams, t, m, tcfg)
    garbage = t.clone()
    garbage[m == 0] = 7  # other tokens where the mask says pad
    assert (tbert.embed(tparams, garbage, m, tcfg) - e).abs().max().item() < 1e-6
    assert (tbert.embed(tparams, t, None, tcfg) - e)[1:].abs().max().item() > 1e-3  # rows with padding move


def test_bert_at_bge_small_widths_matches_jax():
    """bge-small's widths (384, 12 heads of 32, ffn 1536, vocab 30522), depth 2."""
    cfg = dataclasses.replace(jbert.BertConfig.bge_small_en(), n_layers=2)
    np_params, tcfg, tparams = _bert(cfg, seed=3)
    toks, mask = _tokens(cfg, 2, 40)
    jp = jax.tree.map(jnp.asarray, np_params)
    _close(tbert.forward(tparams, torch.from_numpy(toks).long(), torch.from_numpy(mask), tcfg),
           jbert.forward(jp, jnp.asarray(toks), jnp.asarray(mask), cfg), 1e-4)
    _close(tbert.embed(tparams, torch.from_numpy(toks).long(), torch.from_numpy(mask), tcfg),
           jbert.embed(jp, jnp.asarray(toks), jnp.asarray(mask), cfg), 1e-5)


def _write_hf_bert(tmp_path, np_params, cfg):
    """The tree under HF BERT names ([out, in] linears, ``bert.`` prefix)."""
    raw = {
        "bert.embeddings.word_embeddings.weight": np_params["word_emb"],
        "bert.embeddings.position_embeddings.weight": np_params["pos_emb"],
        "bert.embeddings.token_type_embeddings.weight": np_params["type_emb"],
        "bert.embeddings.LayerNorm.weight": np_params["emb_norm_w"],
        "bert.embeddings.LayerNorm.bias": np_params["emb_norm_b"],
    }
    names = {
        "wq": "attention.self.query.weight", "bq": "attention.self.query.bias",
        "wk": "attention.self.key.weight", "bk": "attention.self.key.bias",
        "wv": "attention.self.value.weight", "bv": "attention.self.value.bias",
        "wo": "attention.output.dense.weight", "bo": "attention.output.dense.bias",
        "attn_norm_w": "attention.output.LayerNorm.weight", "attn_norm_b": "attention.output.LayerNorm.bias",
        "fc_w": "intermediate.dense.weight", "fc_b": "intermediate.dense.bias",
        "proj_w": "output.dense.weight", "proj_b": "output.dense.bias",
        "mlp_norm_w": "output.LayerNorm.weight", "mlp_norm_b": "output.LayerNorm.bias",
    }
    for i in range(cfg.n_layers):
        for ours, theirs in names.items():
            a = np_params["layers"][ours][i]
            raw[f"bert.encoder.layer.{i}.{theirs}"] = a.T if a.ndim == 2 else a
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in raw.items()}, str(tmp_path / "model.safetensors"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_load_hf_weights_is_bitwise_to_the_jax_loader(tmp_path, dtype):
    cfg = jbert.BertConfig.tiny()
    np_params, tcfg, _ = _bert(cfg, seed=4)
    _write_hf_bert(tmp_path, np_params, cfg)
    ref = jbert.load_hf_weights(tmp_path, cfg, dtype=jnp.dtype(dtype))
    want = tbert.params_from_jax(jax.tree.map(np.asarray, ref), dataclasses.replace(tcfg, dtype=dtype), device="cpu")
    got = tbert.load_hf_weights(tmp_path, tcfg, dtype=getattr(torch, dtype), device="cpu")
    assert_trees_bitwise(got, want)


def test_bert_entry_points_want_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = tbert.BertConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbert.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbert.load_hf_weights(tmp_path, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbert.params_from_jax({}, cfg)
    params = tbert.init_params(cfg, seed=0, device="cpu")
    assert params["word_emb"].device.type == "cpu" and params["word_emb"].dtype == torch.float32
