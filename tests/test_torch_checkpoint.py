"""Checkpoint loading in the port against the JAX package.

The port's safetensors reader and writer against the ``safetensors``
package, bitwise, for every dtype they take; ``quantize_weight_host``
bitwise to JAX's; ``load_hf_weights`` on a synthetic HF llama checkpoint
(written as ``tests/test_models.py::test_hf_weight_roundtrip`` writes one, in
two shards) bitwise to the JAX loader followed by ``params_from_jax``, in
f32, bf16 and int8; and ``build_engine(model_dir=...)``, whose engine serves
the checkpoint.
"""

import dataclasses
import json
import struct

import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

import jax

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.models import quantize as jquant
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.models import quantize as tquant
from modal_examples_tpu_torch.models.quantize import QuantizedWeight
from modal_examples_tpu_torch.serving.engine import build_engine
from modal_examples_tpu_torch.utils import safetensors as tst
from test_torch_time_limit import share_cores

share_cores()

DTYPES = ["BF16", "F16", "F32", "I8", "I32", "I64"]


def _tensors(dtype: str, seed: int = 0) -> dict:
    gen = torch.Generator().manual_seed(seed)
    t = tst.DTYPES[dtype]
    if t.is_floating_point:
        make = lambda *shape: torch.randn(shape, generator=gen).to(t)  # noqa: E731
    else:
        info = torch.iinfo(t)
        make = lambda *shape: torch.randint(max(info.min, -2**31), min(info.max, 2**31 - 1), shape,  # noqa: E731
                                            generator=gen).to(t)
    return {"a.weight": make(7, 5), "b": make(3), "scalar": make(), "empty": make(0, 4), "c.w": make(2, 3, 4)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_safetensors_round_trips_against_the_package(tmp_path, dtype):
    tensors = _tensors(dtype)
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.safetensors"
    tst.save_file(tensors, ours, metadata={"format": "pt", "note": dtype})
    safetensors.torch.save_file(tensors, str(theirs), metadata={"format": "pt"})
    for path in (ours, theirs):
        by_package = safetensors.torch.load_file(str(path))
        by_port = tst.load_file(path)
        assert sorted(by_port) == sorted(by_package) == sorted(tensors)
        for name, want in tensors.items():
            for got in (by_port[name], by_package[name]):
                assert got.dtype == want.dtype and got.shape == want.shape
                assert torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))
    with tst.SafeFile(ours) as f:
        assert f.metadata() == {"format": "pt", "note": dtype}
    with safetensors.safe_open(str(ours), framework="pt") as f:
        assert f.metadata() == {"format": "pt", "note": dtype}


def _write_raw(path, header: dict | bytes, data: bytes = b"", length: int | None = None):
    raw = header if isinstance(header, bytes) else json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw) if length is None else length) + raw + data)


@pytest.mark.parametrize("case", ["short", "header past the end", "not json", "not an object", "unknown dtype",
                                  "offsets past the data", "offsets and shape disagree", "bad shape",
                                  "metadata not strings"])
def test_malformed_safetensors_are_refused(tmp_path, case):
    path = tmp_path / "bad.safetensors"
    good = {"x": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}}
    if case == "short":
        path.write_bytes(b"\x01\x00")
    elif case == "header past the end":
        _write_raw(path, good, bytes(8), length=10_000)
    elif case == "not json":
        _write_raw(path, b"{not json", bytes(8))
    elif case == "not an object":
        _write_raw(path, b"[1, 2]")
    elif case == "unknown dtype":
        _write_raw(path, {"x": {"dtype": "X9", "shape": [2], "data_offsets": [0, 2]}}, bytes(2))
    elif case == "offsets past the data":
        _write_raw(path, good, bytes(4))
    elif case == "offsets and shape disagree":
        _write_raw(path, {"x": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, bytes(8))
    elif case == "bad shape":
        _write_raw(path, {"x": {"dtype": "F32", "shape": [-2], "data_offsets": [0, 8]}}, bytes(8))
    else:
        _write_raw(path, {**good, "__metadata__": {"k": 1}}, bytes(8))
    with pytest.raises(ValueError):
        tst.load_file(path)
    with pytest.raises(Exception):  # the package refuses each of them too
        safetensors.torch.load_file(str(path))


# -- host quantization --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 48), (2, 96, 40)])
def test_quantize_weight_host_is_bitwise_jax(dtype, shape):
    rng = np.random.default_rng(3)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel: scale 1, q 0
    w[..., 1] = np.linspace(-127, 127, shape[-2]) / 127.0  # exact ties at scale 1/127
    if dtype == "bfloat16":
        w_j, w_t = w.astype(ml_dtypes.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    else:
        w_j, w_t = w, torch.from_numpy(w)
    want = jquant.quantize_weight_host(w_j)
    got = tquant.quantize_weight_host(w_t, device="cpu")
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert torch.equal(got.q, tquant.quantize_weight_host(w_t.numpy() if dtype == "float32" else w_t, device="cpu").q)


def test_quantize_weight_host_int4_names_a2():
    with pytest.raises(NotImplementedError, match="A2"):
        tquant.quantize_weight_host(torch.ones(4, 4), bits=4, device="cpu")


# -- load_hf_weights -----------------------------------------------------------------

HF = {
    "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight", "wv": "self_attn.v_proj.weight",
    "wo": "self_attn.o_proj.weight", "gate": "mlp.gate_proj.weight", "up": "mlp.up_proj.weight",
    "down": "mlp.down_proj.weight",
}
NORMS = {"attn_norm": "input_layernorm.weight", "mlp_norm": "post_attention_layernorm.weight"}
EXPERTS = {"moe_gate": "w1", "moe_up": "w3", "moe_down": "w2"}


def _hf_config(tie: bool = False) -> dict:
    return {
        "model_type": "llama", "vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 1, "intermediate_size": 48,
        "max_position_embeddings": 256, "tie_word_embeddings": tie,
    }


def write_checkpoint(path, cfg_json: dict, seed: int = 0, *, bf16: bool = False) -> dict:
    """Random f32 JAX params under HF llama names (Mixtral's
    ``block_sparse_moe`` names for a config with ``num_local_experts``), in
    two shards (layer 0 with the embeddings, the rest in the second), plus
    ``config.json``. ``bf16`` stores every tensor as BF16 (through the
    package's torch writer). Returns the HF-named arrays."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg_json))
    jcfg = dataclasses.replace(jllama.LlamaConfig.from_hf_config(path / "config.json"), dtype="float32")
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(seed), jcfg))
    raw = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    if not jcfg.tie_embeddings:
        raw["lm_head.weight"] = np.ascontiguousarray(params["lm_head"].T)
    for i in range(jcfg.n_layers):
        for ours, name in HF.items():
            if ours in params["layers"]:
                raw[f"model.layers.{i}.{name}"] = np.ascontiguousarray(params["layers"][ours][i].T)
        if jcfg.n_experts:
            raw[f"model.layers.{i}.block_sparse_moe.gate.weight"] = np.ascontiguousarray(params["layers"]["router"][i].T)
            for ours, name in EXPERTS.items():
                for e in range(jcfg.n_experts):
                    raw[f"model.layers.{i}.block_sparse_moe.experts.{e}.{name}.weight"] = np.ascontiguousarray(
                        params["layers"][ours][i][e].T)
        for ours, name in NORMS.items():
            raw[f"model.layers.{i}.{name}"] = np.ascontiguousarray(params["layers"][ours][i])
    shards = [{k: v for k, v in raw.items() if ".layers.1." not in k}, {k: v for k, v in raw.items() if ".layers.1." in k}]
    for n, shard in enumerate(shards):
        name = path / f"model-0000{n + 1}-of-00002.safetensors"
        if bf16:
            safetensors.torch.save_file({k: torch.tensor(v).to(torch.bfloat16) for k, v in shard.items()}, str(name))
        else:
            safetensors.numpy.save_file(shard, str(name))
    return raw


def _assert_tree_equal(got, want, path="params"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, QuantizedWeight):
        assert isinstance(got, QuantizedWeight), path
        _assert_tree_equal(got.q, want.q, path + ".q")
        _assert_tree_equal(got.scale, want.scale, path + ".scale")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert got.is_contiguous(), path
        assert torch.equal(got, want), path


@pytest.mark.parametrize("dtype,quantization,tie", [
    ("float32", None, False), ("bfloat16", None, False), ("float32", "int8", False), ("bfloat16", "int8", False),
    ("float32", None, True),
])
def test_load_hf_weights_is_bitwise_the_jax_loader(tmp_path, dtype, quantization, tie):
    write_checkpoint(tmp_path, _hf_config(tie))
    jcfg = dataclasses.replace(jllama.LlamaConfig.from_hf_config(tmp_path / "config.json"), dtype=dtype)
    tcfg = dataclasses.replace(tllama.LlamaConfig.from_hf_config(tmp_path / "config.json"), dtype=dtype)
    jparams = jllama.load_hf_weights(tmp_path, jcfg, quantization=quantization)
    want = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    got = tllama.load_hf_weights(tmp_path, tcfg, quantization=quantization, device="cpu")
    assert ("lm_head" in got) == (not tie)
    if quantization:
        assert isinstance(got["lm_head"], QuantizedWeight) and isinstance(got["layers"][1]["down"], QuantizedWeight)
        assert got["embed"].dtype == tcfg.torch_dtype  # embeddings and norms keep the model dtype
    _assert_tree_equal(got, want)


def test_load_hf_weights_reads_bf16_checkpoints(tmp_path):
    """A BF16 checkpoint (which the JAX loader's numpy reader cannot open)
    loads to exactly the stored values, transposed, in bf16 and int8."""
    write_checkpoint(tmp_path, _hf_config(), bf16=True)
    stored = {}
    for shard in sorted(tmp_path.glob("*.safetensors")):
        stored.update(safetensors.torch.load_file(str(shard)))
    cfg = tllama.LlamaConfig.from_hf_config(tmp_path / "config.json")
    got = tllama.load_hf_weights(tmp_path, cfg, device="cpu")
    assert torch.equal(got["embed"], stored["model.embed_tokens.weight"])
    assert torch.equal(got["lm_head"], stored["lm_head.weight"].T)
    for i in range(cfg.n_layers):
        for ours, name in HF.items():
            assert torch.equal(got["layers"][i][ours], stored[f"model.layers.{i}.{name}"].T)
        for ours, name in NORMS.items():
            assert torch.equal(got["layers"][i][ours], stored[f"model.layers.{i}.{name}"])
    q = tllama.load_hf_weights(tmp_path, cfg, quantization="int8", device="cpu")
    want = tquant.quantize_weight_host(stored["model.layers.1.mlp.down_proj.weight"].T.contiguous(), device="cpu")
    assert torch.equal(q["layers"][1]["down"].q, want.q) and torch.equal(q["layers"][1]["down"].scale, want.scale)


def test_load_hf_weights_refusals(tmp_path):
    cfg = tllama.LlamaConfig.from_hf_config
    with pytest.raises(FileNotFoundError):
        tllama.load_hf_weights(tmp_path, tllama.LlamaConfig.tiny(), device="cpu")
    raw = write_checkpoint(tmp_path, _hf_config())
    with pytest.raises(NotImplementedError, match="A2"):
        tllama.load_hf_weights(tmp_path, cfg(tmp_path / "config.json"), quantization="int4", device="cpu")
    (tmp_path / "model-00002-of-00002.safetensors").unlink()
    with pytest.raises(KeyError, match="model.layers.1"):
        tllama.load_hf_weights(tmp_path, cfg(tmp_path / "config.json"), device="cpu")
    # a mixture of experts loads; an expert missing from its stack is named
    moe_dir = tmp_path / "moe"
    moe_raw = write_checkpoint(moe_dir, {**_hf_config(), "num_local_experts": 4, "num_experts_per_tok": 2})
    moe = tllama.load_hf_weights(moe_dir, cfg(moe_dir / "config.json"), device="cpu")
    assert moe["layers"][1]["moe_down"].shape == (4, 48, 32) and moe["layers"][1]["router"].shape == (32, 4)
    assert torch.equal(moe["layers"][1]["moe_down"][3], torch.from_numpy(
        moe_raw["model.layers.1.block_sparse_moe.experts.3.w2.weight"]).T.to(moe["layers"][1]["moe_down"].dtype))
    shard = safetensors.numpy.load_file(str(moe_dir / "model-00002-of-00002.safetensors"))
    del shard["model.layers.1.block_sparse_moe.experts.2.w3.weight"]
    safetensors.numpy.save_file(shard, str(moe_dir / "model-00002-of-00002.safetensors"))
    with pytest.raises(KeyError, match=r"model\.layers\.1\.block_sparse_moe\.experts\.\*\.w3"):
        tllama.load_hf_weights(moe_dir, cfg(moe_dir / "config.json"), device="cpu")


def test_build_engine_loads_the_checkpoint_as_the_jax_engine(tmp_path):
    """``build_engine(model_dir=...)`` on both packages reads the same
    config, falls back to the byte tokenizer (the directory has no tokenizer
    files) and serves bitwise the JAX engine's weights, bf16 and int8;
    ``LLMEngine(cfg, model_dir=...)`` in f32 serves the JAX engine's greedy
    tokens."""
    from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
    from modal_examples_tpu.serving.engine import build_engine as jbuild
    from modal_examples_tpu.serving.sampling import SamplingParams as JP
    from modal_examples_tpu_torch import LLMEngine, SamplingParams

    write_checkpoint(tmp_path, {**_hf_config(), "vocab_size": 300})
    kw = dict(max_slots=2, max_model_len=64, prefill_buckets=(16, 32), enable_prefix_cache=False)
    for quantization in (None, "int8"):
        jeng = jbuild(model_dir=str(tmp_path), quantization=quantization, **kw)
        teng = build_engine(model_dir=str(tmp_path), quantization=quantization, device="cpu", **kw)
        try:
            ported = dataclasses.asdict(teng.cfg)  # the JAX config's dense fields
            assert ported == {k: v for k, v in dataclasses.asdict(jeng.cfg).items() if k in ported}
            assert type(teng.tokenizer).__name__ == type(jeng.tokenizer).__name__ == "ByteTokenizer"
            want = tllama.params_from_jax(jax.tree.map(np.asarray, jeng.params), teng.cfg, device="cpu")
            _assert_tree_equal(teng.params, want)
        finally:
            jeng.stop()
            teng.stop()
    jcfg = dataclasses.replace(jllama.LlamaConfig.from_hf_config(tmp_path / "config.json"), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.from_hf_config(tmp_path / "config.json"), dtype="float32")
    jeng = JaxEngine(jcfg, model_dir=str(tmp_path), kv_dtype="float32", **kw)
    teng = LLMEngine(tcfg, model_dir=str(tmp_path), kv_dtype="float32", device="cpu", **kw)
    try:
        for prompt in ("checkpoint", "z" * 40):
            jr = jeng.submit(prompt, JP(max_tokens=5, temperature=0.0))
            tr = teng.submit(prompt, SamplingParams(max_tokens=5, temperature=0.0))
            assert "".join(teng.stream(tr)) == "".join(jeng.stream(jr))
            assert (tr.generated_tokens, tr.finish_reason) == (jr.generated_tokens, jr.finish_reason)
    finally:
        jeng.stop()
        teng.stop()
    # the mixture-of-experts presets: the JAX engine's configs, and the tiny one serves
    from modal_examples_tpu.serving.engine import MODEL_PRESETS as JAX_PRESETS
    from modal_examples_tpu_torch.serving.engine import MODEL_PRESETS

    for name in ("mixtral-8x7b", "tiny-moe"):
        assert dataclasses.asdict(MODEL_PRESETS[name]()) == dataclasses.asdict(JAX_PRESETS[name]())
    teng = build_engine("tiny-moe", device="cpu", **kw)
    try:
        assert teng.cfg.n_experts == 4 and teng.params["layers"][0]["moe_gate"].shape == (4, 128, 256)
        req = teng.submit("experts", SamplingParams(max_tokens=4, temperature=0.0))
        "".join(teng.stream(req))
        assert req.finish_reason == "length" and len(req.generated_tokens) == 4
    finally:
        teng.stop()
    with pytest.raises(ValueError, match="unknown model preset"):
        build_engine("llama9", device="cpu")


def test_a_directory_without_tokenizer_files_serves_bytes(tmp_path):
    """A bare ``config.json`` (which some ``transformers`` versions turn into
    a tokenizer with no vocabulary) gives the byte tokenizer, as the JAX
    package falls back when ``transformers`` refuses the directory."""
    from modal_examples_tpu.utils.tokenizer import load_tokenizer as jload
    from modal_examples_tpu_torch.utils.tokenizer import load_tokenizer

    (tmp_path / "config.json").write_text(json.dumps(_hf_config()))
    tok = load_tokenizer(str(tmp_path))
    assert type(tok).__name__ == "ByteTokenizer" and tok.encode("hi") == [256, 104, 105]
    assert type(jload(str(tmp_path))).__name__ == "ByteTokenizer"
    assert type(load_tokenizer(None)).__name__ == "ByteTokenizer"
