"""The flash kernels at every head dim the reference computes at (ROADMAP
C12): the port's wrappers zero-pad a head dim no kernel is built at up to
the next instance (``ops.flash_attention.at_instance``) and slice the
outputs back.

On the CPU the helper is driven with the plain versions as its launcher, so
the padded route itself is held against the JAX package's Pallas kernels
(in interpret mode, as its own tests run them): f32 at the GPT sweep's head
dim 16 (``examples/06_gpu_and_ml/hyperparameter-sweep/hp_sweep_gpt.py``,
dim 64 over 4 heads, block 128, batch 8), forward and all three gradients,
within 1e-5 of the largest value (f32 sums in another order); bf16 at D=80
and 96, forward, within K1's bf16 tolerance (``chip_smoke.TOL``, max abs:
one bf16 rounding of o apart). Every head dim that the reference's shipped
configs and examples reach is taken in its dtype; what no instance takes
(f32 above 128, anything above 256) is refused, naming the departure.
``tests/test_torch_flash_f32_card.py`` runs the padded route on the card.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from modal_examples_tpu.models import diffusion as jdiffusion
from modal_examples_tpu.models import gpt as jgpt
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu_torch.ops import flash_attention as tfa
from test_torch_time_limit import share_cores

share_cores()

jfa = importlib.import_module("modal_examples_tpu.ops.flash_attention")

F32_REL = 1e-5


def recording(launch, seen: list):
    """``launch`` that records the head dim it was given."""

    def call(*args, **kw):
        seen.append(args[0].shape[-1])
        return launch(*args, **kw)

    return call


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got.float(), np.float32) - want).max() / np.abs(want).max())


def test_f32_head_dim_16_padded_to_32_matches_the_pallas_kernels():
    B, H, S, D = 8, 4, 128, 16  # the GPT sweep's dim-64 runs
    rng = np.random.default_rng(26)
    q, k, v, do = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(4))
    (want_o, want_lse), vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_with_lse(q, k, v, causal=True),
                                      *map(jnp.asarray, (q, k, v)))
    want_dq, want_dk, want_dv = vjp((jnp.asarray(do), jnp.zeros((B, H, S), jnp.float32)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    scale = D**-0.5  # resolved from the true D, as _resolve_scale does before the wrappers
    seen = []
    o, lse = tfa.at_instance(recording(tfa.flash_forward_f32_plain, seen), tq, tk, tv, causal=True, sm_scale=scale)
    args = (tq, tk, tv, tdo, lse, (tdo * o).sum(dim=-1), torch.zeros(B, H, S))
    dq = tfa.at_instance(recording(tfa.flash_bwd_dq_f32_plain, seen), *args, causal=True, sm_scale=scale)
    dk, dv = tfa.at_instance(recording(tfa.flash_bwd_dkv_f32_plain, seen), *args, causal=True, sm_scale=scale)
    assert seen == [32, 32, 32]
    assert all(t.shape == (B, H, S, D) for t in (o, dq, dk, dv))
    errs = {"o": rel(o, want_o), "lse": rel(lse, want_lse), "dq": rel(dq, want_dq), "dk": rel(dk, want_dk),
            "dv": rel(dv, want_dv)}
    assert max(errs.values()) <= F32_REL, errs


@pytest.mark.parametrize("D", [80, 96])
def test_bf16_head_dims_between_instances_padded_to_128_match_the_pallas_kernel(D):
    B, Hq, Hkv, S = 1, 4, 2, 128
    rng = np.random.default_rng(D)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32) for _ in range(2))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    want = jfa.flash_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv)), causal=True)
    seen = []
    o, _ = tfa.at_instance(recording(tfa.flash_forward_plain, seen), tq, tk, tv, causal=True, sm_scale=D**-0.5)
    assert seen == [128] and o.dtype == torch.bfloat16 and o.shape == (B, Hq, S, D)
    err = float(np.abs(o.float().numpy() - np.asarray(want, np.float32)).max())
    assert err <= cs.TOL["flash_fwd"], err


def test_the_backward_pads_once_for_both_kernels(monkeypatch):
    """``_flash_backward`` on the card runs ``at_instance(_backward_kernels,
    ...)``: q, k, v and do are padded once and the same padded tensors go
    to the dQ and the dK/dV wrappers, whose outputs come back as views of
    the first D columns. Driven here with the plain versions standing in
    for the two wrappers."""
    B, H, S, D = 2, 4, 32, 16
    gen = torch.Generator().manual_seed(26)
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen) for _ in range(4))
    o, lse = tfa.flash_forward_plain(q, k, v, causal=True, sm_scale=D**-0.5)
    dlse = torch.zeros(B, H, S)
    given = []

    def stand_in(plain):
        def call(*args, **kw):
            given.append(args[:4])
            return plain(*args, **kw)

        return call

    monkeypatch.setattr(tfa, "flash_bwd_dq_cuda", stand_in(tfa.flash_bwd_dq_plain))
    monkeypatch.setattr(tfa, "flash_bwd_dkv_cuda", stand_in(tfa.flash_bwd_dkv_plain))
    args = (q, k, v, do, lse, (do * o).sum(dim=-1), dlse)
    dq, dk, dv = tfa.at_instance(tfa._backward_kernels, *args, causal=True, sm_scale=D**-0.5)
    assert len(given) == 2 and all(a is b for a, b in zip(*given))
    assert all(t.shape[-1] == 32 for t in given[0])
    want = tfa.flash_backward_plain(q, k, v, o, lse, do, dlse, causal=True, sm_scale=D**-0.5)
    for got, w in zip((dq, dk, dv), want):
        assert got.shape == (B, H, S, D) and got.stride(-2) == 32  # a view, not a copy
        torch.testing.assert_close(got, w, rtol=0, atol=1e-6)


def test_an_instance_head_dim_launches_its_inputs_as_they_are():
    """An instance's own D is neither copied nor sliced: the launcher gets
    the caller's tensors and its outputs come back as they are."""
    q = torch.randn(1, 2, 16, 64)
    got = []

    def launch(*args, **kw):
        got.extend(args)
        return args[0], None

    out = tfa.at_instance(launch, q, q, q, causal=True, sm_scale=0.125)
    assert all(a is q for a in got) and out[0] is q


def _shipped_configs():
    """(name, head dim, dtype) of the reference's shipped configs whose
    attention can reach the flash kernels, and of the GPT sweep's example."""
    out = [("GPTConfig()", jgpt.GPTConfig()), ("GPTConfig.tiny()", jgpt.GPTConfig.tiny())]
    out += [(f"hp_sweep_gpt dim={dim}", jgpt.GPTConfig(block_size=128, n_layers=4, n_heads=4, dim=dim))
            for dim in (64, 128)]
    out += [(f"LlamaConfig.{name}()", getattr(jllama.LlamaConfig, name)())
            for name in ("llama2_7b", "llama3_8b", "llama31_8b", "llama32_1b", "mistral_7b", "mixtral_8x7b",
                         "tiny_moe", "tiny")]
    out += [(f"MMDiTConfig{name}", cfg) for name, cfg in (
        ("()", jdiffusion.MMDiTConfig()), (".sd3_shape()", jdiffusion.MMDiTConfig.sd3_shape()),
        (".tiny()", jdiffusion.MMDiTConfig.tiny()))]
    return [(name, cfg.head_dim, getattr(torch, cfg.dtype)) for name, cfg in out]


@pytest.mark.parametrize("name,D,dtype", _shipped_configs(), ids=lambda x: x if isinstance(x, str) else None)
def test_every_shipped_head_dim_is_taken_in_its_dtype(name, D, dtype):
    instances = tfa._F32_HEAD_DIMS if dtype == torch.float32 else tfa._KERNEL_HEAD_DIMS
    width = tfa.kernel_head_dim(D, dtype)
    assert width in instances and width >= D and (width == D or D not in instances), (name, D, width)
    seen = []
    q = torch.randn(1, 2, 8, D, dtype=dtype)
    o, _ = tfa.at_instance(recording(tfa.flash_forward_plain, seen), q, q, q, causal=True, sm_scale=D**-0.5)
    assert seen == [width] and o.shape == q.shape


def test_the_sweep_reaches_head_dims_16_and_32():
    dims = {D for name, D, _ in _shipped_configs() if name.startswith("hp_sweep_gpt")}
    assert dims == {16, 32}


@pytest.mark.parametrize("D,dtype", [(200, torch.float32), (264, torch.float32), (264, torch.bfloat16)])
def test_head_dims_no_instance_takes_are_refused_naming_the_departure(D, dtype):
    with pytest.raises(ValueError, match="head dim up to .* departure"):
        tfa.kernel_head_dim(D, dtype)
    q = torch.randn(1, 1, 4, D, dtype=dtype)
    launched = []
    with pytest.raises(ValueError, match="departure"):
        tfa.at_instance(recording(tfa.flash_forward_plain, launched), q, q, q, causal=True, sm_scale=1.0)
    with pytest.raises(ValueError, match="departure"):  # the wrappers refuse before any launch
        tfa.flash_forward_cuda(q, q, q, causal=True, sm_scale=1.0)
    lse = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="departure"):
        tfa.flash_bwd_dq_cuda(q, q, q, q, lse, lse, lse, causal=True, sm_scale=1.0)
    with pytest.raises(ValueError, match="departure"):
        tfa.flash_bwd_dkv_cuda(q, q, q, q, lse, lse, lse, causal=True, sm_scale=1.0)
    assert launched == []


@pytest.mark.parametrize("D", [1, 8, 16, 33, 100, 128, 129, 255, 256])
def test_the_padded_width_is_the_next_instance(D):
    assert tfa.kernel_head_dim(D, torch.bfloat16) == next(w for w in (32, 64, 128, 256) if w >= D)
    if D <= 128:
        assert tfa.kernel_head_dim(D, torch.float32) == next(w for w in (32, 64, 128) if w >= D)
