"""The f32 instances of the flash kernels (``csrc/flash_fwd_f32.cu``,
``csrc/flash_bwd_dq_f32.cu``, ``csrc/flash_bwd_dkv_f32.cu``) on the card.
Marked ``gpu``: each test skips without a card (the CUDA kernels have no CPU
mode). This file imports no JAX, so it runs on the card's machine as it is:

    python3 -m pytest tests/test_torch_flash_f32_card.py -q -m gpu

Each case of ``chip_smoke.F32_CASES`` holds the three instances against
their plain versions at ``chip_smoke.F32_TOL`` of the largest value,
bitwise from launch to launch; the planted faults (each kernel's last tile
dropped; in all three, which run on the tensor cores by a 3xTF32 split, the
two big.small products dropped, leaving one TF32 pass; variants built under
``build/variants``) must be refused. Their SASS holds wgmma (HGMMA) and TMA
(UTMALDG) instructions, and they refuse inputs TMA cannot load. Head dims
between the instances (C12) run through the kernels, zero-padded by the
wrappers: f32 at the GPT sweep's D=16 and bf16 at D=80, forward and
backward through ``flash_attention``.
``tests/test_torch_gpt.py`` holds the plain versions at f32 against the JAX
Pallas kernels on the CPU, ``tests/test_torch_flash_tf32x3.py`` the split's
arithmetic.
"""

import os
import re
import shutil
import subprocess

import pytest
import torch

import chip_smoke as cs
from modal_examples_tpu_torch.ops import flash_attention as fa
from test_torch_time_limit import share_cores

share_cores()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32


@pytest.mark.gpu
@pytest.mark.parametrize("case", cs.F32_CASES, ids=lambda c: "B{}-Hq{}-Hkv{}-S{}-Skv{}-off{}-causal{}-D{}-dlse{}".format(*c))
def test_f32_flash_instances_match_their_plain_versions_on_card(case):
    _card()
    r = cs.f32_case(fa, torch.Generator(device="cuda").manual_seed(20), *case)
    assert r["bitwise"], r
    assert cs.f32_passes(r), r


@pytest.mark.gpu
def test_f32_flash_check_refuses_the_last_tile_dropped_on_card():
    _card()
    refused = cs.f32_fault_refused(fa, faults=("last tile dropped",))["last tile dropped"]
    assert sorted(refused) == ["flash_bwd_dkv_f32", "flash_bwd_dq_f32", "flash_fwd_f32"] and all(refused.values()), refused


@pytest.mark.gpu
def test_f32_flash_check_refuses_one_tf32_pass_on_card():
    """K1-f32, K5-f32 and K6-f32 with their small parts zeroed, so the
    big.small products add nothing (one TF32 pass, 3-8e-4 of the largest
    value off), fail ``F32_TOL``."""
    _card()
    refused = cs.f32_fault_refused(fa, faults=("one TF32 pass",))["one TF32 pass"]
    assert sorted(refused) == ["flash_bwd_dkv_f32", "flash_bwd_dq_f32", "flash_fwd_f32"] and all(refused.values()), refused


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32"])
def test_f32_tensor_core_kernels_hold_their_instructions_on_card(name):
    _card()
    from modal_examples_tpu_torch.ops import _build

    _build.build([name])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    assert os.path.exists(tool), "cuobjdump not found"
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True, text=True,
                          check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in cs.SASS_CHECKED[name]}
    assert set(counts) == {"HGMMA", "UTMALDG"} and all(counts.values()), counts


@pytest.mark.gpu
def test_f32_tensor_core_kernels_refuse_a_misaligned_input_on_card():
    """TMA loads their tiles from 16-byte boundaries: a tensor that starts
    4 bytes past one is refused before a launch."""
    _card()
    B, H, S, D = 1, 2, 64, 64
    q = torch.randn(B * H * S * D + 1, device="cuda")[1:].view(B, H, S, D)
    k = torch.randn(B, H, S, D, device="cuda")
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_forward_f32_cuda(q, k, k, causal=True, sm_scale=D**-0.5)
    lse = torch.zeros(B, H, S, device="cuda")
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_bwd_dkv_f32_cuda(q, k, k, k, lse, lse, lse, causal=True, sm_scale=D**-0.5)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_bwd_dq_f32_cuda(q, k, k, k, lse, lse, lse, causal=True, sm_scale=D**-0.5)


@pytest.mark.gpu
def test_f32_instances_refuse_another_head_dim_on_card():
    """f32 above 128 stays a departure (no f32 instance fits there): D=256
    is refused before a launch, naming it."""
    _card()
    q = torch.randn(1, 2, 16, 256, device="cuda")
    before = fa.f32_launches
    with pytest.raises(ValueError, match="head dim.*departure"):
        fa.flash_forward_f32_cuda(q, q, q, causal=True, sm_scale=0.0625)
    assert fa.f32_launches == before


def _launch_counts():
    return (fa.launches, fa.dq_launches, fa.dkv_launches, fa.f32_launches, fa.dq_f32_launches,
            fa.dkv_f32_launches)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D,shape,counts", [
    (torch.float32, 16, (8, 4, 4, 128), [0, 0, 0, 1, 1, 1]),   # the GPT sweep's dim 64 over 4 heads
    (torch.bfloat16, 80, (2, 8, 2, 300), [1, 1, 1, 0, 0, 0]),  # a Llama head dim between instances, GQA
], ids=["f32-D16", "bf16-D80"])
def test_a_head_dim_between_instances_runs_on_the_kernels_on_card(dtype, D, shape, counts):
    """C12: ``flash_attention`` at a head dim no kernel is built at runs
    forward and backward on the kernels (inputs zero-padded to the next
    instance, outputs sliced back; the counters show one launch of each,
    no plain version), within the existing tolerances of the plain
    versions at the true D (f32: ``F32_TOL``; bf16: K1's max abs, K5/K6's
    share of the largest value)."""
    _card()
    B, Hq, Hkv, S = shape
    gen = torch.Generator(device="cuda").manual_seed(26)
    q = torch.randn(B, Hq, S, D, generator=gen, device="cuda").to(dtype).requires_grad_()
    k, v = (torch.randn(B, Hkv, S, D, generator=gen, device="cuda").to(dtype).requires_grad_() for _ in range(2))
    do = torch.randn(B, Hq, S, D, generator=gen, device="cuda").to(dtype)
    before = _launch_counts()
    o = fa.flash_attention(q, k, v, causal=True)
    o.backward(do)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launch_counts(), before)] == counts
    assert o.shape == q.shape and q.grad.shape == q.shape and k.grad.shape == k.shape
    scale = D**-0.5
    want_o, lse = fa.flash_forward_plain(q.detach(), k.detach(), v.detach(), causal=True, sm_scale=scale)
    want = fa.flash_backward_plain(q.detach(), k.detach(), v.detach(), want_o, lse, do, torch.zeros_like(lse),
                                   causal=True, sm_scale=scale)
    got = (q.grad, k.grad, v.grad)
    if dtype == torch.float32:
        errs = [cs.rel_err(o, want_o)] + [cs.rel_err(g, w) for g, w in zip(got, want)]
        assert max(errs) <= cs.F32_TOL, errs
    else:
        assert cs.max_err(o, want_o) <= cs.TOL["flash_fwd"]
        rel = [cs.rel_err(g, w) for g, w in zip(got, want)]
        assert rel[0] <= cs.TOL["flash_bwd_dq"] and max(rel[1:]) <= cs.TOL["flash_bwd_dkv"], rel


@pytest.mark.gpu
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dq_on_the_tensor_cores_matches_its_plain_version_on_card(D, causal):
    """K5-f32 alone at a ragged S=300 with GQA (8 query heads over 2) and an
    lse cotangent: within ``F32_TOL`` of its plain version, bitwise from
    launch to launch."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(27)
    B, Hq, Hkv, S = 2, 8, 2, 300
    q, do = cs.rand_f32(gen, B, Hq, S, D), cs.rand_f32(gen, B, Hq, S, D)
    k, v = cs.rand_f32(gen, B, Hkv, S, D), cs.rand_f32(gen, B, Hkv, S, D)
    scale = D**-0.5
    o, lse = fa.flash_forward_f32_plain(q, k, v, causal=causal, sm_scale=scale)
    args = (q, k, v, do, lse, (do * o).sum(dim=-1), cs.rand_f32(gen, B, Hq, S))
    before = fa.dq_f32_launches
    dq = fa.flash_bwd_dq_f32_cuda(*args, causal=causal, sm_scale=scale)
    again = fa.flash_bwd_dq_f32_cuda(*args, causal=causal, sm_scale=scale)
    torch.cuda.synchronize()
    assert fa.dq_f32_launches - before == 2
    assert torch.equal(dq, again)
    err = cs.rel_err(dq, fa.flash_bwd_dq_f32_plain(*args, causal=causal, sm_scale=scale))
    assert err <= cs.F32_TOL, err


@pytest.mark.gpu
def test_f32_dispatch_counts_the_f32_instances_on_card():
    """``flash_attention`` at f32 on the card: forward and backward through
    the f32 instances, none through the bf16 kernels."""
    _card()
    before = (fa.launches, fa.dq_launches, fa.dkv_launches, fa.f32_launches, fa.dq_f32_launches,
              fa.dkv_f32_launches)
    q, k, v = (torch.randn(2, 4, 64, 64, device="cuda", requires_grad=True) for _ in range(3))
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    after = (fa.launches, fa.dq_launches, fa.dkv_launches, fa.f32_launches, fa.dq_f32_launches,
             fa.dkv_f32_launches)
    assert [a - b for a, b in zip(after, before)] == [0, 0, 0, 1, 1, 1]
