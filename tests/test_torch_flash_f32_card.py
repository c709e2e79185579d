"""The f32 instances of the flash kernels (``csrc/flash_fwd_f32.cu``,
``csrc/flash_bwd_dq_f32.cu``, ``csrc/flash_bwd_dkv_f32.cu``) on the card.
Marked ``gpu``: each test skips without a card (the CUDA kernels have no CPU
mode). This file imports no JAX, so it runs on the card's machine as it is:

    python3 -m pytest tests/test_torch_flash_f32_card.py -q -m gpu

Each case of ``chip_smoke.F32_CASES`` holds the three instances against
their plain versions at ``chip_smoke.F32_TOL`` of the largest value,
bitwise from launch to launch; the planted faults (each kernel's last tile
dropped; in the forward and dK/dV, which run on the tensor cores by a
3xTF32 split, the two big.small products dropped, leaving one TF32 pass;
variants built under ``build/variants``) must be refused. The two
tensor-core kernels' SASS holds their wgmma (HGMMA) and TMA (UTMALDG)
instructions, and they refuse inputs TMA cannot load.
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
    """K1-f32 and K6-f32 with their small parts zeroed, so the big.small
    products add nothing (one TF32 pass, 3-8e-4 of the largest value off),
    fail ``F32_TOL``."""
    _card()
    refused = cs.f32_fault_refused(fa, faults=("one TF32 pass",))["one TF32 pass"]
    assert sorted(refused) == ["flash_bwd_dkv_f32", "flash_fwd_f32"] and all(refused.values()), refused


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_fwd_f32", "flash_bwd_dkv_f32"])
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


@pytest.mark.gpu
def test_f32_instances_refuse_another_head_dim_on_card():
    _card()
    q = torch.randn(1, 2, 16, 256, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_forward_f32_cuda(q, q, q, causal=True, sm_scale=0.0625)


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
