"""The f32 instances of the flash kernels (``csrc/flash_fwd_f32.cu``,
``csrc/flash_bwd_dq_f32.cu``, ``csrc/flash_bwd_dkv_f32.cu``) on the card.
Marked ``gpu``: each test skips without a card (the CUDA kernels have no CPU
mode). This file imports no JAX, so it runs on the card's machine as it is:

    python3 -m pytest tests/test_torch_flash_f32_card.py -q -m gpu

Each case of ``chip_smoke.F32_CASES`` holds the three instances against
their plain versions at ``chip_smoke.F32_TOL`` of the largest value,
bitwise from launch to launch; the planted faults (each kernel's last tile
dropped, variants built under ``build/variants``) must be refused.
``tests/test_torch_gpt.py`` holds the plain versions at f32 against the JAX
Pallas kernels on the CPU.
"""

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
    assert all(cs.f32_fault_refused(fa).values())


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
