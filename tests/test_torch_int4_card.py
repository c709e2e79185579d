"""K7-int4 (``csrc/quantized_matmul_int4.cu``) on the card against its plain
version, and the int4 product's backward there. Marked ``gpu``: each test
skips without a card (the CUDA kernel has no CPU mode). This file imports no
JAX, so it runs on the card's machine as it is:

    python3 -m pytest tests/test_torch_int4_card.py -q -m gpu

``chip_smoke.py`` phase 17a holds the kernel at every Llama-2-7B and
Mixtral expert shape and times it; ``tests/test_torch_int4.py`` holds the
plain version against the JAX package on the CPU.
"""

import pytest
import torch

from modal_examples_tpu_torch.models import layers as tlayers
from modal_examples_tpu_torch.models import quantize as tquant
from modal_examples_tpu_torch.ops import quantized_matmul as tqmm
from test_torch_time_limit import share_cores

share_cores()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")


#: the path each shape must take: the TMA paths for Llama-2-7B's widths,
#: the masked one where N % 16 != 0 or K % 8 != 0
TMA_SHAPES = {(4096, 4096), (4096, 11008)}


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 16, 64, 65, 128, 129, 300, 2048])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008), (4000, 11000), (513, 384)])
def test_int4_matmul_kernel_matches_plain_on_card(M, K, N):
    """Run on the card (``python3 chip_smoke.py`` phase 17a covers the
    path's shapes): one launch on the path the shape picks ("ring" at
    M <= 64, "wgmma" above, "masked" for a ragged N or odd K), within 1e-3 of
    the plain version's largest value, the same bits twice."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
    qw = tquant.quantize_weight(torch.randn(K, N, generator=g, device="cuda"), bits=4)
    want_path = ("wgmma" if M > 64 else "ring") if (K, N) in TMA_SHAPES else "masked"
    assert tqmm.int4_kernel_path(x, qw.q) == tqmm.int4_path_rule(x, qw.q) == want_path
    before = tqmm.qmm_int4_launches
    out = tqmm.qmm_int4_cuda(x, qw.q, qw.scale)
    torch.cuda.synchronize()
    want = tqmm.qmm_int4_plain(x, qw.q, qw.scale)
    assert tqmm.qmm_int4_launches == before + 1
    assert ((out - want).abs().max() / want.abs().max()).item() < 1e-3
    assert torch.equal(out, tqmm.qmm_int4_cuda(x, qw.q, qw.scale))


@pytest.mark.gpu
def test_int4_mm_backward_on_card():
    """QLoRA's product on the card: the forward one K7-int4 launch within
    1e-3 of the plain version's largest value, the backward the closed form
    ``(dY * scale) @ q^T`` over the unpacked values in bf16 within 1e-2."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    w = tquant.quantize_weight(torch.randn(512, 384, generator=g, device="cuda"), bits=4)
    x = torch.randn(64, 512, generator=g, device="cuda").bfloat16().requires_grad_(True)
    before = tqmm.qmm_int4_launches
    y = tlayers.mm(x, w)
    assert tqmm.qmm_int4_launches == before + 1
    want = tqmm.qmm_int4_plain(x.detach(), w.q, w.scale)
    assert ((y.detach() - want).abs().max() / want.abs().max()).item() < 1e-3
    dy = torch.randn(64, 384, generator=g, device="cuda")
    y.backward(dy)
    ref = (dy * w.scale).bfloat16() @ w.values().bfloat16().T
    assert ((x.grad.float() - ref.float()).abs().max() / ref.float().abs().max()).item() < 1e-2
