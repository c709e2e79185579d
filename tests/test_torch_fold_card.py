"""The folded write (the write-then-attend kernel writing the new rows
itself) and the capacity experts' memory plan on the card. Marked ``gpu``:
each test skips without a card (the CUDA kernels have no CPU mode). This
file imports no JAX, so it runs on the card's machine as it is:

    python3 -m pytest tests/test_torch_fold_card.py -q -m gpu

``chip_smoke.py`` phase 2 holds the folded write the same way (with two
planted faults) and phase 18 trains Mixtral-8x7B through the capacity
experts; ``tests/test_torch_writeback.py`` and
``tests/test_torch_moe_training.py`` hold the plain versions against the JAX
package on the CPU.
"""

import pytest
import torch

import chip_smoke as cs
from modal_examples_tpu_torch.models import moe as tmoe
from modal_examples_tpu_torch.models import quantize as tquant
from modal_examples_tpu_torch.ops import paged_attention as tpa
from test_torch_time_limit import share_cores

share_cores()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")


@pytest.mark.gpu
def test_folded_writeback_is_bitwise_the_scatter_then_the_kernel_on_card():
    """Each of phase 2's cases (decode steps with dead slots and at the split
    edges, G = 1 and 4; verify chains across the split edges and past the
    table's end): one folded launch against K3 over the one-layer view and
    then K4, pages and output bitwise (trash page 0's raced row aside, and
    then one of its writers'), one launch counted as folded."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, c in cs.fold_cases(gen):
        want = cs.fold_sequence(tpa, c)
        before = (tpa.decode_writeback_launches, tpa.decode_writeback_fold_launches, tpa.scatter_launches)
        got = cs.fold_launch(tpa, c)
        torch.cuda.synchronize()
        after = (tpa.decode_writeback_launches, tpa.decode_writeback_fold_launches, tpa.scatter_launches)
        assert after == (before[0] + 1, before[1] + 1, before[2]), label
        diff = cs.fold_differs(got, want, c)
        assert not diff["pages"] and not diff["output"], (label, diff)


@pytest.mark.gpu
def test_write_then_attend_launches_the_folded_kernel_alone_on_card():
    """The entry over bf16 pages: one folded launch, no scatter; over int8
    pages the int8 scatter and the int8 kernel."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    c = cs.fold_decode_case(gen, 8, cs.WRITEBACK_CTX, (0, 4, len(cs.WRITEBACK_CTX) - 1))
    args = (c["q"], c["k_pages"], c["v_pages"], c["page_tables"], c["context_lens"], c["k_new"], c["v_new"],
            c["page_idx"], c["slot"])
    counts = lambda: (tpa.decode_writeback_fold_launches, tpa.scatter_launches, tpa.scatter_int8_launches,  # noqa: E731
                      tpa.decode_writeback_int8_launches)
    before = counts()
    tpa.write_then_attend(*args)
    assert counts() == (before[0] + 1, *before[1:])
    from modal_examples_tpu_torch.ops import kv_quant

    q8 = (kv_quant.quantize_kv(c["k_pages"].float()), kv_quant.quantize_kv(c["v_pages"].float()))
    before = counts()
    tpa.write_then_attend(c["q"], *q8, *args[3:])
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2] + 1, before[3] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_capacity_experts_match_the_unplanned_formula_on_card(bits):
    """The capacity experts' Function against autograd through the unplanned
    formula on the card, f32 products with TF32 off: output and d``expert_in``
    within 1e-5 of the largest value, over int8 and int4 stacks (E=8,
    C=96, D=512, F=1024)."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    E, C, D, F = 8, 96, 512, 1024
    stacks = [tquant.quantize_weight(torch.randn(*shape, generator=g, device="cuda") * shape[1] ** -0.5, bits=bits)
              for shape in ((E, D, F), (E, D, F), (E, F, D))]
    x = torch.randn(E, C, D, generator=g, device="cuda")
    dy = torch.randn(E, C, D, generator=g, device="cuda")
    results = []
    for fn in (tmoe.CapacityExperts.apply, tmoe.capacity_experts_plain):
        xin = x.clone().requires_grad_(True)
        out = fn(xin, *stacks)
        out.backward(dy)
        results.append((out.detach(), xin.grad))
    for got, want in zip(*results):
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
