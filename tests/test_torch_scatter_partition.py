"""The int8 KV scatter's row partition (``ops/paged_attention.py::
scatter_int8_partition``), on the CPU.

- The walk of ``csrc/kv_scatter_int8.cu`` (blocks striding over passes, a
  pass of ``groups_per_block x rows_per_group`` consecutive rows, row
  ``start + j * groups_per_block + group``), mirrored here in numpy, assigns
  every (layer, token, array, kv head) row exactly once, at the main paths'
  shapes and at ragged ones, and the kernel's numbering of a row is a
  bijection onto those tuples.
- The partition gives the card work at every shape: 64 blocks for one
  layer's 8 tokens, half a wave of resident blocks at a decode step, and at
  a prefill batch 96 blocks an SM striding over the rows.
- The kernel's arithmetic on the rows that walk reaches (amax in f32, an
  IEEE division by 127, IEEE quotients rounded half to even, clipped to
  +-127), mirrored in numpy and written where the kernel writes each row,
  gives JAX's ``scatter_kv_pages`` int8 pages bitwise.
- A head dim the kernel does not take raises before anything reaches a card.

The kernel itself runs only on the card (``chip_smoke.py`` holds it bitwise
to the plain version at these shapes' full-size cases).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modal_examples_tpu.ops import kv_quant as jkv
from modal_examples_tpu_torch.ops import _build
from modal_examples_tpu_torch.ops import kv_quant as tkv
from modal_examples_tpu_torch.ops import paged_attention as tpa

# the JAX package's ops/__init__ re-exports functions under their modules' names
jpa = importlib.import_module("modal_examples_tpu.ops.paged_attention")

SMS = 132  # an H100 SXM's SMs
# (L, N, Hkv, D): a decode step, the prefill batch, one layer's view, then
# ragged ones (a partial last block; one token; head dims whose lanes are
# not all used; GQA)
SHAPES = [(32, 8, 32, 128), (32, 2048, 32, 128), (1, 8, 32, 128), (3, 37, 5, 256), (1, 1, 32, 64),
          (2, 3, 3, 8), (1, 5, 3, 96), (32, 8, 8, 128), (4, 37, 8, 64)]


def kernel_walk(part, rows: int) -> np.ndarray:
    """Row indices in the order the kernel's blocks, passes, rows of a group
    and groups reach them (rows past the end skipped, as the kernel does)."""
    _, per_group, groups, blocks = part
    block_rows = groups * per_group
    passes = -(-rows // (blocks * block_rows))
    p, b, j, g = np.meshgrid(np.arange(passes), np.arange(blocks), np.arange(per_group), np.arange(groups),
                             indexing="ij")
    r = ((p * blocks + b) * block_rows + j * groups + g).ravel()
    return r[r < rows]


def row_tuple(r, L: int, N: int, Hkv: int):
    """The kernel's (array, layer, token, head) of row ``r``: K rows then V
    rows, each array's in (layer, token, head) order, head fastest."""
    per_array = L * N * Hkv
    a = r // per_array
    t, h = np.divmod(r - a * per_array, Hkv)
    layer, n = np.divmod(t, N)
    return a, layer, n, h


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "L{}-N{}-Hkv{}-D{}".format(*s))
def test_partition_assigns_every_row_once(shape):
    L, N, Hkv, D = shape
    part = tpa.scatter_int8_partition(L, N, Hkv, D, SMS)
    lanes, per_group, groups, blocks = part
    assert lanes & (lanes - 1) == 0 and 4 * lanes < D <= 8 * lanes  # the fewest lanes that hold D
    assert lanes * groups == tpa.SCATTER_INT8_THREADS
    assert 1 <= per_group <= 4 and 1 <= blocks <= 96 * SMS
    rows = 2 * L * N * Hkv
    walk = kernel_walk(part, rows)
    assert len(walk) == rows
    assert (np.bincount(walk, minlength=rows) == 1).all()
    a, layer, n, h = row_tuple(walk, L, N, Hkv)
    key = ((layer * N + n) * 2 + a) * Hkv + h  # (layer, token, array, head)
    assert (np.bincount(key, minlength=rows) == 1).all()


def test_partition_gives_the_card_work_at_every_shape():
    one_layer = tpa.scatter_int8_partition(1, 8, 32, 128, SMS)
    decode = tpa.scatter_int8_partition(32, 8, 32, 128, SMS)
    prefill = tpa.scatter_int8_partition(32, 2048, 32, 128, SMS)
    assert one_layer == (16, 1, 8, 64)  # 512 rows over 64 blocks, one row a group
    assert decode == (16, 2, 8, 1024)  # 16,384 rows: half a wave of resident blocks at 2 rows a group
    assert prefill == (16, 4, 8, 96 * SMS)  # 4 rows a group, the blocks striding
    rows, per_pass = 2 * 32 * 2048 * 32, 96 * SMS * 8 * 4
    assert -(-rows // per_pass) == 11 and rows % per_pass  # 11 passes, the last one partial


def _quantize_rows(x: np.ndarray):
    """The kernel's arithmetic on f32 rows ``[..., D]``: amax, scale = amax /
    127 (1 for an all-zero row), IEEE quotients rounded half to even,
    clipped to +-127."""
    amax = np.abs(x).max(axis=-1)
    scale = np.where(amax > 0, amax / np.float32(127), np.float32(1)).astype(np.float32)
    return np.clip(np.rint(x / scale[..., None]), -127, 127).astype(np.int8), scale


@pytest.mark.parametrize("shape", [(2, 6, 3, 32), (3, 37, 5, 256), (1, 1, 4, 64), (2, 9, 2, 96)],
                         ids=lambda s: "L{}-N{}-Hkv{}-D{}".format(*s))
def test_walk_writes_the_pages_of_jax_scatter_kv_pages(shape):
    L, N, Hkv, D = shape
    P, ps = 9, 16
    rng = np.random.default_rng(sum(shape))
    new = rng.standard_normal((2, L, N, Hkv, D)).astype(np.float32)
    new = np.array(jnp.asarray(new).astype(jnp.bfloat16).astype(jnp.float32))  # bf16 values, as the kernel reads
    new[0, 0, 0, 0] = 0.0  # an all-zero row
    new[1, 0, 0, 0, 1:] = rng.integers(-127, 127, D - 1) + 0.5  # ties: scale exactly 1
    new[1, 0, 0, 0, 0] = 127.0
    flat = rng.permutation((P - 1) * ps)[:N] + ps
    page_idx, slot = (flat // ps).astype(np.int32), (flat % ps).astype(np.int32)
    if N > 3:  # two dead tokens on trash page 0 slot 0, given equal rows
        page_idx[[1, 3]], slot[[1, 3]] = 0, 0
        new[:, :, 3] = new[:, :, 1]
    jk, jv = (jkv.quantize_kv(jnp.asarray(rng.standard_normal((L, P, ps, Hkv, D)).astype(np.float32)))
              for _ in range(2))
    ref = jpa.scatter_kv_pages(jk, jv, *(jnp.asarray(a, jnp.bfloat16) for a in new), jnp.asarray(page_idx),
                               jnp.asarray(slot))
    pages = [(np.array(p.data), np.array(p.scale)) for p in (jk, jv)]
    walk = kernel_walk(tpa.scatter_int8_partition(L, N, Hkv, D, SMS), 2 * L * N * Hkv)
    a, layer, n, h = row_tuple(walk, L, N, Hkv)
    q, scale = _quantize_rows(new[a, layer, n, h])
    for arr in (0, 1):
        at = a == arr
        data, scales = pages[arr]
        data[layer[at], page_idx[n[at]], slot[n[at]], h[at]] = q[at]
        scales[layer[at], page_idx[n[at]], slot[n[at]], h[at]] = scale[at]
    for (data, scales), want in zip(pages, ref):
        np.testing.assert_array_equal(data, np.asarray(want.data))
        np.testing.assert_array_equal(scales.view(np.int32), np.asarray(want.scale).view(np.int32))


@pytest.mark.parametrize("D", [4, 12, 100, 264, 0])
def test_unsupported_head_dim_raises_before_the_card(D):
    with pytest.raises(ValueError, match="head dim"):
        tpa.scatter_int8_partition(1, 8, 2, D, SMS)
    before, loaded = tpa.scatter_int8_launches, "kv_scatter_int8" in _build._libs
    pages = tkv.kv_empty((1, 3, 16, 2, D), "int8", "cpu")
    rows = torch.zeros(1, 2, 2, D, dtype=torch.bfloat16)
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim"):  # not the CPU tensors' refusal, which comes later
        tpa.scatter_int8_cuda(pages, pages, rows, rows, idx, idx)
    assert tpa.scatter_int8_launches == before
    assert ("kv_scatter_int8" in _build._libs) == loaded
