"""The port's write-then-attend decode against the JAX package's.

- ``paged_decode_writeback_plain`` (the twin of ``csrc/paged_decode_writeback.cu``)
  and the entry ``paged_decode_attention`` against the JAX Pallas kernel
  (``paged_decode_attention(impl="pallas", interpret=True)``) and the JAX
  ``reference.paged_decode_attention``: GQA groups 1, 2 and 8; contexts of 1,
  a full page, a page plus one and every page; a dead row on trash page 0.
  Tolerance 1e-5 in f32, 2e-2 in bf16 (the kernel keeps its probabilities in
  f32, the reference rounds them to bf16). A context of 0 gives zeros.
- int8 pages: ``paged_decode_writeback_int8_plain`` (the twin of
  ``csrc/paged_decode_writeback_int8.cu``) and the entry are the JAX entry's
  own int8 route (dequantize in the gather), within 1e-5 in f32; a context
  of 0 gives zeros there too. Their wrapper refuses tensors off the card.
- ``kv_scatter(leading_layer=False)`` bitwise as JAX, bf16 and int8.
- The folded write (the write-then-attend kernel writing the new rows
  itself, ``write_then_attend``): its plain twin bitwise equal to
  ``scatter_kv_layer`` followed by ``paged_decode_writeback_plain``, pages
  and output, with a dead slot on trash page 0 and one with a stale table;
  the entry within 1e-5 of the JAX write-then-attend (``kv_scatter``, then
  ``paged_decode_attention(impl="xla")``) in f32; the kernel's staging rule
  (which context rows it stages from the new rows instead of the pages),
  mirrored here, giving bitwise the scatter-then-attend output for decode
  steps and for verify chains that straddle the kernel's split edge and run
  past the table's capacity; the verify route with the chain's rows folded
  against the scatter followed by the reference verify attention.
- ``llama.decode_step`` for each of the four impls against the JAX function
  with the same impl (tiny f32): logits and pages within 1e-5 of their
  largest value; the writeback structure over an int8 cache the same way.
  The writeback structure against the read-only one.
- ``paged_impl_plan`` for every impl and kv dtype: the card serves them all.
- The tiny f32 engine with ``paged_impl="pallas-writeback"`` (f32 pages, and
  int8 pages) against the JAX engine with the same impl and kv
  dtype: finish reasons, token counts and pages exactly; tokens wherever the
  reference's top-2 margin exceeds 1e-3.

The CUDA kernels run only on the card (the ``gpu``-marked tests;
``chip_smoke.py`` at full size).
"""

import dataclasses
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.ops import kv_quant as jkv
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu_torch import LLMEngine, SamplingParams
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.ops import kv_quant as tkv
from modal_examples_tpu_torch.ops import paged_attention as tpa
from modal_examples_tpu_torch.ops import reference as tref
from test_torch_time_limit import share_cores

share_cores()

# the JAX package's ops/__init__ re-exports functions under their modules' names
jpa = importlib.import_module("modal_examples_tpu.ops.paged_attention")
jref = importlib.import_module("modal_examples_tpu.ops.reference")

PS, PPS, D = 16, 4, 32
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
GROUPS = [(4, 4), (4, 2), (8, 1)]
# contexts 1, ps, ps+1, pps*ps, and a dead row (trash page 0, one row)
CTX = [1, PS, PS + 1, PPS * PS, 1]


def _case(seed, hq, hkv, ctx=CTX, pps=PPS):
    """One layer's pages over shuffled page ids; the last row's table is all
    trash page 0."""
    rng = np.random.default_rng(seed)
    B = len(ctx)
    n_pages = 1 + B * pps
    tables = (rng.permutation(n_pages - 1)[: B * pps] + 1).reshape(B, pps).astype(np.int32)
    tables[-1] = 0
    return dict(
        q=rng.standard_normal((B, hq, D)).astype(np.float32),
        kp=rng.standard_normal((n_pages, PS, hkv, D)).astype(np.float32),
        vp=rng.standard_normal((n_pages, PS, hkv, D)).astype(np.float32),
        tables=tables,
        ctx=np.array(ctx, np.int32),
    )


def _jax_args(c, jdt):
    return (jnp.asarray(c["q"], jdt), jnp.asarray(c["kp"], jdt), jnp.asarray(c["vp"], jdt),
            jnp.asarray(c["tables"]), jnp.asarray(c["ctx"]))


def _port_args(c, tdt):
    return (torch.from_numpy(c["q"]).to(tdt), torch.from_numpy(c["kp"]).to(tdt), torch.from_numpy(c["vp"]).to(tdt),
            torch.from_numpy(c["tables"]), torch.from_numpy(c["ctx"]))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_writeback_plain_matches_jax_kernel_interpret(hq, hkv, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    c = _case(0, hq, hkv)
    ref = jpa.paged_decode_attention(*_jax_args(c, jdt), impl="pallas", interpret=True)
    got = tpa.paged_decode_writeback_plain(*_port_args(c, tdt))
    assert got.dtype == tdt and got.shape == (len(CTX), hq, D)
    _close(got, ref, tol)
    _close(tpa.paged_decode_attention(*_port_args(c, tdt), impl="pallas"), ref, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_writeback_entry_matches_jax_reference(hq, hkv, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    c = _case(1, hq, hkv)
    ref = jref.paged_decode_attention(*_jax_args(c, jdt))
    for impl in (None, "xla", "pallas"):  # one function whatever the name
        _close(tpa.paged_decode_attention(*_port_args(c, tdt), impl=impl), ref, tol)
    _close(tref.paged_decode_attention(*_port_args(c, tdt)), ref, tol)


def test_empty_context_gives_zeros_as_the_jax_kernel():
    c = _case(2, 4, 2, ctx=[0, 5, 0, PS])
    ref = np.asarray(jpa.paged_decode_attention(*_jax_args(c, jnp.float32), impl="pallas", interpret=True))
    got = tpa.paged_decode_writeback_plain(*_port_args(c, torch.float32)).numpy()
    assert np.isfinite(got).all() and not got[[0, 2]].any()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_int8_pages_take_the_jax_int8_route(hq, hkv):
    c = _case(3, hq, hkv)
    jk, jv = jkv.quantize_kv(jnp.asarray(c["kp"])), jkv.quantize_kv(jnp.asarray(c["vp"]))
    q, tables, ctx = jnp.asarray(c["q"]), jnp.asarray(c["tables"]), jnp.asarray(c["ctx"])
    ref = jpa.paged_decode_attention(q, jk, jv, tables, ctx, impl="pallas", interpret=True)  # routes int8 to XLA
    tk = tkv.QuantizedKV(torch.tensor(np.asarray(jk.data)), torch.tensor(np.asarray(jk.scale)))
    tv = tkv.QuantizedKV(torch.tensor(np.asarray(jv.data)), torch.tensor(np.asarray(jv.scale)))
    args = (torch.from_numpy(c["q"]), tk, tv, torch.from_numpy(c["tables"]), torch.from_numpy(c["ctx"]))
    _close(tpa.paged_decode_attention(*args, impl="pallas"), ref, 1e-5)
    _close(tpa.paged_decode_writeback_plain(*args), ref, 1e-5)  # f32: same function


def _int8_args(c):
    """(JAX args, port args) of one case over the same int8 pages, quantized
    by JAX."""
    jk, jv = jkv.quantize_kv(jnp.asarray(c["kp"])), jkv.quantize_kv(jnp.asarray(c["vp"]))
    tk = tkv.QuantizedKV(torch.tensor(np.asarray(jk.data)), torch.tensor(np.asarray(jk.scale)))
    tv = tkv.QuantizedKV(torch.tensor(np.asarray(jv.data)), torch.tensor(np.asarray(jv.scale)))
    return ((jnp.asarray(c["q"]), jk, jv, jnp.asarray(c["tables"]), jnp.asarray(c["ctx"])),
            (torch.from_numpy(c["q"]), tk, tv, torch.from_numpy(c["tables"]), torch.from_numpy(c["ctx"])))


@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_writeback_int8_plain_matches_jax_int8_route(hq, hkv):
    jargs, args = _int8_args(_case(8, hq, hkv))
    ref = jpa.paged_decode_attention(*jargs, impl="pallas", interpret=True)  # routes int8 to XLA
    got = tpa.paged_decode_writeback_int8_plain(*args)
    assert got.dtype == torch.float32 and got.shape == (len(CTX), hq, D)
    _close(got, ref, 1e-5)


def test_writeback_int8_plain_empty_context_gives_zeros():
    """A context of 0 gives zeros (the kernel's contract, as the bf16
    kernel's); the other rows stay the JAX int8 route's."""
    ctx = [0, 5, 0, PS]
    jargs, args = _int8_args(_case(9, 4, 2, ctx=ctx))
    ref = np.asarray(jpa.paged_decode_attention(*jargs, impl="pallas", interpret=True))
    got = tpa.paged_decode_writeback_int8_plain(*args).numpy()
    assert np.isfinite(got).all() and not got[[0, 2]].any()
    np.testing.assert_allclose(got[[1, 3]], ref[[1, 3]], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tpa.paged_decode_attention(*args).numpy(), got)


def test_int8_pages_raise_off_the_cpu_and_wrapper_refuses_cpu_tensors():
    """int8 pages off the CPU go to the int8 kernel's wrapper, which takes
    CUDA tensors only: meta tensors (standing in for another device) raise
    there, and so do CPU tensors given to either kernel's wrapper, without
    counting a launch."""
    pages = tkv.QuantizedKV(torch.empty(3, PS, 2, D, dtype=torch.int8, device="meta"),
                            torch.empty(3, PS, 2, device="meta"))
    q = torch.empty(1, 4, D, dtype=torch.bfloat16, device="meta")
    idx = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    before = (tpa.decode_writeback_launches, tpa.decode_writeback_int8_launches)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention(q, pages, pages, idx, idx[0])
    c = _port_args(_case(4, 4, 2), torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_writeback_cuda(*c, sm_scale=1.0)
    _, (_, tk, tv, tables, ctx) = _int8_args(_case(4, 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_writeback_int8_cuda(c[0], tk, tv, tables, ctx, sm_scale=1.0)
    with pytest.raises(ValueError, match="impl"):
        tpa.paged_decode_attention(*c, impl="mosaic")
    assert (tpa.decode_writeback_launches, tpa.decode_writeback_int8_launches) == before


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_kv_scatter_one_layer_is_bitwise_jax(dtype):
    rng = np.random.default_rng(5)
    pages = rng.standard_normal((9, PS, 2, D)).astype(np.float32)
    update = (rng.standard_normal((5, 2, D)) * rng.choice([1e-3, 1.0, 30.0], (5, 2, 1))).astype(np.float32)
    update[2] = 0.0  # an all-zero row: unit scale
    update[4] = update[1]  # two dead rows on trash page 0 slot 0, equal so the race has one result
    page_idx = np.array([3, 0, 5, 8, 0], np.int32)
    slot = np.array([2, 0, 15, 0, 0], np.int32)
    if dtype == "int8":
        jp = jkv.quantize_kv(jnp.asarray(pages))
        port = tkv.QuantizedKV(torch.tensor(np.asarray(jp.data)), torch.tensor(np.asarray(jp.scale)))
        ju = jnp.asarray(update)
        tu = torch.from_numpy(update)
    else:
        jp = jnp.asarray(pages, jnp.bfloat16)
        port = torch.from_numpy(pages).to(torch.bfloat16)
        ju = jnp.asarray(update, jnp.bfloat16)
        tu = torch.from_numpy(update).to(torch.bfloat16)
    ref = jkv.kv_scatter(jp, ju, jnp.asarray(page_idx), jnp.asarray(slot), leading_layer=False)
    out = tkv.kv_scatter(port, tu, torch.from_numpy(page_idx).long(), torch.from_numpy(slot).long(),
                         leading_layer=False)
    assert out is port  # in place
    if dtype == "int8":
        np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
        np.testing.assert_array_equal(port.scale.numpy(), np.asarray(ref.scale))
    else:
        np.testing.assert_array_equal(port.float().numpy(), np.asarray(ref, np.float32))


# -- the folded write ------------------------------------------------------------------


def _split_rows() -> int:
    src = (Path(tpa.__file__).resolve().parent.parent / "csrc" / "paged_decode.cuh").read_text()
    return int(re.search(r"constexpr int SPLIT = (\d+);", src).group(1))


def _fold_case(seed, hq, hkv, ctx, pps=PPS, dtype=torch.float32):
    """A decode step's write-then-attend over one layer (``_case``'s pages and
    tables; its last slot dead on an all-trash table), the new rows written
    where each context's last row sits; the first slot also dead, with the
    stale table a freed slot keeps. Dead slots attend one row and write trash
    page 0, slot 0 with equal rows (so the race there has one result, as
    ``scatter_kv_pages`` says)."""
    c = _case(seed, hq, hkv, ctx=ctx, pps=pps)
    rng = np.random.default_rng(seed + 100)
    B = len(ctx)
    c["ctx"][0] = 1
    dead = np.zeros(B, bool)
    dead[[0, B - 1]] = True
    pos = c["ctx"] - 1
    page_idx = np.where(dead, 0, c["tables"][np.arange(B), pos // PS]).astype(np.int32)
    slot = np.where(dead, 0, pos % PS).astype(np.int32)
    k_new = rng.standard_normal((B, hkv, D)).astype(np.float32)
    v_new = rng.standard_normal((B, hkv, D)).astype(np.float32)
    k_new[0], v_new[0] = k_new[-1], v_new[-1]
    q, kp, vp, tables, lens = _port_args(c, dtype)
    return dict(q=q, kp=kp, vp=vp, tables=tables, ctx=lens, k_new=torch.from_numpy(k_new).to(dtype),
                v_new=torch.from_numpy(v_new).to(dtype), page_idx=torch.from_numpy(page_idx),
                slot=torch.from_numpy(slot), np=c)


FOLD_CTX = [1, PS, PS + 1, 17, PPS * PS, 1]


@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_folded_twin_is_the_scatter_then_the_plain_attention(hq, hkv):
    """Bitwise, pages and output, in bf16: the plain twin of the folded
    kernel against the sequence it replaces."""
    f = _fold_case(11, hq, hkv, FOLD_CTX, dtype=torch.bfloat16)
    new = dict(k_new=f["k_new"], v_new=f["v_new"], page_idx=f["page_idx"], slot=f["slot"])
    kp, vp = f["kp"].clone(), f["vp"].clone()
    got = tpa.paged_decode_writeback_plain(f["q"], kp, vp, f["tables"], f["ctx"], **new)
    kq, vq = f["kp"].clone(), f["vp"].clone()
    tpa.scatter_kv_layer(kq, vq, f["k_new"], f["v_new"], f["page_idx"], f["slot"])
    want = tpa.paged_decode_writeback_plain(f["q"], kq, vq, f["tables"], f["ctx"])
    assert torch.equal(kp, kq) and torch.equal(vp, vq) and torch.equal(got, want)
    assert not torch.equal(kp, f["kp"])  # the rows went in
    kr, vr = f["kp"].clone(), f["vp"].clone()
    assert torch.equal(tpa.write_then_attend(f["q"], kr, vr, f["tables"], f["ctx"], **new), want)
    assert torch.equal(kr, kq) and torch.equal(vr, vq)


@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_folded_entry_matches_the_jax_write_then_attend(hq, hkv):
    """``write_then_attend`` against the JAX package's two calls, in f32:
    ``kv_scatter`` into one layer's pages, then ``paged_decode_attention``
    (the xla formulation); pages bitwise, output within 1e-5."""
    f = _fold_case(12, hq, hkv, FOLD_CTX)
    c = f["np"]
    jk = jkv.kv_scatter(jnp.asarray(c["kp"]), jnp.asarray(f["k_new"].numpy()), jnp.asarray(f["page_idx"].numpy()),
                        jnp.asarray(f["slot"].numpy()), leading_layer=False)
    jv = jkv.kv_scatter(jnp.asarray(c["vp"]), jnp.asarray(f["v_new"].numpy()), jnp.asarray(f["page_idx"].numpy()),
                        jnp.asarray(f["slot"].numpy()), leading_layer=False)
    ref = jpa.paged_decode_attention(jnp.asarray(c["q"]), jk, jv, jnp.asarray(c["tables"]),
                                     jnp.asarray(f["ctx"].numpy()), impl="xla")
    kp, vp = f["kp"].clone(), f["vp"].clone()
    got = tpa.write_then_attend(f["q"], kp, vp, f["tables"], f["ctx"], f["k_new"], f["v_new"], f["page_idx"],
                                f["slot"])
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(jv))
    _close(got, ref, 1e-5)


def _staged_rows(tables, ctx, page_idx, slot, positions, chain):
    """The write-then-attend kernel's staging rule, mirrored
    (``csrc/paged_decode.cuh``, the folded write): for row r, the context
    positions it stages from the launch's new rows, as {position: new row}.
    A position pos takes the chain row j = r - (positions[r] - pos) when j is
    in r's chain and that row's target is pos's place in r's table."""
    out = []
    for r in range(len(ctx)):
        n, mine, first = min(int(ctx[r]), tables.shape[1] * PS), int(positions[r]), r - r % chain
        staged = {}
        for pos in range(n):
            j = r - (mine - pos)
            if first <= j <= r and page_idx[j] == tables[r, pos // PS] and slot[j] == pos % PS:
                staged[pos] = j
        out.append(staged)
    return out


def _attend_as_staged(q, kp, vp, tables, ctx, k_new, v_new, staged):
    """Each row's output over the pages as they stood before the launch,
    its staged positions taken from the new rows (plain attention, f32)."""
    outs = []
    for r, rows in enumerate(staged):
        k, v = kp.clone(), vp.clone()
        for pos, j in rows.items():
            k[tables[r, pos // PS], pos % PS], v[tables[r, pos // PS], pos % PS] = k_new[j], v_new[j]
        outs.append(tpa.paged_decode_writeback_plain(q[r:r + 1], k, v, tables[r:r + 1], ctx[r:r + 1]))
    return torch.cat(outs)


def test_the_kernels_staging_rule_gives_the_scatter_then_attend_decode():
    """A decode step: every live slot stages exactly its new row, at its
    context's last position; the dead slot on an all-trash table stages its
    own trash row, the one with a stale table stages nothing; and the result
    is bitwise the scatter followed by the attention."""
    f = _fold_case(13, 4, 2, FOLD_CTX)
    positions = f["ctx"] - 1
    staged = _staged_rows(f["tables"], f["ctx"], f["page_idx"], f["slot"], positions, 1)
    B = len(FOLD_CTX)
    assert staged[0] == {} and staged[-1] == {0: B - 1}
    assert all(staged[r] == {int(positions[r]): r} for r in range(1, B - 1))
    got = _attend_as_staged(f["q"], f["kp"], f["vp"], f["tables"], f["ctx"], f["k_new"], f["v_new"], staged)
    kq, vq = f["kp"].clone(), f["vp"].clone()
    want = tpa.write_then_attend(f["q"], kq, vq, f["tables"], f["ctx"], f["k_new"], f["v_new"], f["page_idx"],
                                 f["slot"])
    assert torch.equal(got, want)


def _verify_fold_case(seed, T, pos0, pps, hq=4, hkv=2):
    """B chains of T tokens each at positions pos0[b].. over one layer's
    pages, the tables full; rows past the table's capacity target trash
    page 0, slot 0 (``llama.verify_step``'s targets)."""
    rng = np.random.default_rng(seed)
    B = len(pos0)
    P = 1 + B * pps
    tables = torch.from_numpy((rng.permutation(P - 1)[: B * pps] + 1).reshape(B, pps).astype(np.int32))
    positions = torch.tensor(pos0)[:, None] + torch.arange(T)[None, :]
    cap = pps * PS
    valid = positions < cap
    pc = positions.clamp(max=cap - 1)
    page_idx = torch.where(valid, tables.gather(1, (pc // PS).long()), 0).int().reshape(B * T)
    slot = torch.where(valid, pc % PS, 0).int().reshape(B * T)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    return dict(q=t(B, T, hq, D), kp=t(P, PS, hkv, D), vp=t(P, PS, hkv, D), tables=tables, positions=positions,
                k_new=t(B * T, hkv, D), v_new=t(B * T, hkv, D), page_idx=page_idx, slot=slot, cap=cap)


def test_the_kernels_staging_rule_gives_the_scatter_then_attend_verify():
    """Verify chains of 5 at positions that straddle the kernel's split edge
    (``SPLIT`` rows a block), start a page, and run past the table's
    capacity: each chain row stages every chain row at or before it that
    lands in its table, the rows past capacity none of theirs, and the
    result is bitwise the scatter followed by the rows' attention."""
    split, T = _split_rows(), 5
    pps = 2 * split // PS
    cap = pps * PS
    pos0 = [split - 2, split - 5, PS, cap - 2, 0]
    f = _verify_fold_case(14, T, pos0, pps)
    B = len(pos0)
    rows_q = f["q"].reshape(B * T, 4, D)
    tables = f["tables"].repeat_interleave(T, 0)
    ctx = (f["positions"] + 1).clamp(max=cap).reshape(B * T).int()
    positions = f["positions"].reshape(B * T).int()
    staged = _staged_rows(tables, ctx, f["page_idx"], f["slot"], positions, T)
    for b, p0 in enumerate(pos0):
        for t in range(T):
            want = {p0 + i: b * T + i for i in range(t + 1) if p0 + i < cap}
            assert staged[b * T + t] == want, (b, t)
    got = _attend_as_staged(rows_q, f["kp"], f["vp"], tables, ctx, f["k_new"], f["v_new"], staged)
    kq, vq = f["kp"].clone(), f["vp"].clone()
    want = tpa.verify_by_rows(f["q"], kq, vq, f["tables"], f["positions"], k_new=f["k_new"], v_new=f["v_new"],
                              page_idx=f["page_idx"], slot=f["slot"])
    assert torch.equal(got, want.reshape(B * T, 4, D))


def test_verify_route_with_the_chain_folded_matches_the_reference():
    """``verify_by_rows`` writing the chain (its CPU route: the plain twin)
    against ``scatter_kv_layer`` and the reference verify attention, f32
    within 1e-5; ``paged_verify_attention`` with the chain's rows on the CPU
    is bitwise those two calls, pages too."""
    split = _split_rows()
    pps = 2 * split // PS
    f = _verify_fold_case(15, 5, [split - 2, PS - 1, pps * PS - 3], pps)
    new = dict(k_new=f["k_new"], v_new=f["v_new"], page_idx=f["page_idx"], slot=f["slot"])
    kq, vq = f["kp"].clone(), f["vp"].clone()
    tpa.scatter_kv_layer(kq, vq, f["k_new"], f["v_new"], f["page_idx"], f["slot"])
    ref = tref.paged_verify_attention(f["q"], kq, vq, f["tables"], f["positions"])
    kp, vp = f["kp"].clone(), f["vp"].clone()
    _close(tpa.verify_by_rows(f["q"], kp, vp, f["tables"], f["positions"], **new), ref.numpy(), 1e-5)
    assert torch.equal(kp, kq) and torch.equal(vp, vq)
    kp, vp = f["kp"].clone(), f["vp"].clone()
    assert torch.equal(tpa.paged_verify_attention(f["q"], kp, vp, f["tables"], f["positions"], **new), ref)
    assert torch.equal(kp, kq) and torch.equal(vp, vq)


def test_int8_pages_write_then_attend_through_the_int8_scatter():
    """Over int8 pages ``write_then_attend`` is the int8 scatter, then the
    int8 write-then-attend route: bitwise those two calls."""
    f = _fold_case(16, 4, 2, FOLD_CTX)
    a, b = (tkv.quantize_kv(f["kp"]), tkv.quantize_kv(f["vp"])), (tkv.quantize_kv(f["kp"]), tkv.quantize_kv(f["vp"]))
    got = tpa.write_then_attend(f["q"], *a, f["tables"], f["ctx"], f["k_new"], f["v_new"], f["page_idx"], f["slot"])
    tpa.scatter_kv_layer(*b, f["k_new"], f["v_new"], f["page_idx"], f["slot"])
    want = tpa.paged_decode_attention(f["q"], *b, f["tables"], f["ctx"])
    assert torch.equal(got, want)
    for x, y in zip(a, b):
        assert torch.equal(x.data, y.data) and torch.equal(x.scale, y.scale)


def test_folded_wrapper_refuses_cpu_tensors_and_bad_rows():
    f = _fold_case(17, 4, 2, FOLD_CTX, dtype=torch.bfloat16)
    before = (tpa.decode_writeback_launches, tpa.decode_writeback_fold_launches)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_writeback_cuda(f["q"], f["kp"], f["vp"], f["tables"], f["ctx"], sm_scale=1.0,
                                        k_new=f["k_new"], v_new=f["v_new"], page_idx=f["page_idx"], slot=f["slot"])
    assert (tpa.decode_writeback_launches, tpa.decode_writeback_fold_launches) == before


# -- the model's decode step ---------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _prefilled(model, kv_dtype="float32"):
    """A cache holding two prompts (20 and 32 tokens) written by the JAX
    prefill, its page tables for three slots, and the first decode inputs.
    An f32 cache comes back as numpy arrays, an int8 one as the JAX
    ``QuantizedKV`` pair."""
    jcfg, _, jparams, _ = model
    rng = np.random.default_rng(6)
    pps = 8
    n_pages = 1 + 3 * pps
    tables = (rng.permutation(n_pages - 1)[: 3 * pps] + 1).reshape(3, pps).astype(np.int32)
    shape = (jcfg.n_layers, n_pages, PS, jcfg.n_kv_heads, jcfg.head_dim)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    _, jk, jv = jllama.prefill(
        jparams, jnp.asarray(tokens), jkv.kv_empty(shape, kv_dtype), jkv.kv_empty(shape, kv_dtype),
        jnp.asarray(tables[:2]), jnp.asarray([20, 32], jnp.int32), jcfg,
    )
    if kv_dtype == "int8":
        return jk, jv, tables
    return np.asarray(jk), np.asarray(jv), tables


def _run_port(tparams, tcfg, kp, vp, tables, impl, scatter_impl="xla", steps=3):
    toks = np.array([5, 9, 0], np.int32)
    positions = np.array([20, 32, 7], np.int32)
    active = np.array([True, True, False])  # the third slot is dead: trash page 0
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = []
    for _ in range(steps):
        logits, _, _ = tllama.decode_step(
            tparams, torch.from_numpy(toks), torch.from_numpy(positions), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(active), tcfg, impl=impl, scatter_impl=scatter_impl,
        )
        out.append(logits.numpy())
        toks = logits.argmax(-1).int().numpy()
        positions = positions + 1
    return out, tk.numpy(), tv.numpy()


@pytest.mark.parametrize("impl", tllama.PAGED_IMPLS)
def test_decode_step_each_impl_matches_jax(model, impl):
    jcfg, tcfg, jparams, tparams = model
    kp, vp, tables = _prefilled(model)
    scatter_impl = "pallas" if impl.startswith("pallas") else "xla"
    port, tk, tv = _run_port(tparams, tcfg, kp, vp, tables, impl, scatter_impl)
    toks = np.array([5, 9, 0], np.int32)
    positions = np.array([20, 32, 7], np.int32)
    active = np.array([True, True, False])
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    for got in port:
        j_logits, jk, jv = jllama.decode_step(
            jparams, jnp.asarray(toks), jnp.asarray(positions), jk, jv, jnp.asarray(tables),
            jnp.asarray(active), jcfg, impl=impl, scatter_impl=scatter_impl,
        )
        ref = np.asarray(j_logits)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
        toks = ref.argmax(-1).astype(np.int32)
        positions = positions + 1
    for p, r in ((tk, jk), (tv, jv)):  # page 0, the trash page, excluded
        r = np.asarray(r)
        np.testing.assert_allclose(p[:, 1:], r[:, 1:], rtol=0, atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("impl", ["xla-writeback", "pallas-writeback"])
def test_decode_step_writeback_over_int8_pages_matches_jax(model, impl):
    """The writeback structure over an int8 cache (the int8 scatter, then the
    int8 write-then-attend decode, per layer) against the JAX function with
    the same impl: logits within 1e-5 of their largest value; pages within
    one int8 step (a quantized row may round the other way after f32
    reordering), scales at rtol 1e-5."""
    jcfg, tcfg, jparams, tparams = model
    jk, jv, tables = _prefilled(model, "int8")
    tk, tv = (tkv.QuantizedKV(torch.tensor(np.asarray(a.data)), torch.tensor(np.asarray(a.scale))) for a in (jk, jv))
    scatter_impl = "pallas" if impl.startswith("pallas") else "xla"
    toks = np.array([5, 9, 0], np.int32)
    positions = np.array([20, 32, 7], np.int32)
    active = np.array([True, True, False])  # the third slot is dead: trash page 0
    for _ in range(3):
        j_logits, jk, jv = jllama.decode_step(
            jparams, jnp.asarray(toks), jnp.asarray(positions), jk, jv, jnp.asarray(tables),
            jnp.asarray(active), jcfg, impl=impl, scatter_impl=scatter_impl,
        )
        t_logits, _, _ = tllama.decode_step(
            tparams, torch.from_numpy(toks), torch.from_numpy(positions), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(active), tcfg, impl=impl, scatter_impl=scatter_impl,
        )
        ref = np.asarray(j_logits)
        np.testing.assert_allclose(t_logits.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
        toks = ref.argmax(-1).astype(np.int32)
        positions = positions + 1
    for p, r in ((tk, jk), (tv, jv)):  # page 0, the trash page, excluded
        np.testing.assert_allclose(p.scale.numpy()[:, 1:], np.asarray(r.scale)[:, 1:], rtol=1e-5)
        diff = np.abs(p.data.numpy()[:, 1:].astype(np.int32) - np.asarray(r.data)[:, 1:].astype(np.int32))
        assert diff.max() <= 1 and diff.mean() < 1e-3


def test_writeback_structure_matches_read_only_structure(model):
    _, tcfg, _, tparams = model
    kp, vp, tables = _prefilled(model)
    ro, rk, rv = _run_port(tparams, tcfg, kp, vp, tables, "xla")
    wb, wk, wv = _run_port(tparams, tcfg, kp, vp, tables, "pallas-writeback")
    for a, b in zip(wb, ro):  # live slots; a dead slot's logits differ by design and are never read
        np.testing.assert_allclose(a[:2], b[:2], rtol=0, atol=1e-5 * np.abs(b).max())
    # the same K/V rows land in the same places (the trash page aside); past
    # the first layer they carry the attention's f32 rounding
    for a, b in ((wk, rk), (wv, rv)):
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("impl", tllama.PAGED_IMPLS)
def test_paged_impl_plan_reports_the_structure(impl, kv_dtype):
    cfg = tllama.LlamaConfig.llama2_7b()
    writeback = impl.endswith("-writeback")
    for scatter_impl in tllama.SCATTER_IMPLS:
        plan = tllama.paged_impl_plan(cfg, "cpu", kv_dtype, impl=impl, scatter_impl=scatter_impl)
        assert plan["attention"] == ("writeback" if writeback else "ragged")
        assert plan["scatter"] == "kernel" and plan["impl"] == "plain" and plan["kv_dtype"] == kv_dtype
        assert plan["requested"] == impl and plan["downgraded"] == []
        assert plan["ragged_variant"] == (None if writeback else tpa.ragged_variant_for(32, kv_dtype))
        # the JAX plan names the same structure (its "xla" reads pages through an XLA gather)
        jplan = jllama.paged_impl_plan(jllama.LlamaConfig.llama2_7b(), 16, impl, kv_dtype=kv_dtype, warn=False)
        assert (jplan["attention"] == "writeback") == writeback
    # the card serves every structure at every kv dtype (int8 pages through
    # the int8 kernel of the structure)
    card = tllama.paged_impl_plan(cfg, "cuda", kv_dtype, impl=impl)
    assert card["impl"] == "cuda" and card["attention"] == plan["attention"] and card["downgraded"] == []


@pytest.mark.parametrize("cfg", ["llama2_7b", "llama3_8b", "tiny"])
def test_tp_shard_ok_as_jax(cfg):
    tcfg, jcfg = getattr(tllama.LlamaConfig, cfg)(), getattr(jllama.LlamaConfig, cfg)()
    for tp in (1, 2, 3, 4, 8, 16):
        assert tllama.tp_shard_ok(tcfg, tp) == jllama.tp_shard_ok(jcfg, tp)


def test_unknown_impl_names_raise(model):
    _, tcfg, _, tparams = model
    cfg = tllama.LlamaConfig.llama2_7b()
    with pytest.raises(ValueError, match="paged_impl"):
        tllama.paged_impl_plan(cfg, "cpu", impl="mosaic")
    with pytest.raises(ValueError, match="scatter_impl"):
        tllama.paged_impl_plan(cfg, "cpu", scatter_impl="triton")
    with pytest.raises(ValueError, match="paged_impl"):
        LLMEngine(tcfg, tparams, device="cpu", paged_impl="xla-inflight", max_slots=2, max_model_len=64)
    with pytest.raises(ValueError, match="scatter_impl"):
        LLMEngine(tcfg, tparams, device="cpu", scatter_impl="dma", max_slots=2, max_model_len=64)


# -- the engine --------------------------------------------------------------------------

MARGIN = 1e-3
ENGINE_KW = dict(
    max_slots=4, max_model_len=256, page_size=16, prefill_buckets=(32, 64),
    seed=0, kv_dtype="float32", decode_block=4, paged_impl="pallas-writeback",
)
REQUESTS = [  # (prompt, params): prompt lengths 11, 41, 64, 101 and 151 tokens
    ("a" * 10, dict(max_tokens=9, temperature=0.0)),
    ("the quick brown fox jumps over a lazy dog", dict(max_tokens=12, temperature=0.8, seed=7)),
    ("b" * 63, dict(max_tokens=6, temperature=1.0)),  # engine-assigned seed
    ("c" * 100, dict(max_tokens=10, temperature=0.0, stop=("zz",))),
    ("0123456789" * 15, dict(max_tokens=8, temperature=0.7, seed=123)),
]


def _ref_margin(jparams, jcfg, req, j):
    """Top-2 margin of what the reference sampled for generated token j."""
    toks = list(req.prompt_tokens) + list(req.generated_tokens[:j])
    logits = jllama.forward(jparams, jnp.asarray([toks], jnp.int32), jcfg, attn_impl="xla")[0, -1]
    p = req.params
    if p.temperature > 0:
        seed = p.seed if p.seed is not None else req.auto_seed
        step = len(req.prompt_tokens) + max(0, j - 1)  # first decode step reuses the prefill's
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), seed), step)
        logits = logits / p.temperature + jax.random.gumbel(key, logits.shape)
    top2 = np.sort(np.asarray(logits))[-2:]
    return float(top2[1] - top2[0])


def _serve(engine, params_cls):
    reqs = [engine.submit(prompt, params_cls(**kw)) for prompt, kw in REQUESTS]
    pieces = [list(engine.stream(r)) for r in reqs]
    return reqs, pieces


def _engines_agree(model, **kw):
    """The JAX and the port's engines over the same tiny f32 weights and
    requests: finish reasons, token counts and pages exactly; tokens wherever
    the reference's top-2 margin exceeds ``MARGIN``."""
    jcfg, tcfg, jparams, tparams = model
    jeng = JaxEngine(jcfg, jparams, enable_prefix_cache=False, **kw)
    teng = LLMEngine(tcfg, tparams, device="cpu", enable_prefix_cache=False, **kw)
    assert teng.impl_plan["attention"] == "writeback" and teng.paged_impl == jeng.paged_impl
    assert teng.kv_dtype == jeng.kv_dtype and teng.cache.quantized == (kw["kv_dtype"] == "int8")
    try:
        jreqs, jpieces = _serve(jeng, JaxParams)
        treqs, tpieces = _serve(teng, SamplingParams)
        assert jeng.cache.allocator.available == jeng.cache.n_pages - 1
        assert teng.cache.allocator.available == teng.cache.n_pages - 1
    finally:
        jeng.stop()
        teng.stop()
    for jr, tr, jp, tp in zip(jreqs, treqs, jpieces, tpieces):
        assert tr.finish_reason == jr.finish_reason
        assert tr.n_generated == jr.n_generated
        assert len(tr.generated_tokens) == len(jr.generated_tokens)
        if tr.generated_tokens == jr.generated_tokens:
            assert tp == jp
            continue
        j = next(i for i, (a, b) in enumerate(zip(tr.generated_tokens, jr.generated_tokens)) if a != b)
        assert _ref_margin(jparams, jcfg, jr, j) <= MARGIN, f"token {j} differs past the margin"


def test_writeback_engine_matches_jax_engine(model):
    _engines_agree(model, **ENGINE_KW)


def test_writeback_engine_over_int8_pages_matches_jax_engine(model):
    """int8 pages on the writeback structure (the JAX engine's
    ``kv_dtype="int8"`` with ``paged_impl="pallas-writeback"``)."""
    _engines_agree(model, **{**ENGINE_KW, "kv_dtype": "int8"})


def _row_rel(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().amax(dim=-1) / ref.abs().amax(dim=-1)).max().item()


@pytest.mark.gpu
def test_writeback_kernel_matches_plain_on_card():
    """Run on the card (``python3 chip_smoke.py`` covers the same at full
    width). Contexts up to 1001 rows over 64 pages, so several splits merge.
    Each (sequence, head) row with a context within 1e-2 of its largest value
    (one bf16 ulp is at most 2^-7 of it), and at most 1% of the elements
    differing from the plain version's bf16 values (both keep f32
    probabilities: only the f32 summation order differs before the one
    rounding). Then an engine serves int8 pages on the writeback structure
    through the int8 kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    ctx = [0, 1, PS, PS + 1, 334, 1001, 64 * PS, 1]
    for hq, hkv in GROUPS:
        c = _case(7, hq, hkv, ctx=ctx, pps=64)
        args = [t.cuda() for t in _port_args(c, torch.bfloat16)]
        before = tpa.decode_writeback_launches
        out = tpa.paged_decode_attention(*args)
        torch.cuda.synchronize()
        assert tpa.decode_writeback_launches == before + 1
        want = tpa.paged_decode_writeback_plain(*args)
        assert not out[0].any()  # no context: zeros
        got, ref = out[1:].float(), want[1:].float()
        assert _row_rel(got, ref) <= 1e-2
        assert (got != ref).float().mean().item() <= 1e-2
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), n_heads=4, n_kv_heads=4)
    eng = LLMEngine(cfg, device="cuda", kv_dtype="int8", paged_impl="xla-writeback", max_slots=2, max_model_len=64,
                    enable_prefix_cache=False)
    before = (tpa.decode_writeback_launches, tpa.decode_writeback_int8_launches, tpa.decode_int8_launches)
    try:
        req = eng.submit("hello", SamplingParams(max_tokens=4, temperature=0.0))
        "".join(eng.stream(req))
        assert req.n_generated == 4 and eng.cache.allocator.available == eng.cache.n_pages - 1
    finally:
        eng.stop()
    after = (tpa.decode_writeback_launches, tpa.decode_writeback_int8_launches, tpa.decode_int8_launches)
    assert after[0] == before[0] and after[2] == before[2] and after[1] > before[1]


@pytest.mark.gpu
def test_writeback_kernels_at_split_edges_on_card():
    """Both write-then-attend kernels at contexts on both sides of the split
    edges (each counts the current token), G = 1 and 4, D = 128: per
    (sequence, head) row within 1e-2 of its largest value against the plain
    version (int8 also max abs 6e-2), bitwise equal on a second launch, and
    an empty context exactly zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    src = (Path(tpa.__file__).resolve().parent.parent / "csrc" / "paged_decode.cuh").read_text()
    split = int(re.search(r"constexpr int SPLIT = (\d+);", src).group(1))
    ctx = [0] + [n + 1 for n in (split - 1, split, split + 1, 2 * split, 2 * split + 1, 3 * split - 1)] + [64 * PS]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for hq, hkv in ((4, 4), (8, 2)):
        B, P, d = len(ctx), 1 + len(ctx) * 64, 128
        tables = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(1))[: B * 64] + 1).reshape(B, 64)
        tables, lens = tables.to(dev, torch.int32), torch.tensor(ctx, dtype=torch.int32, device=dev)
        q = torch.randn(B, hq, d, generator=g, device=dev).bfloat16()
        bf16_pages = [torch.randn(P, PS, hkv, d, generator=g, device=dev).bfloat16() for _ in range(2)]
        int8_pages = [tkv.quantize_kv(t.float()) for t in bf16_pages]
        for kernel, plain, pages, max_abs in (
            (tpa.paged_decode_writeback_cuda, tpa.paged_decode_writeback_plain, bf16_pages, None),
            (tpa.paged_decode_writeback_int8_cuda, tpa.paged_decode_writeback_int8_plain, int8_pages, 6e-2),
        ):
            args = (q, *pages, tables, lens)
            got, again = (kernel(*args, sm_scale=d**-0.5) for _ in range(2))
            torch.cuda.synchronize()
            want = plain(*args, sm_scale=d**-0.5)
            assert not got[0].any() and torch.equal(got, again)
            assert _row_rel(got[1:], want[1:]) <= 1e-2
            if max_abs is not None:
                assert (got.float() - want.float()).abs().max().item() <= max_abs
