"""The port's MTKV1 wire codec (``serving/disagg/transport.py``) against the
JAX package's: the same pages, bf16 and int8, serialize to the same bytes;
each side deserializes the other's blocks; the leaf names are the JAX
package's tree paths; a flipped byte, a truncation and a bad magic raise
``TransportError``; ``chain_hashes`` agree; the chunked transfer retries a
dropped or corrupted chunk to the same payload, and a dead peer or a
stalled sender ends as the JAX package's does.
"""

import dataclasses
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import modal_examples_tpu.serving.disagg.transport as jtr
import modal_examples_tpu.serving.kv_cache as jkv
import modal_examples_tpu_torch.serving.disagg.transport as ttr
import modal_examples_tpu_torch.serving.kv_cache as tkv
from modal_examples_tpu.faults import inject as jinject
from modal_examples_tpu.ops.kv_quant import QuantizedKV as JQuantizedKV
from modal_examples_tpu.serving import health as jhealth
from modal_examples_tpu_torch.faults import inject as tinject
from modal_examples_tpu_torch.ops.kv_quant import QuantizedKV as TQuantizedKV
from modal_examples_tpu_torch.serving import health as thealth
from test_torch_time_limit import share_cores, time_limits

share_cores()

_limit_module, _limit_test = time_limits(test_s=60, module_s=120)

GEOM = dict(n_layers=2, n_kv_heads=2, head_dim=8, n_pages=9, page_size=4)
PAGES = [3, 7, 1, 5]
TOKENS = list(range(100, 117))  # 4 full pages of 4, one token over
META = {"request_id": "req-0123456789ab", "prompt_tokens": TOKENS, "position": 17, "first_token": 42,
        "auto_seed": 7, "trace": None}


def _pages(kv: str, seed: int) -> dict:
    """One cache's leaves as numpy (bf16 as its bits), the same for both packages."""
    rng = np.random.default_rng(seed)
    shape = (GEOM["n_layers"], GEOM["n_pages"], GEOM["page_size"], GEOM["n_kv_heads"], GEOM["head_dim"])
    out = {}
    for name in ("k_pages", "v_pages"):
        if kv == "int8":
            out[name] = (rng.integers(-127, 128, shape).astype(np.int8),
                         rng.random(shape[:-1]).astype(np.float32) + 0.01)
        else:
            out[name] = rng.standard_normal(shape).astype(ml_dtypes.bfloat16).view(np.uint16)
    return out


def jax_cache(kv: str, seed: int = 0):
    cache = jkv.PagedKVCache.create(**GEOM, kv_dtype="int8" if kv == "int8" else jnp.bfloat16)
    for name, val in _pages(kv, seed).items():
        if kv == "int8":
            setattr(cache, name, JQuantizedKV(data=jnp.asarray(val[0]), scale=jnp.asarray(val[1])))
        else:
            setattr(cache, name, jnp.asarray(val.view(ml_dtypes.bfloat16)))
    return cache


def port_cache(kv: str, seed: int = 0):
    cache = tkv.PagedKVCache.create(**GEOM, kv_dtype="int8" if kv == "int8" else "bfloat16", device="cpu")
    for name, val in _pages(kv, seed).items():
        if kv == "int8":
            setattr(cache, name, TQuantizedKV(data=torch.from_numpy(val[0]), scale=torch.from_numpy(val[1])))
        else:
            setattr(cache, name, torch.from_numpy(val.view(np.int16).copy()).view(torch.bfloat16))
    return cache


def _blocks(kv: str):
    hashes = jtr.chain_hashes(TOKENS, GEOM["page_size"])
    jb = jtr.extract_pages(jax_cache(kv), PAGES, block_hashes=hashes, meta=META)
    tb = ttr.extract_pages(port_cache(kv), PAGES, block_hashes=hashes, meta=META)
    return jb, tb


def _bits(a) -> bytes:
    """A leaf's raw bytes, from either side (bf16 as its 2-byte bit patterns)."""
    if isinstance(a, torch.Tensor):
        t = a.contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_serialized_bytes_equal_the_jax_package(kv):
    jb, tb = _blocks(kv)
    wire = ttr.serialize_block(tb)
    assert wire == jtr.serialize_block(jb)
    assert tb.n_pages == len(PAGES) and tb.nbytes() == jb.nbytes() and tb.kv_dtype == jb.kv_dtype == kv


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_each_side_deserializes_the_other(kv):
    jb, tb = _blocks(kv)
    from_jax = ttr.deserialize_block(jtr.serialize_block(jb))
    from_port = jtr.deserialize_block(ttr.serialize_block(tb))
    for back, want in ((from_jax, tb), (from_port, jb)):
        assert sorted(back.leaves) == sorted(want.leaves)
        for name in want.leaves:
            assert _bits(back.leaves[name]) == _bits(want.leaves[name]), name
            assert tuple(back.leaves[name].shape) == tuple(want.leaves[name].shape)
        assert (back.meta, back.block_hashes, back.page_size, back.kv_dtype) == (
            want.meta, want.block_hashes, want.page_size, want.kv_dtype)
    # the port carries bf16 as torch tensors, never through numpy
    if kv == "bfloat16":
        assert all(t.dtype == torch.bfloat16 for t in from_jax.leaves.values())


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_leaf_names_equal_the_jax_wire_leaves(kv):
    jnames = [n for n, _ in jtr.wire_leaves(jax_cache(kv))]
    tnames = [n for n, _ in ttr.wire_leaves(port_cache(kv))]
    assert tnames == jnames
    assert tnames == (["k_pages.data", "k_pages.scale", "v_pages.data", "v_pages.scale"] if kv == "int8"
                      else ["k_pages", "v_pages"])


@pytest.mark.parametrize("damage", ["flip", "truncate", "magic"])
def test_damaged_wire_raises_transport_error(damage):
    _, tb = _blocks("int8")
    wire = bytearray(ttr.serialize_block(tb))
    if damage == "flip":
        wire[-5] ^= 0x01  # payload byte: a crc mismatch on the last leaf
        match = "crc mismatch"
    elif damage == "truncate":
        del wire[-3:]
        match = "truncated"
    else:
        wire[:6] = b"MTKV0\n"
        match = "bad magic"
    with pytest.raises(ttr.TransportError, match=match):
        ttr.deserialize_block(bytes(wire))
    with pytest.raises(jtr.TransportError, match=match):
        jtr.deserialize_block(bytes(wire))


@pytest.mark.parametrize("page_size", [1, 4, 16])
def test_chain_hashes_equal(page_size):
    for tokens in ([], list(range(3)), list(range(64)), [31999, 0, 5] * 11):
        assert ttr.chain_hashes(tokens, page_size) == jtr.chain_hashes(tokens, page_size)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_adopt_round_trip_is_bitwise(kv):
    _, tb = _blocks(kv)
    dst = port_cache(kv, seed=1)
    target = [2, 4, 6, 8]
    ttr.adopt_pages(dst, ttr.deserialize_block(ttr.serialize_block(tb)), target)
    src = port_cache(kv)
    for (name, a), (_, b) in zip(ttr.wire_leaves(src), ttr.wire_leaves(dst)):
        assert _bits(a[:, PAGES]) == _bits(b[:, target]), name
    untouched = [0, 1, 3, 5, 7]
    fresh = port_cache(kv, seed=1)
    for (_, a), (_, b) in zip(ttr.wire_leaves(fresh), ttr.wire_leaves(dst)):
        assert _bits(a[:, untouched]) == _bits(b[:, untouched])


def test_adopt_refuses_an_incompatible_block():
    _, tb = _blocks("int8")
    with pytest.raises(ttr.TransportError, match="kv_dtype mismatch"):
        ttr.adopt_pages(port_cache("bfloat16"), tb, [1, 2, 3, 4])
    with pytest.raises(ttr.TransportError, match="adopting 4 pages into 3"):
        ttr.adopt_pages(port_cache("int8"), tb, [1, 2, 3])
    with pytest.raises(ttr.TransportError, match="page_size mismatch"):
        ttr.adopt_pages(port_cache("int8"), dataclasses.replace(tb, page_size=8), [1, 2, 3, 4])


def _transfer_both(spec: dict, payload: bytes) -> list:
    """The same payload through each package's transfer under the same fault
    plan: (result or exception type, the plan's hit and fire counts)."""
    out = []
    for inject, tr in ((jinject, jtr), (tinject, ttr)):
        plan = inject.FaultPlan(spec, seed=3)
        with inject.active(plan):
            try:
                got = tr.transfer(payload, tr.LoopbackChannel(), transfer_id="req-t", chunk_bytes=64,
                                  max_rounds=4, backoff=None)
            except Exception as e:  # the outcome is compared, not raised
                got = type(e).__name__
        out.append((got, plan.hits(), plan.fired()))
    return out


@pytest.mark.parametrize("point", ["disagg.chunk_drop", "disagg.chunk_corrupt"])
def test_a_dropped_or_corrupted_chunk_retries_to_the_same_payload(point):
    payload = bytes(range(256)) * 5  # 20 chunks of 64
    (jgot, jhits, jfired), (tgot, thits, tfired) = _transfer_both({point: {"on_hit": [2, 7, 19]}}, payload)
    assert tgot == jgot == payload
    assert (thits, tfired) == (jhits, jfired) and tfired == {point: 3}


def test_a_dead_peer_ends_the_transfer_as_the_jax_package():
    payload = b"x" * 700
    (jgot, jhits, _), (tgot, thits, _) = _transfer_both({"disagg.replica_death": {"on_hit": 4}}, payload)
    assert tgot == jgot == "ConnectionError" and thits == jhits


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_stalled_sender_is_broken_by_the_transfer_registry(pkg):
    """``disagg.transfer_stall`` holds the sender between chunks until the
    watchdog's abort through the process-wide registry lifts it."""
    inject, tr, health = (jinject, jtr, jhealth) if pkg == "jax" else (tinject, ttr, thealth)
    plan = inject.FaultPlan({"disagg.transfer_stall": {"on_hit": 2}})
    result = {}

    def run():
        with inject.active(plan):
            try:
                tr.transfer(b"y" * 300, tr.LoopbackChannel(), transfer_id="req-stall", chunk_bytes=64, backoff=None)
            except tr.TransportError as e:
                result["err"] = str(e)

    t = threading.Thread(target=run)
    t.start()
    for _ in range(2000):
        if plan.fired():
            break
        threading.Event().wait(0.005)
    assert [s["transfer_id"] for s in health.transfers.snapshot()] == ["req-stall"]
    assert health.transfers.request_abort("req-stall")
    t.join(timeout=30)
    assert "aborted by the progress watchdog" in result["err"]
    assert health.transfers.snapshot() == []
