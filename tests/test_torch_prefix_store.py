"""The port's shared prefix store (``serving/prefix_store/``) against the JAX
package's, driven by the same scripts on two volumes:

- ``rendezvous_owner`` names the same owner for seeded chains and replica
  names;
- membership, lease and takeover sequences under the same fake clock give
  the same answers, lease files and ``prefix_store`` journal records;
- a block written by either package's store reads back bitwise through the
  other's (bf16 and int8 pages, the MTKV1 envelope);
- dedup, deferral to the rendezvous owner, the owner-death fault, torn and
  corrupt blocks, refcount pins and the bounded LRU ``gc`` leave equal
  ``stats()`` and equal sweep reports.
"""

import json
import os

import numpy as np
import pytest

import modal_examples_tpu.serving.disagg.transport as jtr
import modal_examples_tpu.serving.prefix_store as jps
import modal_examples_tpu_torch.serving.disagg.transport as ttr
import modal_examples_tpu_torch.serving.prefix_store as tps
from modal_examples_tpu.faults import inject as jinject
from modal_examples_tpu.storage.volume import Volume as JVolume
from modal_examples_tpu_torch.faults import inject as tinject
from modal_examples_tpu_torch.storage.volume import Volume as TVolume
from test_torch_time_limit import share_cores, time_limits
from test_torch_transport import PAGES, TOKENS, _bits, jax_cache, port_cache

share_cores()

_limit_module, _limit_test = time_limits(test_s=60, module_s=120)

SIDES = {"jax": (jps, JVolume, jinject), "port": (tps, TVolume, tinject)}


@pytest.fixture()
def vols():
    """One ephemeral volume per package."""
    with JVolume.ephemeral() as jv, TVolume.ephemeral() as tv:
        yield {"jax": jv, "port": tv}


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _no_at(records: list) -> list:
    return [{k: v for k, v in r.items() if k != "at"} for r in records]


def _scripted(script, side: str, state, *args) -> list:
    """Run one side's script with a state directory of its own (the tests'
    shared one takes other workers' journals); its last row is the
    ``prefix_store`` journal the script wrote."""
    monkeypatch, root = state
    d = root / f"state-{side}"
    d.mkdir()
    monkeypatch.setenv("MTPU_STATE_DIR", str(d))
    out = script(*args)
    path = d / "prefix_store.jsonl"
    records = [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []
    out.append(("journal", _no_at(records)))
    return out


def _block_bytes(kv: str, seed: int, pages=(3,)) -> bytes:
    """One serialized block of the port's cache (bytes equal to the JAX
    package's for the same pages)."""
    return ttr.serialize_block(ttr.extract_pages(port_cache(kv, seed), list(pages)))


# -- ownership -----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_rendezvous_owner_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    names = [f"replica-{int(x)}" for x in rng.integers(0, 10_000, size=int(rng.integers(1, 9)))]
    tokens = [int(t) for t in rng.integers(0, 32_000, size=96)]
    for chain in ttr.chain_hashes(tokens, 8):
        assert tps.rendezvous_owner(chain, names) == jps.rendezvous_owner(chain, names)
    assert tps.rendezvous_owner("x", []) is None and jps.rendezvous_owner("x", []) is None


def _lease_script(pkg, vol, clock: Clock) -> list:
    """Two replicas' boards over one volume: acquire, refusal, expiry,
    owner death, release; every answer and lease file in order."""
    a = pkg.LeaseBoard(vol, "ps", "a", lease_ttl_s=10.0, replica_ttl_s=30.0, clock=clock)
    b = pkg.LeaseBoard(vol, "ps", "b", lease_ttl_s=10.0, replica_ttl_s=30.0, clock=clock)
    out = []
    a.register()
    b.register(boot="warm")
    out.append(("alive", a.alive_replicas()))
    out.append(("owner", a.owner_for("c1"), b.owner_for("c2", ["a", "b", "z"])))
    out.append(("a.acquire", a.acquire("c1"), a.lease_of("c1")))
    out.append(("b.acquire live", b.acquire("c1")))
    clock.t += 11.0  # past the lease ttl: an expired lease is taken over
    out.append(("b.acquire expired", b.acquire("c1"), b.lease_of("c1"), b.takeovers))
    out.append(("a.release not held", a.release("c1"), a.lease_of("c1")))
    out.append(("a.acquire c2", a.acquire("c2")))
    a.deregister()  # a dies: its live lease is taken over as owner_dead
    out.append(("alive after", b.alive_replicas()))
    out.append(("b.acquire dead", b.acquire("c2"), b.lease_of("c2"), b.takeovers))
    clock.t += 31.0  # b's heartbeat goes stale too
    out.append(("alive stale", b.alive_replicas(), b.owner_for("c3")))
    b.heartbeat()
    out.append(("n_leases", b.n_leases()))
    b.release("c2")
    out.append(("released", b.lease_of("c2"), b.n_leases()))
    return out


def test_lease_and_takeover_sequence_equals_the_reference(vols, monkeypatch, tmp_path):
    state = (monkeypatch, tmp_path)
    got = {side: _scripted(_lease_script, side, state, SIDES[side][0].ownership, vols[side], Clock())
           for side in SIDES}
    assert got["port"] == got["jax"]
    takeovers = [r for r in got["port"][-1][1] if r["action"] == "owner_takeover"]
    assert [r["reason"] for r in takeovers] == ["lease_expired", "owner_dead"]


# -- blocks across packages ------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_a_block_written_by_one_store_reads_bitwise_in_the_other(vols, kv, writer):
    """Both stores over ONE volume (the port's): a block spilled by either
    package is found, read and deserialized bitwise by the other."""
    vol = vols["port"]
    reader = "port" if writer == "jax" else "jax"
    hashes = jtr.chain_hashes(TOKENS, 4)
    if writer == "jax":
        wire = jtr.serialize_block(jtr.extract_pages(jax_cache(kv, 3), PAGES, block_hashes=hashes))
    else:
        wire = ttr.serialize_block(ttr.extract_pages(port_cache(kv, 3), PAGES, block_hashes=hashes))
    w = SIDES[writer][0].SharedPrefixStore(vol, replica="w", shared=False)
    r = SIDES[reader][0].SharedPrefixStore(vol, replica="r", shared=False)
    assert w.put(hashes[0], wire) == "written"
    assert r.exists(hashes[0]) and r.put(hashes[0], wire) == "dedup"
    got = r.get(hashes[0])
    assert got == wire
    assert r.stats()["hits"] == {"self": 0, "peer": 1}
    back = (ttr if reader == "port" else jtr).deserialize_block(got)
    want = ttr.extract_pages(port_cache(kv, 3), PAGES)
    assert sorted(back.leaves) == sorted(want.leaves)
    for name in want.leaves:
        assert _bits(back.leaves[name]) == _bits(want.leaves[name]), name
    assert back.block_hashes == hashes and back.kv_dtype == kv


# -- the store's behaviour, scripted on both sides --------------------------------


def _store_script(pkg, inject, vol, clock: Clock) -> list:
    """Dedup, deferral, the owner-death fault, torn and corrupt blocks."""
    a = pkg.SharedPrefixStore(vol, replica="a", shared=True, lease_ttl_s=10.0, replica_ttl_s=30.0, clock=clock)
    b = pkg.SharedPrefixStore(vol, replica="b", shared=True, lease_ttl_s=10.0, replica_ttl_s=30.0, clock=clock)
    chains = ttr.chain_hashes(list(range(64)), 8)
    head = chains[0]
    owner, other = (a, b) if a.owner_for(head) == "a" else (b, a)
    data = [_block_bytes("int8", i) for i in range(4)]
    out = [("owner", owner.replica)]
    out.append(("non-owner defers", other.put(chains[0], data[0], chain=head)))
    out.append(("owner writes", owner.put(chains[0], data[0], chain=head)))
    out.append(("dedup", other.put(chains[0], data[0], chain=head)))
    out.append(("peer hit", other.get(chains[0]) == data[0], other.stats()["hits"]))
    out.append(("miss", owner.get("nope")))
    # the owner dies mid-spill: it leaves the membership, nothing lands
    with inject.active(inject.FaultPlan({"prefix_store.owner_death": {"on_hit": 1}})):
        try:
            owner.put(chains[1], data[1], chain=head)
            out.append(("owner death", "no raise"))
        except inject.FaultError as e:
            out.append(("owner death", str(e)))
    out.append(("after death", owner.exists(chains[1]), other.alive_replicas()))
    out.append(("survivor takes over", other.put(chains[1], data[1], chain=head), other.board.takeovers))
    owner.register_replica()
    # a torn block is dropped and reported as a miss
    torn = vol.local_path / other.root / pkg.block_file(chains[1])
    torn.write_bytes(data[1][:-7])
    out.append(("torn", other.get(chains[1]), other.exists(chains[1])))
    # in-flight corruption keeps the stored block; rotten bytes on disk go
    other.put(chains[2], data[2], chain=None)
    out.append(("inflight corrupt kept", other.drop_if_corrupt(chains[2]), other.exists(chains[2])))
    rotten = vol.local_path / other.root / pkg.block_file(chains[2])
    raw = bytearray(rotten.read_bytes())
    raw[-3] ^= 0xFF
    rotten.write_bytes(bytes(raw))
    out.append(("rotten dropped", other.drop_if_corrupt(chains[2]), other.exists(chains[2])))
    stats = [{k: v for k, v in s.stats().items()} for s in (a, b)]
    out.append(("stats", stats, round(a.dedup_ratio(), 6), round(b.dedup_ratio(), 6)))
    return out


def test_dedup_ownership_faults_and_stats_equal_the_reference(vols, monkeypatch, tmp_path):
    state = (monkeypatch, tmp_path)
    got = {side: _scripted(_store_script, side, state, SIDES[side][0], SIDES[side][2], vols[side], Clock())
           for side in SIDES}
    assert got["port"] == got["jax"]
    steps = dict((row[0], row[1:]) for row in got["port"])
    assert steps["non-owner defers"] == ("deferred",) and steps["dedup"] == ("dedup",)
    assert steps["owner death"] == ("injected fault: prefix_store.owner_death",)
    assert steps["survivor takes over"][0] == "written" and steps["survivor takes over"][1] == 1
    assert steps["torn"] == (None, False) and steps["rotten dropped"] == (True, False)


def _gc_script(pkg, vol) -> list:
    s = pkg.SharedPrefixStore(vol, replica="a", shared=False)
    peer = pkg.SharedPrefixStore(vol, replica="b", shared=True)
    live = pkg.SharedPrefixStore(vol, replica="c", shared=True)
    data = _block_bytes("bfloat16", 9)
    names = [f"g{i}" for i in range(6)]
    for i, h in enumerate(names):
        s.put(h, data)
        # strictly increasing mtimes: g0 oldest
        path = vol.local_path / s.root / pkg.block_file(h)
        os.utime(path, (1000.0 + i, 1000.0 + i))
    out = [("stats", s.stats())]
    s.unpin(names)
    s.pin(["g0", "g1"])
    out.append(("gc bounded", s.gc(max_blocks=2, max_remove=2)))
    out.append(("left", [s.exists(h) for h in names]))
    out.append(("gc again", s.gc(max_blocks=2, max_remove=64)))
    # a live peer's pins hold a block against another replica's sweep
    live.put("p0", data)
    live.pin(["p0"])
    out.append(("peer gc", peer.gc(max_blocks=0, max_remove=64), peer.exists("p0")))
    live.deregister_replica()
    out.append(("after deregister", peer.gc(max_blocks=0, max_remove=64), peer.exists("p0")))
    out.append(("stats after", s.stats(), peer.stats()))
    return out


def test_gc_pins_and_stats_equal_the_reference(vols, monkeypatch, tmp_path):
    state = (monkeypatch, tmp_path)
    got = {side: _scripted(_gc_script, side, state, SIDES[side][0], vols[side]) for side in SIDES}
    assert got["port"] == got["jax"]
    steps = dict((row[0], row[1:]) for row in got["port"])
    assert steps["gc bounded"][0]["removed"] == 2
    assert steps["left"] == ([True, True, False, False, True, True],)
    assert steps["peer gc"][1] is True and steps["after deregister"][1] is False
