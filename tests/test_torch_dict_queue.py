"""The port's ``Dict`` and ``Queue`` (``storage/dict_queue.py``) held against
the JAX package's: the cases of ``tests/test_primitives.py::TestDictQueue``
on the port, one operation sequence through both packages (results and
exceptions equal, ``Empty`` after a timeout and partitions included), one
on-disk format read across the packages, and a ``Dict``/``Queue`` shared
between a spawned container and its caller.
"""

import threading
import time

import pytest

import modal_examples_tpu as jm
import modal_examples_tpu_torch as pm
from modal_examples_tpu.storage.dict_queue import Empty as JEmpty
from modal_examples_tpu_torch.core.app import load_module_from_path
from modal_examples_tpu_torch.storage.dict_queue import Empty
from test_torch_time_limit import share_cores, time_limits

share_cores()

#: the container test boots one container (about a second)
_limit_module, _limit_test = time_limits(test_s=60, module_s=120)


class TestDictQueue:
    def test_dict_ops(self):
        with pm.Dict.ephemeral() as d:
            d["a"] = 1
            d.put("b", {"x": [1, 2]})
            assert d["a"] == 1
            assert d.get("b") == {"x": [1, 2]}
            assert "a" in d
            assert len(d) == 2
            assert d.pop("a") == 1
            assert d.get("a", "gone") == "gone"

    def test_queue_fifo_and_partitions(self):
        with pm.Queue.ephemeral() as q:
            q.put_many([1, 2, 3])
            q.put(99, partition="other")
            assert q.get() == 1
            assert q.get_many(5) == [2, 3]
            assert q.get(partition="other") == 99
            with pytest.raises(Empty):
                q.get(block=False)

    def test_queue_blocking_get(self):
        with pm.Queue.ephemeral() as q:
            def put_later():
                time.sleep(0.1)
                q.put("late")

            threading.Thread(target=put_later).start()
            assert q.get(timeout=2.0) == "late"

    def test_queue_timeout(self):
        with pm.Queue.ephemeral() as q:
            t0 = time.monotonic()
            with pytest.raises(Empty):
                q.get(timeout=0.05)
            assert time.monotonic() - t0 >= 0.05

    def test_ephemeral_leaves_nothing_behind(self, state_dir):
        with pm.Dict.ephemeral() as d:
            d["k"] = 1
            name = d.name
        assert not (state_dir / "dicts" / f"{name}.pkl").exists()
        assert not (state_dir / "dicts" / f"{name}.lock").exists()


def _outcome(fn):
    """What ``fn()`` returned, or the name of the exception it raised."""
    try:
        return ("ok", fn())
    except Exception as e:
        return ("raised", "Empty" if isinstance(e, (Empty, JEmpty)) else type(e).__name__)


def _dict_sequence(pkg, name):
    d = pkg.Dict.from_name(name)
    return [
        _outcome(lambda: d.put("a", 1)),
        _outcome(lambda: d.put_if_absent("a", 2)),
        _outcome(lambda: d.put_if_absent("b", [1, {"x": (2, 3)}])),
        _outcome(lambda: d["a"]),
        _outcome(lambda: d["missing"]),
        _outcome(lambda: d.get("missing", "dflt")),
        _outcome(lambda: d.update(c=3, e=None)),
        _outcome(lambda: sorted(d.keys())),
        _outcome(lambda: sorted(map(repr, d.values()))),
        _outcome(lambda: sorted(d.items(), key=repr)),
        _outcome(lambda: (d.contains("c"), "zz" in d, d.len(), len(d))),
        _outcome(lambda: d.pop("c")),
        _outcome(lambda: d.pop("c")),
        _outcome(lambda: d.pop("c", "gone")),
        _outcome(lambda: d.clear()),
        _outcome(lambda: len(d)),
        _outcome(lambda: pkg.Dict.delete(name)),
    ]


def _queue_sequence(pkg, name):
    q = pkg.Queue.from_name(name)
    return [
        _outcome(lambda: q.put_many([1, 2, 3])),
        _outcome(lambda: q.put("p0", partition="p")),
        _outcome(lambda: q.put_many(["p1", "p2"], partition="p")),
        _outcome(lambda: (q.len(), q.len(partition="p"), q.len(total=True), len(q))),
        _outcome(lambda: q.get()),
        _outcome(lambda: q.get_many(1)),
        _outcome(lambda: q.get_many(10, partition="p")),
        _outcome(lambda: q.get(block=False)),
        _outcome(lambda: q.get(block=False)),
        _outcome(lambda: q.get(timeout=0.05)),
        _outcome(lambda: q.get(block=False, partition="p")),
        _outcome(lambda: q.get_many(3, block=False, partition="none")),
        _outcome(lambda: q.put_many(range(4))),
        _outcome(lambda: q.clear(partition="p")),
        _outcome(lambda: q.len(total=True)),
        _outcome(lambda: q.clear(all=True)),
        _outcome(lambda: q.len(total=True)),
        _outcome(lambda: pkg.Queue.delete(name)),
    ]


@pytest.mark.parametrize("sequence", [_dict_sequence, _queue_sequence], ids=["dict", "queue"])
def test_one_sequence_through_both_packages(sequence):
    port = sequence(pm, "seq-port")
    ref = sequence(jm, "seq-jax")
    assert port == ref
    assert ("raised", "Empty") in port or ("raised", "KeyError") in port


@pytest.mark.parametrize("writer,reader", [(pm, jm), (jm, pm)], ids=["port-writes", "jax-writes"])
def test_one_on_disk_format(writer, reader):
    """Both packages pointed at one state directory share dicts and queues:
    the same pickled file under ``dicts/`` and ``queues/``, the same lock."""
    writer.Dict.from_name("shared-fmt")["k"] = {"v": [1, 2]}
    writer.Queue.from_name("shared-fmt").put_many(["a", "b"], partition="x")
    try:
        assert reader.Dict.from_name("shared-fmt")["k"] == {"v": [1, 2]}
        assert reader.Queue.from_name("shared-fmt").get_many(5, partition="x") == ["a", "b"]
    finally:
        reader.Dict.delete("shared-fmt")
        reader.Queue.delete("shared-fmt")


def test_put_if_absent_claims_once_across_threads():
    """The crawler's exactly-once claim: of 8 racing claimers one wins."""
    with pm.Dict.ephemeral() as d:
        wins = []
        barrier = threading.Barrier(8)

        def claim(i):
            barrier.wait()
            if d.put_if_absent("job", i):
                wins.append(i)

        threads = [threading.Thread(target=claim, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(wins) == 1 and d["job"] == wins[0]


SHARED = '''
import modal_examples_tpu_torch as mtpu

app = mtpu.App("dict-queue-shared")


@app.function(timeout=60)
def worker(dict_name: str, queue_name: str) -> int:
    """Drain the caller's queue into the caller's dict, then answer on the
    queue's ``done`` partition."""
    d, q = mtpu.Dict.from_name(dict_name), mtpu.Queue.from_name(queue_name)
    n = 0
    while True:
        item = q.get(timeout=30)
        if item is None:
            break
        d[item] = item * item
        n += 1
    q.put(n, partition="done")
    return n
'''


def test_shared_between_a_container_and_its_caller(tmp_path):
    path = tmp_path / "dict_queue_app.py"
    path.write_text(SHARED)
    mod = load_module_from_path(str(path))
    with pm.Dict.ephemeral() as d, pm.Queue.ephemeral() as q:
        with mod.app.run():
            call = mod.worker.spawn(d.name, q.name)
            q.put_many([1, 2, 3, None])
            assert call.get(timeout=60) == 3
        assert q.get(timeout=5, partition="done") == 3
        assert dict(d.items()) == {1: 1, 2: 4, 3: 9}
