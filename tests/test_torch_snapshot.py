"""The port's memory-snapshot subsystem (``modal_examples_tpu_torch/snapshot/``)
held against the JAX package's: the cases of ``tests/test_snapshot.py`` on
the port (store, key, codec, capture/restore policy, FunctionSpec plumbing,
the autoscaler's first-warm-boot gate, prometheus accounting, second-boot
restores in real container processes, the CLI), the codec's tensor round
trips (f32, bf16, int8, a view, an ``nn.Module``) and rebuild markers (a
kernel-library handle), the boot outcomes of one class through both
packages' ``build_and_enter``, and the keys of a ``gpu=`` class and of one
without ``gpu=``.
"""

import collections
import ctypes
import dataclasses
import json
import pickle
import threading
import types

import pytest
import torch

import modal_examples_tpu_torch as mtpu
from modal_examples_tpu.snapshot import build_and_enter as jbuild_and_enter
from modal_examples_tpu.snapshot.store import SnapshotStore as JSnapshotStore
from modal_examples_tpu_torch.core.app import load_module_from_path
from modal_examples_tpu_torch.core.executor import FunctionPool
from modal_examples_tpu_torch.snapshot import build_and_enter, codec
from modal_examples_tpu_torch.snapshot.store import (
    SnapshotStore,
    compute_snapshot_key,
    default_root,
    source_hash_for,
)
from modal_examples_tpu_torch.utils.metrics import (
    SNAPSHOT_BOOTS_METRIC,
    SNAPSHOT_CAPTURES_METRIC,
    record_snapshot_boot,
)
from modal_examples_tpu_torch.utils.prometheus import Registry, default_registry
from test_torch_time_limit import share_cores, time_limits

share_cores()

#: the end-to-end cases boot two or three containers each (a few seconds)
_limit_module, _limit_test = time_limits(test_s=90, module_s=120)


@pytest.fixture()
def store(tmp_path):
    return SnapshotStore(root=tmp_path / "snaps")


# --------------------------------------------------------------------------
# Store
# --------------------------------------------------------------------------


class TestStore:
    def test_roundtrip(self, store):
        assert not store.has("k1")
        assert store.put("k1", b"payload", {"tag": "t"})
        assert store.has("k1")
        payload, meta = store.get("k1")
        assert payload == b"payload"
        assert meta["manifest"]["tag"] == "t"
        assert meta["size_bytes"] == 7

    def test_miss(self, store):
        assert store.get("nope") is None
        assert store.inspect("nope") is None

    def test_corrupt_payload_is_deleted(self, store):
        store.put("k1", b"payload")
        store._state_path("k1").write_bytes(b"garbage")
        assert store.get("k1") is None  # checksum mismatch
        assert not store.has("k1")  # corrupt entry removed

    def test_missing_payload_is_deleted(self, store):
        store.put("k1", b"payload")
        store._state_path("k1").unlink()
        assert store.get("k1") is None
        assert not store.has("k1")

    def test_corrupt_meta_reads_as_miss_and_self_heals(self, store):
        store.put("k1", b"payload")
        store._meta_path("k1").write_text("{not json")
        assert not store.has("k1")
        assert store.get("k1") is None
        assert not store._entry_dir("k1").exists()

    def test_put_replaces_corrupt_entry(self, store):
        store.put("k1", b"old")
        store._meta_path("k1").write_text("{not json")
        assert store.put("k1", b"new")
        payload, _ = store.get("k1")
        assert payload == b"new"

    def test_clear_removes_corrupt_entries(self, store):
        store.put("k1", b"x")
        store._meta_path("k1").write_text("{not json")
        assert store.clear() == 1
        assert not store._entry_dir("k1").exists()

    def test_malformed_env_knobs_fall_back_to_defaults(self, monkeypatch, tmp_path):
        from modal_examples_tpu_torch.snapshot.store import DEFAULT_MAX_ENTRIES

        monkeypatch.setenv("MTPU_SNAPSHOT_MAX_ENTRIES", "lots")
        monkeypatch.setenv("MTPU_SNAPSHOT_MAX_BYTES", "1g")
        s = SnapshotStore(root=tmp_path)
        assert s.max_entries == DEFAULT_MAX_ENTRIES
        assert s.max_bytes is None

    def test_delete_and_clear(self, store):
        store.put("a", b"1")
        store.put("b", b"2")
        assert store.delete("a")
        assert not store.delete("a")
        assert store.clear() == 1
        assert store.entries() == []

    def test_lru_eviction_by_count(self, tmp_path):
        store = SnapshotStore(root=tmp_path, max_entries=2)
        store.put("a", b"1")
        store.put("b", b"2")
        store.get("a")
        store.put("c", b"3")
        assert {e["key"] for e in store.entries()} == {"a", "c"}

    def test_eviction_by_bytes(self, tmp_path):
        store = SnapshotStore(root=tmp_path, max_entries=100, max_bytes=10)
        store.put("a", b"x" * 8)
        store.put("b", b"y" * 8)
        assert {e["key"] for e in store.entries()} == {"b"}

    def test_first_writer_wins(self, store):
        store.put("k", b"first", {"tag": "one"})
        store.put("k", b"second", {"tag": "two"})
        payload, _ = store.get("k")
        assert payload == b"first"

    def test_default_root_env_override(self, monkeypatch, tmp_path):
        monkeypatch.setenv("MTPU_SNAPSHOT_DIR", str(tmp_path / "custom"))
        assert default_root() == tmp_path / "custom"

    def test_from_volume_shares_across_replicas(self, tmp_path):
        vol = types.SimpleNamespace(local_path=tmp_path / "vol")
        SnapshotStore.from_volume(vol).put("k", b"shared")
        payload, _ = SnapshotStore.from_volume(vol).get("k")
        assert payload == b"shared"

    def test_entries_are_read_by_the_reference_store(self, tmp_path):
        """One on-disk layout: the JAX package's store reads the port's
        entries (meta, checksum, payload), and the reverse."""
        SnapshotStore(root=tmp_path).put("from-port", b"p", {"tag": "a.M"})
        JSnapshotStore(root=tmp_path).put("from-jax", b"j", {"tag": "b.M"})
        assert JSnapshotStore(root=tmp_path).get("from-port")[0] == b"p"
        assert SnapshotStore(root=tmp_path).get("from-jax")[0] == b"j"


class TestKey:
    BASE = dict(image_digest="img1", source_hash="src1", env={"A": "1"}, cls_params=b"p")

    def test_deterministic(self):
        k1 = compute_snapshot_key(machine_tag="mt", **self.BASE)
        k2 = compute_snapshot_key(machine_tag="mt", **self.BASE)
        assert k1 == k2

    @pytest.mark.parametrize(
        "field,value",
        [("image_digest", "img2"), ("source_hash", "src2"), ("env", {"A": "2"}), ("cls_params", b"q")],
    )
    def test_every_component_changes_key(self, field, value):
        base = compute_snapshot_key(machine_tag="mt", **self.BASE)
        assert base != compute_snapshot_key(machine_tag="mt", **{**self.BASE, field: value})

    def test_machine_tag_prefix(self):
        assert compute_snapshot_key(machine_tag="cafe1234", **self.BASE).startswith("cafe1234-")

    def test_key_equals_the_reference_key(self):
        """Same inputs, same key: the port's copy of the machine tag is the
        reference's, and so is the hash."""
        from modal_examples_tpu.snapshot.store import compute_snapshot_key as jkey

        assert compute_snapshot_key(**self.BASE) == jkey(**self.BASE)

    def test_source_hash_tracks_code(self):
        class A:
            def f(self):
                return 1

        class B:
            def f(self):
                return 2

        assert source_hash_for(A) != source_hash_for(B)
        assert source_hash_for(A) == source_hash_for(A)

    def test_source_hash_falls_back_to_fn_bytes(self):
        cls = types.new_class("Synthetic")
        assert source_hash_for(cls, b"bytes1") != source_hash_for(cls, b"bytes2")

    def test_gpu_and_cpu_classes_never_share_a_key(self, monkeypatch, tmp_path):
        """The ``gpu=`` request is in the container env, hence in the key: a
        card container's entry is never a card-less container's."""
        monkeypatch.setenv("MTPU_SNAPSHOT_DIR", str(tmp_path))
        app = mtpu.App("snap-key-gpu")

        def make(gpu):
            @app.cls(gpu=gpu, enable_memory_snapshot=True)
            class Same:
                @mtpu.enter(snap=True)
                def load(self):
                    self.w = 1

                @mtpu.method()
                def m(self):
                    return self.w

            return Same._spec.container_config()

        card, plain = make("H100"), make(None)
        assert card.env["MTPU_GPU_SPEC"] == "H100:1" and "MTPU_GPU_SPEC" not in plain.env
        assert card.snapshot_key and plain.snapshot_key and card.snapshot_key != plain.snapshot_key


# --------------------------------------------------------------------------
# Codec
# --------------------------------------------------------------------------

Point = collections.namedtuple("Point", "x y")


@dataclasses.dataclass
class Holder:
    w: torch.Tensor
    n: int


class TinyModule(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 3)
        self.register_buffer("steps", torch.arange(5, dtype=torch.int64))

    def forward(self, x):
        return self.lin(x) + self.steps[:3]


def _tensor_cases():
    gen = torch.Generator().manual_seed(0)
    base = torch.randn(6, 8, generator=gen)
    return {
        "f32": base,
        "bf16": base.to(torch.bfloat16),
        "int8": torch.randint(-128, 128, (5, 7), generator=gen, dtype=torch.int8),
        "view": base.t()[2:5],  # non-contiguous
    }


class TestCodec:
    def test_plain_roundtrip(self):
        state = {"a": 1, "b": "two", "c": [1, 2, {"d": (3, 4)}]}
        payload, rebuild = codec.encode_state(state)
        assert rebuild == []
        assert codec.decode_state(payload) == state

    def test_namedtuple_roundtrip(self):
        payload, rebuild = codec.encode_state({"p": Point(1, 2)})
        assert rebuild == []
        out = codec.decode_state(payload)
        assert out["p"] == Point(1, 2)
        assert isinstance(out["p"], Point)

    @pytest.mark.parametrize("case", ["f32", "bf16", "int8", "view"])
    def test_tensor_roundtrip(self, case):
        """Each tensor comes back with its dtype, shape, device and values,
        bitwise, wherever it sits (a dict, a namedtuple, a dataclass)."""
        t = _tensor_cases()[case]
        state = {"params": {"layer": {"w": t}}, "p": Point(t, [t]), "h": Holder(t, 3)}
        payload, rebuild = codec.encode_state(state)
        assert rebuild == []
        out = codec.decode_state(payload)
        for got in (out["params"]["layer"]["w"], out["p"].x, out["p"].y[0], out["h"].w):
            assert got.dtype == t.dtype and got.shape == t.shape and got.device == t.device
            assert torch.equal(got, t)
            assert got.is_contiguous()  # a view is stored as the tensor it shows
        assert isinstance(out["h"], Holder) and out["h"].n == 3

    def test_module_parameters_and_buffers_roundtrip(self):
        m = TinyModule()
        m.lin.weight.requires_grad_(False)
        payload, rebuild = codec.encode_state({"model": m})
        assert rebuild == []
        out = codec.decode_state(payload)["model"]
        assert isinstance(out, TinyModule)
        assert isinstance(out.lin.weight, torch.nn.Parameter) and isinstance(out.lin.bias, torch.nn.Parameter)
        assert not out.lin.weight.requires_grad and out.lin.bias.requires_grad
        for (name, got), (_, want) in zip(out.state_dict().items(), m.state_dict().items()):
            assert torch.equal(got, want), name
        assert torch.equal(out(torch.ones(2, 4)), m(torch.ones(2, 4)))

    def test_no_tensor_goes_through_torchs_pickle(self):
        """A tensor's record is its host bytes and device, never torch's own
        reduction (which records the storage's device)."""
        payload = codec.encode_attr({"w": torch.ones(3)})
        assert b"_rebuild_tensor_v2" not in payload and b"torch._utils" not in payload
        assert b"_rebuild_tensor" in payload

    def test_a_cuda_tensor_never_lands_on_the_cpu(self, monkeypatch):
        """An entry whose tensor lived on a card refuses to restore where no
        card is (the restore then falls back to a cold boot)."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        buf = bytearray(torch.ones(2).numpy().tobytes())
        data = pickle.dumps(_CudaRecord(buf), protocol=pickle.HIGHEST_PROTOCOL)
        with pytest.raises(codec.CodecError, match="cuda:0"):
            codec.decode_attr(data)

    def test_unpicklable_becomes_rebuild_marker(self):
        payload, rebuild = codec.encode_state(
            {"ok": 1, "lock": threading.Lock(), "gen": (x for x in range(3))}
        )
        assert sorted(rebuild) == ["gen", "lock"]
        assert codec.decode_state(payload) == {"ok": 1}

    def test_kernel_library_handle_is_marker(self):
        """The jitted-callable case of the reference: a loaded library's
        ctypes handle (what ``ops/_build.load`` returns) and its entry points
        are only valid in their process, so they become rebuild markers."""
        lib = ctypes.CDLL(None)
        payload, rebuild = codec.encode_state({"lib": lib, "fn": lib.strlen, "kept": [1.0]})
        assert sorted(rebuild) == ["fn", "lib"]
        assert codec.decode_state(payload) == {"kept": [1.0]}

    def test_encode_attr_raises_codec_error(self):
        with pytest.raises(codec.CodecError):
            codec.encode_attr(threading.Lock())


class _CudaRecord:
    """Pickles as the codec's record of a float32 tensor on ``cuda:0``."""

    def __init__(self, buf):
        self.buf = buf

    def __reduce__(self):
        return codec._rebuild_tensor, (self.buf, "float32", (2,), "cuda:0", False, False)


# --------------------------------------------------------------------------
# build_and_enter policy (in-process)
# --------------------------------------------------------------------------

_hook_calls = {"snap": 0, "plain": 0}


class Model:
    def snap_load(self):
        _hook_calls["snap"] += 1
        self.weights = {"w": torch.tensor([1.0, 2.0], dtype=torch.bfloat16)}

    def plain_enter(self):
        _hook_calls["plain"] += 1
        self.client = object()

    def exit_hook(self):
        pass


META = {"enter": ["snap_load", "plain_enter"], "exit": ["exit_hook"], "snap_enter": ["snap_load"]}


@pytest.fixture(autouse=True)
def _reset_hook_calls():
    _hook_calls["snap"] = _hook_calls["plain"] = 0


class TestBuildAndEnter:
    def boot(self, tmp_path, key="key-1", meta=META, cls=Model, params=None, timings=None):
        return build_and_enter(cls, params or {}, meta, snapshot_key=key, snapshot_dir=str(tmp_path / "snaps"),
                               tag="t.Model", timings=timings)

    def test_miss_then_hit_skips_snap_hook(self, tmp_path):
        obj1, info1 = self.boot(tmp_path)
        assert info1 == {"snapshot": "miss", "captured": True}
        assert _hook_calls == {"snap": 1, "plain": 1}

        obj2, info2 = self.boot(tmp_path)
        assert info2["snapshot"] == "hit"
        assert info2["skipped_hooks"] == ["snap_load"]
        assert _hook_calls == {"snap": 1, "plain": 2}
        assert torch.equal(obj2.weights["w"], obj1.weights["w"]) and obj2.weights["w"].dtype == torch.bfloat16
        assert hasattr(obj2, "client")

    def test_no_key_means_off(self, tmp_path):
        _obj, info = build_and_enter(Model, {}, META, snapshot_key=None)
        assert info == {"snapshot": "off"}
        assert _hook_calls == {"snap": 1, "plain": 1}

    def test_kill_switch_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MTPU_SNAPSHOT", "0")
        _obj, info = self.boot(tmp_path)
        assert info == {"snapshot": "off"}
        assert SnapshotStore(root=tmp_path / "snaps").entries() == []

    def test_corrupted_entry_falls_back_to_cold_boot(self, tmp_path):
        self.boot(tmp_path)
        SnapshotStore(root=tmp_path / "snaps")._state_path("key-1").write_bytes(b"garbage")
        obj, info = self.boot(tmp_path)
        assert info["snapshot"] == "fallback"
        assert info["captured"]
        assert _hook_calls["snap"] == 2
        assert obj.weights["w"].tolist() == [1.0, 2.0]
        _obj, info3 = self.boot(tmp_path)
        assert info3["snapshot"] == "hit"

    def test_lifecycle_shape_change_falls_back(self, tmp_path):
        self.boot(tmp_path)

        class Model2(Model):
            def extra_snap(self):
                self.extra = True

        meta2 = {"enter": ["snap_load", "extra_snap", "plain_enter"], "exit": [],
                 "snap_enter": ["snap_load", "extra_snap"]}
        _obj, info = self.boot(tmp_path, meta=meta2, cls=Model2)
        assert info["snapshot"] == "fallback"

    def test_unpicklable_snap_attr_reruns_owning_hook(self, tmp_path):
        calls = {"n": 0}

        class Kernels:
            def load(self):
                calls["n"] += 1
                self.weights = torch.ones(2)
                self.lib = ctypes.CDLL(None)  # stands for ops/_build.load(name)

        meta = {"enter": ["load"], "exit": [], "snap_enter": ["load"]}
        _obj, info1 = self.boot(tmp_path, meta=meta, cls=Kernels)
        assert info1["captured"]
        obj2, info2 = self.boot(tmp_path, meta=meta, cls=Kernels)
        assert info2["snapshot"] == "hit"
        assert info2["rerun_hooks"] == ["load"]
        assert calls["n"] == 2
        assert isinstance(obj2.lib, ctypes.CDLL)

    def test_mutated_baseline_attr_reruns_owning_hook(self, tmp_path):
        calls = {"n": 0}

        class Placeholder:
            def __init__(self):
                self.client = None

            def load(self):
                calls["n"] += 1
                self.weights = [1.0]
                self.client = threading.Lock()

        meta = {"enter": ["load"], "exit": [], "snap_enter": ["load"]}
        _obj, info1 = self.boot(tmp_path, meta=meta, cls=Placeholder)
        assert info1["captured"]
        obj2, info2 = self.boot(tmp_path, meta=meta, cls=Placeholder)
        assert info2["snapshot"] == "hit"
        assert info2["rerun_hooks"] == ["load"]
        assert calls["n"] == 2
        assert obj2.client is not None
        assert obj2.weights == [1.0]

    def test_hit_failure_after_non_snap_side_effects_raises(self, tmp_path):
        effects = []
        flag = tmp_path / "explode"

        class Sideful:
            def load(self):
                self.w = [1.0]

            def effect(self):
                effects.append("ran")

            def boom(self):
                if flag.exists():
                    raise RuntimeError("transient failure after side effects")

        meta = {"enter": ["load", "effect", "boom"], "exit": [], "snap_enter": ["load"]}
        self.boot(tmp_path, meta=meta, cls=Sideful)
        assert effects == ["ran"]
        flag.touch()
        with pytest.raises(RuntimeError, match="transient"):
            self.boot(tmp_path, meta=meta, cls=Sideful)
        assert effects == ["ran", "ran"]
        assert not SnapshotStore(root=tmp_path / "snaps").has("key-1")

    def test_poison_snapshot_is_deleted_and_boot_goes_cold(self, tmp_path):
        class Fragile:
            def load(self):
                self.mode = getattr(self, "mode", "good")

            def check(self):
                assert self.mode == "good"

        meta = {"enter": ["load", "check"], "exit": [], "snap_enter": ["load"]}
        self.boot(tmp_path, meta=meta, cls=Fragile)
        store = SnapshotStore(root=tmp_path / "snaps")
        bad, _ = codec.encode_state({"mode": "poison"})
        store.delete("key-1")
        store.put("key-1", bad, {"hook_attrs": {"load": ["mode"]}, "rebuild": []})
        obj, info = self.boot(tmp_path, meta=meta, cls=Fragile)
        assert obj.mode == "good"
        assert info["captured"]

    def test_params_applied_before_hooks(self, tmp_path):
        class P:
            def load(self):
                self.doubled = self.base * 2

        meta = {"enter": ["load"], "exit": [], "snap_enter": ["load"]}
        obj, _ = self.boot(tmp_path, meta=meta, cls=P, params={"base": 21})
        assert obj.doubled == 42

    def test_an_entry_from_a_card_falls_back_on_the_cpu(self, tmp_path, monkeypatch):
        """A restore never puts a card's tensor on the CPU: the boot goes
        cold, runs the snap hook and captures its own entry."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        self.boot(tmp_path)
        store = SnapshotStore(root=tmp_path / "snaps")
        on_card = pickle.dumps({"weights": pickle.dumps({"w": _CudaRecord(bytearray(8))}, protocol=5)}, protocol=5)
        store.delete("key-1")
        store.put("key-1", on_card, {"hook_attrs": {"snap_load": ["weights"]}, "rebuild": []})
        obj, info = self.boot(tmp_path)
        assert info["snapshot"] == "fallback" and info["captured"]
        assert _hook_calls["snap"] == 2 and obj.weights["w"].device.type == "cpu"

    def test_timings_split_the_boot(self, tmp_path):
        t1, t2 = {}, {}
        self.boot(tmp_path, timings=t1)
        self.boot(tmp_path, timings=t2)
        assert set(t1) == {"restore", "snap_hooks", "capture", "enter_hooks"}
        assert set(t2) == {"restore", "enter_hooks"}  # the hit ran no snap hook
        assert all(v >= 0 for v in [*t1.values(), *t2.values()])


class _Both:
    """One lifecycle through either package's build_and_enter."""

    calls = {"snap": 0, "plain": 0}

    def load(self):
        _Both.calls["snap"] += 1
        self.table = {"rows": [[1, 2], [3, 4]], "name": "t"}

    def ready(self):
        _Both.calls["plain"] += 1
        self.lock = threading.Lock()


def test_boot_outcomes_equal_the_references(tmp_path, monkeypatch):
    """off, miss, hit, a corrupt payload's fallback (and its recapture), a
    hit again, and the kill switch: the same boot infos and hook counts
    through both packages."""
    meta = {"enter": ["load", "ready"], "exit": [], "snap_enter": ["load"]}

    def sequence(build, store_cls, root):
        out = []
        _Both.calls.update(snap=0, plain=0)

        def boot(key="k"):
            _obj, info = build(_Both, {}, meta, snapshot_key=key, snapshot_dir=str(root), tag="a.Both")
            out.append((info, dict(_Both.calls)))

        boot(key=None)
        boot()
        boot()
        store_cls(root=root)._state_path("k").write_bytes(b"garbage")
        boot()
        boot()
        monkeypatch.setenv("MTPU_SNAPSHOT", "off")
        boot()
        monkeypatch.delenv("MTPU_SNAPSHOT")
        return out

    port = sequence(build_and_enter, SnapshotStore, tmp_path / "port")
    ref = sequence(jbuild_and_enter, JSnapshotStore, tmp_path / "jax")
    assert port == ref
    assert [i["snapshot"] for i, _ in port] == ["off", "miss", "hit", "fallback", "hit", "off"]
    assert [i.get("captured") for i, _ in port] == [None, True, False, True, False, None]


# --------------------------------------------------------------------------
# FunctionSpec / ContainerConfig plumbing
# --------------------------------------------------------------------------


class TestSpecPlumbing:
    def test_function_kwarg_reaches_spec(self):
        app = mtpu.App("snap-plumb-fn")

        @app.function(enable_memory_snapshot=True, serialized=True, experimental_options={"x": 1})
        def f():
            return 1

        assert f.spec.enable_memory_snapshot is True
        assert f.spec.serialized is True
        assert f.spec.experimental_options == {"x": 1}

    def test_cls_kwarg_reaches_spec(self):
        app = mtpu.App("snap-plumb-cls")

        @app.cls(enable_memory_snapshot=True, experimental_options={"y": 2})
        class C:
            @mtpu.method()
            def m(self):
                return 1

        assert C._spec.enable_memory_snapshot is True
        assert C._spec.experimental_options == {"y": 2}

    def test_default_is_off(self):
        app = mtpu.App("snap-plumb-default")

        @app.cls()
        class C:
            @mtpu.method()
            def m(self):
                return 1

        assert C._spec.enable_memory_snapshot is False
        assert C._spec.container_config().snapshot_key is None

    def test_cls_container_config_resolves_key(self, monkeypatch, tmp_path):
        monkeypatch.setenv("MTPU_SNAPSHOT_DIR", str(tmp_path))
        app = mtpu.App("snap-plumb-key")

        @app.cls(enable_memory_snapshot=True)
        class C:
            @mtpu.enter(snap=True)
            def load(self):
                self.ready = True

            @mtpu.method()
            def m(self):
                return 1

        cfg = C._spec.container_config()
        assert cfg.snapshot_key is not None
        assert cfg.snapshot_dir == str(tmp_path)
        assert C._spec.container_config().snapshot_key == cfg.snapshot_key

    def test_plain_function_gets_no_key(self):
        app = mtpu.App("snap-plumb-plainfn")

        @app.function(enable_memory_snapshot=True)
        def f():
            return 1

        assert f.spec.container_config().snapshot_key is None

    def test_snap_enter_meta_collected(self):
        class C:
            @mtpu.enter(snap=True)
            def a(self):
                pass

            @mtpu.enter()
            def b(self):
                pass

        from modal_examples_tpu_torch.core.cls import _collect_lifecycle

        meta = _collect_lifecycle(C)
        assert meta["snap_enter"] == ["a"]
        assert meta["enter"][0] == "a"


# --------------------------------------------------------------------------
# Autoscaler first-warm-boot gate
# --------------------------------------------------------------------------


class TestSnapshotGate:
    def _fake_pool(self, tmp_path, key="gate-key"):
        cfg = types.SimpleNamespace(snapshot_key=key, snapshot_dir=str(tmp_path))
        return types.SimpleNamespace(_snapshot_gate=bool(key), container_config=cfg, containers=[])

    def test_gate_holds_until_entry_or_warm_boot(self, tmp_path):
        pool = self._fake_pool(tmp_path)
        assert FunctionPool._snapshot_pending_first_capture(pool)
        assert FunctionPool._snapshot_pending_first_capture(pool)

    def test_gate_opens_when_store_has_entry(self, tmp_path):
        pool = self._fake_pool(tmp_path)
        SnapshotStore(root=tmp_path).put("gate-key", b"x")
        assert not FunctionPool._snapshot_pending_first_capture(pool)
        assert not pool._snapshot_gate

    def test_gate_opens_after_first_warm_boot_without_capture(self, tmp_path):
        pool = self._fake_pool(tmp_path)
        pool.containers = [types.SimpleNamespace(ever_ready=True)]
        assert not FunctionPool._snapshot_pending_first_capture(pool)
        assert not pool._snapshot_gate

    def test_no_key_no_gate(self, tmp_path):
        pool = self._fake_pool(tmp_path, key=None)
        assert not FunctionPool._snapshot_pending_first_capture(pool)


# --------------------------------------------------------------------------
# Metrics
# --------------------------------------------------------------------------


class TestMetrics:
    def test_record_and_expose(self):
        reg = Registry()
        record_snapshot_boot("a.M", "miss", captured=True, registry=reg)
        record_snapshot_boot("a.M", "hit", registry=reg)
        record_snapshot_boot("a.M", "hit", registry=reg)
        assert reg.value(SNAPSHOT_BOOTS_METRIC, {"function": "a.M", "result": "hit"}) == 2
        assert reg.value(SNAPSHOT_BOOTS_METRIC, {"function": "a.M", "result": "miss"}) == 1
        assert reg.value(SNAPSHOT_CAPTURES_METRIC, {"function": "a.M"}) == 1
        text = reg.expose()
        assert "mtpu_snapshot_boots_total" in text
        assert 'result="hit"' in text
        assert "# TYPE mtpu_snapshot_boots_total counter" in text

    def test_unwritten_series_reads_zero(self):
        assert Registry().value(SNAPSHOT_BOOTS_METRIC, {"function": "x", "result": "hit"}) == 0.0

    def test_store_gauges_follow_the_store(self, tmp_path):
        from modal_examples_tpu_torch.observability import catalog as C

        store = SnapshotStore(root=tmp_path)
        store.put("a", b"12345")
        store.put("b", b"678")
        assert default_registry.value(C.SNAPSHOT_STORE_ENTRIES) == 2
        assert default_registry.value(C.SNAPSHOT_STORE_BYTES) == 8
        hits = default_registry.value(C.SNAPSHOT_STORE_GETS_TOTAL, {"result": "hit"})
        store.get("a")
        assert default_registry.value(C.SNAPSHOT_STORE_GETS_TOTAL, {"result": "hit"}) == hits + 1


# --------------------------------------------------------------------------
# End-to-end: process backend, second boot restores
# --------------------------------------------------------------------------

E2E = '''
import os

import torch

import modal_examples_tpu_torch as mtpu

app = mtpu.App("snapshot-e2e")


@app.cls(timeout=60, enable_memory_snapshot=True)
class SnapService:
    counter_file: str = mtpu.parameter(default="")

    @mtpu.enter(snap=True)
    def load(self):
        with open(self.counter_file, "a") as f:
            f.write("x")
        self.weights = {"w": torch.tensor([3.0, 4.0], dtype=torch.bfloat16)}

    @mtpu.method()
    def norm(self) -> float:
        return float(torch.linalg.vector_norm(self.weights["w"].float()))

    @mtpu.method()
    def boots(self) -> int:
        return os.path.getsize(self.counter_file)

    @mtpu.method()
    def boot(self) -> dict:
        from modal_examples_tpu_torch.core.executor import boot_info

        return boot_info()
'''


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    path = tmp_path_factory.mktemp("snap-e2e") / "snapshot_e2e_app.py"
    path.write_text(E2E)
    return load_module_from_path(str(path))


def _boot_counts(tag):
    return {r: default_registry.value(SNAPSHOT_BOOTS_METRIC, {"function": tag, "result": r})
            for r in ("hit", "miss", "fallback")}


class TestEndToEnd:
    TAG = "snapshot-e2e.SnapService"

    def test_second_container_boot_restores(self, e2e, tmp_path, monkeypatch):
        monkeypatch.setenv("MTPU_SNAPSHOT_DIR", str(tmp_path / "snaps"))
        counter = tmp_path / "enter-count"
        counter.touch()
        before = _boot_counts(self.TAG)

        with e2e.app.run():
            svc = e2e.SnapService(counter_file=str(counter))
            assert svc.norm.remote() == 5.0
            first = svc.boot.remote()
        assert counter.read_text() == "x"

        with e2e.app.run():
            svc = e2e.SnapService(counter_file=str(counter))
            assert svc.norm.remote() == 5.0
            assert svc.boots.remote() == 1
            second = svc.boot.remote()
        assert counter.read_text() == "x"  # the snap hook never re-ran

        after = _boot_counts(self.TAG)
        assert after["miss"] == before["miss"] + 1
        assert after["hit"] == before["hit"] + 1
        assert "mtpu_snapshot_boots_total" in default_registry.expose()
        assert (first["snapshot"], first["captured"], second["snapshot"]) == ("miss", True, "hit")
        assert {"interpreter", "handshake", "app_file", "restore", "snap_hooks", "capture"} <= set(first["boot_s"])
        assert "snap_hooks" not in second["boot_s"] and "restore" in second["boot_s"]

        entries = SnapshotStore(root=tmp_path / "snaps").entries()
        assert len(entries) == 1
        assert entries[0]["manifest"]["tag"] == self.TAG
        assert entries[0]["manifest"]["hook_attrs"] == {"load": ["weights"]}
        assert entries[0]["manifest"]["torch"] == torch.__version__

    def test_corrupt_store_still_boots(self, e2e, tmp_path, monkeypatch):
        monkeypatch.setenv("MTPU_SNAPSHOT_DIR", str(tmp_path / "snaps"))
        counter = tmp_path / "enter-count"
        counter.touch()

        with e2e.app.run():
            assert e2e.SnapService(counter_file=str(counter)).norm.remote() == 5.0

        store = SnapshotStore(root=tmp_path / "snaps")
        [entry] = store.entries()
        store._state_path(entry["key"]).write_bytes(b"garbage")
        before = _boot_counts(self.TAG)

        with e2e.app.run():
            assert e2e.SnapService(counter_file=str(counter)).norm.remote() == 5.0
        assert counter.read_text() == "xx"
        assert _boot_counts(self.TAG)["fallback"] == before["fallback"] + 1


# --------------------------------------------------------------------------
# Example smoke: the snapshot example's Embedder, on the port's bge shape
# --------------------------------------------------------------------------

EMBEDDER = '''
import modal_examples_tpu_torch as mtpu

app = mtpu.App("example-gpu-snapshot")


@app.cls(enable_memory_snapshot=True, timeout=600)
class Embedder:
    @mtpu.enter(snap=True)
    def load(self):
        """Pure state (config + weights): a restored boot skips this hook."""
        from modal_examples_tpu_torch.models import bert

        self.cfg = bert.BertConfig.tiny()
        self.params = bert.init_params(self.cfg, seed=0, device="cpu")

    @mtpu.enter()
    def warmup(self):
        """Runs on every boot."""
        import torch

        from modal_examples_tpu_torch.models import bert

        self._embed = lambda t: bert.embed(self.params, t, None, self.cfg)
        self._embed(torch.zeros((4, 32), dtype=torch.int64))

    @mtpu.method()
    def embed(self, texts: list) -> dict:
        import torch

        ids = torch.zeros((4, 32), dtype=torch.int64)
        for i, t in enumerate(texts[:4]):
            enc = list(t.encode())[:32]
            ids[i, : len(enc)] = torch.tensor(enc)
        out = self._embed(ids)
        return {"dim": int(out.shape[1]), "sum": float(out.float().sum())}
'''


class TestExampleSmoke:
    def test_embedder_second_boot_is_snapshot_hit(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MTPU_SNAPSHOT_DIR", str(tmp_path / "snaps"))
        path = tmp_path / "gpu_snapshot_app.py"
        path.write_text(EMBEDDER)
        module = load_module_from_path(str(path))
        tag = "example-gpu-snapshot.Embedder"
        before = _boot_counts(tag)

        with module.app.run():
            r1 = module.Embedder().embed.remote(["first boot"])
        mid = _boot_counts(tag)
        assert mid["miss"] == before["miss"] + 1

        with module.app.run():
            r2 = module.Embedder().embed.remote(["first boot"])
        assert _boot_counts(tag)["hit"] == mid["hit"] + 1
        assert r1 == r2 and r1["dim"] > 0  # the restored weights are the drawn ones

        [entry] = SnapshotStore(root=tmp_path / "snaps").entries()
        assert entry["manifest"]["hook_attrs"] == {"load": ["cfg", "params"]}
        assert entry["manifest"]["rebuild"] == []


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


class TestCli:
    def test_list_inspect_clear(self, tmp_path, capsys):
        from modal_examples_tpu_torch.core.cli import cmd_snapshot

        store = SnapshotStore(root=tmp_path)
        store.put("key-a", b"123", {"tag": "app.M"})

        assert cmd_snapshot(["list", "--dir", str(tmp_path)]) == 0
        out = capsys.readouterr().out
        assert "key-a" in out and "app.M" in out

        assert cmd_snapshot(["inspect", "key-a", "--dir", str(tmp_path)]) == 0
        meta = json.loads(capsys.readouterr().out)
        assert meta["key"] == "key-a"
        assert meta["manifest"]["tag"] == "app.M"

        assert cmd_snapshot(["clear", "--dir", str(tmp_path)]) == 0
        assert store.entries() == []
        assert cmd_snapshot(["list", "--dir", str(tmp_path)]) == 0
        assert "no snapshots" in capsys.readouterr().out

    def test_clear_single_key(self, tmp_path):
        from modal_examples_tpu_torch.core.cli import cmd_snapshot

        store = SnapshotStore(root=tmp_path)
        store.put("key-a", b"1")
        store.put("key-b", b"2")
        assert cmd_snapshot(["clear", "key-a", "--dir", str(tmp_path)]) == 0
        assert {e["key"] for e in store.entries()} == {"key-b"}
        assert cmd_snapshot(["clear", "key-a", "--dir", str(tmp_path)]) == 1

    def test_inspect_missing_key_errors(self, tmp_path):
        from modal_examples_tpu_torch.core.cli import cmd_snapshot

        with pytest.raises(SystemExit):
            cmd_snapshot(["inspect", "nope", "--dir", str(tmp_path)])

    def test_dir_flag_requires_value(self):
        from modal_examples_tpu_torch.core.cli import cmd_snapshot

        with pytest.raises(SystemExit, match="usage"):
            cmd_snapshot(["list", "--dir"])

    def test_output_equals_the_references(self, tmp_path, capsys):
        """``list`` (past its age columns), ``inspect`` and ``clear`` print
        what the reference's ``tpurun snapshot`` prints over one store."""
        from modal_examples_tpu.core.cli import cmd_snapshot as jcmd
        from modal_examples_tpu_torch.core.cli import cmd_snapshot as pcmd

        def outputs(cmd, root):
            SnapshotStore(root=root).put("key-a", b"123", {"tag": "app.M"})
            got = []
            for argv in (["list"], ["inspect", "key-a"], ["clear", "key-a"], ["clear"], ["list"]):
                cmd([*argv, "--dir", str(root)])
                got.append(capsys.readouterr().out.replace(str(root), "ROOT"))
            got[0] = [line.split()[0::4] for line in got[0].splitlines()]  # key and function columns
            meta = json.loads(got[1])
            got[1] = (meta["key"], meta["size_bytes"], meta["manifest"])
            return got

        assert outputs(pcmd, tmp_path / "p") == outputs(jcmd, tmp_path / "j")
