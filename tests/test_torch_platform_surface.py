"""The port's platform surface beside the JAX package's: serialization, images,
volumes, secrets, schedules and deploy/lookup held against the reference
(mirrors ``tests/test_primitives.py`` and ``tests/test_deploy.py``), and the
port's own parts: the ``gpu=`` grammar, ``tpu=`` refused, containers without
a card, a ``gpu=`` boot on a card-less host, the gateway's 501 routes, the
CLI, and callables by reference with ``cloudpickle`` hidden. Tests marked
``gpu`` run a ``gpu="H100"`` function on the card and skip elsewhere.
"""

import datetime as dt
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import modal_examples_tpu as jm
import modal_examples_tpu_torch as pm
from modal_examples_tpu.core import app as japp
from modal_examples_tpu.core import serialization as jser
from modal_examples_tpu_torch.core import app as papp
from modal_examples_tpu_torch.core import serialization as pser
from modal_examples_tpu_torch.core.resources import (
    GPUSpec,
    InvalidGPUSpec,
    parse_gpu_request,
    parse_gpu_spec,
    select_gpu_spec,
)

ROOT = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"


def run_cli(pkg: str, *args, env=None, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", pkg, *map(str, args)], capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})},
    )


def test_the_platform_layer_imports_no_torch():
    """A container of a function without ``gpu=`` boots without torch."""
    code = ("import sys, modal_examples_tpu_torch, modal_examples_tpu_torch.core.executor, "
            "modal_examples_tpu_torch.core.cli, modal_examples_tpu_torch.web.gateway; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr


# -- serialization --------------------------------------------------------------


class Unrestorable(Exception):
    def __init__(self, msg, code):
        super().__init__(msg)
        self.code = code


VALUES = [0, -7, 3.5, "text", b"bytes", None, True, [1, [2, 3]], (1, "a"), {"k": [1, 2], "n": None},
          {"nested": {"deep": (1.0, 2.0)}}, list(range(100))]


@pytest.mark.parametrize("value", VALUES, ids=lambda v: type(v).__name__)
def test_serialize_round_trips_as_the_reference(value):
    assert pser.serialize(value) == jser.serialize(value)
    assert pser.deserialize(pser.serialize(value)) == value


@pytest.mark.parametrize("exc", [ValueError("boom"), KeyError("k"), RuntimeError("x", 2)],
                         ids=lambda e: type(e).__name__)
def test_serialize_exception_as_the_reference(exc):
    assert pser.serialize_exception(exc) == jser.serialize_exception(exc)
    got, tb = pser.deserialize_exception(pser.serialize_exception(exc))
    assert type(got) is type(exc) and got.args == exc.args and tb == f"{type(exc).__name__}: {exc}\n"


def test_an_exception_that_does_not_unpickle_becomes_a_remote_error():
    j, jtb = jser.deserialize_exception(jser.serialize_exception(Unrestorable("odd", 2)))
    p, ptb = pser.deserialize_exception(pser.serialize_exception(Unrestorable("odd", 2)))
    assert type(j).__name__ == type(p).__name__ == "RemoteError" and isinstance(p, pser.RemoteError)
    assert j.args == p.args and j.remote_traceback == p.remote_traceback == jtb == ptb


MODULE = '''
import modal_examples_tpu_torch as mtpu

app = mtpu.App("by-reference")


def helper(x):
    return x + 1


@app.function()
def plus_one(x):
    return helper(x)


@app.cls()
class Model:
    scale: int = mtpu.parameter(default=2)

    @mtpu.method()
    def run(self, x):
        return self.scale * x
'''


@pytest.fixture()
def by_reference_module(tmp_path):
    path = tmp_path / "by_reference_app.py"
    path.write_text(MODULE)
    yield papp.load_module_from_path(str(path))
    sys.modules.pop("by_reference_app", None)


def test_module_level_callables_go_by_reference_without_cloudpickle(by_reference_module, monkeypatch):
    mod = by_reference_module
    monkeypatch.setitem(sys.modules, "cloudpickle", None)  # import cloudpickle now raises
    fn = pser.function_from_bytes(pser.function_to_bytes(mod.plus_one.raw_f))
    assert fn is mod.plus_one.raw_f and fn(1) == 2
    cls, meta = pser.function_from_bytes(pser.function_to_bytes(mod.Model._spec.raw_target))
    assert cls is mod.Model.user_cls and meta["methods"] == mod.Model._meta["methods"]


def test_a_closure_needs_cloudpickle_and_names_it(monkeypatch):
    k = 3
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    with pytest.raises(pser.SerializationError, match="cloudpickle"):
        pser.function_to_bytes(lambda x: x + k)


def test_a_closure_goes_by_value_with_cloudpickle():
    k = 3
    assert pser.function_from_bytes(pser.function_to_bytes(lambda x: x + k))(1) == 4


def test_a_module_is_imported_by_path_where_its_name_is_not_importable(by_reference_module):
    data = pser.function_to_bytes(by_reference_module.plus_one.raw_f)
    sys.modules.pop("by_reference_app")
    sys.path.remove(str(Path(by_reference_module.__file__).parent))
    fn = pser.function_from_bytes(data)  # found through the file path the reference carries
    assert fn(41) == 42 and fn.__module__ == "by_reference_app"


# -- resources ------------------------------------------------------------------


class TestGPUSpec:
    @pytest.mark.parametrize("text,kind,count", [("H100", "H100", 1), ("h100", "H100", 1), ("H100:2", "H100", 2),
                                                 ("any", "ANY", 1), ("any:4", "ANY", 4), (" H100:8 ", "H100", 8)])
    def test_parse(self, text, kind, count):
        assert parse_gpu_spec(text) == GPUSpec(kind, count)

    @pytest.mark.parametrize("text", ["", "H100:", "H100:0", "H100-2", "A100", "v5e-8", "H100:x", "nvidia h100"])
    def test_invalid(self, text):
        with pytest.raises(InvalidGPUSpec):
            parse_gpu_spec(text)

    def test_fallback_list(self):
        assert parse_gpu_request(["h100", "any"]) == [GPUSpec("H100", 1), GPUSpec("ANY", 1)]
        assert parse_gpu_request(None) == []
        with pytest.raises(InvalidGPUSpec):
            parse_gpu_request([])

    def test_figures_come_from_the_usage_table(self):
        from modal_examples_tpu_torch.observability.usage import GPU_PEAKS

        s = parse_gpu_spec("H100:2")
        assert s.device_name == H100 and s.memory_gb == 80
        assert (s.bf16_tflops_per_card, s.hbm_gbps_per_card) == GPU_PEAKS[H100]
        assert parse_gpu_spec("any").device_name is None and parse_gpu_spec("any").memory_gb is None

    def test_select(self):
        assert select_gpu_spec("H100:1", [H100]) == GPUSpec("H100", 1)
        assert select_gpu_spec("H100:2,ANY:1", [H100]) == GPUSpec("ANY", 1)
        for request, cards in (("H100:2", [H100]), ("H100:1", []), ("H100:1", ["NVIDIA A100-SXM4-80GB"])):
            with pytest.raises(RuntimeError, match=request):
                select_gpu_spec(request, cards)


class TestOptions:
    def test_tpu_raises_naming_gpu(self):
        app = pm.App("tpu-refused")
        with pytest.raises(ValueError, match="gpu="):
            app.function(tpu="v5e-8")
        with pytest.raises(ValueError, match="gpu="):
            app.cls(tpu="v5e-1")

        @app.cls()
        class C:
            @pm.method()
            def f(self):
                return 1

        with pytest.raises(ValueError, match="gpu="):
            C.with_options(tpu="v5e-8")

    @pytest.mark.parametrize("option,item", [("enable_memory_snapshot", "snapshot"), ("region", "A9")])
    def test_waiting_options_name_their_roadmap_item(self, option, item):
        app = pm.App("waiting-options")
        value = True if option == "enable_memory_snapshot" else "us-east"
        with pytest.raises(NotImplementedError, match=item):
            app.function(**{option: value})
        with pytest.raises(NotImplementedError, match=item):
            app.cls(**{option: value})

    def test_cluster_size_names_a10(self):
        app = pm.App("waiting-cluster")

        @app.cls()
        class C:
            @pm.method()
            def f(self):
                return 1

        with pytest.raises(NotImplementedError, match="A10"):
            C.with_options(cluster_size=2)

    def test_gpu_spec_reaches_the_container_env(self):
        app = pm.App("gpu-env")

        @app.function(gpu=["H100:2", "any"])
        def f():
            return 1

        assert f.spec.container_config().env["MTPU_GPU_SPEC"] == "H100:2,ANY:1"

    def test_waiting_pieces_name_their_roadmap_items(self):
        with pytest.raises(NotImplementedError, match="A13"):
            pm.websocket_endpoint()
        with pytest.raises(NotImplementedError, match="A13"):
            pm.Image.debian_slim().export_oci("/nonexistent")
        out = run_cli("modal_examples_tpu_torch", "chaos")
        assert out.returncode != 0 and "A9" in out.stderr


# -- containers -----------------------------------------------------------------

CONTAINERS = '''
import os

import modal_examples_tpu_torch as mtpu

app = mtpu.App("containers")


@app.function(timeout=60)
def visible_devices():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


@app.function(timeout=60, gpu="H100")
def on_card():
    return "ran"


@app.local_entrypoint()
def main(n: int = 3):
    print("RESULT", visible_devices.remote(), n)
'''


@pytest.fixture(scope="module")
def containers_app(tmp_path_factory):
    path = tmp_path_factory.mktemp("containers") / "containers_app.py"
    path.write_text(CONTAINERS)
    return path, papp.load_module_from_path(str(path))


def test_a_container_without_gpu_sees_no_card(containers_app):
    _, mod = containers_app
    with mod.app.run():
        assert mod.visible_devices.remote() == ""


def test_a_gpu_container_fails_its_boot_on_a_host_without_the_card(containers_app):
    import torch

    _, mod = containers_app
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the gpu-marked test covers it")
    with mod.app.run():
        with pytest.raises(RuntimeError, match="H100:1"):
            mod.on_card.remote()


def test_run_cli_on_a_file(containers_app, tmp_path):
    path, _ = containers_app
    out = run_cli("modal_examples_tpu_torch", "run", path, "--n", "5",
                  env={"MTPU_STATE_DIR": str(tmp_path / "state")})
    assert out.returncode == 0, out.stderr
    assert "RESULT  5" in out.stdout  # the container's CUDA_VISIBLE_DEVICES is ""


# -- deploy ---------------------------------------------------------------------

DEPLOYABLE = '''
import @PKG@ as mtpu

app = mtpu.App("deployed-cross-process")


@app.function(timeout=60)
def triple(x: int) -> int:
    return x * 3
'''

LOOKUP = '''
import @PKG@ as mtpu

f = mtpu.Function.from_name("deployed-cross-process", "triple")
print("RESULT", f.remote(14))
'''


@pytest.mark.parametrize("pkg", ["modal_examples_tpu", "modal_examples_tpu_torch"])
def test_deploy_then_lookup_cross_process(pkg, tmp_path):
    state = tmp_path / "state"
    app_file = tmp_path / "deployable_app.py"
    app_file.write_text(DEPLOYABLE.replace("@PKG@", pkg))
    env = {"MTPU_STATE_DIR": str(state)}
    out = run_cli(pkg, "deploy", "--no-scheduler", app_file, env=env)
    assert out.returncode == 0, out.stderr
    assert "deployed-cross-process" in json.loads((state / "apps.json").read_text())
    out = subprocess.run([sys.executable, "-c", LOOKUP.replace("@PKG@", pkg)], capture_output=True, text=True,
                         timeout=180, env={**os.environ, "PYTHONPATH": str(ROOT), **env})
    assert out.returncode == 0, out.stderr
    assert "RESULT 42" in out.stdout


# -- gateway --------------------------------------------------------------------


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_gateway_serves_what_the_port_has_and_501_for_the_rest():
    from modal_examples_tpu_torch.web.gateway import BUILTIN_ROUTES, WAITING_ROUTES, Gateway

    app = pm.App("gateway-routes")

    @app.function()
    @pm.fastapi_endpoint()
    def hello(name: str = "x"):
        return {"hi": name}

    with app.run():
        gw = Gateway(app, port=0).start()
        try:
            assert get(f"{gw.base_url}/hello?name=y") == (200, json.dumps({"hi": "y"}))
            for label in BUILTIN_ROUTES:
                status, body = get(f"{gw.base_url}/{label}")
                if label in WAITING_ROUTES:
                    item = "A6" if label in ("healthz", "alerts", "incidents", "canary") else "A9"
                    assert status == 501 and item in json.loads(body)["error"], label
                else:
                    assert status == 200, label
            status, body = get(f"{gw.base_url}/")
            assert status == 200 and set(json.loads(body)["routes"]) == {f"/{k}" for k in BUILTIN_ROUTES}
            assert get(f"{gw.base_url}/traces/no-such-trace")[0] == 404
        finally:
            gw.stop()


WEB_PROGRAM = '''
import @PKG@ as mtpu

app = mtpu.App("web-parity")


@app.function(timeout=30)
@mtpu.fastapi_endpoint()
def greet(name: str = "x", times: int = 1):
    return {"hi": name * times}


@app.function(timeout=30)
@mtpu.fastapi_endpoint(method="POST", label="sum")
def add(a: int, b: int):
    return {"sum": a + b}


@app.function(timeout=30)
@mtpu.fastapi_endpoint()
def ticks(n: int = 3):
    for i in range(n):
        yield {"tick": i}


@app.function(timeout=30)
@mtpu.fastapi_endpoint()
def broken():
    raise ValueError("no")


@app.function()
@mtpu.wsgi_app()
def flask_like():
    def wsgi(environ, start_response):
        start_response("200 OK", [("content-type", "text/plain")])
        return [f"{environ['REQUEST_METHOD']} {environ['PATH_INFO']}".encode()]

    return wsgi
'''


def request(url, body=None):
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("content-type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("content-type"), e.read().decode()


def test_gateway_endpoints_answer_as_the_reference(tmp_path):
    """The endpoint front (query coercion, POST bodies, SSE, errors, a WSGI
    app) through both packages' gateways: the same answers."""
    from modal_examples_tpu.web.gateway import Gateway as JGateway
    from modal_examples_tpu_torch.web.gateway import Gateway as PGateway

    paths = ["/greet?name=ab&times=2", "/greet", "/ticks?n=2", "/broken", "/flask_like/deep/path", "/nowhere"]
    answers = []
    for pkg, loader, gateway in (("modal_examples_tpu", japp, JGateway), ("modal_examples_tpu_torch", papp, PGateway)):
        path = tmp_path / f"web_{pkg}_app.py"
        path.write_text(WEB_PROGRAM.replace("@PKG@", pkg))
        mod = loader.load_module_from_path(str(path))
        with mod.app.run():
            gw = gateway(mod.app, port=0).start()
            try:
                got = [request(gw.base_url + q) for q in paths]
                got.append(request(gw.base_url + "/sum", {"a": 2, "b": 40}))
                got.append(request(gw.base_url + "/greet", {"name": "post"}))  # GET-only: 405
            finally:
                gw.stop()
        answers.append(got)
    assert answers[0] == answers[1]
    got = answers[1]
    assert got[0] == (200, "application/json", json.dumps({"hi": "abab"}))
    assert got[2][0] == 200 and got[2][1] == "text/event-stream"
    assert got[2][2] == 'data: {"tick": 0}\n\ndata: {"tick": 1}\n\n'
    assert got[3][0] == 500 and "ValueError: no" in got[3][2]
    assert got[4] == (200, "text/plain", "GET /deep/path")
    assert got[5][0] == 404 and got[6] == (200, "application/json", json.dumps({"sum": 42}))
    assert got[7][0] == 405


SERVED = '''
import modal_examples_tpu_torch as mtpu

app = mtpu.App("served")


@app.function(timeout=30)
@mtpu.fastapi_endpoint()
def echo(text: str = ""):
    return {"echo": text}
'''


def test_serve_cli_hosts_the_endpoints(tmp_path):
    path = tmp_path / "served_app.py"
    path.write_text(SERVED)
    proc = subprocess.Popen(
        [sys.executable, "-m", "modal_examples_tpu_torch", "serve", str(path), "--timeout", "60"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT), "MTPU_STATE_DIR": str(tmp_path / "state")},
    )
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("serving: http://127.0.0.1:") and line.endswith("/echo"), line
        assert request(line[len("serving: "):] + "?text=hi")[::2] == (200, json.dumps({"echo": "hi"}))
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_app_and_secret_cli(tmp_path):
    env = {"MTPU_STATE_DIR": str(tmp_path / "state")}
    out = run_cli("modal_examples_tpu_torch", "secret", "create", "cli-secret", "A=1", "B=2", env=env)
    assert out.returncode == 0 and "['A', 'B']" in out.stdout
    assert json.loads((tmp_path / "state" / "secrets" / "cli-secret.json").read_text()) == {"A": "1", "B": "2"}
    path = tmp_path / "listed_app.py"
    path.write_text(SERVED)
    assert run_cli("modal_examples_tpu_torch", "deploy", "--no-scheduler", path, env=env).returncode == 0
    out = run_cli("modal_examples_tpu_torch", "app", "list", env=env)
    assert out.returncode == 0 and out.stdout.split("\t")[0] == "served"


# -- storage, schedules, images -------------------------------------------------


@pytest.mark.parametrize("pkg", [jm, pm], ids=["jax", "port"])
def test_volume_commit_reload_and_escape(pkg):
    name = f"parity-vol-{pkg.__name__}"
    vol = pkg.Volume.from_name(name, create_if_missing=True)
    vol.write_file("weights/model.bin", b"abc")
    v0 = vol.version
    vol.commit()
    again = pkg.Volume.from_name(name)
    again.reload()
    assert (vol.version, again.read_file("weights/model.bin")) == (v0 + 1, b"abc")
    assert list(again.listdir("/", recursive=True)) == ["weights/model.bin"]
    with pytest.raises(PermissionError):
        again.read_file("../../etc/passwd")
    with pytest.raises(KeyError):
        pkg.Volume.from_name(f"never-created-{pkg.__name__}")


@pytest.mark.parametrize("pkg", [jm, pm], ids=["jax", "port"])
def test_secret(pkg):
    name = f"parity-secret-{pkg.__name__}"
    pkg.Secret.create(name, {"HF_TOKEN": "tok"})
    assert pkg.Secret.from_name(name, required_keys=["HF_TOKEN"]).env_vars() == {"HF_TOKEN": "tok"}
    with pytest.raises(KeyError):
        pkg.Secret.from_name(name, required_keys=["MISSING"])
    with pytest.raises(KeyError):
        pkg.Secret.from_name(f"never-{name}")


@pytest.mark.parametrize("schedule", [("cron", "* * * * *"), ("cron", "0 9 * * *"), ("cron", "*/15 8-17 * * 1-5"),
                                      ("cron", "30 4 1 */2 *"), ("period", 90), ("period", 86400 * 1.5)],
                         ids=lambda s: f"{s[0]}-{s[1]}")
def test_schedules_fire_as_the_reference(schedule):
    kind, arg = schedule

    def make(pkg):
        return pkg.Cron(arg) if kind == "cron" else pkg.Period(seconds=arg)

    t = dt.datetime(2026, 2, 27, 23, 58, 30)
    for _ in range(4):
        nj, np_ = make(jm).next_fire(t), make(pm).next_fire(t)
        assert nj == np_
        t = np_


def test_image_digest_of_the_same_chain():
    def chain(pkg, base):
        return base.uv_pip_install("numpy", "einops").apt_install("ffmpeg").env({"A": "1"}).workdir("/w")

    j, p = chain(jm, jm.Image.debian_slim()), chain(pm, pm.Image.debian_slim())
    assert j.digest() == p.digest() and j.env_vars() == p.env_vars()
    jt, pc = chain(jm, jm.Image.tpu_base()), chain(pm, pm.Image.cuda_base())
    cut_j, cut_p = len(jm.Image.tpu_base().layers), len(pm.Image.cuda_base().layers)
    assert jm.Image(jt.layers[cut_j:]).digest() == pm.Image(pc.layers[cut_p:]).digest()
    assert jt.digest() != pc.digest()


def test_cuda_base_has_torch_and_no_jax():
    pkgs = pm.Image.cuda_base().python_packages()
    assert "torch" in pkgs and not any("jax" in p or "libtpu" in p for p in pkgs)


# -- on the card ----------------------------------------------------------------

K1_APP = '''
import torch

import modal_examples_tpu_torch as mtpu

app = mtpu.App("k1-on-card")


@app.function(gpu="H100", max_containers=1, timeout=600)
def k1(seed: int) -> dict:
    from modal_examples_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(4, 32, 512, 128, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3))
    o, _ = fa.flash_forward_cuda(q, k, v, causal=True, sm_scale=128**-0.5)
    want, _ = fa.flash_forward_plain(q, k, v, causal=True, sm_scale=128**-0.5)
    return {"err": (o.float() - want.float()).abs().max().item(), "launches": fa.launches,
            "card": torch.cuda.get_device_name(0)}
'''


@pytest.mark.gpu
def test_k1_in_a_gpu_function_container_on_card(tmp_path):
    """``chip_smoke.py`` phase 11a covers the same on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    path = tmp_path / "k1_on_card_app.py"
    path.write_text(K1_APP)
    mod = papp.load_module_from_path(str(path))
    with mod.app.run():
        rows = [mod.k1.remote(0), *mod.k1.map(range(1, 5)), mod.k1.spawn(5).get(timeout=600)]
    assert all(r["err"] <= 2e-2 for r in rows)
    assert [r["launches"] for r in rows] == list(range(1, 7))
    assert rows[0]["card"] == torch.cuda.get_device_name(0)
