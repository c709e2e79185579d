"""The port's OpenAI server at its edges, against the JAX server, and its
page-pool snapshots against the JAX cache.

- The request id comes back as ``x-mtpu-request-id`` on the 200, on the
  stream and on the 500, as the reference sends it.
- Every sampling value the port refused before is served as the reference
  serves it (negative temperatures, top_p outside (0, 1], negative top_k,
  max_tokens below 1, negative seeds). A seed outside int32 stays a 400:
  the reference fails such a request while it prefills (a 500).
- ``n <= 0`` serves one choice; an unparsable body is ``{"error": "invalid
  JSON"}``.
- ``n > 1``: one choice per request, seeded ``seed + i``; a shed part way
  aborts the admitted siblings and answers 429; ``stream`` with it is the
  reference's 400.
- ``PagedKVCache.occupancy()`` and ``PageAllocator.used``/``occupancy`` hold
  the JAX cache's keys and values.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

import modal_examples_tpu.scheduling.admission as jadm
import modal_examples_tpu_torch.scheduling.admission as tadm
from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.kv_cache import PagedKVCache as JaxCache
from modal_examples_tpu.serving.openai_api import OpenAIServer as JaxServer
from modal_examples_tpu_torch import LLMEngine, OpenAIServer
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.serving import engine as tengine
from modal_examples_tpu_torch.serving.kv_cache import PagedKVCache
from test_torch_time_limit import share_cores

share_cores()

ENGINE_KW = dict(max_slots=4, max_model_len=128, page_size=16, prefill_buckets=(16, 32), kv_dtype="float32",
                 decode_block=4, seed=0)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def servers(weights):
    jcfg, tcfg, jparams, tparams = weights
    jsrv = JaxServer(JaxEngine(jcfg, jparams, **ENGINE_KW), host="127.0.0.1", port=0).start()
    tsrv = OpenAIServer(LLMEngine(tcfg, tparams, device="cpu", **ENGINE_KW), port=0).start()
    yield f"http://127.0.0.1:{jsrv.port}", f"http://127.0.0.1:{tsrv.port}"
    jsrv.stop()
    tsrv.stop()


def _post(base, body, path="/v1/completions", raw: bytes | None = None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, {k.lower(): v for k, v in r.headers.items()}, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, e.read().decode()


# -- C5: the request id header -------------------------------------------------------


def test_request_id_header_on_the_200_and_the_stream(servers):
    for stream in (False, True):
        got = [_post(base, {"prompt": "hi", "max_tokens": 3, "temperature": 0, "stream": stream}) for base in servers]
        for status, headers, _ in got:
            assert status == 200 and headers["x-mtpu-request-id"].startswith("req-"), (stream, headers)
            assert "x-request-id" not in headers


def test_request_id_header_on_the_500(weights, monkeypatch):
    """The JAX server answers 500 to a seed past int32 (its prefill fails);
    the port refuses that seed up front, so its prefill is made to fail. Both
    500s carry the request id and the same body."""
    jcfg, tcfg, jparams, tparams = weights
    jsrv = JaxServer(JaxEngine(jcfg, jparams, **ENGINE_KW), host="127.0.0.1", port=0).start()
    tsrv = OpenAIServer(LLMEngine(tcfg, tparams, device="cpu", **ENGINE_KW), port=0).start()

    def failing_prefill(*args, **kwargs):
        raise RuntimeError("injected prefill failure")

    monkeypatch.setattr(tengine.llama, "prefill", failing_prefill)
    n_reports = len(tengine.LLMEngine._error_reports)
    try:
        jstatus, jheaders, jbody = _post(f"http://127.0.0.1:{jsrv.port}", {"prompt": "hi", "seed": 2**31})
        status, headers, body = _post(f"http://127.0.0.1:{tsrv.port}", {"prompt": "hi", "max_tokens": 3})
    finally:
        jsrv.stop()
        tsrv.stop()
    assert status == jstatus == 500 and json.loads(body) == json.loads(jbody)
    assert headers["x-mtpu-request-id"].startswith("req-") and jheaders["x-mtpu-request-id"].startswith("req-")
    assert len(tengine.LLMEngine._error_reports) == n_reports  # a failed prefill is not a scheduler error


# -- C6: sampling values the reference serves ----------------------------------------


@pytest.mark.parametrize("fields,deterministic", [
    ({"temperature": -1.0}, True),
    ({"top_p": 1.5, "temperature": 0}, True),
    ({"top_p": 0.0}, True),
    ({"top_p": -0.5}, True),
    ({"top_k": -3, "temperature": 0}, True),
    ({"max_tokens": 0}, False),
    ({"max_tokens": -2}, False),
    ({"seed": -5, "temperature": 0}, True),
], ids=lambda v: json.dumps(v) if isinstance(v, dict) else str(v))
def test_sampling_values_are_served_as_the_reference_serves_them(servers, fields, deterministic):
    body = {"prompt": "hello", "max_tokens": 4, **fields}
    (jstatus, _, jbody), (status, _, tbody) = [_post(base, body) for base in servers]
    assert status == jstatus == 200, (tbody, jbody)
    out, jout = json.loads(tbody), json.loads(jbody)
    assert out["choices"][0]["finish_reason"] == jout["choices"][0]["finish_reason"]
    assert out["usage"]["prompt_tokens"] == jout["usage"]["prompt_tokens"]
    if deterministic:  # greedy in effect: the same text
        assert out["choices"][0]["text"] == jout["choices"][0]["text"]
    else:  # max_tokens below 1 serves one token
        assert out["choices"][0]["finish_reason"] == "length"


@pytest.mark.parametrize("seed,n", [(2**31, 1), (-(2**31) - 1, 1), (2**31 - 2, 3)])  # n = 3: the third choice's
def test_a_seed_outside_int32_is_a_400_where_the_reference_fails(servers, seed, n):
    (jstatus, _, _), (status, _, body) = [_post(base, {"prompt": "hello", "seed": seed, "n": n}) for base in servers]
    assert jstatus == 500  # the reference caveat: its prefill overflows an int32 array
    assert status == 400 and "seed" in json.loads(body)["error"]["message"]


# -- C7: n <= 0 and invalid JSON -------------------------------------------------------


@pytest.mark.parametrize("n", [0, -1])
def test_n_below_one_serves_one_choice(servers, n):
    got = [_post(base, {"prompt": "hello", "max_tokens": 3, "temperature": 0, "n": n}) for base in servers]
    (jstatus, _, jbody), (status, _, body) = got
    assert status == jstatus == 200
    out, jout = json.loads(body), json.loads(jbody)
    assert len(out["choices"]) == len(jout["choices"]) == 1
    assert out["choices"][0]["text"] == jout["choices"][0]["text"]


@pytest.mark.parametrize("path", ["/v1/completions", "/v1/chat/completions"])
def test_invalid_json_answers_as_the_reference(servers, path):
    got = [_post(base, None, path=path, raw=b"{not json") for base in servers]
    (jstatus, _, jbody), (status, _, body) = got
    assert status == jstatus == 400 and json.loads(body) == json.loads(jbody) == {"error": "invalid JSON"}


# -- n > 1 -------------------------------------------------------------------------------


def test_n_choices_are_the_seeded_singles(servers):
    jbase, base = servers
    status, _, body = _post(base, {"prompt": "count", "max_tokens": 5, "temperature": 0.9, "seed": 40, "n": 3})
    assert status == 200
    out = json.loads(body)
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    singles = [json.loads(_post(base, {"prompt": "count", "max_tokens": 5, "temperature": 0.9, "seed": 40 + i})[2])
               for i in range(3)]
    assert [c["text"] for c in out["choices"]] == [s["choices"][0]["text"] for s in singles]
    assert out["usage"]["prompt_tokens"] == singles[0]["usage"]["prompt_tokens"]
    assert out["usage"]["completion_tokens"] == sum(s["usage"]["completion_tokens"] for s in singles)
    jstatus, _, jbody = _post(jbase, {"prompt": "count", "max_tokens": 5, "temperature": 0.9, "seed": 40, "n": 3})
    jout = json.loads(jbody)
    assert jstatus == 200 and [c["finish_reason"] for c in jout["choices"]] == [
        c["finish_reason"] for c in out["choices"]]
    # unseeded: each choice draws its own engine-assigned seed
    status, _, body = _post(base, {"prompt": "count", "max_tokens": 8, "temperature": 1.0, "n": 2})
    assert status == 200 and len(json.loads(body)["choices"]) == 2


def test_n_with_stream_is_the_reference_400(servers):
    got = [_post(base, {"prompt": "x", "n": 2, "stream": True}) for base in servers]
    (jstatus, _, jbody), (status, _, body) = got
    assert status == jstatus == 400 and json.loads(body) == json.loads(jbody)


def test_a_partial_shed_aborts_the_siblings_and_answers_429(weights):
    """The default queue holds two: the third choice is shed, the two queued
    siblings are aborted (reservations and depths back to zero), and the
    answer is the JAX server's 429. The engines' loops stay stopped, so the
    siblings are still queued when the third is shed."""
    jcfg, tcfg, jparams, tparams = weights
    bound = {"interactive": 8, "default": 2, "batch": 8, "canary": 8}
    jeng = JaxEngine(jcfg, jparams, admission=jadm.AdmissionController(jadm.AdmissionConfig(max_queue=bound)),
                     **ENGINE_KW)
    teng = LLMEngine(tcfg, tparams, device="cpu", admission=tadm.AdmissionController(
        tadm.AdmissionConfig(max_queue=bound)), **ENGINE_KW)
    jsrv = JaxServer(jeng, host="127.0.0.1", port=0)
    tsrv = OpenAIServer(teng, port=0)
    threads = [threading.Thread(target=s.httpd.serve_forever, daemon=True) for s in (jsrv, tsrv)]
    for t in threads:
        t.start()
    try:
        got = [_post(f"http://127.0.0.1:{s.port}", {"prompt": "x", "max_tokens": 3, "n": 3}) for s in (jsrv, tsrv)]
        (jstatus, jheaders, jbody), (status, headers, body) = got
        assert status == jstatus == 429 and json.loads(body) == json.loads(jbody)
        assert headers["retry-after"] == jheaders["retry-after"]
        for eng in (jeng, teng):
            assert eng.policy.total_depth() == 0 and eng.admission.reserved_pages == 0
            assert all(s.free for s in eng.slots)
        assert teng.admission.sheds == jeng.admission.sheds == 1
    finally:
        for s in (jsrv, tsrv):
            s.stop()


# -- C8: the page-pool snapshots -----------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_page_pool_snapshot_matches_the_jax_cache(kv_dtype):
    import jax.numpy as jnp

    shape = dict(n_layers=2, n_kv_heads=2, head_dim=32, n_pages=13, page_size=8)
    jcache = JaxCache.create(**shape, kv_dtype="int8" if kv_dtype == "int8" else jnp.bfloat16)
    tcache = PagedKVCache.create(**shape, kv_dtype=kv_dtype, device="cpu")
    for cache in (jcache, tcache):
        pages = cache.allocator.alloc(5)
        cache.allocator.free(pages[:2])
    occ, jocc = tcache.occupancy(), jcache.occupancy()
    assert occ == jocc
    assert set(occ) == {"pages_used", "pages_free", "pages_total", "occupancy", "bytes_used", "bytes_total"}
    assert occ["pages_used"] == 3 and occ["bytes_total"] == tcache.bytes()
    assert tcache.allocator.used == 3 and tcache.allocator.occupancy == 3 / 12
    if hasattr(jcache.allocator, "used"):  # the JAX package's native allocator may stand in
        assert (tcache.allocator.used, tcache.allocator.occupancy) == (jcache.allocator.used,
                                                                       jcache.allocator.occupancy)
