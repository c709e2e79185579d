"""The port's vision-language path against the JAX package's, on the CPU:
``models/vlm.py`` (the ViT tower and projector, preprocessing, the HF
loader), ``llama`` with ``input_embeds``, the engine with ``vision=`` and
the OpenAI chat route with image parts.

Same weights (the JAX inits through ``*_from_jax``; the tower perturbed by
a seeded N(0, 0.02) so its zero biases and unit norms carry a signal), same
numpy images. Tolerances, f32: the tower's embeddings and the prefix
logits within 1e-5 of their largest value; the HF loader bitwise. The
engines are stepped by hand (``eng.step()``, fake clocks) and must agree
after every tick on the tokens each request accepted, which slots hold
which request, the free pages and the prefix cache's pages, hits and
misses; then on finish reasons, ``cached_tokens``, the trie pages that
requests with the same image share (and those with different images do
not) and every refusal's message.
"""

import base64
import builtins
import dataclasses
import http.client
import io
import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import llama as jllama
from modal_examples_tpu.models import vlm as jvlm
from modal_examples_tpu.serving.engine import LLMEngine as JaxEngine
from modal_examples_tpu.serving.openai_api import OpenAIServer as JaxServer
from modal_examples_tpu.serving.sampling import SamplingParams as JaxParams
from modal_examples_tpu_torch import LLMEngine, OpenAIServer, SamplingParams
from modal_examples_tpu_torch.models import llama as tllama
from modal_examples_tpu_torch.models import vlm as tvlm
from modal_examples_tpu_torch.utils import images as timages
from modal_examples_tpu_torch.utils import tree
from modal_examples_tpu_torch.utils.safetensors import save_file
from test_torch_time_limit import share_cores

share_cores()

TOL = 1e-5
VIT = dict(image_size=32, patch_size=8)  # 16 image tokens: two pages of 8
ENGINE_KW = dict(max_slots=3, max_model_len=128, page_size=8, prefill_buckets=(32, 64), decode_block=4, seed=0,
                 kv_dtype="float32")


def _perturbed(tree_, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + rng.normal(0, 0.02, a.shape)).astype(np.float32),
                        tree_)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-6))


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    jv = jvlm.VLMConfig(vision=jvlm.ViTConfig.tiny(**VIT), llm_dim=jcfg.dim)
    tv = tvlm.VLMConfig(vision=tvlm.ViTConfig.tiny(**VIT), llm_dim=tcfg.dim)
    np_vision = _perturbed(jvlm.init_vision_params(jax.random.PRNGKey(1), jv), 2)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams, jv=jv, tv=tv,
                jvision=jax.tree.map(jnp.asarray, np_vision),
                tvision=tvlm.vision_params_from_jax(np_vision, tv, device="cpu"))


def _image(seed, size=32):
    return np.random.default_rng(seed).integers(0, 256, (size, size, 3), dtype=np.uint8)


# -- the tower ---------------------------------------------------------------------


def test_patchify_matches_jax():
    x = np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvlm.patchify(torch.from_numpy(x), 8).numpy(),
                                  np.asarray(jvlm.patchify(jnp.asarray(x), 8)))


def test_encode_image_matches_jax(model):
    imgs = np.random.default_rng(3).random((3, 32, 32, 3)).astype(np.float32)
    want = jvlm.encode_image(model["jvision"], jnp.asarray(imgs), model["jv"])
    got = tvlm.encode_image(model["tvision"], torch.from_numpy(imgs), model["tv"])
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, model["tv"].n_image_tokens, model["tcfg"].dim)
    _close(got, want)


def test_init_vision_params_mirrors_the_jax_tree(model):
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jvlm.init_vision_params(jax.random.PRNGKey(0), model["jv"]))
    got = tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
                   tvlm.init_vision_params(model["tv"], seed=0, device="cpu"))
    assert got == jax.tree.map(lambda s: s, want, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("kind", ["uint8", "float", "gray", "pil", "resize"])
def test_preprocess_image_matches_jax(kind):
    from PIL import Image

    img = _image(4)
    if kind == "float":
        img = img.astype(np.float32) / 255.0
    elif kind == "gray":
        img = img[:, :, 0]
    elif kind == "pil":
        img = Image.fromarray(img)
    elif kind == "resize":
        img = _image(5, size=48)
    got = tvlm.preprocess_image(img, 32)
    want = jvlm.preprocess_image(img, 32)
    assert got.dtype == np.float32 and got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, want)


def test_preprocess_image_needs_pil_only_to_resize(monkeypatch):
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name.startswith("PIL"):
            raise ImportError("no PIL here")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    assert tvlm.preprocess_image(_image(6), 32).shape == (32, 32, 3)
    with pytest.raises(ValueError, match="PIL resize unavailable"):
        tvlm.preprocess_image(_image(6, size=40), 32)


def _hf_checkpoint(path, lcfg, vcfg):
    v = vcfg.vision
    rng = np.random.default_rng(0)
    raw, P = {}, "vision_model."

    def put(name, *shape):
        raw[name] = rng.standard_normal(shape).astype(np.float32)

    put(P + "embeddings.patch_embedding.weight", v.dim, 3, v.patch_size, v.patch_size)
    put(P + "embeddings.position_embedding.weight", v.n_patches + 1, v.dim)
    put(P + "embeddings.class_embedding", v.dim)
    put(P + "pre_layrnorm.weight", v.dim)
    put(P + "pre_layrnorm.bias", v.dim)
    for i in range(v.n_layers):
        E = P + f"encoder.layers.{i}."
        for lin, shp in [("self_attn.q_proj", (v.dim, v.dim)), ("self_attn.k_proj", (v.dim, v.dim)),
                         ("self_attn.v_proj", (v.dim, v.dim)), ("self_attn.out_proj", (v.dim, v.dim)),
                         ("mlp.fc1", (v.mlp_dim, v.dim)), ("mlp.fc2", (v.dim, v.mlp_dim))]:
            put(E + lin + ".weight", *shp)
            put(E + lin + ".bias", shp[0])
        for ln in ("layer_norm1", "layer_norm2"):
            put(E + ln + ".weight", v.dim)
            put(E + ln + ".bias", v.dim)
    put("multi_modal_projector.linear_1.weight", lcfg.dim, v.dim)
    put("multi_modal_projector.linear_1.bias", lcfg.dim)
    put("multi_modal_projector.linear_2.weight", lcfg.dim, lcfg.dim)
    put("multi_modal_projector.linear_2.bias", lcfg.dim)
    names = sorted(raw)  # two shards, as a real checkpoint may come
    save_file({k: torch.from_numpy(raw[k]) for k in names[::2]}, path / "model-00001.safetensors")
    save_file({k: torch.from_numpy(raw[k]) for k in names[1::2]}, path / "model-00002.safetensors")


def test_load_hf_vision_weights_is_bitwise_the_jax_loader(model, tmp_path):
    _hf_checkpoint(tmp_path, model["tcfg"], model["tv"])
    want = jvlm.load_hf_vision_weights(tmp_path, model["jv"])
    got = tvlm.load_hf_vision_weights(tmp_path, model["tv"], device="cpu")
    want_flat = dict(zip(*(lambda kv: ([jax.tree_util.keystr(k) for k, _ in kv], [v for _, v in kv]))(
        jax.tree_util.tree_flatten_with_path(want)[0])))
    got_flat = dict(zip(*(lambda kv: ([jax.tree_util.keystr(k) for k, _ in kv], [v for _, v in kv]))(
        jax.tree_util.tree_flatten_with_path(tree.map(lambda t: t.numpy(), got))[0])))
    assert sorted(got_flat) == sorted(want_flat)
    for k, w in want_flat.items():
        assert got_flat[k].dtype == np.float32 and got_flat[k].flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got_flat[k], np.asarray(w), err_msg=k)


def test_forward_and_prefill_take_input_embeds_as_jax(model):
    """The first P positions take the embeddings (cast to the model dtype):
    ``forward`` and ``prefill``'s last logits against JAX."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    embeds = rng.standard_normal((2, 16, jcfg.dim)).astype(np.float32)
    want = jllama.forward(model["jparams"], jnp.asarray(toks), jcfg, attn_impl="xla", input_embeds=jnp.asarray(embeds))
    got = tllama.forward(model["tparams"], torch.from_numpy(toks).long(), tcfg, attn_impl="flash",
                         input_embeds=torch.from_numpy(embeds))
    _close(got, want)
    from modal_examples_tpu.serving.kv_cache import PagedKVCache as JCache
    from modal_examples_tpu_torch.serving.kv_cache import PagedKVCache as TCache

    kw = dict(n_layers=jcfg.n_layers, n_kv_heads=jcfg.n_kv_heads, head_dim=jcfg.head_dim, n_pages=9, page_size=8)
    jc = JCache.create(**kw, dtype=jnp.float32)
    tc = TCache.create(**kw, kv_dtype="float32", device="cpu")
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    lens = np.array([24, 20], np.int32)
    jl, _, _ = jllama.prefill(model["jparams"], jnp.asarray(toks), jc.k_pages, jc.v_pages, jnp.asarray(tables),
                              jnp.asarray(lens), jcfg, input_embeds=jnp.asarray(embeds))
    tl, _, _ = tllama.prefill(model["tparams"], torch.from_numpy(toks).long(), tc.k_pages, tc.v_pages,
                              torch.from_numpy(tables), torch.from_numpy(lens), tcfg, input_embeds=torch.from_numpy(embeds))
    _close(tl, jl)


def test_input_embeds_under_a_mesh_names_a10b(model):
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="A10b"):
        tllama.forward(model["tparams"], toks, model["tcfg"], input_embeds=torch.zeros(1, 2, 128), mesh=object())


# -- the engine ----------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


IMG_A, IMG_B = _image(10), _image(11)
#: (prompt, image, sampling): two requests share IMG_A and its text, one
#: carries IMG_B, the rest are text only
BURST = [
    ("describe this picture", IMG_A, dict(max_tokens=5, temperature=0.0)),
    ("what is here?", None, dict(max_tokens=4, temperature=0.0)),
    ("describe this picture", IMG_A, dict(max_tokens=6, temperature=0.8, seed=7)),
    ("describe this picture", IMG_B, dict(max_tokens=5, temperature=0.0)),
    ("a longer text-only prompt that fills a page or two", None, dict(max_tokens=3, temperature=0.7, seed=3)),
    ("count the shapes", IMG_B, dict(max_tokens=4, temperature=0.9)),  # an engine-assigned seed
]


def _engines(model, **kw):
    kw = {**ENGINE_KW, **kw}
    jclock, tclock = FakeClock(), FakeClock()
    return [
        ("jax", JaxEngine(model["jcfg"], model["jparams"], vision=(model["jv"], model["jvision"]), clock=jclock, **kw),
         JaxParams),
        ("port", LLMEngine(model["tcfg"], model["tparams"], device="cpu", vision=(model["tv"], model["tvision"]),
                           clock=tclock, **kw), SamplingParams),
    ]


def _state(eng, reqs) -> tuple:
    held = {id(s.request): i for i, s in enumerate(eng.slots) if s.request is not None}
    pc = eng.prefix_cache
    return (
        tuple(tuple(r.generated_tokens) for r in reqs),
        tuple(held.get(id(r)) for r in reqs),
        eng.cache.allocator.available,
        (pc.cached_pages, pc.hits, pc.misses) if pc is not None else None,
        (eng.stats.prompt_tokens, eng.stats.generated_tokens),
    )


def _finish_of(req):
    """The finish reason of a hand-stepped request: its queued marker."""
    while req.finish_reason is None:
        item = req.out_queue.get(timeout=5)
        if hasattr(item, "reason"):
            req.finish_reason = item.reason
    return req.finish_reason


def _trie_pages(eng, req) -> list:
    """The trie pages a request's key holds (its image pages first)."""
    key = req.cache_key_tokens or req.prompt_tokens
    shared, _ = eng.prefix_cache.acquire(key)
    eng.prefix_cache.release(shared)
    return shared


@pytest.mark.parametrize("cache", [True, False], ids=["prefix-cache", "no-cache"])
def test_vision_engine_matches_the_jax_engine_tick_by_tick(model, cache):
    runs = {}
    for name, eng, P in _engines(model, enable_prefix_cache=cache):
        try:
            reqs = [eng.submit(p, P(**sp), image=img) for p, img, sp in BURST]
            assert reqs[0].image is not None and reqs[1].image is None
            states = []
            for _ in range(40):
                eng.step()
                states.append(_state(eng, reqs))
            assert all(s.free for s in eng.slots), f"{name}: the burst did not finish in 40 ticks"
            finals = [(r.cached_prompt_tokens, r.prompt_tokens, r.cache_key_tokens) for r in reqs]
            pages = [_trie_pages(eng, r) for r in reqs] if cache else None
        finally:
            eng.stop()
        runs[name] = (states, finals, pages, [_finish_of(r) for r in reqs])
    for t, (j, p) in enumerate(zip(runs["jax"][0], runs["port"][0])):
        assert p == j, f"tick {t}: port {p} != jax {j}"
    assert runs["port"][1:] == runs["jax"][1:]
    n_img = model["tv"].n_image_tokens
    finals, pages = runs["port"][1], runs["port"][2]
    assert all(len(f[1]) > n_img for f, (_, img, _) in zip(finals, BURST) if img is not None)
    assert runs["port"][3] == runs["jax"][3] and set(runs["port"][3]) <= {"stop", "length"}
    if cache:
        # the second request with IMG_A and its text reuses at least the image's pages
        assert finals[2][0] >= n_img and finals[0][0] == 0
        assert pages[0] == pages[2] and len(pages[0]) >= n_img // ENGINE_KW["page_size"]
        assert not set(pages[0][:2]) & set(pages[3][:2])  # IMG_B's image pages are its own
        assert finals[3][0] == 0 and finals[0][2][0] >= model["tcfg"].vocab_size  # keys above the vocabulary
        assert finals[0][2][0] != finals[3][2][0]
    else:
        assert all(f[0] == 0 and f[2] is None for f in finals)


def test_image_prompt_is_cut_to_the_largest_bucket(model):
    (_, jeng, JP), (_, teng, TP) = _engines(model)
    try:
        text = "word " * 80
        jr = jeng.make_request(text, JP(max_tokens=2), image=IMG_A)
        tr = teng.make_request(text, TP(max_tokens=2), image=IMG_A)
        assert tr.prompt_tokens == jr.prompt_tokens and tr.cache_key_tokens == jr.cache_key_tokens
        assert len(tr.prompt_tokens) == ENGINE_KW["prefill_buckets"][-1]
    finally:
        jeng.stop()
        teng.stop()


def _error(fn) -> str:
    with pytest.raises((ValueError, NotImplementedError)) as e:
        fn()
    return str(e.value)


def test_refusals_match_the_jax_engine(model):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    jvis, tvis = (model["jv"], model["jvision"]), (model["tv"], model["tvision"])
    kw = dict(ENGINE_KW)

    def both(jfn, tfn):
        j, t = _error(jfn), _error(tfn)
        assert t == j
        return t

    # an engine without a tower takes no image
    jplain, tplain = JaxEngine(jcfg, model["jparams"], **kw), LLMEngine(tcfg, model["tparams"], device="cpu", **kw)
    try:
        assert "without vision=" in both(lambda: jplain.submit("x", JaxParams(), image=IMG_A),
                                         lambda: tplain.submit("x", SamplingParams(), image=IMG_A))
    finally:
        jplain.stop()
        tplain.stop()
    # the projector must land in the model's width
    jbad = (dataclasses.replace(model["jv"], llm_dim=64), model["jvision"])
    tbad = (dataclasses.replace(model["tv"], llm_dim=64), model["tvision"])
    assert "!= model dim" in both(lambda: JaxEngine(jcfg, model["jparams"], vision=jbad, **kw),
                                  lambda: LLMEngine(tcfg, model["tparams"], device="cpu", vision=tbad, **kw))
    # image tokens must leave room in the largest bucket
    small = dict(kw, prefill_buckets=(16,))
    assert "multimodal prompts do not chunk" in both(
        lambda: JaxEngine(jcfg, model["jparams"], vision=jvis, **small),
        lambda: LLMEngine(tcfg, model["tparams"], device="cpu", vision=tvis, **small))
    # no speculation beside a tower
    assert "speculative" in both(
        lambda: JaxEngine(jcfg, model["jparams"], vision=jvis, speculative=("ngram", 2), **kw),
        lambda: LLMEngine(tcfg, model["tparams"], device="cpu", vision=tvis, speculative=("ngram", 2), **kw))
    # image requests refuse the disaggregated prefill and the failover resume
    (_, jeng, JP), (_, teng, TP) = _engines(model)
    try:
        jr, tr = (e.make_request("hi", P(max_tokens=2), image=IMG_A) for e, P in ((jeng, JP), (teng, TP)))
        assert "disagg prefill" in both(lambda: jeng.prefill_sync(jr), lambda: teng.prefill_sync(tr))
        assert "failover resume" in both(
            lambda: jeng.submit_resumed(jr, prompt_tokens=jr.prompt_tokens, generated=[1]),
            lambda: teng.submit_resumed(tr, prompt_tokens=tr.prompt_tokens, generated=[1]))
    finally:
        jeng.stop()
        teng.stop()
    # under a mesh the tower waits for A10b (the JAX engine replicates it)
    assert "A10b" in _error(lambda: LLMEngine(tcfg, model["tparams"], device="cpu", vision=tvis,
                                         mesh=types.SimpleNamespace(mesh_dim_names=("tensor",), shape=(2,)), **kw))


# -- the OpenAI chat route ---------------------------------------------------------------


def _post(port, body) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/chat/completions", json.dumps(body), {"content-type": "application/json"})
    r = conn.getresponse()
    out = (r.status, json.loads(r.read()))
    conn.close()
    return out


def _chat(url_or_parts, **kw):
    content = url_or_parts if isinstance(url_or_parts, list) else [
        {"type": "text", "text": "What is in the picture?"},
        {"type": "image_url", "image_url": {"url": url_or_parts}}]
    return {"messages": [{"role": "user", "content": content}], "max_tokens": 5, "temperature": 0.0, **kw}


def _png_uri(img) -> str:
    return "data:image/png;base64," + base64.b64encode(timages.to_png(img)).decode()


def test_chat_with_a_png_data_uri_matches_the_jax_server(model):
    (_, jeng, _), (_, teng, _) = _engines(model)
    jsrv, tsrv = JaxServer(jeng, port=0).start(), OpenAIServer(teng, port=0).start()
    try:
        body = _chat(_png_uri(IMG_A))
        js, jb = _post(jsrv.port, body)
        ts, tb = _post(tsrv.port, body)
        assert (ts, js) == (200, 200)
        assert tb["choices"][0]["message"] == jb["choices"][0]["message"]
        assert tb["usage"]["prompt_tokens"] == jb["usage"]["prompt_tokens"] > model["tv"].n_image_tokens
        # the same image again: its pages come from the prefix cache
        ts, tb2 = _post(tsrv.port, body)
        assert tb2["usage"]["prompt_tokens_details"]["cached_tokens"] >= model["tv"].n_image_tokens
        assert tb2["choices"][0]["message"] == tb["choices"][0]["message"]
    finally:
        jsrv.stop()
        tsrv.stop()


def _no_pil(monkeypatch):
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name.startswith("PIL"):
            raise ImportError("no PIL here")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)


def test_chat_image_refusals_are_400s(model, monkeypatch):
    teng = LLMEngine(model["tcfg"], model["tparams"], device="cpu", vision=(model["tv"], model["tvision"]),
                     **ENGINE_KW)
    plain = LLMEngine(model["tcfg"], model["tparams"], device="cpu", **ENGINE_KW)
    srv, plain_srv = OpenAIServer(teng, port=0).start(), OpenAIServer(plain, port=0).start()
    try:
        png = _png_uri(IMG_A)
        two = _chat([{"type": "image_url", "image_url": {"url": png}}, {"type": "image_url", "image_url": {"url": png}}])
        cases = [
            (srv, two, "multiple images"),
            (srv, _chat("https://example.com/cat.png"), "only data: URIs"),
            (srv, _chat([{"type": "audio", "audio": {}}]), "unsupported content part"),
            (plain_srv, _chat(png), "does not accept images"),
        ]
        for s, body, msg in cases:
            status, out = _post(s.port, body)
            assert status == 400 and msg in out["error"]["message"], out
        _no_pil(monkeypatch)
        jpeg = "data:image/jpeg;base64," + base64.b64encode(b"\xff\xd8\xff\xe0" + b"\0" * 64).decode()
        status, out = _post(srv.port, _chat(jpeg))
        assert status == 400 and "JPEG" in out["error"]["message"] and "PIL" in out["error"]["message"]
        # a PNG is read without PIL, filters and all
        buf = io.BytesIO()
        monkeypatch.undo()
        from PIL import Image

        Image.fromarray(IMG_B).save(buf, format="PNG", optimize=True)
        _no_pil(monkeypatch)
        status, out = _post(srv.port, _chat("data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()))
        assert status == 200, out
    finally:
        srv.stop()
        plain_srv.stop()


def test_png_reader_reads_every_filter_and_refuses_other_pngs():
    from PIL import Image

    img = np.add.outer(np.arange(20), np.arange(30))[..., None] * np.array([1, 3, 7]) % 256
    img = img.astype(np.uint8)
    for optimize in (False, True):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG", optimize=optimize)
        np.testing.assert_array_equal(timages.from_png(buf.getvalue()), img)
    buf = io.BytesIO()
    Image.fromarray(np.dstack([img, img[..., :1]])).save(buf, format="PNG")  # RGBA
    with pytest.raises(ValueError, match="color type 6"):
        timages.from_png(buf.getvalue())
    with pytest.raises(ValueError):
        timages.from_png(timages.PNG_SIGNATURE + b"\0\0\0\x0dIHDR")


def test_an_image_rides_through_the_router(model):
    """``PrefixAffinityRouter.submit(..., image=)`` reaches the replica's
    engine: the routed request's tokens are the direct request's."""
    from modal_examples_tpu_torch.scheduling.router import EngineReplica, PrefixAffinityRouter

    teng, direct = (LLMEngine(model["tcfg"], model["tparams"], device="cpu", vision=(model["tv"], model["tvision"]),
                              **ENGINE_KW) for _ in range(2))
    router = PrefixAffinityRouter([EngineReplica(teng, "a")])
    try:
        sp = SamplingParams(max_tokens=4, temperature=0.0)
        routed = router.submit("describe this picture", sp, image=IMG_B)
        "".join(router.stream(routed))
        want = direct.submit("describe this picture", sp, image=IMG_B)
        "".join(direct.stream(want))
        assert routed.image is not None and routed.generated_tokens == want.generated_tokens
    finally:
        teng.stop()
        direct.stop()
