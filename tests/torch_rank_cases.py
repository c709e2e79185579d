"""What the port's parallel tests run inside their rank processes.

The ``tests/test_torch_{parallel,sharded,tensor_parallel,ring_attention,
dp_training,clustered}.py`` modules each start two rank processes once, and
``tests/test_torch_{tp_training,fsdp}.py`` one gang of each size in turn
(:func:`gang_fixture`, :func:`open_gang`: ``parallel.cluster.RankGang`` over gloo on the CPU,
rendezvous through a ``file://`` store under the module's temporary
directory, never a fixed port) and run their cases in them. A case is a
module-level function ``case(rank, *args)`` of this module (the ranks import
it by name), imports no JAX (the ranks never load it) and returns plain
values, numpy arrays or CPU tensors, which the test holds against the JAX
package computed in the test process.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

#: every rank runs torch on one thread (six xdist workers, two ranks each)
RANK_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@contextlib.contextmanager
def open_gang(world: int, tmp_path_factory):
    """``world`` CPU ranks over gloo, rendezvous under a fresh temporary
    directory, for the block."""
    from modal_examples_tpu_torch.parallel.cluster import RankGang

    store = tmp_path_factory.mktemp("rendezvous") / "store"
    with RankGang(world, backend="gloo", device="cpu", init_method=f"file://{store}", env=RANK_ENV) as g:
        yield g


def gang_fixture(world: int = 2):
    """A module-scoped fixture: ``world`` CPU ranks over gloo for the
    module's cases."""

    @pytest.fixture(scope="module")
    def gang(tmp_path_factory):
        with open_gang(world, tmp_path_factory) as g:
            yield g

    return gang


def _mesh(axes: dict):
    from modal_examples_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    return make_mesh(axes)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else t


# -- parallel/ ------------------------------------------------------------------------


def mesh_layout(rank: int, axes: dict):
    """The mesh's axis names and sizes, and this rank's coordinate."""
    from modal_examples_tpu_torch.parallel.collectives import axis_index
    from modal_examples_tpu_torch.parallel.mesh import axis_sizes

    mesh = _mesh(axes)
    return list(mesh.mesh_dim_names), axis_sizes(mesh), {a: axis_index(a, mesh) for a in mesh.mesh_dim_names}


def mesh_refused(rank: int, axes: dict, spec: str | None) -> str:
    """The ValueError ``make_mesh`` raises (empty if it makes the mesh)."""
    from modal_examples_tpu_torch.parallel import make_mesh

    try:
        make_mesh(axes, spec=spec)
    except ValueError as e:
        return str(e)
    return ""


def collectives(rank: int, x_full: np.ndarray):
    """Each collective over a ``data`` axis of the world, this rank holding
    block ``rank`` of ``x_full`` (dim 0) where the JAX test shards it."""
    from modal_examples_tpu_torch.parallel import collectives as C

    mesh = _mesh({"data": -1})
    n = C.axis_size("data", mesh)
    full = torch.from_numpy(x_full)
    mine = full.chunk(n, dim=0)[rank].contiguous()
    ones = torch.ones_like(mine)
    out = {
        "axis_index": C.axis_index("data", mesh),
        "axis_size": n,
        "psum": C.psum(ones, "data", mesh),
        "pmean": C.pmean(mine, "data", mesh),
        "pmax": C.pmax(mine, "data", mesh),
        "pmin": C.pmin(mine, "data", mesh),
        "ring_shift": C.ring_shift(mine, "data", 1, mesh),
        "all_gather": C.all_gather(mine, "data", mesh=mesh),
        "all_gather_untiled": C.all_gather(mine, "data", tiled=False, mesh=mesh),
        "reduce_scatter": C.reduce_scatter(full, "data", mesh=mesh),
        "all_to_all": C.all_to_all(mine, "data", split_dim=0, concat_dim=0, mesh=mesh),
        "barrier": C.barrier("data", mesh),
        "ppermute_one_way": C.ppermute(mine, "data", [(0, 1)], mesh),
        "input_kept": bool(torch.equal(mine, full.chunk(n, dim=0)[rank])),
    }
    out["psum_calls_before_tree"] = C.counts["psum"]
    tree = C.psum_tree({"f32": mine, "bf16": mine.to(torch.bfloat16), "f32_row": mine[0]}, "data", mesh)
    out["psum_tree"] = {k: v.float() for k, v in tree.items()}
    out["psum_tree_calls"] = C.counts["psum"]
    return {k: ({a: _np(b) for a, b in v.items()} if isinstance(v, dict) else _np(v)) for k, v in out.items()}


def ppermute_grad(rank: int, x_full: np.ndarray, w_full: np.ndarray):
    """``ring_shift`` of this rank's block times a weight, summed; the
    gradient of the block (the backward sends it back along the ring)."""
    from modal_examples_tpu_torch.parallel import collectives as C

    mesh = _mesh({"data": -1})
    n = C.axis_size("data", mesh)
    x = torch.from_numpy(x_full).chunk(n, dim=0)[rank].contiguous().requires_grad_(True)
    w = torch.from_numpy(w_full).chunk(n, dim=0)[rank]
    y = C.ring_shift(x, "data", 1, mesh)
    (y * w).sum().backward()
    return _np(y), _np(x.grad)


def fsdp_specs_of(rank: int, shapes: dict, min_size: int):
    from modal_examples_tpu_torch.parallel.mesh import fsdp_specs

    mesh = _mesh({"fsdp": 2})
    tree = {k: torch.zeros(s) for k, s in shapes.items()}
    return {k: tuple(v) for k, v in fsdp_specs(tree, mesh, min_size=min_size).items()}


def shard_pytree_blocks(rank: int, x: np.ndarray):
    from modal_examples_tpu_torch.parallel.mesh import P, shard_pytree

    mesh = _mesh({"data": 2})
    tree = {"w": torch.from_numpy(x), "b": torch.ones(3)}
    placed = shard_pytree(tree, mesh, lambda path, leaf: P("data") if leaf.ndim == 2 else P())
    return _np(placed["w"]), _np(placed["b"])


# -- ops/sharded.py ---------------------------------------------------------------------


def _local_heads(a: np.ndarray, axis: int, rank: int, tp: int = 2) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.split(a, tp, axis=axis)[rank]))


def _pages(pair, axis: int, rank: int | None):
    """A cache side from (data, scale-or-None) numpy arrays, cut to this
    rank's heads (``rank`` None: whole)."""
    from modal_examples_tpu_torch.ops.kv_quant import QuantizedKV

    data, scale = pair
    cut = (lambda a, ax: torch.from_numpy(a.copy())) if rank is None else (lambda a, ax: _local_heads(a, ax, rank))
    if scale is None:
        return cut(data, axis)
    return QuantizedKV(data=cut(data, axis), scale=cut(scale, axis))


def _pages_np(p):
    from modal_examples_tpu_torch.ops.kv_quant import is_quantized

    return (_np(p.data), _np(p.scale)) if is_quantized(p) else (_np(p), None)


def sharded_ops(rank: int, inp: dict):
    """Every ``ops.sharded`` wrapper at TP=2 on this rank's heads, and (the
    fall-through) with no mesh on every head."""
    from modal_examples_tpu_torch.ops import sharded as S

    mesh = _mesh({"tensor": 2})
    heads = inp["heads"]
    out = {}
    for name, m, r in (("tp", mesh, rank), ("none", None, None)):
        def cut(a, axis):
            return torch.from_numpy(a.copy()) if r is None else _local_heads(a, axis, r)

        kw = {"heads": heads} if m is not None else {}
        kp, vp = _pages(inp["kp"], 3, r), _pages(inp["vp"], 3, r)
        ragged = S.sharded_ragged_decode(
            m, cut(inp["q"], 1), kp, vp, 1, torch.from_numpy(inp["tables"]), torch.from_numpy(inp["prefix"]),
            cut(inp["k_new"], 1), cut(inp["v_new"], 1), **kw)
        S.sharded_scatter_kv_pages(m, kp, vp, cut(inp["k_all"], 2), cut(inp["v_all"], 2),
                                   torch.from_numpy(inp["page_idx"]), torch.from_numpy(inp["slot"]), **kw)
        flash = S.sharded_flash_attention(m, cut(inp["fq"], 1), cut(inp["fk"], 1), cut(inp["fv"], 1), True, **kw)
        chunked = S.sharded_flash_attention_chunked(m, cut(inp["fq"], 1)[:, :, 16:].contiguous(), cut(inp["fk"], 1),
                                                    cut(inp["fv"], 1), q_offset=16, **kw)
        wk, wv = _pages(inp["kp"], 3, r), _pages(inp["vp"], 3, r)
        wta = S.sharded_write_then_attend(
            m, cut(inp["q"], 1), wk[0], wv[0], torch.from_numpy(inp["tables"]), torch.from_numpy(inp["ctx"]),
            cut(inp["k_new"], 1), cut(inp["v_new"], 1), torch.from_numpy(inp["w_page"]),
            torch.from_numpy(inp["w_slot"]), **kw)
        read = S.sharded_paged_decode_attention(m, cut(inp["q"], 1), wk[0], wv[0], torch.from_numpy(inp["tables"]),
                                                torch.from_numpy(inp["ctx"]), **kw)
        out[name] = {"ragged": _np(ragged), "k_pages": _pages_np(kp), "v_pages": _pages_np(vp), "flash": _np(flash),
                     "chunked": _np(chunked), "wta": _np(wta), "read": _np(read), "wk": _pages_np(wk[0])}
    return out


def sharded_refusals(rank: int) -> list:
    """The ValueErrors of a head count the degree does not divide, and of a
    shard that is not the count's half."""
    from modal_examples_tpu_torch.ops import sharded as S

    mesh = _mesh({"tensor": 2})
    q, kv = torch.zeros(1, 2, 8), torch.zeros(1, 1, 8)
    pages = torch.zeros(1, 5, 16, 1, 8)
    msgs = []
    for heads in ((4, 3), (8, 4), (3, 2)):
        try:
            S.sharded_ragged_decode(mesh, q, pages, pages, 0, torch.zeros(1, 4, dtype=torch.int32),
                                    torch.zeros(1, dtype=torch.int32), kv, kv, heads=heads)
            msgs.append("")
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def shard_params_of(rank: int, np_params: dict, cfg_kw: dict):
    """``llama.shard_params`` of the JAX tree carried across, as numpy
    (a quantized leaf as (int8 values, scale))."""
    from modal_examples_tpu_torch.models import llama
    from modal_examples_tpu_torch.models.quantize import QuantizedWeight

    mesh = _mesh({"tensor": 2})
    cfg = llama.LlamaConfig(**cfg_kw)
    local = llama.shard_params(llama.params_from_jax(np_params, cfg, device="cpu"), cfg, mesh)

    def leaf(w):
        if isinstance(w, QuantizedWeight):
            return _np(w.values()), _np(w.scale), w.bits
        return _np(w.float()) if w.dtype == torch.bfloat16 else _np(w)

    return {
        "embed": leaf(local["embed"]), "final_norm": leaf(local["final_norm"]),
        "lm_head": leaf(local["lm_head"]) if "lm_head" in local else None,
        "layers": [{k: leaf(w) for k, w in layer.items()} for layer in local["layers"]],
    }


# -- the tensor-parallel engine and the dense path ----------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _tiny(np_params, cfg_kw):
    from modal_examples_tpu_torch.models import llama

    cfg = llama.LlamaConfig(**cfg_kw)
    return cfg, llama.params_from_jax(np_params, cfg, device="cpu")


def tp_model_logits(rank: int, np_params, cfg_kw: dict, kv_dtype: str, impl: str, inp: dict):
    """Prefill, then two decode steps (``impl``), at TP=2 on this rank's
    shards and on one rank with every weight: the logits of each."""
    from modal_examples_tpu_torch.models import llama
    from modal_examples_tpu_torch.serving.kv_cache import PagedKVCache

    mesh = _mesh({"tensor": 2})
    cfg, full = _tiny(np_params, cfg_kw)
    out = {}
    for name, params, m, tp in (("tp", llama.shard_params(full, cfg, mesh), mesh, 2), ("one", full, None, 1)):
        c = PagedKVCache.create(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads // tp, head_dim=cfg.head_dim,
                                n_pages=inp["n_pages"], page_size=inp["page_size"], kv_dtype=kv_dtype, device="cpu")
        tables, lens = torch.from_numpy(inp["tables"]), torch.from_numpy(inp["lens"])
        pre, kp, vp = llama.prefill(params, torch.from_numpy(inp["tokens"]), c.k_pages, c.v_pages, tables, lens, cfg,
                                    mesh=m)
        logits, tok, pos = [pre], pre.argmax(-1).int(), lens.clone()
        active = torch.ones(len(lens), dtype=torch.bool)
        for _ in range(2):
            d, kp, vp = llama.decode_step(params, tok, pos, kp, vp, tables, active, cfg, impl=impl, mesh=m)
            logits.append(d)
            tok, pos = d.argmax(-1).int(), pos + 1
        with torch.no_grad():
            fwd = llama.forward(params, torch.from_numpy(inp["tokens"]), cfg, mesh=m)
        out[name] = [_np(x) for x in logits] + [_np(fwd)]
    return out


def _serve(eng, burst):
    from modal_examples_tpu_torch.serving.sampling import SamplingParams

    reqs = [eng.submit(p, SamplingParams(**kw)) for p, kw in burst]
    pieces = [list(eng.stream(r)) for r in reqs]
    return {
        "tokens": [list(r.generated_tokens) for r in reqs], "finish": [r.finish_reason for r in reqs],
        "pieces": pieces, "prompts": [list(r.prompt_tokens) for r in reqs],
    }


def tp_engine_serve(rank: int, np_params, cfg_kw: dict, engine_kw: dict, burst: list, quantization=None):
    """The burst through the TP=2 engine (rank 0; rank 1 follows) and, on
    rank 0, through the one-rank engine over the same weights."""
    from modal_examples_tpu_torch.serving.engine import LLMEngine, follow
    from modal_examples_tpu_torch.serving.openai_api import _metrics_text

    mesh = _mesh({"tensor": 2})
    cfg, full = _tiny(np_params, cfg_kw)
    kw = dict(engine_kw, device="cpu", quantization=quantization)
    if rank:
        journal: list = []
        follow(cfg, full, mesh=mesh, device="cpu", journal=journal)
        return {"journal": journal}
    eng = LLMEngine(cfg, full, mesh=mesh, **kw)
    eng.runner.journal = []
    try:
        out = _serve(eng, burst)
        out["pages_back"] = eng.cache.allocator.available == eng.cache.n_pages - 1
        out["plan"] = dict(eng.impl_plan)
        out["local_kv_heads"] = int(eng.cache.k_pages.shape[3])
        out["metrics"] = _metrics_text(eng)
    finally:
        eng.stop()
    out["journal"] = eng.runner.journal
    one = LLMEngine(cfg, full, **kw)
    try:
        out["one"] = _serve(one, burst)
    finally:
        one.stop()
    return out


def tp_follower_settings(rank: int, np_params, cfg_kw: dict, engine_kw: dict, follower_env: dict, burst: list):
    """The burst through the TP=2 engine, the follower's environment set to
    other defaults than rank 0's (rank 0's has none of them): what the
    follower built from, rank 0's resolved settings, the tokens of the TP
    and one-rank engines and both journals."""
    import os

    from modal_examples_tpu_torch.serving.engine import LLMEngine, follow

    mesh = _mesh({"tensor": 2})
    cfg, full = _tiny(np_params, cfg_kw)
    if rank:
        os.environ.update(follower_env)
        journal: list = []
        got = follow(cfg, full, mesh=mesh, device="cpu", journal=journal)
        return {"settings": {k: v for k, v in got.items() if k != "cfg"}, "journal": journal}
    for k in follower_env:
        os.environ.pop(k, None)
    eng = LLMEngine(cfg, full, mesh=mesh, device="cpu", **engine_kw)
    eng.runner.journal = []
    try:
        out = _serve(eng, burst)
    finally:
        eng.stop()
    out.update(journal=eng.runner.journal, kv_dtype=eng.kv_dtype, paged_impl=eng.paged_impl,
               scatter_impl=eng.scatter_impl, n_pages=eng.cache.n_pages, decode_block=eng.decode_block)
    one = LLMEngine(cfg, full, device="cpu", **engine_kw)
    try:
        out["one"] = _serve(one, burst)
    finally:
        one.stop()
    return out


def tp_deadline_journal(rank: int, np_params, cfg_kw: dict, engine_kw: dict):
    """A hand-stepped burst on rank 0's engine under a fake clock, one
    request's deadline expiring mid-decode: rank 0's runner journal and the
    follower's (every call, with a digest of its host inputs)."""
    from modal_examples_tpu_torch.serving.engine import LLMEngine, follow
    from modal_examples_tpu_torch.serving.sampling import SamplingParams

    mesh = _mesh({"tensor": 2})
    cfg, full = _tiny(np_params, cfg_kw)
    if rank:
        journal: list = []
        follow(cfg, full, mesh=mesh, device="cpu", journal=journal)
        return journal, None
    clock = FakeClock()
    eng = LLMEngine(cfg, full, mesh=mesh, device="cpu", clock=clock, **engine_kw)
    eng.runner.journal = []
    reqs = [
        eng.submit("a deadline in the middle", SamplingParams(max_tokens=24, temperature=0.0, deadline_s=5.0)),
        eng.submit("x" * 40, SamplingParams(max_tokens=10, temperature=0.8, seed=3)),
        eng.submit("hello", SamplingParams(max_tokens=6, temperature=0.0)),
    ]
    try:
        for t in range(30):
            if t == 4:
                clock.t = 10.0  # past the first request's deadline, mid-decode
            eng.step()
        finish = [_finish_of(r) for r in reqs]
        tokens = [len(r.generated_tokens) for r in reqs]
    finally:
        eng.stop()
    return eng.runner.journal, (finish, tokens)


def _finish_of(req):
    """The finish reason once the terminal marker is queued (text drained)."""
    import queue

    while req.finish_reason is None:
        try:
            item = req.out_queue.get_nowait()
        except queue.Empty:
            return None
        if hasattr(item, "reason"):
            req.finish_reason = item.reason
    return req.finish_reason


def dense_tp(rank: int, np_params, cfg_kw: dict, prompts: np.ndarray, lens: np.ndarray, max_new: int, kv_dtype):
    """``decode_step_dense``'s logits over the prompt's first token and
    ``generate_tp``'s tokens at TP=2, and ``generate_tp`` on one rank."""
    from modal_examples_tpu_torch.models import llama
    from modal_examples_tpu_torch.serving import tensor_parallel as tp

    mesh = _mesh({"tensor": 2})
    cfg, full = _tiny(np_params, cfg_kw)
    local = tp.shard_params_tp(full, cfg, mesh)
    cache = tp.DenseKVCache.create(cfg, prompts.shape[0], 32, mesh, dtype=full["embed"].dtype, kv_dtype=kv_dtype,
                                   device="cpu")
    toks = torch.from_numpy(prompts[:, 0].copy())
    logits, _ = tp.decode_step_dense(local, toks, cache, torch.zeros_like(toks), cfg, mesh=mesh)
    args = (cfg, torch.from_numpy(prompts), torch.from_numpy(lens), max_new)
    return {
        "logits": _np(logits),
        "gen_tp": _np(tp.generate_tp(full, *args, mesh=mesh, max_len=32, kv_dtype=kv_dtype)),
        "gen_one": _np(tp.generate_tp(full, *args, max_len=32, kv_dtype=kv_dtype)),
        "cache_heads": int(cache.k.shape[2]),
    }


def tp_engine_refusals(rank: int, np_params, cfg_kw: dict) -> dict:
    """The errors of what a tensor-parallel engine does not take."""
    from modal_examples_tpu_torch.models import llama
    from modal_examples_tpu_torch.serving.engine import LLMEngine

    mesh = _mesh({"tensor": 2})
    cfg, full = _tiny(np_params, cfg_kw)
    kw = dict(device="cpu", max_slots=2, max_model_len=64, page_size=16, prefill_buckets=(32,))
    out = {}
    for name, extra in (("speculative", dict(speculative=("ngram", 2))), ("macro-step", dict(decode_steps=4)),
                        ("tiered", dict(tiered_prefix=True))):
        try:
            if rank == 0:
                LLMEngine(cfg, full, mesh=mesh, **kw, **extra)
            out[name] = "ROADMAP A10b" if rank else "built"
        except NotImplementedError as e:
            out[name] = str(e)
    try:
        LLMEngine(llama.LlamaConfig(**{**cfg_kw, "n_kv_heads": 1, "n_heads": 4}), None, mesh=mesh, **kw)
        out["heads"] = "built"
    except (ValueError, RuntimeError) as e:
        out["heads"] = str(e)
    return out


# -- data-parallel training ------------------------------------------------------------------


def dp_train(rank: int, np_base, cfg_kw: dict, np_lora: dict, lora_kw: dict, batch: dict, lr: float, steps: int,
             grad_accum: int = 1):
    """LoRA ``Trainer`` steps data parallel over the two ranks (each takes
    its block of every microbatch of the global batch) and, on every rank,
    the one-rank trainer over the whole batch: losses, grad norms and
    adapters of each, and the first step's gradients (``loss_and_grads``).
    The loss is ``cross_entropy_terms``, so the global mean counts the
    tokens of every rank."""
    from modal_examples_tpu_torch.models import llama, lora
    from modal_examples_tpu_torch.training import Trainer, cross_entropy_terms, make_optimizer

    mesh = _mesh({"data": 2})
    cfg, base = _tiny(np_base, cfg_kw)
    lcfg = lora.LoRAConfig(**lora_kw)

    def loss_fn(adapters, b):
        logits = llama.forward(base, b["tokens"], cfg, attn_impl="flash", lora=adapters, lora_scale=lcfg.scale)
        return cross_entropy_terms(logits[:, :-1], b["tokens"][:, 1:], b["mask"][:, 1:])

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for name, m in (("dp", mesh), ("one", None)):
        t = Trainer(loss_fn, make_optimizer(lr), mesh=m, grad_accum=grad_accum)
        state = t.init_state(lora.lora_from_jax(np_lora, device="cpu"))
        _, grads = t.loss_and_grads(state.params, tb)
        losses, norms = [], []
        for _ in range(steps):
            state, metrics = t.train_step(state, tb)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        out[name] = {"loss": losses, "grad_norm": norms,
                     "grads": {k: _np(v) for k, v in grads["layers"].items()},
                     "adapters": {k: _np(v) for k, v in state.params["layers"].items()}}
    return out


# -- tensor-parallel and FSDP training ---------------------------------------------------


def named_leaves(params) -> dict:
    """A llama tree's leaves by name (``embed``, ``final_norm``,
    ``layers.<i>.<key>``), as numpy (a placement tree's ``P`` leaves as
    they are)."""
    out = {k: _np(v) for k, v in params.items() if k != "layers"}
    for i, layer in enumerate(params["layers"]):
        out.update({f"layers.{i}.{k}": _np(v) for k, v in layer.items()})
    return out


def _bytes(tree_) -> int:
    from modal_examples_tpu_torch.utils import tree

    return sum(x.numel() * x.element_size() for x in tree.leaves(tree_) if torch.is_tensor(x))


#: parallel_train's options and their defaults
TRAIN_OPTS = {"attn_impl": "xla", "moe_impl": "nodrop", "aux_weight": 0.0, "grad_clip": 1.0, "batch_spec": ("data",),
              "remat": False, "one_rank": True}


def parallel_train(rank: int, np_params, cfg_kw: dict, axes: dict, kind: str, batch: dict, lr: float, steps: int,
                   opts: dict | None = None):
    """``Trainer(param_specs=)`` on a mesh of the gang (``kind`` "tp":
    ``llama.partition_specs``; "fsdp": ``fsdp_specs`` of the tree) and, with
    ``one_rank``, the one-rank trainer over the whole batch on every rank:
    the first step's gradients (gathered whole), each step's loss and grad
    norm, the first moments after the first step (gathered), the at-rest bytes of parameters and moments, the local shapes of
    both, each leaf's placement, the replicated leaves' gradients as this
    rank holds them (before any gather), and the parameters after the steps
    (gathered). ``opts`` overrides :data:`TRAIN_OPTS`."""
    from modal_examples_tpu_torch.models import llama
    from modal_examples_tpu_torch.parallel.mesh import P, fsdp_specs, specs_for
    from modal_examples_tpu_torch.training import Trainer, cross_entropy_loss, make_optimizer

    o = {**TRAIN_OPTS, **(opts or {})}
    attn_impl, moe_impl, aux_weight = o["attn_impl"], o["moe_impl"], o["aux_weight"]
    mesh = _mesh(axes)
    cfg, full = _tiny(np_params, cfg_kw)
    capacity = moe_impl == "capacity"

    def loss_fn(p, b):  # the reference's loss: llama.forward given no mesh
        out = llama.forward(p, b["tokens"], cfg, attn_impl=attn_impl, moe_impl=moe_impl, return_aux=capacity)
        logits, aux = out if capacity else (out, 0.0)
        return cross_entropy_loss(logits[:, :-1], b["tokens"][:, 1:]) + aux_weight * aux

    specs = llama.partition_specs(cfg) if kind == "tp" else fsdp_specs(full, mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    runs = [("mesh", mesh, specs)] + ([("one", None, None)] if o["one_rank"] else [])
    for name, m, sp in runs:
        t = Trainer(loss_fn, make_optimizer(lr, grad_clip=o["grad_clip"]), mesh=m, param_specs=sp,
                    batch_spec=P(*o["batch_spec"]), remat=o["remat"])
        state = t.init_state(full)
        placed = named_leaves(specs_for(full, sp)) if sp is not None else {}
        _, grads = t.loss_and_grads(state.params, tb)
        local = named_leaves(grads)
        losses, norms = [], []
        for i in range(steps):
            state, metrics = t.train_step(state, tb)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            if i == 0:
                mu_1 = named_leaves(t.gather_tree(state.opt_state["mu"], like=state.params))
        out[name] = {
            "mu_1": mu_1,
            "grads": named_leaves(t.gather_tree(grads, like=state.params)),
            "replicated_grads": {k: g for k, g in local.items() if not any(placed.get(k, ()))},
            "loss": losses, "grad_norm": norms,
            "bytes": _bytes(state.params) + _bytes(state.opt_state["mu"]) + _bytes(state.opt_state["nu"]),
            "shapes": {k: v.shape for k, v in named_leaves(state.params).items()},
            "moment_shapes": {k: v.shape for k, v in named_leaves(state.opt_state["mu"]).items()},
            "placement": {k: tuple(s) for k, s in placed.items()},
            "params": named_leaves(t.gather_tree(state.params)),
        }
    return out


def tp_train_on_card(rank: int, cfg_kw: dict, batch_shape: tuple, steps: int) -> dict:
    """``Trainer(param_specs=partition_specs)`` at TP=2 on the card (bf16,
    the flash kernels): the K1, K5 and K6 launches each step and the q
    shapes they were launched at, the losses."""
    from modal_examples_tpu_torch.models import llama
    from modal_examples_tpu_torch.ops import flash_attention as fa
    from modal_examples_tpu_torch.parallel.mesh import P
    from modal_examples_tpu_torch.training import Trainer, cross_entropy_loss, make_optimizer

    mesh = _mesh({"tensor": 2})
    cfg = llama.LlamaConfig(**cfg_kw)
    params = llama.init_params(cfg, seed=0, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, batch_shape, generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda")

    def loss_fn(p, b):
        logits = llama.forward(p, b["tokens"], cfg, attn_impl="flash")
        return cross_entropy_loss(logits[:, :-1], b["tokens"][:, 1:])

    shapes = set()
    kernels = {name: getattr(fa, name) for name in ("flash_forward_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda")}

    def recording(name):
        def launch(q, k, *args, **kw):
            shapes.add((name, tuple(q.shape), tuple(k.shape)))
            return kernels[name](q, k, *args, **kw)
        return launch

    t = Trainer(loss_fn, make_optimizer(1e-3), mesh=mesh, param_specs=llama.partition_specs(cfg), batch_spec=P())
    state = t.init_state(params)
    del params
    per_step, losses = [], []
    for name in kernels:
        setattr(fa, name, recording(name))
    try:
        for _ in range(steps):
            before = (fa.launches, fa.dq_launches, fa.dkv_launches)
            state, m = t.train_step(state, {"tokens": tokens})
            torch.cuda.synchronize()
            per_step.append([a - b for a, b in zip((fa.launches, fa.dq_launches, fa.dkv_launches), before)])
            losses.append(float(m["loss"]))
    finally:
        for name, fn in kernels.items():
            setattr(fa, name, fn)
    return {"per_step": per_step, "shapes": sorted(shapes), "losses": losses}


# -- expert parallelism -------------------------------------------------------------------


def moe_ep(rank: int, np_params: dict, x: np.ndarray, cfg_kw: dict):
    """``moe_mlp_ep`` over an ``expert`` axis of every rank: this rank's
    tokens and experts in, its output and the averaged aux loss out."""
    from modal_examples_tpu_torch.models import moe
    from modal_examples_tpu_torch.parallel.collectives import axis_size

    mesh = _mesh({"expert": -1})
    n = axis_size("expert", mesh)
    cfg = moe.MoEConfig(**cfg_kw)
    e_loc = cfg.n_experts // n
    params = {"router": torch.from_numpy(np_params["router"]),
              "w_in": torch.from_numpy(np_params["w_in"][rank * e_loc:(rank + 1) * e_loc].copy()),
              "w_out": torch.from_numpy(np_params["w_out"][rank * e_loc:(rank + 1) * e_loc].copy())}
    x_loc = torch.from_numpy(np.split(x, n)[rank].copy())
    out, aux = moe.moe_mlp_ep(params, x_loc, cfg, mesh)
    return _np(out), float(aux)


# -- ring and Ulysses attention ----------------------------------------------------------------


def ring_and_ulysses(rank: int, q: np.ndarray, k: np.ndarray, v: np.ndarray, causal: bool, grad: bool):
    """The sharded ring and Ulysses outputs (whole, on every rank) and,
    with ``grad``, this rank's block of the ring's gradients of ``sum(o)``."""
    from modal_examples_tpu_torch.ops import ring_attention as ra

    mesh = _mesh({"seq": 2})
    t = [torch.from_numpy(a.copy()) for a in (q, k, v)]
    out = {"ring": _np(ra.ring_attention_sharded(*t, mesh, causal=causal))}
    if q.shape[1] % 2 == 0 and k.shape[1] % 2 == 0:
        out["ulysses"] = _np(ra.ulysses_attention_sharded(*t, mesh, causal=causal))
    if grad:
        blocks = [a.chunk(2, dim=2)[rank].contiguous().requires_grad_(True) for a in t]
        ra.ring_attention(*blocks, axis_name="seq", causal=causal, mesh=mesh).sum().backward()
        out["grads"] = [_np(b.grad) for b in blocks]
    return out


def ulysses_refused(rank: int) -> str:
    from modal_examples_tpu_torch.ops import ring_attention as ra

    mesh = _mesh({"seq": 2})
    x = torch.ones(1, 3, 64, 32)
    try:
        ra.ulysses_attention_sharded(x, x, x, mesh)
    except ValueError as e:
        return str(e)
    return ""


def fail_on_rank(rank: int, bad: int) -> int:
    """Raises on rank ``bad``; the others wait in a collective it never joins."""
    import torch.distributed as dist

    if rank == bad:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()
    return rank
