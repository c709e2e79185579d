"""The kernels' dispatch under tensor parallelism: each rank runs the
unmodified kernel on its local kv-head shard.

Counterpart of ``modal_examples_tpu/ops/sharded.py``. There each wrapper
puts a Pallas kernel under ``shard_map`` over the kv-head axis, so every
chip runs it on its local heads. Here every rank is its own process and
already holds only its local shards (:func:`~..models.llama.shard_params`,
:func:`shard_cache_pages`): a wrapper checks the shard and calls the same
entry the one-card path calls, at the local shapes. So:

- with no mesh, or a 1-wide ``tensor`` axis, a wrapper is the plain entry;
- attention is head-local (query head ``h`` reads only kv head
  ``h // group``), so no wrapper runs a collective: outputs are the local
  query heads, and the one sum tensor parallelism needs is the row-parallel
  ``wo`` product's (``models.llama``);
- the scatter is head-local too (page ids are global, the page axis whole),
  and quantize-at-write stays exact under sharding because int8 scales are
  per (token, head);
- every shape choice is made from the local shapes: the ragged variant
  reported by ``llama.paged_impl_plan(mesh=)``, the int8 scatter's row
  partition (``paged_attention.scatter_int8_partition`` at the local
  ``Hkv``), the decode kernels' splits.

``heads=(n_heads, n_kv_heads)`` gives a wrapper the model's global head
counts: a count that the tensor degree does not divide raises, as in JAX,
and so does a local shard that is not ``count / tp`` heads wide. The
serving code (``models/llama.py``, ``serving/``) reaches the attention and
scatter kernels only through these wrappers (``tests/test_torch_static.py``).
"""

from __future__ import annotations

from ..parallel.mesh import TENSOR, P, axis_sizes
from . import flash_attention as _flash
from . import paged_attention as _paged


def mesh_tp_degree(mesh, axis: str = TENSOR) -> int:
    """Size of the mesh's tensor axis (1 when mesh is None or the axis is
    absent): the one helper every mesh-aware dispatch and plan uses."""
    return int(axis_sizes(mesh).get(axis, 1))


def shard_cache_pages(mesh, k_pages, v_pages, *, axis: str = TENSOR):
    """This rank's kv-head block of a full ``[L, P, ps, Hkv, D]`` cache (an
    int8 cache's f32 scales on the same head axis as their data): the one
    placement rule of the engine's cache and the tests. No mesh: the pages
    as they are."""
    from .kv_quant import shard_kv

    if mesh is None:
        return k_pages, v_pages
    data, scale = P(None, None, None, axis, None), P(None, None, None, axis)
    return shard_kv(k_pages, data, scale, mesh), shard_kv(v_pages, data, scale, mesh)


def _check_heads(tp: int, name_shapes: list[tuple[str, int]]) -> None:
    for name, n in name_shapes:
        if n % tp:
            raise ValueError(
                f"{name}={n} is not divisible by the tensor-parallel degree "
                f"{tp}: head-sharded kernels need whole heads per shard"
            )


def _check_shard(mesh, axis: str, heads, local: list[tuple[str, int]]) -> int:
    """The tensor degree, after checking the global head counts divide it
    and the local shards are their ``1/tp``."""
    tp = mesh_tp_degree(mesh, axis)
    if heads is None:
        return tp
    glob = list(zip(("n_heads", "n_kv_heads"), heads))
    _check_heads(tp, glob)
    for (name, n), (_, have) in zip(glob, local):
        if have is not None and have != n // tp:
            raise ValueError(f"a local shard of {have} {name.removeprefix('n_')} is not {n}/{tp}")
    return tp


def sharded_ragged_decode(
    mesh,
    q,  # [B, Hq/tp, D]
    k_pages,  # [L, P, ps, Hkv/tp, D] array or QuantizedKV: the local shard
    v_pages,
    layer: int,
    page_tables,  # [B, pages_per_seq] int32: global page ids (P is whole)
    prefix_lens,  # [B] int32
    k_new,  # [B, Hkv/tp, D]
    v_new,
    *,
    sm_scale: float | None = None,
    heads: tuple[int, int] | None = None,
    axis: str = TENSOR,
):
    """The ragged decode (bf16 or int8 pages) on this rank's kv heads; the
    output is this rank's query heads (no sum: attention is head-local)."""
    _check_shard(mesh, axis, heads, [("n_heads", q.shape[1]), ("n_kv_heads", k_new.shape[1])])
    return _paged.paged_decode_attention_ragged(
        q, k_pages, v_pages, layer, page_tables, prefix_lens, k_new, v_new, sm_scale=sm_scale,
    )


def sharded_scatter_kv_pages(
    mesh,
    k_pages,  # [L, P, ps, Hkv/tp, D] array or QuantizedKV
    v_pages,
    k_all,  # [L, N, Hkv/tp, D]
    v_all,
    page_idx,  # [N] int32: global page ids
    slot,  # [N] int32
    *,
    heads: tuple[int, int] | None = None,
    axis: str = TENSOR,
):
    """The scatter of every layer's new rows into this rank's head columns
    of the pages (int8 pages quantize inside the shard: exact, the scales
    being per token and head)."""
    _check_shard(mesh, axis, heads, [("n_heads", None), ("n_kv_heads", k_all.shape[2])])
    return _paged.scatter_kv_pages(k_pages, v_pages, k_all, v_all, page_idx, slot)


def sharded_flash_attention(
    mesh,
    q,  # [B, Hq/tp, S, D]
    k,  # [B, Hkv/tp, S, D]
    v,
    causal: bool = True,
    *,
    heads: tuple[int, int] | None = None,
    axis: str = TENSOR,
):
    """Flash prefill attention on this rank's heads (GQA groups stay whole
    per shard): per head the same math as on one card."""
    _check_shard(mesh, axis, heads, [("n_heads", q.shape[1]), ("n_kv_heads", k.shape[1])])
    return _flash.flash_attention(q, k, v, causal)


def sharded_flash_attention_chunked(
    mesh,
    q,  # [B, Hq/tp, C, D]
    k,  # [B, Hkv/tp, S_kv, D]
    v,
    *,
    q_offset: int,
    heads: tuple[int, int] | None = None,
    axis: str = TENSOR,
):
    """Chunked-prefill flash on this rank's heads, the chunk's global
    ``q_offset`` unchanged."""
    _check_shard(mesh, axis, heads, [("n_heads", q.shape[1]), ("n_kv_heads", k.shape[1])])
    return _flash.flash_attention_chunked(q, k, v, q_offset=q_offset)


def sharded_paged_decode_attention(
    mesh,
    q,  # [B, Hq/tp, D]
    k_pages,  # [P, ps, Hkv/tp, D]: one layer's local pages (the writeback structure)
    v_pages,
    page_tables,  # [B, pages_per_seq] int32
    context_lens,  # [B] int32
    *,
    impl: str | None = None,
    heads: tuple[int, int] | None = None,
    axis: str = TENSOR,
):
    """The write-then-attend decode over this rank's heads of one layer's
    pages, the current rows already written."""
    _check_shard(mesh, axis, heads, [("n_heads", q.shape[1]), ("n_kv_heads", k_pages.shape[2])])
    return _paged.paged_decode_attention(q, k_pages, v_pages, page_tables, context_lens, impl=impl)


def sharded_write_then_attend(
    mesh,
    q,  # [B, Hq/tp, D]
    k_pages,  # [P, ps, Hkv/tp, D]: one layer's local pages
    v_pages,
    page_tables,
    context_lens,
    k_new,  # [B, Hkv/tp, D]
    v_new,
    page_idx,
    slot,
    *,
    heads: tuple[int, int] | None = None,
    axis: str = TENSOR,
):
    """The write-then-attend step (bf16 pages: the one launch of the
    folded write) over this rank's heads."""
    _check_shard(mesh, axis, heads, [("n_heads", q.shape[1]), ("n_kv_heads", k_pages.shape[2])])
    return _paged.write_then_attend(q, k_pages, v_pages, page_tables, context_lens, k_new, v_new, page_idx, slot)


def sharded_paged_verify_attention(
    mesh,
    q,  # [B, T, Hq/tp, D]
    k_pages,  # [P, ps, Hkv/tp, D]
    v_pages,
    page_tables,
    positions,  # [B, T]
    *,
    k_new=None,
    v_new=None,
    page_idx=None,
    slot=None,
    heads: tuple[int, int] | None = None,
    axis: str = TENSOR,
):
    """The verify step's attention over this rank's heads."""
    _check_shard(mesh, axis, heads, [("n_heads", q.shape[2]), ("n_kv_heads", k_pages.shape[2])])
    return _paged.paged_verify_attention(q, k_pages, v_pages, page_tables, positions, k_new=k_new, v_new=v_new,
                                         page_idx=page_idx, slot=slot)

