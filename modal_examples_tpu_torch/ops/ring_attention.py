"""Ring and Ulysses attention: context parallelism over a sequence-sharded
mesh axis of rank processes.

Counterpart of ``modal_examples_tpu/ops/ring_attention.py``. The sequence
dimension is split over a mesh axis (``seq``): rank ``i`` holds the i-th
block of the queries, keys and values.

- :func:`ring_attention`: each rank attends its queries to the K/V block it
  holds with the flash kernel (K1, with its logsumexp), merges the partial
  with the online-softmax rule (:func:`_merge`), and passes the K/V block
  one hop around the ring (``collectives.ring_shift``); after ``n`` blocks
  the result is dense attention. Causal: a rank's own block uses the
  kernel's causal mask, earlier blocks attend fully, later blocks are
  skipped (the K/V still travel). It is differentiable: the flash kernel's
  ``autograd.Function`` runs K5/K6 in the backward, and the ring shift's
  backward sends the gradients back along the ring.
- :func:`ulysses_attention`: two ``all_to_all`` exchanges turn the split
  from the sequence to the heads, so each rank runs K1 over the whole
  sequence on ``H / n`` heads, and back.

``*_sharded`` take the whole ``[B, H, S, D]`` tensors on every rank, cut
this rank's block, and return the whole output (all-gathered), as the JAX
wrappers return a global array.
"""

from __future__ import annotations

import torch

from ..parallel import collectives
from .flash_attention import flash_attention_with_lse


def _merge(o1, lse1, o2, lse2):
    """Combine two attention partials over disjoint K/V sets."""
    m = torch.maximum(lse1, lse2)
    # guard -inf (a block that saw nothing)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w1 = torch.where(torch.isfinite(lse1), torch.exp(lse1 - m_safe), torch.zeros_like(lse1))
    w2 = torch.where(torch.isfinite(lse2), torch.exp(lse2 - m_safe), torch.zeros_like(lse2))
    denom = w1 + w2
    denom_safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    o = o1.float() * (w1 / denom_safe)[..., None] + o2.float() * (w2 / denom_safe)[..., None]
    lse = torch.where(denom > 0, m_safe + torch.log(denom_safe), torch.full_like(denom, float("-inf")))
    return o.to(o1.dtype), lse


def ring_attention(q, k, v, *, axis_name: str = "seq", causal: bool = True, sm_scale: float | None = None,
                   mesh=None):
    """This rank's queries ``q`` [B, H, S_local, D] against every rank's
    keys and values, its own block ``k``/``v`` [B, Hkv, S_local, D] first.
    Returns this rank's output [B, H, S_local, D]."""
    n = collectives.axis_size(axis_name, mesh)
    me = collectives.axis_index(axis_name, mesh)
    B, H, S, _ = q.shape
    o_acc = torch.zeros_like(q)
    lse_acc = torch.full((B, H, S), float("-inf"), dtype=torch.float32, device=q.device)
    # K and V travel as one tensor: one shift a hop, so the backward's shifts
    # form one chain and every rank runs them in the same order
    kv = torch.stack([k, v])
    for step in range(n):
        kv_index = (me - step) % n  # whose K/V this rank holds this hop
        if not causal or kv_index <= me:
            o_blk, lse_blk = flash_attention_with_lse(q, kv[0], kv[1], causal=causal and kv_index == me,
                                                      sm_scale=sm_scale)
            o_acc, lse_acc = _merge(o_acc, lse_acc, o_blk, lse_blk)
        elif kv.requires_grad:
            # a skipped block still joins the backward: every rank must run
            # every hop's shift backward (a collective), with a zero gradient here
            o_acc = o_acc + 0.0 * kv.sum()
        if step < n - 1:  # one hop around the ring
            kv = collectives.ring_shift(kv, axis_name, 1, mesh)
    return o_acc


def _local_block(x, axis_name: str, mesh):
    n = collectives.axis_size(axis_name, mesh)
    if x.shape[2] % n:
        raise ValueError(f"sequence of {x.shape[2]} does not split over {n} ranks")
    return x.chunk(n, dim=2)[collectives.axis_index(axis_name, mesh)].contiguous()


def ring_attention_sharded(q, k, v, mesh, *, seq_axis: str = "seq", causal: bool = True,
                           sm_scale: float | None = None):
    """The ring over the whole ``[B, H, S, D]`` tensors: this rank's block
    of each, then the outputs all-gathered along the sequence."""
    o = ring_attention(*(_local_block(t, seq_axis, mesh) for t in (q, k, v)), axis_name=seq_axis, causal=causal,
                       sm_scale=sm_scale, mesh=mesh)
    return collectives.all_gather(o, seq_axis, gather_dim=2, mesh=mesh)


def ulysses_attention(q, k, v, *, axis_name: str = "seq", causal: bool = True, sm_scale: float | None = None,
                      mesh=None):
    """Ulysses (DeepSpeed-style) sequence parallelism over this rank's
    sequence block ``[B, H, S_local, D]``: the heads split over the ranks,
    full-sequence flash attention on ``H / n`` heads, and back."""
    n = collectives.axis_size(axis_name, mesh)
    B, H, S_loc, D = q.shape
    if H % n or k.shape[1] % n:
        raise ValueError(f"heads {H} (kv {k.shape[1]}) must be divisible by seq shards {n}")

    def seq_to_heads(x):
        h = x.shape[1]
        # [B, h, S_loc, D] -> [B, h/n, S, D]: give away head blocks, receive
        # every rank's tokens for this rank's heads (rank-major sequence)
        x = x.reshape(B, n, h // n, S_loc, D)
        x = collectives.all_to_all(x, axis_name, split_dim=1, concat_dim=2, tiled=False, mesh=mesh)
        return x.reshape(B, h // n, n * S_loc, D)

    def heads_to_seq(x):
        x = x.reshape(B, H // n, n, S_loc, D)
        x = collectives.all_to_all(x, axis_name, split_dim=2, concat_dim=1, tiled=False, mesh=mesh)
        return x.reshape(B, H, S_loc, D)

    og, _ = flash_attention_with_lse(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), causal=causal,
                                     sm_scale=sm_scale)
    return heads_to_seq(og)


def ulysses_attention_sharded(q, k, v, mesh, *, seq_axis: str = "seq", causal: bool = True,
                              sm_scale: float | None = None):
    o = ulysses_attention(*(_local_block(t, seq_axis, mesh) for t in (q, k, v)), axis_name=seq_axis, causal=causal,
                          sm_scale=sm_scale, mesh=mesh)
    return collectives.all_gather(o, seq_axis, gather_dim=2, mesh=mesh)
