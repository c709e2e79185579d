"""Named-axis collectives over a :mod:`.mesh` dimension's process group.

Counterpart of ``modal_examples_tpu/parallel/collectives.py``. The JAX
functions name a mesh axis inside ``shard_map``; these name it too, and
reduce over that axis's process group of the given mesh (the current mesh,
:func:`.mesh.current_mesh`, when none is given). Each returns a new tensor
and leaves its input as it was, as the JAX ones do.

- ``reduce_scatter`` is an all-reduce and this rank's block of it (gloo has
  no reduce-scatter): the same sums.
- ``ppermute`` (and so ``ring_shift``) is point to point: each rank sends
  its shard to its destination and receives its source's
  (``dist.batch_isend_irecv``), so a ring hop moves one block and a rank
  holds one block at a time, as ``lax.ppermute`` does. It is a
  ``torch.autograd.Function`` whose backward is the reverse permutation, so
  ring attention is differentiable. Gloo sends and receives CPU tensors
  only: a CUDA tensor over gloo raises gloo's own error.
- ``psum_tree`` sums a pytree's leaves in one all-reduce per dtype (the
  leaves flattened into one buffer, as DDP's buckets are): the data-parallel
  gradient sync.
- ``copy_to``, ``reduce_from`` and ``gather_from`` are the tensor-parallel
  regions' collectives with a gradient (``torch.autograd.Function``s; the
  serving path's forward, with no gradient to record, runs the plain ones).
  Every rank of the axis computes the same loss, so each backward hands a
  rank the gradient of its own block and no more: ``copy_to`` (the input
  of a column-parallel product) is the identity whose backward sums the
  ranks' partial gradients; ``reduce_from`` (a row-parallel sum) passes its
  gradient through unchanged; ``gather_from``'s backward takes this rank's
  block of the gradient, or, with ``sum_grad`` (a leaf gathered on use over
  an axis the batch is split on: FSDP), the block of its sum over the
  ranks, each of which took the gradient of its own rows.
- Every call is counted in :data:`counts` (op -> calls), which the card
  check reads.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from ..utils import tree as _tree
from .mesh import axis_sizes, current_mesh

AxisName = str | tuple[str, ...]

#: calls by op name, since the process started (the card check resets it)
counts: collections.Counter = collections.Counter()

def _names(axis: AxisName) -> tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def _group(axis: str, mesh):
    mesh = mesh if mesh is not None else current_mesh()
    return mesh.get_group(axis), mesh


def _reduce(x, axis: AxisName, op, mesh, name: str):
    counts[name] += 1
    out = x.clone()
    for a in _names(axis):
        g, _ = _group(a, mesh)
        dist.all_reduce(out, op=op, group=g)
    return out


def psum(x, axis: AxisName, mesh=None):
    """All-reduce sum over a mesh axis (the gradient sync of data
    parallelism; the row-parallel sum of tensor parallelism)."""
    return _reduce(x, axis, dist.ReduceOp.SUM, mesh, "psum")


def psum_tree(tree, axis: AxisName, mesh=None):
    """``psum`` of every leaf of ``tree``, in one all-reduce per dtype over
    the leaves flattened into one buffer."""
    leaves = _tree.leaves(tree)
    out = [None] * len(leaves)
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = psum(torch.cat([leaves[i].reshape(-1) for i in idx]), axis, mesh)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view_as(leaves[i])
    return _tree.unflatten(tree, out)


def pmean(x, axis: AxisName, mesh=None):
    n = axis_size(axis, mesh)
    return _reduce(x, axis, dist.ReduceOp.SUM, mesh, "pmean") / n


def pmax(x, axis: AxisName, mesh=None):
    return _reduce(x, axis, dist.ReduceOp.MAX, mesh, "pmax")


def pmin(x, axis: AxisName, mesh=None):
    return _reduce(x, axis, dist.ReduceOp.MIN, mesh, "pmin")


def _one(axis: AxisName, what: str) -> str:
    names = _names(axis)
    if len(names) != 1:
        raise NotImplementedError(f"{what} over several axes at once ({names})")
    return names[0]


def _gather_list(x, axis: str, mesh) -> list:
    g, m = _group(axis, mesh)
    parts = [torch.empty_like(x) for _ in range(axis_sizes(m)[axis])]
    dist.all_gather(parts, x.contiguous(), group=g)
    return parts


def all_gather(x, axis: AxisName, *, gather_dim: int = 0, tiled: bool = True, mesh=None):
    """Every rank's shard, concatenated along ``gather_dim`` (``tiled``) or
    stacked as a new dimension there."""
    counts["all_gather"] += 1
    parts = _gather_list(x, _one(axis, "all_gather"), mesh)
    return torch.cat(parts, dim=gather_dim) if tiled else torch.stack(parts, dim=gather_dim)


def reduce_scatter(x, axis: AxisName, *, scatter_dim: int = 0, mesh=None):
    """The sum over the axis, split along ``scatter_dim``: this rank's
    block."""
    counts["reduce_scatter"] += 1
    a = _one(axis, "reduce_scatter")
    g, m = _group(a, mesh)
    out = x.clone()
    dist.all_reduce(out, group=g)
    n = axis_sizes(m)[a]
    if out.shape[scatter_dim] % n:
        raise ValueError(f"dim {scatter_dim} of size {out.shape[scatter_dim]} does not split over {n} ranks")
    return out.chunk(n, dim=scatter_dim)[m.get_local_rank(a)].contiguous()


def all_to_all(x, axis: AxisName, *, split_dim: int, concat_dim: int, tiled: bool = True, mesh=None):
    """Split ``x`` along ``split_dim`` into one block per rank, send block
    ``j`` to rank ``j``, and concatenate what arrives along ``concat_dim``
    (``tiled``), or stack it there as a new dimension, in rank order."""
    counts["all_to_all"] += 1
    a = _one(axis, "all_to_all")
    g, m = _group(a, mesh)
    n = axis_sizes(m)[a]
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} does not split over {n} ranks")
    send = [c.contiguous() for c in x.chunk(n, dim=split_dim)]
    if not tiled:  # the untiled form consumes the split dimension (size n)
        send = [c.squeeze(split_dim) for c in send]
    recv = [torch.empty_like(c) for c in send]
    dist.all_to_all(recv, send, group=g)
    return torch.cat(recv, dim=concat_dim) if tiled else torch.stack(recv, dim=concat_dim)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: str, perm: tuple, mesh):
        ctx.axis, ctx.perm, ctx.mesh = axis, perm, mesh
        return _permute(x, axis, perm, mesh)

    @staticmethod
    def backward(ctx, dy):
        back = tuple((dst, src) for src, dst in ctx.perm)
        return _permute(dy, ctx.axis, back, ctx.mesh), None, None, None


def _permute(x, axis: str, perm: tuple, mesh):
    g, m = _group(axis, mesh)
    me = m.get_local_rank(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if src == [me]:  # a pair from this rank to itself: no exchange
        return x.clone()
    x = x.contiguous()
    recv = torch.empty_like(x) if src else torch.zeros_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(g, d), g) for d in dst]
    ops += [dist.P2POp(dist.irecv, recv, dist.get_global_rank(g, s), g) for s in src]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv


def ppermute(x, axis: AxisName, perm: list[tuple[int, int]], mesh=None):
    """Point-to-point shifts: rank ``dst`` receives the shard of rank
    ``src`` for each ``(src, dst)``; a rank that receives nothing gets zeros,
    as in JAX. Differentiable (the backward sends back along the reverse
    pairs)."""
    counts["ppermute"] += 1
    return _Permute.apply(x, _one(axis, "ppermute"), tuple(map(tuple, perm)), mesh)


def _grad_wanted(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: str, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return psum(dy, ctx.axis, ctx.mesh), None, None


def copy_to(x, axis: AxisName, mesh=None):
    """The identity; its backward sums the gradient over the axis. It marks
    a replicated input entering a column-parallel product, whose gradient
    each rank holds only its columns' share of. Without a gradient to
    record, ``x`` itself."""
    return _CopyTo.apply(x, _one(axis, "copy_to"), mesh) if _grad_wanted(x) else x


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: str, mesh):
        return psum(x, axis, mesh)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


def reduce_from(x, axis: AxisName, mesh=None):
    """``psum`` whose backward passes the gradient through unchanged: the
    row-parallel sum of partial products (every rank's partial moves the
    sum as much as the sum moves the loss)."""
    return _ReduceFrom.apply(x, _one(axis, "reduce_from"), mesh) if _grad_wanted(x) else psum(x, axis, mesh)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: str, gather_dim: int, mesh, sum_grad: bool):
        ctx.axis, ctx.dim, ctx.mesh, ctx.sum_grad = axis, gather_dim, mesh, sum_grad
        return all_gather(x, axis, gather_dim=gather_dim, mesh=mesh)

    @staticmethod
    def backward(ctx, dy):
        if ctx.sum_grad:
            return reduce_scatter(dy, ctx.axis, scatter_dim=ctx.dim, mesh=ctx.mesh), None, None, None, None
        m = ctx.mesh if ctx.mesh is not None else current_mesh()
        block = dy.chunk(axis_sizes(m)[ctx.axis], dim=ctx.dim)[m.get_local_rank(ctx.axis)]
        return block.contiguous(), None, None, None, None


def gather_from(x, axis: AxisName, *, gather_dim: int = 0, mesh=None, sum_grad: bool = False):
    """``all_gather`` (tiled) with a gradient: the backward is this rank's
    block of the incoming gradient (every rank computed the same loss from
    the gathered tensor), or with ``sum_grad`` the block of its sum over the
    axis, a reduce-scatter (each rank's loss is its own batch block's)."""
    a = _one(axis, "gather_from")
    if not _grad_wanted(x):
        return all_gather(x, a, gather_dim=gather_dim, mesh=mesh)
    return _GatherFrom.apply(x, a, gather_dim % x.dim(), mesh, sum_grad)


def ring_shift(x, axis: AxisName, shift: int = 1, mesh=None):
    """Rotate shards around the axis ring (the ring-attention step)."""
    n = axis_size(axis, mesh)
    return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)], mesh)


def axis_index(axis: AxisName, mesh=None) -> int:
    """This rank's coordinate on the axis."""
    m = mesh if mesh is not None else current_mesh()
    idx = 0
    for a in _names(axis):
        idx = idx * axis_sizes(m)[a] + m.get_local_rank(a)
    return idx


def axis_size(axis: AxisName, mesh=None) -> int:
    sizes = axis_sizes(mesh if mesh is not None else current_mesh())
    n = 1
    for a in _names(axis):
        n *= sizes[a]
    return n


def barrier(axis: AxisName, mesh=None):
    """A fence every rank of the axis must reach: a psum of ones (returns
    the axis size, as the JAX one does)."""
    m = mesh if mesh is not None else current_mesh()
    dev = m.device_type
    return psum(torch.ones((), dtype=torch.int32, device=dev), axis, m)


def unreplicate(tree):
    """First entry of every leaf along dim 0 (host-side convenience for
    logging)."""
    return _tree.map(lambda x: x[0] if getattr(x, "ndim", 0) else x, tree)
