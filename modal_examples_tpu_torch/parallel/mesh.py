"""Device meshes over ``torch.distributed``: named axes and placements.

Counterpart of ``modal_examples_tpu/parallel/mesh.py``. The JAX package
builds one ``jax.sharding.Mesh`` over every chip from one controller and
lets XLA insert the collectives. Here each rank is a process
(:func:`~.cluster.init_distributed`), the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the same named axes in the
same canonical order (:data:`AXIS_ORDER`), and each axis is a process group
that :mod:`.collectives` reduces over by name.

A placement is a :class:`P`: one entry per tensor dimension, an axis name
(or a tuple of names) where that dimension is split over the axis, ``None``
where it is whole, as a JAX ``PartitionSpec``. A rank holds only its local
slice of a placed tensor (:func:`shard_tensor`, :func:`shard_pytree`), in
place of ``sharding``/``replicated``/``device_put``: nothing holds the global
array.

A placement tree (``param_specs``) mirrors the parameter tree. The port
keeps a model's layers as a list of per-layer dicts where the JAX tree
stacks them on a leading axis, so a spec tree written for the stacked tree
(``llama.partition_specs``, one ``P`` per stacked leaf) applies to every
layer of the list with that leading entry dropped (:func:`specs_for`).

``with enter_mesh(mesh):`` is ``with mesh:`` of the JAX package: code that
is given no mesh (``llama.forward`` inside a loss function) takes the
entered one (:func:`entered_mesh`). ``shard_map_compat`` has no
counterpart: every rank already runs its own program on its local shards,
which is what ``shard_map`` does.
"""

from __future__ import annotations

import contextlib
import math
import threading

from ..utils import tree as _tree

# Canonical axis names, in the JAX package's order: earlier axes vary
# slowest over the ranks, so tensor and seq land on neighbouring ranks (the
# fastest links of a host).
DATA = "data"
FSDP = "fsdp"
TENSOR = "tensor"
SEQ = "seq"
EXPERT = "expert"
AXIS_ORDER = (DATA, FSDP, EXPERT, SEQ, TENSOR)


class P(tuple):
    """A placement: ``P("tensor", None)`` splits dim 0 over ``tensor``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def resolve_axes(axes: dict[str, int] | None, n_devices: int) -> dict[str, int]:
    """Resolve an axis spec against a rank count. One axis may be -1
    (fill); an omitted spec means pure data parallelism."""
    if not axes:
        return {DATA: n_devices}
    axes = dict(axes)
    fill_keys = [k for k, v in axes.items() if v == -1]
    if len(fill_keys) > 1:
        raise ValueError(f"only one axis may be -1, got {fill_keys}")
    fixed = math.prod(v for v in axes.values() if v != -1)
    if fill_keys:
        if n_devices % fixed:
            raise ValueError(f"device count {n_devices} not divisible by fixed axes {axes}")
        axes[fill_keys[0]] = n_devices // fixed
    elif fixed != n_devices:
        raise ValueError(f"axes {axes} multiply to {fixed}, but mesh has {n_devices} devices")
    return axes


_current: dict = {}


def make_mesh(axes: dict[str, int] | None = None, *, spec=None, device_type: str | None = None):
    """A named ``DeviceMesh`` over every rank of the process group.

    ``axes`` maps axis name -> size (one may be -1 to fill; none means
    ``{"data": world_size}``), ordered canonically. ``spec`` (``"H100:2"``
    or a :class:`GPUSpec`) checks the request against the world size.
    ``device_type`` defaults to this rank's device. The mesh becomes the
    current one (:func:`current_mesh`), which the collectives use when they
    are given no mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .cluster import rank_device

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call parallel.cluster.init_distributed() first")
    n = dist.get_world_size()
    if spec is not None:
        if isinstance(spec, str):
            from ..core.resources import parse_gpu_spec

            spec = parse_gpu_spec(spec)
        if spec.count != n:
            raise ValueError(f"gpu spec {spec} wants {spec.count} cards but the process group has {n} ranks")
    resolved = resolve_axes(axes, n)
    names = sorted(resolved, key=lambda a: AXIS_ORDER.index(a) if a in AXIS_ORDER else len(AXIS_ORDER))
    shape = tuple(resolved[a] for a in names)
    mesh = init_device_mesh(device_type or rank_device().type, shape, mesh_dim_names=tuple(names))
    _current["mesh"] = mesh
    return mesh


def current_mesh():
    """The mesh :func:`make_mesh` built last in this process."""
    if "mesh" not in _current:
        raise RuntimeError("no mesh: call parallel.mesh.make_mesh() first")
    return _current["mesh"]


def single_device_mesh():
    """A one-rank ``data`` mesh (a process group of one)."""
    return make_mesh({DATA: 1})


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a mesh (empty for None)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


_entered = threading.local()


@contextlib.contextmanager
def enter_mesh(mesh):
    """Make ``mesh`` the entered mesh of this thread for the block (JAX's
    ``with mesh:``); ``None`` enters nothing."""
    stack = _entered.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def entered_mesh():
    """The innermost mesh entered on this thread (:func:`enter_mesh`), or
    None."""
    stack = getattr(_entered, "stack", None)
    return stack[-1] if stack else None


def _is_layer_list(node) -> bool:
    return isinstance(node, (list, tuple)) and bool(node) and all(isinstance(x, dict) for x in node)


def fsdp_specs(params, mesh, *, axis: str = FSDP, min_size: int = 2**12):
    """ZeRO-3/FSDP placements for a parameter tree: every leaf of at least
    ``min_size`` elements is split over ``axis`` along its largest
    axis-divisible dimension; small leaves (norms, biases) stay whole. The
    rule of the JAX package's ``fsdp_specs``, read on the JAX tree's sizes:
    a leaf of a list of layer dicts counts as the layer-stacked leaf the JAX
    tree holds (its size times the number of layers), so both packages
    place the same leaves (a norm of Llama-3.2-1B's 16 layers is 16 x 2048
    elements there, and split). The layer axis itself is never split: each
    layer is a leaf of its own here. The returned tree mirrors ``params``."""
    n = axis_sizes(mesh)[axis]

    def spec_for(leaf, stacked: int):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape or stacked * math.prod(shape) < min_size:
            return P()
        for d in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
            if shape[d] % n == 0:
                return P(*(axis if i == d else None for i in range(len(shape))))
        return P()

    def walk(node, stacked: int):
        if isinstance(node, dict):
            return {k: walk(v, stacked) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            inner = stacked * len(node) if _is_layer_list(node) else stacked
            return type(node)(walk(v, inner) for v in node)
        return spec_for(node, stacked)

    return walk(params, 1)


def specs_for(params, specs):
    """A placement tree with the structure of ``params``: ``specs`` itself
    where it mirrors the tree, and where ``params`` holds a list of layer
    dicts but ``specs`` one dict of layer-stacked placements (the JAX
    tree's layout), that dict's placements with their leading (layer)
    entry dropped, for every layer. A stacked placement that splits the
    layer axis raises, as does a structure that matches neither way."""

    def walk(node, spec, path):
        if isinstance(spec, P):
            if isinstance(node, (dict, list, tuple)):
                raise ValueError(f"{'/'.join(map(str, path)) or 'the tree'}: a placement {spec!r} for a subtree")
            if len(spec) > len(tuple(getattr(node, "shape", ()))):
                raise ValueError(f"{'/'.join(map(str, path))}: {spec!r} has more entries than the leaf's "
                                 f"{len(node.shape)} dimensions")
            return spec
        if isinstance(node, dict) and isinstance(spec, dict):
            if set(node) != set(spec):
                raise ValueError(f"{'/'.join(map(str, path)) or 'the tree'}: placements for {sorted(spec)}, "
                                 f"leaves {sorted(node)}")
            return {k: walk(v, spec[k], path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and isinstance(spec, (list, tuple)) and len(node) == len(spec):
            return type(node)(walk(v, s, path + (i,)) for i, (v, s) in enumerate(zip(node, spec)))
        if _is_layer_list(node) and isinstance(spec, dict):
            per_layer = {k: _unstacked(s, path + (k,)) for k, s in spec.items()}
            return type(node)(walk(v, per_layer, path + (i,)) for i, v in enumerate(node))
        raise ValueError(f"{'/'.join(map(str, path)) or 'the tree'}: placements {type(spec).__name__} do not match "
                         f"{type(node).__name__}")

    return walk(params, specs, ())


def _unstacked(spec, path) -> P:
    if not isinstance(spec, P):
        raise ValueError(f"{'/'.join(map(str, path))}: a stacked layer placement must be a P, not {spec!r}")
    if not spec or spec[0] is None:
        return P(*spec[1:])
    raise ValueError(f"{'/'.join(map(str, path))}: {spec!r} splits the stacked layer axis, which is a list here")


def spec_leaves(specs) -> list:
    """The placements of a placement tree, in the leaf order of the tree it
    mirrors (a ``P`` is a tuple, but a leaf here)."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in spec_leaves(v)]
    if isinstance(specs, (list, tuple)):
        return [s for v in specs for s in spec_leaves(v)]
    raise ValueError(f"a placement tree holds P leaves, not {specs!r}")


def _axis_rank_and_size(mesh, entry) -> tuple[int, int]:
    names = entry if isinstance(entry, tuple) else (entry,)
    sizes = axis_sizes(mesh)
    index, size = 0, 1
    for name in names:  # the first name varies slowest, as in a PartitionSpec
        index = index * sizes[name] + mesh.get_local_rank(name)
        size *= sizes[name]
    return index, size


def local_slice(shape: tuple, spec: P, mesh) -> tuple:
    """The index (a tuple of slices) of this rank's block of a tensor of
    ``shape`` placed by ``spec``; a split that does not divide raises."""
    idx = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            idx.append(slice(None))
            continue
        r, size = _axis_rank_and_size(mesh, entry)
        if n % size:
            raise ValueError(f"dim {d} of size {n} does not split over {entry!r} ({size} ranks)")
        step = n // size
        idx.append(slice(r * step, (r + 1) * step))
    return tuple(idx)


def shard_tensor(t, spec: P, mesh):
    """This rank's block of ``t`` under ``spec``, contiguous (a copy the
    size of the block, so the whole tensor can be freed)."""
    if mesh is None or not any(e is not None for e in spec):
        return t
    return t[local_slice(tuple(t.shape), spec, mesh)].contiguous()


def shard_pytree(tree, mesh, specs):
    """Every leaf's local block, as the JAX ``shard_pytree`` places them
    with ``device_put``: placed by ``specs(path, leaf)`` when ``specs`` is
    a function (``path`` is the leaf's key path as a tuple), else by the
    placement tree ``specs`` (:func:`specs_for`)."""
    if not callable(specs):
        placed = spec_leaves(specs_for(tree, specs))
        return _tree.unflatten(tree, [shard_tensor(t, s, mesh) for t, s in zip(_tree.leaves(tree), placed)])

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,)) for i, v in enumerate(node))
        return shard_tensor(node, specs(path, node), mesh)

    return walk(tree, ())
