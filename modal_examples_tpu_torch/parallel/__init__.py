"""Parallel layer: process groups, meshes, named-axis collectives, clusters.

Lazy re-exports (PEP 562), as in the JAX package: ``cluster`` imports no
torch at module load (the control plane reads its env protocol), while
``mesh`` and ``collectives`` load ``torch.distributed`` when first touched.
"""

from .cluster import ClusterInfo, clustered, get_cluster_info, init_distributed, spawn_ranks

_LAZY = {
    "AXIS_ORDER": "mesh",
    "DATA": "mesh",
    "EXPERT": "mesh",
    "FSDP": "mesh",
    "SEQ": "mesh",
    "TENSOR": "mesh",
    "P": "mesh",
    "enter_mesh": "mesh",
    "fsdp_specs": "mesh",
    "make_mesh": "mesh",
    "shard_tensor": "mesh",
    "shard_pytree": "mesh",
    "single_device_mesh": "mesh",
    "collectives": None,
    "mesh": None,
    "cluster": None,
}

__all__ = [
    "ClusterInfo",
    "clustered",
    "get_cluster_info",
    "init_distributed",
    "spawn_ranks",
    *sorted(_LAZY),
]


def __getattr__(name: str):
    import importlib

    if name in _LAZY:
        target = _LAZY[name]
        if target is None:
            mod = importlib.import_module(f".{name}", __name__)
            globals()[name] = mod
            return mod
        mod = importlib.import_module(f".{target}", __name__)
        value = getattr(mod, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
