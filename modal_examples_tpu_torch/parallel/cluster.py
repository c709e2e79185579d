"""Clusters and rank processes: ``@clustered(size=n)``, ``get_cluster_info()``,
``init_distributed()`` and the local launcher ``spawn_ranks``.

Counterpart of ``modal_examples_tpu/parallel/cluster.py``. The reference
co-schedules n containers (``@modal.experimental.clustered(size=2)``),
exposes ``rank`` / ``container_ips`` with rank 0 as the coordinator, and then
launches torchrun with one process per GPU and NCCL for the collectives
(14_clusters/simple_torch_cluster.py:67, :96-111, :118-130). The JAX package
drives every chip of a host from one process instead. The port goes back to
the reference's idiom: one process per card, joined by ``torch.distributed``
(NCCL between cards, gloo when the caller asks for the CPU).

The env protocol (``MTPU_CLUSTER_*``), :class:`ClusterInfo`,
:func:`in_cluster`, :func:`get_cluster_info` and :func:`clustered` are
copies. :func:`init_distributed` takes the place of
``init_jax_distributed``. :func:`spawn_ranks` and :class:`RankGang` start
one process per rank on this machine: ``@clustered``'s ``chips_per_host``
(the reference's ``torchrun --nproc-per-node``) and tensor-parallel serving
go through them. The JAX package has no launcher, because it has one
controller per host.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import traceback
from typing import Callable

RANK_ENV = "MTPU_CLUSTER_RANK"
SIZE_ENV = "MTPU_CLUSTER_SIZE"
COORD_ENV = "MTPU_CLUSTER_COORDINATOR"
IPS_ENV = "MTPU_CLUSTER_IPS"
CHIPS_ENV = "MTPU_CLUSTER_CHIPS_PER_HOST"
#: a rank process's index among its host's ranks (set by the launcher)
LOCAL_RANK_ENV = "MTPU_LOCAL_RANK"


@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    rank: int
    size: int
    container_ips: list[str]
    coordinator_address: str
    chips_per_host: int
    task_id: str | None = None


def in_cluster() -> bool:
    return RANK_ENV in os.environ


def get_cluster_info() -> ClusterInfo:
    """Inside a clustered container: this host's place in the cluster."""
    if not in_cluster():
        raise RuntimeError("get_cluster_info() called outside a @clustered container")
    return ClusterInfo(
        rank=int(os.environ[RANK_ENV]),
        size=int(os.environ[SIZE_ENV]),
        container_ips=os.environ[IPS_ENV].split(","),
        coordinator_address=os.environ[COORD_ENV],
        chips_per_host=int(os.environ.get(CHIPS_ENV, "1")),
        task_id=os.environ.get("MTPU_TASK_ID"),
    )


def clustered(size: int, chips_per_host: int | None = None) -> Callable:
    """Mark a function for gang scheduling over ``size`` containers.

    Apply *under* ``@app.function`` (like the reference stacks
    ``@app.function`` over ``@modal.experimental.clustered``,
    simple_torch_cluster.py:96-97).
    """
    if size < 1:
        raise ValueError("cluster size must be >= 1")

    def deco(fn):
        if hasattr(fn, "spec") and hasattr(fn, "raw_f"):
            raise TypeError(
                "@clustered must be applied UNDER @app.function (closest to "
                "the def), like the reference stacks them "
                "(simple_torch_cluster.py:96-97)"
            )
        fn.__mtpu_cluster__ = {"size": size, "chips_per_host": chips_per_host}
        return fn

    return deco


# -- process groups ---------------------------------------------------------------

#: this process's rank device, recorded by init_distributed
_rank: dict = {}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(
    *, device=None, backend: str | None = None, init_method: str | None = None, rank: int | None = None,
    world_size: int | None = None, timeout_s: float = 600.0,
):
    """Join this process to its process group and return its device.

    Inside a ``@clustered`` container the rank, the world size and the
    coordinator come from the env: container ``r`` of ``size``, with
    ``chips_per_host`` rank processes each, holds global ranks
    ``r * chips_per_host + local_rank``, and rank 0's container is the
    ``tcp://`` rendezvous. Elsewhere the caller passes ``rank``,
    ``world_size`` and ``init_method`` (:func:`spawn_ranks` does).

    ``device`` is the card by default: ``cuda:<local_rank % cards>``, made
    current with ``torch.cuda.set_device``, and a process without a card
    raises. Pass ``device="cpu"`` for a rank on the CPU. ``backend``
    defaults to NCCL on the card and gloo on the CPU; gloo over CUDA tensors
    is allowed (two ranks sharing one card)."""
    import torch
    import torch.distributed as dist

    local_rank = int(os.environ.get(LOCAL_RANK_ENV, "0"))
    if rank is None:
        info = get_cluster_info()
        rank = info.rank * info.chips_per_host + local_rank
        world_size = info.size * info.chips_per_host
        init_method = init_method or f"tcp://{info.coordinator_address}"
    if world_size is None or init_method is None:
        raise ValueError("init_distributed outside a cluster needs rank, world_size and init_method")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for this rank; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _rank.update(device=dev, backend=backend)
    return dev


def rank_device():
    """The device :func:`init_distributed` gave this rank."""
    if "device" not in _rank:
        raise RuntimeError("init_distributed() has not run in this process")
    return _rank["device"]


def rank_backend() -> str:
    if "backend" not in _rank:
        raise RuntimeError("init_distributed() has not run in this process")
    return _rank["backend"]


def global_mesh(axes: dict[str, int] | None = None, **kw):
    """Mesh over every rank of the process group (after
    :func:`init_distributed`)."""
    from .mesh import make_mesh

    return make_mesh(axes, **kw)


# -- the local launcher -------------------------------------------------------------


class RankFailed(RuntimeError):
    """A rank process raised or died; the gang is torn down."""


def _rank_main(rank: int, world: int, backend, device, init_method, inbox, outbox, env: dict, init: bool) -> None:
    os.environ.update(env)
    os.environ[LOCAL_RANK_ENV] = str(rank)
    try:
        if init:
            init_distributed(device=device, backend=backend, init_method=init_method, rank=rank, world_size=world)
    except BaseException:
        outbox.put((rank, False, traceback.format_exc()))
        return
    outbox.put((rank, True, "ready"))
    import torch.distributed as dist

    try:
        while True:
            job = inbox.get()
            if job is None:
                return
            fn, args = job
            try:
                out = fn(rank, *args)
            except BaseException:
                outbox.put((rank, False, traceback.format_exc()))
                return
            outbox.put((rank, True, out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankGang:
    """``world_size`` rank processes on this machine, each joined to one
    process group, that run jobs: :meth:`run` calls ``fn(rank, *args)`` on
    every rank and returns the results in rank order. A rank that raises or
    dies fails the call and tears the whole gang down (a rank blocked in a
    collective with it would wait forever), so no rank process outlives a
    failure, nor :meth:`close`.

    ``device`` is each rank's device (``"cpu"``, or ``"cuda"``: rank ``r`` on
    card ``r % cards``); ``init_method`` defaults to a ``tcp://`` port on
    localhost. ``env`` is set in every rank before it starts. ``fn`` travels
    by reference (a module-level function). ``init=False`` starts the
    processes without a process group: each sets ``MTPU_LOCAL_RANK`` and its
    job calls :func:`init_distributed` itself (a ``@clustered`` container's
    ranks, which join the ranks of the other containers)."""

    def __init__(self, world_size: int, *, backend: str | None = None, device=None, init_method: str | None = None,
                 env: dict | None = None, boot_timeout_s: float = 300.0, init: bool = True):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world_size = int(world_size)
        init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
        dev = None if device is None else str(device)
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(self.world_size)]
        self._procs = [
            ctx.Process(
                target=_rank_main, daemon=True, name=f"rank-{r}",
                args=(r, self.world_size, backend, dev, init_method, self._inboxes[r], self._outbox, dict(env or {}),
                      init),
            )
            for r in range(self.world_size)
        ]
        for p in self._procs:
            p.start()
        try:
            self._collect(boot_timeout_s, "boot")
        except BaseException:
            self.close(force=True)
            raise

    def _collect(self, timeout_s: float | None, what: str) -> list:
        import queue
        import time

        out: dict = {}
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while len(out) < self.world_size:
            try:
                rank, ok, value = self._outbox.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive() and r not in out]
                if dead:
                    code = self._procs[dead[0]].exitcode
                    self.close(force=True)
                    raise RankFailed(f"rank {dead[0]} died during {what} (exit code {code})")
                if deadline is not None and time.monotonic() > deadline:
                    self.close(force=True)
                    raise RankFailed(f"{what} did not finish on every rank within {timeout_s:g} s")
                continue
            if not ok:
                self.close(force=True)
                raise RankFailed(f"rank {rank} failed during {what}:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.world_size)]

    def run(self, fn: Callable, *args, timeout_s: float | None = None) -> list:
        if not self._procs:
            raise RuntimeError("the rank gang is closed")
        for q in self._inboxes:
            q.put((fn, args))
        return self._collect(timeout_s, getattr(fn, "__name__", "a job"))

    def close(self, *, force: bool = False) -> None:
        procs, self._procs = self._procs, []
        if not force:
            for q in self._inboxes:
                q.put(None)
            for p in procs:
                p.join(10.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)

    def __enter__(self) -> "RankGang":
        return self

    def __exit__(self, *exc) -> None:
        self.close(force=exc[0] is not None)


def spawn_ranks(fn: Callable, world_size: int, *, backend: str | None = None, device=None,
                init_method: str | None = None, args: tuple = (), env: dict | None = None,
                timeout_s: float | None = None, init: bool = True) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` rank processes joined to one
    process group (:class:`RankGang`; ``init=False``: the processes join
    none) and return the results in rank order. A rank's failure fails the
    call, and no rank process outlives it."""
    with RankGang(world_size, backend=backend, device=device, init_method=init_method, env=env,
                  init=init) as gang:
        return gang.run(fn, *args, timeout_s=timeout_s)
