"""KV-page transport: the MTKV1 wire format for migrating paged-KV blocks,
after ``modal_examples_tpu/serving/disagg/transport.py`` and byte-compatible
with it.

A finished prefill is a set of physical pages in the prefill replica's
:class:`~..kv_cache.PagedKVCache` plus its sampler state (position, first
token, seed). This module turns that into bytes and back:

- :func:`wire_leaves` names every device leaf of the cache as the JAX
  package's pytree paths do, in its flatten order: ``k_pages`` and
  ``v_pages`` over bf16 pages; ``k_pages.data``, ``k_pages.scale``,
  ``v_pages.data`` and ``v_pages.scale`` over :class:`QuantizedKV`. The
  names come from the cache's dataclass fields, so a new leaf shows up here
  without this module changing.
- :func:`extract_pages` gathers ``leaf[:, ids]`` on the device (the page
  axis is axis 1 on every leaf) and makes one device-to-host copy per leaf
  (into pinned memory on the card), into a :class:`PageBlock` of CPU tensors.
- :func:`serialize_block` / :func:`deserialize_block`: magic, a JSON header
  (leaf specs with a crc32 each, block hashes, sampler meta) and the raw
  leaf bytes. bf16 leaves travel as their raw 2-byte bits under the dtype
  name ``"bfloat16"`` (through ``view(torch.uint16)`` one way and
  ``torch.frombuffer(...).view(torch.bfloat16)`` the other, never through
  numpy, which has no bf16 without ``ml_dtypes``); int8 blocks ship the int8
  payload and the f32 scale rows as stored, so adoption is bit-exact. The
  envelope is built with one copy and read with none (the leaves view the
  wire bytes, read-only), and every crc32 runs on a buffer view, where
  ``zlib`` releases the GIL: a block of hundreds of MB must not hold the
  interpreter for long while a decode scheduler shares the process.
- :func:`iter_chunks` / :class:`ChunkAssembler` / :func:`transfer`: chunked
  streaming with a crc32 per chunk and resumable retry by sequence number
  (:class:`LoopbackChannel` is the in-process channel).
- :func:`adopt_pages` writes a received block into freshly allocated pages
  of the destination cache with ``index_copy_`` along the page axis, from
  pinned host staging, on the current stream. The engine calls it on its
  scheduler thread, so the write is ordered against the decode block in
  flight on the same stream.

A live-migrated mid-decode request ships through the same envelope with
``meta["resume"] = {"generated": [...], "emitted_len": n}``, a purely
additive meta field: a plain first-token block decodes and adopts as before.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import queue
import struct
import time
import warnings
import zlib

import torch

from ...core.retries import Retries
from ...faults import inject as _inject
from ...observability import metrics as _obs
from ...observability import reqtrace as _rt
from ...ops.kv_quant import QuantizedKV
from ..health import transfers as _transfer_watermarks

#: envelope magic + version (bump on any layout change)
_MAGIC = b"MTKV1\n"
#: default chunk payload size: one lost chunk is cheap to resend, and the
#: header overhead stays noise
DEFAULT_CHUNK_BYTES = 256 * 1024

#: backoff between chunk-retry rounds: short (a round is a loopback or pipe
#: re-send, not a network call) and jittered per transfer id, so transfers
#: over one flaky channel do not re-send in lockstep
DEFAULT_RETRY_BACKOFF = Retries(max_retries=8, initial_delay=0.01, max_delay=0.25, jitter=0.5)

#: wire dtype name <-> torch dtype (the names numpy and the JAX package use)
_WIRE_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "int8": torch.int8,
}
_DTYPE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


class TransportError(RuntimeError):
    """Corrupt, incomplete, or incompatible wire data."""


class TransferAborted(TransportError):
    """The transfer's ``should_abort`` tripped mid-stream (client abort or
    deadline while chunks were in flight)."""


# -- cache fields <-> named leaves --------------------------------------------


def wire_leaves(cache) -> list:
    """``[(name, tensor)]`` for every device leaf of the cache, in the JAX
    package's flatten order: the dataclass fields that hold tensors, and the
    fields of the :class:`QuantizedKV` that hold an int8 cache's pages."""
    out = []
    for field in dataclasses.fields(cache):
        value = getattr(cache, field.name)
        if isinstance(value, torch.Tensor):
            out.append((field.name, value))
        elif isinstance(value, QuantizedKV):
            for sub in dataclasses.fields(value):
                out.append((f"{field.name}.{sub.name}", getattr(value, sub.name)))
    return out


@dataclasses.dataclass
class PageBlock:
    """``n`` cache pages of every leaf, on the host as CPU tensors.

    ``leaves[name]`` has the page axis (axis 1) cut down to the block's
    pages, in page-table order. ``block_hashes`` are the chained content
    hashes of the full prompt pages these pages hold; ``meta`` carries the
    sampler state the decode side continues from (position, first token,
    prompt token ids, seed)."""

    leaves: dict
    page_size: int
    kv_dtype: str
    block_hashes: list = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def n_pages(self) -> int:
        first = next(iter(self.leaves.values()))
        return int(first.shape[1])

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.leaves.values())


def extract_pages(cache, page_ids: list, *, block_hashes=None, meta=None) -> PageBlock:
    """Copy ``page_ids`` out of every cache leaf: one gather on the device
    and one device-to-host copy per leaf. Every leaf's page axis is axis 1
    (``[L, P, page_size, Hkv, D]`` for data, ``[L, P, page_size, Hkv]`` for
    int8 scale rows), so one expression covers them all."""
    leaves = {}
    named = wire_leaves(cache)
    ids = torch.tensor([int(p) for p in page_ids], dtype=torch.long, device=named[0][1].device)
    for name, leaf in named:
        if leaf.shape[1] != cache.n_pages:
            raise TransportError(
                f"cache leaf {name!r} does not have the page axis at axis 1 (shape {tuple(leaf.shape)}); "
                "the wire codec needs updating"
            )
        rows = leaf.index_select(1, ids)
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=rows.is_cuda)
        leaves[name] = host.copy_(rows)
    return PageBlock(
        leaves=leaves, page_size=cache.page_size, kv_dtype=cache.kv_dtype,
        block_hashes=list(block_hashes or []), meta=dict(meta or {}),
    )


def adopt_pages(cache, block: PageBlock, page_ids: list) -> None:
    """Write ``block`` into ``page_ids`` of the destination cache, leaf by
    leaf (the receive side of :func:`extract_pages`): ``index_copy_`` along
    the page axis, in place, from pinned host staging on the card. Run it on
    the thread and stream that own the cache (the decode engine's scheduler
    thread), so the write queues behind the block in flight."""
    if block.kv_dtype != cache.kv_dtype:
        raise TransportError(
            f"kv_dtype mismatch: block is {block.kv_dtype}, destination cache is {cache.kv_dtype}: "
            "replicas must serve one cache dtype"
        )
    if block.page_size != cache.page_size:
        raise TransportError(f"page_size mismatch: block {block.page_size} vs cache {cache.page_size}")
    if len(page_ids) != block.n_pages:
        raise TransportError(f"adopting {block.n_pages} pages into {len(page_ids)} page ids")
    named = wire_leaves(cache)
    if {name for name, _ in named} != set(block.leaves):
        raise TransportError(f"leaf set mismatch: wire {sorted(block.leaves)} vs cache {sorted(n for n, _ in named)}")
    device = named[0][1].device
    on_card = device.type == "cuda"
    ids = torch.tensor([int(p) for p in page_ids], dtype=torch.long)
    if on_card:
        ids = ids.pin_memory().to(device, non_blocking=True)
    for name, leaf in named:
        data = torch.as_tensor(block.leaves[name])
        want = (leaf.shape[0], len(page_ids), *leaf.shape[2:])
        if data.dtype != leaf.dtype or tuple(data.shape) != want:
            raise TransportError(
                f"leaf {name!r} is {data.dtype} {tuple(data.shape)}, the cache wants {leaf.dtype} {want}"
            )
        if on_card:
            # the caching host allocator keeps the pinned buffer alive until
            # the copy queued from it has run
            data = data.pin_memory().to(device, non_blocking=True)
        leaf.index_copy_(1, ids, data)


# -- block (de)serialization -------------------------------------------------


def _leaf_bytes(t) -> tuple[str, list, memoryview]:
    """(wire dtype name, shape, a byte view) of one host leaf: bf16 as its
    2-byte bit patterns, never as a numpy bf16."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    name = _DTYPE_NAMES.get(t.dtype)
    if name is None:
        raise TransportError(f"no wire dtype for {t.dtype}")
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return name, list(t.shape), memoryview(raw.numpy()).cast("B")


def serialize_block(block: PageBlock) -> bytes:
    """Envelope: ``MTKV1\\n`` + u32 header length + JSON header + raw leaf
    bytes in header order. Each leaf records dtype, shape and crc32, so a
    flipped byte is a loud :class:`TransportError`, never silent KV
    corruption."""
    specs, views = [], []
    for name in sorted(block.leaves):
        dtype, shape, buf = _leaf_bytes(block.leaves[name])
        specs.append({"name": name, "dtype": dtype, "shape": shape, "crc32": zlib.crc32(buf) & 0xFFFFFFFF,
                      "nbytes": buf.nbytes})
        views.append(buf)
    header = json.dumps(
        {
            "version": 1,
            "page_size": block.page_size,
            "kv_dtype": block.kv_dtype,
            "block_hashes": list(block.block_hashes),
            "meta": block.meta,
            "leaves": specs,
        }
    ).encode()
    # the payload's one copy: the leaves' views joined behind the header
    return b"".join([_MAGIC, struct.pack("<I", len(header)), header, *views])


def deserialize_block(data: bytes) -> PageBlock:
    """The inverse of :func:`serialize_block`: every leaf a CPU tensor over
    the wire bytes themselves (no copy; read-only, as ``data`` is), bf16
    read as raw bits through ``torch.frombuffer``."""
    if data[: len(_MAGIC)] != _MAGIC:
        raise TransportError("bad magic: not a KV page block")
    off = len(_MAGIC)
    if len(data) < off + 4:
        raise TransportError("truncated block: no header length")
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    try:
        header = json.loads(data[off : off + hlen])
    except (ValueError, UnicodeDecodeError) as e:
        raise TransportError(f"corrupt block header: {e}") from e
    off += hlen
    view = memoryview(data)
    leaves = {}
    for spec in header["leaves"]:
        buf = view[off : off + spec["nbytes"]]
        if len(buf) != spec["nbytes"]:
            raise TransportError(
                f"truncated block: leaf {spec['name']!r} short by {spec['nbytes'] - len(buf)} bytes"
            )
        if (zlib.crc32(buf) & 0xFFFFFFFF) != spec["crc32"]:
            raise TransportError(f"crc mismatch on leaf {spec['name']!r}")
        dtype = _WIRE_DTYPES.get(spec["dtype"])
        if dtype is None:
            raise TransportError(f"unknown wire dtype {spec['dtype']!r} on leaf {spec['name']!r}")
        if spec["nbytes"]:
            with warnings.catch_warnings():
                # a bytes object is not writable: the leaves are only read
                warnings.simplefilter("ignore", UserWarning)
                flat = torch.frombuffer(data, dtype=torch.uint8, count=spec["nbytes"], offset=off)
        else:
            flat = torch.empty(0, dtype=torch.uint8)
        leaves[spec["name"]] = flat.view(dtype).reshape(spec["shape"])
        off += spec["nbytes"]
    return PageBlock(
        leaves=leaves,
        page_size=int(header["page_size"]),
        kv_dtype=str(header["kv_dtype"]),
        block_hashes=list(header["block_hashes"]),
        meta=dict(header["meta"]),
    )


# -- prefix block hashing ----------------------------------------------------


def chain_hashes(tokens: list, page_size: int) -> list:
    """Chained content hash per FULL page of ``tokens``: ``h_i =
    sha256(h_{i-1} || page_i tokens)``. Position-dependent by construction,
    so the same 16 tokens at different prompt depths never collide — the
    tiered prefix cache's key, and the trie's page identity on the wire."""
    out = []
    prev = b""
    n_full = len(tokens) // page_size
    for i in range(n_full):
        page = tokens[i * page_size : (i + 1) * page_size]
        h = hashlib.sha256(
            prev + b"," + b",".join(str(int(t)).encode() for t in page)
        ).digest()
        out.append(h.hex())
        prev = h
    return out


# -- chunked streaming with resumable retry ----------------------------------


def iter_chunks(
    payload: bytes, transfer_id: str, chunk_bytes: int = DEFAULT_CHUNK_BYTES
) -> list:
    """Split ``payload`` into picklable chunk tuples
    ``("kv_chunk", transfer_id, seq, total, crc32, bytes)``."""
    chunk_bytes = max(1, int(chunk_bytes))
    total = max(1, -(-len(payload) // chunk_bytes))
    out = []
    for seq in range(total):
        piece = payload[seq * chunk_bytes : (seq + 1) * chunk_bytes]
        out.append(
            (
                "kv_chunk",
                transfer_id,
                seq,
                total,
                zlib.crc32(piece) & 0xFFFFFFFF,
                piece,
            )
        )
    return out


class ChunkAssembler:
    """Receive side: collect chunks, detect gaps/corruption, reassemble.

    ``add`` drops corrupt chunks (crc mismatch) and records them as missing
    so the sender's next round re-sends exactly those — resumable retry at
    chunk granularity."""

    def __init__(self, transfer_id: str):
        self.transfer_id = transfer_id
        self.total: int | None = None
        self._chunks: dict[int, bytes] = {}
        self.corrupt = 0

    def add(self, chunk) -> bool:
        """Returns True when the chunk was accepted (valid + ours)."""
        kind, tid, seq, total, crc, piece = chunk
        if kind != "kv_chunk" or tid != self.transfer_id:
            return False
        if self.total is None:
            self.total = int(total)
        if (zlib.crc32(piece) & 0xFFFFFFFF) != crc:
            self.corrupt += 1
            return False
        self._chunks[int(seq)] = piece
        return True

    @property
    def complete(self) -> bool:
        return self.total is not None and len(self._chunks) == self.total

    def missing(self) -> list:
        if self.total is None:
            return []
        return [s for s in range(self.total) if s not in self._chunks]

    def payload(self) -> bytes:
        if not self.complete:
            raise TransportError(
                f"transfer {self.transfer_id}: missing chunks {self.missing()}"
            )
        return b"".join(self._chunks[s] for s in range(self.total))


class LoopbackChannel:
    """In-process chunk channel (the inline-executor shape): ``send``
    enqueues, ``recv`` drains. The seam where a cross-process pipe sits in
    the process executor — and where tests inject corruption, drops, and
    replica death."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()

    def send(self, chunk) -> None:
        self._q.put(chunk)

    def recv(self, block: bool = False, timeout: float | None = None):
        return self._q.get(block=block, timeout=timeout)


def _mangle(chunk):
    """A corrupted copy of ``chunk``: payload bytes flipped, crc left
    STALE — exactly the wire damage the assembler must catch."""
    kind, tid, seq, total, crc, piece = chunk
    bad = piece[:-1] + bytes([piece[-1] ^ 0xFF]) if piece else piece
    return (kind, tid, seq, total, crc, bad)


def transfer(
    payload: bytes,
    channel,
    *,
    transfer_id: str,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    max_rounds: int = 3,
    should_abort=None,
    backoff: Retries | None = DEFAULT_RETRY_BACKOFF,
) -> bytes:
    """Stream ``payload`` through ``channel`` and reassemble it: send every
    pending chunk, drain what arrived, re-send only the gaps. Raises
    :class:`TransferAborted` the moment ``should_abort()`` trips (checked
    between chunks, so an abort never waits for the tail of a large block)
    and :class:`TransportError` when ``max_rounds`` can't complete the set.

    Retry rounds wait ``backoff.delay_for_attempt(round, key=transfer_id)``
    between attempts — jittered so concurrent transfers over one flaky
    channel don't re-send in lockstep; ``max_rounds`` x those delays bounds
    the retry budget. ``backoff=None`` retries immediately (tests).

    Fault points (docs/faults.md): ``disagg.replica_death`` kills the
    stream mid-transfer, ``disagg.chunk_drop`` swallows one chunk,
    ``disagg.chunk_corrupt`` flips payload bytes under a stale crc, and
    ``disagg.transfer_stall`` holds the sender between chunks WITHOUT an
    error — the gray failure only the progress watchdog can see.

    Progress watermarks (serving/health.py, docs/health.md): the transfer
    registers in the process-wide :data:`~..health.transfers` registry and
    advances its sequence watermark per chunk sent; the fleet watchdog
    aborts a transfer whose watermark goes stale, which surfaces HERE as a
    :class:`TransportError` between chunks — the coordinator's unified
    fallback then re-prefills on the decode side, so a silently stalled
    wire never hangs a request to its deadline.
    """
    chunks = iter_chunks(payload, transfer_id, chunk_bytes)
    asm = ChunkAssembler(transfer_id)
    pending = list(range(len(chunks)))
    _transfer_watermarks.begin(transfer_id)
    try:
        for round_i in range(max(1, int(max_rounds))):
            if round_i and pending:
                _obs.record_disagg_chunk_retries(len(pending))
                if backoff is not None:
                    delay = backoff.delay_for_attempt(round_i, key=transfer_id)
                    # retry backoff as a span event on the ambient request
                    # (the coordinator scopes the migration's trace frame
                    # around this call — docs/observability.md)
                    _rt.ambient_event(
                        "retry_wait", round=round_i, pending=len(pending),
                        delay_s=round(delay, 6),
                    )
                    time.sleep(delay)
            for seq in pending:
                if should_abort is not None and should_abort():
                    raise TransferAborted(f"transfer {transfer_id} aborted")
                if _transfer_watermarks.abort_requested(transfer_id):
                    raise TransportError(
                        f"transfer {transfer_id}: aborted by the progress "
                        "watchdog (stalled between chunks)"
                    )
                _inject.check(
                    "disagg.replica_death",
                    ConnectionError,
                    f"injected: peer died mid-transfer {transfer_id}",
                )
                if _inject.fire("disagg.transfer_stall"):
                    # gray failure: the sender goes quiet between chunks —
                    # no exception, no closed channel, the peer just never
                    # sees the next seq. Only an abort (the watchdog's
                    # stalled-watermark ladder, or the caller's own
                    # abort/deadline) lifts the stall.
                    while not _transfer_watermarks.abort_requested(
                        transfer_id
                    ) and not (should_abort is not None and should_abort()):
                        time.sleep(0.005)
                    if should_abort is not None and should_abort():
                        raise TransferAborted(
                            f"transfer {transfer_id} aborted"
                        )
                    raise TransportError(
                        f"transfer {transfer_id}: aborted by the progress "
                        "watchdog (stalled between chunks)"
                    )
                if _inject.fire("disagg.chunk_drop"):
                    continue  # the chunk vanishes; the next round re-sends it
                chunk = chunks[seq]
                if _inject.fire("disagg.chunk_corrupt"):
                    chunk = _mangle(chunk)
                # per-chunk span (child of the ambient transfer span): a dead
                # channel mid-send still closes it with status=error
                sp = _rt.begin_ambient(
                    "chunk", seq=seq, nbytes=len(chunk[5]), round=round_i
                )
                try:
                    channel.send(chunk)
                except BaseException:
                    _rt.finish_ambient(sp, status="error")
                    raise
                _rt.finish_ambient(sp)
                _transfer_watermarks.progress(transfer_id, seq)
            while True:
                try:
                    received = channel.recv(block=False)
                except queue.Empty:
                    break
                asm.add(received)
            if asm.complete:
                return asm.payload()
            pending = asm.missing()
        raise TransportError(
            f"transfer {transfer_id}: {len(asm.missing())} chunks still "
            f"missing after {max_rounds} rounds ({asm.corrupt} corrupt)"
        )
    finally:
        _transfer_watermarks.end(transfer_id)
