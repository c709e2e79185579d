"""The engine's device calls, behind one runner; under tensor parallelism,
rank 0's runner ships each call to the follower ranks before it launches.

The JAX engine drives every chip from one controller: its jitted prefill,
chunk and decode-block programs run under a mesh and XLA inserts the
collectives. Here each rank is a process (``parallel.cluster``), so the
engine's scheduler runs on rank 0 only: scheduling, admission, deadlines,
page accounting and the pipelined loop are decided there, exactly as on one
card. What reaches the card goes through :class:`ModelRunner`:

- ``prefill`` (a batched prefill and its first tokens' sampling),
  ``prefill_chunk`` and ``sample_first`` (a sliced prompt),
  ``replay_step`` (a resumed request's generated prefix) and
  ``decode_block`` (a block's decode and sampling steps, the tokens fed
  forward on the device).
- Rank 0's engine first broadcasts its resolved settings (the config, the
  weights' source, the cache's size and dtype, the decode structure, the
  seed) over a gloo group (:func:`control_group`, :func:`share_settings`),
  and every follower builds its shards and cache from them, so no rank
  resolves a default or an environment variable of its own.
- On rank 0 each call first broadcasts its name and its host inputs (numpy
  arrays and scalars) to the followers over that group, then runs.
- A follower (:func:`follow`) runs the same call on its shards and joins the
  collectives. It reads no clock and decides nothing. The logits are
  all-gathered, so every rank holds the same logits; the keys are threefry
  in integer tensors, advanced once a call on every rank; so every rank
  draws the same tokens and feeds the same ones forward, and only rank 0
  reads them.

With no mesh the runner runs each call and ships nothing: the one-card
engine's path. The launcher and the follower loop have no counterpart in
the JAX package, which has one controller.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..models import llama
from ..ops.sharded import mesh_tp_degree
from ..parallel.mesh import TENSOR
from .sampling import block_noise, prng_key, sample, split


def _digest(args: tuple) -> str:
    """A short digest of a call's host inputs (the follower journal)."""
    h = hashlib.sha1()
    for a in args:
        h.update(a.tobytes() if isinstance(a, np.ndarray) else repr(a).encode())
    return h.hexdigest()[:16]


def control_group(mesh) -> tuple:
    """``(group, src)``: the gloo group over a mesh's ``tensor`` axis that
    carries rank 0's settings and calls, and the global rank of the axis's
    rank 0; ``(None, None)`` with no mesh or a one-wide axis. Every rank of
    the axis makes it, in the same order."""
    if mesh_tp_degree(mesh) <= 1:
        return None, None
    import torch.distributed as dist

    group = mesh.get_group(TENSOR)
    ranks = dist.get_process_group_ranks(group)
    if len(ranks) != dist.get_world_size():
        raise NotImplementedError(
            "tensor-parallel serving over a part of the ranks (a mesh with another axis wider than 1) is "
            "not ported (ROADMAP A10b)"
        )
    # host messages ride a gloo group of their own, whatever the collectives' backend
    ctrl = group if dist.get_backend(group) == "gloo" else dist.new_group(ranks, backend="gloo")
    return ctrl, ranks[0]


def share_settings(settings: dict | None, control: tuple) -> dict:
    """Rank 0's resolved engine ``settings`` on every rank of the control
    group (a follower passes None and gets rank 0's)."""
    import torch.distributed as dist

    box = [settings]
    dist.broadcast_object_list(box, src=control[1], group=control[0])
    return box[0]


class ModelRunner:
    """The device half of an engine (module docstring): the weights, the
    paged cache, the key chain and, for the decode loop, the last block's
    tokens on the device. ``mesh`` with a ``tensor`` axis makes rank 0 the
    leader of the axis's other ranks. ``journal`` (a list) records every
    call run, as ``(name, digest of its host inputs)``."""

    def __init__(self, cfg, params: dict, cache, *, device, seed: int, decode_block: int, paged_impl: str,
                 scatter_impl: str, mesh=None, control: tuple | None = None, journal: list | None = None):
        self.cfg, self.params, self.cache, self.device = cfg, params, cache, device
        self.block = decode_block  # a decode block's steps (its step keys)
        self.paged_impl, self.scatter_impl = paged_impl, scatter_impl
        self.mesh = mesh
        self.tp = mesh_tp_degree(mesh)
        self.key = prng_key(seed, device)
        self.last = None  # the last decode block's tokens [max_slots], on the device
        self.chunk_logits: dict = {}  # a sliced prompt's last chunk's logits, by slot
        self.draft = None  # (params, cache, cfg) of a speculating engine's draft: prefilled beside the target
        self.vision = None  # (VLMConfig, vision params) of a multimodal engine (never under a mesh)
        self.journal = journal
        self.closed = False  # rank 0 released its followers (a stopped tensor-parallel engine)
        # the control group (:func:`control_group`): made here unless the engine made it
        self._ctrl, self._src = control if control is not None else control_group(mesh)

    # -- shipping -------------------------------------------------------------

    def _ship(self, name: str, args: tuple) -> None:
        if self._ctrl is not None:
            import torch.distributed as dist

            dist.broadcast_object_list([(name, args)], src=self._src, group=self._ctrl)

    def _run(self, name: str, *args):
        """Ship the call (rank 0) and run it here."""
        self._ship(name, args)
        if self.journal is not None:
            self.journal.append((name, _digest(args)))
        return getattr(self, f"_{name}")(*args)

    def close(self) -> None:
        """Release the followers (their :func:`follow` returns)."""
        if self._ctrl is not None:
            self._ship("close", ())
            self._ctrl = None
            self.closed = True

    def serve_calls(self) -> None:
        """The follower loop: receive each call rank 0 ships and run it,
        until rank 0 closes."""
        import torch.distributed as dist

        while True:
            box = [None]
            dist.broadcast_object_list(box, src=self._src, group=self._ctrl)
            name, args = box[0]
            if name == "close":
                return
            if self.journal is not None:
                self.journal.append((name, _digest(args)))
            getattr(self, f"_{name}")(*args)

    # -- host arrays to the device ---------------------------------------------

    def stage(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """One dispatch's host arrays (int32, float32 or bool) on the device:
        packed into one int32 buffer and sent in one copy, non-blocking from
        pinned memory on the card. The buffer is fresh each time: PyTorch's
        pinned-memory cache reuses it only after its copy has run, so a later
        dispatch never rewrites what a queued copy still reads."""
        total = sum(a.size for a in arrays)
        on_card = self.device.type == "cuda"
        host = torch.empty(total, dtype=torch.int32, pin_memory=on_card)
        flat = host.numpy()
        off = 0
        for a in arrays:
            flat[off : off + a.size] = (a.view(np.int32) if a.dtype == np.float32 else a).reshape(-1)
            off += a.size
        dev = host.to(self.device, non_blocking=True) if on_card else host
        out, off = [], 0
        for a in arrays:
            t = dev[off : off + a.size].view(a.shape)
            off += a.size
            if a.dtype == np.float32:
                t = t.view(torch.float32)
            elif a.dtype == np.bool_:
                t = t != 0
            out.append(t)
        return out

    def next_key(self):
        keys = split(self.key, 2)
        self.key = keys[0]
        return keys[1]

    # -- the calls ---------------------------------------------------------------

    def prefill(self, tokens, tables, seq_lens, temps, top_ps, top_ks, seeds):
        """A batched prefill and its first tokens' sampling; returns the
        tokens [B] on the device."""
        return self._run("prefill", tokens, tables, seq_lens, temps, top_ps, top_ks, seeds)

    def _prefill(self, tokens, tables, seq_lens, temps, top_ps, top_ks, seeds):
        tok_d, tables_d, lens_d, temps_d, top_ps_d, top_ks_d, seeds_d = self.stage(
            tokens, tables, seq_lens, temps, top_ps, top_ks, seeds)
        logits, _, _ = llama.prefill(
            self.params, tok_d, self.cache.k_pages, self.cache.v_pages, tables_d, lens_d, self.cfg, mesh=self.mesh,
        )
        if self.draft is not None:
            # the draft's cache over the same pages (the caches share page ids)
            d_params, d_cache, d_cfg = self.draft
            llama.prefill(d_params, tok_d, d_cache.k_pages, d_cache.v_pages, tables_d, lens_d, d_cfg)
        return sample(
            logits, self.next_key(), temps_d, top_ps_d, top_ks_d, seeds=seeds_d, step_ids=lens_d,
            needs_filter=bool(((top_ps < 1.0) | (top_ks > 0)).any()),
        )

    def prefill_mm(self, images, tokens, tables, seq_lens, temps, top_ps, top_ks, seeds):
        """A batched multimodal prefill: the vision tower over ``images``
        [B, S, S, 3], its projected patch states as each row's first
        positions (``llama.prefill(input_embeds=)``), and the first tokens'
        sampling, one step; returns the tokens [B] on the device."""
        return self._run("prefill_mm", images, tokens, tables, seq_lens, temps, top_ps, top_ks, seeds)

    def _prefill_mm(self, images, tokens, tables, seq_lens, temps, top_ps, top_ks, seeds):
        from ..models import vlm

        vcfg, vparams = self.vision
        tok_d, tables_d, lens_d, temps_d, top_ps_d, top_ks_d, seeds_d = self.stage(
            tokens, tables, seq_lens, temps, top_ps, top_ks, seeds)
        images_d = torch.from_numpy(images).to(self.device)
        embeds = vlm.encode_image(vparams, images_d, vcfg)
        logits, _, _ = llama.prefill(
            self.params, tok_d, self.cache.k_pages, self.cache.v_pages, tables_d, lens_d, self.cfg,
            input_embeds=embeds,
        )
        return sample(
            logits, self.next_key(), temps_d, top_ps_d, top_ks_d, seeds=seeds_d, step_ids=lens_d,
            needs_filter=bool(((top_ps < 1.0) | (top_ks > 0)).any()),
        )

    def prefill_chunk(self, slot_idx: int, toks, table, chunk_len, offset: int):
        """One chunk of a sliced prompt; returns its last-token logits (kept
        by slot for :meth:`sample_first`)."""
        return self._run("prefill_chunk", slot_idx, toks, table, chunk_len, offset)

    def _prefill_chunk(self, slot_idx: int, toks, table, chunk_len, offset: int):
        toks_d, table_d, len_d = self.stage(toks, table, chunk_len)
        logits, _, _ = llama.prefill_chunk(
            self.params, toks_d, self.cache.k_pages, self.cache.v_pages, table_d, len_d, self.cfg, q_offset=offset,
            mesh=self.mesh,
        )
        if self.draft is not None:
            d_params, d_cache, d_cfg = self.draft
            llama.prefill_chunk(d_params, toks_d, d_cache.k_pages, d_cache.v_pages, table_d, len_d, d_cfg,
                                q_offset=offset)
        self.chunk_logits[slot_idx] = logits
        return logits

    def sample_first(self, slot_idx: int, temp, top_p, top_k, seed, step):
        """A sliced prompt's first token from its last chunk's logits."""
        return self._run("sample_first", slot_idx, temp, top_p, top_k, seed, step)

    def _sample_first(self, slot_idx: int, temp, top_p, top_k, seed, step):
        logits = self.chunk_logits.pop(slot_idx)
        temps_d, top_ps_d, top_ks_d, seeds_d, step_d = self.stage(temp, top_p, top_k, seed, step)
        return sample(logits, self.next_key(), temps_d, top_ps_d, top_ks_d, seeds=seeds_d, step_ids=step_d,
                      needs_filter=bool(top_p[0] < 1.0 or top_k[0] > 0))

    def replay_step(self, tokens, positions, tables, active) -> None:
        """One decode step of a resumed request's replay (nothing read)."""
        self._run("replay_step", tokens, positions, tables, active)

    def _replay_step(self, tokens, positions, tables, active) -> None:
        tok_d, pos_d, tables_d, active_d = self.stage(tokens, positions, tables, active)
        llama.decode_step(
            self.params, tok_d, pos_d, self.cache.k_pages, self.cache.v_pages, tables_d, active_d, self.cfg,
            impl=self.paged_impl, scatter_impl=self.scatter_impl, mesh=self.mesh,
        )

    def decode_block(self, restart: bool, override, override_mask, positions, tables, active, temps, top_ps, top_ks,
                     seeds, n_run: int, needs_filter: bool):
        """The first ``n_run`` of a block's ``decode_block`` decode+sample
        steps over every slot (step keys as for the whole block); tokens feed
        forward on the device from the last block's (zeros after a
        ``restart``), a fresh slot's first token through the override lane.
        Returns (tokens [n_run, B], last [B])."""
        return self._run("decode_block", restart, override, override_mask, positions, tables, active, temps, top_ps,
                         top_ks, seeds, n_run, needs_filter)

    def _decode_block(self, restart: bool, override, override_mask, positions, tables, active, temps, top_ps, top_ks,
                      seeds, n_run: int, needs_filter: bool):
        override, override_mask, positions, tables, active, temps, top_ps, top_ks, seeds = self.stage(
            override, override_mask, positions, tables, active, temps, top_ps, top_ks, seeds)
        key = self.next_key()
        prev = self.last
        if restart or prev is None:
            prev = torch.zeros(override.shape, dtype=torch.int32, device=self.device)
        tok = torch.where(override_mask, override, prev)
        pos = positions
        step_keys = split(key, self.block)
        # the block's sampling noise in one derivation (it depends on the keys
        # and positions only, not on the tokens fed forward)
        noise = block_noise(step_keys[:n_run], seeds, positions, self.cfg.vocab_size)
        out = []
        for k in range(n_run):
            logits, _, _ = llama.decode_step(
                self.params, tok, pos, self.cache.k_pages, self.cache.v_pages, tables, active, self.cfg,
                impl=self.paged_impl, scatter_impl=self.scatter_impl, mesh=self.mesh,
            )
            nxt = sample(logits, step_keys[k], temps, top_ps, top_ks, needs_filter=needs_filter, noise=noise[k])
            tok = torch.where(active, nxt, tok)  # dead slots hold steady
            out.append(tok)
            pos = pos + 1
        self.last = tok
        return torch.stack(out), tok
