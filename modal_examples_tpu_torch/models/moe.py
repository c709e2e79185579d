"""Mixture of experts: top-k routing, the capacity-routed GShard dispatch and
the serving formulation that runs every expert on every token.

Counterpart of ``modal_examples_tpu/models/moe.py`` (``MoEConfig``,
``init_params``, ``_route``, ``_expert_ffn``, ``moe_mlp``, ``_mm``,
``_swiglu_expert``, ``moe_swiglu_nodrop``, ``moe_swiglu_capacity``).
``moe_mlp_ep``, the expert-parallel layer over a device mesh, waits for the
port's mesh (ROADMAP A10) and raises.

Top-k keeps ``lax.top_k``'s order (the larger value first, the lower index
first among equals) through a stable sort, and the top-1 of the aux loss is
``argmax``'s first maximum, as in JAX, so both frameworks pick the same
experts on ties.

One departure, on the serving path only (:func:`moe_swiglu_nodrop`): the
reference promotes the expert inputs to f32. Here the experts multiply the
activations in their own dtype with f32 sums and an f32 combine: exact f32
for an f32 model, and for a bf16 model the bf16 GEMM or the int8 matmul
kernel with no f32 copy of any expert weight. The hidden state entering the
layer is already bf16, so the only extra rounding is of the SwiGLU product
before the down projection, the rounding the dense ``layers.swiglu_mlp``
makes too. The capacity path (training scale) keeps the reference's f32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from . import layers
from .quantize import QuantizedWeight, dequantize_weight


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    d_model: int = 64
    d_ff: int = 128

    def capacity(self, tokens_per_group: int) -> int:
        c = int(self.capacity_factor * self.top_k * tokens_per_group / self.n_experts)
        return max(c, 1)


def init_params(cfg: MoEConfig, *, seed: int = 0, device=None, dtype=torch.float32) -> dict:
    """Random ``router`` [D, E], ``w_in`` [E, D, F] and ``w_out`` [E, F, D]
    from a seeded generator on the device, at the JAX init's scales
    (fan_in**-0.5)."""
    init = layers.SeededInit(seed, resolve_device(device), dtype)
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": init.dense(D, E),
        "w_in": init.dense(E, D, Fd),
        "w_out": init.dense(E, Fd, D),
    }


def _topk(probs, k: int):
    """``lax.top_k`` along the last axis: the k largest, the lower index
    first among equals."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _aux_loss(probs):
    """Switch load balance: E x sum(mean top-1 assignment x mean prob)."""
    E = probs.shape[-1]
    frac_tokens = F.one_hot(probs.argmax(dim=-1), E).float().mean(dim=0)
    return E * (frac_tokens * probs.mean(dim=0)).sum()


def _route(x, router, cfg: MoEConfig, capacity: int):
    """Per-group dispatch and combine tensors. x: [T, D] (one group).
    Returns (dispatch [T, E, C] f32 of 0/1, combine [T, E, C] f32 weights,
    aux loss). Each token takes a slot of each of its k experts in token
    order, the first choices of every token before the second ones; a
    token past an expert's capacity is dropped there."""
    T = x.shape[0]
    E = cfg.n_experts
    logits = layers.mm(x, router)  # [T, E] f32
    probs = torch.softmax(logits, dim=-1)
    aux = _aux_loss(probs)
    topk_p, topk_idx = _topk(probs, cfg.top_k)
    topk_p = topk_p / topk_p.sum(dim=-1, keepdim=True)

    dispatch = torch.zeros((T, E, capacity), dtype=torch.float32, device=x.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((E,), dtype=torch.long, device=x.device)  # slots used per expert so far
    for k in range(cfg.top_k):
        e_k = topk_idx[:, k]
        onehot = F.one_hot(e_k, E)  # [T, E]
        pos = (torch.cumsum(onehot, dim=0) - 1 + counts[None, :]).gather(1, e_k[:, None])[:, 0]
        keep = pos < capacity
        slot = pos.clamp(0, capacity - 1)
        d_k = onehot.float()[:, :, None] * F.one_hot(slot, capacity).float()[:, None, :] * keep.float()[:, None, None]
        dispatch = dispatch + d_k
        combine = combine + d_k * topk_p[:, k][:, None, None]
        counts = counts + (onehot * keep[:, None]).sum(dim=0)
    return dispatch, combine, aux


def _expert_ffn(w_in, w_out, h):
    """h: [..., C, D] per expert; the GELU (tanh) MLP of that expert."""
    return F.gelu(h @ w_in, approximate="tanh") @ w_out


def moe_mlp(params: dict, x, cfg: MoEConfig, *, groups: int = 1):
    """The single-device MoE layer. x: [T, D]; ``groups`` partitions the
    tokens as expert-parallel shards would (capacities, and so drops, per
    group). Returns (out [T, D], mean aux loss)."""
    T, D = x.shape
    if T % groups:
        raise ValueError(f"{T} tokens do not split into {groups} groups")
    tg = T // groups
    cap = cfg.capacity(tg)
    outs, auxes = [], []
    for xg in x.reshape(groups, tg, D):
        dispatch, combine, aux = _route(xg, params["router"], cfg, cap)
        expert_in = torch.einsum("tec,td->ecd", dispatch, xg)  # [E, C, D]
        expert_out = _expert_ffn(params["w_in"], params["w_out"], expert_in)  # [E, C, D]
        outs.append(torch.einsum("tec,ecd->td", combine, expert_out))
        auxes.append(aux)
    return torch.stack(outs).reshape(T, D), torch.stack(auxes).mean()


def moe_mlp_ep(params: dict, x, cfg: MoEConfig, mesh, *, axis: str = "expert"):
    """Expert parallelism over a device mesh: not ported yet."""
    raise NotImplementedError("moe_mlp_ep (experts sharded over a mesh axis, all_to_all) waits for ROADMAP A10")


def _mm(h, w):
    """``h @ w`` with f32 sums, returned in f32; ``w`` may be an int8
    :class:`~.quantize.QuantizedWeight` (the int8 or int4 matmul kernel on
    the card).
    ``h`` enters at its own dtype."""
    return layers.mm(h, w)


def _expert(w, e: int):
    """Expert ``e``'s matrix of a stacked [E, ...] leaf: a contiguous view
    (a quantized leaf's ``q[e]`` and ``scale[e]``, int8 or packed int4)."""
    if isinstance(w, QuantizedWeight):
        return dataclasses.replace(w, q=w.q[e], scale=w.scale[e])
    return w[e]


def _swiglu_expert(w_gate, w_up, w_down, h):
    """A SwiGLU expert (Mixtral's w1/w3/w2): h [T, D] -> [T, D] f32. The
    gate and up products stay f32 through the SwiGLU product, which enters
    the down projection at ``h``'s dtype."""
    a = _mm(h, w_gate)
    b = _mm(h, w_up)
    return _mm((F.silu(a) * b).to(h.dtype), w_down)


def _nodrop_weights(x, router, top_k: int):
    """Routing of the serving formulation, in f32: (top-k indices [T, k],
    combine weights [T, E], zero off each token's top k, aux loss)."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    topk_p, topk_idx = _topk(probs, top_k)
    topk_p = topk_p / topk_p.sum(dim=-1, keepdim=True)
    return topk_idx, torch.zeros_like(probs).scatter_add_(1, topk_idx, topk_p), _aux_loss(probs)


def moe_swiglu_nodrop(router, w_gate, w_up, w_down, x, top_k: int):
    """Top-k routed SwiGLU experts with no capacity drops, the serving
    formulation: routing is per token, so incremental decode reproduces the
    full-sequence forward. Every expert runs on every token, weighted by its
    combine weight (zero off the top k), one expert at a time (the [T, F]
    intermediate stays one expert's). router [D, E]; w_gate, w_up [E, D, F];
    w_down [E, F, D] (int8 leaves allowed); x [T, D]. The router runs in f32;
    the experts take ``x`` at its own dtype (module docstring). Returns
    (out [T, D] f32, aux load-balance loss)."""
    _, w_full, aux = _nodrop_weights(x, router, top_k)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(w_gate.shape[0]):
        y = _swiglu_expert(_expert(w_gate, e), _expert(w_up, e), _expert(w_down, e), x)
        out = out + w_full[:, e, None] * y
    return out, aux


def moe_swiglu_capacity(router, w_gate, w_up, w_down, x, top_k: int, capacity_factor: float):
    """Capacity-routed SwiGLU experts (the GShard dispatch): each expert
    computes only its capacity slots, about top_k / E of the no-drop work,
    for compute-bound training and prefill (tokens over capacity drop, so it
    is not the no-drop path). int8 leaves are dequantized to bf16 first, as
    in the reference. Returns (out [T, D] f32, aux load-balance loss)."""
    w_gate, w_up, w_down = (
        dequantize_weight(w) if isinstance(w, QuantizedWeight) else w for w in (w_gate, w_up, w_down)
    )
    E, D, Fd = w_gate.shape
    cfg = MoEConfig(n_experts=E, top_k=top_k, capacity_factor=capacity_factor, d_model=D, d_ff=Fd)
    xf = x.float()
    dispatch, combine, aux = _route(xf, router.float(), cfg, cfg.capacity(x.shape[0]))
    expert_in = torch.einsum("tec,td->ecd", dispatch, xf)  # [E, C, D]
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, w_gate.float())) * torch.einsum(
        "ecd,edf->ecf", expert_in, w_up.float()
    )
    expert_out = torch.einsum("ecf,efd->ecd", h, w_down.float())
    return torch.einsum("tec,ecd->td", combine, expert_out), aux
