"""Mixture of experts: top-k routing, the capacity-routed GShard dispatch and
the serving formulation that runs every expert on every token.

Counterpart of ``modal_examples_tpu/models/moe.py`` (``MoEConfig``,
``init_params``, ``_route``, ``_expert_ffn``, ``moe_mlp``, ``_mm``,
``_swiglu_expert``, ``moe_swiglu_nodrop``, ``moe_swiglu_capacity``).
``moe_mlp_ep`` is the expert-parallel layer over a mesh axis of rank
processes (``parallel``): each rank holds its tokens and its block of the
experts, and two ``all_to_all`` exchanges carry the dispatched tokens to
their experts' ranks and the results back.

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

The capacity path's experts run as one ``torch.autograd.Function``
(:class:`CapacityExperts`) with a memory plan of its own: the reference
dequantizes every expert stack to bf16 and widens it to f32 for its einsums
(under ``jit``, XLA decides what stays alive). Done eagerly, that held three
f32 stacks a layer for the backward, 5.6 GB a Mixtral layer. Here one
expert's widened matrices live at a time, nothing widened is saved, and the
backward widens them again: the same values, the same f32 products.
:func:`capacity_experts_plain` is the unplanned formula.
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
    """Expert parallelism over the mesh axis ``axis`` of ``n`` ranks: this
    rank's tokens ``x`` [T/n, D] and its experts (``w_in``/``w_out`` are its
    block of E/n experts, the blocked layout: global expert ``e`` lives on
    rank ``e // (E/n)``; ``router`` whole). Routing and capacities are per
    rank, as ``moe_mlp(groups=n)`` makes them per group; the dispatched
    activations go to their experts' ranks by ``all_to_all`` and come back
    the same way. Returns (this rank's out [T/n, D], the aux loss averaged
    over the axis)."""
    from ..parallel import collectives

    if mesh is None:
        raise ValueError("moe_mlp_ep runs over a mesh's expert axis (parallel.make_mesh); moe_mlp(groups=n) is "
                         "its one-device form")
    n = collectives.axis_size(axis, mesh)
    if cfg.n_experts % n:
        raise ValueError(f"{cfg.n_experts} experts do not split over {n} ranks")
    e_loc = cfg.n_experts // n
    if params["w_in"].shape[0] != e_loc:
        raise ValueError(f"w_in holds {params['w_in'].shape[0]} experts; this rank's block is {e_loc}")
    t, d = x.shape
    cap = cfg.capacity(t)
    dispatch, combine, aux = _route(x, params["router"], cfg, cap)  # [t, E, C]
    expert_in = torch.einsum("tec,td->ecd", dispatch, x)  # [E, C, D]
    # block j of the experts goes to rank j; each rank receives every rank's
    # tokens for its experts, stacked by source rank: [n, E/n, C, D]
    recv = collectives.all_to_all(expert_in.reshape(n, e_loc, cap, d), axis, split_dim=0, concat_dim=0, tiled=False,
                                  mesh=mesh)
    h = recv.transpose(0, 1).reshape(e_loc, n * cap, d)
    out_loc = _expert_ffn(params["w_in"], params["w_out"], h)  # [E/n, n*C, D]
    back = collectives.all_to_all(out_loc.reshape(e_loc, n, cap, d).transpose(0, 1), axis, split_dim=0, concat_dim=0,
                                  tiled=False, mesh=mesh)  # block j: this rank's tokens through rank j's experts
    out = torch.einsum("tec,ecd->td", combine, back.reshape(cfg.n_experts, cap, d))
    return out, collectives.pmean(aux, axis, mesh)


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


def _tp_regions(mesh):
    """(copy_to, reduce_from) over the mesh's tensor axis: the gradient
    rules of a column-parallel input and a row-parallel sum
    (``parallel.collectives``); identities without a mesh."""
    if mesh is None:
        return (lambda t: t), (lambda t: t)
    from ..parallel import collectives
    from ..parallel.mesh import TENSOR

    return (lambda t: collectives.copy_to(t, TENSOR, mesh)), (lambda t: collectives.reduce_from(t, TENSOR, mesh))


def moe_swiglu_nodrop(router, w_gate, w_up, w_down, x, top_k: int, *, mesh=None):
    """Top-k routed SwiGLU experts with no capacity drops, the serving
    formulation: routing is per token, so incremental decode reproduces the
    full-sequence forward. Every expert runs on every token, weighted by its
    combine weight (zero off the top k), one expert at a time (the [T, F]
    intermediate stays one expert's). router [D, E]; w_gate, w_up [E, D, F];
    w_down [E, F, D] (int8 leaves allowed); x [T, D]. The router runs in f32;
    the experts take ``x`` at its own dtype (module docstring). Returns
    (out [T, D] f32, aux load-balance loss).

    Under a ``mesh`` the stacks are this rank's ffn block of every expert
    (``llama.partition_specs``) and ``out`` is this rank's f32 partial, which
    the caller sums over the tensor axis; the experts' input and the combine
    weights then take the gradient rule of a column-parallel input (each
    rank's share of their gradient, summed over the axis)."""
    copy_to, _ = _tp_regions(mesh)
    _, w_full, aux = _nodrop_weights(x, router, top_k)
    x, w_full = copy_to(x), copy_to(w_full)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(w_gate.shape[0]):
        y = _swiglu_expert(_expert(w_gate, e), _expert(w_up, e), _expert(w_down, e), x)
        out = out + w_full[:, e, None] * y
    return out, aux


def _widened(w, e: int):
    """Expert ``e``'s matrix of a stack in f32: a quantized leaf (int8 or
    packed int4) dequantized to bf16 first, as the reference does, then
    widened; a plain leaf widened from its own dtype."""
    m = _expert(w, e)
    return (dequantize_weight(m) if isinstance(m, QuantizedWeight) else m).float()


def capacity_experts_plain(expert_in, w_gate, w_up, w_down):
    """The capacity path's expert products as the reference writes them:
    every stack dequantized (quantized leaves to bf16) and widened to f32 at
    once, then ``einsum`` over all experts. expert_in [E, C, D] f32 ->
    [E, C, D] f32. Under autograd it saves the three widened stacks; the
    card's training path runs :class:`CapacityExperts` instead."""
    wg, wu, wd = ((dequantize_weight(w) if isinstance(w, QuantizedWeight) else w).float()
                  for w in (w_gate, w_up, w_down))
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, wg)) * torch.einsum("ecd,edf->ecf", expert_in, wu)
    return torch.einsum("ecf,efd->ecd", h, wd)


class CapacityExperts(torch.autograd.Function):
    """:func:`capacity_experts_plain`'s function with a memory plan: one
    expert at a time, each of its matrices widened to f32 (:func:`_widened`:
    the reference's values) just before its products and dropped after
    them. The forward saves ``expert_in`` and the stacks as they are held
    (a :class:`~.quantize.QuantizedWeight` or a plain tensor), never a widened
    copy; the backward widens each expert's matrices again, recomputes its
    gate and up products (``a``, ``b``), and returns d``expert_in`` and, for a
    plain stack that needs one, its gradient (in the stack's dtype).

    Per expert, with h = silu(a) * b, a = x W_g, b = x W_u, y = h W_d:
    dh = dy W_d^T, db = dh silu(a), da = dh b silu'(a), dx = da W_g^T +
    db W_u^T, dW_g = x^T da, dW_u = x^T db, dW_d = h^T dy, silu'(a) =
    sigmoid(a) (1 + a (1 - sigmoid(a)))."""

    @staticmethod
    def forward(ctx, expert_in, w_gate, w_up, w_down):
        stacks = (w_gate, w_up, w_down)
        ctx.quantized = [w if isinstance(w, QuantizedWeight) else None for w in stacks]
        ctx.save_for_backward(expert_in, *(None if isinstance(w, QuantizedWeight) else w for w in stacks))
        out = torch.empty_like(expert_in)
        for e in range(expert_in.shape[0]):
            x = expert_in[e]
            h = F.silu(x @ _widened(w_gate, e)) * (x @ _widened(w_up, e))
            out[e] = h @ _widened(w_down, e)
        return out

    @staticmethod
    def backward(ctx, g_out):
        expert_in, *plain = ctx.saved_tensors
        w_gate, w_up, w_down = (q if q is not None else t for q, t in zip(ctx.quantized, plain))
        need = [isinstance(w, torch.Tensor) and n for w, n in zip((w_gate, w_up, w_down), ctx.needs_input_grad[1:])]
        dx = torch.empty_like(expert_in) if ctx.needs_input_grad[0] else None
        dw = [torch.empty_like(w) if n else None for w, n in zip((w_gate, w_up, w_down), need)]
        for e in range(expert_in.shape[0]):
            x, dy = expert_in[e], g_out[e].float()
            wg, wu, wd = _widened(w_gate, e), _widened(w_up, e), _widened(w_down, e)
            a, b = x @ wg, x @ wu
            sig = torch.sigmoid(a)
            silu = a * sig
            dh = dy @ wd.T
            db = dh * silu
            da = dh * b * (sig * (1 + a * (1 - sig)))
            if dx is not None:
                dx[e] = da @ wg.T + db @ wu.T
            if dw[0] is not None:
                dw[0][e] = (x.T @ da).to(dw[0].dtype)
            if dw[1] is not None:
                dw[1][e] = (x.T @ db).to(dw[1].dtype)
            if dw[2] is not None:
                dw[2][e] = ((silu * b).T @ dy).to(dw[2].dtype)
        return (dx, *dw)


def moe_swiglu_capacity(router, w_gate, w_up, w_down, x, top_k: int, capacity_factor: float, *, mesh=None):
    """Capacity-routed SwiGLU experts (the GShard dispatch): each expert
    computes only its capacity slots, about top_k / E of the no-drop work,
    for compute-bound training and prefill (tokens over capacity drop, so it
    is not the no-drop path). int8 leaves are dequantized to bf16 first, as
    in the reference; the expert products run through
    :class:`CapacityExperts` (module docstring). Returns (out [T, D] f32, aux
    load-balance loss).

    Under a ``mesh`` (tensor parallelism) the stacks are this rank's ffn
    block of every expert (``llama.partition_specs``). Every rank routes
    every token with the whole router (the same dispatch, and the aux loss
    counted once), runs its block of each expert on the dispatched slots,
    and sums the experts' f32 partial outputs over the tensor axis before
    the combine: the dispatched input takes the gradient rule of a
    column-parallel input, the sum that of a row-parallel one, and the
    combine weights, downstream of the sum, get the whole gradient on every
    rank."""
    E, D, Fd = w_gate.shape
    copy_to, reduce_from = _tp_regions(mesh)
    cfg = MoEConfig(n_experts=E, top_k=top_k, capacity_factor=capacity_factor, d_model=D, d_ff=Fd)
    xf = x.float()
    dispatch, combine, aux = _route(xf, router.float(), cfg, cfg.capacity(x.shape[0]))
    expert_in = copy_to(torch.einsum("tec,td->ecd", dispatch, xf))  # [E, C, D]
    expert_out = reduce_from(CapacityExperts.apply(expert_in, w_gate, w_up, w_down))
    return torch.einsum("tec,ecd->td", combine, expert_out), aux
