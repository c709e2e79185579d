"""Training: the train step, its optimizer and the loop around it.

Counterpart of ``modal_examples_tpu/training/trainer.py`` (``TrainState``,
``cross_entropy_loss``, ``make_optimizer``, ``warmup_cosine``, ``Trainer``)
on one device. ``loss_fn(params, batch)`` takes the trainable pytree (for
LoRA, the adapters; the frozen base rides in the closure) and gradients are
taken with respect to its leaves. Gradient accumulation sums microbatch
gradients and then divides; ``remat`` recomputes the loss's activations in
the backward (``torch.utils.checkpoint``); ``grad_norm`` is reported before
clipping.

The optimizer is optax's ``chain(clip_by_global_norm, adamw)`` written in
tensor ops, so a test can hold it against optax: clipping scales by
``max_norm / norm`` only when ``norm >= max_norm``; Adam's ``eps`` is outside
the square root; decoupled weight decay ``lr * wd * p`` applies to every
leaf; the moments are kept in each parameter's dtype (optax gives bf16
moments to bf16 parameters); a schedule's count starts at 0 on the first
update. A step builds new parameter and moment tensors and leaves the old
state intact (JAX donated it instead).

Data parallelism (``mesh=`` with a ``data`` axis, ``parallel.make_mesh``):
every rank gets the global batch (the JAX trainer's ``P("data")`` input),
cuts it into the ``grad_accum`` microbatches as the JAX step does, takes its
block of each microbatch's dim 0, and runs the step on it. The trainable
gradients are summed over the axis in one all-reduce per dtype (the leaves
flattened into one buffer, as DDP's buckets are) before the optimizer, so
every rank applies the same update and the parameters stay replicated.
The loss and the gradient norm are the global batch's, as the JAX trainer
reports them. A ``loss_fn`` that returns a pair ``(total, count)``
(:func:`cross_entropy_terms`) is divided by the count summed over the
ranks: a masked loss whose token counts differ across ranks is the mean
over the global batch's tokens, as in JAX. A scalar ``loss_fn`` counts as
a mean over equal-weight blocks, so the ranks are averaged.
``param_specs`` (tensor-parallel or FSDP training) waits for ROADMAP A10b's
later items and raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import DATA, P, axis_sizes, shard_tensor
from ..utils import tree
from ..utils.tracking import RunLogger


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int


def _token_ll(logits, targets):
    logp = F.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, targets[..., None].long())[..., 0]


def cross_entropy_loss(logits, targets, mask=None):
    """Mean next-token cross entropy; logits [B,S,V] f32, targets [B,S]."""
    ll = _token_ll(logits, targets)
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)


def cross_entropy_terms(logits, targets, mask=None):
    """``(total, count)``: the summed next-token cross entropy and the
    number of tokens it counts, whose ratio is :func:`cross_entropy_loss`.
    A ``loss_fn`` returns this pair so that ``Trainer(mesh=)`` divides by
    the global batch's count."""
    ll = _token_ll(logits, targets)
    if mask is None:
        return -ll.sum(), torch.tensor(float(ll.numel()), device=ll.device)
    mask = mask.float()
    return -(ll * mask).sum(), mask.sum()


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, as
    ``optax.global_norm`` (each leaf's sum in its own dtype)."""
    sq = [(g * g).sum() for g in tree.leaves(grads)]
    return torch.sqrt(sum(sq[1:], sq[0]))


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(...))``: the
    ``init``/``update`` pair of an optax GradientTransformation. The state is
    ``{"count": int, "mu": tree, "nu": tree}``."""

    def __init__(self, learning_rate, *, weight_decay: float, b1: float, b2: float,
                 grad_clip: float, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = grad_clip

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params) -> dict:
        return {"count": 0, "mu": tree.map(torch.zeros_like, params), "nu": tree.map(torch.zeros_like, params)}

    def update(self, grads, state: dict, params):
        """Returns (updates, new_state); ``apply_updates`` adds the updates.
        Constants are rounded to each leaf's dtype before they multiply it,
        as JAX's weakly typed scalars are (a bf16 leaf is scaled by
        bf16(0.1), not by 0.1 in f32)."""

        def c(value: float, like):
            return torch.tensor(value, dtype=like.dtype)

        with torch.no_grad():
            norm = global_norm(grads)
            keep = norm < self.grad_clip  # on the device: no host sync
            grads = tree.map(lambda g: torch.where(keep, g, g / norm.to(g.dtype) * c(self.grad_clip, g)), grads)
            b1, b2 = self.b1, self.b2
            mu = tree.map(lambda g, m: c(1 - b1, g) * g + c(b1, m) * m, grads, state["mu"])
            nu = tree.map(lambda g, v: c(1 - b2, g) * (g * g) + c(b2, v) * v, grads, state["nu"])
            count = state["count"] + 1
            # bias corrections in f32 (low precision would round b**count to 1)
            c1 = torch.tensor(1 - b1**count, dtype=torch.float32)
            c2 = torch.tensor(1 - b2**count, dtype=torch.float32)
            lr = self.lr(state["count"])

            def step(m, v, p):
                u = (m / c1.to(m.dtype)) / (torch.sqrt(v / c2.to(v.dtype)) + c(self.eps, v))
                u = u + c(self.weight_decay, p) * p
                return c(-lr, u) * u

            updates = tree.map(step, mu, nu, params)
        return updates, {"count": count, "mu": mu, "nu": nu}


def apply_updates(params, updates):
    return tree.map(lambda p, u: (p + u).to(p.dtype), params, updates)


def make_optimizer(
    learning_rate: float | Callable = 3e-4,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> AdamW:
    return AdamW(learning_rate, weight_decay=weight_decay, b1=b1, b2=b2, grad_clip=grad_clip)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.1) -> Callable:
    """optax.warmup_cosine_decay_schedule(0, peak_lr, warmup_steps,
    max(total_steps, warmup_steps + 1), end_value=peak_lr * floor):
    linear from 0 over ``warmup_steps`` counts, then cosine down to
    ``peak_lr * floor`` at ``total_steps``, flat after."""
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps
    alpha = floor

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_lr * count / warmup_steps
        t = min(count - warmup_steps, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
        return peak_lr * ((1 - alpha) * cosine + alpha)

    return schedule


def _per_count(total, count, grads):
    """A loss pair's total and gradients divided by its count (at least
    one); a scalar loss (``count`` None) as it is."""
    if count is None:
        return total, grads
    count = count.float().clamp(min=1.0)
    return total / count, tree.map(lambda g: (g.float() / count).to(g.dtype), grads)


class Trainer:
    """Training loop around a pure loss function, on one device or data
    parallel over a mesh's ``data`` axis (module docstring).

    ``loss_fn(params, batch) -> scalar`` defines the model; accumulation,
    the gradient average and the optimizer live here. ``train_step``
    returns a new state.
    """

    def __init__(
        self,
        loss_fn: Callable,
        optimizer: AdamW,
        *,
        mesh=None,
        param_specs=None,
        batch_axis: str = DATA,
        grad_accum: int = 1,
        remat: bool = False,
    ):
        if param_specs is not None:
            raise NotImplementedError(
                "param_specs (tensor-parallel or FSDP training) is not ported; data parallelism is (mesh=): "
                "ROADMAP A10b"
            )
        if mesh is not None and batch_axis not in axis_sizes(mesh):
            raise ValueError(f"the mesh has no {batch_axis!r} axis to split the batch over: {axis_sizes(mesh)}")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1; got {grad_accum}")
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.grad_accum = grad_accum
        self.remat = remat
        self.mesh = mesh
        self.batch_axis = batch_axis

    def init_state(self, params) -> TrainState:
        return TrainState(params=params, opt_state=self.optimizer.init(params), step=0)

    def _value_and_grad(self, params, batch):
        """``(loss, gradients)`` of ``batch`` on this rank alone (a pair's
        total divided by its count)."""
        return _per_count(*self._terms_and_grad(params, batch))

    def _terms_and_grad(self, params, batch):
        """``(total, count, gradients of total)``; ``count`` is None for a
        scalar ``loss_fn``."""
        flat = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        p_tree = tree.unflatten(params, flat)
        if self.remat:
            out = checkpoint(self.loss_fn, p_tree, batch, use_reentrant=False)
        else:
            out = self.loss_fn(p_tree, batch)
        total, count = out if isinstance(out, tuple) else (out, None)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        return total.detach(), count, tree.unflatten(params, grads)

    def shard_batch(self, batch):
        """This rank's block of the global batch (dim 0 of every leaf split
        over the data axis); the batch itself without a mesh."""
        if self.mesh is None:
            return batch
        return tree.map(lambda x: shard_tensor(x, P(self.batch_axis), self.mesh), batch)

    def _micro_loss_and_grads(self, params, micro):
        """One microbatch of the global batch: its loss and this rank's
        share of its gradients (summed over the data axis, they are the
        microbatch's gradients)."""
        total, count, grads = self._terms_and_grad(params, self.shard_batch(micro))
        if self.mesh is not None:
            from ..parallel import collectives

            if count is None:  # a scalar loss: each rank's block weighs one
                count = torch.ones((), device=total.device)
            both = collectives.psum(torch.stack([total.float(), count.float()]), self.batch_axis, self.mesh)
            total, count = both[0], both[1]
        return _per_count(total, count, grads)

    def loss_and_grads(self, params, batch):
        """The loss and the trainable gradients of the global ``batch``
        (under a mesh, summed over the data axis, so every rank holds the
        same), averaged over the ``grad_accum`` microbatches."""
        n = self.grad_accum
        loss, grads = None, None
        for i in range(n):
            micro = batch if n == 1 else tree.map(lambda x: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i], batch)
            micro_loss, micro_grads = self._micro_loss_and_grads(params, micro)
            if grads is None:
                loss, grads = micro_loss, micro_grads
            else:
                loss = loss + micro_loss
                grads = tree.map(torch.add, grads, micro_grads)
        if self.mesh is not None:
            from ..parallel import collectives

            grads = collectives.psum_tree(grads, self.batch_axis, self.mesh)
        if n > 1:
            loss = loss / n
            grads = tree.map(lambda g: g / n, grads)
        return loss, grads

    def train_step(self, state: TrainState, batch):
        """One optimizer step over ``batch`` (a pytree of tensors with the
        batch on dim 0; under a mesh the global batch, of which this rank
        takes its block of each microbatch). Returns (new_state, {"loss",
        "grad_norm"})."""
        loss, grads = self.loss_and_grads(state.params, batch)
        grad_norm = global_norm(grads)
        updates, opt_state = self.optimizer.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        new_state = TrainState(params=params, opt_state=opt_state, step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": grad_norm}

    def fit(self, state: TrainState, batches, *, run_dir=None, logger=None, volume=None,
            log_every: int = 1) -> TrainState:
        """Drive ``train_step`` over ``batches``, recording loss/grad_norm to
        a ``utils.tracking.RunLogger``. Pass an open ``logger`` to share one
        across phases (the caller closes it), or just ``run_dir`` and the
        loop owns the logger, closed even when a step raises."""
        owned = None
        if logger is None and run_dir is not None:
            logger = owned = RunLogger(run_dir, volume=volume)
        try:
            for batch in batches:
                state, metrics = self.train_step(state, batch)
                if logger is not None and state.step % max(1, log_every) == 0:
                    # float() waits for the device, so only on log steps
                    logger.log(state.step, {k: float(v) for k, v in metrics.items()})
            return state
        finally:
            if owned is not None:
                owned.close()
