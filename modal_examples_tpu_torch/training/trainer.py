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

Parallel training (``mesh=``, ``parallel.make_mesh``) follows the JAX
trainer's signature: ``param_specs`` is a placement tree (a ``P`` a leaf,
as ``PartitionSpec``s), ``batch_spec`` (default ``P("data")``) splits the
batch's dim 0 over its axes. Each rank is a process holding only its blocks:

- At rest, ``init_state`` keeps this rank's block of every placed leaf
  (``parallel.mesh.shard_pytree``; a spec tree written for the JAX tree's
  layer-stacked leaves, as ``llama.partition_specs`` is, applies to every
  layer of the port's list, ``parallel.mesh.specs_for``), and the Adam
  moments are made from those blocks, so they are placed like their
  parameters.
- Tensor parallelism: a leaf placed on the ``tensor`` axis is used as the
  block it is. The step enters the mesh (``parallel.enter_mesh``, JAX's
  ``with mesh:``), so ``llama.forward`` called without a mesh inside the
  ``loss_fn`` runs tensor parallel on the blocks, and its collectives carry
  the gradient (``parallel.collectives.copy_to``/``reduce_from``/
  ``gather_from``): the gradient of a tensor-placed leaf is its block of
  the one-card gradient, and stays local.
- FSDP: a leaf placed on any other axis (``parallel.fsdp_specs``'s
  ``fsdp``) is all-gathered for the step's forward, and its gradient
  reduce-scattered back to the block (a sum over that axis where the batch
  is split over it, this rank's block of the gradient where it is not).
  The gathered leaves live for one microbatch's forward and backward: the
  gathered tree is dropped once the loss is computed, so the backward
  frees each gathered leaf when its last use has taken its gradient.
- Data parallelism: every rank gets the global batch (the JAX trainer's
  ``P("data")`` input), cuts it into the ``grad_accum`` microbatches as the
  JAX step does and takes its block of each microbatch's dim 0 by
  ``batch_spec``. The gradients are summed over the batch axes that their
  own gathers did not already sum over, in one all-reduce per dtype and
  set of axes (the leaves flattened into one buffer, as DDP's buckets are),
  so the ranks of a batch axis apply the same update and stay replicated.
- The loss and the gradient norm are the global batch's, as the JAX
  trainer reports them. A ``loss_fn`` that returns a pair ``(total,
  count)`` (:func:`cross_entropy_terms`) is divided by the count summed over
  the batch axes: a masked loss whose token counts differ across ranks is
  the mean over the global batch's tokens, as in JAX. A scalar ``loss_fn``
  counts as a mean over equal-weight blocks, so the ranks are averaged.
- The norm (reported, and clipped to) is the one-card norm: each leaf's
  sum of squares summed over the axes its blocks are placed on, so a
  replicated leaf counts once and every rank clips by the same factor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import DATA, TENSOR, P, axis_sizes, enter_mesh, shard_pytree, shard_tensor, spec_leaves, specs_for
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


def global_norm(grads, placement=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, as
    ``optax.global_norm`` (each leaf's sum in its own dtype). With a
    ``placement`` (a list of ``P``, one a leaf) over ``mesh``, the leaves are
    blocks and the norm is the whole tree's: each leaf's sum (in f32) is
    summed over the axes its placement names, one all-reduce per set of
    axes, so a replicated leaf counts once."""
    leaves = tree.leaves(grads)
    if placement is None or mesh is None:
        sq = [(g * g).sum() for g in leaves]
        return torch.sqrt(sum(sq[1:], sq[0]))
    from ..parallel import collectives

    by_axes: dict = {}
    for g, spec in zip(leaves, placement):
        by_axes.setdefault(_spec_axes(spec), []).append((g.float() * g.float()).sum())
    total = None
    for axes, sums in by_axes.items():
        part = torch.stack(sums).sum()
        if axes:
            part = collectives.psum(part, axes, mesh)
        total = part if total is None else total + part
    return torch.sqrt(total)


def _single_axis(entry) -> str:
    """A placement entry's one axis; a dimension split over several axes at
    once is not gathered here."""
    names = entry if isinstance(entry, tuple) else (entry,)
    if len(names) != 1:
        raise NotImplementedError(f"a dimension placed over several axes at once ({names}) is not gathered")
    return names[0]


def _spec_axes(spec) -> tuple:
    """The axis names a placement names, in its order."""
    out = []
    for entry in spec:
        for a in entry if isinstance(entry, tuple) else (entry,):
            if a is not None and a not in out:
                out.append(a)
    return tuple(out)


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

    def update(self, grads, state: dict, params, *, norm=None):
        """Returns (updates, new_state); ``apply_updates`` adds the updates.
        Constants are rounded to each leaf's dtype before they multiply it,
        as JAX's weakly typed scalars are (a bf16 leaf is scaled by
        bf16(0.1), not by 0.1 in f32). ``norm`` is the gradients' global norm
        when the caller has it (the whole tree's, where ``grads`` are a
        rank's blocks: :func:`global_norm` with a placement); else it is
        computed from ``grads``."""

        def c(value: float, like):
            return torch.tensor(value, dtype=like.dtype)

        with torch.no_grad():
            norm = global_norm(grads) if norm is None else norm
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
    """Training loop around a pure loss function, on one device or over a
    mesh: data parallel, tensor parallel, FSDP (module docstring).

    ``loss_fn(params, batch) -> scalar`` defines the model; accumulation,
    the placements, the gradient sync and the optimizer live here.
    ``train_step`` returns a new state.
    """

    def __init__(
        self,
        loss_fn: Callable,
        optimizer: AdamW,
        *,
        mesh=None,
        param_specs=None,  # a placement tree (P leaves): tensor parallel, FSDP
        batch_spec: P = P(DATA),
        grad_accum: int = 1,
        remat: bool = False,
    ):
        batch_spec = P(*batch_spec)
        if mesh is not None:
            have = axis_sizes(mesh)
            for a in _spec_axes(batch_spec):
                if a not in have:
                    raise ValueError(f"the mesh has no {a!r} axis to split the batch over: {have}")
            if param_specs is not None:
                for a in sorted({a for spec in spec_leaves(param_specs) for a in _spec_axes(spec)}):
                    if a not in have:
                        raise ValueError(f"param_specs place leaves over {a!r}, an axis the mesh lacks: {have}")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1; got {grad_accum}")
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.grad_accum = grad_accum
        self.remat = remat
        self.mesh = mesh
        # as in JAX, placements without a mesh place nothing
        self.param_specs = param_specs if mesh is not None else None
        self.batch_spec = batch_spec
        self.batch_axes = _spec_axes(batch_spec)
        # the step enters the mesh (the forward's tensor parallelism) only
        # where leaves are placed on its tensor axis: whole leaves under a
        # mesh with one run the one-card forward, as they do in JAX
        self._tensor_placed = self.param_specs is not None and any(
            TENSOR in _spec_axes(s) for s in spec_leaves(self.param_specs))

    def init_state(self, params) -> TrainState:
        """The state of ``params`` (the whole tree, on every rank): this
        rank's blocks under ``param_specs``, the moments made from them."""
        params = self.shard_params(params)
        return TrainState(params=params, opt_state=self.optimizer.init(params), step=0)

    def shard_params(self, params):
        """This rank's block of every leaf of the whole tree ``params``."""
        if self.param_specs is None:
            return params
        return shard_pytree(params, self.mesh, specs_for(params, self.param_specs))

    def placement(self, params) -> list | None:
        """One ``P`` a leaf of ``params`` (or of any tree of its structure:
        gradients, moments), in leaf order; None without placements."""
        if self.param_specs is None:
            return None
        return spec_leaves(specs_for(params, self.param_specs))

    def gather_tree(self, blocks, like=None):
        """Every placed leaf of ``blocks`` (parameters, gradients or moments:
        this rank's blocks, in the structure of ``like``, by default
        ``blocks``) all-gathered into the whole leaf, on every rank."""
        placement = self.placement(blocks if like is None else like)
        if placement is None:
            return blocks
        from ..parallel import collectives

        def whole(x, spec):
            for d, entry in enumerate(spec):
                if entry is not None:
                    x = collectives.all_gather(x, _single_axis(entry), gather_dim=d, mesh=self.mesh)
            return x

        with torch.no_grad():
            return tree.unflatten(blocks, [whole(x, s) for x, s in zip(tree.leaves(blocks), placement)])

    def _gather_on_use(self, p, spec):
        """A leaf's block gathered over every axis of its placement but
        ``tensor`` (the FSDP gather on use), with the gradient rule of
        ``collectives.gather_from``: reduce-scattered where the batch is
        split over the axis."""
        from ..parallel import collectives

        for d, entry in enumerate(spec):
            a = None if entry is None else _single_axis(entry)
            if a is not None and a != TENSOR:
                p = collectives.gather_from(p, a, gather_dim=d, mesh=self.mesh, sum_grad=a in self.batch_axes)
        return p

    def _value_and_grad(self, params, batch):
        """``(loss, gradients)`` of ``batch`` on this rank alone (a pair's
        total divided by its count)."""
        return _per_count(*self._terms_and_grad(params, batch))

    def _loss(self, p_tree, batch):
        """``loss_fn`` inside the mesh where leaves are tensor-placed (also
        when the backward recomputes it under ``remat``, on whichever thread
        autograd runs it)."""
        if not self._tensor_placed:
            return self.loss_fn(p_tree, batch)
        with enter_mesh(self.mesh):
            return self.loss_fn(p_tree, batch)

    def _terms_and_grad(self, params, batch):
        """``(total, count, gradients of total)``; ``count`` is None for a
        scalar ``loss_fn``. Under placements the gradients are this rank's
        blocks, summed over the gather axes the batch is split over."""
        flat = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        placement = self.placement(params)
        used = flat if placement is None else [self._gather_on_use(p, s) for p, s in zip(flat, placement)]
        p_tree = tree.unflatten(params, used)
        del used
        if self.remat:
            out = checkpoint(self._loss, p_tree, batch, use_reentrant=False)
        else:
            out = self._loss(p_tree, batch)
        del p_tree  # the gathered leaves now live only as long as the backward needs them
        total, count = out if isinstance(out, tuple) else (out, None)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        return total.detach(), count, tree.unflatten(params, grads)

    def shard_batch(self, batch):
        """This rank's block of the global batch (every leaf split by
        ``batch_spec``); the batch itself without a mesh."""
        if self.mesh is None:
            return batch
        return tree.map(lambda x: shard_tensor(x, self.batch_spec, self.mesh), batch)

    def _micro_loss_and_grads(self, params, micro):
        """One microbatch of the global batch: its loss and this rank's
        share of its gradients (summed over the batch axes, they are the
        microbatch's gradients)."""
        total, count, grads = self._terms_and_grad(params, self.shard_batch(micro))
        if self.mesh is not None and self.batch_axes:
            from ..parallel import collectives

            if count is None:  # a scalar loss: each rank's block weighs one
                count = torch.ones((), device=total.device)
            both = collectives.psum(torch.stack([total.float(), count.float()]), self.batch_axes, self.mesh)
            total, count = both[0], both[1]
        return _per_count(total, count, grads)

    def _sync(self, grads, placement):
        """Each leaf's gradient summed over the batch axes its gathers did
        not sum over already: one ``psum_tree`` per set of axes."""
        from ..parallel import collectives

        leaves = tree.leaves(grads)
        specs = placement or [P()] * len(leaves)
        groups: dict = {}
        for i, spec in enumerate(specs):
            gathered = {a for a in _spec_axes(spec) if a != TENSOR}
            groups.setdefault(tuple(a for a in self.batch_axes if a not in gathered), []).append(i)
        out = list(leaves)
        for axes, idx in groups.items():
            if axes:
                for i, g in zip(idx, collectives.psum_tree([leaves[i] for i in idx], axes, self.mesh)):
                    out[i] = g
        return tree.unflatten(grads, out)

    def loss_and_grads(self, params, batch):
        """The loss and the trainable gradients of the global ``batch``
        (under a mesh, summed over the batch axes, so every rank of them
        holds the same; under placements, this rank's blocks), averaged over
        the ``grad_accum`` microbatches."""
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
            grads = self._sync(grads, self.placement(params))
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
        grad_norm = global_norm(grads, self.placement(state.params), self.mesh)
        updates, opt_state = self.optimizer.update(grads, state.opt_state, state.params, norm=grad_norm)
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
