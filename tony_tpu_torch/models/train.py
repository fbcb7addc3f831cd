"""The train step: loss → gradients → optimizer update, on one device or
sharded over a mesh.

Port of ``tony_tpu/models/train.py``. The train state is a plain dict
``{"params", "opt_state", "step"}``; ``step`` and the optimizer's count
are host integers, advanced when a step is launched, so nothing on the
step path reads the card. PyTorch runs eagerly: no compile, no donation.
Instead the optimizers update params and moments in place, which is what
donation buys the JAX package, and the step returns the same dicts.

With a mesh (dp, fsdp, tp, ep, cp) the params and moments are DTensors
laid out by the logical-axis rules (:func:`init_state`), each process feeds its
local shard of the batch (:func:`global_batch`, :func:`batch_sharding`,
:func:`data_parallel_rank`), and the loss function runs each rank's
local shard (:mod:`tony_tpu_torch.parallel.spmd`); the gradients come
back on the params' placements and the global-norm clip sees every
shard. The fused optimizer (K4) refuses a mesh, as in the JAX package.

:class:`SGD` is ``optax.sgd`` (momentum, Nesterov), what the ResNet and
MNIST recipes train with.

Two optimizers come from :func:`default_optimizer`, as in the JAX package:

- ``fused=False`` (the default): clip by global norm 1.0 + AdamW +
  warmup-cosine with optax's semantics, written out in torch
  (:class:`ClippedAdamW`) — moments in the grads' dtype, eps outside the
  square root, decay on every leaf, the schedule read at the
  pre-increment count;
- ``fused=True``: :class:`~tony_tpu_torch.ops.optim.FusedAdamW`, the
  hand-written kernel K4 with f32 moments.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable

import numpy as np
import torch

from tony_tpu_torch import tree_leaves, tree_map
from tony_tpu_torch.ops.optim import FusedAdamW, _global_norm
from tony_tpu_torch.parallel.mesh import mesh_shape
from tony_tpu_torch.parallel.sharding import (DEFAULT_RULES, Rules,
                                              Sharding, logical_sharding,
                                              shard_pytree, spec_placements)
from tony_tpu_torch.runtime import metrics as metrics_mod

TrainState = dict


def masked_cross_entropy(logits: torch.Tensor,
                         targets: torch.Tensor) -> torch.Tensor:
    """Mean -log p[target] over positions with targets >= 0 (-1 =
    ignore), in f32 whatever the logits' storage dtype: logsumexp minus
    the target logit, the JAX package's form (it picks the target logit
    with a one-hot compare-and-reduce that XLA fuses; a gather picks the
    same value)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)                        # [B, S]
    picked = logits.gather(-1, targets.clamp(min=0)[..., None].long())[..., 0]
    mask = (targets >= 0).float()
    return ((lse - picked) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], np.float32]:
    """``count -> lr`` with optax's ``warmup_cosine_decay_schedule``
    arithmetic in f32: a linear ramp from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps`` (warmup included). Evaluated on the
    host from the host count."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = f32(decay_steps - warmup_steps)

    def linear(count: int) -> np.float32:
        if warmup_steps <= 0:
            return f32(init_value)
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1) - c / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count: int) -> np.float32:
        c = min(f32(count), cos_steps)
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / cos_steps))
        return f32(peak_value) * (f32(1 - alpha) * decay + f32(alpha))

    def schedule(count: int) -> np.float32:
        count = int(count)
        return linear(count) if count < warmup_steps \
            else cosine(count - warmup_steps)

    return schedule


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(lr, b1, b2,
    eps, weight_decay))`` in plain torch, with optax's semantics: moments
    in the grads' dtype, eps outside the square root, decay on every
    leaf, lr read at the pre-increment count and applied as ``-lr · u``,
    params updated as ``p + u``. The global norm is taken in f32 (optax
    sums squares in the grads' dtype; the two agree in f32). Params and
    moments are updated in place; :meth:`apply` returns ``(params,
    state, gnorm)`` like ``FusedAdamW.fused_apply``. DTensor leaves
    (sharded params, with grads and moments on the same placements) are
    updated shard by shard; the norm is the whole tree's."""

    def __init__(self, learning_rate: float | Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, clip_norm: float = 1.0):
        self._lr = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros_like(p)
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def apply(self, grads, state: dict, params):
        count = state["count"]
        lr = self._lr(count) if callable(self._lr) else self._lr
        f32 = np.float32
        bc1 = f32(1) - f32(self.b1) ** f32(count + 1)
        bc2 = f32(1) - f32(self.b2) ** f32(count + 1)
        leaves_g = tree_leaves(grads)
        gnorm = _global_norm(leaves_g)
        trigger = gnorm < self.clip_norm
        for p, g, m, v in zip(*(map(_local, tree_leaves(t)) for t in (
                params, grads, state["mu"], state["nu"]))):
            g = torch.where(trigger, g, g / gnorm.to(g.dtype)
                            * self.clip_norm)
            m.copy_((1 - self.b1) * g + self.b1 * m)
            v.copy_((1 - self.b2) * (g * g) + self.b2 * v)
            u = (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + self.eps)
            u = u + self.weight_decay * p
            p.add_(float(-lr) * u)
        new_state = {"count": count + 1, "mu": state["mu"],
                     "nu": state["nu"]}
        return params, new_state, gnorm


class SGD:
    """``optax.sgd(learning_rate, momentum, nesterov)`` in plain torch:
    the trace ``t ← g + momentum · t`` (in the params' dtype, as optax
    keeps it), the update ``-lr · t``, or ``-lr · (g + momentum · t)``
    with ``nesterov``, params updated as ``p + u``; no clipping, no
    decay. Same interface as :class:`ClippedAdamW`: params and trace are
    updated in place (DTensor leaves shard by shard), and :meth:`apply`
    returns ``(params, state, gnorm)``, the norm of the whole gradient
    tree in f32 (for the step's metrics; it scales nothing)."""

    def __init__(self, learning_rate: float, momentum: float,
                 nesterov: bool = False):
        self.lr, self.momentum, self.nesterov = (learning_rate, momentum,
                                                 nesterov)

    def init(self, params) -> dict:
        return {"count": 0,
                "trace": tree_map(lambda p: torch.zeros_like(p), params)}

    @torch.no_grad()
    def apply(self, grads, state: dict, params):
        leaves_g = tree_leaves(grads)
        gnorm = _global_norm(leaves_g)
        for p, g, t in zip(map(_local, tree_leaves(params)),
                           map(_local, leaves_g),
                           map(_local, tree_leaves(state["trace"]))):
            t.copy_(g + self.momentum * t)
            u = g + self.momentum * t if self.nesterov else t
            p.add_(u * -self.lr)
        return params, {"count": state["count"] + 1,
                        "trace": state["trace"]}, gnorm


def _local(t):
    """A DTensor's local shard (the same storage), a tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.01,
                      warmup_steps: int = 100, total_steps: int = 10_000,
                      fused: bool = False):
    """AdamW + linear warmup → cosine decay, the standard LM recipe.
    ``fused=True`` selects the single-pass CUDA update (K4) with f32
    moments; the default is the optax-semantics chain."""
    sched = warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps, max(total_steps, warmup_steps + 1))
    if fused:
        return FusedAdamW(sched, weight_decay=weight_decay, clip_norm=1.0)
    return ClippedAdamW(sched, weight_decay=weight_decay, clip_norm=1.0)


def init_state(params, optimizer, mesh=None, axes=None,
               rules: Rules = DEFAULT_RULES) -> TrainState:
    """The train state ``{"params", "opt_state", "step"}``; given a
    ``mesh`` and the params' logical ``axes``, the params are laid out
    on it first (:func:`~tony_tpu_torch.parallel.sharding.shard_pytree`)
    and the moments follow their placements."""
    if mesh is not None and axes is not None:
        params = shard_pytree(params, axes, mesh, rules)
    return {"params": params, "opt_state": optimizer.init(params),
            "step": 0}


def replicated_axes(tree):
    """The logical axes of a tree every leaf of which replicates (the
    ``axes`` of :func:`init_state` for a plain data-parallel model)."""
    return tree_map(lambda t: (None,) * t.dim(), tree)


def value_and_grad(loss_fn: Callable, params, *args,
                   has_aux: bool = False):
    """``jax.value_and_grad(loss_fn, has_aux=has_aux)(params, *args)``:
    ``(loss, grads)``, or ``((loss, aux), grads)`` when ``loss_fn``
    returns ``(loss, aux)``; ``grads`` has ``params``' structure. A leaf
    the loss does not read (BERT's type_embed without type_ids) gets a
    zero gradient, as jax.grad gives it."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        out = loss_fn(params, *args)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    it = (torch.zeros_like(t) if g is None else g
          for t, g in zip(leaves, grads))
    out = (loss.detach(), out[1]) if has_aux else loss.detach()
    return out, tree_map(lambda _: next(it), params)


def make_train_step(loss_fn: Callable[[Any, Any], torch.Tensor] | None,
                    optimizer, mesh=None,
                    value_and_grad_fn: Callable | None = None) -> Callable:
    """``step(state, batch) -> (state, {"loss", "grad_norm", "step"})``.

    ``loss_fn(params, batch) -> scalar``. The gradient is taken with
    respect to every leaf of ``state["params"]`` (zero for a leaf the
    loss does not read); an optimizer with
    ``fused_apply`` (K4) updates the params inside it, the other through
    its ``apply``. ``loss`` and ``grad_norm`` stay device tensors (reading
    them is the caller's choice). With a ``mesh`` the params are
    DTensors and ``loss_fn`` runs the sharded model (it takes the mesh
    itself); each gradient comes back on its leaf's placements (the
    backward of the step's gather), and the fused optimizer raises here,
    where the step is built.

    ``value_and_grad_fn(params, batch) -> (loss, grads)`` replaces the
    autograd of ``loss_fn`` for schedules that produce their own
    gradients (1F1B, :func:`~tony_tpu_torch.models.transformer
    .lm_value_and_grad`: its loss head runs inside the pipeline);
    ``loss_fn`` may then be None."""
    fused = hasattr(optimizer, "fused_apply")
    if fused and mesh is not None:
        raise ValueError("fused optimizers are single-device only: use "
                         "default_optimizer(fused=False) with a mesh")

    vag = value_and_grad_fn or (
        lambda params, batch: value_and_grad(loss_fn, params, batch))

    def step(state: TrainState, batch: Any):
        params = state["params"]
        loss, grads = vag(params, batch)
        if fused:
            params, opt_state, gnorm = optimizer.fused_apply(
                grads, state["opt_state"], params)
        else:
            params, opt_state, gnorm = optimizer.apply(
                grads, state["opt_state"], params)
        new_state = {"params": params, "opt_state": opt_state,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm,
                           "step": new_state["step"]}

    return _instrument_step(step)


def _instrument_step(step_fn: Callable) -> Callable:
    """Observe per-call wall time and example throughput into the default
    metrics registry (``tony_train_step_seconds`` histogram,
    ``tony_train_steps_total`` / ``tony_train_examples_total`` counters),
    as the JAX package does. The time is the host wall of the call: kernels
    run asynchronously, so in a saturated loop it tracks the step time
    only once the queue of launched work is full."""

    def instrumented(state, batch):
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        dt = time.perf_counter() - t0
        reg = metrics_mod.get_default()
        reg.histogram("tony_train_step_seconds",
                      help="host wall seconds per train-step dispatch"
                      ).observe(dt)
        reg.counter("tony_train_steps_total", help="train steps run").inc()
        leaves = tree_leaves(batch)
        if leaves and getattr(leaves[0], "shape", None):
            reg.counter("tony_train_examples_total",
                        help="examples consumed by train steps").inc(
                            leaves[0].shape[0])
        return out

    return instrumented


def batch_sharding(mesh, rules: Rules = DEFAULT_RULES,
                   logical: tuple = ("batch",)) -> Sharding:
    """The layout of input batches: the batch dimension over dp/fsdp, the
    rest replicated (callers append dimensions, e.g. ``("batch",
    "seq")`` for token arrays)."""
    return logical_sharding(logical, mesh, rules)


def data_parallel_rank(mesh, axes: tuple[str, ...] = ("dp", "fsdp")) -> int:
    """This process's rank along the data-parallel mesh axes, from its
    mesh coordinates (not its task index): the value to seed per-process
    data with. Processes at the same dp/fsdp coordinate (pure tp meshes,
    where the batch is replicated across processes) get the same rank
    and must feed identical data."""
    shape = mesh_shape(mesh)
    coord = dict(zip(shape, mesh.get_coordinate()))
    rank = 0
    for ax in axes:
        if ax in shape:
            rank = rank * shape[ax] + int(coord[ax])
    return rank


def data_parallel_size(mesh, axes: tuple[str, ...] = ("dp", "fsdp")) -> int:
    """The number of distinct batch shards over the data-parallel mesh
    axes: the count :func:`data_parallel_rank` ranges over."""
    shape = mesh_shape(mesh)
    return int(np.prod([shape[ax] for ax in axes if ax in shape],
                       dtype=np.int64))


def global_batch(sharding: Sharding, local_tree: Any) -> Any:
    """Each process's LOCAL batch shard as the global DTensors of
    ``sharding``: the global batch is the concatenation of the shards in
    data-parallel rank order (:func:`data_parallel_rank`), and processes
    that share a data rank must pass the same shard. Leaves are tensors
    already on the mesh's device; only the spec's batch entry is read:
    a shard holds its rows whole, so under cp (``("batch", "seq")``) the
    leaves replicate over cp and the step cuts each rank's chunk of the
    sequence."""
    from torch.distributed.tensor import DTensor
    placements = spec_placements(sharding.spec[:1], sharding.mesh)
    return tree_map(lambda x: DTensor.from_local(
        x, sharding.mesh, placements, run_check=False), local_tree)


def make_eval_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                   mesh=None) -> Callable:
    """``eval_step(params, batch) -> loss`` with no gradient recorded.
    ``mesh`` is accepted for the JAX package's signature: the sharded
    loss function takes the mesh itself, and the step adds nothing."""

    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(params, batch)

    return eval_step
