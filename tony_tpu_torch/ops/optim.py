"""Fused AdamW: a hand-written CUDA kernel plus its plain version.

Port of ``tony_tpu/ops/optim.py``. :class:`FusedAdamW` is clip by global
norm + AdamW + a schedule, with f32 moments, applied as one pass over
each leaf: the kernel K4 (``csrc/adamw.cu``, through :func:`adamw_update`)
for CUDA tensors, the plain version :func:`_plain_leaf_update` for CPU
tensors. Same numerics as the JAX ``FusedAdamW.fused_apply``:

- moments are f32 whatever the params' dtype;
- the schedule is read at the pre-increment count (optax's
  ``scale_by_schedule``: the first step sees the schedule at 0);
- the global-norm clip is a reduction outside the kernel, entering it as
  a scalar scale; ``1/bc1`` and ``1/bc2`` enter as scalars too;
- decoupled weight decay on every leaf; params round to their storage
  dtype once per step.

The eight scalars ``[lr, b1, b2, eps, wd, 1/bc1, 1/bc2, clip]`` live in a
small device tensor: the clip scale is a device value, and the count that
sets lr and the bias corrections is a host integer kept in the optimizer
state, advanced when a step is launched, so the step never reads the card.

Params, moments and grads are updated IN PLACE: the JAX kernel aliases
p/m/v in→out under donation (``input_output_aliases``), and the port
writes into the same tensors. The TPU's ``(rows, 128·k)`` leaf views and
its 65536-element gate are VMEM choices; here every leaf, whatever its
size, is one launch of the same kernel.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tony_tpu_torch import tree_leaves, tree_map
from tony_tpu_torch.ops import _kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _plain_leaf_update(p, g, m, v, scalars):
    """One leaf's update in plain torch, the counterpart of the JAX
    ``_xla_leaf_update``: returns new ``(p, m, v)`` with p in its dtype
    and m, v in theirs. Every operation rounds on its own, as the kernel's
    explicitly rounded intrinsics do."""
    lr, b1, b2, eps, wd, inv_bc1, inv_bc2, clip = scalars.unbind(0)
    g = g.float() * clip
    new_m = b1 * m.float() + (1 - b1) * g
    new_v = b2 * v.float() + (1 - b2) * g * g
    update = (new_m * inv_bc1) / (torch.sqrt(new_v * inv_bc2) + eps) \
        + wd * p.float()
    return ((p.float() - lr * update).to(p.dtype), new_m.to(m.dtype),
            new_v.to(v.dtype))


def adamw_update(p, g, m, v, scalars) -> None:
    """Update one leaf in place: p (f32 or bf16), g (p's dtype), m and v
    (f32), scalars ``[8]`` f32 on the same device. A CUDA leaf launches
    K4 on the current stream without synchronising
    (``adamw_update.launches`` counts launches); a CPU leaf takes
    :func:`_plain_leaf_update`."""
    if p.shape != g.shape or p.shape != m.shape or p.shape != v.shape:
        raise ValueError(f"p, g, m, v shapes differ: {p.shape}, {g.shape}, "
                         f"{m.shape}, {v.shape}")
    if p.dtype not in _DTYPE_CODES or g.dtype != p.dtype:
        raise TypeError(f"adamw_update takes f32 or bf16 p with g of the "
                        f"same dtype, got {p.dtype}/{g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("adamw_update keeps f32 moments")
    if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
        raise ValueError("p, m and v are updated in place and must be "
                         "contiguous")
    if p.device.type == "cpu":
        new_p, new_m, new_v = _plain_leaf_update(p, g, m, v, scalars)
        p.copy_(new_p)
        m.copy_(new_m)
        v.copy_(new_v)
        return
    if not all(t.is_cuda and t.device == p.device
               for t in (g, m, v, scalars)):
        raise ValueError("adamw_update: every tensor on the leaf's card")
    if scalars.dtype != torch.float32 or scalars.shape != (8,):
        raise ValueError("scalars must be an f32 tensor of 8")
    g, scalars = g.contiguous(), scalars.contiguous()
    fn = _kernels.load().tony_adamw
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                scalars.data_ptr(), _DTYPE_CODES[p.dtype], p.numel(),
                stream)
    _kernels.check(rc, "adamw")
    adamw_update.launches += 1


adamw_update.launches = 0


def _global_norm(leaves) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in f32, as a 0-d tensor on
    the leaves' device. A DTensor leaf counts every shard once: its local
    sum of squares is summed over the mesh dimensions it is sharded on
    (one all-reduce per dimension and distinct layout), so every rank
    gets the norm of the whole tree, as the JAX package's norm of a
    sharded tree is."""
    import torch.distributed as dist
    total = None
    by_layout: dict = {}
    for x in leaves:
        if hasattr(x, "placements"):
            key = (x.device_mesh, tuple(i for i, p in enumerate(x.placements)
                                        if p.is_shard()))
            sq = torch.sum(torch.square(x.to_local().float()))
            by_layout[key] = by_layout.get(key, 0) + sq
        else:
            sq = torch.sum(torch.square(x.float()))
            total = sq if total is None else total + sq
    for (mesh, dims), sq in by_layout.items():
        for i in dims:
            dist.all_reduce(sq, group=mesh.get_group(i))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _check_no_aliasing(*trees) -> None:
    """Each leaf is updated in place: two leaves that share memory would
    be updated twice."""
    ptrs = [t.data_ptr() for tree in trees for t in tree_leaves(tree)]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("params, grads and moments must not share memory")


class FusedAdamW:
    """Fused clip-by-global-norm + AdamW + schedule, one kernel pass per
    leaf. Matches ``optax.chain(optax.clip_by_global_norm(clip_norm),
    optax.adamw(lr, b1, b2, eps, weight_decay, mu_dtype=f32))`` to fp
    tolerance. Consumed by ``make_train_step`` through the
    ``fused_apply`` protocol: ``(grads, state, params) -> (params, state,
    gnorm)``, params updated inside (in place)."""

    def __init__(self, learning_rate: float | Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, clip_norm: float | None = 1.0):
        self._lr = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params) -> dict:
        """``{"count": 0, "mu", "nu"}``: f32 zero moments shaped like the
        params, on their devices."""
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def host_scalars(self, count: int) -> np.ndarray:
        """``[lr, b1, b2, eps, wd, 1/bc1, 1/bc2]`` in f32 for the step
        after ``count`` steps: lr at the pre-increment count, the bias
        corrections at the incremented one."""
        f32 = np.float32
        lr = self._lr(count) if callable(self._lr) else self._lr
        cf = f32(count + 1)
        one = f32(1.0)
        return np.array([lr, self.b1, self.b2, self.eps, self.weight_decay,
                         one / (one - f32(self.b1) ** cf),
                         one / (one - f32(self.b2) ** cf)], np.float32)

    def fused_apply(self, grads, state: dict, params):
        leaves_p = tree_leaves(params)
        leaves_g = tree_leaves(grads)
        leaves_m = tree_leaves(state["mu"])
        leaves_v = tree_leaves(state["nu"])
        _check_no_aliasing(params, grads, state["mu"], state["nu"])
        dev = leaves_p[0].device
        gnorm = _global_norm(leaves_g)
        if self.clip_norm is not None:
            clip = torch.where(gnorm < self.clip_norm,
                               torch.ones_like(gnorm),
                               self.clip_norm / torch.clamp(gnorm, min=1e-20))
        else:
            clip = torch.ones_like(gnorm)
        host = torch.from_numpy(self.host_scalars(state["count"]))
        if dev.type == "cuda":
            # pinned and non-blocking: a pageable copy would wait for the
            # kernels already queued
            host = host.pin_memory().to(dev, non_blocking=True)
        scalars = torch.cat([host, clip.reshape(1).float()])
        for p, g, m, v in zip(leaves_p, leaves_g, leaves_m, leaves_v):
            adamw_update(p, g, m, v, scalars)
        new_state = {"count": state["count"] + 1, "mu": state["mu"],
                     "nu": state["nu"]}
        return params, new_state, gnorm
