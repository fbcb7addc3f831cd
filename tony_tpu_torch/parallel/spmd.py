"""How a sharded step runs: on each rank's local shards, with explicit
collectives.

The JAX package annotates layouts (``constrain``) and lets XLA insert the
collectives. The port keeps the layouts and writes the collectives out,
because its kernels are launched on plain local tensors (DTensor has no
sharding rule for them). Under the default rules a rank holds:

- the batch split over the data axes (``dp`` and ``fsdp``, whatever
  ``"batch"`` resolves to), every activation replicated over the model
  axis (``tp``) except the ones the reference constrains onto it: q, k,
  v and attention outputs by heads, the MLP hidden by ``"mlp"``, the
  logits by ``"vocab"``;
- each parameter gathered over the data axes once per step
  (:meth:`Layout.local_params`), its model-axis shard kept.

Inside a layer this is Megatron-style tensor parallelism:
:func:`copy_to_model` before a column-parallel product (identity forward,
all-reduce of the gradient), :func:`reduce_from_model` after a
row-parallel one (all-reduce forward, identity backward), a
vocab-parallel embedding lookup and a vocab-parallel cross-entropy
(the logits are never gathered). Gradients of the gathered parameters
come back through DTensor: partial over the data axes, they are summed
(dp) or reduce-scattered (fsdp) onto each leaf's own placements.

cp, pp and ep (and rule tables that would split the residual stream)
raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tony_tpu_torch.parallel.mesh import mesh_shape
from tony_tpu_torch.parallel.sharding import (DEFAULT_RULES, Rules,
                                              logical_to_spec, spec_axes,
                                              spec_placements)

#: mesh axes whose strategies are not ported: any of them of size > 1
#: raises
_UNPORTED = {"pp": "pipeline", "cp": "context", "ep": "expert"}


def _all_reduce(x: torch.Tensor, groups, op=dist.ReduceOp.SUM):
    """``x`` reduced over each group in turn (a new tensor)."""
    x = x.clone()
    for g in groups:
        dist.all_reduce(x, op=op, group=g)
    return x


class _SumOver(torch.autograd.Function):
    """All-reduce sum forward, identity backward: the result is
    replicated, and every rank differentiates the same replicated value,
    so each rank's input gets the cotangent as it is."""

    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce sum of the cotangent backward: a
    replicated input read by rank-local products gets the sum of every
    rank's partial gradient."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


class Layout:
    """The local-shard layout of a mesh under a rule table, validated.

    - ``data_axes``: the live mesh axes ``"batch"`` splits over;
    - ``model_axis``: the live axis ``"heads"``, ``"mlp"`` and ``"vocab"``
      all resolve to, or None;
    - ``model_rank`` / ``model_size``: this rank's coordinate on it.
    """

    def __init__(self, mesh, rules: Rules = DEFAULT_RULES):
        shape = mesh_shape(mesh)
        for ax, what in _UNPORTED.items():
            if shape.get(ax, 1) > 1:
                raise NotImplementedError(
                    f"{what} parallelism ({ax}={shape[ax]}) is not ported "
                    f"yet; the port runs dp, fsdp and tp")
        self.mesh, self.rules = mesh, rules
        self.data_axes = spec_axes(logical_to_spec(("batch",), mesh,
                                                   rules)[0])
        used = set(self.data_axes)
        model = {name: logical_to_spec(("batch", name), mesh, rules)[1]
                 for name in ("heads", "mlp", "vocab")}
        if len(set(model.values())) != 1 or isinstance(
                model["heads"], tuple):
            raise NotImplementedError(
                f"heads, mlp and vocab must resolve to one mesh axis (or "
                f"none), got {model}")
        self.model_axis = model["heads"]
        for name in ("embed", "seq", "kv", "norm", "stage"):
            entry = logical_to_spec(("batch", name), mesh, rules)[1]
            if entry is not None:
                raise NotImplementedError(
                    f"rules that split activations' {name!r} dimension "
                    f"(over {entry}) are not ported")
        for name in ("embed", "stage", "norm", "kv"):
            if not set(spec_axes(logical_to_spec((name,), mesh,
                                                 rules)[0])) <= used:
                raise NotImplementedError(
                    f"rules that split parameters' {name!r} dimension "
                    f"over a non-data axis are not ported")
        self._names = list(shape)
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        self._coord = dict(zip(self._names, coord))
        self.model_size = shape[self.model_axis] if self.model_axis else 1
        self.model_rank = (self._coord[self.model_axis]
                           if self.model_axis else 0)
        self._data_groups = [mesh.get_group(a) for a in self.data_axes]
        self._model_groups = ([mesh.get_group(self.model_axis)]
                              if self.model_axis else [])
        self.data_size = 1
        self.data_rank = 0
        for a in self.data_axes:
            self.data_size *= shape[a]
            self.data_rank = self.data_rank * shape[a] + self._coord[a]

    # -- parameters and inputs ----------------------------------------
    def local_params(self, tree, partial=frozenset(), _path=()):
        """Each DTensor leaf of ``tree`` as a local tensor for the step:
        gathered over every axis but the model axis, its model-axis shard
        kept. Its gradient comes back partial over the data axes (the
        batch is split there) and, over the model axis, as its shard
        where it is sharded, else replicated — or partial for the leaves
        whose paths (key tuples) are in ``partial``, those a rank reads
        only in part (GQA's K/V projections under tp). Plain tensors pass
        through."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        if isinstance(tree, dict):
            return {k: self.local_params(v, partial, _path + (k,))
                    for k, v in tree.items()}
        if not isinstance(tree, DTensor):
            return tree
        compute, grad = [], []
        for name, p in zip(self._names, tree.placements):
            if name == self.model_axis:
                compute.append(p)
                grad.append(Partial() if _path in partial and not
                            p.is_shard() else p)
            else:
                compute.append(Replicate())
                grad.append(Partial() if name in self.data_axes
                            else Replicate())
        return tree.redistribute(self.mesh, compute).to_local(
            grad_placements=grad)

    def local(self, x):
        """This rank's shard of a batch leaf split by ``"batch"``: a
        DTensor's local tensor in the batch layout, or rows of a plain
        tensor, which is taken as the global batch."""
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            spec = logical_to_spec(("batch",), self.mesh, self.rules)
            return x.redistribute(self.mesh, spec_placements(
                spec, self.mesh)).to_local()
        if x.shape[0] % self.data_size:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over {self.data_size} data ranks")
        rows = x.shape[0] // self.data_size
        return x[self.data_rank * rows:(self.data_rank + 1) * rows]

    def wrap(self, x: torch.Tensor, logical_axes):
        """A local activation as the global DTensor of its layout."""
        from torch.distributed.tensor import DTensor
        spec = logical_to_spec(logical_axes, self.mesh, self.rules)
        return DTensor.from_local(x, self.mesh,
                                  spec_placements(spec, self.mesh),
                                  run_check=False)

    # -- collectives --------------------------------------------------
    def copy_to_model(self, x):
        """Before a column-parallel product: see :func:`copy_to_model`."""
        return copy_to_model(x, self)

    def reduce_from_model(self, x):
        return reduce_from_model(x, self)

    def sum_data(self, x):
        """Sum over the data ranks, identity backward."""
        if not self._data_groups:
            return x
        return _SumOver.apply(x, self._data_groups)

    def count_data(self, x):
        """Sum over the data ranks, outside autograd."""
        if not self._data_groups:
            return x
        return _all_reduce(x.detach(), self._data_groups)


def _model_live(lay) -> bool:
    return lay is not None and lay.model_size > 1


def copy_to_model(x, lay):
    """Identity forward; the gradient is summed over the model axis
    (Megatron's f). No-op without a live model axis."""
    return _CopyTo.apply(x, lay._model_groups) if _model_live(lay) else x


def reduce_from_model(x, lay):
    """Sum over the model axis, identity backward (Megatron's g). No-op
    without a live model axis."""
    return _SumOver.apply(x, lay._model_groups) if _model_live(lay) else x


def _vocab_range(lay, local: int, total: int) -> tuple[int, int]:
    if local * lay.model_size != total:
        raise ValueError(f"vocab {total} does not split evenly over "
                         f"{lay.model_axis}={lay.model_size}")
    lo = lay.model_rank * local
    return lo, lo + local


def embed_lookup(w: torch.Tensor, tokens: torch.Tensor, lay,
                 vocab: int) -> torch.Tensor:
    """``w[tokens]``; with ``w`` split by vocab over the model axis, each
    rank looks up the tokens in its range (zeros elsewhere) and the
    ranks' rows are summed."""
    if not _model_live(lay) or w.shape[0] == vocab:
        return w[tokens.long()]
    lo, hi = _vocab_range(lay, w.shape[0], vocab)
    t = tokens.long() - lo
    inside = (t >= 0) & (t < hi - lo)
    x = w[t.clamp(0, hi - lo - 1)] * inside[..., None].to(w.dtype)
    return reduce_from_model(x, lay)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, lay,
                  vocab: int) -> torch.Tensor:
    """The global masked mean of ``-log p[target]`` (targets ``-1``
    ignored) from this rank's logits ``[b, s, V or V/tp]``: f32
    logsumexp minus the target logit, summed over the local positions and
    then over the data ranks, over the global count of targets. With the
    vocab split over the model axis the logsumexp and the target logit
    are combined across it (max, then sums), never gathering the logits.
    With neither split it is ``masked_cross_entropy`` op for op."""
    logits = logits.float()
    if not _model_live(lay) or logits.shape[-1] == vocab:
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(
            -1, targets.clamp(min=0)[..., None].long())[..., 0]
    else:
        lo, hi = _vocab_range(lay, logits.shape[-1], vocab)
        m = _all_reduce(logits.detach().amax(dim=-1), lay._model_groups,
                        op=dist.ReduceOp.MAX)
        sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
        lse = m + torch.log(reduce_from_model(sumexp, lay))
        t = targets.long() - lo
        inside = (t >= 0) & (t < hi - lo)
        picked = logits.gather(-1, t.clamp(0, hi - lo - 1)[..., None])[..., 0]
        picked = reduce_from_model(picked * inside.float(), lay)
    mask = (targets >= 0).float()
    num = lay.sum_data(((lse - picked) * mask).sum())
    den = lay.count_data(mask.sum())
    return num / torch.clamp(den, min=1.0)
