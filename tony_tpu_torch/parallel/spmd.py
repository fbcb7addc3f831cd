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

Expert parallelism (``ep``): ``"expert"`` resolves to a mesh axis of
its own, the batch stays on the data axes, so every activation is
replicated over ep, and a rank keeps its ep shard of the expert leaves
(:meth:`Layout.local_params`); :func:`~tony_tpu_torch.parallel.moe.moe_ffn`
runs this rank's experts and sums their outputs over ep.

Context parallelism (``cp``): ``"seq"`` resolves to a mesh axis of its
own, and a rank holds its data rows' chunk of the sequence
(:meth:`Layout.local`: rank ``i`` of ``cp`` holds positions ``[i·S/cp,
(i+1)·S/cp)``). Every layer but attention is position-wise, so it runs on
the chunk as it is; attention exchanges K/V around the cp ring
(:mod:`~tony_tpu_torch.parallel.ring_attention`) or re-shards heads by
all-to-all (:mod:`~tony_tpu_torch.parallel.ulysses`), and MoE routing
takes its capacity slots after the lower ranks'
(:func:`~tony_tpu_torch.parallel.moe.moe_ffn`). Parameters replicate
over cp, and each rank's gradient is the partial sum over its chunk,
summed over cp as over the data axes; the loss sums over the data and cp
ranks. A dict of sizes with a live cp axis runs every cp rank in one
process on the global tensors (:class:`EmulatedCp`).

Pipeline parallelism (``pp``): ``"stage"`` resolves to a mesh axis of
its own, and a rank keeps its pp shard of the stacked ``[L, ...]``
blocks: a contiguous group of ``L/pp`` layers, gathered over every other
axis but ep (inside a stage the blocks run whole on the stage's
microbatches, as the reference's ``shard_map`` body does; experts stay
split over ep). Embed, the final norm and the lm_head replicate over pp.
The schedules are :mod:`~tony_tpu_torch.parallel.pipeline`'s;
:meth:`Layout.stage_layout` is the layout a stage's blocks run under.
Under pp the sequence is not cut: the reference's stage body runs
unsharded in cp, so every cp rank runs whole sequences and cp
replicates (its gradients whole, not partial; the loss not summed over
it). A model that is not pipelined (BERT, ``Layout(...,
pipelined=False)``) gathers its stacked blocks over pp instead, every pp
rank running every layer, their gradients replicated over pp.
:class:`_SumOver` is the reference's ``psum_rep`` (all-reduce forward,
identity backward).

Inference (tensor-parallel decoding, ``models/decode.py``) runs outside
autograd on the same shards: the data axes replicate (every rank decodes
the whole batch), a rank runs its query heads, kv heads, MLP hidden (an
MoE model's: its experts' slice of it, its experts under ep) and vocab
slice, and :class:`ModelRanks` gives the plain sum after a row-parallel
product (over ep, then tp, for an MoE block) and the gather of
vocab-split logits. One rank body
serves a ``DeviceMesh`` (this rank, collectives in its tp group) and a
dict of sizes (every rank in turn in this process,
:func:`emulated_shards`), adding the ranks' parts in rank order in both,
so the two agree bit for bit.

Rule tables that would split the residual stream raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

import copy

from tony_tpu_torch.parallel.mesh import mesh_shape
from tony_tpu_torch.parallel.sharding import (DEFAULT_RULES, Rules,
                                              logical_to_spec, spec_axes,
                                              spec_placements)


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


def model_axis(mesh, rules: Rules = DEFAULT_RULES):
    """The one mesh axis ``"heads"``, ``"mlp"`` and ``"vocab"`` resolve to
    on ``mesh`` (a ``DeviceMesh`` or its sizes), or None; rule tables
    that split them over several axes, or over different ones, raise
    ``NotImplementedError``."""
    model = {name: logical_to_spec(("batch", name), mesh, rules)[1]
             for name in ("heads", "mlp", "vocab")}
    if len(set(model.values())) != 1 or isinstance(model["heads"], tuple):
        raise NotImplementedError(
            f"heads, mlp and vocab must resolve to one mesh axis (or "
            f"none), got {model}")
    return model["heads"]


class Layout:
    """The local-shard layout of a mesh under a rule table, validated.

    - ``data_axes``: the live mesh axes ``"batch"`` splits over;
    - ``model_axis``: the live axis ``"heads"``, ``"mlp"`` and ``"vocab"``
      all resolve to, or None;
    - ``model_rank`` / ``model_size``: this rank's coordinate on it;
    - ``expert_axis`` / ``expert_rank``: the same for ``"expert"``
      (experts over ep), an axis of its own;
    - ``cp_axis`` / ``cp_rank`` / ``cp_size`` / ``cp_group``: the same
      for ``"seq"`` (the sequence over cp), an axis of its own; the
      group is None without a live axis;
    - ``pp_axis`` / ``pp_rank`` / ``pp_size`` / ``pp_group``: the same
      for the parameters' ``"stage"`` (the stacked blocks over pp).

    With a live pp axis the cp fields are those of no axis (a pipeline
    stage runs whole sequences); with ``pipelined=False`` the pp fields
    are (the blocks gathered over pp, as any replicated leaf).
    """

    def __init__(self, mesh, rules: Rules = DEFAULT_RULES,
                 pipelined: bool = True):
        shape = mesh_shape(mesh)
        self.mesh, self.rules = mesh, rules
        self.data_axes = spec_axes(logical_to_spec(("batch",), mesh,
                                                   rules)[0])
        used = set(self.data_axes)
        self.model_axis = model_axis(mesh, rules)
        self.expert_axis = logical_to_spec(("batch", "expert"), mesh,
                                           rules)[1]
        if isinstance(self.expert_axis, tuple) or (
                self.expert_axis is not None
                and self.expert_axis == self.model_axis):
            raise NotImplementedError(
                f"expert must resolve to one mesh axis of its own (or "
                f"none), got {self.expert_axis}")
        self.cp_axis = logical_to_spec(("batch", "seq"), mesh, rules)[1]
        if isinstance(self.cp_axis, tuple) or (
                self.cp_axis is not None
                and self.cp_axis in (self.model_axis, self.expert_axis)):
            raise NotImplementedError(
                f"seq must resolve to one mesh axis of its own (or none), "
                f"got {self.cp_axis}")
        for name in ("embed", "kv", "norm"):
            entry = logical_to_spec(("batch", name), mesh, rules)[1]
            if entry is not None:
                raise NotImplementedError(
                    f"rules that split activations' {name!r} dimension "
                    f"(over {entry}) are not ported")
        self.pp_axis = logical_to_spec(("stage",), mesh, rules)[0]
        if isinstance(self.pp_axis, tuple) or (
                self.pp_axis is not None and self.pp_axis in (
                    self.model_axis, self.expert_axis, self.cp_axis,
                    *self.data_axes)):
            raise NotImplementedError(
                f"stage must resolve to one mesh axis of its own (or "
                f"none), got {self.pp_axis}")
        used = used | ({self.pp_axis} if self.pp_axis else set())
        for name in ("embed", "norm", "kv"):
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
        self.expert_rank = (self._coord[self.expert_axis]
                            if self.expert_axis else 0)
        self.expert_size = shape[self.expert_axis] if self.expert_axis else 1
        #: the groups an MoE block's partial outputs sum over: ep, then tp
        self.expert_model_groups = (
            ([mesh.get_group(self.expert_axis)] if self.expert_axis
             else []) + self._model_groups)
        self.data_size = 1
        self.data_rank = 0
        for a in self.data_axes:
            self.data_size *= shape[a]
            self.data_rank = self.data_rank * shape[a] + self._coord[a]
        self.cp_size = shape[self.cp_axis] if self.cp_axis else 1
        self.cp_rank = self._coord[self.cp_axis] if self.cp_axis else 0
        self.cp_group = (mesh.get_group(self.cp_axis) if self.cp_axis
                         else None)
        #: the groups a loss sums over: the data axes, then cp
        self._loss_groups = self._data_groups + (
            [self.cp_group] if self.cp_axis else [])
        self.pp_size = shape[self.pp_axis] if self.pp_axis else 1
        self.pp_rank = self._coord[self.pp_axis] if self.pp_axis else 0
        self.pp_group = (mesh.get_group(self.pp_axis) if self.pp_axis
                         else None)
        if self.pp_axis is not None and not pipelined:
            self.pp_axis, self.pp_size, self.pp_rank, self.pp_group = (
                None, 1, 0, None)
        elif self.pp_axis is not None and self.cp_axis is not None:
            self.cp_axis, self.cp_size, self.cp_rank, self.cp_group = (
                None, 1, 0, None)
            self._loss_groups = list(self._data_groups)

    def stage_layout(self):
        """The layout a pipeline stage's blocks run under: no model axis
        (the blocks are gathered over it) and no cp; the expert axis
        kept (the stage's experts stay split over ep, the MoE block's
        outputs summed over it); the loss and routing counts local to
        the rank's microbatch shard (the pipeline averages the aux over
        the data axes). None when nothing of it is live."""
        if self.expert_axis is None:
            return None
        lay = copy.copy(self)
        lay.model_axis, lay.model_size, lay.model_rank = None, 1, 0
        lay._model_groups = []
        lay.expert_model_groups = [self.mesh.get_group(self.expert_axis)]
        lay.cp_axis, lay.cp_size, lay.cp_rank, lay.cp_group = (None, 1, 0,
                                                               None)
        lay._data_groups, lay._loss_groups = [], []
        lay.data_size, lay.data_rank = 1, 0
        return lay

    # -- parameters and inputs ----------------------------------------
    def local_params(self, tree, partial=frozenset(), _path=()):
        """Each DTensor leaf of ``tree`` as a local tensor for the step:
        gathered over every axis but the model and expert axes, its
        shards there kept. Its gradient comes back partial over the data
        axes and cp (the batch and the sequence are split there), on its
        own placement over the
        expert axis and, over the model axis, as its shard
        where it is sharded, else replicated — or partial for the leaves
        whose paths (key tuples) are in ``partial``, those a rank reads
        only in part (GQA's K/V projections under tp). A named tuple (a
        quantized weight's q and scale) has each of its fields laid out
        so. Under pp a leaf
        split over it (the stacked blocks) keeps its stage's shard and is
        gathered over the model axis too (a stage runs its blocks
        whole). Plain tensors pass through."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        if isinstance(tree, dict):
            return {k: self.local_params(v, partial, _path + (k,))
                    for k, v in tree.items()}
        if _is_record(tree):
            return type(tree)(*(self.local_params(v, partial, _path)
                                for v in tree))
        if not isinstance(tree, DTensor):
            return tree
        staged = self.pp_axis is not None and tree.placements[
            self._names.index(self.pp_axis)].is_shard()
        compute, grad = [], []
        for name, p in zip(self._names, tree.placements):
            if name == self.pp_axis:
                compute.append(p)
                grad.append(p)
            elif name == self.model_axis and staged:
                compute.append(Replicate())
                grad.append(Replicate())
            elif name == self.model_axis:
                compute.append(p)
                grad.append(Partial() if _path in partial and not
                            p.is_shard() else p)
            elif name == self.expert_axis:
                compute.append(p)
                grad.append(p)
            else:
                compute.append(Replicate())
                grad.append(Partial() if name in self.data_axes
                            or name == self.cp_axis else Replicate())
        return tree.redistribute(self.mesh, compute).to_local(
            grad_placements=grad)

    def local(self, x):
        """This rank's shard of a batch leaf laid out by ``("batch",
        "seq")``: its rows and, under cp, its chunk of the sequence
        (dimension 1). A DTensor's local tensor in that layout, or a
        slice of a plain tensor, which is taken as the global batch."""
        from torch.distributed.tensor import DTensor
        logical = ("batch", "seq")[:x.dim()]
        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, spec_placements(
                self._spec(logical), self.mesh)).to_local()
        if x.shape[0] % self.data_size:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over {self.data_size} data ranks")
        rows = x.shape[0] // self.data_size
        x = x[self.data_rank * rows:(self.data_rank + 1) * rows]
        if self.cp_size == 1 or x.dim() < 2:
            return x
        if x.shape[1] % self.cp_size:
            raise ValueError(f"a sequence of {x.shape[1]} does not split "
                             f"over {self.cp_axis}={self.cp_size}")
        n = x.shape[1] // self.cp_size
        return x[:, self.cp_rank * n:(self.cp_rank + 1) * n]

    def wrap(self, x: torch.Tensor, logical_axes):
        """A local activation as the global DTensor of its layout."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(
            x, self.mesh, spec_placements(self._spec(logical_axes),
                                          self.mesh), run_check=False)

    def _spec(self, logical_axes) -> tuple:
        """The spec of an activation's logical axes on this layout: the
        rule table's, with ``"seq"`` unsplit where cp is not live here
        (under pp)."""
        spec = logical_to_spec(logical_axes, self.mesh, self.rules)
        if self.cp_axis is None:
            spec = tuple(None if name == "seq" else e
                         for name, e in zip(logical_axes, spec))
        return spec

    # -- collectives --------------------------------------------------
    def copy_to_model(self, x):
        """Before a column-parallel product: see :func:`copy_to_model`."""
        return copy_to_model(x, self)

    def reduce_from_model(self, x):
        return reduce_from_model(x, self)

    def sum_data(self, x):
        """Sum over the data and cp ranks, identity backward."""
        if not self._loss_groups:
            return x
        return _SumOver.apply(x, self._loss_groups)

    def sync_data(self, x):
        """Sum over the data ranks, all-reduce backward too: for a
        statistic of the global batch that feeds every rank's rows
        (sync-BN's sums), whose cotangent each rank holds only in part.
        (:meth:`sum_data`'s identity backward would drop the other
        ranks' parts.)"""
        if not self._data_groups:
            return x
        groups = self._data_groups
        return _SumOver.apply(_CopyTo.apply(x, groups), groups)

    def count_data(self, x):
        """Sum over the data and cp ranks, outside autograd."""
        if not self._loss_groups:
            return x
        return _all_reduce(x.detach(), self._loss_groups)

    def model_ranks(self) -> "ModelRanks":
        """This rank of the model axis, with its group (see
        :class:`ModelRanks`)."""
        return ModelRanks(self.model_size, (self.model_rank,),
                          self._model_groups[0] if self.model_size > 1
                          else None)

    def expert_ranks(self) -> "ModelRanks":
        """This rank of the expert axis, with its group: the same
        collectives as :meth:`model_ranks` for the sum over ep of an MoE
        block's partial outputs."""
        return ModelRanks(self.expert_size, (self.expert_rank,),
                          self.mesh.get_group(self.expert_axis)
                          if self.expert_size > 1 else None)


class EmulatedCp:
    """The layout of a dict of sizes with a live cp axis: every cp rank
    run in this process on the global tensors. The position-wise layers
    run on them whole; attention cuts them into the ranks' chunks and
    runs the emulated ring or Ulysses
    (:func:`~tony_tpu_torch.parallel.ring_attention.ring_attention_emulated`,
    :func:`~tony_tpu_torch.parallel.ulysses.ulysses_attention_emulated`);
    MoE routes each chunk after the lower ranks' as a cp rank does
    (:func:`~tony_tpu_torch.parallel.moe.moe_ffn`). No other axis is
    emulated (the data, model and expert axes leave the function as it
    is unsharded), so nothing is summed across ranks here: the global
    tensors already hold every rank's part."""

    model_size, cp_rank, cp_group = 1, 0, None

    def __init__(self, cp_size: int):
        self.cp_size = cp_size
        self.expert_model_groups = []

    def sum_data(self, x):
        return x

    def count_data(self, x):
        return x


def _is_record(x) -> bool:
    """A named tuple (a record of tensors, such as a quantized weight)."""
    return isinstance(x, tuple) and hasattr(x, "_fields")


class ModelRanks:
    """The model-axis (tp) ranks whose shards this process computes, and
    the two collectives between them that inference needs, outside
    autograd: :meth:`sum` after a row-parallel product and :meth:`gather`
    of vocab-split logits. A rank body runs once for each of ``ranks``
    and hands the collectives one part per rank, in rank order:

    - distributed (a ``DeviceMesh``): ``ranks`` is this process's own
      rank and ``group`` the model axis's process group;
    - emulated (a dict of sizes): ``ranks`` is every rank of the axis,
      run in turn in this process (the form one card runs), and no
      group;
    - unsharded: one rank of one.

    Both forms add the ranks' parts in rank order — the distributed sum
    gathers them first — so every rank and the emulation get the same
    bits."""

    def __init__(self, size: int, ranks, group=None):
        self.size, self.ranks, self.group = size, tuple(ranks), group

    def _everyone(self, parts: list) -> list:
        if self.group is None:
            return parts
        x = parts[0].contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return out

    def sum(self, parts: list) -> torch.Tensor:
        """The sum of every rank's part, added in rank order."""
        parts = self._everyone(parts)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def gather(self, parts: list, dim: int = -1) -> torch.Tensor:
        """Every rank's part concatenated along ``dim`` in rank order."""
        parts = self._everyone(parts)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


#: the model axis of an unsharded run: one rank, no collective
SOLO = ModelRanks(1, (0,))


def emulated_shards(tree, logical_tree, mesh,
                    rules: Rules = DEFAULT_RULES) -> tuple:
    """(:class:`ModelRanks` of every rank of the model axis, each rank's
    local tree) of the global ``tree`` on ``mesh``, a dict of sizes: each
    leaf cut along the dimension its logical axes (the same nested
    dicts; a named tuple of axes for a named-tuple leaf) put on the model
    axis, whole elsewhere — the data axes replicate, as
    :meth:`Layout.local_params` gathers them."""
    ranks = emulated_ranks(mesh, rules)
    axis, size = model_axis(mesh, rules), ranks.size

    def cut(t, logical, rank):
        if isinstance(t, dict):
            return {k: cut(v, logical[k], rank) for k, v in t.items()}
        if _is_record(t):
            return type(t)(*(cut(v, a, rank) for v, a in zip(t, logical)))
        if size == 1:
            return t
        for dim, entry in enumerate(logical_to_spec(logical or (), mesh,
                                                    rules)):
            if axis not in spec_axes(entry):
                continue
            if spec_axes(entry) != (axis,):
                raise NotImplementedError(
                    f"dimension {dim} of a leaf is split over {entry}: "
                    f"the emulation splits over {axis} alone")
            if t.shape[dim] % size:
                raise ValueError(f"dimension {dim} of a {tuple(t.shape)} "
                                 f"leaf does not split evenly over "
                                 f"{axis}={size}")
            n = t.shape[dim] // size
            # a buffer of its own, as a rank's shard is: products read it
            # with the strides and alignment the distributed rank has
            t = t.narrow(dim, rank * n, n).contiguous()
        return t
    return ranks, [cut(tree, logical_tree, r) for r in ranks.ranks]


def emulated_ranks(mesh, rules: Rules = DEFAULT_RULES) -> ModelRanks:
    """Every rank of the model axis of ``mesh``, a dict of sizes, run in
    this process."""
    axis = model_axis(mesh, rules)
    size = mesh_shape(mesh)[axis] if axis else 1
    return ModelRanks(size, range(size))


def emulated_expert_ranks(mesh, rules: Rules = DEFAULT_RULES) -> ModelRanks:
    """Every rank of the expert axis of ``mesh``, a dict of sizes, run in
    this process."""
    axis = logical_to_spec(("batch", "expert"), mesh, rules)[1]
    size = mesh_shape(mesh)[axis] if axis else 1
    return ModelRanks(size, range(size))


def seq_parallel_size(mesh, rules: Rules = DEFAULT_RULES) -> int:
    """The number of chunks ``"seq"`` splits a sequence into on ``mesh``
    (a ``DeviceMesh`` or its sizes): 1 without a live cp axis."""
    shape = mesh_shape(mesh)
    entry = logical_to_spec(("batch", "seq"), mesh, rules)[1]
    n = 1
    for a in spec_axes(entry):
        n *= shape[a]
    return n


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


def copy_to_experts(x, lay):
    """Identity forward; the gradient is summed over the expert and model
    axes: an input that each rank's experts (or their hidden slice) read
    only in part. No-op without either axis live."""
    groups = [] if lay is None else lay.expert_model_groups
    return _CopyTo.apply(x, groups) if groups else x


def reduce_from_experts(x, lay):
    """Sum over the expert and model axes, identity backward: the
    partial outputs of each rank's experts. No-op without either axis
    live."""
    groups = [] if lay is None else lay.expert_model_groups
    return _SumOver.apply(x, groups) if groups else x


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
    _vocab_range(lay, w.shape[0], vocab)
    return reduce_from_model(embed_partial(w, tokens, lay.model_rank), lay)


def embed_partial(w: torch.Tensor, tokens: torch.Tensor,
                  rank: int) -> torch.Tensor:
    """Rank ``rank``'s part of a vocab-parallel lookup, ``w`` its ``[V/n,
    D]`` slice of the vocab: its rows where a token falls in its range,
    zeros elsewhere (the ranks' parts sum to ``w_full[tokens]``)."""
    n = w.shape[0]
    t = tokens.long() - rank * n
    inside = (t >= 0) & (t < n)
    return w[t.clamp(0, n - 1)] * inside[..., None].to(w.dtype)


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
