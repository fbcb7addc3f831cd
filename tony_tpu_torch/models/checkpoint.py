"""Checkpoint and resume of the train state, retry-aware.

Port of ``tony_tpu/models/checkpoint.py`` for local directories. A
checkpoint of an unsharded state is one ``torch.save`` file per step,
``step_<N>.pt``, written to a temporary name in the same directory and
moved into place with ``os.replace``: a reader sees a whole checkpoint or
none. Tensors are restored onto the devices of a template state (the
freshly initialized one), as the JAX manager restores arrays onto their
saved sharding.

Save offers decide from memory, as orbax's ``CheckpointManager.save``
does. The manager keeps the steps it has saved, oldest first, as orbax's
in-memory list does: it learns them from the directory when it is built
(rank 0's listing, broadcast) and again in ``restore`` and
``restore_or_init``. ``save`` applies orbax's rule to the last of them:
save on ``force``; else skip a step at or below it; else save if nothing
is saved yet or the step is on the interval. An offer that does not save
returns at once, with no join, no directory listing and no collective,
so ``run_training`` can offer a save after every step. Only a save that
will happen waits for the one before and raises its error; a forced save
of a step already saved raises ``ValueError``, as orbax's
``StepAlreadyExistsError`` does. Once a save commits, the steps beyond
``max_to_keep`` are removed, oldest saved first.

Every save is asynchronous, as the JAX package's orbax saves are:
``save`` returns once the state is copied to host memory
(:func:`snapshot`) — a copy, since the optimizers update params and
moments in place, so the next step cannot write into the checkpoint —
and a background thread writes and commits it. Reads (``latest_step``,
``all_steps``, ``restore``, ``restore_or_init``) first wait for the save
in flight, so they see every save this process has accepted; a save that
failed is logged and leaves them on the latest committed step.
``wait_until_finished``, ``close`` and the next save that happens join
the save in flight and raise its error, and the manager then learns its
steps from the directory again. The writer thread is not a daemon: a
process that exits with a save in flight commits it first.

A sharded state (DTensor params and moments over a mesh) is saved and
restored on every rank through ``torch.distributed.checkpoint``. The
snapshot copies each rank's local shards and wraps them in DTensors of
the same mesh and placements; the writer thread writes them into
``step_<N>.tmp/`` with ``dcp.save`` over a gloo group of the manager's
own (the checkpoint group, created collectively on every rank when the
manager is built, its waits bounded by ``SAVE_TIMEOUT_S``). DCP's collectives
(plan gathering, the write results gathered for the metadata) therefore
never interleave with the step's collectives on the training group, and
no NCCL work starts from a side thread (at world 1 the training group is
NCCL); a writer whose peer died fails after the timeout instead of
hanging the next save. ``dcp.save`` returns on any rank only once the
coordinator holds every rank's write result and has written the
metadata, and raises on every rank if one failed; rank 0 then renames
``step_<N>.tmp/`` to ``step_<N>/`` — the commit, atomic as the file's —
and the ranks agree on the outcome over the checkpoint group, so a write
that failed on any rank commits nothing and raises on every rank, and no
rank's writer ends before the commit. A process that died mid-save left
only ``step_<N>.tmp/``, which no read lists and rank 0 clears at the next
sharded save. In a job of several processes rank 0 alone lists the
directory, and every rank reads its answer, so a retry resumes every rank
at the same step; building the manager, ``latest_step``, ``restore`` and
``restore_or_init`` are then collective calls, as the JAX package's are.
A restore loads into the template's DTensors, so the state lands on the
template's placements (whatever the saving job's were): a pipeline's
stage-sharded blocks (``Shard(0)`` over pp) save each stage's layers from
its own ranks and restore in a new group as any other placement does.

Remote URLs (``gs://…``) raise ``NotImplementedError`` — a remote path
must never be turned into a local directory (the JAX package has no
working remote checkpoint either).

    mgr = CheckpointManager(ckpt_dir, save_interval_steps=50)
    state = mgr.restore_or_init(lambda: init_state(params, opt))
    # ... run_training(..., checkpoint=mgr)
"""

from __future__ import annotations

import datetime
import logging
import os
import re
import shutil
import threading
from typing import Any, Callable

import torch
import torch.distributed as dist

from tony_tpu_torch import tree_leaves, tree_map
from tony_tpu_torch.constants import ATTEMPT_NUMBER

log = logging.getLogger(__name__)

_NAME = re.compile(r"^step_(\d+)\.pt$")
_DIR = re.compile(r"^step_(\d+)$")
_PARTIAL = re.compile(r"^step_\d+\.tmp$")

#: how long the checkpoint group waits for a peer (orbax's
#: ``AsyncOptions.timeout_secs``)
SAVE_TIMEOUT_S = 600.0


def attempt_number() -> int:
    """Which coordinator attempt this process belongs to (0 = first
    run)."""
    return int(os.environ.get(ATTEMPT_NUMBER, "0"))


def _is_sharded(tree) -> bool:
    return any(hasattr(t, "placements") for t in tree_leaves(tree))


def _multi_process() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _is_rank0() -> bool:
    return not _multi_process() or dist.get_rank() == 0


def snapshot(state: Any) -> Any:
    """A copy of ``state`` in host memory: every tensor copied, every
    other leaf as it is; a DTensor becomes a DTensor of the same mesh and
    placements over a host copy of its local shard. A tensor on the card
    is copied into pinned host memory on its current stream, after the
    work that writes it, and the copies are waited for together (a copy
    into pageable memory runs slower and blocks the caller for each
    tensor). The pinned buffers go back to torch's pinned-memory cache
    once the write is done, and the next save reuses them."""
    cards = set()

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        if hasattr(x, "placements"):
            from torch.distributed.tensor import DTensor
            return DTensor(copy(x.detach().to_local()), x._spec,
                           requires_grad=False)
        if x.device.type != "cuda":
            return x.detach().clone()
        cards.add(x.device)
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return out.copy_(x.detach(), non_blocking=True)

    snap = tree_map(copy, state)
    for card in cards:
        torch.cuda.current_stream(card).synchronize()
    return snap


def _to_template(x, t):
    """A loaded leaf placed like the template's leaf."""
    if isinstance(t, dict):
        return {k: _to_template(x[k], t[k]) for k in t}
    if isinstance(t, torch.Tensor):
        return x.to(device=t.device, dtype=t.dtype)
    return x


class CheckpointManager:
    """Keep the last ``max_to_keep`` checkpoints of a local directory,
    saving every ``save_interval_steps`` steps (and the first step
    offered, as orbax does). Build it after the process group, on every
    rank: it creates its checkpoint group there."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1) -> None:
        if "://" in directory:
            raise NotImplementedError(
                f"remote checkpoint paths are not ported yet: {directory}")
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, save_interval_steps)
        os.makedirs(directory, exist_ok=True)
        #: the background write of the last save, and its error
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        #: gloo over every rank: the sharded writer's collectives and the
        #: manager's listings run here, never on the training group
        self._group = (dist.new_group(backend="gloo", timeout=datetime
                                      .timedelta(seconds=SAVE_TIMEOUT_S))
                       if dist.is_initialized() else None)
        #: the steps saved, oldest first: what a save offer decides from
        self._steps = self._listing()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}")

    def _join(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def _raise_failed_save(self) -> None:
        """Join the save in flight and raise its error, once; after a
        failure the saved steps are learned from the directory again (the
        failed step is not there, and the steps it would have pruned
        are)."""
        self._join()
        err, self._error = self._error, None
        if err is not None:
            self._steps = self._committed_steps()
            raise err

    def _fence(self) -> None:
        """Read barrier: a read never runs beside this process's own save
        in flight. It never raises: a failed save surfaces on the next
        save, ``wait_until_finished`` or ``close``; reads see the latest
        committed step."""
        self._join()
        if self._error is not None:
            log.warning("in-flight checkpoint save failed; reading the "
                        "latest COMMITTED step", exc_info=self._error)

    def all_steps(self) -> list[int]:
        """Committed steps in this process's view of the directory:
        ``step_<N>.pt`` files and ``step_<N>/`` directories."""
        self._fence()
        return self._committed_steps()

    def _committed_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _NAME.match(name) or _DIR.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _listing(self) -> list[int]:
        """Rank 0's committed steps, on every rank (in a job of several
        processes, a broadcast over the checkpoint group)."""
        steps = [self._committed_steps() if _is_rank0() else None]
        if _multi_process():
            dist.broadcast_object_list(steps, src=0, group=self._group)
        return steps[0]

    def latest_step(self) -> int | None:
        """The latest committed step; in a job of several processes,
        rank 0's answer on every rank (a collective call)."""
        self._fence()
        steps = self._listing()
        return steps[-1] if steps else None

    def _remove(self, step: int) -> None:
        if os.path.isdir(self._dir(step)):
            shutil.rmtree(self._dir(step))
        elif os.path.exists(self._path(step)):
            os.remove(self._path(step))

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save if ``force``, or if ``step`` is past the last saved step
        and on the interval (or nothing is saved yet); decided from
        memory, with no join, listing or collective. Returns True if
        saved. A save waits for the previous one and raises its error,
        copies ``state`` to host memory, and writes and commits it in the
        background."""
        step = int(step)
        last = self._steps[-1] if self._steps else None
        if not force and last is not None and (
                step <= last or step % self.save_interval_steps):
            return False
        self._raise_failed_save()
        if step in self._steps:
            raise ValueError(f"a checkpoint of step {step} already exists "
                             f"in {self.directory}")
        sharded = _is_sharded(state)
        if sharded and self._group is None:
            raise RuntimeError("a sharded state needs the checkpoint "
                               "group: build the manager after the process "
                               "group")
        snap = snapshot(state)
        self._steps.append(step)
        drop = self._steps[:-self.max_to_keep]
        del self._steps[:-self.max_to_keep]
        self._writer = threading.Thread(
            target=self._write_sharded if sharded else self._write,
            args=(step, snap, drop), name=f"tony-checkpoint-{step}")
        self._writer.start()
        return True

    def _write(self, step: int, state: Any, drop: list[int]) -> None:
        """The background half of an unsharded save: write, commit,
        prune."""
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(state, tmp)
            os.replace(tmp, path)      # atomic: never half a checkpoint
            for old in drop:
                self._remove(old)
        except Exception as e:         # kept and re-raised
            self._error = e            # by the next save/wait/close
            log.error("checkpoint save at step %d failed", step,
                      exc_info=e)
            try:
                os.remove(tmp)
            except OSError:
                pass
            return
        log.info("checkpoint saved at step %d → %s", step, self.directory)

    def _write_sharded(self, step: int, state: Any, drop: list[int]) -> None:
        """The background half of a sharded save, on every rank: each
        writes its shards into ``step_<N>.tmp/``; rank 0 renames it
        ``step_<N>/`` once ``dcp.save`` has returned (every rank wrote)
        and prunes; then the ranks agree on the outcome. Every collective
        runs on the checkpoint group."""
        import torch.distributed.checkpoint as dcp
        final = self._dir(step)
        tmp = final + ".tmp"
        error = None
        try:
            if _is_rank0():            # saves that died before commit
                for name in os.listdir(self.directory):
                    if _PARTIAL.match(name):
                        shutil.rmtree(os.path.join(self.directory, name))
            dist.barrier(group=self._group)    # before any rank writes
            # the serial loader: the shards are in host memory already,
            # so this thread runs no work on the card
            dcp.save(state, storage_writer=dcp.FileSystemWriter(
                tmp, per_thread_copy_ahead=0), process_group=self._group)
            if _is_rank0():
                os.replace(tmp, final)  # atomic: never half a checkpoint
                for old in drop:
                    self._remove(old)
        except BaseException as e:     # DCP's CheckpointException is one
            error = e
        outcomes = [None] * dist.get_world_size(self._group)
        try:
            dist.all_gather_object(
                outcomes, None if error is None else
                f"rank {dist.get_rank()}: {type(error).__name__}: {error}",
                group=self._group)
        except Exception as e:
            error = error or e
        failed = [o for o in outcomes if o]
        if error is not None or failed:
            # the same error on every rank, an Exception (DCP's is not)
            self._error = RuntimeError(
                f"the sharded checkpoint of step {step} was not committed: "
                + "; ".join(failed or [str(error)]))
            self._error.__cause__ = error
            log.error("sharded checkpoint save at step %d failed", step,
                      exc_info=self._error)
            return
        log.info("sharded checkpoint saved at step %d → %s", step,
                 self.directory)

    def restore(self, template: Any | None = None,
                step: int | None = None) -> Any:
        """Load the given (or latest) step; with a ``template`` state its
        tensors land on the template's devices and dtypes."""
        self._fence()
        self._steps = self._listing()
        if step is None:
            if not self._steps:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
            step = self._steps[-1]
        return self._load(template, int(step))

    def _load(self, template: Any, step: int) -> Any:
        if os.path.isdir(self._dir(step)):
            return self._restore_sharded(template, step)
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        return state if template is None else _to_template(state, template)

    def _restore_sharded(self, template: Any, step: int) -> Any:
        """Load ``step_<N>/`` into ``template`` in place, collectively:
        each rank reads the shards its DTensors' placements ask for."""
        import torch.distributed.checkpoint as dcp
        if template is None:
            raise ValueError("a sharded checkpoint restores into a template "
                             "state (the freshly initialized one)")
        dcp.load(template, checkpoint_id=self._dir(step))
        return template

    def restore_or_init(self, init_fn: Callable[[], Any]) -> Any:
        """Restore the latest checkpoint if one exists, else build fresh
        state. On coordinator retries (ATTEMPT_NUMBER > 0) a missing
        checkpoint is fine: the job may have died before its first
        save."""
        state = init_fn()
        self._fence()
        self._steps = self._listing()
        if not self._steps:
            if attempt_number() > 0:
                log.warning("attempt %d but no checkpoint in %s — starting "
                            "fresh", attempt_number(), self.directory)
            return state
        log.info("resuming from checkpoint step %d (attempt %d)",
                 self._steps[-1], attempt_number())
        return self._load(state, self._steps[-1])

    def wait_until_finished(self) -> None:
        """Join the save in flight; raise its error if it failed."""
        self._raise_failed_save()

    def close(self) -> None:
        """Join the save in flight; raise its error if it failed."""
        self._raise_failed_save()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
