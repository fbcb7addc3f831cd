"""Checkpoint and resume of the train state, retry-aware.

Port of ``tony_tpu/models/checkpoint.py`` for local directories. A
checkpoint of an unsharded state is one ``torch.save`` file per step,
``step_<N>.pt``, written to a temporary name in the same directory and
moved into place with ``os.replace``: a reader sees a whole checkpoint or
none. Tensors are restored onto the devices of a template state (the
freshly initialized one), as the JAX manager restores arrays onto their
saved sharding.

Unsharded saves are asynchronous, as the JAX package's orbax saves are:
``save`` returns once the state is copied to host memory
(:func:`snapshot`) — a copy, since the optimizers update params and
moments in place, so the next step cannot write into the checkpoint —
and a background thread writes and commits the file. Reads
(``latest_step``, ``all_steps``, ``restore``, ``restore_or_init``) first
wait for the save in flight, so they see every save this process has
accepted; a save that failed is logged and leaves them on the latest
committed step. ``wait_until_finished``, ``close`` and
the next ``save`` join the save in flight and raise its error. The
writer thread is not a daemon: a process that exits with a save in
flight commits it first.

A sharded state (DTensor params and moments over a mesh) is saved and
restored collectively on every rank through
``torch.distributed.checkpoint``: each rank writes its shards into
``step_<N>.tmp/``, and once all have, rank 0 renames it ``step_<N>/`` —
the commit, atomic as the file's. A restore loads into the template's
DTensors, so the state lands on the template's placements (whatever the
saving job's were). In a job of several processes rank 0 alone lists the
directory, and every rank reads its answer (:meth:`latest_step`), so a
retry resumes every rank at the same step; save, restore and
``latest_step`` are then collective calls, as the JAX package's are.

Sharded saves are synchronous: a commit that is atomic across ranks
needs every rank's writes finished before rank 0's rename, which an
asynchronous save would have to agree on collectively later. Remote URLs
(``gs://…``) raise ``NotImplementedError`` — a remote path must never be
turned into a local directory (the JAX package has no working remote
checkpoint either).

    mgr = CheckpointManager(ckpt_dir, save_interval_steps=50)
    state = mgr.restore_or_init(lambda: init_state(params, opt))
    # ... run_training(..., checkpoint=mgr)
"""

from __future__ import annotations

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


def _barrier() -> None:
    if _multi_process():
        dist.barrier()


def snapshot(state: Any) -> Any:
    """A copy of ``state`` in host memory: every tensor copied, every
    other leaf as it is. A tensor on the card is copied into pinned host
    memory on its current stream, after the work that writes it, and the
    copies are waited for together (a copy into pageable memory runs
    slower and blocks the caller for each tensor). The pinned buffers go
    back to torch's pinned-memory cache once the write is done, and the
    next save reuses them."""
    cards = set()

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
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
    offered, as orbax does)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1) -> None:
        if "://" in directory:
            raise NotImplementedError(
                f"remote checkpoint paths are not ported yet: {directory}")
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, save_interval_steps)
        os.makedirs(directory, exist_ok=True)
        #: the background write of the last unsharded save, and its error
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}")

    def _join(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def _raise_failed_save(self) -> None:
        """Join the save in flight and raise its error, once."""
        self._join()
        err, self._error = self._error, None
        if err is not None:
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

    def latest_step(self) -> int | None:
        """The latest committed step; in a job of several processes,
        rank 0's answer on every rank (a collective call)."""
        self._fence()
        steps = self._committed_steps() if _is_rank0() else []
        latest = [steps[-1] if steps else None]
        if _multi_process():
            dist.broadcast_object_list(latest, src=0)
        return latest[0]

    def _remove(self, step: int) -> None:
        if os.path.isdir(self._dir(step)):
            shutil.rmtree(self._dir(step))
        else:
            os.remove(self._path(step))

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save if ``force``, or if ``step`` is past the latest saved step
        and on the interval (or nothing is saved yet). Returns True if
        saved. An unsharded state is copied to host memory here and
        written in the background; the previous save is joined first and
        its error raised."""
        self._raise_failed_save()
        latest = self.latest_step()
        if not force:
            if latest is not None and step <= latest:
                return False
            if latest is not None and step % self.save_interval_steps:
                return False
        if _is_sharded(state):
            self._save_sharded(step, state)
            return True
        self._writer = threading.Thread(
            target=self._write, args=(int(step), snapshot(state)),
            name=f"tony-checkpoint-{int(step)}")
        self._writer.start()
        return True

    def _write(self, step: int, state: Any) -> None:
        """The background half of a save: write, commit, prune."""
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(state, tmp)
            os.replace(tmp, path)      # atomic: never half a checkpoint
            for old in self._committed_steps()[:-self.max_to_keep]:
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

    def _save_sharded(self, step: int, state: Any) -> None:
        """Every rank writes its shards into ``step_<N>.tmp/``; after a
        barrier rank 0 commits it with one rename and prunes."""
        import torch.distributed.checkpoint as dcp
        final = self._dir(step)
        tmp = final + ".tmp"
        if _is_rank0() and os.path.exists(tmp):
            shutil.rmtree(tmp)         # a save that died before commit
        _barrier()
        dcp.save(state, checkpoint_id=tmp)
        _barrier()
        if _is_rank0():
            if os.path.exists(final):  # a forced save of the same step
                shutil.rmtree(final)
            os.replace(tmp, final)     # atomic: never half a checkpoint
            for old in self._committed_steps()[:-self.max_to_keep]:
                self._remove(old)
            log.info("sharded checkpoint saved at step %d → %s", step,
                     self.directory)
        _barrier()

    def restore(self, template: Any | None = None,
                step: int | None = None) -> Any:
        """Load the given (or latest) step; with a ``template`` state its
        tensors land on the template's devices and dtypes."""
        self._fence()
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
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
        step = self.latest_step()
        if step is None:
            if attempt_number() > 0:
                log.warning("attempt %d but no checkpoint in %s — starting "
                            "fresh", attempt_number(), self.directory)
            return state
        log.info("resuming from checkpoint step %d (attempt %d)", step,
                 attempt_number())
        return self.restore(template=state, step=step)

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
