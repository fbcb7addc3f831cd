"""Checkpoint and resume of the train state, retry-aware.

Port of ``tony_tpu/models/checkpoint.py`` for local directories. A
checkpoint is one ``torch.save`` file per step, ``step_<N>.pt``, written
to a temporary name in the same directory and moved into place with
``os.replace``: a reader sees a whole checkpoint or none. Tensors are
restored onto the devices of a template state (the freshly initialized
one), as the JAX manager restores arrays onto their saved sharding.

Saves are synchronous: ``wait_until_finished`` has nothing to wait for
(the JAX package's orbax saves run in the background). Remote URLs
(``gs://…``) raise ``NotImplementedError`` — a remote path must never be
turned into a local directory.

    mgr = CheckpointManager(ckpt_dir, save_interval_steps=50)
    state = mgr.restore_or_init(lambda: init_state(params, opt))
    # ... run_training(..., checkpoint=mgr)
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Callable

import torch

log = logging.getLogger(__name__)

#: the environment variable the coordinator sets on retries (a copy of
#: ``tony_tpu.constants.ATTEMPT_NUMBER``)
ATTEMPT_NUMBER = "ATTEMPT_NUMBER"

_NAME = re.compile(r"^step_(\d+)\.pt$")


def attempt_number() -> int:
    """Which coordinator attempt this process belongs to (0 = first
    run)."""
    return int(os.environ.get(ATTEMPT_NUMBER, "0"))


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

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save if ``force``, or if ``step`` is past the latest saved step
        and on the interval (or nothing is saved yet). Returns True if
        saved."""
        latest = self.latest_step()
        if not force:
            if latest is not None and step <= latest:
                return False
            if latest is not None and step % self.save_interval_steps:
                return False
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)          # atomic: never half a checkpoint
        log.info("checkpoint saved at step %d → %s", step, self.directory)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def restore(self, template: Any | None = None,
                step: int | None = None) -> Any:
        """Load the given (or latest) step; with a ``template`` state its
        tensors land on the template's devices and dtypes."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        return state if template is None else _to_template(state, template)

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
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release."""
