"""The training loop: prefetched input, the train step, evaluation and
checkpoints together.

Port of ``tony_tpu/models/loop.py::run_training``. The loop observes
``tony_data_wait_seconds`` into the default metrics registry — the host
wall each iteration spent blocked on ``next(data)``, the direct signal of
an input-bound step — offers a checkpoint save every step, runs
``eval_fn`` every ``eval_every`` steps, and closes the data iterator
(stopping its producer thread) in ``finally``. A step that fails because
its gang did dumps the flight recorder and raises :class:`GangLostError`.

What the orchestrator reads of it, as of the JAX loop:

- spans (``runtime/tracing.py``, head-sampled): a ``train.step`` root
  per step with ``train.data_wait``, ``train.dispatch``,
  ``train.checkpoint`` and ``train.eval`` as children, spooled to the
  executor and on to ``TRACE_SPAN`` events;
- the goodput ledger (``runtime/goodput.py``): ``data_wait``, ``step``,
  ``checkpoint`` and ``eval`` around the same calls, the exit join under
  ``checkpoint``, published to the executor's spool at exit.

The loop adds no device synchronisation. On the card the host runs ahead
of the device, so ``step`` holds the host's dispatch of the step plus
whatever ``step_fn`` waits for inside it (a loss read back, a full
launch queue); device time the host did not wait for lands in the
category the host was in when it did wait.
"""

from __future__ import annotations

import itertools
import logging
import sys
import time
from typing import Any, Callable, Iterable

from tony_tpu_torch.runtime import goodput as goodput_mod
from tony_tpu_torch.runtime import metrics as metrics_mod
from tony_tpu_torch.runtime import tracing

log = logging.getLogger(__name__)

#: exit code of a trainer whose gang was lost (a copy of
#: ``tony_tpu.constants.EXIT_GANG_LOST``)
EXIT_GANG_LOST = 76


class GangLostError(RuntimeError):
    """The step loop died because its gang did, not because of user code:
    a collective transport or the distributed runtime failed under the
    step. Trainers exit with :attr:`exit_code`, which the executor
    recognizes."""

    exit_code = EXIT_GANG_LOST


#: substrings naming a collectives layer in an error message (the JAX
#: package's list, which covers NCCL and gloo too)
_GANG_LOSS_MARKERS = (
    "gloo", "coordination service", "nccl", "megascale",
    "distributed service", "all-reduce failed", "all-gather failed",
    "collective", "preempted",
)


def _looks_like_gang_loss(e: BaseException) -> bool:
    seen: set[int] = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        msg = str(e).lower()
        if any(m in msg for m in _GANG_LOSS_MARKERS):
            return True
        e = e.__cause__ or e.__context__
    return False


#: data-wait buckets: the healthy value is ~0, so sub-millisecond
#: resolution matters more than a minute-scale tail
DATA_WAIT_BUCKETS_S: tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 5.0)


def run_training(step_fn: Callable[[Any, Any], tuple[Any, dict]],
                 state: Any, data: Iterable | None, steps: int, *,
                 start_step: int = 0, checkpoint=None,
                 eval_fn: Callable[[Any], Any] | None = None,
                 eval_every: int = 0, log_every: int = 20,
                 log_fn: Callable[[int, dict, Any], None] | None = None,
                 step_hook: Callable[[int], None] | None = None,
                 ) -> tuple[Any, dict]:
    """Drive ``steps - start_step`` train steps; returns (state, metrics).

    - ``step_fn(state, batch) -> (state, metrics)``, the shape of
      ``make_train_step``'s step.
    - ``data``: an iterator of batches, normally a ``DevicePrefetcher``;
      closed at exit if it has ``close()``. If it runs dry the loop stops
      cleanly. ``None`` passes ``batch=None`` every step.
    - ``checkpoint``: a ``CheckpointManager``; ``save(step + 1, state)``
      is offered every step (the manager's interval decides), and the
      saves in flight are joined once at exit (a failed one raises,
      unless the loop is already failing: then it is logged).
    - ``eval_fn(state)`` runs every ``eval_every`` steps; the latest
      result rides in ``metrics["eval"]`` from then on.
    - ``log_fn(step, metrics, batch)`` runs every ``log_every`` steps and
      on the final step.
    - ``step_hook(step)`` runs first in each iteration.
    """
    if data is None:
        data = itertools.repeat(None)
    it = iter(data)
    wait_hist = metrics_mod.get_default().histogram(
        "tony_data_wait_seconds",
        help="host wall seconds the train loop spent blocked on data",
        buckets=DATA_WAIT_BUCKETS_S)
    metrics: dict = {}
    last_eval = None
    tracer = tracing.get_tracer()
    flight = tracing.get_flight()
    ledger = goodput_mod.get_ledger()
    try:
        for step in range(start_step, steps):
            if step_hook is not None:
                step_hook(step)
            with tracer.span("train.step", step=step) as step_span:
                t0 = time.perf_counter()
                try:
                    with ledger.enter("data_wait"):
                        batch = next(it)
                except StopIteration:
                    log.warning("data exhausted at step %d (wanted %d); "
                                "stopping early", step, steps)
                    break
                wait = time.perf_counter() - t0
                wait_hist.observe(wait)
                tracer.record_span("train.data_wait", wait,
                                   parent=step_span)
                try:
                    with tracer.span("train.dispatch"), \
                            ledger.enter("step"):
                        state, metrics = step_fn(state, batch)
                except Exception as e:
                    if _looks_like_gang_loss(e):
                        # the flight ring dumps first: the step-level
                        # postmortem of what died mid-collective outlives
                        # the process
                        log.warning(
                            "step %d failed with a collective/"
                            "distributed-runtime error — gang lost: %s",
                            step, e)
                        flight.record("gang_lost", step=step,
                                      error=str(e)[:500])
                        flight.dump("gang_lost", step=step)
                        raise GangLostError(str(e)) from e
                    raise
                if checkpoint is not None:
                    with tracer.span("train.checkpoint"), \
                            ledger.enter("checkpoint"):
                        checkpoint.save(step + 1, state)
                if (eval_fn is not None and eval_every > 0
                        and (step + 1) % eval_every == 0):
                    with tracer.span("train.eval"), ledger.enter("eval"):
                        last_eval = eval_fn(state)
                if last_eval is not None:
                    metrics = dict(metrics)
                    metrics["eval"] = last_eval
                if log_fn is not None and (step % max(1, log_every) == 0
                                           or step == steps - 1):
                    log_fn(step, metrics, batch)
    finally:
        close = getattr(data, "close", None)
        if close is not None:
            close()
        if checkpoint is not None:
            failing = sys.exc_info()[1]
            try:
                with ledger.enter("checkpoint"):
                    checkpoint.wait_until_finished()
            except Exception:
                if failing is None:
                    raise
                # the loop's own error surfaces: a GangLostError's exit
                # code is what the executor reads, and a sharded write
                # in flight fails with the gang that died under the step
                log.exception("a checkpoint save failed too")
        # the final breakdown reaches the executor even when the loop ends
        # between two throttled publishes
        ledger.publish()
    return state, metrics
