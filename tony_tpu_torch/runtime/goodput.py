"""Goodput ledger: attribute every second of the process to a category.

The port's copy of the user-process side of ``tony_tpu/runtime/goodput.py``
(stdlib only; the port imports nothing of ``tony_tpu``). The question it
answers for the orchestrator: of the seconds a task held its card, how
many trained steps or served tokens, and where did the rest go?

- A :class:`GoodputLedger` always has exactly ONE open category (a stack
  whose base is ``overhead``). ``enter(cat)`` pushes a category and
  restores the previous one on exit, so ``sum(categories) == now - t0``
  at every snapshot: no gap and no overlap, by construction.
- Totals are cumulative seconds per category, so the wire snapshot is
  idempotent: a re-delivered or re-read snapshot rebuilds the same table.
- The trainer or server is fork-exec'd by the executor, so its ledger is
  process-local. It publishes its wire snapshot atomically to the file
  named by ``TONY_GOODPUT_SPOOL`` (at most about once a second, and at
  exit by an explicit :meth:`GoodputLedger.publish`); the executor's
  ``merge_wires`` puts the breakdown in place of the host ledger's
  ``user`` span and ships it on heartbeats.

The wire readers (``validate_wire``, ``from_wire_json``, ``merge_wires``,
``goodput_fraction``) and the straggler detector run in the executor and
the coordinator, which are not ported; no port process calls them.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from tony_tpu_torch import constants

# The closed set of categories. ``step`` is goodput; everything else is
# badput of a named kind. ``overhead`` is the base: time no instrumented
# phase claims (process start-up, logging, ...).
CATEGORIES: Tuple[str, ...] = (
    "provision",   # waiting for the gang barrier / resources
    "stage",       # staging artifacts (venv, weights) onto the host
    "compile",     # compilation walls
    "data_wait",   # input pipeline starvation (blocked on the next batch)
    "step",        # productive train-step / serve-token time (GOODPUT)
    "checkpoint",  # checkpoint save/restore walls
    "eval",        # in-loop evaluation
    "resync",      # elastic reconfiguration
    "recovery",    # crash-recovery walls
    "idle",        # intentionally idle (serve engine waiting for work)
    "queue_wait",  # waiting in the cluster daemon's queue for a grant
    "overhead",    # everything unclaimed
)

_CATEGORY_SET = frozenset(CATEGORIES)

# Category the executor's host ledger uses for "the user process is
# running"; the executor replaces it with the process's own breakdown.
# Not a public category: a port process never enters it.
USER_CATEGORY = "user"

WIRE_VERSION = 1

# The category open when no instrumented phase claims the time.
BASE_CATEGORY = "overhead"

# The least time between two throttled spool writes.
SPOOL_INTERVAL_S = 1.0


class GoodputLedger:
    """Thread-safe interval accountant with exactly one open category.

    The ledger starts at construction with the base category
    (``overhead``) open. ``enter(cat)`` pushes; on exit the
    previous category resumes. ``snapshot()`` folds the live interval into
    the totals so that their sum equals the elapsed wall clock.
    """

    def __init__(
        self,
        registry=None,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
        spool_path: Optional[str] = None,
    ):
        self._clock = clock
        self._wall_clock = wall_clock
        self._lock = threading.Lock()
        self._t0_wall = wall_clock()
        self._t0 = clock()
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        # Stack of [category, resumed_at, folded_seconds_this_frame]; the
        # bottom is the base category. The third field keeps the wall
        # already folded out of an interrupted frame (a nested push folds
        # its parent), so closing a "step" credits the WHOLE step wall to
        # the step accumulators, not just its last segment.
        self._stack: List[List] = [[BASE_CATEGORY, self._t0, 0.0]]
        # closed steps and their cumulative seconds (the live step is not
        # included, so window deltas measure completed steps only)
        self._step_closed = 0
        self._step_seconds = 0.0
        self._registry = registry
        self._shipped: Dict[str, float] = {}
        self._spool_path = spool_path
        self._last_spool = 0.0

    # -- core accounting ------------------------------------------------

    def enter(self, category: str):
        """Context manager: attribute the enclosed wall time to
        *category*."""
        if category not in _CATEGORY_SET:
            raise ValueError("unknown goodput category: %r" % (category,))
        return _Interval(self, category)

    def _push(self, category: str) -> None:
        with self._lock:
            now = self._clock()
            self._fold_top(now)
            self._stack.append([category, now, 0.0])

    def _pop(self, category: str) -> None:
        with self._lock:
            now = self._clock()
            # Tolerate out-of-order exits (a generator-held context
            # finalized late): unwind to the matching frame, folding
            # everything above it. Each unwound frame's parent resumes from
            # *now*: its since still points at the child's push time, and
            # folding from there would count the child's interval twice.
            while len(self._stack) > 1:
                top = self._fold_top(now, close=True)
                self._stack[-1][1] = now
                if top == category:
                    break
        self._maybe_spool()

    def _fold_top(self, now: float, close: bool = False):
        """Fold the top frame's elapsed time into the totals (the caller
        holds the lock). With ``close`` the frame is removed and its
        interval count bumped; otherwise it stays open from *now*."""
        frame = self._stack[-1]
        cat, since = frame[0], frame[1]
        dt = max(0.0, now - since)
        if dt:
            self._totals[cat] = self._totals.get(cat, 0.0) + dt
        if close:
            self._stack.pop()
            self._counts[cat] = self._counts.get(cat, 0) + 1
            if cat == "step":
                self._step_closed += 1
                self._step_seconds += frame[2] + dt
        else:
            frame[1] = now
            frame[2] += dt
        return cat

    def add(self, category: str, seconds: float) -> None:
        """Attribute *seconds* to *category* without an interval (a wall
        measured elsewhere). Added seconds are NOT part of the wall-clock
        invariant."""
        if category not in _CATEGORY_SET:
            raise ValueError("unknown goodput category: %r" % (category,))
        if seconds <= 0:
            return
        with self._lock:
            self._totals[category] = self._totals.get(category, 0.0) \
                + seconds
            self._counts[category] = self._counts.get(category, 0) + 1

    # -- snapshots ------------------------------------------------------

    def snapshot(self) -> dict:
        """Cumulative wire snapshot; idempotent, safe to re-send."""
        with self._lock:
            now = self._clock()
            self._fold_top(now)
            cats = {k: v for k, v in self._totals.items() if v > 0.0}
            wire = {
                "v": WIRE_VERSION,
                "t0": self._t0_wall,
                "now": self._t0_wall + (now - self._t0),
                "cat": cats,
                "cur": self._stack[-1][0],
                "n": dict(self._counts),
                "sw": {"c": self._step_closed, "s": self._step_seconds},
            }
        self._mirror(cats)
        return wire

    def to_wire_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def _mirror(self, cats: Dict[str, float]) -> None:
        """Mirror the growth of each total since the last snapshot into
        ``tony_goodput_seconds_total``."""
        reg = self._registry
        if reg is None:
            return
        try:
            for cat, total in cats.items():
                delta = total - self._shipped.get(cat, 0.0)
                if delta > 0:
                    reg.counter(
                        "tony_goodput_seconds_total",
                        help="wall seconds attributed by the goodput "
                             "ledger, by category",
                        category=cat,
                    ).inc(delta)
                    self._shipped[cat] = total
        except Exception:  # noqa: BLE001 - accounting never breaks the task
            pass

    def _maybe_spool(self) -> None:
        path = self._spool_path
        if not path:
            return
        now = self._clock()
        if now - self._last_spool < SPOOL_INTERVAL_S:
            return
        self._last_spool = now
        self.publish()

    def publish(self) -> None:
        """Atomically publish the current snapshot to the spool file."""
        path = self._spool_path
        if not path:
            return
        try:
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(self.to_wire_json())
            os.replace(tmp, path)
        except OSError:
            pass


class _Interval:
    """The context manager ``ledger.enter`` returns."""

    __slots__ = ("_ledger", "_category")

    def __init__(self, ledger: GoodputLedger, category: str):
        self._ledger = ledger
        self._category = category

    def __enter__(self):
        self._ledger._push(self._category)
        return self

    def __exit__(self, *exc):
        self._ledger._pop(self._category)
        return False


# -- the process-global ledger ------------------------------------------

_default_ledger: Optional[GoodputLedger] = None
_default_lock = threading.Lock()


def get_ledger() -> GoodputLedger:
    """The process-global ledger. Its first caller wires it to the
    executor's spool (``TONY_GOODPUT_SPOOL``) and to the default metrics
    registry."""
    global _default_ledger
    with _default_lock:
        if _default_ledger is None:
            from tony_tpu_torch.runtime import metrics as metrics_mod
            spool = os.environ.get(constants.TONY_GOODPUT_SPOOL) or None
            _default_ledger = GoodputLedger(
                registry=metrics_mod.get_default(), spool_path=spool)
        return _default_ledger


def set_ledger(ledger: Optional[GoodputLedger]) -> None:
    global _default_ledger
    with _default_lock:
        _default_ledger = ledger
