"""Host-side phase timing for the port's serving loop.

A copy of ``PhaseTimes`` from ``tony_tpu/runtime/profiler.py`` (the rest
of that module drives the JAX profiler and is not ported).
"""

from __future__ import annotations

import contextlib
import time


class PhaseTimes:
    """Wall-clock accumulator for the phases of a host-driven loop.

    Usage::

        times = PhaseTimes()
        with times.phase("dispatch"):
            handle = issue_chunk()
        with times.phase("fetch"):
            host = np.asarray(handle)
        times.total("fetch")        # seconds
        times.summary()             # {"fetch": {"total_s", "count",
                                    #            "mean_ms"}, ...}

    The serving batchers (`tony_tpu_torch.models.serve`) keep one per
    ``serve()`` call under ``.phase_times``, recording ``dispatch``
    (building + enqueueing a device chunk — async, no device sync),
    ``fetch`` (blocking on a chunk's tokens: device compute remaining +
    the transport round trip — the time the pipelined loop overlaps with
    the next chunk), ``admit`` (admission dispatches), and ``retire``.
    Pure host timing: no device sync of its own."""

    def __init__(self) -> None:
        self._total: dict[str, float] = {}
        self._count: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._total[name] = self._total.get(name, 0.0) + dt
            self._count[name] = self._count.get(name, 0) + 1

    def total(self, name: str) -> float:
        """Accumulated seconds in ``name`` (0.0 if never entered)."""
        return self._total.get(name, 0.0)

    def count(self, name: str) -> int:
        return self._count.get(name, 0)

    def summary(self) -> dict:
        """Per-phase {total_s, count, mean_ms}, insertion-ordered."""
        return {
            name: {"total_s": round(self._total[name], 6),
                   "count": self._count[name],
                   "mean_ms": round(
                       1e3 * self._total[name] / self._count[name], 3)}
            for name in self._total
        }
