"""In-process metrics registry for the port's serving engine and train loop.

A copy of the registry half of ``tony_tpu/runtime/metrics.py`` —
:class:`MetricsRegistry` with its counters, gauges and fixed-bucket
histograms, :class:`NullRegistry`, the process default, and
:func:`observe_phase_times` — so the port keeps the JAX package's series
names without importing it. The wire validation, snapshot table and
Prometheus rendering stay in the JAX package until the port's servers
need them.
"""

from __future__ import annotations

import bisect
import threading

#: default histogram bucket bounds for wall-clock seconds (le-style,
#: +Inf implicit) — spans µs-scale registry costs to minute-scale steps
TIME_BUCKETS_S: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_KIND_COUNTER = "counter"
_KIND_GAUGE = "gauge"
_KIND_HISTOGRAM = "histogram"


def _labels_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing value. ``inc`` locks per instrument —
    ``+=`` is a preemptible read-modify-write, and a lost increment is a
    permanent undercount on a counter; ``value`` reads lock-free."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict[str, str]) -> None:
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-set value (may go up or down). ``set`` is a single atomic
    store (no lock needed); ``inc`` read-modify-writes under a lock."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict[str, str]) -> None:
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram (cumulative rendering happens at export).

    ``observe`` is one ``bisect`` + three increments under the
    per-instrument lock — O(log #buckets) with a handful of buckets,
    effectively O(1). Reads don't lock (sum/count may be torn)."""

    __slots__ = ("name", "labels", "buckets", "_lock", "_counts", "_sum",
                 "_count")

    def __init__(self, name: str, labels: dict[str, str],
                 buckets: tuple[float, ...] = TIME_BUCKETS_S) -> None:
        self.name = name
        self.labels = labels
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        # one slot per finite bound plus the +Inf overflow slot
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> list[int]:
        """Per-bound cumulative counts (Prometheus ``le`` semantics),
        +Inf last."""
        out, running = [], 0
        for c in self._counts:
            running += c
            out.append(running)
        return out

class MetricsRegistry:
    """Thread-safe instrument registry with get-or-create semantics.

    One metric NAME has one kind (and one help string and, for
    histograms, one bucket ladder); label sets distinguish series under
    it. Lookup of an existing instrument is a single dict read.
    """

    def __init__(self) -> None:
        self._instruments: dict[tuple, object] = {}
        self._meta: dict[str, tuple[str, str]] = {}   # name -> (kind, help)
        self._lock = threading.Lock()

    # -- get-or-create ------------------------------------------------------
    def _get(self, kind: str, name: str, help: str, labels: dict,
             factory, cls: type):
        key = (name, _labels_key(labels))
        inst = self._instruments.get(key)      # lock-free fast path
        if inst is not None:
            if type(inst) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__.lower()}, cannot use as {kind}")
            return inst
        with self._lock:
            inst = self._instruments.get(key)
            if inst is not None:
                return inst
            meta = self._meta.get(name)
            if meta is not None and meta[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {meta[0]}, "
                    f"cannot re-register as {kind}")
            if meta is None or (help and not meta[1]):
                self._meta[name] = (kind, help)
            inst = factory()
            self._instruments[key] = inst
            return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(_KIND_COUNTER, name, help, labels,
                         lambda: Counter(name, dict(labels)), Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(_KIND_GAUGE, name, help, labels,
                         lambda: Gauge(name, dict(labels)), Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = TIME_BUCKETS_S,
                  **labels) -> Histogram:
        return self._get(_KIND_HISTOGRAM, name, help, labels,
                         lambda: Histogram(name, dict(labels), buckets),
                         Histogram)

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()
            self._meta.clear()

    # -- snapshots ----------------------------------------------------------
    def to_wire(self) -> dict:
        """Compact, JSON-safe snapshot of every series (the heartbeat
        payload). Keys: ``c``/``g``/``h`` hold ``[name, {labels},
        value]`` triples (histogram value = ``{"b": bounds, "n":
        per-bucket counts, "s": sum, "c": count}``); ``m`` maps metric
        name to ``[kind, help]``."""
        c, g, h = [], [], []
        for (name, _), inst in list(self._instruments.items()):
            if isinstance(inst, Counter):
                c.append([name, inst.labels, inst.value])
            elif isinstance(inst, Gauge):
                g.append([name, inst.labels, inst.value])
            elif isinstance(inst, Histogram):
                h.append([name, inst.labels,
                          {"b": list(inst.buckets), "n": list(inst._counts),
                           "s": inst.sum, "c": inst.count}])
        return {"c": c, "g": g, "h": h,
                "m": {n: list(km) for n, km in self._meta.items()}}


class NullRegistry(MetricsRegistry):
    """A registry whose instruments swallow every observation — the
    zero-cost-contrast arm for overhead benchmarks."""

    class _Null:
        name = "null"
        labels: dict = {}
        value = 0.0
        count = 0
        sum = 0.0
        buckets: tuple = (1.0,)

        def inc(self, amount: float = 1.0) -> None: ...
        def set(self, value: float) -> None: ...
        def observe(self, value: float) -> None: ...
        def cumulative(self) -> list: return [0, 0]

    _NULL = _Null()

    def counter(self, name, help="", **labels): return self._NULL
    def gauge(self, name, help="", **labels): return self._NULL
    def histogram(self, name, help="", buckets=TIME_BUCKETS_S, **labels):
        return self._NULL
    def to_wire(self) -> dict:
        return {"c": [], "g": [], "h": [], "m": {}}


_default = MetricsRegistry()


def get_default() -> MetricsRegistry:
    """The process-wide registry every producer observes into."""
    return _default


def observe_phase_times(phase_times, registry: MetricsRegistry | None = None,
                        prefix: str = "tony_serve_phase") -> None:
    """Fold a :class:`tony_tpu_torch.runtime.profiler.PhaseTimes` summary into
    the registry: per phase, ``<prefix>_seconds_total`` (host wall spent)
    and ``<prefix>_ops_total`` (times entered) counters, labeled
    ``phase=<name>``. Called once per ``serve()`` — each call ADDS that
    call's accumulation, so the counters stay monotonic across calls."""
    reg = registry or get_default()
    for phase, row in phase_times.summary().items():
        reg.counter(f"{prefix}_seconds_total",
                    help="host wall seconds per serve-loop phase",
                    phase=phase).inc(row["total_s"])
        reg.counter(f"{prefix}_ops_total",
                    help="serve-loop phase entries", phase=phase).inc(
                        row["count"])
