"""Metrics-driven fleet control: autoscale + rolling upgrades over a
:class:`~tony_tpu_torch.serving.router.ServingRouter`.

The port's copy of ``tony_tpu/serving/fleet.py``. Like the router it
imports no torch: a controller runs on a host with no model stack, over
replicas of either package. One change: :class:`SubprocessProvider`
reads each child's output to its end on a thread of its own, so a
replica that logs more than a pipe holds never blocks in a write, and a
child that prints no address is given up on at ``spawn_timeout_s``.

The :class:`FleetController` closes the loop the serving metrics plane
opened: it consumes the load signals the router already aggregates from
replica STATS (``tony_serve_queue_depth`` / ``tony_prefill_queue_depth``
per replica, idle decode slots — the same numbers behind
``tony_router_replica_queue_depth``) and turns them into fleet actions:

- **scale up** when sustained queue depth per replica crosses
  ``up_queue_per_replica`` — ask the :class:`CapacityProvider` for more
  replicas and :meth:`~ServingRouter.add_replicas` them live;
- **scale down** when sustained utilization falls under
  ``down_utilization`` — pick the least-loaded replica,
  :meth:`~ServingRouter.drain` it (planned migration, zero dup/drop),
  retire it from the router, and release it back to the provider;
- **rolling upgrade**: stand the new-version tier up, drain the old
  tier replica by replica, retire it — sessions live-migrate with
  version-pinned placement, so no stream ever mixes weight generations.

Decisions are HYSTERETIC and rate-limited by design: a threshold must
hold for ``hysteresis_ticks`` consecutive ticks, and any action starts
a ``cooldown_ticks`` quiet period. The sim harness pins that the
controller does not flap on an oscillating load signal
(tests/test_fleet.py).

Capacity comes from a pluggable :class:`CapacityProvider`: the local
backend spawns/reaps real replica processes; a TPU-backed provider
returns slices to the pool instead. The provider only creates and
destroys capacity — all session safety (fence, migrate, tombstone)
lives in the router's drain path.

Controller series (default registry): ``tony_fleet_replicas``,
``tony_fleet_load_per_replica``, ``tony_fleet_scale_ups_total``,
``tony_fleet_scale_downs_total``, ``tony_fleet_upgrades_total``.
"""

from __future__ import annotations

import collections
import logging
import re
import subprocess
import threading

from tony_tpu_torch.runtime import metrics as metrics_mod

log = logging.getLogger(__name__)


class CapacityProvider:
    """Where replicas come from and where they go back to. ``grow``
    returns the new replicas' ``host:port`` addresses once they accept
    connections; ``release`` reaps them AFTER the router drained and
    retired them (the provider never sees live sessions)."""

    def grow(self, n: int) -> list:
        raise NotImplementedError

    def release(self, addrs) -> None:
        raise NotImplementedError


class _ChildOutput:
    """A child's merged stdout/stderr, read to its end on a daemon
    thread: the first match of ``addr_re`` is the child's address, and
    the last ``keep`` lines (each cut to 500 characters) are kept for
    the error that names a child which never served. Reading on past
    the address is what keeps a chatty replica from filling its pipe
    and blocking in its next write."""

    def __init__(self, proc, addr_re, keep: int = 40) -> None:
        self.proc = proc
        self.addr_re = addr_re
        self.addr: str | None = None
        self.lines: collections.deque = collections.deque(maxlen=keep)
        self.settled = threading.Event()    # address seen, or EOF
        self.thread = threading.Thread(
            target=self._read, name=f"tony-fleet-child-{proc.pid}",
            daemon=True)
        self.thread.start()

    def _read(self) -> None:
        try:
            for line in self.proc.stdout:
                self.lines.append(line[:500])
                if self.addr is None:
                    m = self.addr_re.search(line)
                    if m:
                        self.addr = m.group(1)
                        self.settled.set()
        except (OSError, ValueError):
            pass                            # pipe closed under us
        finally:
            self.settled.set()

    def tail(self) -> str:
        return "".join(self.lines)[-4000:]


class SubprocessProvider(CapacityProvider):
    """Local capacity = real replica processes. ``argv`` launches ONE
    replica that prints its serving address on stdout (matched by
    ``addr_pattern``, default the ``serving on host:port`` line the
    stock servers log). ``release`` terminates the process behind the
    address. A child that prints no address within ``spawn_timeout_s``
    (or exits first) is terminated and ``grow`` raises RuntimeError
    with the child's last lines."""

    def __init__(self, argv, addr_pattern: str = r"on ([\d.]+:\d+)",
                 spawn_timeout_s: float = 60.0) -> None:
        self.argv = list(argv)
        self.addr_re = re.compile(addr_pattern)
        self.spawn_timeout_s = spawn_timeout_s
        self._procs: dict = {}              # addr -> (Popen, _ChildOutput)

    def grow(self, n: int) -> list:
        addrs = []
        for _ in range(n):
            proc = subprocess.Popen(
                self.argv, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, errors="replace")
            out = _ChildOutput(proc, self.addr_re)
            out.settled.wait(self.spawn_timeout_s)
            if out.addr is None:
                self._reap(proc, out)
                raise RuntimeError(
                    f"replica process printed no address within "
                    f"{self.spawn_timeout_s}s (exit code "
                    f"{proc.returncode}): {self.argv}\n{out.tail()}")
            self._procs[out.addr] = (proc, out)
            addrs.append(out.addr)
        return addrs

    @staticmethod
    def _reap(proc, out) -> None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        out.thread.join(timeout=5)

    def release(self, addrs) -> None:
        for addr in addrs:
            entry = self._procs.pop(addr, None)
            if entry is not None:
                self._reap(*entry)


class FleetController:
    """Close the metrics->capacity loop over a running router.

    ``tick()`` is one pure decision step (the sim harness drives it
    directly, deterministically); ``start()`` runs it on a timer
    thread. Thresholds:

    - ``up_queue_per_replica``: mean reported load per live replica
      that, sustained, triggers a scale-up of ``step`` replicas.
    - ``down_utilization``: active-sessions / decode-slots floor below
      which, sustained, one replica is drained and released.
    - ``hysteresis_ticks``: consecutive out-of-band ticks required
      before acting (a one-tick spike never scales).
    - ``cooldown_ticks``: quiet ticks after ANY action (scaling churn
      is worse than brief over/under-capacity: every scale-down is a
      migration storm someone must absorb).
    - ``min_replicas`` / ``max_replicas``: hard clamps.
    """

    def __init__(self, router, provider: CapacityProvider,
                 min_replicas: int = 1, max_replicas: int = 16,
                 up_queue_per_replica: float = 4.0,
                 down_utilization: float = 0.3,
                 hysteresis_ticks: int = 3, cooldown_ticks: int = 10,
                 step: int = 1, interval_s: float = 1.0,
                 drain_timeout_s: float = 120.0,
                 registry=None, warmer=None) -> None:
        self.router = router
        self.provider = provider
        self.warmer = warmer                # FleetWarmer or None (cold admit)
        self.last_warm: dict | None = None  # summary of the last warm pass
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_queue_per_replica = float(up_queue_per_replica)
        self.down_utilization = float(down_utilization)
        self.hysteresis_ticks = int(hysteresis_ticks)
        self.cooldown_ticks = int(cooldown_ticks)
        self.step = int(step)
        self.interval_s = float(interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._over = 0                      # consecutive over-threshold ticks
        self._under = 0                     # consecutive under-threshold ticks
        self._cooldown = 0
        self._thread: threading.Thread | None = None
        self._stopping = threading.Event()
        reg = registry or metrics_mod.get_default()
        self._replicas_g = reg.gauge(
            "tony_fleet_replicas",
            help="live replicas under fleet control")
        self._load_g = reg.gauge(
            "tony_fleet_load_per_replica",
            help="mean SLO-relevant load per live replica (busy slots "
                 "+ interactive/standard backlog; batch backlog "
                 "excluded for class-aware replicas) — the scale-up "
                 "signal")
        self._ups_c = reg.counter(
            "tony_fleet_scale_ups_total",
            help="scale-up actions taken (replicas added = actions x "
                 "step)")
        self._downs_c = reg.counter(
            "tony_fleet_scale_downs_total",
            help="scale-down actions taken (each = one drained, "
                 "retired, released replica)")
        self._upgrades_c = reg.counter(
            "tony_fleet_upgrades_total",
            help="rolling weight upgrades completed (old tier fully "
                 "drained and retired)")

    # -- one decision step ---------------------------------------------------
    def _observe(self) -> tuple:
        """(live replica count, mean load per replica, utilization) —
        read from the router's STATS aggregation, the same numbers the
        ``tony_router_replica_*`` gauges export.

        Class-aware replicas report per-class ``queue_depths``; for
        those the scale-up signal counts busy slots plus ONLY the
        latency-sensitive backlog (interactive + standard). A deep
        batch queue is deliberate oversubscription — it is what the
        batch tier is FOR — and must never page in capacity on its
        own. Classless replicas keep the aggregate ``reported_load``
        fallback, so mixed fleets and old engines behave exactly as
        before."""
        st = self.router.stats()
        reps = [r for r in st["replicas"].values() if r["up"]]
        n = len(reps)
        total = 0.0
        for r in reps:
            depths = r.get("queue_depths") or {}
            # reported_load = waiting + busy slots, and waiting is the
            # sum of the class depths — so subtracting the batch depth
            # leaves busy slots + interactive/standard backlog
            total += max(0, r["reported_load"] - depths.get("batch", 0))
        load = (total / n) if n else 0.0
        slots = st.get("slots", 0)
        util = (st.get("active", 0) / slots) if slots else 1.0
        return n, load, util

    def tick(self) -> str:
        """Run one decision step; returns the action taken:
        ``"up"``, ``"down"``, or ``"hold"``."""
        n, load, util = self._observe()
        self._replicas_g.set(n)
        self._load_g.set(load)
        if self._cooldown > 0:
            self._cooldown -= 1
            return "hold"
        self._over = self._over + 1 if load > self.up_queue_per_replica \
            else 0
        self._under = self._under + 1 if (
            util < self.down_utilization
            and load < self.up_queue_per_replica) else 0
        if self._over >= self.hysteresis_ticks and n < self.max_replicas:
            self._scale_up(min(self.step, self.max_replicas - n))
            return "up"
        if self._under >= self.hysteresis_ticks and n > self.min_replicas:
            self._scale_down()
            return "down"
        return "hold"

    def _reset(self) -> None:
        self._over = self._under = 0
        self._cooldown = self.cooldown_ticks

    def _scale_up(self, n: int) -> None:
        addrs = self.provider.grow(n)
        addrs = self._warm(addrs)
        if addrs:
            self.router.add_replicas(addrs)
        self._ups_c.inc()
        self._reset()
        log.info("fleet: scaled up by %d (%s)", n, addrs)

    def _warm(self, addrs) -> list:
        """Warm fresh capacity before it takes traffic. With no warmer
        every address is admitted cold (storage load already happened
        in the provider). With one, targets the warm pass could not
        bring up — peer ship failed AND the storage fallback failed —
        are released instead of admitted: a replica that never landed
        the weights would 503 every stream routed at it."""
        if self.warmer is None or not addrs:
            return list(addrs)
        self.last_warm = res = self.warmer.warm(list(addrs))
        failed = list(res.get("failed", ()))
        if failed:
            log.warning("fleet: releasing %d unwarmable replicas (%s)",
                        len(failed), failed)
            self.provider.release(failed)
        dead = set(failed)
        return [a for a in addrs if a not in dead]

    def _scale_down(self) -> None:
        st = self.router.stats()
        candidates = [(r["reported_load"], r["assigned"], addr)
                      for addr, r in st["replicas"].items()
                      if r["up"] and not r["draining"]]
        if len(candidates) <= self.min_replicas:
            return
        _, _, addr = min(candidates)
        res = self.router.drain(addr, timeout_s=self.drain_timeout_s)
        self.router.remove_replica(addr)
        self.provider.release([addr])
        self._downs_c.inc()
        self._reset()
        log.info("fleet: scaled down %s (drain: %s)", addr, res)

    # -- rolling weight upgrade ----------------------------------------------
    def rolling_upgrade(self, new_addrs, old_addrs=None,
                        role: str | None = None) -> dict:
        """Replace the fleet's weights generation without dropping a
        stream: connect ``new_addrs`` (warmed first via the fleet's
        ``warmer`` when one is configured — one storage load seeds the
        tier, peers fan the weights out — otherwise already serving
        the new weights), then drain and retire each OLD replica in
        turn.
        Version-pinned placement keeps existing sessions on their
        generation while any same-version replica survives, and the
        per-replica drains migrate them (zero dup/drop) as their tier
        shrinks. ``old_addrs`` defaults to every replica the router
        knew before the call. Returns per-replica drain summaries."""
        st = self.router.stats()
        if old_addrs is None:
            old_addrs = [a for a, r in st["replicas"].items() if r["up"]]
        old_addrs = [a for a in old_addrs if a not in set(new_addrs)]
        new_addrs = self._warm(list(new_addrs))
        self.router.add_replicas(new_addrs, role=role)
        results = {}
        for addr in old_addrs:
            results[addr] = self.router.drain(
                addr, timeout_s=self.drain_timeout_s)
            self.router.remove_replica(addr)
            self.provider.release([addr])
        self._upgrades_c.inc()
        return results

    # -- timer loop ----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="tony-fleet-controller", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stopping.wait(self.interval_s):
            try:
                self.tick()
            except Exception:               # noqa: BLE001 - keep ticking
                log.exception("fleet controller tick failed")

    def stop(self) -> None:
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
