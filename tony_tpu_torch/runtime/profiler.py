"""Profiling hooks for the port's tasks, on ``torch.profiler``.

The port's copy of ``tony_tpu/runtime/profiler.py``, which drives
``jax.profiler``; here every capture is a ``torch.profiler`` run that
writes a Chrome trace (``<host>_<pid>.<ns>.pt.trace.json``, the name
``torch.profiler.tensorboard_trace_handler`` gives, so TensorBoard's
PyTorch profiler plugin and Perfetto read it):

- :func:`maybe_start`: driven by the executor's environment. With
  ``tony.task.profile.enabled`` each task starts a capture listener on
  its reserved TensorBoard port (``TB_PORT``), the counterpart of
  ``jax.profiler.start_server``: ``GET /capture?ms=N`` records N ms of
  the whole process and writes the trace under :func:`profile_dir`.
- :func:`trace`: a context manager capturing the enclosed block.
- :class:`StepTracer`: captures steps ``[start, stop)`` of a loop, the
  steady state without the warm-up.
- :class:`PhaseTimes`: a host-side wall-clock accumulator for the
  phases of a host-driven loop (the serving batchers record
  ``dispatch``/``fetch``/``admit``/``retire``).

What a capture holds. It records CPU activity (aten ops, with their
input shapes), plus the card's kernels and copies when a card is
present. CUPTI's kernel records are process-wide, so every capture holds
the kernels of every thread. ``torch.profiler`` records aten ops only on
the thread that started it unless asked for every thread: a
:class:`StepTracer` or :func:`trace` capture runs on the loop's own
thread and holds that thread's ops; a live capture starts on the
listener's thread and asks for every thread's
(``profile_all_threads``), so it holds the training or engine thread's
ops too. On the card a capture synchronises the device before it starts
and before it stops, so it holds the kernels launched inside it,
finished. In a process with a long history of card work it misses its
first GPU records: those launches are in the trace, their kernels not.
The count grows with what the process has run (none in a fresh process,
53 after ``chip_smoke.py``'s 21 phases on an H100 with torch 2.11 and
CUDA 12.8), not with the time or the number of captures. A trainer's
:class:`StepTracer` runs a few steps into a fresh process and holds
every kernel.

One profiler runs at a time in a process. A capture that finds another
running is refused: a live request gets HTTP 409 and the loop's thread
never sees it; a :class:`StepTracer` logs it and tries again at its next
step inside its window; :func:`trace` raises :class:`CaptureBusy`.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from tony_tpu_torch import constants

log = logging.getLogger(__name__)

#: the longest live capture one request may ask for
MAX_CAPTURE_MS = 60_000

_server_started = False
_server: ThreadingHTTPServer | None = None
#: the card of the process that started the listener (its thread records
#: on it), None when CUDA was not initialized then
_server_card: int | None = None
#: held by the one capture running in this process
_capture_lock = threading.Lock()


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


def profile_dir() -> str | None:
    """Trace directory of this task, or None when profiling is off. A
    directory per task keeps the captures of many processes apart."""
    base = os.environ.get(constants.TONY_PROFILE_DIR, "")
    if not base:
        return None
    job = os.environ.get(constants.JOB_NAME, "worker")
    idx = os.environ.get(constants.TASK_INDEX, "0")
    return os.path.join(base, f"{job}-{idx}")


def _activities() -> list:
    """CPU activity, and the card's when one is present."""
    import torch
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])


def _warm_up() -> None:
    """One empty capture on the calling thread. Kineto sets up its client
    only when its first session starts on the thread that loaded torch: a
    first session on the listener's thread skips that ("External init
    callback must run in same thread as registerClient") and records no
    aten op of any thread. It also moves Kineto's start-up (seconds with
    CUPTI) out of the first capture."""
    from torch.profiler import profile
    with profile(activities=_activities()):
        pass


class CaptureBusy(RuntimeError):
    """Another capture is running in this process."""


class _Capture:
    """One ``torch.profiler`` run, holding the process's capture lock
    from construction until :meth:`stop`."""

    def __init__(self, logdir: str, all_threads: bool = False,
                 card: int | None = None) -> None:
        if not _capture_lock.acquire(blocking=False):
            raise CaptureBusy("another capture is running in this process "
                              "(a step trace or a live request)")
        try:
            import torch
            from torch.profiler import profile
            self.cuda = torch.cuda.is_available()
            self.card = card
            kw = {}
            if all_threads:
                from torch._C._profiler import _ExperimentalConfig
                kw["experimental_config"] = _ExperimentalConfig(
                    profile_all_threads=True)
            os.makedirs(logdir, exist_ok=True)
            self.logdir = logdir
            self._sync()
            self.prof = profile(activities=_activities(),
                                record_shapes=True, **kw)
            self.prof.start()
        except BaseException:
            _capture_lock.release()
            raise

    def _sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.card)

    def stop(self, sync: bool = True) -> str:
        """Stop recording and write the trace; returns its path. Without
        ``sync`` the card is not waited for: its kernels still running are
        left out of the trace."""
        try:
            if sync:
                self._sync()
            self.prof.stop()
            path = os.path.join(
                self.logdir, f"{socket.gethostname()}_{os.getpid()}."
                             f"{time.time_ns()}.pt.trace.json")
            self.prof.export_chrome_trace(path)
            return path
        finally:
            _capture_lock.release()


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture the enclosed block into a Chrome trace under ``logdir``
    (default: :func:`profile_dir`); a no-op when neither is set. Raises
    :class:`CaptureBusy` when another capture is running."""
    logdir = logdir or profile_dir()
    if logdir is None:
        yield
        return
    cap = _Capture(logdir)
    try:
        yield
    finally:
        log.info("trace written to %s", cap.stop())


class StepTracer:
    """Capture steps [start, stop) of a training loop::

        tracer = StepTracer(start=10, stop=13)   # skip the warm-up
        for step in range(total):
            tracer.step(step)
            state, m = train_step(state, batch)
        tracer.close()

    Each captured step is a ``ProfilerStep#<step>`` range in the trace
    (the name ``torch.profiler``'s own step marks take). ``path`` is the
    trace written, once the window closed."""

    def __init__(self, start: int = 10, stop: int = 13,
                 logdir: str | None = None) -> None:
        self.start = start
        self.stop = stop
        self.logdir = logdir or profile_dir()
        self.path: str | None = None
        self._capture: _Capture | None = None
        self._mark = None

    @property
    def _active(self) -> bool:
        return self._capture is not None

    def step(self, step: int) -> None:
        if self.logdir is None:
            return
        if self._capture is None and self.start <= step < self.stop:
            try:
                self._capture = _Capture(self.logdir)
            except CaptureBusy:
                log.warning("step trace [%d,%d): a live capture is running "
                            "at step %d; trying again at the next step",
                            self.start, self.stop, step)
                return
        elif self._capture is not None and step >= self.stop:
            self.close()
            log.info("step trace [%d,%d) written to %s", self.start,
                     self.stop, self.path)
            return
        if self._capture is not None:
            self._end_mark()
            from torch.profiler import record_function
            self._mark = record_function(f"ProfilerStep#{step}")
            self._mark.__enter__()

    def _end_mark(self) -> None:
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
            self._mark = None

    def close(self, failing: bool = False) -> None:
        """Stop a capture that is still open (and write its trace). With
        ``failing`` (the loop raised or lost its gang) the card is not
        waited for, since a failed collective may never finish, and an
        error of the stop is logged, not raised: the loop's own error or
        exit code stands."""
        if self._capture is None:
            return
        cap, self._capture = self._capture, None
        if not failing:
            self._end_mark()
            self.path = cap.stop()
            return
        try:
            self._end_mark()
        finally:
            try:
                self.path = cap.stop(sync=False)
            except Exception:  # noqa: BLE001 - the loop's outcome stands
                log.warning("step trace [%d,%d): stopping the capture of a "
                            "failing loop failed", self.start, self.stop,
                            exc_info=True)


def _live_capture(ms: int) -> str:
    """Record ``ms`` milliseconds of every thread of the process; the
    trace's path. Runs on a listener thread."""
    logdir = profile_dir()
    if logdir is None:
        raise FileNotFoundError("no trace directory: set "
                                "tony.task.profile.dir")
    cap = _Capture(logdir, all_threads=True, card=_server_card)
    try:
        time.sleep(ms / 1e3)
    finally:
        path = cap.stop()
    return path


class _CaptureHandler(BaseHTTPRequestHandler):
    """``GET /capture?ms=N``: 200 with ``{"ok": true, "trace": path,
    "ms": N}``; 400 for a bad duration, 409 when another capture is
    running, 503 with no trace directory, 500 when the capture failed;
    every refusal with ``{"ok": false, "error": ...}``."""

    def do_GET(self) -> None:  # noqa: N802 - http.server's name
        url = urlparse(self.path)
        if url.path != "/capture":
            self._answer(404, error=f"unknown path {url.path}; use "
                                    f"/capture?ms=N")
            return
        try:
            ms = int(parse_qs(url.query).get("ms", ["1000"])[0])
        except ValueError:
            ms = 0
        if not 0 < ms <= MAX_CAPTURE_MS:
            self._answer(400, error=f"ms must be in 1..{MAX_CAPTURE_MS}")
            return
        try:
            path = _live_capture(ms)
        except CaptureBusy as e:
            self._answer(409, error=str(e))
        except FileNotFoundError as e:
            self._answer(503, error=str(e))
        except Exception as e:  # noqa: BLE001 - answer, keep listening
            log.warning("live capture failed", exc_info=True)
            self._answer(500, error=f"{type(e).__name__}: {e}")
        else:
            self._answer(200, trace=path, ms=ms)

    def _answer(self, code: int, **body) -> None:
        data = json.dumps({"ok": code == 200, **body}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args) -> None:
        log.debug("capture listener: " + fmt, *args)


def _start_server(port: int) -> ThreadingHTTPServer:
    """Bind the capture listener on ``port`` (every interface) and serve
    it from a daemon thread."""
    server = ThreadingHTTPServer(("", port), _CaptureHandler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, name="tony-profiler",
                     daemon=True).start()
    return server


def maybe_start() -> bool:
    """Start this task's capture listener (idempotent) when profiling is
    enabled. Returns whether the listener is LIVE: False when profiling
    is off, when no ``TB_PORT`` is exported (or it is 0), or when the bind
    failed. Trace files from :func:`trace` / :class:`StepTracer` do not
    need it; they follow ``tony.task.profile.dir``."""
    global _server_started, _server, _server_card
    enabled = os.environ.get(constants.TONY_PROFILE_ENABLED, "") == "true"
    if not enabled:
        return False
    if _server_started:
        return True
    port = int(os.environ.get(constants.TB_PORT, "0") or "0")
    if not port:
        log.warning("profiling enabled but no TB_PORT exported — capture "
                    "listener not started")
        return False
    try:
        with _capture_lock:
            _warm_up()
        _server = _start_server(port)
    except Exception:  # noqa: BLE001 - profiling never fails the task
        log.warning("capture listener failed to start", exc_info=True)
        return False
    import torch
    _server_card = (torch.cuda.current_device()
                    if torch.cuda.is_initialized() else None)
    _server_started = True
    log.info("torch.profiler capture listener on port %d", port)
    return True


def _reset_server_state_for_tests() -> None:
    """Stop the listener, if any, and forget that it was started, so that
    :func:`maybe_start`'s decisions can be exercised again."""
    global _server_started, _server, _server_card
    if _server is not None:
        _server.shutdown()
        _server.server_close()
    _server_started, _server, _server_card = False, None, None
