"""Network emulation for serving benchmarks/tests: a latency-injecting
TCP proxy.

:class:`LatencyProxy` forwards a local port to a target, delivering
each byte burst ``delay_s`` after it was read — in BOTH directions, so
one request/response round trip through the proxy costs ``2*delay_s``.
Crucially it models link LATENCY, not throughput: bursts are
timestamped on read and released by a separate writer thread, so
in-flight data overlaps (a stream of pushed token deltas pays the delay
once, pipelined, while a poll-per-chunk client pays it once per round
trip). That asymmetry is exactly what the streaming-vs-request/response
bench arm measures, deterministically, on loopback.

The port's copy of ``tony_tpu/serving/netem.py`` (stdlib only: no
torch). It forwards bytes, so it sits as well in front of a replica or a
router of either package.
"""

from __future__ import annotations

import queue
import socket
import threading
import time

from tony_tpu_torch.serving.protocol import set_nodelay

_BUF = 1 << 16


def _delayed_pump(src: socket.socket, dst: socket.socket,
                  delay_s: float) -> None:
    """Copy src→dst, releasing each burst ``delay_s`` after it was
    read. The writer thread sleeps per burst; reads continue in the
    meantime, so concurrent bursts' delays overlap (latency, not
    serialization)."""
    q: queue.Queue = queue.Queue()

    def writer() -> None:
        while True:
            item = q.get()
            if item is None:
                try:
                    dst.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                return
            deadline, data = item
            dt = deadline - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            try:
                dst.sendall(data)
            except OSError:
                return

    t = threading.Thread(target=writer, name="tony-netem-writer",
                         daemon=True)
    t.start()
    try:
        while True:
            data = src.recv(_BUF)
            if not data:
                break
            q.put((time.perf_counter() + delay_s, data))
    except OSError:
        pass
    q.put(None)
    t.join()


class LatencyProxy:
    """Listen locally, forward to ``remote_host:remote_port`` with
    ``delay_s`` of one-way latency injected per direction (round trip
    = ``2*delay_s``)."""

    def __init__(self, remote_host: str, remote_port: int,
                 delay_s: float, bind_host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.remote_host = remote_host
        self.remote_port = remote_port
        self.delay_s = delay_s
        self.bind_host = bind_host
        self.port = port
        self._server: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._stopping = threading.Event()
        self._conn_lock = threading.Lock()
        #: live (client, upstream) socket pairs — what sever() cuts
        self._conns: set = set()

    def start(self) -> int:
        server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server.bind((self.bind_host, self.port))
        server.listen(16)
        self.port = server.getsockname()[1]
        self._server = server
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="tony-netem-accept",
            daemon=True)
        self._accept_thread.start()
        return self.port

    def _accept_loop(self) -> None:
        assert self._server is not None
        while not self._stopping.is_set():
            try:
                client, _ = self._server.accept()
            except OSError:
                break
            threading.Thread(target=self._handle, args=(client,),
                             name="tony-netem-conn",
                             daemon=True).start()

    def _handle(self, client: socket.socket) -> None:
        try:
            upstream = socket.create_connection(
                (self.remote_host, self.remote_port), timeout=10)
        except OSError:
            client.close()
            return
        # latency injection must not compound with Nagle batching
        for s in (client, upstream):
            set_nodelay(s)
        upstream.settimeout(None)
        pair = (client, upstream)
        with self._conn_lock:
            self._conns.add(pair)
        t = threading.Thread(target=_delayed_pump,
                             args=(client, upstream, self.delay_s),
                             name="tony-netem-pump", daemon=True)
        t.start()
        _delayed_pump(upstream, client, self.delay_s)
        t.join()
        with self._conn_lock:
            self._conns.discard(pair)
        for s in pair:
            try:
                s.close()
            except OSError:
                pass

    def sever(self) -> int:
        """Hard-cut every connection currently flowing through the
        proxy (both sides see EOF/reset) while the listener keeps
        accepting — a crash/partition of the REPLICA as seen by its
        peers, without killing the process behind it. The chaos
        harness's replica-loss injection. Returns the number of
        connections cut."""
        with self._conn_lock:
            pairs = list(self._conns)
        for pair in pairs:
            for s in pair:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        return len(pairs)

    def stop(self) -> None:
        self._stopping.set()
        if self._server is not None:
            try:
                self._server.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._server.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
