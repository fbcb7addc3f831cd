"""tony_tpu_torch's LatencyProxy against the JAX package's.

A port ``SimReplica`` (the ``sim_token`` oracle, no model stack) behind
a ``LatencyProxy`` of either package: the streams equal the unproxied
ones frame for frame, each direction adds its delay (a STATS request
reaches the replica no sooner than ``delay_s`` after it was sent, and
its reply reaches the client no sooner than ``delay_s`` after the
replica sent it), and ``sever`` drops the connections flowing through
while the listener keeps accepting new ones.
"""

import queue
import socket
import time

import pytest

from tony_tpu.serving import netem as JNET
from tony_tpu_torch.serving import netem as NET
from tony_tpu_torch.serving import protocol as P
from tony_tpu_torch.serving.client import StreamingClient
from tony_tpu_torch.serving.simfleet import SimReplica, sim_token

pytestmark = pytest.mark.fleet_sim

DELAY_S = 0.05
PROXIES = {"port": NET.LatencyProxy, "jax": JNET.LatencyProxy}


class _Stamped(SimReplica):
    """A simulated replica that notes when each STATS request arrives
    (its reply is sent straight after)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.stats_at = []

    def _handle_frame(self, conn, ftype, rid, payload):
        if ftype == P.STATS:
            self.stats_at.append(time.monotonic())
        super()._handle_frame(conn, ftype, rid, payload)


def _frames(port, seeds, budget):
    """Every event of each stream, in order, up to its terminal."""
    with StreamingClient("127.0.0.1", port) as c:
        rids = [c.submit([s, 1, 2], budget) for s in seeds]
        out = []
        for r in rids:
            evs = []
            while True:
                ev = c.next_event(r, timeout=30)
                evs.append(ev)
                if ev[0] != "tokens":
                    break
            out.append(evs)
    return out


@pytest.fixture
def replica():
    rep = _Stamped(itl_s=0.002, slots=4)
    rep.start()
    yield rep
    rep.stop()


@pytest.mark.parametrize("pkg", sorted(PROXIES))
def test_proxied_streams_equal_unproxied_frame_for_frame(replica, pkg):
    proxy = PROXIES[pkg]("127.0.0.1", replica.port, DELAY_S)
    pport = proxy.start()
    try:
        seeds, budget = [300, 301, 302, 303, 304], 12
        direct = _frames(replica.port, seeds, budget)
        proxied = _frames(pport, seeds, budget)
        assert proxied == direct
        for s, evs in zip(seeds, direct):
            assert evs[-1][:2] == ("retired", "budget")
            assert [t for e in evs[:-1] for t in e[1]] == \
                [sim_token(s, p) for p in range(budget)]
            assert all(len(e[1]) == 1 for e in evs[:-1])   # a frame a token
    finally:
        proxy.stop()


@pytest.mark.parametrize("pkg", sorted(PROXIES))
def test_each_direction_adds_its_delay(replica, pkg):
    proxy = PROXIES[pkg]("127.0.0.1", replica.port, DELAY_S)
    pport = proxy.start()
    try:
        with socket.create_connection(("127.0.0.1", pport),
                                      timeout=10) as s:
            t0 = time.monotonic()
            s.sendall(P.MAGIC)
            hello = P.recv_frame(s)
            assert hello[0] == P.HELLO
            assert time.monotonic() - t0 >= 2 * DELAY_S   # a round trip
            for _ in range(3):
                n = len(replica.stats_at)
                t_send = time.monotonic()
                P.send_frame(s, P.STATS, 0, b"")
                frame = P.recv_frame(s)
                t_recv = time.monotonic()
                assert frame[0] == P.STATS
                assert len(replica.stats_at) == n + 1
                t_srv = replica.stats_at[-1]
                assert t_srv - t_send >= DELAY_S          # client -> replica
                assert t_recv - t_srv >= DELAY_S          # replica -> client
    finally:
        proxy.stop()


@pytest.mark.parametrize("pkg", sorted(PROXIES))
def test_sever_drops_open_links_and_keeps_accepting(replica, pkg):
    proxy = PROXIES[pkg]("127.0.0.1", replica.port, DELAY_S / 5)
    pport = proxy.start()
    try:
        with StreamingClient("127.0.0.1", pport) as c:
            rid = c.submit([555, 1, 2], 100000)
            assert c.next_event(rid, timeout=10)[0] == "tokens"
            assert proxy.sever() >= 1
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                try:
                    ev = c.next_event(rid, timeout=1.0)
                except queue.Empty:
                    continue
                if ev[0] != "tokens":
                    break
            assert ev[0] == "error", ev
        deadline = time.monotonic() + 10          # the replica lets go
        while replica._sessions and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not replica._sessions
        assert _frames(pport, [556], 6)[0][-1][:2] == ("retired", "budget")
    finally:
        proxy.stop()
