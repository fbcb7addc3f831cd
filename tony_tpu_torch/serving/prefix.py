"""Prefix-aware serving: the shared-prefix catalog and the template-ship
plane — the port's copy of ``tony_tpu/serving/prefix.py``, on the same
TONYC1 lane and PREFIX ops, so a JAX replica and a port replica warm
each other.

Production traffic is prefix-heavy — system prompts, few-shot
templates, multi-turn chat — and a prefix computed on one replica is
pure waste to recompute on another. This module holds the pieces every
layer shares:

- **Identity**: a prefix is named by an id — any caller-chosen string,
  or :func:`fingerprint` (a content hash of the token sequence), so
  two processes that never spoke agree on the name of the same prefix.
- **Matching**: :func:`match_prefix` finds the LONGEST registered
  prefix that is a proper token-boundary prefix of a prompt — the
  router's fallback when an ADMIT names no prefix id, and the engine's
  resolution against its resident store.
- **Hosting** (:class:`PrefixHost`): the mixin a serving-plane server
  (:class:`~tony_tpu_torch.serving.server.ServingServer`) uses
  to be warmable: a :class:`~tony_tpu_torch.channels.channel.ChannelHub`
  lane (``PREFIX_CHANNEL``) receiving template blobs
  (``kvship.pack_template`` wire shape), an install thread that lands
  them into the host's resident store, the ``PREFIX`` frame ops
  (install / publish / list), and :meth:`PrefixHost.publish_prefix` —
  a warm replica ships its resident template to a cold one in ONE
  channel send instead of the cold replica recomputing the prefill.

A malformed or mismatched template blob (wrong vocab, wrong layer
count, truncated) costs only ITSELF: the install thread logs, records
a flight event, and keeps serving — template warming is an
optimization and must never be able to kill a replica.
"""

from __future__ import annotations

import hashlib
import logging
import struct
import threading

from tony_tpu_torch.channels.channel import (ChannelClosed, ChannelError,
                                       ChannelHub, ChannelSender)
from tony_tpu_torch.serving import kvship
from tony_tpu_torch.serving import protocol as P

log = logging.getLogger(__name__)

#: the channel lane template blobs ride (one hub port per replica,
#: multiplexed by name — a replica that also lands KV shipments keeps
#: them on their own lane)
PREFIX_CHANNEL = "prefix"


def fingerprint(tokens) -> str:
    """Content-derived prefix id: a 16-hex-digit sha256 over the token
    sequence packed as little-endian u32s. Two processes that tokenized
    the same system prompt name it identically without coordination."""
    packed = struct.pack(f"<{len(tokens)}I",
                         *(int(t) & 0xFFFFFFFF for t in tokens))
    return hashlib.sha256(packed).hexdigest()[:16]


def match_prefix(prompt, catalog) -> str | None:
    """Longest token-boundary match: the id of the longest catalog
    entry that is a PROPER prefix of ``prompt`` (strictly shorter — a
    prompt that IS the prefix leaves no suffix to run through the
    model), or None. ``catalog``: {prefix_id: token list} or an
    iterable of ``(prefix_id, tokens)`` pairs. The ONE copy of the
    matching invariant — the router's catalog fallback and both
    engines' resident-store resolution all come through here. The
    candidate list is snapshotted first: catalogs/stores are grown
    concurrently (register ops, template-install threads) and dict
    iteration during an insert raises."""
    items = catalog.items() if isinstance(catalog, dict) else catalog
    best = None
    best_len = 0
    n = len(prompt)
    for pid, toks in list(items):
        k = len(toks)
        if k <= best_len or k >= n:
            continue
        if list(prompt[:k]) == list(toks):
            best, best_len = pid, k
    return best


class PrefixHost:
    """Mixin: a serving-plane server that hosts resident prefix
    templates and can be WARMED over the template-ship lane (see module
    docstring). The concrete class implements the store:

    - ``install_prefix(tokens, prefix_id=None) -> str | None`` —
      compute the template locally and make it resident (None = the
      host degraded, e.g. a rolling-cache layout);
    - ``install_prefix_template(meta, bufs) -> str`` — land an
      unpacked shipped template (raises ``ValueError`` /
      ``ProtocolError`` on a mismatched one);
    - ``resident_prefixes() -> list[str]``;
    - ``_prefix_blob(prefix_id) -> bytes`` — pack a resident entry for
      publication (raises ``ValueError`` when not resident).

    and calls ``_init_prefix_host(registry)`` in ``__init__``,
    ``_start_prefix_host()`` in ``start()``, ``_stop_prefix_host()``
    in ``stop()``/``kill()``, and routes ``PREFIX`` frames to
    :meth:`_handle_prefix_frame`."""

    def _init_prefix_host(self, registry) -> None:
        self._prefix_reg = registry
        self._prefix_hub = ChannelHub(port=0, capacity=4,
                                      registry=registry)
        self._prefix_install_thread: threading.Thread | None = None
        self._prefix_installs_c = registry.counter(
            "tony_prefix_installs_total",
            help="prefix templates made resident (computed locally or "
                 "landed from a template ship)")
        self._prefix_ships_c = registry.counter(
            "tony_prefix_ships_total",
            help="prefix template blobs published to peer replicas")
        self._prefix_ship_bytes_c = registry.counter(
            "tony_prefix_ship_bytes_total",
            help="prefix template payload bytes published to peers")

    @property
    def prefix_port(self) -> int:
        """The template-ship lane's bound port (HELLO-advertised)."""
        return self._prefix_hub.port

    def _start_prefix_host(self) -> None:
        self._prefix_hub.start()
        self._prefix_install_thread = threading.Thread(
            target=self._prefix_install_loop, name="tony-prefix-install",
            daemon=True)
        self._prefix_install_thread.start()

    def _stop_prefix_host(self) -> None:
        self._prefix_hub.stop()
        if self._prefix_install_thread is not None:
            self._prefix_install_thread.join(timeout=10)

    # -- the install thread (template ships land here) ----------------------
    def _prefix_install_loop(self) -> None:
        receiver = self._prefix_hub.receiver(PREFIX_CHANNEL)
        while True:
            try:
                blob = receiver.recv_bytes(timeout=0.25)
            except ChannelClosed:
                return                  # hub stopped: lane is dead
            except ChannelError:
                continue                # timeout; re-check liveness
            except P.ProtocolError as e:
                log.warning("prefix lane: non-template frame dropped: %s",
                            e)
                continue
            try:
                meta, bufs = kvship.unpack_template(blob)
                pid = self.install_prefix_template(meta, bufs)
                self._prefix_installs_c.inc()
                log.info("prefix %s resident via template ship "
                         "(%d bytes, %d tokens)", pid, len(blob),
                         len(meta["tokens"]))
            except Exception as e:      # noqa: BLE001 — thread survival
                # a bad template costs only itself: warming is an
                # optimization, and a dead install thread would
                # silently make this replica forever cold
                log.warning("prefix lane: template install rejected: %s",
                            e)
                from tony_tpu_torch.runtime import tracing
                tracing.get_flight().record("prefix_template_rejected",
                                            error=str(e)[:500])

    # -- publication --------------------------------------------------------
    def publish_prefix(self, prefix_id: str, target: str,
                       timeout_s: float = 30.0) -> int:
        """Ship the resident template ``prefix_id`` to ``target`` (a
        peer's ``host:prefix_port`` template lane) in ONE
        delivery-confirmed channel send; returns the blob size. The
        peer warms without running a single prefill forward for the
        prefix. Raises ``ValueError`` (not resident) or
        :class:`~tony_tpu_torch.channels.channel.ChannelError` (peer
        unreachable)."""
        blob = self._prefix_blob(prefix_id)
        sender = ChannelSender(target, PREFIX_CHANNEL, window=2,
                               registry=self._prefix_reg)
        try:
            sender.send_bytes(blob, sync=True, timeout=timeout_s)
        finally:
            sender.close(drain=False)
        self._prefix_ships_c.inc()
        self._prefix_ship_bytes_c.inc(len(blob))
        return len(blob)

    # -- the PREFIX frame ops (conn reader threads) -------------------------
    def _handle_prefix_frame(self, conn, rid: int, payload: bytes) -> None:
        """``PREFIX`` op dispatch. Op failures are REQUEST-scoped
        (``{"ok": false, "error": ...}`` back on the same rid) — an
        operator fat-fingering a publish target must not cost the
        connection, let alone the replica."""
        obj = P.unpack_json(payload)    # structural garbage: conn-scoped
        op = obj.get("op")
        try:
            if op == "install":
                tokens = obj.get("tokens")
                if (not isinstance(tokens, list) or not tokens
                        or not all(isinstance(t, int)
                                   and not isinstance(t, bool)
                                   for t in tokens)):
                    raise ValueError("install needs a non-empty token "
                                     "list")
                pid = self.install_prefix(tokens,
                                          prefix_id=obj.get("id"))
                if pid is None:
                    body = {"ok": False,
                            "error": "replica degraded prefix-blind "
                                     "(rolling-cache layout)"}
                else:
                    self._prefix_installs_c.inc()
                    body = {"ok": True, "id": pid,
                            "resident": self.resident_prefixes()}
            elif op == "publish":
                pid = obj.get("id")
                target = obj.get("target")
                if not isinstance(pid, str) or not isinstance(target, str):
                    raise ValueError("publish needs 'id' and 'target'")
                n = self.publish_prefix(pid, target)
                body = {"ok": True, "id": pid, "bytes": n}
            elif op == "list":
                body = {"ok": True,
                        "resident": self.resident_prefixes()}
            else:
                body = {"ok": False, "error": f"unknown prefix op {op!r}"}
        except (ValueError, KeyError, ChannelError, P.ProtocolError) as e:
            body = {"ok": False, "error": str(e)}
        conn.send(P.PREFIX, rid, P.pack_json(body))
