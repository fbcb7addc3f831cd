"""Trainer-side link discovery for cross-slice pipeline stages.

The port's copy of the trainer half of ``tony_tpu/channels/registry.py``,
on the port's TONYC1 channel (:mod:`tony_tpu_torch.channels.channel`),
so a port stage gang and a JAX one share the wire. The coordinator
(``tony_tpu``'s ``build_channel_specs``) folds the pipeline declaration
(``tony.pipeline.stages``) and the gangs' channel ports into one channel
spec per task; the executor exports it as ``TONY_PIPELINE_*`` /
``TONY_CHANNEL_*``, and :func:`open_stage_links_from_env` turns those
back into live transport for :class:`~tony_tpu_torch.parallel.pipeline
.CrossSlicePipeline`.

Per-task channel spec (JSON on the wire, :func:`parse_channel_spec`)::

    {"stage": 1, "num_stages": 2, "rank": 0, "ranks": 1,
     "prev": "hostA:chportA",     # stage-1 peer's hub ("" at stage 0)
     "next": "hostC:chportC"}     # stage+1 peer's hub ("" at the last)

plus ``"interleave"`` and ``"compression"`` when they are not 1 and
``"none"``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from tony_tpu_torch import constants
from tony_tpu_torch.channels.channel import (ChannelHub, ChannelReceiver,
                                             ChannelSender)

#: channel names on a task's hub: activations flowing INTO this stage,
#: cotangents flowing back INTO this stage. With interleaving (v virtual
#: stage chunks per gang) each chunk gets its own lane — ``act.1``,
#: ``grad.2``, … — named by the CONSUMING chunk; chunk 0 keeps the bare
#: names, so a non-interleaved job's wire is unchanged.
ACT_CHANNEL = "act"
GRAD_CHANNEL = "grad"


def act_channel(chunk: int = 0) -> str:
    return ACT_CHANNEL if chunk == 0 else f"{ACT_CHANNEL}.{chunk}"


def grad_channel(chunk: int = 0) -> str:
    return GRAD_CHANNEL if chunk == 0 else f"{GRAD_CHANNEL}.{chunk}"


@dataclass
class StageLinks:
    """A stage gang member's live transport endpoints:

    - ``act_in`` / ``grad_in``: receivers on this task's own hub
      (activations from stage-1, cotangents from stage+1);
    - ``act_out`` / ``grad_out``: senders dialing the neighbours' hubs.

    Boundary stages hold ``None`` on the missing side. ``close`` drains
    the senders (so the last microbatch's cotangents land), then stops
    the hub.

    With ``interleave`` = v > 1 the gang holds v virtual stage chunks
    (chunk j is virtual stage ``j * num_stages + stage``, the looping
    placement) and the per-chunk lanes live in ``act_ins`` /
    ``act_outs`` / ``grad_ins`` / ``grad_outs`` (index = chunk, ``None``
    at the model boundary); the scalar fields stay chunk 0's lanes.
    Stage neighbours form a ring: every chunk's activations go out on
    ``next`` and cotangents on ``prev``, the lane name carrying the
    consuming chunk.
    """
    stage: int
    num_stages: int
    rank: int = 0
    interleave: int = 1
    compression: str = "none"
    hub: ChannelHub | None = None
    act_in: ChannelReceiver | None = None
    act_out: ChannelSender | None = None
    grad_in: ChannelReceiver | None = None
    grad_out: ChannelSender | None = None
    act_ins: list = None
    act_outs: list = None
    grad_ins: list = None
    grad_outs: list = None

    @property
    def is_first(self) -> bool:
        return self.stage == 0

    @property
    def is_last(self) -> bool:
        return self.stage == self.num_stages - 1

    @property
    def num_virtual(self) -> int:
        return self.num_stages * self.interleave

    def global_stage(self, chunk: int = 0) -> int:
        """This gang's chunk ``chunk`` as a virtual stage index in
        ``0..num_virtual-1``."""
        return chunk * self.num_stages + self.stage

    def _senders(self):
        seen = []
        for group in (self.act_outs or [self.act_out],
                      self.grad_outs or [self.grad_out]):
            for sender in group:
                if sender is not None and sender not in seen:
                    seen.append(sender)
        return seen

    def close(self) -> None:
        for sender in self._senders():
            sender.close(drain=True)
        if self.hub is not None:
            self.hub.stop()


def _wire_links(links: StageLinks, *, prev: str, next: str,
                window: int, registry) -> StageLinks:
    """Attach the per-chunk lanes (and chunk 0's scalar mirrors) to a
    StageLinks whose hub is listening. Chunk j of gang s is virtual
    stage g = j*S + s; activations for g+1 ride ``next`` on the
    consuming chunk's act lane, cotangents for g-1 ride ``prev`` on the
    consuming chunk's grad lane. With interleave 1 this is the plain
    act/grad pair."""
    s, S, v = links.stage, links.num_stages, links.interleave
    V = links.num_virtual
    codec = links.compression
    hub = links.hub
    links.act_ins, links.act_outs = [], []
    links.grad_ins, links.grad_outs = [], []
    for j in range(v):
        g = j * S + s
        links.act_ins.append(
            hub.receiver(act_channel(j), codec=codec) if g > 0 else None)
        links.grad_ins.append(
            hub.receiver(grad_channel(j), codec=codec)
            if g < V - 1 else None)
        # the consuming chunk on the ring successor/predecessor gang: the
        # same chunk inside the chain, the next/previous one where the
        # hop wraps past gang S-1 / gang 0
        links.act_outs.append(
            ChannelSender(next, act_channel(j if s < S - 1 else j + 1),
                          window=window, codec=codec, registry=registry)
            if g < V - 1 else None)
        links.grad_outs.append(
            ChannelSender(prev, grad_channel(j if s > 0 else j - 1),
                          window=window, codec=codec, registry=registry)
            if g > 0 else None)
    links.act_in = links.act_ins[0]
    links.act_out = links.act_outs[0]
    links.grad_in = links.grad_ins[0]
    links.grad_out = links.grad_outs[0]
    return links


def open_stage_links(*, stage: int, num_stages: int, rank: int = 0,
                     prev: str = "", next: str = "",
                     interleave: int = 1, compression: str = "none",
                     hub_port: int = 0, window: int = 8,
                     capacity: int = 8, registry=None) -> StageLinks:
    """Stand up this task's hub and dial its neighbours. ``prev`` /
    ``next`` are the neighbour hubs' ``host:port`` ("" at the pipeline
    boundary; with ``interleave`` > 1 the boundary gangs need them too:
    the stages close into a ring). Senders dial lazily, so a neighbour
    whose hub is still coming up is absorbed by the sender's connect
    retry."""
    if not 0 <= stage < num_stages:
        raise ValueError(f"stage {stage} outside 0..{num_stages - 1}")
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    ring = interleave > 1
    if (stage > 0 or ring) and not prev:
        raise ValueError(f"stage {stage} has no upstream channel endpoint")
    if (stage < num_stages - 1 or ring) and not next:
        raise ValueError(f"stage {stage} has no downstream channel endpoint")
    hub = ChannelHub(port=hub_port, capacity=capacity, registry=registry)
    hub.start()
    links = StageLinks(stage=stage, num_stages=num_stages, rank=rank,
                       interleave=interleave, compression=compression,
                       hub=hub)
    return _wire_links(links, prev=prev, next=next, window=window,
                       registry=registry)


def open_local_pipeline(num_stages: int, *, window: int = 8,
                        capacity: int = 8, interleave: int = 1,
                        compression: str = "none", registry=None,
                        endpoint_map=None) -> list[StageLinks]:
    """Wire ``num_stages`` stages of one process over loopback (each
    "gang" a thread): the test and measurement harness of the
    cross-slice schedule. Every hub starts first, so there is no
    bring-up order; ``endpoint_map(stage, port) -> "host:port"`` lets a
    harness put a proxy in front of a stage's hub."""
    hubs = [ChannelHub(capacity=capacity, registry=registry)
            for _ in range(num_stages)]
    ports = [hub.start() for hub in hubs]
    ring = interleave > 1

    def addr(k: int) -> str:
        if endpoint_map is not None:
            return endpoint_map(k, ports[k])
        return f"127.0.0.1:{ports[k]}"

    links = []
    for k in range(num_stages):
        link = StageLinks(stage=k, num_stages=num_stages,
                          interleave=interleave, compression=compression,
                          hub=hubs[k])
        prev = addr((k - 1) % num_stages) if (k > 0 or ring) else ""
        nxt = addr((k + 1) % num_stages) \
            if (k < num_stages - 1 or ring) else ""
        links.append(_wire_links(link, prev=prev, next=nxt,
                                 window=window, registry=registry))
    return links


def stage_env(environ=None) -> dict | None:
    """The executor-exported pipeline env, parsed (None when this
    process is not a pipeline stage)."""
    env = os.environ if environ is None else environ
    stage = env.get(constants.PIPELINE_STAGE)
    if stage is None or stage == "":
        return None
    return {
        "stage": int(stage),
        "num_stages": int(env.get(constants.PIPELINE_NUM_STAGES, "1")),
        "rank": int(env.get(constants.PIPELINE_RANK, "0")),
        "prev": env.get(constants.CHANNEL_PREV, ""),
        "next": env.get(constants.CHANNEL_NEXT, ""),
        "interleave": int(env.get(constants.PIPELINE_INTERLEAVE, "1")
                          or "1"),
        "compression": env.get(constants.CHANNEL_COMPRESSION, "") or "none",
        "hub_port": int(env.get(constants.CHANNEL_PORT, "0")),
    }


def open_stage_links_from_env(environ=None, *, window: int = 8,
                              capacity: int = 8,
                              registry=None) -> StageLinks | None:
    """env → live :class:`StageLinks` (None outside a pipeline). The
    hub binds the port the executor reserved and advertised to the
    coordinator: the peers are already dialing it."""
    env = stage_env(environ)
    if env is None:
        return None
    return open_stage_links(window=window, capacity=capacity,
                            registry=registry, **env)


def parse_channel_spec(spec_json: str) -> dict | None:
    """The wire channel spec, decoded; None for a worker outside a
    pipeline (empty string) or a malformed payload (the trainer is then
    simply not a pipeline stage)."""
    if not spec_json:
        return None
    try:
        obj = json.loads(spec_json)
    except json.JSONDecodeError:
        return None
    return obj if isinstance(obj, dict) and "stage" in obj else None
