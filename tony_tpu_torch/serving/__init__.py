"""The port's serving host: the TONYS1 streaming protocol, its server
over a :class:`~tony_tpu_torch.models.serve.ServeEngine`, the
stdlib-only streaming client, the server's prefix and weights lanes
(``prefix``, ``kvship``, ``blobcodec``, ``weightstore``), the two tiers
of disaggregated serving (``disagg``: ``PrefillServer`` ships KV
packages to ``DecodeServer`` over TONYC1 channels), the multi-replica
``ServingRouter``, and the fleet's operations — copies of
``tony_tpu/serving``'s modules, on the same wire:

  fleet    — FleetController + CapacityProvider: metrics-driven autoscale
             (grow, warm, drain, release) and rolling weight upgrades
             over a running router; ``SubprocessProvider`` grows real
             ``serve_lm --listen`` replica processes
  simfleet — SimFleet / SimReplica: simulated replicas behind a real
             router (the ``sim_token`` oracle, no model stack) for
             fleet-scale drain, storm and autoscale tests
  netem    — LatencyProxy: per-direction latency injection and severed
             links in front of any replica or router

``weightstore.warm_fanout`` / ``ChannelWarmer`` warm new capacity peer
to peer before it takes traffic.

The re-exports below are lazy: ``protocol``, ``client``, ``router``,
``fleet``, ``simfleet`` and ``netem`` load no model stack (no torch), so
a client, a gateway or a fleet controller imports them cheaply.
"""

from tony_tpu_torch.serving.protocol import ProtocolError

_LAZY = {
    "ServingServer": ("tony_tpu_torch.serving.server", "ServingServer"),
    "StreamingClient": ("tony_tpu_torch.serving.client", "StreamingClient"),
    "ServingConnectionError": ("tony_tpu_torch.serving.client",
                               "ServingConnectionError"),
    "ServingRouter": ("tony_tpu_torch.serving.router", "ServingRouter"),
    "PrefillServer": ("tony_tpu_torch.serving.disagg", "PrefillServer"),
    "DecodeServer": ("tony_tpu_torch.serving.disagg", "DecodeServer"),
    "LatencyProxy": ("tony_tpu_torch.serving.netem", "LatencyProxy"),
    "FleetController": ("tony_tpu_torch.serving.fleet", "FleetController"),
    "CapacityProvider": ("tony_tpu_torch.serving.fleet",
                         "CapacityProvider"),
    "SimFleet": ("tony_tpu_torch.serving.simfleet", "SimFleet"),
    "SimReplica": ("tony_tpu_torch.serving.simfleet", "SimReplica"),
}

__all__ = ["ProtocolError", *_LAZY]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'tony_tpu_torch.serving' has no attribute {name!r}")
