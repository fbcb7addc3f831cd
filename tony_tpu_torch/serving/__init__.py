"""The port's serving host: the TONYS1 streaming protocol, its server
over a :class:`~tony_tpu_torch.models.serve.ServeEngine`, the
stdlib-only streaming client, the server's prefix and weights lanes
(``prefix``, ``kvship``, ``blobcodec``, ``weightstore``), the two tiers
of disaggregated serving (``disagg``: ``PrefillServer`` ships KV
packages to ``DecodeServer`` over TONYC1 channels) and the multi-replica
``ServingRouter`` — copies of ``tony_tpu/serving``'s modules, on the
same wire.

The re-exports below are lazy: ``protocol``, ``client`` and ``router``
load no model stack (no torch), so a client or a gateway host imports
them cheaply.
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
}

__all__ = ["ProtocolError", *_LAZY]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'tony_tpu_torch.serving' has no attribute {name!r}")
