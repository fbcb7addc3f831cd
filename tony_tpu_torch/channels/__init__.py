"""Typed tensor channels between processes: the port's copy of
``tony_tpu/channels``' transport (``channel.py``), on the same TONYC1
wire. The serving host's prefix-template and weights lanes ride its
byte-blob frames (``ChannelSender.send_bytes`` /
``ChannelReceiver.recv_bytes``). The pipeline lanes of
``tony_tpu/channels/registry.py`` are not ported."""

from tony_tpu_torch.channels.channel import (CODECS, ChannelClosed,
                                             ChannelError, ChannelHub,
                                             ChannelReceiver, ChannelSender,
                                             decode_tensor, encode_tensor,
                                             forbid_codecs)

__all__ = [
    "CODECS", "ChannelClosed", "ChannelError", "ChannelHub",
    "ChannelReceiver", "ChannelSender",
    "decode_tensor", "encode_tensor", "forbid_codecs",
]
