"""Typed tensor channels between processes: the port's copy of
``tony_tpu/channels``' transport (``channel.py``), on the same TONYC1
wire, and the trainer side of its registry (``registry.py``). The
serving host's prefix-template and weights lanes ride its byte-blob
frames (``ChannelSender.send_bytes`` / ``ChannelReceiver.recv_bytes``);
the pipeline's activation and cotangent lanes ride its tensor frames
(:class:`StageLinks`, opened from the executor's env by
:func:`open_stage_links_from_env`)."""

from tony_tpu_torch.channels.channel import (CODECS, ChannelClosed,
                                             ChannelError, ChannelHub,
                                             ChannelReceiver, ChannelSender,
                                             decode_tensor, encode_tensor,
                                             forbid_codecs)
from tony_tpu_torch.channels.registry import (ACT_CHANNEL, GRAD_CHANNEL,
                                              StageLinks, act_channel,
                                              grad_channel,
                                              open_local_pipeline,
                                              open_stage_links,
                                              open_stage_links_from_env,
                                              parse_channel_spec, stage_env)

__all__ = [
    "ACT_CHANNEL", "CODECS", "ChannelClosed", "ChannelError", "ChannelHub",
    "ChannelReceiver", "ChannelSender", "GRAD_CHANNEL", "StageLinks",
    "act_channel", "decode_tensor", "encode_tensor", "forbid_codecs",
    "grad_channel", "open_local_pipeline", "open_stage_links",
    "open_stage_links_from_env", "parse_channel_spec", "stage_env",
]
