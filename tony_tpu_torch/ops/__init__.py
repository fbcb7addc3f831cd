"""Ops of the port: flash attention (a CUDA kernel and its plain version)
and RMSNorm."""

from tony_tpu_torch.ops.attention import (flash_attention,
                                          flash_attention_with_lse,
                                          reference_attention)
from tony_tpu_torch.ops.norms import rms_norm_reference

__all__ = ["flash_attention", "flash_attention_with_lse",
           "reference_attention", "rms_norm_reference"]
