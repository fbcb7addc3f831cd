"""Ops of the port: flash attention forward and backward and fused AdamW
(CUDA kernels with their plain versions), and RMSNorm."""

from tony_tpu_torch.ops.attention import (flash_attention,
                                          flash_attention_with_lse,
                                          reference_attention)
from tony_tpu_torch.ops.norms import rms_norm_reference

__all__ = ["flash_attention", "flash_attention_with_lse",
           "reference_attention", "rms_norm_reference"]
