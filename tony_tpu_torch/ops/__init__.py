"""Ops of the port: flash attention forward and backward, fused AdamW,
RMSNorm and LayerNorm (CUDA kernels with their plain versions)."""

from tony_tpu_torch.ops.attention import (flash_attention,
                                          flash_attention_with_lse,
                                          reference_attention)
from tony_tpu_torch.ops.norms import (layer_norm, layer_norm_reference,
                                      rms_norm, rms_norm_reference)

__all__ = ["flash_attention", "flash_attention_with_lse",
           "layer_norm", "layer_norm_reference", "reference_attention",
           "rms_norm", "rms_norm_reference"]
