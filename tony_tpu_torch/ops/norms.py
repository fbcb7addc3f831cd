"""RMSNorm in plain torch.

Port of ``tony_tpu/ops/norms.py::rms_norm_reference``. The JAX models
call only the reference functions, never the Pallas norm kernels
(``_rms_kernel``, ``_ln_kernel``), so this slice needs no kernel here.
"""

from __future__ import annotations

import torch


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in f32 math, output in x's dtype."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms * w.float()).to(x.dtype)
