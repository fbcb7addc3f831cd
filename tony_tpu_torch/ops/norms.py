"""RMSNorm and LayerNorm: hand-written CUDA forwards plus their plain
versions.

Port of ``tony_tpu/ops/norms.py``. :func:`rms_norm` and
:func:`layer_norm` compute what the JAX package's ``rms_norm`` /
``layer_norm`` (and their ``*_reference`` twins) compute: f32 math over
the last dim, eps 1e-6, one rounding to x's dtype; LayerNorm's variance
is the two-pass one (centred values squared).

Dispatch is by the tensor's device. A CPU tensor takes the plain
version, :func:`rms_norm_reference` / :func:`layer_norm_reference`,
under autograd. A CUDA tensor runs a ``torch.autograd.Function`` whose
forward launches the kernel, K5 (:func:`rms_norm_forward`) or K6
(:func:`layer_norm_forward`) from ``csrc/norms.cu``, and whose backward
is a plain torch copy of the JAX package's ``_rms_bwd`` / ``_ln_bwd``:
the JAX package has no backward kernel for either, so the port needs
none. Gradients come back in the inputs' dtypes; ``_ln_bwd`` returns db
in f32 whatever b's dtype is, while here db is cast to b's dtype (as
autograd would cast it anyway), so the two agree exactly when b is f32.
"""

from __future__ import annotations

import torch

from tony_tpu_torch.ops import _kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in f32 math, output in x's dtype."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms * w.float()).to(x.dtype)


def layer_norm_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim in f32 math (two-pass variance),
    output in x's dtype."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return (xc * inv * w.float() + b.float()).to(x.dtype)


def _check_cuda_norm(what: str, x, *params) -> int:
    """Check what the kernels take: CUDA tensors on one device, x f32 or
    bf16 with a last dim d, each param a ``[d]`` vector of f32 or bf16.
    Returns d."""
    ts = (x,) + params
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} takes CUDA tensors")
    if any(t.device != x.device for t in ts):
        raise ValueError(f"{what}: all tensors must be on one device")
    if any(t.dtype not in _DTYPE_CODES for t in ts):
        raise TypeError(f"{what} takes float32 or bfloat16 tensors, got "
                        f"{[t.dtype for t in ts]}")
    d = x.shape[-1] if x.dim() else 0
    if d == 0 or any(t.shape != (d,) for t in params):
        raise ValueError(f"{what}: x [..., d] with d > 0 and params [d], "
                         f"got {tuple(x.shape)} and "
                         f"{[tuple(t.shape) for t in params]}")
    return d


def _launch(fn_name: str, x, params, eps: float):
    """Run one norm kernel over x viewed as ``[rows, d]``; returns the
    output shaped like x, in x's dtype."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    params = [p.contiguous() for p in params]
    out = torch.empty_like(x2)
    if x2.shape[0]:
        fn = getattr(_kernels.load(), fn_name)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(x2.data_ptr(), *(p.data_ptr() for p in params),
                    out.data_ptr(), _DTYPE_CODES[x.dtype],
                    *(_DTYPE_CODES[p.dtype] for p in params), x2.shape[0],
                    d, float(eps), stream)
        _kernels.check(rc, fn_name)
    return out.reshape(x.shape)


def rms_norm_forward(x, w, eps: float = 1e-6):
    """K5: RMSNorm over the last dim of a CUDA tensor. The kernel's
    wrapper: checks, allocates the output and launches on the current
    stream without synchronising; ``rms_norm_forward.launches`` counts
    launches (a tensor with no rows launches nothing)."""
    _check_cuda_norm("rms_norm_forward", x, w)
    out = _launch("tony_rms_norm", x, (w,), eps)
    if out.numel():
        rms_norm_forward.launches += 1
    return out


rms_norm_forward.launches = 0


def layer_norm_forward(x, w, b, eps: float = 1e-6):
    """K6: LayerNorm over the last dim of a CUDA tensor, as
    :func:`rms_norm_forward`; ``layer_norm_forward.launches`` counts
    launches."""
    _check_cuda_norm("layer_norm_forward", x, w, b)
    out = _launch("tony_layer_norm", x, (w, b), eps)
    if out.numel():
        layer_norm_forward.launches += 1
    return out


layer_norm_forward.launches = 0


def _lead_dims(x) -> tuple:
    return tuple(range(x.dim() - 1))


def _rms_backward(x, w, g, eps: float):
    """``(dx, dw)`` of RMSNorm for the cotangent g: the JAX package's
    ``_rms_bwd`` in plain torch, f32 math, each gradient in its input's
    dtype."""
    xf, gf, wf = x.float(), g.float(), w.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    gw = gf * wf
    dx = inv * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    dw = (gf * xhat).sum(dim=_lead_dims(x))
    return dx.to(x.dtype), dw.to(w.dtype)


def _ln_backward(x, w, g, eps: float):
    """``(dx, dw, db)`` of LayerNorm for the cotangent g: the JAX
    package's ``_ln_bwd`` in plain torch, f32 math; dx and dw in their
    inputs' dtypes, db in f32 (the caller casts it to b's dtype)."""
    xf, gf, wf = x.float(), g.float(), w.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * inv
    gw = gf * wf
    dx = inv * (gw - gw.mean(dim=-1, keepdim=True)
                - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    lead = _lead_dims(x)
    return dx.to(x.dtype), (gf * xhat).sum(dim=lead).to(w.dtype), \
        gf.sum(dim=lead)


class _RMSNorm(torch.autograd.Function):
    """K5 forward, plain backward; saves (x, w)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rms_norm_forward(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _rms_backward(x, w, g, ctx.eps)
        return dx, dw, None


class _LayerNorm(torch.autograd.Function):
    """K6 forward, plain backward; saves (x, w) and b's dtype."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.b_dtype = eps, b.dtype
        return layer_norm_forward(x, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw, db = _ln_backward(x, w, g, ctx.eps)
        return dx, dw, db.to(ctx.b_dtype), None


def _on_cuda(x, what: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, differentiable in x and w: K5 for a
    CUDA tensor, :func:`rms_norm_reference` for a CPU tensor."""
    if not _on_cuda(x, "rms_norm"):
        return rms_norm_reference(x, w, eps)
    return _RMSNorm.apply(x, w, eps)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim, differentiable in x, w and b: K6 for
    a CUDA tensor, :func:`layer_norm_reference` for a CPU tensor."""
    if not _on_cuda(x, "layer_norm"):
        return layer_norm_reference(x, w, b, eps)
    return _LayerNorm.apply(x, w, b, eps)
