"""Flash attention forward: a hand-written CUDA kernel plus its plain version.

Port of ``tony_tpu/ops/attention.py`` (forward only). The public
functions keep the JAX package's contract: layout ``[batch, seq, heads,
head_dim]``, K/V may carry fewer heads than Q (query head ``i`` reads kv
head ``i // (H/KV)``, never expanded in the kernel), a causal mask
``qpos >= kpos`` with an optional sliding window ``qpos - kpos <
window``, default scale ``head_dim ** -0.5``, o in the input dtype and a
natural-log lse ``[batch, heads, seq]`` in f32.

Dispatch is by the tensors' device: a CUDA tensor launches the kernel
(``csrc/flash_fwd.cu``, through :func:`flash_forward`) or raises; a CPU
tensor takes the plain version :func:`_dense_with_lse`. The TPU
kernel's tiling choices — the base-2 fold outside the kernel, 8-row head
padding, 128-lane lse, head groups, block-size clamps and the dense
fallback for sub-tile shapes — were made for VMEM and are not carried
over: the CUDA kernel masks ragged edges itself, so any sequence length
works.

Forward only: tensors that require a gradient raise
``NotImplementedError`` (the backward kernels come with training).
"""

from __future__ import annotations

import torch

from tony_tpu_torch.ops import _kernels

_NEG_INF = -1.0e30
_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _resolve_window(window, causal: bool, sq: int) -> int | None:
    """Validate/normalize the sliding-window size: None or >= sq means
    full causal attention; windowed non-causal attention is undefined
    (the window is anchored on the causal diagonal)."""
    if window is None:
        return None
    if not causal:
        raise ValueError("sliding-window attention requires causal=True "
                         "(the window is anchored on the diagonal)")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return None if window >= sq else int(window)


def _check_forward_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "flash attention is forward-only in this package so far; "
            "the backward kernels come with the training port")


def _check_kv_heads(h: int, hk: int) -> None:
    if hk <= 0 or h % hk:
        raise ValueError(f"kv heads ({hk}) must divide query heads ({h})")


def flash_forward(q, k, v, *, causal: bool, scale: float,
                  window: int | None):
    """Launch the CUDA flash-attention forward on contiguous CUDA tensors
    and return ``(o, lse)``. The wrapper of the kernel: it checks what
    the kernel takes, allocates the outputs and launches on the current
    stream without synchronising. ``flash_forward.launches`` counts the
    launches made."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_forward takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_forward takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,S,H,D] and k = v [B,Sk,KV,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError("q and k/v disagree on batch or head_dim")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the CUDA kernel "
                         f"(supported: {_HEAD_DIMS})")
    _check_kv_heads(h, hk)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _kernels.load().tony_flash_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), _DTYPE_CODES[q.dtype], b, sq, sk, h, hk, d,
                float(scale), int(causal), int(window or 0), stream)
    _kernels.check(rc, "flash_fwd")
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             scale: float | None = None,
                             window: int | None = None):
    """Fused attention over ``[B, S, H, D]`` inputs, returning
    ``(o, lse)`` with lse ``[B, H, S]`` f32 natural log. GQA K/V (fewer
    heads than Q) and sliding windows as in the module docstring. A CUDA
    tensor runs the kernel, a CPU tensor the plain version."""
    _check_forward_only(q, k, v)
    window = _resolve_window(window, causal, q.shape[1])
    if q.device.type == "cpu":
        return _dense_with_lse(q, k, v, causal=causal, scale=scale,
                               window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    return flash_forward(q, k, v, causal=causal, scale=scale, window=window)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, window: int | None = None):
    """Like :func:`flash_attention_with_lse`, returning o only."""
    o, _ = flash_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                    window=window)
    return o


def _dense_with_lse(q, k, v, *, causal: bool, scale: float | None,
                    window: int | None = None):
    """Dense (o, lse) in plain torch — the plain version of the kernel,
    taken for CPU tensors and used by the tests and the chip smoke to
    hold the kernel to. GQA K/V are expanded here (clarity over the
    bandwidth saving the kernel exists for). Scores and the softmax are
    f32 whatever the input dtype; probabilities round to v's dtype before
    the value product, as in the JAX package."""
    d = q.shape[-1]
    h, hk = q.shape[2], k.shape[2]
    window = _resolve_window(window, causal, q.shape[1])
    if h != hk:
        _check_kv_heads(h, hk)
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = qpos >= kpos
        if window is not None:
            mask = mask & (qpos - kpos < window)
        s = s.masked_fill(~mask, _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype), lse


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: float | None = None,
                        window: int | None = None):
    """Dense O(S²) attention in plain torch (GQA- and window-aware; see
    :func:`_dense_with_lse`, whose output this is)."""
    o, _ = _dense_with_lse(q, k, v, causal=causal, scale=scale,
                           window=window)
    return o
