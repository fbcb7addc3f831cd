"""Flash attention, forward and backward: hand-written CUDA kernels plus
their plain versions.

Port of ``tony_tpu/ops/attention.py``. The public
functions keep the JAX package's contract: layout ``[batch, seq, heads,
head_dim]``, K/V may carry fewer heads than Q (query head ``i`` reads kv
head ``i // (H/KV)``, never expanded in the kernel), a causal mask
``qpos >= kpos`` with an optional sliding window ``qpos - kpos <
window``, default scale ``head_dim ** -0.5``, o in the input dtype and a
natural-log lse ``[batch, heads, seq]`` in f32.

Dispatch is by the tensors' device: a CUDA tensor launches the kernels
or raises; a CPU tensor takes the plain versions. On the card, dtype
picks the kernel inside the C entry points (:func:`kernel_variant`):
bf16 the tensor-core kernels (mma.sync, FlashAttention-2 design), f32
the FP32-pipe kernels. Forward: K1
(``csrc/flash_fwd.cu``, :func:`flash_forward`), plain
:func:`_dense_with_lse`. Backward (``csrc/flash_bwd.cu``): K2, the fused
kv-major pass (:func:`flash_backward_fused`), or, when its f32 dQ
buffer passes ``TONY_FLASH_FUSED_PARTIALS_MB``, the two-pass route K3a
(:func:`flash_backward_dq`) then K3b (:func:`flash_backward_dkv`) —
:func:`backward_route` decides, as ``_flash_backward`` does from its dQ
partials; plain :func:`_dense_backward`. The TPU
kernel's tiling choices — the base-2 fold outside the kernel, 8-row head
padding, 128-lane lse, head groups, block-size clamps and the dense
fallback for sub-tile shapes — were made for VMEM and are not carried
over: the CUDA kernel masks ragged edges itself, so any sequence length
works.

Gradients: :func:`flash_attention_with_lse` (and :func:`flash_attention`,
which drops lse) is a ``torch.autograd.Function`` saving ``(q, k, v, o,
lse)`` that differentiates lse too, folding its cotangent into delta as
``delta - dlse`` (``tony_tpu/ops/attention.py:372-376, 655-658``).
"""

from __future__ import annotations

import os

import torch

from tony_tpu_torch.ops import _kernels

_NEG_INF = -1.0e30
_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: budget for the dQ buffer that picks the fused backward over the
#: two-pass one, read from the same variable as the JAX package
#: (``TONY_FLASH_FUSED_PARTIALS_MB``, default 1024; 0 forces two-pass)
_FUSED_PARTIALS_BYTES = int(os.environ.get(
    "TONY_FLASH_FUSED_PARTIALS_MB", "1024")) * 1024 * 1024


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


def _check_kv_heads(h: int, hk: int) -> None:
    if hk <= 0 or h % hk:
        raise ValueError(f"kv heads ({hk}) must divide query heads ({h})")


#: the kernel a dtype runs in every attention wrapper (K1, K2, K3a, K3b):
#: bf16 the tensor-core kernels (mma.sync), f32 the FP32-pipe kernels
#: (full f32, no TF32).
VARIANTS = {torch.bfloat16: "tensor_core", torch.float32: "fp32_pipe"}


def kernel_variant(dtype, wrapper=None) -> str:
    """``"tensor_core"`` or ``"fp32_pipe"``: the kernel that ``wrapper``
    (one of the four kernel wrappers; K1 by default) launches for inputs
    of ``dtype``, as the C entry points dispatch. Every wrapper follows
    the dtype alone."""
    if dtype not in VARIANTS:
        raise TypeError(f"the attention kernels take float32 or bfloat16, "
                        f"got {dtype}")
    return VARIANTS[dtype]


def _count(wrapper, dtype) -> None:
    wrapper.launches += 1
    wrapper.variant_launches[kernel_variant(dtype, wrapper)] += 1


def reset_launches() -> None:
    """Zero every attention wrapper's launch counts (total and per
    variant)."""
    for fn in (flash_forward, flash_backward_fused, flash_backward_dq,
               flash_backward_dkv):
        fn.launches = 0
        fn.variant_launches = dict.fromkeys(VARIANTS.values(), 0)


def _aligned(t):
    """``t`` contiguous at a 16-byte-aligned address: the tensor-core
    kernels move tiles with 16-byte copies. A view that starts off that
    alignment is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fn_name, device, args) -> None:
    """Call C entry point ``fn_name`` with ``args`` and the current stream
    of ``device``; raise if the launch was refused."""
    fn = getattr(_kernels.load(), fn_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    _kernels.check(rc, fn_name)


def flash_forward(q, k, v, *, causal: bool, scale: float,
                  window: int | None):
    """Launch the CUDA flash-attention forward on CUDA tensors and return
    ``(o, lse)``: bf16 runs the tensor-core kernel, f32 the FP32-pipe
    kernel (:func:`kernel_variant`). The wrapper of the kernels: it checks
    what they take, allocates the outputs and launches on the current
    stream without synchronising. ``flash_forward.launches`` counts the
    launches made, ``flash_forward.variant_launches`` them by variant."""
    b, sq, h, d = _check_cuda_qkv("flash_forward", q, k, v)
    sk, hk = k.shape[1], k.shape[2]
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("tony_flash_fwd", q.device,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), _DTYPE_CODES[q.dtype], b, sq, sk, h, hk, d,
             float(scale), int(causal), int(window or 0)))
    _count(flash_forward, q.dtype)
    return o, lse


def _check_device(what: str, ts) -> None:
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} takes CUDA tensors")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{what}: all tensors must be on one device")


def _check_cuda_qkv(what: str, q, k, v, *more):
    """Check what the CUDA kernels take: f32 or bf16 tensors of one dtype,
    q [B,S,H,D] and k = v [B,Sk,KV,D] with KV dividing H and D in (32,
    64, 128), on one CUDA device; ``more`` are tensors shaped like q.
    Dtype and shapes are checked before the device. Returns q's shape."""
    ts = (q, k, v) + more
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{what} takes float32 or bfloat16 tensors of one "
                        f"dtype, got {[t.dtype for t in ts]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,S,H,D] and k = v [B,Sk,KV,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if any(t.shape != q.shape for t in more):
        raise ValueError(f"{what}: o and do must be shaped like q")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError("q and k/v disagree on batch or head_dim")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the CUDA kernels "
                         f"(supported: {_HEAD_DIMS})")
    _check_kv_heads(h, k.shape[2])
    _check_device(what, ts)
    return b, sq, h, d


def _bwd_inputs(q, k, v, o, lse, do, dlse):
    """Contiguous, 16-byte-aligned q, k, v, do, the lse [B,H,S] f32 and
    delta = rowsum(do * o) - dlse [B,H,S] f32 that every backward kernel
    reads. delta is one plain pass outside the kernels, as the JAX
    package computes it outside its Pallas calls; dlse folds in here so
    the kernels never see it."""
    delta = (do.float() * o).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return (_aligned(q), _aligned(k), _aligned(v), _aligned(do),
            lse.float().contiguous(), delta.contiguous())


def _launch_bwd(fn_name, q, k, ptrs, *, causal, scale, window):
    b, sq, h, d = q.shape
    _launch(fn_name, q.device,
            (*ptrs, _DTYPE_CODES[q.dtype], b, sq, k.shape[1], h, k.shape[2],
             d, float(scale), int(causal), int(window or 0)))


def flash_backward_fused(q, k, v, o, lse, do, dlse=None, *, causal: bool,
                         scale: float, window: int | None):
    """K2: the fused kv-major backward on CUDA tensors → ``(dq, dk, dv)``
    in the input dtype (bf16 the tensor-core kernel, f32 the FP32-pipe
    one). dQ accumulates across kv tiles with f32 atomics into a zeroed
    f32 buffer, cast once at the end. The kernel's wrapper: checks,
    allocates, launches on the current stream without synchronising;
    ``flash_backward_fused.launches`` counts launches (and
    ``variant_launches`` by variant)."""
    _check_cuda_qkv("flash_backward_fused", q, k, v, o, do)
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, o, lse, do, dlse)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("tony_flash_bwd_fused", q, k,
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
                 dk.data_ptr(), dv.data_ptr()),
                causal=causal, scale=scale, window=window)
    _count(flash_backward_fused, q.dtype)
    return dq_acc.to(q.dtype), dk, dv


def flash_backward_dq(q, k, v, o, lse, do, dlse=None, *, causal: bool,
                      scale: float, window: int | None):
    """K3a: the q-major dQ pass of the two-pass backward on CUDA tensors
    → dq in the input dtype (f32 accumulation, no atomics: deterministic;
    bf16 the tensor-core kernel, f32 the FP32-pipe one).
    ``flash_backward_dq.launches`` counts launches (and
    ``variant_launches`` by variant)."""
    _check_cuda_qkv("flash_backward_dq", q, k, v, o, do)
    return _launch_dq(_bwd_inputs(q, k, v, o, lse, do, dlse), causal=causal,
                      scale=scale, window=window)


def _launch_dq(inputs, *, causal, scale, window):
    q, k, v, do, lse, delta = inputs
    dq = torch.empty_like(q)
    _launch_bwd("tony_flash_bwd_dq", q, k,
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
                causal=causal, scale=scale, window=window)
    _count(flash_backward_dq, q.dtype)
    return dq


def flash_backward_dkv(q, k, v, o, lse, do, dlse=None, *, causal: bool,
                       scale: float, window: int | None):
    """K3b: the kv-major dK/dV pass of the two-pass backward on CUDA
    tensors → ``(dk, dv)`` in the input dtype, summed over each kv head's
    query group (bf16 the tensor-core kernel, f32 the FP32-pipe one).
    ``flash_backward_dkv.launches`` counts launches."""
    _check_cuda_qkv("flash_backward_dkv", q, k, v, o, do)
    return _launch_dkv(_bwd_inputs(q, k, v, o, lse, do, dlse), causal=causal,
                       scale=scale, window=window)


def _launch_dkv(inputs, *, causal, scale, window):
    q, k, v, do, lse, delta = inputs
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("tony_flash_bwd_dkv", q, k,
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr()),
                causal=causal, scale=scale, window=window)
    _count(flash_backward_dkv, q.dtype)
    return dk, dv


reset_launches()


def tp_kv_heads(n_heads: int, kv_heads: int, rank: int,
                size: int) -> tuple[int, int]:
    """The kv heads ``[lo, hi)`` that rank ``rank`` of a ``size``-way
    head split needs when it holds query heads ``[rank·H/size,
    (rank+1)·H/size)`` and every kv head (GQA under tp replicates K/V):
    global query head ``g`` reads kv head ``g // (H/KV)``. Cut to that
    range, the kernels' own rule (local query head ``i`` reads local kv
    head ``i // (H_local/KV_local)``) gives the same pairs. It holds when
    ``size`` divides KV or KV divides ``size``; other splits raise."""
    if n_heads % size or (kv_heads % size and size % kv_heads):
        raise ValueError(f"{n_heads} query / {kv_heads} kv heads do not "
                         f"split over {size} ranks")
    _check_kv_heads(n_heads, kv_heads)
    h_local, group = n_heads // size, n_heads // kv_heads
    lo = rank * h_local // group
    return lo, max(lo + 1, (rank + 1) * h_local // group)


def fused_dq_bytes(q_shape) -> int:
    """Bytes of the f32 ``[B, S, H, D]`` dQ buffer K2 adds into: the
    memory the fused route costs beyond the two-pass one. It takes the
    place of the JAX package's count of its per-kv-tile dQ partials
    (``nk · B·H · S · D · itemsize``, ``:634``), which K2 never stores."""
    b, sq, h, d = q_shape
    return b * sq * h * d * 4


def backward_route(q_shape, budget: int | None = None) -> str:
    """``"fused"`` (K2) when its dQ buffer fits the budget
    (``TONY_FLASH_FUSED_PARTIALS_MB``; 0 forces two-pass), else
    ``"two_pass"`` (K3a + K3b) — the choice ``_flash_backward`` makes
    (``:634-638``)."""
    budget = _FUSED_PARTIALS_BYTES if budget is None else budget
    return "fused" if fused_dq_bytes(q_shape) <= budget else "two_pass"


def _forward(q, k, v, causal, scale, window):
    if q.device.type == "cpu":
        return _dense_with_lse(q, k, v, causal=causal, scale=scale,
                               window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return flash_forward(q, k, v, causal=causal, scale=scale, window=window)


def _backward(q, k, v, o, lse, do, dlse, causal, scale, window):
    if q.device.type == "cpu":
        return _dense_backward(q, k, v, o, lse, do, dlse, causal=causal,
                               scale=scale, window=window)
    kw = dict(causal=causal, scale=scale, window=window)
    if backward_route(q.shape) == "fused":
        return flash_backward_fused(q, k, v, o, lse, do, dlse, **kw)
    # K3a and K3b read the same prepared inputs: delta is computed once
    _check_cuda_qkv("flash_backward two-pass", q, k, v, o, do)
    inputs = _bwd_inputs(q, k, v, o, lse, do, dlse)
    return (_launch_dq(inputs, **kw),) + _launch_dkv(inputs, **kw)


class _FlashAttention(torch.autograd.Function):
    """(o, lse), both differentiated; lse's cotangent folds into delta
    (what cross-chunk softmax merging needs). An unused lse gets no
    cotangent (None), so plain attention pays nothing for it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        o, lse = _forward(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, window)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = _backward(q, k, v, o, lse, do, dlse, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             scale: float | None = None,
                             window: int | None = None):
    """Fused attention over ``[B, S, H, D]`` inputs, returning
    ``(o, lse)`` with lse ``[B, H, S]`` f32 natural log. GQA K/V (fewer
    heads than Q) and sliding windows as in the module docstring. A CUDA
    tensor runs the kernels, a CPU tensor the plain versions.
    Differentiable in q, k, v through o and lse."""
    window = _resolve_window(window, causal, q.shape[1])
    _check_kv_heads(q.shape[2], k.shape[2])
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    return _FlashAttention.apply(q, k, v, causal, scale, window)


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


def _dense_backward(q, k, v, o, lse, do, dlse=None, *, causal: bool,
                    scale: float | None, window: int | None = None):
    """Dense gradients ``(dq, dk, dv)`` in plain torch — the plain version
    of K2 and K3a/K3b, taken for CPU tensors and used by the tests and
    the chip smoke to hold the kernels to. In f32 whatever the input
    dtype: ``p = exp(s - lse)`` (0 where masked), ``delta = rowsum(do·o)
    - dlse``, ``ds = p·(dp - delta)``; p and ds round to the input dtype
    before the products that consume them (dV, dK, dQ), as the JAX
    package's backward kernels and the CUDA kernels do (the identity in
    f32); dK/dV of a kv head sum over its query group. Outputs in the
    inputs' dtypes."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    _check_kv_heads(h, hk)
    rep = h // hk
    window = _resolve_window(window, causal, sq)
    scale = (d ** -0.5) if scale is None else scale
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = qpos >= kpos
        if window is not None:
            mask = mask & (qpos - kpos < window)
        p = p.masked_fill(~mask, 0.0)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)           # [B,H,S]
    if dlse is not None:
        delta = delta - dlse.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    pr, dsr = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dsr, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dsr, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", pr, dof)
    dk = dk.reshape(b, sk, hk, rep, d).sum(3)
    dv = dv.reshape(b, sk, hk, rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: float | None = None,
                        window: int | None = None):
    """Dense O(S²) attention in plain torch (GQA- and window-aware; see
    :func:`_dense_with_lse`, whose output this is)."""
    o, _ = _dense_with_lse(q, k, v, causal=causal, scale=scale,
                           window=window)
    return o
