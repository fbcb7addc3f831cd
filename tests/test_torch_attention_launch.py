"""What surrounds the CUDA attention kernels in Python, on the CPU.

The kernels themselves run only on the card (chip_smoke.py phases 3 and
6, and the ``cuda``-marked tests of test_torch_attention*.py). Here: the
dtype → kernel-variant dispatch and the per-variant launch counts of the
four wrappers (with the launch itself replaced by a recorder), the
wrappers refusing shapes and dtypes the kernels do not take, the
16-byte alignment the tensor-core kernels' copies need, the build hash
covering the shared headers, and the ctypes argument lists against the
``extern "C"`` signatures in the sources.
"""

import ctypes
import os
import re

import pytest
import torch

from tony_tpu_torch.ops import _kernels
from tony_tpu_torch.ops import attention as A

torch.set_num_threads(2)

WRAPPERS = {
    "flash_forward": ("tony_flash_fwd", 5),
    "flash_backward_fused": ("tony_flash_bwd_fused", 9),
    "flash_backward_dq": ("tony_flash_bwd_dq", 7),
    "flash_backward_dkv": ("tony_flash_bwd_dkv", 8),
}


@pytest.fixture
def counts():
    A.reset_launches()
    yield
    A.reset_launches()


def _call(name, q, k, v):
    kw = dict(causal=True, scale=q.shape[-1] ** -0.5, window=None)
    if name == "flash_forward":
        return A.flash_forward(q, k, v, **kw)
    o = torch.zeros_like(q)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1])
    return getattr(A, name)(q, k, v, o, lse, torch.ones_like(q), **kw)


def _qkv(dtype, b=1, s=17, h=4, kv=2, d=64):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(b, s, h, d, generator=g).to(dtype),
            torch.randn(b, s, kv, d, generator=g).to(dtype),
            torch.randn(b, s, kv, d, generator=g).to(dtype))


def test_kernel_variant_follows_the_dtype():
    assert A.kernel_variant(torch.bfloat16) == "tensor_core"
    assert A.kernel_variant(torch.float32) == "fp32_pipe"
    # every wrapper, K3a included, runs its tensor-core kernel in bf16
    for fn in (A.flash_forward, A.flash_backward_fused, A.flash_backward_dq,
               A.flash_backward_dkv):
        assert A.kernel_variant(torch.bfloat16, fn) == "tensor_core"
        assert A.kernel_variant(torch.float32, fn) == "fp32_pipe"
    with pytest.raises(TypeError):
        A.kernel_variant(torch.float16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_passes_the_dtype_code_and_counts_its_variant(
        monkeypatch, counts, name, dtype):
    """Each wrapper hands its C entry point the dtype code the C side
    dispatches on (0 f32, 1 bf16) and counts the launch under the variant
    that code selects; nothing else is counted."""
    calls = []
    monkeypatch.setattr(A, "_check_device", lambda what, ts: None)
    monkeypatch.setattr(A, "_launch",
                        lambda fn_name, device, args: calls.append(
                            (fn_name, args)))
    q, k, v = _qkv(dtype)
    _call(name, q, k, v)
    fn_name, n_ptrs = WRAPPERS[name]
    assert [c[0] for c in calls] == [fn_name]
    args = calls[0][1]
    assert args[n_ptrs] == {torch.float32: 0, torch.bfloat16: 1}[dtype]
    # B, Sq, Sk, H, KV, D, scale, causal, window follow the dtype code
    assert args[n_ptrs + 1:n_ptrs + 7] == (1, 17, 17, 4, 2, 64)
    assert all(isinstance(p, int) for p in args[:n_ptrs])
    fn = getattr(A, name)
    variant = A.kernel_variant(dtype, fn)
    assert fn.launches == 1
    want = {"tensor_core": 0, "fp32_pipe": 0}
    want[variant] = 1
    assert fn.variant_launches == want
    others = [getattr(A, n) for n in WRAPPERS if n != name]
    assert all(f.launches == 0 for f in others)


def test_reset_launches_zeroes_every_count(monkeypatch, counts):
    monkeypatch.setattr(A, "_check_device", lambda what, ts: None)
    monkeypatch.setattr(A, "_launch", lambda *a: None)
    for name in WRAPPERS:
        _call(name, *_qkv(torch.bfloat16))
    assert all(getattr(A, n).launches == 1 for n in WRAPPERS)
    A.reset_launches()
    for name in WRAPPERS:
        fn = getattr(A, name)
        assert fn.launches == 0
        assert fn.variant_launches == {"tensor_core": 0, "fp32_pipe": 0}


REFUSED = {
    "head_dim_48": (dict(d=48), ValueError, "head_dim 48"),
    "head_dim_256": (dict(d=256), ValueError, "head_dim 256"),
    "float16": (dict(dtype=torch.float16), TypeError, "float32 or bfloat16"),
    "kv_not_dividing": (dict(h=4, kv=3), ValueError, "must divide"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_refuses_what_the_kernels_do_not_take(counts, name, case):
    spec, exc, match = REFUSED[case]
    spec = dict(spec)
    dtype = spec.pop("dtype", torch.bfloat16)
    q, k, v = _qkv(dtype, **spec)
    with pytest.raises(exc, match=match):
        _call(name, q, k, v)
    assert getattr(A, name).launches == 0


def test_wrapper_refuses_mixed_dtypes_and_mismatched_shapes(counts):
    q, k, v = _qkv(torch.bfloat16)
    with pytest.raises(TypeError, match="of one dtype"):
        A.flash_forward(q, k.float(), v, causal=True, scale=0.1, window=None)
    with pytest.raises(ValueError, match="k = v"):
        A.flash_forward(q, k, v[:, :5], causal=True, scale=0.1, window=None)
    with pytest.raises(ValueError, match=r"q \[B,S,H,D\]"):
        A.flash_forward(q[0], k, v, causal=True, scale=0.1, window=None)
    with pytest.raises(ValueError, match="batch or head_dim"):
        A.flash_forward(q, k[:, :, :, :32].contiguous(),
                        v[:, :, :, :32].contiguous(), causal=True,
                        scale=0.1, window=None)
    o, lse = torch.zeros_like(q), torch.zeros(1, 4, 17)
    with pytest.raises(ValueError, match="shaped like q"):
        A.flash_backward_fused(q, k, v, o[:, :5], lse, q, causal=True,
                               scale=0.1, window=None)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_refuses_cpu_tensors_of_a_good_shape(counts, name):
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        _call(name, *_qkv(torch.bfloat16))
    assert getattr(A, name).launches == 0


def test_aligned_copies_a_view_off_16_bytes():
    base = torch.arange(1 + 2 * 3 * 4 * 32, dtype=torch.float32).to(
        torch.bfloat16)
    view = base[1:].view(2, 3, 4, 32)       # 2 bytes past the storage
    assert view.data_ptr() % 16 == 2
    out = A._aligned(view)
    assert out.data_ptr() % 16 == 0
    assert torch.equal(out, view)
    ok = torch.zeros(2, 3, 4, 32, dtype=torch.bfloat16)
    assert A._aligned(ok).data_ptr() == ok.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_inputs_leave_their_arguments_alone(dtype):
    """delta = rowsum(do * o) - dlse in f32 [B, H, S], computed without
    touching do or o (in f32, ``do.float()`` is do itself)."""
    g = torch.Generator().manual_seed(1)
    q, k, v, o, do = (torch.randn(2, 9, 4, 32, generator=g).to(dtype)
                      for _ in range(5))
    lse, dlse = (torch.randn(2, 4, 9, generator=g) for _ in range(2))
    before = [t.clone() for t in (q, k, v, o, do, lse, dlse)]
    *_, lse_out, delta = A._bwd_inputs(q, k, v, o, lse, do, dlse)
    for t, b in zip((q, k, v, o, do, lse, dlse), before):
        assert torch.equal(t, b)
    want = (do.double() * o.double()).sum(-1).transpose(1, 2) - dlse.double()
    assert delta.dtype == torch.float32 and delta.shape == (2, 4, 9)
    torch.testing.assert_close(delta.double(), want, atol=1e-5, rtol=1e-5)
    assert lse_out.dtype == torch.float32 and lse_out.is_contiguous()


def test_library_path_follows_sources_headers_and_flags(monkeypatch,
                                                        tmp_path):
    src = tmp_path / "k.cu"
    hdr = tmp_path / "common.cuh"
    src.write_text('#include "common.cuh"\n')
    hdr.write_text("// v1\n")
    monkeypatch.setattr(_kernels, "CSRC", str(tmp_path))
    first = _kernels.library_path(str(src))
    assert first == _kernels.library_path(str(src))
    assert os.path.basename(first).startswith("k-")
    hdr.write_text("// v2\n")
    second = _kernels.library_path(str(src))
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    third = _kernels.library_path(str(src))
    assert third not in (first, second)
    (tmp_path / "notes.txt").write_text("not a header")
    assert _kernels.library_path(str(src)) == third
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ("-G",))
    assert _kernels.library_path(str(src)) != third


def test_attention_sources_include_the_shared_header():
    with open(os.path.join(_kernels.CSRC, "tc_common.cuh")) as f:
        assert "namespace tc" in f.read()
    for name in ("flash_fwd.cu", "flash_bwd.cu"):
        with open(os.path.join(_kernels.CSRC, name)) as f:
            assert '#include "tc_common.cuh"' in f.read()


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "long": ctypes.c_long}


def _c_signatures(text):
    """{name: [ctypes type of each parameter]} of the ``extern "C"``
    functions in a CUDA source: a pointer is ``c_void_p``, ``int``,
    ``float`` and ``long`` their ctypes namesakes."""
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\s*\(([^)]*)\)',
                                   text):
        out[name] = [ctypes.c_void_p if "*" in p
                     else _C_TYPES[p.replace("const ", "").split()[0]]
                     for p in params.split(",")]
    return out


@pytest.mark.parametrize("source", sorted(_kernels.ENTRY_POINTS))
def test_ctypes_argtypes_match_the_c_signatures(source):
    """Every bound entry point's argtypes list has the parameters of its
    ``extern "C"`` signature, in order and of the matching ctypes type,
    and every extern "C" function of the source is bound: a mismatch
    would pass arguments in the wrong registers, which no compiler here
    can catch."""
    with open(os.path.join(_kernels.CSRC, source)) as f:
        sigs = _c_signatures(f.read())
    bound = _kernels.ENTRY_POINTS[source]
    assert sorted(sigs) == sorted(bound)
    for fn, argtypes in bound.items():
        assert len(argtypes) == len(sigs[fn]), fn
        assert list(argtypes) == sigs[fn], fn
