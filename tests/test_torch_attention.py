"""tony_tpu_torch flash attention vs the JAX package's.

The port's plain version (what a CPU tensor runs) against JAX
``flash_attention_with_lse`` in Pallas interpret mode (block 32, as
tests/test_ops.py runs it) and against JAX ``reference_attention``, on
inputs made from a seeded numpy generator. f32 throughout: o to 2e-5
and lse to 1e-5 (summation order differs between the dense and the
blockwise online softmax). The CUDA kernel itself is held to its plain
version on the card (``cuda`` marker; chip_smoke.py runs the same check
at the serving shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops.attention import (flash_attention_with_lse as jax_flash,
                                    reference_attention as jax_reference)
from tony_tpu_torch.ops import attention as A

torch.set_num_threads(2)

# name -> (B, S, H, KV, D, causal, window)
CASES = {
    "causal": (2, 64, 2, 2, 32, True, None),
    "noncausal": (2, 64, 2, 2, 32, False, None),
    "gqa": (2, 64, 8, 2, 32, True, None),
    "gqa_noncausal": (1, 64, 8, 2, 32, False, None),
    "window": (2, 64, 2, 2, 32, True, 24),
    "gqa_window": (1, 64, 8, 2, 32, True, 16),
    "ragged17": (2, 17, 2, 2, 32, True, None),
}


def _inputs(b, s, h, kv, d, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(b, s, h, d).astype(np.float32),
            r.randn(b, s, kv, d).astype(np.float32),
            r.randn(b, s, kv, d).astype(np.float32))


def _port(q, k, v, **kw):
    o, lse = A.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), **kw)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_flash_interpret(case):
    b, s, h, kv, d, causal, window = CASES[case]
    q, k, v = _inputs(b, s, h, kv, d)
    o, lse = _port(q, k, v, causal=causal, window=window)
    jo, jlse = jax_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                         window=window, block_q=32, block_k=32)
    np.testing.assert_allclose(o, np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(lse, np.asarray(jlse), atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES) + ["ragged40"])
def test_matches_jax_reference(case):
    b, s, h, kv, d, causal, window = CASES.get(
        case, (2, 40, 4, 2, 32, True, 16))
    q, k, v = _inputs(b, s, h, kv, d, seed=1)
    o = A.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal, window=window).numpy()
    want = jax_reference(*(jnp.asarray(x) for x in (q, k, v)),
                         causal=causal, window=window)
    np.testing.assert_allclose(o, np.asarray(want), atol=2e-5)


def test_explicit_scale_matches_jax():
    q, k, v = _inputs(1, 32, 2, 2, 32, seed=2)
    o, lse = _port(q, k, v, causal=True, scale=0.3)
    jo, jlse = jax_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                         scale=0.3, block_q=32, block_k=32)
    np.testing.assert_allclose(o, np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(lse, np.asarray(jlse), atol=1e-5)


def test_cpu_call_takes_the_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 33, 4, 2, 64))
    before = A.flash_forward.launches
    o, lse = A.flash_attention_with_lse(q, k, v, causal=True)
    ref_o, ref_lse = A._dense_with_lse(q, k, v, causal=True, scale=None)
    assert A.flash_forward.launches == before == 0
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    assert o.shape == q.shape and lse.shape == (1, 4, 33)
    assert lse.dtype == torch.float32


def test_requires_grad_raises():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 2, 32))
    with pytest.raises(NotImplementedError):
        A.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():                    # no gradient asked for: fine
        A.flash_attention(q, k, v)


def test_window_validation_matches_jax():
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError):
        A.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError):
        A.flash_attention(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError):
        A.flash_attention(q, q[:, :, :1].expand(1, 8, 3, 32).contiguous(),
                          q[:, :, :1].expand(1, 8, 3, 32).contiguous())
    assert A._resolve_window(64, True, 64) is None     # >= seq: full causal


def test_bf16_plain_version_tracks_f32():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 48, 4, 2, 64, seed=3))
    o32, lse32 = A.flash_attention_with_lse(q, k, v, causal=True)
    o16, lse16 = A.flash_attention_with_lse(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    assert (o16.float() - o32).abs().max() < 3e-2
    assert (lse16 - lse32).abs().max() < 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_kernel_matches_plain_version(dtype, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (b, s, h, kv, causal, window) in [(2, 17, 4, 4, True, None),
                                          (2, 130, 8, 2, True, 64),
                                          (1, 96, 4, 2, False, None)]:
        q, k, v = (torch.from_numpy(x).cuda().to(dtype)
                   for x in _inputs(b, s, h, kv, d, seed=4))
        o, lse = A.flash_attention_with_lse(q, k, v, causal=causal,
                                            window=window)
        ro, rlse = A._dense_with_lse(q.float(), k.float(), v.float(),
                                     causal=causal, scale=None,
                                     window=window)
        torch.cuda.synchronize()
        o_tol, lse_tol = (1e-4, 1e-5) if dtype == torch.float32 \
            else (2e-2, 1e-3)
        assert (o.float() - ro).abs().max().item() <= o_tol
        assert (lse - rlse).abs().max().item() <= lse_tol
