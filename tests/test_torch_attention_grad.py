"""Gradients of tony_tpu_torch flash attention vs the JAX package's.

``torch.autograd.grad`` of the port's ``flash_attention`` and
``flash_attention_with_lse`` on CPU tensors (the autograd Functions with
their plain backward, ``_dense_backward``) against ``jax.grad`` of the
JAX ``flash_attention`` in Pallas interpret mode (block 32, as
tests/test_ops.py runs it) and of ``reference_attention``, on inputs made
from a seeded numpy generator. f32 throughout, dq/dk/dv to 5e-5 — the JAX
tests' own limit (the blockwise and dense sums round differently) — and
bf16 on two cases, to 2% of the largest entry. The
CUDA kernels are held to the plain backward on the card (``cuda`` marker
here; chip_smoke.py phase 6 at the training shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops.attention import _dense_with_lse as jax_dense_with_lse
from tony_tpu.ops.attention import flash_attention as jax_flash
from tony_tpu.ops.attention import \
    flash_attention_with_lse as jax_flash_with_lse
from tony_tpu.ops.attention import reference_attention as jax_reference
from tony_tpu_torch.ops import attention as A

torch.set_num_threads(2)

# name -> (B, S, H, KV, D, causal, window, block of the Pallas comparison;
# the JAX kernel needs S to divide into blocks, so S = 50 takes one block)
CASES = {
    "causal": (2, 64, 2, 2, 32, True, None, 32),
    "noncausal": (2, 64, 2, 2, 32, False, None, 32),
    "gqa": (1, 64, 8, 2, 32, True, None, 32),
    "window24": (1, 64, 4, 2, 32, True, 24, 32),
    "ragged50": (2, 50, 4, 2, 32, True, None, 64),
}


def _inputs(b, s, h, kv, d, seed):
    r = np.random.RandomState(seed)
    return (r.randn(b, s, h, d).astype(np.float32),
            r.randn(b, s, kv, d).astype(np.float32),
            r.randn(b, s, kv, d).astype(np.float32),
            r.randn(b, s, h, d).astype(np.float32),       # o cotangent
            r.randn(b, h, s).astype(np.float32))          # lse cotangent


def _port_grads(q, k, v, wo, wl, *, causal, window, with_lse):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    if with_lse:
        o, lse = A.flash_attention_with_lse(*ts, causal=causal, window=window)
        loss = (o * torch.from_numpy(wo)).sum() \
            + (lse * torch.from_numpy(wl)).sum()
    else:
        o = A.flash_attention(*ts, causal=causal, window=window)
        loss = (o * torch.from_numpy(wo)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, ts)]


def _jax_grads(fn, q, k, v, wo, wl, with_lse):
    def loss(q, k, v):
        if with_lse:
            o, lse = fn(q, k, v)
            return jnp.sum(o * wo) + jnp.sum(lse * wl)
        return jnp.sum(fn(q, k, v) * wo)
    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))


def _check(got, want, atol=5e-5):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, err_msg=name)


#: interpret mode costs seconds a case: each case once, the lse cotangent
#: on two of them (the reference comparison below runs every pairing)
INTERPRET = [("causal", False), ("noncausal", True), ("gqa", True),
             ("window24", False), ("ragged50", False)]


@pytest.mark.parametrize("case,with_lse", INTERPRET,
                         ids=[f"{c}-{'o_lse' if w else 'o'}"
                              for c, w in INTERPRET])
def test_grads_match_jax_flash_interpret(case, with_lse):
    b, s, h, kv, d, causal, window, block = CASES[case]
    q, k, v, wo, wl = _inputs(b, s, h, kv, d, seed=10)
    got = _port_grads(q, k, v, wo, wl, causal=causal, window=window,
                      with_lse=with_lse)
    jfn = jax_flash_with_lse if with_lse else jax_flash
    want = _jax_grads(lambda *a: jfn(*a, causal=causal, window=window,
                                     block_q=block, block_k=block),
                      q, k, v, wo, wl, with_lse)
    _check(got, want)


@pytest.mark.parametrize("case", ["causal", "gqa"])
def test_bf16_plain_backward_matches_jax_flash_interpret(case):
    """The bf16 plain backward (autograd through the CPU path) against
    ``jax.grad`` of the JAX flash backward in bf16, Pallas interpret mode.
    Both round p and ds to bf16 before the dV, dK and dQ products, and
    each rounds its gradients (JAX also its pre-scaled q) to bf16, so they
    differ by a few bf16 units in the last place of the largest entry
    (under 1% on these inputs): held to 2% of the largest entry, the
    limit of tests/test_ops.py's bf16 gradient tests."""
    b, s, h, kv, d, causal, window, block = CASES[case]
    q, k, v, wo, _ = _inputs(b, s, h, kv, d, seed=15)
    ts = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
          for x in (q, k, v)]
    o = A.flash_attention(*ts, causal=causal, window=window)
    got = torch.autograd.grad((o.float() * torch.from_numpy(wo)).sum(), ts)
    assert all(g.dtype == torch.bfloat16 for g in got)

    def loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, window=window, block_q=block,
                      block_k=block)
        return jnp.sum(o.astype(jnp.float32) * wo)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w,
                                   atol=0.02 * np.abs(w).max(), rtol=0,
                                   err_msg=name)


def test_plain_backward_rounds_p_and_ds_to_the_input_dtype():
    """In bf16 the plain backward's dV is the product of the bf16-rounded
    p with do (as the kernels and the JAX backward form it), not of the
    f32 p; in f32 the rounding is the identity."""
    q, k, v, do, _ = (torch.from_numpy(x) for x in
                      _inputs(1, 40, 2, 2, 32, seed=16))
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd, dod = (x.to(dtype) for x in (q, k, v, do))
        o, lse = A._dense_with_lse(qd, kd, vd, causal=True, scale=None)
        _, _, dv = A._dense_backward(qd, kd, vd, o, lse, dod, causal=True,
                                     scale=None)
        s = torch.einsum("bqhd,bkhd->bhqk", qd.float(), kd.float()) * 32 ** -0.5
        p = torch.exp(s - lse.float()[..., None]).tril()
        want = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(),
                            dod.float()).to(dtype)
        torch.testing.assert_close(dv, want, atol=0, rtol=0)


@pytest.mark.parametrize("with_lse", [False, True], ids=["o", "o_lse"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_jax_reference(case, with_lse):
    b, s, h, kv, d, causal, window, _ = CASES[case]
    q, k, v, wo, wl = _inputs(b, s, h, kv, d, seed=11)
    got = _port_grads(q, k, v, wo, wl, causal=causal, window=window,
                      with_lse=with_lse)
    if with_lse:
        fn = lambda *a: jax_dense_with_lse(*a, causal=causal, scale=None,
                                           window=window)
    else:
        fn = lambda *a: jax_reference(*a, causal=causal, window=window)
    _check(got, _jax_grads(fn, q, k, v, wo, wl, with_lse))


def test_dense_backward_sums_gqa_groups_and_folds_dlse():
    """_dense_backward called directly equals autograd through the plain
    forward: dK/dV summed over each kv head's query group, dlse folded
    into delta."""
    q, k, v, wo, wl = (torch.from_numpy(x) for x in
                       _inputs(2, 40, 8, 2, 32, seed=12))
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = A._dense_with_lse(*ts, causal=True, scale=None, window=16)
    want = torch.autograd.grad((o * wo).sum() + (lse * wl).sum(), ts)
    with torch.no_grad():
        o, lse = A._dense_with_lse(q, k, v, causal=True, scale=None,
                                   window=16)
    got = A._dense_backward(q, k, v, o, lse, wo, wl, causal=True, scale=None,
                            window=16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=5e-5, rtol=0)
    assert got[1].shape == k.shape and got[2].shape == v.shape


def test_backward_route_follows_the_partials_budget():
    """The fused backward (K2) at the training slice's shape under the
    default 1024 MB budget; two-pass (K3a + K3b) when the budget is 0 or
    K2's f32 dQ buffer passes it. Bytes are those K2 allocates for dQ,
    whatever the input dtype."""
    shape = (16, 1024, 8, 64)
    assert A.fused_dq_bytes(shape) == 16 * 1024 * 8 * 64 * 4
    assert A._FUSED_PARTIALS_BYTES == 1024 * 1024 * 1024
    assert A.backward_route(shape) == "fused"
    assert A.backward_route(shape, budget=0) == "two_pass"
    assert A.backward_route((16, 2048, 8, 64)) == "fused"
    assert A.backward_route((16, 65536, 8, 64)) == "two_pass"
    small = (1, 17, 8, 64)
    assert A.backward_route(small, budget=A.fused_dq_bytes(small)) == "fused"
    assert A.backward_route(small, budget=A.fused_dq_bytes(small) - 1) \
        == "two_pass"


def test_cpu_backward_launches_nothing():
    q, k, v, wo, wl = _inputs(1, 33, 4, 2, 64, seed=13)
    counters = (A.flash_forward, A.flash_backward_fused,
                A.flash_backward_dq, A.flash_backward_dkv)
    before = [f.launches for f in counters]
    _port_grads(q, k, v, wo, wl, causal=True, window=None, with_lse=True)
    assert [f.launches for f in counters] == before == [0, 0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "two_pass"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_plain_version(route, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (b, s, h, kv, d, causal, window) in [(2, 17, 4, 4, 64, True, None),
                                             (2, 130, 8, 2, 64, True, 64),
                                             (2, 200, 8, 2, 64, True, 24),
                                             (1, 330, 4, 4, 128, True, 100),
                                             (1, 96, 4, 2, 128, False, None)]:
        q, k, v, do, dlse = (torch.from_numpy(x).cuda() for x in
                             _inputs(b, s, h, kv, d, seed=14))
        q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
        kw = dict(causal=causal, scale=d ** -0.5, window=window)
        o, lse = A.flash_forward(q, k, v, **kw)
        f32 = [x.float() for x in (q, k, v)]
        ro, rlse = A._dense_with_lse(*f32, causal=causal, scale=None,
                                     window=window)
        ref = A._dense_backward(*f32, ro, rlse, do.float(), dlse, **kw)
        if route == "fused":
            got = A.flash_backward_fused(q, k, v, o, lse, do, dlse, **kw)
        else:
            got = (A.flash_backward_dq(q, k, v, o, lse, do, dlse, **kw),
                   *A.flash_backward_dkv(q, k, v, o, lse, do, dlse, **kw))
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            scale = r.abs().max().item()
            lim = 1e-4 * max(1.0, scale) if dtype == torch.float32 \
                else 2e-2 * scale
            assert (g.float() - r).abs().max().item() <= lim
