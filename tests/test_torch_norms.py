"""tony_tpu_torch norms vs the JAX package's.

The same seeded inputs through the port's ``rms_norm`` / ``layer_norm``
(their plain versions, which a CPU tensor takes) and the JAX package's
``rms_norm`` / ``layer_norm`` (the Pallas kernels in interpret mode, as
``tests/test_ops.py`` runs them, with their custom VJPs):

- f32 forward to atol 1e-6;
- gradients of x, w (and b) against ``jax.grad`` through the custom
  VJP: atol 1e-5 for dx, 1e-4 for dw and db — both for the CPU path
  (autograd of the plain version) and for the backward the card runs
  (the plain copies of ``_rms_bwd`` / ``_ln_bwd`` behind the
  ``autograd.Function``, driven here with the kernel launch replaced by
  the plain forward);
- bf16: output dtypes, values within one bf16 rounding of JAX's, and the
  gradients' dtypes (the port's db takes b's dtype where ``_ln_bwd``
  returns f32).

The ``cuda``-marked tests hold K5 and K6 against the plain versions on
the card and skip without one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops import norms as JN
from tony_tpu_torch.ops import norms as N

torch.set_num_threads(2)

# (lead shape, d): d 64 and 128 are model widths, 100 is a multiple of
# neither 8 nor 32, and a lone row of a ragged row count
SHAPES = [((4, 16), 64), ((3, 5), 128), ((7,), 100), ((1,), 64)]


def _data(lead, d, seed=0, offset=0.0):
    r = np.random.RandomState(seed)
    x = (r.randn(*lead, d) + offset).astype(np.float32)
    w = (1.0 + 0.1 * r.randn(d)).astype(np.float32)
    b = (0.1 * r.randn(d)).astype(np.float32)
    g = r.randn(*lead, d).astype(np.float32)
    return x, w, b, g


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax_grads(kind, x, w, b, g):
    """Gradients of sum(f(...) * g) through the JAX custom VJP."""
    if kind == "rms":
        return jax.grad(lambda x, w: (JN.rms_norm(x, w) * g).sum(),
                        argnums=(0, 1))(x, w)
    return jax.grad(lambda x, w, b: (JN.layer_norm(x, w, b) * g).sum(),
                    argnums=(0, 1, 2))(x, w, b)


@functools.lru_cache(maxsize=None)
def _grad_case(kind, lead, d):
    """Inputs and JAX gradients of one case, shared by the CPU-path and
    card-path gradient tests."""
    data = _data(lead, d, seed=1, offset=0.5)
    return data, _jax_grads(kind, *(jnp.asarray(a) for a in data))


def _port(kind, x, w, b):
    return N.rms_norm(x, w) if kind == "rms" else N.layer_norm(x, w, b)


def _jax(kind, x, w, b):
    return JN.rms_norm(x, w) if kind == "rms" else JN.layer_norm(x, w, b)


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("lead,d", SHAPES)
def test_forward_matches_jax_f32(kind, lead, d):
    x, w, b, _ = _data(lead, d, offset=0.5)
    want = np.asarray(_jax(kind, *(jnp.asarray(a) for a in (x, w, b))))
    got = _port(kind, *_t(x, w, b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def _check_grads(kind, got, want):
    names = ("dx", "dw", "db")
    for name, a, e in zip(names, got, want):
        np.testing.assert_allclose(a, np.asarray(e),
                                   atol=1e-5 if name == "dx" else 1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("lead,d", SHAPES[:3])
def test_cpu_gradients_match_jax_custom_vjp(kind, lead, d):
    (x, w, b, g), want = _grad_case(kind, lead, d)
    tx, tw, tb = (t.requires_grad_() for t in _t(x, w, b))
    inputs = (tx, tw) if kind == "rms" else (tx, tw, tb)
    got = torch.autograd.grad((_port(kind, tx, tw, tb)
                               * torch.from_numpy(g)).sum(), inputs)
    _check_grads(kind, [t.numpy() for t in got], want)


@pytest.fixture
def plain_kernels(monkeypatch):
    """Replace the two kernel launches by the plain forwards, so the
    autograd Functions the card runs can be driven on CPU tensors."""
    monkeypatch.setattr(N, "rms_norm_forward",
                        lambda x, w, eps: N.rms_norm_reference(x, w, eps))
    monkeypatch.setattr(N, "layer_norm_forward",
                        lambda x, w, b, eps:
                        N.layer_norm_reference(x, w, b, eps))


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("lead,d", SHAPES[:3])
def test_card_backward_matches_jax_custom_vjp(kind, lead, d, plain_kernels):
    (x, w, b, g), want = _grad_case(kind, lead, d)
    tx, tw, tb = (t.requires_grad_() for t in _t(x, w, b))
    if kind == "rms":
        out, inputs = N._RMSNorm.apply(tx, tw, 1e-6), (tx, tw)
    else:
        out, inputs = N._LayerNorm.apply(tx, tw, tb, 1e-6), (tx, tw, tb)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), inputs)
    _check_grads(kind, [t.numpy() for t in got], want)


def _bf16_ulp(a):
    """One bf16 unit in the last place of each element of f32 ``a``."""
    _, e = np.frexp(np.maximum(np.abs(a), 2.0 ** -120))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_bf16_outputs_and_gradient_dtypes(kind, plain_kernels):
    x, w, b, g = _data((4, 8), 64, seed=3)
    jx, jw, jb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, b))
    want = np.asarray(_jax(kind, jx, jw, jb).astype(jnp.float32))
    tx, tw, tb = _t(x, w, b, dtype=torch.bfloat16)
    got = _port(kind, tx, tw, tb)
    assert got.dtype == torch.bfloat16
    # both compute in f32 and round once; the sums' order may move a
    # value across a rounding edge by one bf16 unit, and where the output
    # is near 0 the f32 difference itself may exceed that unit
    assert np.all(np.abs(got.float().numpy() - want)
                  <= _bf16_ulp(want) + 1e-5)
    # the card's Function: gradients in the inputs' dtypes, db in b's
    tx, tw, tb = (t.requires_grad_() for t in (tx, tw, tb))
    if kind == "rms":
        out, inputs = N._RMSNorm.apply(tx, tw, 1e-6), (tx, tw)
    else:
        out, inputs = N._LayerNorm.apply(tx, tw, tb, 1e-6), (tx, tw, tb)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(
        (out.float() * torch.from_numpy(g)).sum(), inputs)
    assert [t.dtype for t in grads] == [torch.bfloat16] * len(inputs)
    if kind == "ln":
        jg = jnp.asarray(g).astype(jnp.bfloat16)
        assert JN._ln_bwd(1e-6, (jx, jw), jg)[2].dtype == jnp.float32


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, w, b, _ = _data((2,), 64)
    tx, tw, tb = _t(x, w, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        N.rms_norm_forward(tx, tw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        N.layer_norm_forward(tx, tw, tb)
    assert N.rms_norm_forward.launches == 0
    assert N.layer_norm_forward.launches == 0


def test_cpu_path_is_the_plain_version_bit_for_bit():
    x, w, b, _ = _data((3, 9), 128, seed=4)
    tx, tw, tb = _t(x, w, b)
    assert torch.equal(N.rms_norm(tx, tw), N.rms_norm_reference(tx, tw))
    assert torch.equal(N.layer_norm(tx, tw, tb),
                       N.layer_norm_reference(tx, tw, tb))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 64), (17, 128), (8192, 768),
                                    (33, 770)])
def test_cuda_kernel_matches_plain_version(kind, dtype, rows, d):
    _card()
    g = torch.Generator(device="cuda").manual_seed(rows + d)
    x = (torch.randn(rows, d, device="cuda", generator=g) + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=g)).to(dtype)
    b = (0.1 * torch.randn(d, device="cuda", generator=g)).to(dtype)
    if kind == "rms":
        got, want = N.rms_norm_forward(x, w), N.rms_norm_reference(x, w)
    else:
        got = N.layer_norm_forward(x, w, b)
        want = N.layer_norm_reference(x, w, b)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        # one rounding each, after f32 values within the f32 limit: a
        # LayerNorm output near 0 may differ by more than its own ulp
        wf = want.float().cpu().numpy()
        assert np.all(np.abs(got.float().cpu().numpy() - wf)
                      <= _bf16_ulp(wf) + 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_cuda_gradients_match_autograd_of_plain_version(kind):
    _card()
    g = torch.Generator(device="cuda").manual_seed(5)
    x, ct = (torch.randn(64, 768, device="cuda", generator=g)
             for _ in range(2))
    w = 1 + 0.1 * torch.randn(768, device="cuda", generator=g)
    b = 0.1 * torch.randn(768, device="cuda", generator=g)
    grads = {}
    for name, fn in (("kernel", N.rms_norm if kind == "rms"
                      else N.layer_norm),
                     ("plain", N.rms_norm_reference if kind == "rms"
                      else N.layer_norm_reference)):
        ins = [t.clone().requires_grad_() for t in
               ((x, w) if kind == "rms" else (x, w, b))]
        grads[name] = torch.autograd.grad((fn(*ins) * ct).sum(), ins)
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert (got - want).abs().max().item() <= \
            1e-4 * want.abs().max().item()
