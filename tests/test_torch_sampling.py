"""tony_tpu_torch sampling vs the JAX package's.

- ``_filter_logits``: the top-k mask equals JAX's exactly, ties at the
  k-th value included; the top-p mask equals JAX's on every row except
  where the mass preceding the cut lies within 1e-6 of ``top_p`` (the
  two sum the sorted probabilities in different orders) — such rows are
  counted and every other row must agree.
- ``_sample``: the logprob is the model's (from the raw logits).
- sampled ``generate`` on ``tiny`` f32 with the JAX parameters converted
  to torch gives JAX's tokens exactly, and logprobs to rtol 1e-5; a
  divergence is reported at its first differing step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import decode as JD
from tony_tpu.models import transformer as JT
from tony_tpu_torch.models import decode as TD
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy
from tony_tpu_torch.ops import prng as R

torch.set_num_threads(2)


def _finite_mask(a):
    return np.isfinite(np.asarray(a))


@pytest.mark.parametrize("top_k", [1, 5, 50, 200])
def test_top_k_mask_equals_jax_with_ties(top_k):
    rs = np.random.RandomState(top_k)
    lg = rs.randn(6, 300).astype(np.float32)
    # ties AT the cutoff: copy each row's k-th largest value elsewhere
    for r in range(6):
        kth = np.sort(lg[r])[::-1][top_k - 1]
        lg[r, rs.randint(0, 300, size=3)] = kth
    want = JD._filter_logits(jnp.asarray(lg), 1.0, top_k, 0.0)
    got = TD._filter_logits(torch.from_numpy(lg), 1.0, top_k, 0.0)
    np.testing.assert_array_equal(_finite_mask(got), _finite_mask(want))
    assert (_finite_mask(got).sum(-1) > top_k).any()   # ties were kept
    np.testing.assert_array_equal(np.asarray(got)[_finite_mask(got)],
                                  np.asarray(want)[_finite_mask(want)])


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.8, 0, 0.95), (1.0, 0, 0.5), (0.7, 50, 0.9), (1.3, 0, 0.999),
    (0.5, 10, 0.3)])
def test_top_p_mask_equals_jax_off_the_boundary(temperature, top_k, top_p):
    rs = np.random.RandomState(int(top_p * 1000))
    lg = (rs.randn(64, 1000) * 3).astype(np.float32)
    lg[:8, :20] = lg[:8, :1]                   # ties at the top
    want = np.asarray(JD._filter_logits(jnp.asarray(lg), temperature,
                                        top_k, top_p))
    got = TD._filter_logits(torch.from_numpy(lg), temperature, top_k,
                            top_p).numpy()
    # rows whose cut sits within 1e-6 of top_p may differ (the two sum
    # the sorted probabilities in different orders): the preceding mass
    # of some position, as either side computes it in f32
    near = _near_boundary(TD._filter_logits(torch.from_numpy(lg),
                                            temperature, top_k, 0.0),
                          top_p)
    differ = (_finite_mask(got) != _finite_mask(want)).any(-1)
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)
    assert near.sum() < len(lg) // 4
    np.testing.assert_array_equal(got[~near], want[~near])


def _near_boundary(scaled, top_p, tol=1e-6):
    """Rows where some position's preceding mass, in f32 by torch's or
    JAX's sort-softmax-cumsum, lies within ``tol`` of ``top_p``."""
    desc = torch.sort(scaled, -1, descending=True).values
    probs = torch.softmax(desc, -1)
    before_t = (torch.cumsum(probs, -1) - probs).numpy()
    jd = -jnp.sort(-jnp.asarray(scaled.numpy()), axis=-1)
    jp = jax.nn.softmax(jd, axis=-1)
    before_j = np.asarray(jnp.cumsum(jp, axis=-1) - jp)
    return ((np.abs(before_t - top_p) < tol)
            | (np.abs(before_j - top_p) < tol)).any(-1)


def test_sample_logprob_is_the_models():
    lg = np.random.RandomState(0).randn(3, 50).astype(np.float32)
    key = R.PRNGKey(5)
    tok, logp = TD._sample(torch.from_numpy(lg), key, 0.7, 5, 0.9)
    jtok, jlogp = JD._sample(jnp.asarray(lg), jax.random.PRNGKey(5), 0.7, 5,
                             0.9)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    want = torch.log_softmax(torch.from_numpy(lg), -1).gather(
        -1, tok[:, None])[:, 0]
    np.testing.assert_allclose(logp.numpy(), want.numpy(), rtol=1e-6)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), rtol=1e-5)


def _first_divergence(got, want):
    diff = np.nonzero((got != want).any(0))[0]
    return None if diff.size == 0 else int(diff[0])


@pytest.fixture(scope="module")
def tiny():
    jcfg = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False)
    tcfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp),
                                             device="cpu")


@pytest.mark.parametrize("seed,temperature,top_k,top_p", [
    (0, 0.8, 50, 0.95), (1, 1.0, 0, 0.0), (7, 0.6, 0, 0.9),
    (3, 1.2, 20, 0.0)])
def test_sampled_generate_token_identical_to_jax(tiny, seed, temperature,
                                                 top_k, top_p):
    jcfg, tcfg, jp, tp = tiny
    prompt = np.random.RandomState(seed).randint(0, 1024, size=(3, 9))
    want = JD.generate(jp, jnp.asarray(prompt, jnp.int32), jcfg,
                       max_new_tokens=16, rng=jax.random.PRNGKey(seed),
                       temperature=temperature, top_k=top_k, top_p=top_p)
    got = TD.generate(tp, torch.from_numpy(prompt), tcfg, 16,
                      R.PRNGKey(seed), temperature=temperature,
                      top_k=top_k, top_p=top_p)
    step = _first_divergence(got.tokens.numpy()[:, 9:],
                             np.asarray(want.tokens)[:, 9:])
    assert step is None, f"first diverging step {step}"
    np.testing.assert_allclose(got.logprobs.numpy(),
                               np.asarray(want.logprobs), rtol=1e-5,
                               atol=1e-6)


def test_sampled_generate_needs_a_key(tiny):
    _, tcfg, _, tp = tiny
    with pytest.raises(ValueError, match="rng"):
        TD.generate(tp, torch.zeros(1, 3, dtype=torch.long), tcfg, 2,
                    temperature=0.7)
