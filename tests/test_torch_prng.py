"""tony_tpu_torch's threefry stream vs ``jax.random``, bit for bit.

The port's ``ops/prng.py`` reproduces JAX's default PRNG
(``threefry2x32``, partitionable counters) on the CPU: keys, ``fold_in``,
``split``, 32-bit words and f32 uniforms are bitwise equal; Gumbel noise
(through the port's copy of XLA's CPU logarithm) and categorical draws
are bitwise equal too (tolerance 0 everywhere). Several seeds, shapes
``[V]`` and ``[B, V]``, one key and a key per row (``jax.vmap``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu_torch.models import serve as TS
from tony_tpu_torch.ops import prng as R

torch.set_num_threads(2)

SEEDS = [0, 1, 42, 2**31 - 1, 2**33 + 5, -3]
SHAPES = [(7,), (1000,), (4, 77), (2, 3, 5), (3, 32000)]


def _u64(a):
    return np.asarray(a).astype(np.int64)


def _f32_bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_jax_runs_partitionable_threefry():
    """The port mirrors this layout; an upgrade that changes it must fail
    here first."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_bitwise(seed):
    jk = jax.random.PRNGKey(seed)
    tk = R.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _u64(jk))
    for data in (0, 7, 2**31 - 1, 0x7FFFFFFF):
        np.testing.assert_array_equal(R.fold_in(tk, data).numpy(),
                                      _u64(jax.random.fold_in(jk, data)))
    for num in (1, 2, 5, 33):
        np.testing.assert_array_equal(R.split(tk, num).numpy(),
                                      _u64(jax.random.split(jk, num)))
    keys = jax.random.split(jk, 4)
    data = jnp.arange(4, dtype=jnp.int32) * 3 + 10
    np.testing.assert_array_equal(
        R.fold_in(torch.from_numpy(_u64(keys)),
                  torch.from_numpy(np.array(data))).numpy(),
        _u64(jax.vmap(jax.random.fold_in)(keys, data)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_uniform_and_gumbel_bitwise(seed, shape):
    jk = jax.random.PRNGKey(seed)
    tk = R.PRNGKey(seed)
    np.testing.assert_array_equal(R.random_bits(tk, shape).numpy(),
                                  _u64(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(
        _f32_bits(R.uniform(tk, shape).numpy()),
        _f32_bits(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(
        _f32_bits(R.uniform(tk, shape, minval=-2.0, maxval=3.0).numpy()),
        _f32_bits(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0)))
    np.testing.assert_array_equal(
        _f32_bits(R.gumbel(tk, shape).numpy()),
        _f32_bits(jax.random.gumbel(jk, shape)))


def test_xla_log_bitwise_over_the_f32_range():
    rs = np.random.RandomState(0)
    x = np.concatenate([
        np.exp(rs.uniform(-87, 88, size=100_000)),
        rs.uniform(0.5, 2.0, size=100_000),
        np.float32(1.1754944e-38) * rs.uniform(1, 4, size=1000),
    ]).astype(np.float32)
    np.testing.assert_array_equal(
        _f32_bits(R.xla_log(torch.from_numpy(x)).numpy()),
        _f32_bits(jnp.log(jnp.asarray(x))))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_categorical_bitwise_one_key_and_per_row(seed):
    jk = jax.random.PRNGKey(seed)
    tk = R.PRNGKey(seed)
    lg = np.random.RandomState(seed % 97).randn(4, 32000).astype(np.float32)
    np.testing.assert_array_equal(
        R.categorical(tk, torch.from_numpy(lg)).numpy(),
        np.asarray(jax.random.categorical(jk, jnp.asarray(lg))))
    np.testing.assert_array_equal(
        R.categorical(tk, torch.from_numpy(lg[0])).numpy(),
        np.asarray(jax.random.categorical(jk, jnp.asarray(lg[0]))))
    # a key per row, as the serving batcher draws (_row_samples at
    # temperature 1 with no filter is the vmapped categorical)
    keys = jax.random.split(jk, 4)

    def per_row(lg):
        t = torch.from_numpy(lg)
        noise = R.gumbel(torch.from_numpy(_u64(keys)), (t.shape[-1],))
        return TS._row_samples(t, noise, 1.0, 0, 0.0).numpy()

    np.testing.assert_array_equal(
        per_row(lg),
        np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                    jnp.asarray(lg))))
    # masked logits (a filter's -inf) never win
    lg[:, 100:] = -np.inf
    got = per_row(lg)
    assert (got < 100).all()
    np.testing.assert_array_equal(
        got, np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                         jnp.asarray(lg))))


def test_keys_are_rejected_without_a_trailing_pair():
    with pytest.raises(ValueError):
        R.fold_in(torch.zeros(3, dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="one key"):
        R.categorical(torch.zeros(2, 2, dtype=torch.int64),
                      torch.zeros(2, 5))


@pytest.mark.cuda
def test_stream_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys = R.split(R.PRNGKey(3), 8)
    cpu = R.gumbel(keys, (32000,))
    gpu = R.gumbel(keys.cuda(), (32000,)).cpu()
    assert torch.equal(R.random_bits(keys, (32000,)),
                       R.random_bits(keys.cuda(), (32000,)).cpu())
    assert torch.equal(cpu.view(torch.int32), gpu.view(torch.int32))
