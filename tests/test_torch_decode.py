"""tony_tpu_torch KV-cache decoding vs the JAX package's.

JAX ``tiny`` in f32 with its parameters converted to torch: prefill,
bucketed ``prefill_rows`` and ``decode_step`` logits agree to atol 1e-4
/ rtol 1e-4, the blockwise cache walk (max_len >= 512) included, and
greedy ``generate`` is token-identical.
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

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)


def _setup(**kw):
    jcfg = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False, **kw)
    tcfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False, **kw)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp),
                                             device="cpu")


@pytest.fixture(scope="module")
def mha():
    return _setup()


def _toks(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 1024, size=shape)


@pytest.mark.parametrize("max_len", [32, 520])
def test_prefill_then_decode_steps_match_jax(mha, max_len):
    """Scalar frontier; max_len 520 takes the blockwise walk."""
    jcfg, tcfg, jp, tp = mha
    toks = _toks((2, 9))
    jl, jc = JD.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, max_len)
    tl, tc = TD.prefill(tp, torch.from_numpy(toks), tcfg, max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["length"] == 9 and tc["k"].shape == jc["k"].shape
    for step in range(3):
        nxt = np.argmax(np.asarray(jl), axis=-1)
        jl, jc = JD.decode_step(jp, jnp.asarray(nxt, jnp.int32), jc,
                                jc["length"], jcfg)
        tl, tc = TD.decode_step(tp, torch.from_numpy(nxt), tc,
                                tc["length"], tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-5)


@pytest.mark.parametrize("max_len", [48, 512])
def test_prefill_rows_and_per_row_decode_match_jax(mha, max_len):
    """Bucketed prefill with per-row true lengths, landed into slots,
    then per-row-frontier decode steps (the serving path)."""
    jcfg, tcfg, jp, tp = mha
    lens = np.array([5, 16, 9], np.int32)
    toks = _toks((3, 16), seed=1)
    jl, jmini = JD.prefill_rows(jp, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(lens), jcfg)
    tl, tmini = TD.prefill_rows(tp, torch.from_numpy(toks),
                                torch.from_numpy(lens), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    rows = np.array([2, 0, 5], np.int32)        # 5: an out-of-range sentinel
    jc = JD.init_kv_cache(jcfg, 4, max_len)
    jc = JD.place_rows(dict(jc, length=jnp.zeros((4,), jnp.int32)), jmini,
                       jnp.asarray(rows), jnp.asarray(lens))
    tc = TD.init_kv_cache(tcfg, 4, max_len, device="cpu")
    tc["length"] = torch.zeros(4, dtype=torch.int32)
    TD.place_rows(tc, tmini, rows, torch.from_numpy(lens))
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray(jc["length"]))
    host_len = [int(x) for x in tc["length"]]
    for step in range(3):
        tok = _toks((4,), seed=10 + step)
        jl, jc = JD.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                                jc["length"], jcfg)
        tl, tc = TD.decode_step(
            tp, torch.from_numpy(tok), tc, tc["length"], tcfg,
            pos_range=(min(host_len), max(host_len)))
        host_len = [n + 1 for n in host_len]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_blockwise_window_decode_matches_jax():
    """Sliding window over a blockwise cache: the walk starts at the
    window's first block."""
    jcfg, tcfg, jp, tp = _setup(attn_window=200, n_kv_heads=2)
    toks = _toks((1, 300), seed=2)
    jl, jc = JD.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, 600)
    tl, tc = TD.prefill(tp, torch.from_numpy(toks), tcfg, 600)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt = np.argmax(np.asarray(jl), axis=-1)
    jl, _ = JD.decode_step(jp, jnp.asarray(nxt, jnp.int32), jc, 300, jcfg)
    tl, _ = TD.decode_step(tp, torch.from_numpy(nxt), tc, 300, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("kw", [{}, {"n_kv_heads": 2}],
                         ids=["mha", "gqa"])
def test_greedy_generate_token_identical(kw):
    jcfg, tcfg, jp, tp = _setup(**kw)
    prompt = _toks((2, 7), seed=3)
    want = JD.generate(jp, jnp.asarray(prompt, jnp.int32), jcfg,
                       max_new_tokens=10, rng=jax.random.PRNGKey(0))
    got = TD.generate(tp, torch.from_numpy(prompt), tcfg, 10)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(),
                               np.asarray(want.logprobs), atol=1e-4)


def test_out_of_range_per_row_writes_drop():
    """A finished row decoding past the cache end writes nothing (JAX's
    scatter drops it) while the other rows write normally."""
    buf = torch.zeros(1, 2, 4, 1, 1)
    chunk = torch.ones(2, 1, 1, 1)
    TD._write_kv_chunk(buf, chunk, 0, torch.tensor([1, 4]), fits=False)
    assert buf[0, 0, :, 0, 0].tolist() == [0, 1, 0, 0]
    assert buf[0, 1].abs().sum() == 0


def test_unported_cache_kinds_raise():
    for kw in ({"kv_cache_dtype": "int8"},
               {"attn_window": 4, "kv_cache_capacity": 8}):
        cfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, **kw)
        with pytest.raises(NotImplementedError):
            TD.init_kv_cache(cfg, 1, 8, device="cpu")
    cfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    from tony_tpu_torch.models import serve as TS
    with pytest.raises(NotImplementedError):
        TS.ContinuousBatcher(params, cfg, batch=1, max_len=8,
                             shared_prefix=[1, 2])
