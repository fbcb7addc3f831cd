"""tony_tpu_torch int8 serving weights vs the JAX package's.

The port's ``quantize_weights_int8`` of a converted float tree is
bitwise the JAX package's quantized tree (``q`` and ``scale``, f32 and
bf16 trees), and ``models/weights.py`` carries a quantized tree across
both ways. On ``tiny`` in f32 with the JAX weights converted: the
quantized prefill and decode logits agree with JAX's to atol/rtol 1e-4,
quantized ``generate`` is token-identical to JAX's (with the float
cache, the int8 cache and a window), and the quant-to-quant contracts of
``tests/test_quantize.py`` hold in the port (serving == generate, beam
W=1 == speculative == greedy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import decode as JD
from tony_tpu.models import quantize as JQ
from tony_tpu.models import transformer as JT
from tony_tpu_torch.models import decode as TD
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.quantize import (QuantizedWeight, _quantize,
                                            quantize_weights_int8,
                                            weight_bytes)
from tony_tpu_torch.models.serve import ContinuousBatcher
from tony_tpu_torch.models.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)
JCFG = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False)
TCFG = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)
_MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def trees():
    """(JAX float, JAX quantized, port quantized of the converted float
    tree)."""
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    return jp, JQ.quantize_weights_int8(jp), quantize_weights_int8(tp)


def _toks(shape, seed):
    return np.random.RandomState(seed).randint(0, 1024, size=shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bitwise_equals_jax(dtype):
    cfg = JT.PRESETS["tiny"].scaled(dtype=jnp.dtype(dtype), remat=False)
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    want = jax.device_get(JQ.quantize_weights_int8(jp))
    got = quantize_weights_int8(params_from_numpy(jax.device_get(jp),
                                                  device="cpu"))
    pairs = [(want["blocks"][n], got["blocks"][n]) for n in _MATMULS]
    pairs.append((want["lm_head"], got["lm_head"]))
    for w, g in pairs:
        assert g.q.dtype == torch.int8 and g.scale.dtype == torch.float32
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))


def test_structure(trees):
    """Matmul weights become QuantizedWeight; embed and norms stay."""
    jp, _, qp = trees
    for name in _MATMULS:
        w = qp["blocks"][name]
        assert isinstance(w, QuantizedWeight), name
        assert w.q.dtype == torch.int8
        assert tuple(w.q.shape) == tuple(jp["blocks"][name].shape)
    assert isinstance(qp["lm_head"], QuantizedWeight)
    for name in ("attn_norm", "mlp_norm"):
        assert not isinstance(qp["blocks"][name], QuantizedWeight)
    assert not isinstance(qp["embed"], QuantizedWeight)
    assert not isinstance(qp["final_norm"], QuantizedWeight)
    # the int8 tree holds about a quarter of the f32 tree's weight bytes
    # (the embedding stays f32)
    fp = params_from_numpy(jax.device_get(jp), device="cpu")
    assert weight_bytes(qp) < 0.45 * weight_bytes(fp)


def test_weights_carry_a_quantized_tree_both_ways(trees):
    _, jq, qp = trees
    got = params_from_numpy(jax.device_get(jq), device="cpu")
    w = got["blocks"]["wq"]
    assert isinstance(w, QuantizedWeight) and w.q.dtype == torch.int8
    np.testing.assert_array_equal(w.q.numpy(), qp["blocks"]["wq"].q.numpy())
    back = params_to_numpy(qp)
    jq_host = jax.device_get(jq)
    for name in _MATMULS:
        b, j = back["blocks"][name], jq_host["blocks"][name]
        np.testing.assert_array_equal(b.q, np.asarray(j.q))
        np.testing.assert_array_equal(b.scale, np.asarray(j.scale))
    # the numpy pair rebuilds the JAX package's weight
    rebuilt = JQ.QuantizedWeight(*back["lm_head"])
    np.testing.assert_array_equal(np.asarray(rebuilt.q),
                                  np.asarray(jq_host["lm_head"].q))


def test_per_channel_roundtrip_bound():
    w = torch.randn(16, 4, 8, generator=torch.Generator().manual_seed(2))
    qw = _quantize(w, (0,))
    assert tuple(qw.scale.shape) == (4, 8)
    deq = qw.q.float() * qw.scale
    # symmetric absmax: error <= per-channel absmax / 254
    bound = w.abs().amax(dim=0) / 254.0
    assert bool(((deq - w).abs() <= bound + 1e-7).all())


def test_weinsum_fold_matches_dequantized():
    """The scale-outside-the-product fold == the einsum over the
    explicitly dequantized weight, and the JAX package's ``_weinsum``."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn(16, 4, 8, generator=g)
    x = torch.randn(2, 3, 16, generator=g)
    qw = _quantize(w, (0,))
    got = TD._weinsum("bsd,dhk->bshk", x, qw)
    want = torch.einsum("bsd,dhk->bshk", x, qw.q.float() * qw.scale)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    jw = JQ.QuantizedWeight(jnp.asarray(qw.q.numpy()),
                            jnp.asarray(qw.scale.numpy()))
    jgot = JD._weinsum("bsd,dhk->bshk", jnp.asarray(x.numpy()), jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-5)
    # plain weights pass straight through
    torch.testing.assert_close(TD._weinsum("bsd,dhk->bshk", x, w),
                               torch.einsum("bsd,dhk->bshk", x, w))


def test_quantized_prefill_and_decode_match_jax(trees):
    _, jq, qp = trees
    toks = _toks((2, 12), 5)
    jl, jc = JD.prefill(jq, jnp.asarray(toks, jnp.int32), JCFG, 32)
    tl, tc = TD.prefill(qp, torch.from_numpy(toks), TCFG, 32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for _ in range(3):
        nxt = np.argmax(np.asarray(jl), axis=-1)
        jl, jc = JD.decode_step(jq, jnp.asarray(nxt, jnp.int32), jc,
                                jc["length"], JCFG)
        tl, tc = TD.decode_step(qp, torch.from_numpy(nxt), tc,
                                tc["length"], TCFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("kw", [{}, {"kv_cache_dtype": "int8"},
                                {"kv_cache_dtype": "int8",
                                 "attn_window": 24}],
                         ids=["float-cache", "int8-cache", "int8-window"])
def test_quantized_generate_token_identical_to_jax(trees, kw):
    _, jq, qp = trees
    prompt = _toks((2, 30), 7)
    want = JD.generate(jq, jnp.asarray(prompt, jnp.int32),
                       JCFG.scaled(**kw), 12, jax.random.PRNGKey(0))
    got = TD.generate(qp, torch.from_numpy(prompt), TCFG.scaled(**kw), 12)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))


def test_serving_token_identical_to_generate(trees):
    """Quant-to-quant: the batcher with quantized weights equals
    per-request generate with the same weights."""
    _, _, qp = trees
    rs = np.random.RandomState(3)
    prompts = [list(rs.randint(0, 1024, size=n)) for n in (5, 7, 4)]
    outs = ContinuousBatcher(qp, TCFG, batch=2, max_len=32,
                             chunk=4).serve(prompts, max_new_tokens=6)
    for i, p in enumerate(prompts):
        want = TD.generate(qp, torch.tensor([p]), TCFG, 6)
        assert outs[i] == want.tokens[0, len(p):].tolist(), i


def test_beam_and_speculative_equal_greedy(trees):
    _, _, qp = trees
    prompt = torch.from_numpy(_toks((2, 6), 6))
    g = TD.generate(qp, prompt, TCFG, 10)
    bs = TD.beam_search(qp, prompt, TCFG, 10, beam_width=1)
    np.testing.assert_array_equal(bs.tokens[:, 0].numpy(), g.tokens.numpy())
    sp = TD.speculative_generate_device(qp, qp, prompt, TCFG, TCFG,
                                        max_new_tokens=10,
                                        num_speculative=3)
    np.testing.assert_array_equal(sp.numpy(), g.tokens.numpy())


def test_composes_with_int8_cache_and_window(trees):
    _, _, qp = trees
    cfg = TCFG.scaled(kv_cache_dtype="int8", attn_window=24)
    out = TD.generate(qp, torch.from_numpy(_toks((2, 30), 8)), cfg, 12)
    tk = out.tokens.numpy()
    assert tk.shape == (2, 42)
    assert (tk >= 0).all() and (tk < 1024).all()


def test_bf16_prefill_route_casts_the_weight_to_bf16():
    """bf16 activations past 256 positions take the bf16 product; a
    decode-shaped call keeps the f32 one (both fold the scale in f32)."""
    g = torch.Generator().manual_seed(9)
    w = _quantize(torch.randn(16, 8, generator=g), (0,))
    long_x = torch.randn(1, 257, 16, generator=g).bfloat16()
    short_x = long_x[:, :256]
    want = torch.einsum("bsd,df->bsf", long_x, w.q.bfloat16()).float() \
        * w.scale
    torch.testing.assert_close(TD._weinsum("bsd,df->bsf", long_x, w),
                               want.bfloat16())
    want = torch.einsum("bsd,df->bsf", short_x.float(), w.q.float()) \
        * w.scale
    torch.testing.assert_close(TD._weinsum("bsd,df->bsf", short_x, w,
                                           f32_out=True), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_tree_quantizes_like_jax(dtype):
    """An MoE tree: the attention products and the lm_head quantize
    bitwise as JAX's; the experts, the router (f32) and the norms pass
    through unchanged, as in the JAX package; quantized MoE ``generate``
    is JAX's token for token (f32)."""
    cfg = JT.PRESETS["tiny"].scaled(dtype=jnp.dtype(dtype), remat=False,
                                    num_experts=4)
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    want = jax.device_get(JQ.quantize_weights_int8(jp))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    got = quantize_weights_int8(tp)
    for n in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(got["blocks"][n].q.numpy(),
                                      np.asarray(want["blocks"][n].q))
        np.testing.assert_array_equal(got["blocks"][n].scale.numpy(),
                                      np.asarray(want["blocks"][n].scale))
    for n in ("router", "w_gate", "w_down", "attn_norm", "mlp_norm"):
        assert got["blocks"][n] is tp["blocks"][n], n
        assert not isinstance(want["blocks"][n], tuple), n
    assert got["blocks"]["router"].dtype == torch.float32
    if dtype == "float32":
        prompt = _toks((2, 9), 8)
        tcfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False,
                                         num_experts=4)
        jt = JD.generate(want, jnp.asarray(prompt, jnp.int32), cfg, 8,
                         jax.random.PRNGKey(0))
        tt = TD.generate(got, torch.from_numpy(prompt), tcfg, 8)
        np.testing.assert_array_equal(tt.tokens.numpy(),
                                      np.asarray(jt.tokens))
