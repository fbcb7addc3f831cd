"""tony_tpu_torch's decode variants vs the JAX package's: int8 KV caches,
sliding windows over linear and rolling (ring) caches, speculative
decoding and beam search.

JAX ``tiny`` in f32 with its weights converted to torch. Tolerances:
logits atol/rtol 1e-4 (the existing decode parity's); tokens exact.
An int8 cache's contents after prefill and decode steps: scales within
rtol 1e-5, int8 values equal but for rare rounding-boundary flips of one
step (the float K/V that feed them differ from JAX's by f32 rounding),
at most 1 in 1000. One such flip moves a logit by up to ~3e-4 (measured
at ``tiny``: layer 1, position 33, with a window of 24), so the logits
of an int8 cache are held to atol/rtol 1e-3, and an int8 stream to JAX's
token for token up to a first difference, which must fall at a near-tie
of JAX's logits: within 1e-2, the bound ``tests/test_decode.py`` holds
int8 attention to against the dequantized cache. The window-24 int8
streams of ``test_int8_window_generate_matches_jax`` do differ: row 1
at its 16th generated token (JAX 475, port 733, JAX's logit gap
4.8e-3), on the ring and the linear cache alike.

Speculative and beam outputs are token-identical to JAX's, and to the
port's greedy ``generate`` where the JAX tests hold that: in f32 on the
CPU the port's k+1-wide verify and its single steps sum the attention
and lm_head products in other orders (BLAS picks its blocking by row
count; the logits differ by ~3e-6 at ``tiny``), which would flip a
greedy token only at a near-tie of that size.
"""

import warnings

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
from tony_tpu_torch.ops import prng

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)


def _setup(seed=0, **kw):
    jcfg = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False, **kw)
    tcfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False, **kw)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp),
                                             device="cpu")


@pytest.fixture(scope="module")
def base():
    return _setup()


@pytest.fixture(scope="module")
def draft():
    """A second (rejecting) draft: the tiny config, other weights."""
    return _setup(seed=99)[2:]


def _toks(shape, seed):
    return np.random.RandomState(seed).randint(0, 1024, size=shape)


def _j(a):
    return jnp.asarray(a, jnp.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _greedy(tp, cfg, prompt, n):
    return TD.generate(tp, _t(prompt), cfg, n).tokens.numpy()


INT8_TOL = dict(atol=1e-3, rtol=1e-3)


def _assert_stream_or_int8_tie(got, want, jp, jcfg, prompt_len):
    """``got`` equals ``want`` (JAX's tokens) row by row up to a first
    difference, which must lie at a near-tie of JAX's logits (gap within
    1e-2) at that step. Returns the first differences (row, step, gap)."""
    diffs = []
    for r in range(want.shape[0]):
        d = np.nonzero(got[r] != want[r])[0]
        if not len(d):
            continue
        j = int(d[0])
        assert j >= prompt_len
        lg, _ = JD.prefill(jp, _j(want[r:r + 1, :j]), jcfg, j + 1)
        lg = np.asarray(lg)[0]
        gap = float(lg[want[r, j]] - lg[got[r, j]])
        assert 0.0 <= gap <= 1e-2, (r, j - prompt_len, gap)
        diffs.append((r, j - prompt_len, gap))
    return diffs


def _assert_int8_cache_close(t_cache, j_cache):
    for n in ("k", "v"):
        a, b = np.asarray(j_cache[n]).astype(np.int32), t_cache[n].numpy()
        assert np.abs(a - b).max() <= 1, n
        assert (a != b).mean() <= 1e-3, (n, (a != b).mean())
    for n in ("k_scale", "v_scale"):
        np.testing.assert_allclose(t_cache[n].numpy(), np.asarray(j_cache[n]),
                                   rtol=1e-5, atol=0)


# --- int8 KV caches -------------------------------------------------------

class TestInt8Cache:
    def test_cache_layout(self):
        cfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32,
                                        kv_cache_dtype="int8")
        c = TD.init_kv_cache(cfg, 2, 64, device="cpu")
        kv, hd = cfg.kv_heads, cfg.head_dim
        assert c["k"].dtype == torch.int8 and c["v"].dtype == torch.int8
        assert tuple(c["k_scale"].shape) == (cfg.n_layers, 2, 64, kv, 1)
        assert c["k_scale"].dtype == torch.float32
        # bytes per slot: (1 + 4/hd) / 2 of the bf16 cache's
        bf = TD.init_kv_cache(cfg.scaled(kv_cache_dtype="model",
                                         dtype=torch.bfloat16), 2, 64,
                              device="cpu")
        nbytes = lambda c: sum(t.numel() * t.element_size()
                               for t in TD._kv_bufs(c).values())
        assert nbytes(c) / nbytes(bf) == pytest.approx((1 + 4 / hd) / 2)

    def test_quantize_bitwise_jax_and_error_bounded(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (4, 7, 2, 32),
                              jnp.float32)
        jq, js = JD._kv_quantize(x)
        q, s = TD._kv_quantize(_t(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        err = (q.float() * s - _t(x)).abs()
        bound = _t(x).abs().amax(dim=-1, keepdim=True) / 254.0
        assert bool((err <= bound + 1e-7).all())

    @pytest.mark.parametrize("max_len", [48, 520])
    def test_contents_and_logits_match_jax(self, max_len):
        """After prefill and after 4 decode steps (max_len 520: the
        blockwise walk)."""
        jcfg, tcfg, jp, tp = _setup(kv_cache_dtype="int8", n_kv_heads=2)
        toks = _toks((2, 30), 1)
        jl, jc = JD.prefill(jp, _j(toks), jcfg, max_len)
        tl, tc = TD.prefill(tp, _t(toks), tcfg, max_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_int8_cache_close(tc, jc)
        for _ in range(4):
            nxt = np.argmax(np.asarray(jl), axis=-1)
            jl, jc = JD.decode_step(jp, _j(nxt), jc, jc["length"], jcfg)
            tl, tc = TD.decode_step(tp, _t(nxt), tc, tc["length"], tcfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_int8_cache_close(tc, jc)

    def _quant_bufs(self, seed, b, max_len, kv, d):
        g = torch.Generator().manual_seed(seed)
        k = torch.randn(1, b, max_len, kv, d, generator=g)
        v = torch.randn(1, b, max_len, kv, d, generator=g)
        kq, ksc = TD._kv_quantize(k)
        vq, vsc = TD._kv_quantize(v)
        return ({"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc},
                {"k": kq.float() * ksc, "v": vq.float() * vsc})

    @pytest.mark.parametrize("max_len,q_start,n_q", [(192, 150, 1),
                                                     (1024, 700, 3)])
    def test_scale_fold_matches_dequantized(self, max_len, q_start, n_q):
        """Scales folded outside the dots == attention over the
        dequantized cache, dense and blockwise; and JAX's on the same
        int8 buffers."""
        bufs_q, bufs_dq = self._quant_bufs(max_len, 2, max_len, 2, 32)
        q = torch.randn(2, n_q, 8, 32,
                        generator=torch.Generator().manual_seed(1))
        got = TD._cached_attention(q, bufs_q, 0, q_start)
        want = TD._cached_attention(q, bufs_dq, 0, q_start)
        torch.testing.assert_close(got, want, atol=1e-2, rtol=0)
        jgot = JD._cached_attention(
            jnp.asarray(q.numpy()),
            {n: jnp.asarray(b.numpy()) for n, b in bufs_q.items()}, 0,
            jnp.asarray(q_start))
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-5)

    def test_quantized_attention_close_to_float(self):
        g = torch.Generator().manual_seed(3)
        k = torch.randn(1, 2, 192, 2, 32, generator=g)
        v = torch.randn(1, 2, 192, 2, 32, generator=g)
        q = torch.randn(2, 1, 4, 32, generator=g)
        kq, ksc = TD._kv_quantize(k)
        vq, vsc = TD._kv_quantize(v)
        of = TD._cached_attention(q, {"k": k, "v": v}, 0, 150)
        oq = TD._cached_attention(
            q, {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}, 0, 150)
        assert float((of - oq).abs().max() / of.abs().max()) < 0.05

    def test_generate_token_identical_to_jax_and_tracks_float(self, base):
        jcfg, tcfg, jp, tp = base
        qj, qt = jcfg.scaled(kv_cache_dtype="int8"), \
            tcfg.scaled(kv_cache_dtype="int8")
        prompt = _toks((2, 8), 40)
        want = JD.generate(jp, _j(prompt), qj, 24, jax.random.PRNGKey(0))
        got = _greedy(tp, qt, prompt, 24)
        np.testing.assert_array_equal(got, np.asarray(want.tokens))
        # the first generated token matches the float model's
        assert (got[:, 8] == _greedy(tp, tcfg, prompt, 1)[:, 8]).all()

    def test_extend_step_matches_sequential_quant(self, base):
        """Chunked verify vs single steps with an int8 cache: logits to
        the JAX test's 2e-4, cache contents dequantized to 1e-3."""
        jcfg, tcfg, jp, tp = base
        qt = tcfg.scaled(kv_cache_dtype="int8")
        prompt, toks = _t(_toks((1, 6), 41)), _t(_toks((1, 4), 42))
        _, c1 = TD.prefill(tp, prompt, qt, 16)
        lg_chunk, c1 = TD.extend_step(tp, toks, c1, 6, qt)
        _, c2 = TD.prefill(tp, prompt, qt, 16)
        for i in range(4):
            lg, c2 = TD.decode_step(tp, toks[:, i], c2, 6 + i, qt)
            torch.testing.assert_close(lg_chunk[:, i], lg, atol=2e-4,
                                       rtol=2e-4)
        for kn, sn in (("k", "k_scale"), ("v", "v_scale")):
            torch.testing.assert_close(c1[kn].float() * c1[sn],
                                       c2[kn].float() * c2[sn], atol=1e-3,
                                       rtol=0)
        np.testing.assert_array_equal(c1["k"][0].numpy(), c2["k"][0].numpy())

    def test_speculative_and_beam_equal_greedy_quant(self, base):
        _, tcfg, _, tp = base
        qt = tcfg.scaled(kv_cache_dtype="int8")
        prompt = _toks((2, 5), 43)
        want = _greedy(tp, qt, prompt, 12)
        got = TD.speculative_generate_device(tp, tp, _t(prompt), qt, qt,
                                             max_new_tokens=12,
                                             num_speculative=3)
        np.testing.assert_array_equal(got.numpy(), want)
        bs = TD.beam_search(tp, _t(prompt), qt, 12, beam_width=1)
        np.testing.assert_array_equal(bs.tokens[:, 0].numpy(), want)


# --- sliding windows and rolling caches -----------------------------------

class TestWindowAndRing:
    def test_window_generate_matches_jax_and_bites(self, base):
        jcfg, tcfg, jp, tp = base
        prompt = _toks((2, 30), 50)
        want = JD.generate(jp, _j(prompt), jcfg.scaled(attn_window=24), 8,
                           jax.random.PRNGKey(0))
        got = _greedy(tp, tcfg.scaled(attn_window=24), prompt, 8)
        np.testing.assert_array_equal(got, np.asarray(want.tokens))
        assert (got != _greedy(tp, tcfg, prompt, 8)).any()

    def test_capacity_sized_and_oversize_warns(self):
        cfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, attn_window=24,
                                        kv_cache_capacity=32)
        assert TD.init_kv_cache(cfg, 2, 999, device="cpu")["k"].shape[2] \
            == 32
        with pytest.warns(UserWarning, match=r"O\(capacity\)"):
            TD.init_kv_cache(cfg.scaled(kv_cache_capacity=96), 1, 999,
                             device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            TD.init_kv_cache(cfg, 1, 999, device="cpu")

    def test_ring_generate_equals_linear_windowed_and_jax(self, base):
        jcfg, tcfg, jp, tp = base
        prompt = _toks((2, 20), 70)
        rj = jcfg.scaled(attn_window=24, kv_cache_capacity=32)
        rt = tcfg.scaled(attn_window=24, kv_cache_capacity=32)
        got = _greedy(tp, rt, prompt, 30)
        np.testing.assert_array_equal(
            got, _greedy(tp, tcfg.scaled(attn_window=24), prompt, 30))
        want = JD.generate(jp, _j(prompt), rj, 30, jax.random.PRNGKey(0))
        np.testing.assert_array_equal(got, np.asarray(want.tokens))

    def test_generation_far_past_capacity_matches_jax(self, base):
        """96 tokens through a 32-row ring: the port's stream is JAX's."""
        jcfg, tcfg, jp, tp = base
        prompt = _toks((1, 10), 71)
        rj = jcfg.scaled(attn_window=24, kv_cache_capacity=32)
        rt = tcfg.scaled(attn_window=24, kv_cache_capacity=32)
        got = _greedy(tp, rt, prompt, 96)
        assert got.shape == (1, 106)
        want = JD.generate(jp, _j(prompt), rj, 96, jax.random.PRNGKey(0))
        np.testing.assert_array_equal(got, np.asarray(want.tokens))

    @pytest.mark.parametrize("kv_dtype", ["model", "int8"])
    def test_ring_contents_match_jax_prompt_past_capacity(self, base,
                                                          kv_dtype):
        """A 45-token prompt into a 32-row ring keeps the last 32
        positions at ``pos % 32``: the ring equals JAX's after prefill
        and after 3 decode steps, and the logits match."""
        jcfg, tcfg, jp, tp = base
        kw = dict(attn_window=24, kv_cache_capacity=32,
                  kv_cache_dtype=kv_dtype)
        rj, rt = jcfg.scaled(**kw), tcfg.scaled(**kw)
        toks = _toks((2, 45), 72)
        jl, jc = JD.prefill(jp, _j(toks), rj, 60)
        tl, tc = TD.prefill(tp, _t(toks), rt, 60)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tol = INT8_TOL if kv_dtype == "int8" else TOL

        def same(tc, jc):
            if kv_dtype == "int8":
                _assert_int8_cache_close(tc, jc)
            else:
                for n in ("k", "v"):
                    np.testing.assert_allclose(tc[n].numpy(),
                                               np.asarray(jc[n]), atol=1e-5)
        same(tc, jc)
        for _ in range(3):
            nxt = np.argmax(np.asarray(jl), axis=-1)
            jl, jc = JD.decode_step(jp, _j(nxt), jc, jc["length"], rj)
            tl, tc = TD.decode_step(tp, _t(nxt), tc, tc["length"], rt)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        same(tc, jc)
        # and the first step equals the linear windowed cache's
        lt = tcfg.scaled(attn_window=24, kv_cache_dtype=kv_dtype)
        _, lc = TD.prefill(tp, _t(toks), lt, 60)
        _, rc = TD.prefill(tp, _t(toks), rt, 60)
        nxt = _t(np.argmax(TD.prefill(tp, _t(toks), lt, 60)[0].numpy(), -1))
        s_l, _ = TD.decode_step(tp, nxt, lc, 45, lt)
        s_r, _ = TD.decode_step(tp, nxt, rc, 45, rt)
        torch.testing.assert_close(s_r, s_l, atol=2e-4, rtol=2e-4)

    def test_refusals(self, base):
        _, tcfg, _, tp = base
        rt = tcfg.scaled(attn_window=24, kv_cache_capacity=32)
        prompt = _t(_toks((1, 8), 73))
        from tony_tpu_torch.models.serve import (ContinuousBatcher,
                                                 SpeculativeContinuousBatcher)
        with pytest.raises(ValueError, match="linear KV cache"):
            TD.beam_search(tp, prompt, rt, 4)
        with pytest.raises(ValueError, match="linear KV cache"):
            TD.speculative_generate_device(tp, tp, prompt, rt, rt,
                                           max_new_tokens=4)
        with pytest.raises(ValueError, match="linear KV cache"):
            TD.speculative_generate(tp, tp, prompt, rt, rt, max_new_tokens=4)
        with pytest.raises(ValueError, match="linear KV cache"):
            TD.prefill_rows(tp, prompt, torch.tensor([8]), rt)
        with pytest.raises(ValueError, match="linear KV"):
            SpeculativeContinuousBatcher(tp, rt, tp, rt, batch=1, max_len=32)
        _, c = TD.prefill(tp, prompt, rt, 32)
        with pytest.raises(ValueError, match="single-token"):
            TD.extend_step(tp, _t(_toks((1, 2), 1)), c, 8, rt)
        assert not ContinuousBatcher(tp, rt, batch=1,
                                     max_len=32).bucketed_admission

    @pytest.mark.parametrize("cap", [32, 0], ids=["ring", "linear"])
    def test_int8_window_generate_matches_jax(self, base, cap):
        """50 tokens past a 32-row ring (and the linear windowed cache):
        JAX's stream up to a first difference at an int8 near-tie (see
        the module docstring: row 1, 16th token, gap 4.8e-3)."""
        jcfg, tcfg, jp, tp = base
        kw = dict(attn_window=24, kv_cache_capacity=cap,
                  kv_cache_dtype="int8")
        prompt = _toks((2, 12), 74)
        want = np.asarray(JD.generate(jp, _j(prompt), jcfg.scaled(**kw), 50,
                                      jax.random.PRNGKey(0)).tokens)
        got = _greedy(tp, tcfg.scaled(**kw), prompt, 50)
        assert got.shape == (2, 62)
        _assert_stream_or_int8_tie(got, want, jp, jcfg.scaled(**kw), 12)


# --- speculative decoding -------------------------------------------------

class TestSpeculative:
    def test_chunk_vs_single_steps(self, base):
        """The k+1-wide verify against k+1 single steps in f32: not
        bitwise in the port (other summation orders), within 1e-5."""
        _, tcfg, _, tp = base
        prompt, toks = _t(_toks((2, 6), 10)), _t(_toks((2, 4), 11))
        _, c1 = TD.prefill(tp, prompt, tcfg, 16)
        lc, _ = TD.extend_step(tp, toks, c1, 6, tcfg)
        _, c2 = TD.prefill(tp, prompt, tcfg, 16)
        for i in range(4):
            lg, c2 = TD.decode_step(tp, toks[:, i], c2, 6 + i, tcfg)
            torch.testing.assert_close(lc[:, i], lg, atol=1e-5, rtol=0)

    @pytest.mark.parametrize("num_spec", [1, 3])
    def test_host_speculative_equals_greedy_and_jax(self, base, draft,
                                                    num_spec):
        jcfg, tcfg, jp, tp = base
        jd, td = draft
        prompt = _toks((1, 5), 12)
        want = _greedy(tp, tcfg, prompt, 9)
        for j_draft, t_draft in ((jp, tp), (jd, td)):
            got = TD.speculative_generate(tp, t_draft, _t(prompt), tcfg,
                                          tcfg, max_new_tokens=9,
                                          num_speculative=num_spec)
            np.testing.assert_array_equal(got.numpy(), want)
        jgot = JD.speculative_generate(jp, jd, _j(prompt), jcfg, jcfg,
                                       max_new_tokens=9,
                                       num_speculative=num_spec)
        np.testing.assert_array_equal(np.asarray(jgot), want)

    @pytest.mark.parametrize("commit,window", [("per_row", 0), ("min", 0),
                                               ("window", 0),
                                               ("window", 5)])
    def test_device_commit_policies_match_jax(self, base, draft, commit,
                                              window):
        """Batch 3, a rejecting draft: tokens and round counts are JAX's,
        and the tokens are greedy's."""
        jcfg, tcfg, jp, tp = base
        jd, td = draft
        prompt = _toks((3, 6), 21)
        kw = dict(max_new_tokens=9, num_speculative=3, commit=commit,
                  window=window, return_rounds=True)
        want, j_rounds = JD.speculative_generate_device(
            jp, jd, _j(prompt), jcfg, jcfg, **kw)
        got, rounds = TD.speculative_generate_device(
            tp, td, _t(prompt), tcfg, tcfg, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert rounds == int(j_rounds)
        np.testing.assert_array_equal(got.numpy(),
                                      _greedy(tp, tcfg, prompt, 9))

    def test_device_batch_one_and_self_draft(self, base):
        _, tcfg, _, tp = base
        prompt = _toks((1, 5), 12)
        for k in (1, 6):
            got = TD.speculative_generate_device(tp, tp, _t(prompt), tcfg,
                                                 tcfg, max_new_tokens=9,
                                                 num_speculative=k)
            np.testing.assert_array_equal(got.numpy(),
                                          _greedy(tp, tcfg, prompt, 9))

    @pytest.mark.parametrize("b", [1, 3])
    def test_sampled_matches_jax(self, base, draft, b):
        """Rejection-sampled rounds: the JAX stream, bitwise tokens."""
        jcfg, tcfg, jp, tp = base
        jd, td = draft
        prompt = _toks((b, 6), 30)
        kw = dict(max_new_tokens=9, num_speculative=3, temperature=0.8,
                  top_k=50, top_p=0.95)
        want = JD.speculative_generate_device(
            jp, jd, _j(prompt), jcfg, jcfg, rng=jax.random.PRNGKey(3), **kw)
        got = TD.speculative_generate_device(
            tp, td, _t(prompt), tcfg, tcfg, rng=prng.PRNGKey(3), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_window_commit_clamp_forced(self, base):
        """The JAX package's forced-clamp case: one row's draft is
        perfect, the other's sabotaged, window k+2 — the bounded-window
        writes (and their clamped base near the end) stay exact."""
        jcfg, tcfg, jp, tp = base
        prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(0),
                                               (2, 6), 0, 1024))
        n = 24
        want = _greedy(tp, tcfg, prompt, n)
        set_a = set(want[0].tolist())
        set_b = set(want[1][6:].tolist())
        assert not (set_a & set_b), "seed drift: trajectories overlap"
        corrupt = np.asarray(sorted(set_b - set_a))
        semi_j = dict(jp, embed=jp["embed"].at[corrupt].add(1.0))
        semi_t = dict(tp, embed=tp["embed"].clone())
        semi_t["embed"][torch.from_numpy(corrupt)] += 1.0
        rounds = []
        for r in range(2):
            _, rr = TD.speculative_generate_device(
                tp, semi_t, _t(prompt[r:r + 1]), tcfg, tcfg,
                max_new_tokens=n, num_speculative=4, commit="per_row",
                return_rounds=True)
            rounds.append(rr)
        assert rounds[0] < rounds[1] // 2, rounds
        for window in (6, 0):
            got = TD.speculative_generate_device(
                tp, semi_t, _t(prompt), tcfg, tcfg, max_new_tokens=n,
                num_speculative=4, commit="window", window=window)
            np.testing.assert_array_equal(got.numpy(), want)
        jgot = JD.speculative_generate_device(
            jp, semi_j, _j(prompt), jcfg, jcfg, max_new_tokens=n,
            num_speculative=4, commit="window", window=6)
        np.testing.assert_array_equal(np.asarray(jgot), want)
        with pytest.raises(ValueError, match="window"):
            TD.speculative_generate_device(tp, semi_t, _t(prompt), tcfg,
                                           tcfg, max_new_tokens=n,
                                           num_speculative=4,
                                           commit="window", window=3)

    def test_window_write_clamps_its_base(self):
        """Near the cache end the window's base clamps to max_len -
        window and each row keeps its own position."""
        buf = torch.zeros(1, 2, 12, 1, 1)
        chunk = torch.tensor([[1.0], [2.0]]).reshape(2, 1, 1, 1)
        TD._write_kv_chunk(buf, chunk, 0, torch.tensor([9, 11]), window=4)
        assert buf[0, 0, :, 0, 0].nonzero().flatten().tolist() == [9]
        assert buf[0, 1, :, 0, 0].nonzero().flatten().tolist() == [11]
        # a frozen row's surrogate far ahead is clipped into the window
        buf.zero_()
        TD._write_kv_chunk(buf, chunk, 0, torch.tensor([2, 11]), window=4)
        assert buf[0, 1, :, 0, 0].nonzero().flatten().tolist() == [5]

    def test_refusals(self, base):
        jcfg, tcfg, jp, tp = base
        bad_cfg = tcfg.scaled(vocab_size=512)
        bad = TT.init_params(torch.Generator().manual_seed(1), bad_cfg,
                             device="cpu")
        prompt = _t([[1, 2, 3]])
        with pytest.raises(ValueError, match="vocab"):
            TD.speculative_generate_device(tp, bad, prompt, tcfg, bad_cfg,
                                           max_new_tokens=4,
                                           num_speculative=2)
        with pytest.raises(ValueError, match="vocab"):
            TD.speculative_generate(tp, bad, prompt, tcfg, bad_cfg,
                                    max_new_tokens=4, num_speculative=2)
        with pytest.raises(ValueError, match="commit policy"):
            TD.speculative_generate_device(tp, tp, prompt, tcfg, tcfg,
                                           max_new_tokens=4, commit="bogus")
        with pytest.raises(ValueError, match="rng"):
            TD.speculative_generate_device(tp, tp, prompt, tcfg, tcfg,
                                           max_new_tokens=4,
                                           temperature=0.8)
        with pytest.raises(ValueError, match="batch size 1"):
            TD.speculative_generate(tp, tp, _t([[1, 2], [3, 4]]), tcfg,
                                    tcfg, max_new_tokens=4)


# --- beam search ----------------------------------------------------------

class TestBeamSearch:
    BJ = JT.TransformerConfig(vocab_size=17, d_model=24, n_layers=2,
                              n_heads=2, d_ff=48, max_seq=256,
                              dtype=jnp.float32, logits_dtype=jnp.float32,
                              remat=False)
    BT = TT.TransformerConfig(vocab_size=17, d_model=24, n_layers=2,
                              n_heads=2, d_ff=48, max_seq=256,
                              dtype=torch.float32,
                              logits_dtype=torch.float32, remat=False)

    @pytest.fixture(scope="class")
    def bparams(self):
        jp = JT.init_params(jax.random.PRNGKey(2), self.BJ)
        return jp, params_from_numpy(jax.device_get(jp), device="cpu")

    def test_width_one_equals_greedy(self, bparams):
        _, tp = bparams
        prompt = _toks((2, 5), 3) % 17
        out = TD.beam_search(tp, _t(prompt), self.BT, 7, beam_width=1)
        np.testing.assert_array_equal(out.tokens[:, 0].numpy(),
                                      _greedy(tp, self.BT, prompt, 7))

    @pytest.mark.parametrize("w,n,lp", [(4, 6, 0.0), (3, 5, 0.7)])
    def test_matches_jax(self, bparams, w, n, lp):
        jp, tp = bparams
        prompt = _toks((2, 4), 4) % 17
        want = JD.beam_search(jp, _j(prompt), self.BJ, n, beam_width=w,
                              length_penalty=lp)
        got = TD.beam_search(tp, _t(prompt), self.BT, n, beam_width=w,
                             length_penalty=lp)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), atol=1e-4)
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))
        scores = got.scores.numpy()
        if lp == 0.0:
            assert (np.diff(scores, axis=1) <= 1e-6).all()

    def test_scores_are_exact(self, bparams):
        """Each beam's score is the full-forward logprob of its tokens."""
        _, tp = bparams
        out = TD.beam_search(tp, _t(_toks((1, 4), 4) % 17), self.BT, 6,
                             beam_width=4)
        toks = out.tokens.numpy()
        for wdx in range(4):
            logits, _ = TT.forward(tp, _t(toks[:, wdx]), self.BT)
            logp = torch.log_softmax(logits[0].float(), dim=-1)
            want = sum(float(logp[3 + i, toks[0, wdx, 4 + i]])
                       for i in range(6))
            assert abs(want - float(out.scores[0, wdx])) < 1e-3

    def test_eos_freezes_beams_as_jax(self, bparams):
        jp, tp = bparams
        prompt = _toks((1, 4), 6) % 17
        free = TD.beam_search(tp, _t(prompt), self.BT, 6, beam_width=3)
        eos = int(free.tokens[0, 0, 4 + 2])
        got = TD.beam_search(tp, _t(prompt), self.BT, 6, beam_width=3,
                             eos_id=eos)
        want = JD.beam_search(jp, _j(prompt), self.BJ, 6, beam_width=3,
                              eos_id=eos)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))
        for wdx in range(3):
            gen = got.tokens[0, wdx, 4:].tolist()
            if eos in gen:
                first = gen.index(eos)
                assert int(got.lengths[0, wdx]) == first + 1
                assert all(t == eos for t in gen[first:])

    def test_bad_width_rejected(self, bparams):
        _, tp = bparams
        prompt = _t([[1, 2]])
        with pytest.raises(ValueError, match="beam_width"):
            TD.beam_search(tp, prompt, self.BT, 3, beam_width=0)
        with pytest.raises(ValueError, match="max_new_tokens"):
            TD.beam_search(tp, prompt, self.BT, 0, beam_width=2)
