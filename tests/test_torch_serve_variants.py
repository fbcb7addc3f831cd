"""tony_tpu_torch's serving variants vs the JAX package's: the int8 KV
cache and int8 weights in the batcher, rolling (ring) caches with their
per-length admission, and ``SpeculativeContinuousBatcher`` (greedy and
sampled) alone and under the QoS engine.

``tiny`` in f32 with the JAX weights converted to torch; a rejecting
draft is the tiny config with other weights. Every comparison is exact:
the port's streams, ``steps_executed`` and ``rounds_executed`` equal the
JAX batcher's, pipelined and sequential, and the greedy speculative
streams equal each request's greedy ``generate``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_qos import SCRIPT, _run_script
from tony_tpu.models import quantize as JQ
from tony_tpu.models import serve as JS
from tony_tpu.models import transformer as JT
from tony_tpu_torch.models import decode as TD
from tony_tpu_torch.models import serve as TS
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.quantize import quantize_weights_int8
from tony_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

JCFG = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False)
TCFG = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)


def _pair(seed, jcfg=JCFG):
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def params():
    return _pair(0)


@pytest.fixture(scope="module")
def draft():
    return _pair(99)


def _prompts(seed, sizes):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(0, 1024, size=n)] for n in sizes]


def _reference(tp, cfg, prompt, n):
    out = TD.generate(tp, torch.tensor([prompt]), cfg, n)
    return out.tokens[0, len(prompt):].tolist()


# --- int8 caches and weights in the batcher ------------------------------

def test_quantized_cache_token_identical_to_quant_generate(params):
    """int8 KV serving equals per-request generate under the same
    quantized config, slot reuse included, and the JAX batcher's
    tokens."""
    jp, tp = params
    kw = dict(kv_cache_dtype="int8")
    prompts = _prompts(7, (5, 3, 6, 4))
    b = TS.ContinuousBatcher(tp, TCFG.scaled(**kw), batch=2, max_len=32,
                             chunk=4)
    outs = b.serve(prompts, max_new_tokens=6)
    for i, p in enumerate(prompts):
        assert outs[i] == _reference(tp, TCFG.scaled(**kw), p, 6), i
    jb = JS.ContinuousBatcher(jp, JCFG.scaled(**kw), batch=2, max_len=32,
                              chunk=4)
    assert outs == jb.serve(prompts, max_new_tokens=6)
    assert b.steps_executed == jb.steps_executed


def test_quantized_weights_and_cache_serve_like_jax(params):
    jp, tp = params
    kw = dict(kv_cache_dtype="int8")
    prompts = _prompts(3, (5, 7, 4, 9))
    budgets = [6, 4, 8, 5]
    b = TS.ContinuousBatcher(quantize_weights_int8(tp), TCFG.scaled(**kw),
                             batch=2, max_len=32, chunk=3)
    jb = JS.ContinuousBatcher(JQ.quantize_weights_int8(jp),
                              JCFG.scaled(**kw), batch=2, max_len=32,
                              chunk=3)
    assert b.serve(prompts, budgets) == jb.serve(prompts, budgets)


# --- rolling caches -------------------------------------------------------

RING = dict(attn_window=24, kv_cache_capacity=32)


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "sequential"])
def test_ring_batcher_matches_jax(params, pipeline):
    """A prompt past the capacity and a request past max_len (the ring
    lifts the ceiling); admission goes per length, never bucketed."""
    jp, tp = params
    prompts = _prompts(5, (10, 45, 7))
    budgets = [60, 20, 9]
    b = TS.ContinuousBatcher(tp, TCFG.scaled(**RING), batch=2, max_len=48,
                             chunk=4, pipeline=pipeline)
    assert b._ring and not b.bucketed_admission
    TS.CALL_COUNTS.clear()
    outs = b.serve(prompts, budgets)
    assert TS.CALL_COUNTS[("admit_row_ring", (1, 45))] == 1
    assert not any(name == "admit_rows" for name, _ in TS.CALL_COUNTS)
    jb = JS.ContinuousBatcher(jp, JCFG.scaled(**RING), batch=2, max_len=48,
                              chunk=4, pipeline=pipeline)
    assert outs == jb.serve(prompts, budgets)
    assert b.steps_executed == jb.steps_executed
    assert [len(o) for o in outs] == budgets


def test_ring_batcher_slots_independent(params):
    """2-slot ring serving == each request through a 1-slot batcher."""
    _, tp = params
    prompts = _prompts(5, (10, 45))
    budgets = [60, 20]
    outs = TS.ContinuousBatcher(tp, TCFG.scaled(**RING), batch=2,
                                max_len=48, chunk=4).serve(prompts, budgets)
    for i, p in enumerate(prompts):
        solo = TS.ContinuousBatcher(tp, TCFG.scaled(**RING), batch=1,
                                    max_len=48, chunk=4)
        assert outs[i] == solo.serve([p], [budgets[i]])[0], i


def test_ring_sampled_int8_matches_jax(params):
    jp, tp = params
    kw = dict(RING, kv_cache_dtype="int8")
    sampling = dict(temperature=0.8, top_k=50, top_p=0.95, seed=0)
    prompts = _prompts(8, (12, 40, 5))
    b = TS.ContinuousBatcher(tp, TCFG.scaled(**kw), batch=2, max_len=48,
                             chunk=4, **sampling)
    jb = JS.ContinuousBatcher(jp, JCFG.scaled(**kw), batch=2, max_len=48,
                              chunk=4, **sampling)
    assert b.serve(prompts, [30, 10, 12]) == jb.serve(prompts, [30, 10, 12])


def test_window_serving_token_identical_to_generate(params):
    """A windowed model on the linear cache, a reused slot included."""
    _, tp = params
    cfg = TCFG.scaled(attn_window=24)
    prompts = _prompts(9, (26, 30, 28))
    outs = TS.ContinuousBatcher(tp, cfg, batch=2, max_len=48,
                                chunk=4).serve(prompts, max_new_tokens=8)
    diverged = False
    for i, p in enumerate(prompts):
        assert outs[i] == _reference(tp, cfg, p, 8), i
        diverged |= outs[i] != _reference(tp, TCFG, p, 8)
    assert diverged


# --- speculative serving ------------------------------------------------

SPEC_PROMPTS = _prompts(3, (3, 8, 5, 4, 7, 6, 4))
SPEC_BUDGETS = [int(b) for b in np.random.RandomState(4).randint(4, 14, 7)]


def _spec_pair(params, draft_pair, pipeline=True, cfg_kw=None,
               bucketed=True, **kw):
    (jp, tp), (jd, td) = params, draft_pair
    jc, tc = JCFG.scaled(**(cfg_kw or {})), TCFG.scaled(**(cfg_kw or {}))
    common = dict(batch=3, max_len=64, num_speculative=3, chunk=2,
                  pipeline=pipeline, bucketed_admission=bucketed, **kw)
    return (TS.SpeculativeContinuousBatcher(tp, tc, td, tc, **common),
            JS.SpeculativeContinuousBatcher(jp, jc, jd, jc, **common))


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "sequential"])
def test_speculative_greedy_matches_jax_and_generate(params, draft,
                                                     pipeline):
    """Self-draft and a rejecting draft: the JAX batcher's streams and
    counters, each request's greedy generate, and fewer rounds with the
    self-draft."""
    rounds = {}
    for name, d in (("self", params), ("rej", draft)):
        b, jb = _spec_pair(params, d, pipeline)
        outs = b.serve(SPEC_PROMPTS, SPEC_BUDGETS)
        assert outs == jb.serve(SPEC_PROMPTS, SPEC_BUDGETS), name
        assert b.rounds_executed == jb.rounds_executed
        assert b.steps_executed == jb.steps_executed
        for i, (p, n) in enumerate(zip(SPEC_PROMPTS, SPEC_BUDGETS)):
            assert outs[i] == _reference(params[1], TCFG, p, n), (name, i)
        rounds[name] = b.rounds_executed
    assert rounds["self"] < rounds["rej"]


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "sequential"])
def test_speculative_sampled_matches_jax(params, draft, pipeline):
    b, jb = _spec_pair(params, draft, pipeline, temperature=0.8, top_k=50,
                       top_p=0.95, seed=3)
    outs = b.serve(SPEC_PROMPTS, SPEC_BUDGETS)
    assert outs == jb.serve(SPEC_PROMPTS, SPEC_BUDGETS)
    assert b.rounds_executed == jb.rounds_executed
    greedy = _spec_pair(params, draft)[0].serve(SPEC_PROMPTS, SPEC_BUDGETS)
    assert outs != greedy


def test_speculative_unbucketed_int8_quantized_matches_jax(params, draft):
    """Per-request admission (spec_admit_row), int8 weights for both
    models and an int8 cache, sampled: the JAX batcher's streams."""
    (jp, tp), (jd, td) = params, draft
    kw = dict(kv_cache_dtype="int8")
    jc, tc = JCFG.scaled(**kw), TCFG.scaled(**kw)
    common = dict(batch=2, max_len=48, num_speculative=2, chunk=2,
                  temperature=0.9, top_k=6, seed=3,
                  bucketed_admission=False)
    b = TS.SpeculativeContinuousBatcher(quantize_weights_int8(tp), tc,
                                        quantize_weights_int8(td), tc,
                                        **common)
    jb = JS.SpeculativeContinuousBatcher(JQ.quantize_weights_int8(jp), jc,
                                         JQ.quantize_weights_int8(jd), jc,
                                         **common)
    TS.CALL_COUNTS.clear()
    prompts, budgets = SPEC_PROMPTS[:4], SPEC_BUDGETS[:4]
    assert b.serve(prompts, budgets) == jb.serve(prompts, budgets)
    assert TS.CALL_COUNTS[("spec_admit_row", (1, 8))] == 1
    assert not any(name == "spec_admit_rows" for name, _ in TS.CALL_COUNTS)


def test_speculative_eos_frees_slot_early(params):
    _, tp = params
    prompts = _prompts(2, (5, 4, 6))
    ref0 = _reference(tp, TCFG, prompts[0], 8)
    eos = ref0[2]
    b = TS.SpeculativeContinuousBatcher(tp, TCFG, tp, TCFG, batch=2,
                                        max_len=64, num_speculative=4,
                                        eos_id=eos, chunk=2)
    outs = b.serve(prompts, max_new_tokens=8)
    assert outs[0] == ref0[:3]
    for i in (1, 2):
        ref = _reference(tp, TCFG, prompts[i], 8)
        cut = (ref.index(eos) + 1) if eos in ref else 8
        assert outs[i] == ref[:cut]


def test_speculative_distinct_draft_config(params):
    """A smaller draft architecture (caches sized per config), on the
    blockwise walk (max_len 520) whose bound is the host's frontier
    bounds."""
    (jp, tp) = params
    dj = JCFG.scaled(n_layers=1, d_model=32, n_heads=2, d_ff=64)
    dt = TCFG.scaled(n_layers=1, d_model=32, n_heads=2, d_ff=64)
    jd = JT.init_params(jax.random.PRNGKey(5), dj)
    td = params_from_numpy(jax.device_get(jd), device="cpu")
    prompts = _prompts(7, (5, 300, 5, 260))
    kw = dict(batch=2, max_len=520, num_speculative=3, chunk=3)
    b = TS.SpeculativeContinuousBatcher(tp, TCFG, td, dt, **kw)
    outs = b.serve(prompts, max_new_tokens=7)
    for i, p in enumerate(prompts):
        assert outs[i] == _reference(tp, TCFG, p, 7), i
    jb = JS.SpeculativeContinuousBatcher(jp, JCFG, jd, dj, **kw)
    assert outs == jb.serve(prompts, max_new_tokens=7)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "sequential"])
def test_engine_script_with_speculative_batcher(params, draft, sampled,
                                                pipeline):
    """The QoS submission script (classes, floors, interactive-over-batch
    preemption) through a speculative batcher: the same admission waves,
    preemptions and tokens as the JAX engine's."""
    (jp, tp), (jd, td) = params, draft
    kw = dict(temperature=0.8, top_k=50, top_p=0.95, seed=0) \
        if sampled else {}

    def spec(base, p, d):
        class Spec(base):
            def __init__(self, params, cfg, **k):
                super().__init__(params, cfg, d, cfg, num_speculative=2,
                                 **k)
        return Spec

    floors = {"batch": 1}
    got, waves, pre = _run_script(spec(TS.SpeculativeContinuousBatcher,
                                       tp, td), TS.ServeEngine, tp, TCFG,
                                  floors, pipeline=pipeline, **kw)
    want, jwaves, jpre = _run_script(spec(JS.SpeculativeContinuousBatcher,
                                          jp, jd), JS.ServeEngine, jp,
                                     JCFG, floors, pipeline=pipeline, **kw)
    assert waves == jwaves
    assert pre == jpre and pre, "the script must preempt"
    assert got == want
    assert sorted(got) == [r for _, reqs in SCRIPT for r, *_ in reqs]


def test_speculative_refusals(params):
    _, tp = params
    with pytest.raises(ValueError, match="num_speculative"):
        TS.SpeculativeContinuousBatcher(tp, TCFG, tp, TCFG, batch=2,
                                        max_len=32, num_speculative=0)
    bad_cfg = TCFG.scaled(vocab_size=512)
    bad = TT.init_params(torch.Generator().manual_seed(1), bad_cfg,
                         device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        TS.SpeculativeContinuousBatcher(tp, TCFG, bad, bad_cfg, batch=2,
                                        max_len=32)
    # the legacy shared prefix builds both models' templates
    b = TS.SpeculativeContinuousBatcher(tp, TCFG, tp, TCFG, batch=1,
                                        max_len=32, shared_prefix=[1, 2])
    assert b._prefix_template["k"].shape[2] == 2
    assert b._draft_prefix_template["k"].shape[2] == 2
    with pytest.raises(ValueError, match="linear KV cache"):
        TS.SpeculativeContinuousBatcher(
            tp, TCFG.scaled(**RING), tp, TCFG, batch=1, max_len=32)
