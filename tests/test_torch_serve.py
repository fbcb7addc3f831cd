"""tony_tpu_torch continuous batching vs the JAX package's.

On ``tiny`` in f32 with the JAX parameters converted to torch, 7
mixed-length requests with mixed budgets through 3 slots: the port's
``ContinuousBatcher.serve`` gives the JAX batcher's tokens exactly and
the same ``steps_executed``, pipelined and sequential alike. The same
holds on the blockwise cache walk (``max_len`` 512, 8 requests of 5 to
400 tokens through 3 slots), where the batcher's host mirror of the
frontiers is also held equal to the device's at every issue. Sampled
serving (temperature 0.8, top-k 50, top-p 0.95, seed 0) gives the JAX
batcher's tokens exactly too, pipelined and sequential, and the same
tokens through any slot count, since each request samples its own
stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import serve as JS
from tony_tpu.models import transformer as JT
from tony_tpu_torch.models import decode as TD
from tony_tpu_torch.models import serve as TS
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy
from tony_tpu_torch.runtime.metrics import MetricsRegistry

torch.set_num_threads(2)

JCFG = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False)
TCFG = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)

_rng = np.random.RandomState(0)
PROMPTS = [list(_rng.randint(0, 1024, size=n))
           for n in (5, 3, 7, 20, 6, 3, 11)]
BUDGETS = [6, 9, 4, 12, 3, 7, 5]


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def jax_serve(params):
    jp, _ = params
    out = {}
    for pipe in (True, False):
        b = JS.ContinuousBatcher(jp, JCFG, batch=3, max_len=48, chunk=4,
                                 pipeline=pipe)
        out[pipe] = (b.serve(PROMPTS, BUDGETS), b.steps_executed)
    return out


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "sequential"])
def test_serve_token_identical_to_jax(params, jax_serve, pipeline):
    _, tp = params
    b = TS.ContinuousBatcher(tp, TCFG, batch=3, max_len=48, chunk=4,
                             pipeline=pipeline)
    out = b.serve(PROMPTS, BUDGETS)
    want, steps = jax_serve[pipeline]
    assert out == want
    assert b.steps_executed == steps
    assert [len(o) for o in out] == BUDGETS


SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95, seed=0)


@pytest.fixture(scope="module")
def jax_serve_sampled(params):
    jp, _ = params
    out = {}
    for pipe in (True, False):
        b = JS.ContinuousBatcher(jp, JCFG, batch=3, max_len=48, chunk=4,
                                 pipeline=pipe, **SAMPLING)
        out[pipe] = (b.serve(PROMPTS, BUDGETS), b.steps_executed)
    return out


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "sequential"])
def test_sampled_serve_token_identical_to_jax(params, jax_serve_sampled,
                                              pipeline):
    _, tp = params
    b = TS.ContinuousBatcher(tp, TCFG, batch=3, max_len=48, chunk=4,
                             pipeline=pipeline, **SAMPLING)
    out = b.serve(PROMPTS, BUDGETS)
    want, steps = jax_serve_sampled[pipeline]
    assert out == want
    assert b.steps_executed == steps
    greedy = TS.ContinuousBatcher(tp, TCFG, batch=3, max_len=48,
                                  chunk=4).serve(PROMPTS, BUDGETS)
    assert out != greedy


@pytest.mark.parametrize("slots,chunk", [(1, 3), (5, 2)])
def test_sampled_tokens_independent_of_slots(params, jax_serve_sampled,
                                             slots, chunk):
    """A request's samples depend on its own stream alone."""
    _, tp = params
    b = TS.ContinuousBatcher(tp, TCFG, batch=slots, max_len=48,
                             chunk=chunk, **SAMPLING)
    assert b.serve(PROMPTS, BUDGETS) == jax_serve_sampled[True][0]


# Blockwise arm (max_len 512 = two 256-position cache blocks): mixed
# prompt lengths whose frontiers sit on both sides of the block edge and
# cross it while decoding, and 8 requests through 3 slots so every slot
# is reused. The walk bound comes from the batcher's host mirror of the
# frontiers, so a mirror that fell behind would skip the second block.
_rs = np.random.RandomState(1)
LONG_PROMPTS = [list(_rs.randint(0, 1024, size=n))
                for n in (250, 5, 40, 300, 9, 400, 120, 247)]
LONG_BUDGETS = [10, 14, 9, 6, 5, 8, 11, 12]


@pytest.fixture(scope="module")
def jax_serve_blockwise(params):
    jp, _ = params
    out = {}
    for pipe in (True, False):
        b = JS.ContinuousBatcher(jp, JCFG, batch=3, max_len=512, chunk=4,
                                 pipeline=pipe)
        out[pipe] = (b.serve(LONG_PROMPTS, LONG_BUDGETS), b.steps_executed)
    return out


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "sequential"])
def test_blockwise_serve_token_identical_to_jax(params, jax_serve_blockwise,
                                                pipeline):
    _, tp = params
    b = TS.ContinuousBatcher(tp, TCFG, batch=3, max_len=512, chunk=4,
                             pipeline=pipeline)
    frontiers = []
    issue = b._issue

    def issue_checked():
        # the host mirror that bounds the walk is the device frontier
        assert b._host_len == b.cache["length"].tolist()
        frontiers.append(list(b._host_len))
        return issue()

    b._issue = issue_checked
    out = b.serve(LONG_PROMPTS, LONG_BUDGETS)
    want, steps = jax_serve_blockwise[pipeline]
    assert out == want
    assert b.steps_executed == steps
    assert [len(o) for o in out] == LONG_BUDGETS
    # some chunk started below the block edge and ended past it
    assert any(max(f) < 256 < max(f) + b.chunk for f in frontiers)


def test_pipelined_equals_sequential_and_solo_generate(params):
    _, tp = params
    outs, steps = [], []
    for pipe in (True, False):
        b = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=40, chunk=3,
                                 pipeline=pipe)
        outs.append(b.serve(PROMPTS[:5], 6))
        steps.append(b.steps_executed)
    assert outs[0] == outs[1] and steps[0] == steps[1]
    for p, o in zip(PROMPTS[:5], outs[0]):
        solo = TD.generate(tp, torch.tensor([p]), TCFG, 6)
        assert o == solo.tokens[0, len(p):].tolist()


def test_unbucketed_admission_and_eos_match_jax(params):
    jp, tp = params
    eos = int(jax_first_token(jp, PROMPTS[1]))
    jb = JS.ContinuousBatcher(jp, JCFG, batch=3, max_len=48, chunk=4,
                              eos_id=eos, bucketed_admission=False)
    tb = TS.ContinuousBatcher(tp, TCFG, batch=3, max_len=48, chunk=4,
                              eos_id=eos, bucketed_admission=False)
    want = jb.serve(PROMPTS, BUDGETS)
    assert tb.serve(PROMPTS, BUDGETS) == want
    assert tb.steps_executed == jb.steps_executed
    assert want[1] == [eos]                      # retired on eos at once


def jax_first_token(jp, prompt):
    lg, _ = JT.forward(jp, jnp.asarray([prompt], jnp.int32), JCFG)
    return np.argmax(np.asarray(lg)[0, -1])


def test_bucket_for_matches_jax():
    for n in (1, 15, 16, 17, 100, 256, 257, 1000):
        for cap in (64, 300, 2048):
            assert TS.bucket_for(n, cap) == JS.bucket_for(n, cap)
            ladder = (8, 40, 200)
            assert TS.bucket_for(n, cap, ladder) == \
                JS.bucket_for(n, cap, ladder)


def test_engine_counters_cancel_and_validation(params):
    _, tp = params
    reg = MetricsRegistry()
    b = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=32, chunk=4)
    retired = {}
    eng = TS.ServeEngine(b, registry=reg,
                         on_retired=lambda rid, reason, n, final:
                             retired.setdefault(rid, (reason, n)))
    for rid in range(4):
        eng.submit(rid, PROMPTS[rid][:6], 5)
    with pytest.raises(ValueError):
        eng.submit(0, [1, 2], 3)                 # live rid
    with pytest.raises(ValueError):
        eng.submit(9, [1] * 30, 5)               # past max_len
    eng.cancel(3)                                # still waiting
    assert retired[3] == ("cancelled", 0)
    eng.drain()
    with pytest.raises(RuntimeError):
        eng.submit(10, [1], 1)
    eng.run()
    assert {rid: retired[rid] for rid in range(3)} == \
        {rid: ("budget", 5) for rid in range(3)}
    wire = {name: v for name, _, v in reg.to_wire()["c"]}
    assert wire["tony_serve_tokens_total"] == 15
    assert wire["tony_serve_requests_admitted_total"] == 3
    assert wire["tony_serve_requests_cancelled_total"] == 1
    assert wire["tony_serve_prefill_tokens_total"] == sum(
        len(PROMPTS[rid][:6]) for rid in range(3))
    assert b.phase_times.count("admit") >= 2
    assert TS.CALL_COUNTS[("admit_rows", (2, 16))] >= 2



def test_moe_serve_token_identical_to_jax_and_generate():
    """An MoE config (4 experts) through the batcher, pipelined: the JAX
    batcher's tokens and steps, and each request equal to the port's
    ``generate`` of its prompt alone. Admission pads a prompt to its
    bucket and capacity follows the padded length, so the factor is
    4.0, where nothing drops (as tests/test_decode.py's MoE test runs);
    then the same requests through a ``ServeEngine`` over the batcher."""
    jcfg = JCFG.scaled(num_experts=4, moe_capacity_factor=4.0)
    tcfg = TCFG.scaled(num_experts=4, moe_capacity_factor=4.0)
    jp = JT.init_params(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    jb = JS.ContinuousBatcher(jp, jcfg, batch=3, max_len=48, chunk=4)
    want = jb.serve(PROMPTS, BUDGETS)
    tb = TS.ContinuousBatcher(tp, tcfg, batch=3, max_len=48, chunk=4)
    assert tb.serve(PROMPTS, BUDGETS) == want
    assert tb.steps_executed == jb.steps_executed
    for p, n, o in zip(PROMPTS, BUDGETS, want):
        solo = TD.generate(tp, torch.tensor([p]), tcfg, n)
        assert o == solo.tokens[0, len(p):].tolist()
    got = {}
    eng = TS.ServeEngine(
        TS.ContinuousBatcher(tp, tcfg, batch=3, max_len=48, chunk=4),
        on_delta=lambda rid, toks: got.setdefault(rid, []).extend(toks),
        on_retired=lambda rid, reason, n, final: got.setdefault(
            rid, []).extend(final or []))
    for rid, (p, n) in enumerate(zip(PROMPTS, BUDGETS)):
        eng.submit(rid, p, n)
    eng.drain()
    eng.run()
    assert [got[rid] for rid in range(len(PROMPTS))] == want
