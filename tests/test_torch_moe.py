"""tony_tpu_torch's mixture-of-experts routing and block vs the JAX
package's (``tony_tpu/parallel/moe.py``).

Seeded numpy inputs through both packages, f32 on the CPU:

- ``ordered_top_k`` gives ``lax.top_k``'s order, ties to the lower index;
- ``default_capacity`` is the same integer;
- ``router_dispatch``: dispatch exactly equal, combine, the aux loss and
  the dropped fraction to 1e-5 relative, at the default capacity factor
  and at one low enough to drop, with rows of tied logits;
- ``moe_ffn`` (silu experts, the transformer's): the output and the
  gradients of every input of a scalar of it and the aux loss to 1e-5
  relative, at the same two factors, with a token whose logits all tie;
- the fused optimizer (K4's plain version here) over a bf16 MoE tree,
  whose router is f32, against the JAX ``FusedAdamW`` on the same grads:
  the router and moments stay f32, the bf16 leaves bf16, every leaf
  equal to JAX's within one bf16 ulp (f32 leaves to 1e-6).

The cp arm (the sequence split over cp, routing over the whole of it):

- each chunk routed after the lower chunks' assignments, at the whole
  sequence's capacity, gives the whole sequence's dispatch and combine
  exactly, at 2 and 4 chunks, with and without drops; ``moe_ffn`` on an
  emulated cp layout gives the whole call's output and input gradients
  within 1e-5 relative, its aux within 1e-6 and its dropped fraction
  equal;
- lower chunks that fill an expert's capacity leave an upper chunk no
  slot there: all of its tokens for that expert drop, as in the whole
  sequence (a chunk routed alone would keep them);
- the emulation against the distributed body in a gloo group of 2
  (``tests/torch_dist_worker.py``'s ``moe`` case): each rank's output,
  aux, dropped fraction and input gradient equal its chunk of the
  emulation's bit for bit, and the ranks' weight gradients summed equal
  the emulation's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tony_tpu.models import transformer as JT
from tony_tpu.ops.optim import FusedAdamW as JaxFusedAdamW
from tony_tpu.parallel import moe as JM
from tony_tpu_torch.models import train as TR
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from tony_tpu_torch.ops import optim as O
from tony_tpu_torch.parallel import moe as TM
from tony_tpu_torch.parallel import spmd

from test_torch_distributed import Case, run_group

torch.set_num_threads(2)

B, S, D, E, H = 2, 16, 32, 4, 48
RTOL = 1e-5


def _close(got, want, what=""):
    """Within 1e-5 of the largest entry of ``want`` (relative)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= RTOL * scale, (what, err, scale)


def test_ordered_top_k_breaks_ties_like_lax_top_k():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1], [0.0, 0.5, 0.0, 0.5]],
                     np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = TM.ordered_top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("tokens,experts,k,cf", [
    (16, 4, 2, 1.25), (1, 8, 2, 1.25), (1024, 8, 2, 1.25), (7, 3, 1, 0.5),
    (32, 4, 2, 4.0)])
def test_default_capacity_matches_jax(tokens, experts, k, cf):
    assert TM.default_capacity(tokens, experts, k, cf) == \
        JM.default_capacity(tokens, experts, k, cf)


def _logits(seed=0):
    rs = np.random.RandomState(seed)
    logits = rs.randn(B, S, E).astype(np.float32)
    logits[0, 3] = [0.5, 0.5, 0.5, 0.1]      # a three-way tie for top-2
    logits[1, 5] = 0.0                       # every expert tied
    logits[1, 6] = [0.2, 0.9, 0.2, 0.9]      # tied pairs
    return logits


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["default", "dropping"])
def test_router_dispatch_matches_jax(cf):
    logits = _logits()
    cap = JM.default_capacity(S, E, 2, cf)
    jd, jc, jm = JM.router_dispatch(jnp.asarray(logits), E, top_k=2,
                                    capacity=cap)
    td, tc, tm = TM.router_dispatch(torch.from_numpy(logits), E, top_k=2,
                                    capacity=cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _close(tc.numpy(), jc, "combine")
    _close(tm.aux_loss.numpy(), jm.aux_loss, "aux")
    assert float(tm.dropped_fraction) == float(jm.dropped_fraction)
    if cf < 1:
        assert float(tm.dropped_fraction) > 0


def _ffn_inputs(seed=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, D).astype(np.float32)
    x[0, 3] = 0.0                            # zero logits: all experts tie
    router = (rs.randn(D, E) * 0.3).astype(np.float32)
    w_in = (rs.randn(E, D, H) * D ** -0.5).astype(np.float32)
    w_out = (rs.randn(E, H, D) * H ** -0.5).astype(np.float32)
    cot = rs.randn(B, S, D).astype(np.float32)
    return x, router, w_in, w_out, cot


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["default", "dropping"])
def test_moe_ffn_forward_and_gradients_match_jax(cf):
    x, router, w_in, w_out, cot = _ffn_inputs()

    def jax_fn(*args):
        out, m = JM.moe_ffn(*args, top_k=2, capacity_factor=cf,
                            activation=jax.nn.silu)
        return jnp.sum(out * cot) + 0.37 * m.aux_loss, (out, m)

    (_, (jout, jm)), jgrads = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2, 3), has_aux=True)(x, router, w_in, w_out)
    ts = [torch.tensor(a, requires_grad=True)
          for a in (x, router, w_in, w_out)]
    tout, tm = TM.moe_ffn(*ts, top_k=2, capacity_factor=cf,
                          activation=F.silu)
    tgrads = torch.autograd.grad(
        (tout * torch.from_numpy(cot)).sum() + 0.37 * tm.aux_loss, ts)
    _close(tout.detach().numpy(), jout, "out")
    _close(tm.aux_loss.detach().numpy(), jm.aux_loss, "aux")
    assert float(tm.dropped_fraction) == float(jm.dropped_fraction)
    for name, g, w in zip(("x", "router", "w_in", "w_out"), tgrads,
                          jgrads):
        _close(g.numpy(), w, name)


def test_decode_shaped_call_never_drops():
    """At S=1 the capacity is at least top_k per expert, so nothing
    drops whatever the factor (the decode caveat of models/decode.py)."""
    x, router, w_in, w_out, _ = _ffn_inputs(2)
    _, m = TM.moe_ffn(torch.from_numpy(x[:, :1]), torch.from_numpy(router),
                      torch.from_numpy(w_in), torch.from_numpy(w_out),
                      top_k=2, capacity_factor=0.1)
    assert float(m.dropped_fraction) == 0.0


def test_fused_optimizer_takes_the_mixed_moe_tree():
    """One fused step over the bf16 MoE tree (f32 router): the port's
    FusedAdamW against the JAX package's on the same grads."""
    jcfg = JT.PRESETS["tiny"].scaled(dtype=jnp.bfloat16, num_experts=4)
    jp = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
    assert jp["blocks"]["router"].dtype == np.float32
    rs = np.random.RandomState(3)
    grads = jax.tree.map(
        lambda a: (rs.randn(*a.shape) * 0.05).astype(a.dtype), jp)
    sched = TR.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 10)
    jopt = JaxFusedAdamW(sched, weight_decay=0.01, clip_norm=1.0)
    jstate = jopt.init(jax.tree.map(jnp.asarray, jp))
    want, _, jn = jopt.fused_apply(jax.tree.map(jnp.asarray, grads), jstate,
                                   jax.tree.map(jnp.asarray, jp))
    opt = O.FusedAdamW(sched, weight_decay=0.01, clip_norm=1.0)
    params = params_from_numpy(jp, device="cpu")
    state = opt.init(params)
    got, state, gn = opt.fused_apply(params_from_numpy(grads, device="cpu"),
                                     state, params)
    assert got["blocks"]["router"].dtype == torch.float32
    assert got["blocks"]["w_gate"].dtype == torch.bfloat16
    assert all(m.dtype == torch.float32
               for m in state["mu"]["blocks"].values())
    np.testing.assert_allclose(float(gn), float(jn), rtol=1e-5)
    got = params_to_numpy(got, bf16_dtype=jnp.bfloat16)
    want = jax.device_get(want)
    for k in want["blocks"]:
        w = np.asarray(want["blocks"][k], np.float32)
        g = np.asarray(got["blocks"][k], np.float32)
        ulp = 2.0 ** -7 if want["blocks"][k].dtype != np.float32 else 1e-6
        assert np.all(np.abs(g - w) <= ulp * np.maximum(np.abs(w), 1e-30)
                      + 1e-6), k


# -- the cp arm ------------------------------------------------------------

def _chunked_dispatch(logits: np.ndarray, cp: int, cap: int, top_k: int):
    """Every chunk's dispatch and combine, each routed after the lower
    chunks' assignments (what a cp rank gathers), concatenated."""
    chunks = torch.from_numpy(logits).chunk(cp, dim=1)
    counts = [TM.assignments(TM._gates(c, top_k)) for c in chunks]
    lowers = TM._exclusive_scan(counts)
    outs = [TM.router_dispatch(c, logits.shape[-1], top_k=top_k,
                               capacity=cap, lower=lo)[:2]
            for c, lo in zip(chunks, lowers)]
    return (torch.cat([o[0] for o in outs], 1),
            torch.cat([o[1] for o in outs], 1), lowers)


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["default", "dropping"])
def test_cp_arm_routes_chunks_as_the_whole_sequence(cp, cf):
    logits = _logits()
    cap = TM.default_capacity(S, E, 2, cf)
    wd, wc, wm = TM.router_dispatch(torch.from_numpy(logits), E, top_k=2,
                                    capacity=cap)
    gd, gc, _ = _chunked_dispatch(logits, cp, cap, 2)
    assert torch.equal(gd, wd) and torch.equal(gc, wc)
    if cf < 1:
        assert float(wm.dropped_fraction) > 0
    x, router, w_in, w_out, cot = _ffn_inputs()
    runs = []
    for lay in (None, spmd.EmulatedCp(cp)):
        ts = [torch.tensor(a, requires_grad=True)
              for a in (x, router, w_in, w_out)]
        out, m = TM.moe_ffn(*ts, top_k=2, capacity_factor=cf,
                            activation=F.silu, lay=lay)
        grads = torch.autograd.grad(
            (out * torch.from_numpy(cot)).sum() + 0.37 * m.aux_loss, ts)
        runs.append((out.detach(), m, grads))
    (wo, wm, wg), (go, gm, gg) = runs
    _close(go.numpy(), wo.numpy(), "out")
    np.testing.assert_allclose(float(gm.aux_loss.detach()),
                               float(wm.aux_loss.detach()), rtol=1e-6)
    assert float(gm.dropped_fraction) == float(wm.dropped_fraction)
    for name, g, w in zip(("x", "router", "w_in", "w_out"), gg, wg):
        _close(g.numpy(), w.numpy(), name)


def test_cp_arm_upper_chunk_drops_what_the_lower_chunk_filled():
    """Every token's first choice is expert 0 (top 1), whose capacity
    is half the sequence: the lower chunk fills it, and every token of
    the upper chunk drops, as in the whole sequence."""
    s, e = 8, 2
    logits = np.zeros((1, s, e), np.float32)
    logits[..., 0] = 1.0
    cap = TM.default_capacity(s, e, 1, 1.0)
    assert cap == s // 2
    wd, wc, wm = TM.router_dispatch(torch.from_numpy(logits), e, top_k=1,
                                    capacity=cap)
    gd, gc, lowers = _chunked_dispatch(logits, 2, cap, 1)
    assert lowers[1].tolist() == [[4.0, 0.0]]
    assert torch.equal(gd, wd) and torch.equal(gc, wc)
    assert float(gd[:, s // 2:].sum()) == 0.0          # all dropped
    assert float(gd[:, :s // 2].sum()) == s // 2
    assert float(wm.dropped_fraction) == 0.5
    # routed alone, at its own capacity, the upper chunk would keep them
    alone, _, _ = TM.router_dispatch(torch.from_numpy(logits[:, s // 2:]),
                                     e, top_k=1, capacity=cap)
    assert float(alone.sum()) == s // 2
    # positive inputs against a router that scores only expert 0
    xs = np.abs(np.random.RandomState(3).randn(1, s, 4)).astype(np.float32)
    router = np.zeros((4, e), np.float32)
    router[:, 0] = 1.0
    w_in = np.random.RandomState(4).randn(e, 4, 6).astype(np.float32)
    w_out = np.random.RandomState(5).randn(e, 6, 4).astype(np.float32)
    args = [torch.from_numpy(a) for a in (xs, router, w_in, w_out)]
    whole, m1 = TM.moe_ffn(*args, top_k=1, capacity_factor=1.0,
                           activation=F.silu)
    emu, m2 = TM.moe_ffn(*args, top_k=1, capacity_factor=1.0,
                         activation=F.silu, lay=spmd.EmulatedCp(2))
    assert float(m1.dropped_fraction) == float(m2.dropped_fraction) == 0.5
    assert float(emu[:, s // 2:].abs().sum()) == 0.0
    torch.testing.assert_close(emu, whole, rtol=1e-6, atol=0)


#: the cp arm's gloo case: the inputs of ``_ffn_inputs`` at a sequence
#: of 32 in 2 chunks, dropping
MOE_CASE = Case("moe_cp2", 2, {"cp": 2}, model="moe",
                kw={"top_k": 2, "capacity_factor": 0.5})


def _moe_case_inputs():
    rs = np.random.RandomState(7)
    x = rs.randn(B, 2 * S, D).astype(np.float32)
    router = (rs.randn(D, E) * 0.3).astype(np.float32)
    w_in = (rs.randn(E, D, H) * D ** -0.5).astype(np.float32)
    w_out = (rs.randn(E, H, D) * H ** -0.5).astype(np.float32)
    cot = rs.randn(B, 2 * S, D).astype(np.float32)
    return dict(x=x, router=router, w_in=w_in, w_out=w_out, cot=cot)


def _moe_setup(case):
    return None, None, {}, _moe_case_inputs()


def test_cp_arm_emulation_equals_the_gloo_group(tmp_path):
    try:
        outs = run_group([MOE_CASE], 2, tmp_path,
                         setup=_moe_setup)[MOE_CASE.name]
    except RuntimeError as e:
        pytest.fail(str(e))
    data = _moe_case_inputs()
    ts = [torch.tensor(data[n], requires_grad=True)
          for n in ("x", "router", "w_in", "w_out")]
    out, m = TM.moe_ffn(*ts, top_k=2, capacity_factor=0.5,
                        activation=F.silu, lay=spmd.EmulatedCp(2))
    grads = torch.autograd.grad(
        (out * torch.from_numpy(data["cot"])).sum() + m.aux_loss, ts)
    assert float(m.dropped_fraction) > 0
    for r, o in enumerate(outs):
        sl = slice(r * S, (r + 1) * S)
        np.testing.assert_array_equal(o["out"], out.detach()[:, sl].numpy())
        np.testing.assert_array_equal(o["aux"], m.aux_loss.detach().numpy())
        np.testing.assert_array_equal(o["dropped"],
                                      m.dropped_fraction.numpy())
        np.testing.assert_array_equal(o["dx"], grads[0][:, sl].numpy())
    for i, n in enumerate(("router", "w_in", "w_out"), start=1):
        np.testing.assert_array_equal(outs[0][f"d{n}"] + outs[1][f"d{n}"],
                                      grads[i].numpy(), n)
