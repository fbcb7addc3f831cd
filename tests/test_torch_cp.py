"""tony_tpu_torch's context parallelism and remat policies vs the JAX package.

- ``ring_attention`` and ``ulysses_attention`` (every rank emulated in one
  process) against ``tony_tpu.parallel.ring_attention.ring_attention`` and
  ``tony_tpu.parallel.ulysses.ulysses_attention`` run on the conftest's
  virtual CPU devices, on ``{"cp": 4}`` and ``{"cp": 2, "tp": 2}``, MHA
  and GQA with kv_heads 2 and 1, causal and not: the output and the
  q/k/v gradients of one cotangent within 2e-5 and 5e-5 (f32; the
  bounds of ``tests/test_parallel.py``'s ring tests). Both engines: the
  dense online softmax (each package's default on the CPU) and the flash
  arm (the port's kernels' plain versions, the JAX kernels in interpret
  mode with ``_USE_FLASH_CHUNKS = True``, as ``tests/test_parallel.py``
  forces it); GQA K/V reach the hops unexpanded exactly where the JAX
  wrappers keep them so;
- the single-process emulation against the distributed bodies at world
  2 and 4 (``tests/torch_dist_worker.py``'s gloo groups, the ``attn``
  case): every rank's output and gradients, both strategies and engines,
  causal and not, GQA, bit for bit;
- the remat policies ``"dots"`` and ``"attn"`` against ``"full"`` and
  against the JAX package's (loss rtol 1e-6, every gradient leaf atol
  1e-6, as ``tests/test_parallel.py::TestRematPolicy``), ``"attn"``
  running the attention forward once a layer where the others run it
  twice, and once a launched hop over a whole ring or Ulysses body
  under checkpoint; a bogus policy raises at config time;
- a window with a live cp axis raises, as ``attention_spec`` resolves
  the JAX package's axes; MoE with one (the dict mesh ``{"dp": 1, "cp":
  2}``, its cp ranks emulated, routing over the global sequence) has the
  JAX package's loss on that mesh at rtol 1e-5, at the default capacity
  factor and at one that drops tokens.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as JT
from tony_tpu.parallel import sharding as JS
from tony_tpu.parallel.mesh import make_mesh
from tony_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from tony_tpu_torch import tree_leaves, tree_map
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy
from tony_tpu_torch.ops import attention as TA
from tony_tpu_torch.parallel import ring_attention as TR
from tony_tpu_torch.parallel import ulysses as TU
from tony_tpu_torch.parallel.sharding import attention_spec

from test_torch_distributed import Case, _flat, run_group

torch.set_num_threads(2)

JR = importlib.import_module("tony_tpu.parallel.ring_attention")
SHAPE = (2, 32, 4, 16)
MESHES = {"cp4": {"cp": 4}, "cp2_tp2": {"cp": 2, "tp": 2}}


def _inputs(kv_heads: int, seed: int = 0):
    r = np.random.RandomState(seed)
    b, s, h, d = SHAPE
    return (r.randn(b, s, h, d).astype(np.float32),
            r.randn(b, s, kv_heads, d).astype(np.float32),
            r.randn(b, s, kv_heads, d).astype(np.float32),
            r.randn(b, s, h, d).astype(np.float32))


def _jax_run(strategy, axes, causal, q, k, v, do):
    fn = JR.ring_attention if strategy == "ring" else jax_ulysses
    mesh = make_mesh(axes, devices=jax.devices()[:4])

    @jax.jit
    def run(q, k, v, do):
        o, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, mesh, causal=causal),
                         q, k, v)
        return (o,) + vjp(do)

    return [np.asarray(x) for x in run(q, k, v, do)]


def _port_run(strategy, axes, causal, q, k, v, do):
    fn = TR.ring_attention if strategy == "ring" else TU.ulysses_attention
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v, axes, causal=causal)
    grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(do))
    return [o.detach().numpy()] + [g.numpy() for g in grads]


def _assert_match(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape       # dK/dV stay kv_heads wide
        np.testing.assert_allclose(g, w, atol=5e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv_heads", [4, 2, 1])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_dense_engine_matches_jax(strategy, mesh, kv_heads, causal):
    args = _inputs(kv_heads)
    _assert_match(_port_run(strategy, MESHES[mesh], causal, *args),
                  _jax_run(strategy, MESHES[mesh], causal, *args))


@pytest.mark.parametrize("strategy,mesh,kv_heads,causal", [
    ("ring", "cp4", 2, True),
    ("ring", "cp2_tp2", 4, False),
    ("ulysses", "cp2_tp2", 2, True),
    ("ulysses", "cp4", 4, False),
])
def test_flash_engine_matches_jax(strategy, mesh, kv_heads, causal,
                                  monkeypatch):
    """The flash arm, forced on in both packages: the port's hops run the
    kernels' plain versions and merge by logsumexp (a non-zero lse
    cotangent in the backward), the JAX hops its Pallas kernels in
    interpret mode."""
    monkeypatch.setattr(JR, "_USE_FLASH_CHUNKS", True)
    monkeypatch.setattr(TR, "_USE_FLASH_CHUNKS", True)
    args = _inputs(kv_heads, seed=1)
    _assert_match(_port_run(strategy, MESHES[mesh], causal, *args),
                  _jax_run(strategy, MESHES[mesh], causal, *args))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv_heads", [4, 1])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_flash_engine_matches_dense_engine(strategy, kv_heads, causal,
                                           monkeypatch):
    """The port's two per-chunk engines agree (f32, 2e-5 / 5e-5), at cp 4
    over a sequence that is not a power of two (the kernels take any
    chunk length)."""
    fn = TR.ring_attention if strategy == "ring" else TU.ulysses_attention
    r = np.random.RandomState(2)
    q, k, v, do = (torch.from_numpy(r.randn(*s).astype(np.float32))
                   for s in ((2, 36, 4, 16), (2, 36, kv_heads, 16),
                             (2, 36, kv_heads, 16), (2, 36, 4, 16)))
    runs = []
    for flash in (False, True):
        monkeypatch.setattr(TR, "_USE_FLASH_CHUNKS", flash)
        args = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = fn(*args, {"cp": 4}, causal=causal)
        runs.append([o.detach().numpy()] + [
            g.numpy() for g in torch.autograd.grad(o, args, do)])
    _assert_match(runs[1], runs[0])


@pytest.mark.parametrize("strategy,axes,kv_heads,want", [
    ("ring", {"cp": 4}, 2, 2),            # rides the ring unexpanded
    ("ring", {"cp": 2, "tp": 2}, 2, 1),   # one kv head per tp shard
    ("ring", {"cp": 2, "tp": 2}, 1, 2),   # 1 % tp: expanded first
    ("ulysses", {"cp": 2}, 2, 2),         # splits over cp: unexpanded
    ("ulysses", {"cp": 2, "tp": 2}, 2, 2),  # 2 % (tp·cp): expanded
])
def test_gqa_kv_widths_follow_the_jax_rules(strategy, axes, kv_heads, want,
                                            monkeypatch):
    """The kv heads each rank's body receives (before Ulysses' head
    split): unexpanded exactly where the JAX wrappers keep K/V so."""
    seen = []
    if strategy == "ring":
        orig = TR.ring_attention_emulated
        monkeypatch.setattr(TR, "ring_attention_emulated", lambda qs, ks, vs,
                            **kw: seen.append(ks[0].shape[2]) or orig(
                                qs, ks, vs, **kw))
    else:
        orig = TU.ulysses_attention_emulated
        monkeypatch.setattr(TU, "ulysses_attention_emulated",
                            lambda qs, ks, vs, **kw: seen.append(
                                ks[0].shape[2]) or orig(qs, ks, vs, **kw))
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(kv_heads))
    fn = TR.ring_attention if strategy == "ring" else TU.ulysses_attention
    fn(q, k, v, axes)
    assert set(seen) == {want}


def test_ulysses_head_split_and_kv_divisibility_raise():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(4))
    with pytest.raises(ValueError, match="n_heads=3 not divisible"):
        TU.ulysses_attention(q[:, :, :3], k[:, :, :3], v[:, :, :3],
                             {"cp": 2})
    with pytest.raises(ValueError, match="kv heads"):
        TU.ulysses_attention_emulated(list(q.chunk(2, 1)),
                                      list(k[:, :, :1].chunk(2, 1)),
                                      list(v[:, :, :1].chunk(2, 1)))
    with pytest.raises(ValueError, match="divide"):
        TR.ring_attention(q, k[:, :, :3], v[:, :, :3], {"cp": 2})


@pytest.mark.parametrize("axes", [{"cp": 4}, {"dp": 2, "cp": 4},
                                  {"fsdp": 2, "cp": 2, "tp": 2},
                                  {"dp": 8}, {"cp": 1, "tp": 2}])
def test_attention_spec_names_the_jax_axes(axes):
    jmesh = make_mesh(axes, devices=jax.devices()[:int(np.prod(
        list(axes.values())))])
    spec, s_live = JS.attention_spec(jmesh, ("dp", "fsdp"), "cp", "tp")
    b, s, h = attention_spec(axes, ("dp", "fsdp"), "cp", "tp")
    want_b = spec[0] if isinstance(spec[0], tuple) else (
        () if spec[0] is None else (spec[0],))
    assert (b, s, h) == (want_b, spec[1], spec[2])
    assert s == s_live


# -- the emulation against the distributed bodies -----------------------

ATTN_CASES = [
    Case("attn_cp2", 2, {"cp": 2}, model="attn", kw={"kv_heads": 2}),
    Case("attn_cp4", 4, {"cp": 4}, model="attn", kw={"kv_heads": 2}),
    Case("attn_dp2_cp2", 4, {"dp": 2, "cp": 2}, model="attn",
         kw={"kv_heads": 4}),
]


def _attn_setup(case):
    r = np.random.RandomState(3)
    b, s, h, d = 4, 16, 4, 8
    hk = case.kw["kv_heads"]
    return None, None, {}, {
        "q": r.randn(b, s, h, d).astype(np.float32),
        "k": r.randn(b, s, hk, d).astype(np.float32),
        "v": r.randn(b, s, hk, d).astype(np.float32),
        "do": r.randn(b, s, h, d).astype(np.float32)}


@pytest.fixture(scope="module")
def attn_groups(tmp_path_factory):
    done = {}

    def get(world):
        if world not in done:
            try:
                done[world] = run_group(
                    [c for c in ATTN_CASES if c.world == world], world,
                    tmp_path_factory.mktemp(f"attn{world}"),
                    setup=_attn_setup)
            except RuntimeError as e:
                done[world] = e
        if isinstance(done[world], Exception):
            pytest.fail(str(done[world]))
        return done[world]
    return get


def _emulated(case, engine, strategy, causal, monkeypatch):
    """Every rank's (o, dq, dk, dv) of the emulation: ranks of one data
    shard emulated together, their rows cut as ``Layout.local`` cuts
    them."""
    monkeypatch.setattr(TR, "_USE_FLASH_CHUNKS", engine == "flash")
    data = _attn_setup(case)[3]
    dp, cp = case.axes.get("dp", 1), case.axes["cp"]
    q, k, v, do = (torch.from_numpy(data[n]) for n in ("q", "k", "v", "do"))
    per_rank = {}
    for d_rank, rows in enumerate(zip(*(x.chunk(dp, 0)
                                        for x in (q, k, v, do)))):
        qr, kr, vr, dor = rows
        ins = [x.clone().requires_grad_(True) for x in (qr, kr, vr)]
        chunks = [list(x.chunk(cp, 1)) for x in ins]
        if strategy == "ring":
            outs = TR.ring_attention_emulated(*chunks, causal=causal)
        else:
            ks, vs = zip(*(TR.expand_kv_unless(a, b, q.shape[2], cp)
                           for a, b in zip(chunks[1], chunks[2])))
            outs = TU.ulysses_attention_emulated(chunks[0], list(ks),
                                                 list(vs), causal=causal)
        o = torch.cat(outs, 1)
        grads = torch.autograd.grad(o, ins, dor)
        for c in range(cp):
            sl = slice(c * o.shape[1] // cp, (c + 1) * o.shape[1] // cp)
            per_rank[d_rank * cp + c] = [o[:, sl].detach().numpy()] + [
                g[:, sl].numpy() for g in grads]
    return per_rank


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c.name for c in ATTN_CASES])
def test_emulation_equals_the_distributed_body(case, attn_groups,
                                               monkeypatch):
    outs = attn_groups(case.world)[case.name]
    for engine in ("dense", "flash"):
        for strategy in ("ring", "ulysses"):
            for causal in (True, False):
                key = f"{engine}/{strategy}/{int(causal)}"
                want = _emulated(case, engine, strategy, causal,
                                 monkeypatch)
                for rank, o in enumerate(outs):
                    got = [o[f"{key}/{n}"] for n in ("o", "dq", "dk", "dv")]
                    for g, w in zip(got, want[rank]):
                        np.testing.assert_array_equal(g, w, key)


# -- the remat policies ---------------------------------------------------

def _lm_batch(cfg):
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 33))
    return {"inputs": toks[:, :32], "targets": toks[:, 1:]}


def _port_loss_and_grads(params, batch, cfg):
    """(loss, {leaf path: gradient})."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = TT.lm_loss(params, {k: torch.from_numpy(v).long()
                                   for k, v in batch.items()}, cfg)
        grads = iter(torch.autograd.grad(loss, leaves))
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return float(loss.detach()), _flat(tree_map(
        lambda _: next(grads).numpy(), params))


@pytest.fixture(scope="module")
def remat_setup():
    jcfg = JT.PRESETS["tiny"].scaled(dtype=jnp.float32)
    jp = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
    tcfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32)
    batch = _lm_batch(tcfg)
    full = _port_loss_and_grads(params_from_numpy(jp, device="cpu"), batch,
                                tcfg)
    return jcfg, jp, tcfg, batch, full


@pytest.mark.parametrize("policy", ["dots", "attn"])
def test_remat_policy_matches_full_and_jax(policy, remat_setup,
                                           monkeypatch):
    jcfg, jp, tcfg, batch, (l_full, g_full) = remat_setup
    calls = []
    orig = TA._dense_with_lse
    monkeypatch.setattr(TA, "_dense_with_lse",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    cfg = tcfg.scaled(remat_policy=policy)
    loss, grads = _port_loss_and_grads(params_from_numpy(jp, device="cpu"),
                                       batch, cfg)
    # the attention forward: once a layer under "attn" (the recompute
    # replays the kept o and lse), twice under the others
    assert len(calls) == cfg.n_layers * (1 if policy == "attn" else 2)
    np.testing.assert_allclose(loss, l_full, rtol=1e-6)
    for name, g in grads.items():
        np.testing.assert_allclose(g, g_full[name], atol=1e-6,
                                   err_msg=name)
    jc = jcfg.scaled(remat_policy=policy)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss, j_grads = jax.value_and_grad(lambda p: JT.lm_loss(p, jb, jc))(
        jax.tree.map(jnp.asarray, jp))
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-6)
    j_grads = _flat(jax.device_get(j_grads))
    assert set(j_grads) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, j_grads[name], atol=1e-6,
                                   err_msg=name)
    with pytest.raises(ValueError, match="remat_policy"):
        tcfg.scaled(remat_policy="bogus")
    with pytest.raises(ValueError, match="remat_policy"):
        tcfg.scaled(remat=False, remat_policy="bogus")


def test_forward_stash_records_then_replays_in_call_order():
    stash = TA.ForwardStash()
    made = []

    def compute(i):
        made.append(i)
        return torch.full((2,), float(i)), torch.full((1,), float(-i))

    stash.begin()
    first = [stash(lambda i=i: compute(i)) for i in range(3)]
    for replay in range(2):
        stash.begin()
        again = [stash(lambda i=i: compute(10 + i)) for i in range(3)]
        assert made == [0, 1, 2]          # nothing computed again
        for a, b in zip(first, again):
            assert all(torch.equal(x, y) and x is not y
                       for x, y in zip(a, b))


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_forward_stash_replays_every_hop_in_the_recompute(strategy,
                                                          monkeypatch):
    """The "attn" policy's record over a whole cp body (the flash engine,
    4 emulated ranks) under ``torch.utils.checkpoint``: the attention
    forward runs once per launched hop (10 for the causal ring, 4 for
    Ulysses), not again in the recompute, and the gradients equal the
    uncheckpointed body's bit for bit."""
    monkeypatch.setattr(TR, "_USE_FLASH_CHUNKS", True)
    calls = []
    orig = TA._dense_with_lse
    monkeypatch.setattr(TA, "_dense_with_lse",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    fn = (TR.ring_attention_emulated if strategy == "ring"
          else TU.ulysses_attention_emulated)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(4))

    def body(q, k, v, stash=None):
        if stash is not None:
            stash.begin()
        outs = fn(*(list(x.chunk(4, dim=1)) for x in (q, k, v)),
                  causal=True, stash=stash)
        return torch.cat(outs, dim=1)

    runs = []
    for remat in (False, True):
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        calls.clear()
        if remat:
            stash = TA.ForwardStash()
            o = torch.utils.checkpoint.checkpoint(
                lambda *a: body(*a, stash), *ins, use_reentrant=False)
        else:
            o = body(*ins)
        grads = torch.autograd.grad(o, ins, do)
        runs.append((len(calls), o.detach(), grads))
    assert runs[0][0] == runs[1][0] == (10 if strategy == "ring" else 4)
    assert torch.equal(runs[0][1], runs[1][1])
    for a, b in zip(runs[0][2], runs[1][2]):
        assert torch.equal(a, b)


def test_window_and_moe_with_cp_raise():
    cfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32)
    toks = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="attn_window"):
        TT.forward({}, toks, cfg.scaled(attn_window=4),
                   mesh={"dp": 1, "cp": 2})
    # MoE with cp is ported: the JAX package's loss on the same mesh
    mesh = make_mesh({"dp": 1, "cp": 2}, devices=jax.devices()[:2])
    for cf in (1.25, 0.5):
        jcfg = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, num_experts=4,
                                         moe_capacity_factor=cf)
        jp = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
        batch = _lm_batch(cfg)
        sp = JS.shard_pytree(jax.tree.map(jnp.asarray, jp),
                             JT.logical_axes(jcfg), mesh)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with jax.set_mesh(mesh):
            jl = float(jax.jit(lambda p, b: JT.lm_loss(p, b, jcfg, mesh))(
                sp, jb))
        tl = TT.lm_loss(params_from_numpy(jp, device="cpu"),
                        {k: torch.from_numpy(v).long()
                         for k, v in batch.items()},
                        cfg.scaled(num_experts=4, moe_capacity_factor=cf),
                        mesh={"dp": 1, "cp": 2})
        np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    with pytest.raises(ValueError, match="cp_strategy"):
        TT._attention(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 8),
                      torch.zeros(1, 4, 4, 8), "ulyses")
