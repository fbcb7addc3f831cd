"""tony_tpu_torch's pipeline parallelism (GPipe and 1F1B over ``pp``)
against the JAX package's, and its single-process emulation against its
distributed bodies.

- The schedules on ``tests/test_parallel.py``'s toy stage problem
  (``tanh(h @ W[s] + b[s])``) against ``tony_tpu.parallel.pipeline`` on
  ``{"pp": 4, "dp": 2}`` and ``{"pp": 2, "dp": 4}`` (the conftest's 8
  virtual CPU devices), f32: outputs within atol 1e-6, gradients within
  atol 1e-5 (the bounds ``tests/test_parallel.py`` holds the reference
  to); the degenerate path (no pp axis) and the invalid cases held as
  there.
- The emulation (every rank in one process) against the distributed
  bodies in gloo groups (``tests/torch_dist_worker.py``'s ``pipe``
  cases) at world 2 and 4 on ``{"pp": 2}``, ``{"pp": 4}``, ``{"pp": 2,
  "dp": 2}`` and ``{"pp": 2, "tp": 2}``: every rank's outputs and
  gradients equal it bit for bit, for both schedules.
- The ``tiny`` LM scaled to 4 layers, f32: ``forward`` on pp 2 and pp 4
  against the JAX forward, ``lm_value_and_grad`` against the JAX 1F1B
  (loss rtol 1e-5, every gradient leaf atol 3e-5, ``tests/
  test_parallel.py``'s bounds), 1F1B against GPipe (loss rtol 1e-6,
  grads atol 3e-5), both against the unpipelined port; MoE with
  replicated experts under 1F1B against GPipe; ``{"pp": 2, "cp": 2}``
  (cp replicated inside the pipeline) with ``{"pp": 2}``'s loss bit for
  bit and its gradients to 1e-7 under both schedules, and the JAX
  package's loss on that mesh.
- The remat policies ``"dots"`` and ``"attn"`` inside a stage against
  ``"full"``, under both schedules.
- 5-step sharded trajectories against the JAX package's on the same
  mesh (``test_torch_distributed.py``'s bounds): world 2 on ``{"pp":
  2}`` under GPipe and 1F1B, world 4 on ``{"pp": 2, "tp": 2}`` under
  1F1B (the vocab-sharded head) and MoE under GPipe on ``{"pp": 2,
  "ep": 2}`` (the experts split over ep inside a stage); a pp
  checkpoint saved by one group at step 2 resumes in a new one.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import train as JTR
from tony_tpu.models import transformer as JT
from tony_tpu.parallel import pipeline as JP
from tony_tpu.parallel import shard_pytree as jax_shard_pytree
from tony_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tony_tpu_torch import tree_leaves
from tony_tpu_torch.models import train as TR
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy
from tony_tpu_torch.parallel import pipeline as P

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_distributed as TD  # noqa: E402

torch.set_num_threads(2)

S4, B, D, M = 4, 16, 16, 4


@pytest.fixture(scope="module")
def toy():
    r = np.random.RandomState(1)
    return dict(W=(r.randn(S4, D, D) * 0.1).astype(np.float32),
                b=(r.randn(S4, D) * 0.1).astype(np.float32),
                x=r.randn(B, D).astype(np.float32),
                tgt=r.randn(B, D).astype(np.float32),
                wo=(r.randn(D, D) * 0.2).astype(np.float32),
                cot=r.randn(B, D).astype(np.float32))


def _jstage(p, h):
    w, b = p
    return jnp.tanh(h @ w + b)


def _jhead(hp, out, tgt):
    return jnp.mean((out @ hp["wo"] - tgt) ** 2)


def _tstage(p, h):
    w, b = p
    return torch.tanh(h @ w + b)


def _thead(hp, out, tgt):
    return torch.mean((out @ hp["wo"] - tgt) ** 2)


def _jaux_stage(p, h):
    out = _jstage(p, h)
    return out, jnp.mean(out ** 2)


def _taux_stage(p, h):
    out = _tstage(p, h)
    return out, torch.mean(out ** 2)


AXES = [{"pp": 4, "dp": 2}, {"pp": 2, "dp": 4}]


def _ids(axes):
    return "_".join(f"{k}{v}" for k, v in axes.items())


@pytest.mark.parametrize("axes", AXES, ids=_ids)
@pytest.mark.parametrize("with_aux", [False, True], ids=["plain", "aux"])
def test_gpipe_matches_jax(toy, axes, with_aux):
    s = axes["pp"]
    W, b, x, cot = toy["W"][:s], toy["b"][:s], toy["x"], toy["cot"]
    mesh = jax_make_mesh(axes)
    jstage = _jaux_stage if with_aux else _jstage

    def jloss(W, b):
        res = JP.pipeline_apply(jstage, (W, b), jnp.asarray(x), mesh,
                                num_microbatches=M, with_aux=with_aux)
        out, aux = res if with_aux else (res, 0.0)
        return (out * cot).sum() + aux, res
    (_, jres), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(W), jnp.asarray(b))
    tW, tb = (torch.tensor(a, requires_grad=True) for a in (W, b))
    res = P.pipeline_apply(_taux_stage if with_aux else _tstage, (tW, tb),
                           torch.tensor(x), axes, num_microbatches=M,
                           with_aux=with_aux)
    out, aux = res if with_aux else (res, 0.0)
    tg = torch.autograd.grad((out * torch.tensor(cot)).sum() + aux,
                             (tW, tb))
    jout = jres[0] if with_aux else jres
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-6)
    if with_aux:
        np.testing.assert_allclose(float(aux.detach()), float(jres[1]),
                                   atol=1e-6)
    for a, w in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-5)


@pytest.mark.parametrize("axes", AXES, ids=_ids)
def test_1f1b_matches_jax(toy, axes):
    s = axes["pp"]
    W, b = toy["W"][:s], toy["b"][:s]
    jl, jgs, jgh, jdx = JP.pipeline_value_and_grad(
        _jstage, (jnp.asarray(W), jnp.asarray(b)), jnp.asarray(toy["x"]),
        {"wo": jnp.asarray(toy["wo"])}, jnp.asarray(toy["tgt"]),
        jax_make_mesh(axes), loss_head=_jhead, num_microbatches=M)
    tl, tgs, tgh, tdx = P.pipeline_value_and_grad(
        _tstage, (torch.tensor(W), torch.tensor(b)), torch.tensor(toy["x"]),
        {"wo": torch.tensor(toy["wo"])}, torch.tensor(toy["tgt"]), axes,
        loss_head=_thead, num_microbatches=M)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-6)
    for a, w in zip(tgs, jgs):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-5)
    np.testing.assert_allclose(tgh["wo"].numpy(), jgh["wo"], atol=1e-5)
    np.testing.assert_allclose(tdx.numpy(), jdx, atol=1e-5)


def test_degenerate_no_pp_axis_matches_jax(toy):
    """Without a pp axis GPipe runs the stages in turn and 1F1B is plain
    autograd over the microbatches, as in the reference."""
    mesh = jax_make_mesh({"dp": 8})
    W, b, x = toy["W"], toy["b"], toy["x"]
    jout = JP.pipeline_apply(_jstage, (jnp.asarray(W), jnp.asarray(b)),
                             jnp.asarray(x), mesh, num_microbatches=2)
    tout = P.pipeline_apply(_tstage, (torch.tensor(W), torch.tensor(b)),
                            torch.tensor(x), {"dp": 8}, num_microbatches=2)
    np.testing.assert_allclose(tout.numpy(), jout, atol=1e-6)
    jl, jgs, jgh, jdx = JP.pipeline_value_and_grad(
        _jstage, (jnp.asarray(W), jnp.asarray(b)), jnp.asarray(x),
        {"wo": jnp.asarray(toy["wo"])}, jnp.asarray(toy["tgt"]), mesh,
        loss_head=_jhead, num_microbatches=2)
    tl, tgs, tgh, tdx = P.pipeline_value_and_grad(
        _tstage, (torch.tensor(W), torch.tensor(b)), torch.tensor(x),
        {"wo": torch.tensor(toy["wo"])}, torch.tensor(toy["tgt"]),
        {"dp": 8}, loss_head=_thead, num_microbatches=2)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-6)
    for a, w in zip(list(tgs) + [tgh["wo"], tdx],
                    list(jgs) + [jgh["wo"], jdx]):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-5)


def _both(toy, axes, m, s=S4):
    W, b = torch.tensor(toy["W"][:s]), torch.tensor(toy["b"][:s])
    x, tgt = torch.tensor(toy["x"]), torch.tensor(toy["tgt"])
    yield lambda: P.pipeline_apply(_tstage, (W, b), x, axes,
                                   num_microbatches=m)
    yield lambda: P.pipeline_value_and_grad(
        _tstage, (W, b), x, {"wo": torch.tensor(toy["wo"])}, tgt, axes,
        loss_head=_thead, num_microbatches=m)


@pytest.mark.parametrize("axes", [{"pp": 4, "dp": 2}, {"dp": 8}],
                         ids=_ids)
def test_indivisible_microbatches_raises(toy, axes):
    for run in _both(toy, axes, 3):
        with pytest.raises(ValueError, match="not divisible"):
            run()


def test_stage_count_mismatch_raises(toy):
    for run in _both(toy, {"pp": 2, "dp": 4}, 4):
        with pytest.raises(ValueError, match="stacked stages"):
            run()


def test_schedule_closed_form_covers_every_microbatch():
    """Every stage forwards and backwards each microbatch once, a
    backward after its forward, and each activation arrives before the
    tick that consumes it (the reference's closed form)."""
    for S in (2, 3, 4):
        for m in (1, 2, 4, 7):
            T = 2 * m + 2 * S - 2
            for s in range(S):
                f = {P._fwd_sched(s, t, S, m): t for t in range(T)
                     if P._fwd_sched(s, t, S, m) is not None}
                bw = {P._bwd_sched(s, t, S, m): t for t in range(T)
                      if P._bwd_sched(s, t, S, m) is not None}
                assert sorted(f) == sorted(bw) == list(range(m))
                assert all(f[i] < bw[i] for i in range(m))
                if s > 0:
                    prev = {P._fwd_sched(s - 1, t, S, m): t
                            for t in range(T)
                            if P._fwd_sched(s - 1, t, S, m) is not None}
                    assert all(prev[i] < f[i] for i in range(m))


# ---------------------------------------------------------------------------
# the emulation against the distributed bodies, bit for bit
# ---------------------------------------------------------------------------
PIPE_CASES = [
    TD.Case("pipe_pp2", 2, {"pp": 2}, model="pipe", kw={"m": M}),
    TD.Case("pipe_pp4", 4, {"pp": 4}, model="pipe", kw={"m": M}),
    TD.Case("pipe_pp2_dp2", 4, {"pp": 2, "dp": 2}, model="pipe",
            kw={"m": M}),
    TD.Case("pipe_pp2_tp2", 4, {"pp": 2, "tp": 2}, model="pipe",
            kw={"m": M}),
]


def _pipe_setup(toy, case):
    return None, None, {}, {k: v for k, v in toy.items()}


STEPS = 5


def _lm_kw(case):
    return {k: v for k, v in case.kw.items() if k != "pp_schedule"}


LM_CASES = [
    TD.Case("pp2", 2, {"pp": 2}, steps=STEPS),
    TD.Case("pp2_1f1b", 2, {"pp": 2}, kw={"pp_schedule": "1f1b"},
            steps=STEPS),
    TD.Case("pp2_tp2_1f1b", 4, {"pp": 2, "tp": 2},
            kw={"pp_schedule": "1f1b"}, steps=STEPS),
    TD.Case("pp2_ep2", 4, {"pp": 2, "ep": 2}, kw={"num_experts": 4},
            steps=STEPS),
]


@functools.lru_cache(maxsize=None)
def _lm_setup_cached(kw: tuple):
    """``test_torch_distributed``'s ``tiny`` LM and seed, with STEPS
    steps of 4 × 32 batches."""
    model = dict(kw)
    jcfg = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, **model)
    tcfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, **model)
    jp = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
    toks = np.random.RandomState(15).randint(
        0, jcfg.vocab_size,
        size=(STEPS, TD.BATCH, TD.SEQ + 1)).astype(np.int32)
    batches = {"inputs": toks[:, :, :TD.SEQ], "targets": toks[:, :, 1:]}
    return jcfg, tcfg, jp, batches


def _lm_setup(case):
    return _lm_setup_cached(tuple(sorted(case.kw.items())))


@pytest.fixture(scope="module")
def groups(tmp_path_factory, toy):
    """``get(world)``: the pipe and LM cases of that world size, run in
    one gloo group the first time they are asked for."""
    done: dict = {}

    def setup(case):
        return _pipe_setup(toy, case) if case.model == "pipe" \
            else _lm_setup(case)

    def get(world):
        if world not in done:
            cases = [c for c in PIPE_CASES + LM_CASES if c.world == world]
            try:
                done[world] = TD.run_group(
                    cases, world, tmp_path_factory.mktemp(f"pp{world}"),
                    setup=setup)
            except RuntimeError as e:
                done[world] = e
        if isinstance(done[world], Exception):
            pytest.fail(str(done[world]))
        return done[world]
    return get


def _shard(a, m, d, k):
    xs = a.reshape((m, a.shape[0] // m) + a.shape[1:])
    n = xs.shape[1] // d
    return xs[:, k * n:(k + 1) * n]


@pytest.mark.parametrize("case", PIPE_CASES, ids=[c.name for c in PIPE_CASES])
def test_emulation_equals_distributed_bodies(toy, case, groups):
    outs = groups(case.world)[case.name]
    S, d = case.axes["pp"], case.axes.get("dp", 1)
    W, b = torch.tensor(toy["W"][:S]), torch.tensor(toy["b"][:S])
    # GPipe: each data shard emulated alone, as its ranks ran it
    for o in outs:
        s, k = int(o["pp_rank"]), int(o["data_rank"])
        tW = W.clone().requires_grad_(True)
        tb = b.clone().requires_grad_(True)
        xs = torch.tensor(_shard(toy["x"], M, d, k)).requires_grad_(True)
        out = P.pipeline_apply(_tstage, (tW, tb), xs.reshape(-1, D),
                               {"pp": S}, num_microbatches=M)
        cot = torch.tensor(_shard(toy["cot"], M, d, k)).reshape(-1, D)
        gW, gb, gx = torch.autograd.grad((out * cot).sum(), (tW, tb, xs))
        assert np.array_equal(o["gpipe/out"].reshape(-1, D),
                              out.detach().numpy())
        assert np.array_equal(o["gpipe/dW"], gW[s].numpy()), s
        assert np.array_equal(o["gpipe/db"], gb[s].numpy()), s
        assert np.array_equal(o["gpipe/dx"], gx.numpy()), s
        assert np.array_equal(o["gpipe_params_only/dW"], gW[s].numpy()), s
        assert np.array_equal(o["gpipe_params_only/db"], gb[s].numpy()), s
    # 1F1B: the data shards emulated together, averaged as the ranks do
    loss, gs, gh, dx = P.pipeline_value_and_grad(
        _tstage, (W, b), torch.tensor(toy["x"]),
        {"wo": torch.tensor(toy["wo"])}, torch.tensor(toy["tgt"]),
        {"pp": S, "dp": d}, loss_head=_thead, num_microbatches=M)
    for o in outs:
        s, k = int(o["pp_rank"]), int(o["data_rank"])
        assert np.array_equal(o["1f1b/loss"], loss.numpy())
        assert np.array_equal(o["1f1b/dW"], gs[0][s].numpy()), s
        assert np.array_equal(o["1f1b/db"], gs[1][s].numpy()), s
        assert np.array_equal(o["1f1b/dwo"], gh["wo"].numpy())
        assert np.array_equal(o["1f1b/dxs"],
                              _shard(dx.numpy(), M, d, k)), s


# ---------------------------------------------------------------------------
# the LM, emulated, against the JAX package
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lm(**kw):
    jcfg = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, n_layers=4, **kw)
    tcfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, n_layers=4, **kw)
    jp = jax.device_get(JT.init_params(jax.random.PRNGKey(3), jcfg))
    toks = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, size=(16, 33)).astype(np.int32)
    return jcfg, tcfg, jp, {"inputs": toks[:, :32], "targets": toks[:, 1:]}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _grads(tcfg, params, batch, mesh):
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = TT.lm_loss(params, batch, tcfg, mesh)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return float(loss.detach()), grads


@pytest.mark.parametrize("axes", AXES, ids=_ids)
def test_lm_forward_matches_jax(axes):
    jcfg, tcfg, jp, batch = _lm()
    mesh = jax_make_mesh(axes)
    sp = jax_shard_pytree(jp, JT.logical_axes(jcfg), mesh)
    jl = jax.jit(lambda p, b: JT.forward(p, b, jcfg, mesh)[0])(
        sp, jnp.asarray(batch["inputs"]))
    with torch.no_grad():
        tl = TT.forward(params_from_numpy(jp, device="cpu"),
                        _tbatch(batch)["inputs"], tcfg, axes)[0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-5)


@pytest.mark.parametrize("axes", AXES, ids=_ids)
def test_lm_1f1b_matches_jax_and_gpipe(axes):
    jcfg, tcfg, jp, batch = _lm()
    mesh = jax_make_mesh(axes)
    sp = jax_shard_pytree(jp, JT.logical_axes(jcfg), mesh)
    with jax.set_mesh(mesh):
        jl, jg = jax.jit(lambda p, b: JT.lm_value_and_grad(
            p, b, jcfg, mesh))(sp, batch)
    params = params_from_numpy(jp, device="cpu")
    tb = _tbatch(batch)
    tl, tg = TT.lm_value_and_grad(params, tb, tcfg, axes)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    flat, _ = jax.tree_util.tree_flatten_with_path(jg)
    for (path, a), g in zip(flat, tree_leaves(tg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), atol=3e-5,
                                   err_msg=str(path))
    # GPipe on the same mesh, and the unpipelined port
    for mesh_ in (axes, None):
        gl, gg = _grads(tcfg, params, tb, mesh_)
        np.testing.assert_allclose(float(tl), gl,
                                   rtol=1e-6 if mesh_ else 1e-5)
        for a, g in zip(gg, tree_leaves(tg)):
            np.testing.assert_allclose(g.numpy(), a.numpy(), atol=3e-5)


@pytest.mark.parametrize("policy", ["dots", "attn"])
def test_lm_remat_policies_inside_a_stage(policy):
    """A stage's blocks run under the config's remat policy: both
    schedules' loss and gradients under ``policy`` equal "full"'s."""
    _, tcfg, jp, batch = _lm()
    params = params_from_numpy(jp, device="cpu")
    tb = _tbatch(batch)
    pcfg = tcfg.scaled(remat_policy=policy)
    for mesh in ({"pp": 2}, {"pp": 4}):
        fl, fg = TT.lm_value_and_grad(params, tb, tcfg, mesh)
        pl, pg = TT.lm_value_and_grad(params, tb, pcfg, mesh)
        gl, gg = _grads(pcfg, params, tb, mesh)
        np.testing.assert_allclose(float(pl), float(fl), rtol=1e-6)
        np.testing.assert_allclose(gl, float(fl), rtol=1e-6)
        for a, b, c in zip(tree_leaves(fg), tree_leaves(pg), gg):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)
            np.testing.assert_allclose(c.numpy(), a.numpy(), atol=1e-6)


def test_lm_1f1b_moe_replicated_experts_matches_gpipe():
    _, tcfg, jp, batch = _lm(num_experts=4)
    params = params_from_numpy(jp, device="cpu")
    tb = _tbatch(batch)
    tl, tg = TT.lm_value_and_grad(params, tb, tcfg, {"pp": 2})
    gl, gg = _grads(tcfg, params, tb, {"pp": 2})
    np.testing.assert_allclose(float(tl), gl, rtol=1e-6)
    for a, g in zip(gg, tree_leaves(tg)):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=3e-5)


def test_lm_1f1b_refuses_live_ep():
    _, tcfg, jp, batch = _lm(num_experts=4)
    with pytest.raises(NotImplementedError, match="REPLICATED"):
        TT.lm_value_and_grad(params_from_numpy(jp, device="cpu"),
                             _tbatch(batch), tcfg,
                             {"pp": 2, "ep": 2, "dp": 2})


def test_lm_pp_with_cp_raises():
    """pp × cp is ported: cp replicates inside the pipeline, as in the
    reference (whose stage body runs unsharded in cp). GPipe and 1F1B on
    the emulated ``{"pp": 2, "cp": 2}`` have ``{"pp": 2}``'s loss bit for
    bit and its gradients to rounding (the embedding's backward adds
    repeated rows in a thread-dependent order on the CPU), and the JAX
    package's loss on that mesh at rtol 1e-5."""
    jcfg, tcfg, jp, batch = _lm()
    params = params_from_numpy(jp, device="cpu")
    tb = _tbatch(batch)
    mesh = jax_make_mesh({"pp": 2, "cp": 2}, devices=jax.devices()[:4])
    sp = jax_shard_pytree(jp, JT.logical_axes(jcfg), mesh)
    with jax.set_mesh(mesh):
        jl = float(jax.jit(lambda p, b: JT.lm_loss(p, b, jcfg, mesh))(
            sp, batch))
    for cfg in (tcfg, tcfg.scaled(pp_schedule="1f1b")):
        if cfg.pp_schedule == "1f1b":
            got = TT.lm_value_and_grad(params, tb, cfg, {"pp": 2, "cp": 2})
            want = TT.lm_value_and_grad(params, tb, cfg, {"pp": 2})
            loss = float(got[0])
            pairs = zip(tree_leaves(got[1]), tree_leaves(want[1]))
        else:
            got = _grads(cfg, params, tb, {"pp": 2, "cp": 2})
            want = _grads(cfg, params, tb, {"pp": 2})
            loss = got[0]
            pairs = zip(got[1], want[1])
        assert loss == float(want[0])
        for a, b in pairs:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)
        np.testing.assert_allclose(loss, jl, rtol=1e-5)


def test_lm_stages_must_split_the_layers():
    _, tcfg, jp, batch = _lm()
    with pytest.raises(ValueError, match="pipeline stages"):
        TT.lm_loss(params_from_numpy(jp, device="cpu"), _tbatch(batch),
                   tcfg, {"pp": 3})


def test_lm_degenerate_1f1b_is_the_unpipelined_step():
    _, tcfg, jp, batch = _lm()
    params = params_from_numpy(jp, device="cpu")
    tl, tg = TT.lm_value_and_grad(params, _tbatch(batch), tcfg, {"dp": 1})
    gl, gg = _grads(tcfg, params, _tbatch(batch), None)
    assert float(tl) == gl
    # the embedding's backward adds repeated rows in a thread-dependent
    # order on the CPU: two runs of the same step agree to rounding
    for a, g in zip(gg, tree_leaves(tg)):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=1e-7)


# ---------------------------------------------------------------------------
# sharded trajectories in gloo groups against the JAX package
# ---------------------------------------------------------------------------
def _jax_pp_trajectory(case):
    jcfg, _, jp, batches = _lm_setup(case)
    mesh = jax_make_mesh(TD._axes(case), devices=jax.devices()[:case.world])
    params = jax_shard_pytree(jax.tree.map(jnp.asarray, jp),
                              JT.logical_axes(jcfg), mesh)
    opt = JTR.default_optimizer(**TD.OPT)
    state = JTR.init_state(params, opt)
    vag = None
    if jcfg.pp_schedule == "1f1b":
        def vag(p, b):
            return JT.lm_value_and_grad(p, b, jcfg, mesh)
    step = JTR.make_train_step(
        None if vag else (lambda p, b: JT.lm_loss(p, b, jcfg, mesh)), opt,
        mesh, donate=False, value_and_grad_fn=vag)
    got = []
    for i in range(case.steps):
        with jax.set_mesh(mesh):
            state, m = step(state, {k: jnp.asarray(v[i])
                                    for k, v in batches.items()})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    return np.array(got)


def _port_emulated(case, tcfg, jp, batches):
    """The port's 3 steps in one process on the case's pp axis alone
    (its ranks emulated): the params' reference, microbatched as the
    sharded run is (an MoE aux loss is a microbatch's)."""
    axes = {"pp": case.axes["pp"]}
    opt = TR.default_optimizer(**TD.OPT)
    state = TR.init_state(params_from_numpy(jp, device="cpu"), opt)
    if case.kw.get("pp_schedule") == "1f1b":
        step = TR.make_train_step(None, opt, value_and_grad_fn=lambda p, b:
                                  TT.lm_value_and_grad(p, b, tcfg, axes))
    else:
        step = TR.make_train_step(lambda p, b: TT.lm_loss(p, b, tcfg, axes),
                                  opt)
    for i in range(case.steps):
        state, _ = step(state, {k: torch.from_numpy(v[i]).long()
                                for k, v in batches.items()})
    return TD._flat(TD.params_to_numpy(state["params"]))


@pytest.mark.parametrize("case", LM_CASES, ids=[c.name for c in LM_CASES])
def test_pp_trajectory_matches_jax(case, groups):
    outs = groups(case.world)[case.name]
    jcfg, tcfg, jp, batches = _lm_setup(case)
    want = _jax_pp_trajectory(case)
    TD._check_case(outs, want, _port_emulated(case, tcfg, jp, batches),
                   jp, batches["inputs"][0])


def test_pp_checkpoint_resumes_in_a_new_group(groups, tmp_path):
    """A 1F1B pp state (blocks split over pp) saved at step 2 is restored
    by a new group and trains on: the first loss equals the
    uninterrupted run's bit for bit (the restored params are its
    params), and the params after the step are held at the trajectory
    bounds."""
    straight = groups(2)["pp2_1f1b"]
    kw = {"pp_schedule": "1f1b"}
    try:
        TD.run_group([TD.Case("ckpt_pp", 2, {"pp": 2}, kw=kw, steps=2,
                              ckpt="save")], 2, tmp_path, setup=_lm_setup)
        outs = TD.run_group([TD.Case("ckpt_pp", 2, {"pp": 2}, kw=kw,
                                     steps=STEPS, ckpt="resume")], 2,
                            tmp_path, setup=_lm_setup)["ckpt_pp"]
    except RuntimeError as e:
        pytest.fail(str(e))
    for o in outs:
        assert int(o["start"]) == 2 and int(o["count"]) == STEPS
        np.testing.assert_array_equal(o["loss"], straight[0]["loss"][2:])
    TD._assert_params_close(TD._gathered(outs[0], "p/"),
                            TD._gathered(straight[0], "p/"))
