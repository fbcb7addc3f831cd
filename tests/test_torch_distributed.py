"""tony_tpu_torch's sharded training across processes vs the JAX package's.

The cases of one world size run in turn in one gloo group of 2 or 4 CPU
processes (``tests/torch_dist_worker.py``), booted from the jax arm's
environment as the executor exports it, each on a mesh of its own; the
group runs under a time limit of its own, so a hang fails its cases
instead of eating the suite's clock, and the checkpoint case starts two
more groups. The JAX package runs the same mesh on the conftest's
virtual CPU devices (the first 2 or 4).
Both start from the JAX ``init_params`` (f32 ``tiny`` LM, ``BERT_TINY``)
and train on the same global batches (4 × 32), each port rank feeding its
rows through ``global_batch``:

- per-step loss and grad_norm against ``make_train_step(mesh=…)`` of the
  JAX package at rtol 1e-4 (the bound of
  ``test_torch_train.py::test_five_step_trajectory_matches_jax``), for
  dp, fsdp, tp (MHA, and GQA with kv_heads 2 and 1) and fsdp × tp at
  world 2 and 4, an MoE LM (4 experts) under ep, dp × ep and ep × tp,
  the LM under cp (ring and Ulysses; cp × tp, dp × cp, GQA with one kv
  head), MoE under cp (cp, dp × cp, ep × cp: routing over the global
  sequence), pp × cp under GPipe and 1F1B (cp replicated inside the
  pipeline), and BERT under fsdp, tp, cp and pp;
- for those last combinations, the dict mesh of the same sizes (every
  cp rank emulated in one process, the form one card runs) against the
  gloo group on the first batch: under pp × cp and BERT's pp the
  logits, the loss and every gradient bit for bit (the same arithmetic:
  cp replicates, BERT's pp gathers its blocks); under cp the logits bit
  for bit (the ranks' chunks are the emulation's rows, attention and
  the MoE cp arm the same bodies), the loss within rtol 1e-6 and the
  gradients within atol 1e-6 (the emulation sums over the whole
  sequence where each rank sums its chunk and the ranks add the parts);
  under ep × cp, whose experts the emulation does not split, the logits
  within the sharded forward's 2e-5 too;
- the final params, gathered to full arrays, against the port's
  unsharded step (that test's bounds: all but 1% of each leaf within
  1e-5, each leaf within 1e-3 in relative L2), and the gathered initial
  tree's ``tree_digest`` equal to the JAX tree's;
- the sharded ``forward``'s logits (a DTensor split by batch and vocab)
  against the unsharded forward to 2e-5;
- the global batch equal to the local shards concatenated in
  data-parallel rank order, and ``constrain`` replicating it;
- a sharded checkpoint saved at step 2 restored by a new group
  (``restore_or_init`` at attempt 1) resumes to the same params, bit for
  bit; an ep-sharded MoE checkpoint of world 2 restored by a group of 4
  on dp × ep resumes to the uninterrupted run's losses and params at
  the bounds above; a dp × cp checkpoint resumes bit for bit in a new
  group;
- an asynchronous sharded save (fsdp 2, shard writes slowed by the
  worker's injected delay) returns before its write ends and holds the
  state as it was when saved, though the next step writes into it in
  place; offers off the interval run no ``broadcast_object_list`` or
  ``barrier``; a write that fails on rank 1 commits nothing and raises
  on both ranks at the next save;
- hybrid (multi-slice) meshes, built by ``runtime.mesh(axes,
  dcn_axes=...)`` as a job with ``tony.application.mesh.dcn`` builds
  them: dp across 2 slices × tp inside (``{"tp": -1}`` × dcn ``{"dp":
  2}``) trains along the JAX package's ``make_train_step`` on its
  ``make_hybrid_mesh`` at rtol 1e-4 (the twin of
  ``tests/test_parallel.py::TestHybridMesh::test_train_step_over_hybrid_mesh``),
  and pp across the slices (``{"dp": -1}`` × dcn ``{"pp": 2}``, GPipe)
  has the unpipelined loss at rtol 1e-5 (the twin of
  ``test_pp_over_dcn``) and trains along the JAX hybrid mesh's step;
- the fused optimizer refuses a mesh, and experts that do not split over
  ep are refused.
"""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import bert as JB
from tony_tpu.models import train as JTR
from tony_tpu.models import transformer as JT
from tony_tpu.parallel.mesh import make_hybrid_mesh as jax_make_hybrid_mesh
from tony_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tony_tpu.parallel.sharding import shard_pytree as jax_shard_pytree
from tony_tpu.serving.weightstore import tree_digest
from tony_tpu_torch.models import bert as TB
from tony_tpu_torch.models import train as TR
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)
STEPS, BATCH, SEQ = 3, 4, 32
GROUP_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


class Case:
    """One sharded run: a model on a mesh of ``world`` processes."""

    def __init__(self, name, world, axes, model="lm", kw=None,
                 steps=STEPS, ckpt="", dcn=None, emu=False):
        self.name, self.world, self.axes = name, world, axes
        self.model, self.kw, self.steps, self.ckpt = model, kw or {}, \
            steps, ckpt
        self.dcn = dcn      # the slices' axes of a hybrid mesh, or None
        self.emu = emu      # also run the dict mesh of the same sizes

    def plan(self) -> dict:
        return dict(name=self.name, axes=self.axes, model=self.model,
                    kw=self.kw, steps=self.steps, ckpt=self.ckpt,
                    dcn=self.dcn, emu=self.emu)


def _setup(case: Case):
    """(JAX config, port config, JAX init params, global batches)."""
    if case.model == "bert":
        return _bert_setup()
    return _lm_setup(case.kw)


def run_group(cases, world: int, out_dir, setup=None, env=None) -> dict:
    """Run ``cases`` in turn on ``world`` worker processes (one gloo
    group, the jax arm's environment, plus ``env``); returns ``{case
    name: [each rank's results]}``. ``setup(case)`` gives each case's
    (JAX config, port config, weights, inputs), :func:`_setup` by
    default. The group gets GROUP_TIMEOUT_S seconds, then every worker is
    killed and the cases fail."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    inputs = {"plan": json.dumps({"opt": OPT,
                                  "cases": [c.plan() for c in cases]})}
    for c in cases:
        _, _, jp, batches = (setup or _setup)(c)
        inputs.update({f"{c.name}/{k}": v for k, v in batches.items()})
        inputs.update({f"{c.name}/p/{k}": v for k, v in _flat(jp).items()})
    in_npz = os.path.join(out_dir, "in.npz")
    np.savez(in_npz, **inputs)
    env = dict(os.environ, PYTHONPATH=REPO,
               TONY_JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               TONY_JAX_NUM_PROCESSES=str(world), **(env or {}))
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(out_dir, f"log{r}.txt"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, in_npz, out_dir],
            env=dict(env, TONY_JAX_PROCESS_ID=str(r)), stdout=log,
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = {r: open(os.path.join(out_dir, f"log{r}.txt")).read()[-3000:]
                 for r in failed}
        raise RuntimeError(
            f"{[c.name for c in cases]}: ranks {failed} failed or timed "
            f"out:\n" + "\n".join(f"--- rank {r}\n{t}" for r, t in
                                   tails.items()))
    return {c.name: [dict(np.load(os.path.join(
        out_dir, f"{c.name}.rank{r}.npz"))) for r in range(world)]
        for c in cases}


@functools.lru_cache(maxsize=None)
def _lm_setup_cached(kw: tuple):
    model = dict(kw)
    jcfg = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, **model)
    tcfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, **model)
    jp = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(5)
    toks = rs.randint(0, jcfg.vocab_size,
                      size=(STEPS, BATCH, SEQ + 1)).astype(np.int32)
    batches = {"inputs": toks[:, :, :SEQ], "targets": toks[:, :, 1:]}
    return jcfg, tcfg, jp, batches


def _lm_setup(model: dict):
    return _lm_setup_cached(tuple(sorted(model.items())))


@functools.lru_cache(maxsize=None)
def _bert_setup():
    jcfg = dataclasses.replace(JB.BERT_TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(TB.BERT_TINY, dtype=torch.float32)
    jp = jax.device_get(JB.init_params(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(6)
    toks = rs.randint(0, jcfg.vocab_size,
                      size=(STEPS, BATCH, SEQ)).astype(np.int32)
    masked = rs.rand(STEPS, BATCH, SEQ) < 0.15
    batches = {"tokens": np.where(masked, jcfg.vocab_size - 1, toks),
               "targets": np.where(masked, toks, -1).astype(np.int32)}
    return jcfg, tcfg, jp, batches


def _jax_trajectory(jloss, jcfg, axes_fn, jp, batches, world, axes,
                    dcn=None):
    devices = jax.devices()[:world]
    mesh = (jax_make_hybrid_mesh(axes, dcn, devices=devices) if dcn
            else jax_make_mesh(axes, devices=devices))
    params = jax_shard_pytree(jax.tree.map(jnp.asarray, jp), axes_fn(jcfg),
                              mesh)
    opt = JTR.default_optimizer(**OPT)
    state = JTR.init_state(params, opt)
    step = JTR.make_train_step(lambda p, b: jloss(p, b, jcfg, mesh), opt,
                               mesh, donate=False)
    got = []
    for i in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v[i])
                                for k, v in batches.items()})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    return np.array(got)


def _port_unsharded(tloss, tcfg, jp, batches):
    opt = TR.default_optimizer(**OPT)
    state = TR.init_state(params_from_numpy(jp, device="cpu"), opt)
    step = TR.make_train_step(lambda p, b: tloss(p, b, tcfg), opt)
    for i in range(STEPS):
        state, _ = step(state, {k: torch.from_numpy(v[i]).long()
                                for k, v in batches.items()})
    return _flat(params_to_numpy(state["params"]))


def _assert_params_close(got: dict, want: dict) -> None:
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert np.mean(diff > 1e-5) <= 0.01, (name, np.mean(diff > 1e-5))
        rel = np.linalg.norm(diff) / np.linalg.norm(w)
        assert rel <= 1e-3, (name, rel)


def _gathered(rank_out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in rank_out.items()
            if k.startswith(prefix)}


def _assert_global_batch(outs, first_rows) -> None:
    """Every rank's assembled global batch is the local shards in
    data-parallel rank order, and ranks sharing a data rank fed equal
    shards."""
    shards = {}
    for o in outs:
        r = int(o["dp_rank"])
        if r in shards:
            np.testing.assert_array_equal(shards[r], o["local0"])
        shards[r] = o["local0"]
    want = np.concatenate([shards[r] for r in sorted(shards)])
    np.testing.assert_array_equal(want, first_rows)
    for o in outs:
        np.testing.assert_array_equal(o["global0"], want)


def _check_case(outs, want_traj, want_params, jp, first_rows) -> None:
    for o in outs:          # every rank sees the same global loss
        assert float(o["logits_err"]) <= 2e-5, float(o["logits_err"])
        got = np.stack([o["loss"], o["grad_norm"]], axis=1)
        np.testing.assert_allclose(got, want_traj, rtol=1e-4)
    _assert_params_close(_gathered(outs[0], "p/"), want_params)
    init = _gathered(outs[0], "init/")
    assert tree_digest(init) == tree_digest(_flat(jp))
    _assert_global_batch(outs, first_rows)


LM_CASES = [
    Case("dp2", 2, {"dp": 2}),
    Case("fsdp2", 2, {"fsdp": 2}),
    Case("tp2", 2, {"tp": 2}),
    Case("tp2_gqa2", 2, {"tp": 2}, kw={"n_kv_heads": 2}),
    Case("tp2_gqa1", 2, {"tp": 2}, kw={"n_kv_heads": 1}),
    Case("dp4", 4, {"dp": 4}),
    Case("fsdp4", 4, {"fsdp": -1}),
    Case("tp4", 4, {"tp": 4}),
    Case("tp4_gqa2", 4, {"tp": 4}, kw={"n_kv_heads": 2}),
    Case("fsdp2_tp2", 4, {"fsdp": 2, "tp": 2}),
    Case("fsdp2_tp2_gqa1", 4, {"fsdp": 2, "tp": 2}, kw={"n_kv_heads": 1}),
    Case("ep2", 2, {"ep": 2}, kw={"num_experts": 4}),
    Case("dp2_ep2", 4, {"dp": 2, "ep": 2}, kw={"num_experts": 4}),
    Case("ep2_tp2", 4, {"ep": 2, "tp": 2}, kw={"num_experts": 4}),
    Case("cp2", 2, {"cp": 2}),
    Case("cp2_ulysses", 2, {"cp": 2}, kw={"cp_strategy": "ulysses"}),
    Case("cp2_gqa1", 2, {"cp": 2}, kw={"n_kv_heads": 1}),
    Case("cp4", 4, {"cp": 4}),
    Case("cp2_tp2", 4, {"cp": 2, "tp": 2}, kw={"remat_policy": "attn"}),
    Case("dp2_cp2_ulysses", 4, {"dp": 2, "cp": 2},
         kw={"cp_strategy": "ulysses", "remat_policy": "dots"}),
    Case("hybrid_dcn_dp2_tp2", 4, {"tp": -1}, dcn={"dp": 2}),
    Case("hybrid_dcn_pp2_dp2", 4, {"dp": -1}, dcn={"pp": 2}),
    Case("cp2_moe", 2, {"cp": 2}, kw={"num_experts": 4}, emu=True),
    Case("dp2_cp2_moe", 4, {"dp": 2, "cp": 2}, kw={"num_experts": 4},
         emu=True),
    Case("ep2_cp2_moe", 4, {"ep": 2, "cp": 2}, kw={"num_experts": 4},
         emu=True),
    Case("pp2_cp2", 4, {"pp": 2, "cp": 2}, emu=True),
    Case("pp2_cp2_1f1b", 4, {"pp": 2, "cp": 2}, kw={"pp_schedule": "1f1b"},
         emu=True),
]
BERT_CASES = [
    Case("bert_fsdp2", 2, {"fsdp": 2}, model="bert"),
    Case("bert_tp2", 2, {"tp": 2}, model="bert"),
    Case("bert_dp2_tp2", 4, {"dp": 2, "tp": 2}, model="bert"),
    Case("bert_cp2", 2, {"cp": 2}, model="bert", emu=True),
    Case("bert_pp2", 2, {"pp": 2}, model="bert", emu=True),
]


@pytest.fixture(scope="module")
def group_results(tmp_path_factory):
    """``get(world)``: every case of that world size, run in one group
    of ``world`` processes the first time it is asked for (a failed
    group fails each of its cases, and is not run again)."""
    done: dict = {}

    def get(world: int) -> dict:
        if world not in done:
            cases = [c for c in LM_CASES + BERT_CASES if c.world == world]
            try:
                done[world] = run_group(cases, world, tmp_path_factory.mktemp(
                    f"world{world}"))
            except RuntimeError as e:
                done[world] = e
        if isinstance(done[world], Exception):
            pytest.fail(str(done[world]))
        return done[world]
    return get


def _axes(case: Case) -> dict:
    if case.dcn:        # make_hybrid_mesh infers the ici axes itself
        return case.axes
    return {k: (case.world if v == -1 else v) for k, v in case.axes.items()}


@pytest.mark.parametrize("case", LM_CASES + BERT_CASES,
                         ids=[c.name for c in LM_CASES + BERT_CASES])
def test_sharded_trajectory_matches_jax(case, group_results):
    outs = group_results(case.world)[case.name]
    jcfg, tcfg, jp, batches = _setup(case)
    if case.model == "bert":
        jloss, axes_fn, tloss = JB.mlm_loss, JB.logical_axes, TB.mlm_loss
        first = batches["tokens"][0]
    else:
        jloss, axes_fn, tloss = JT.lm_loss, JT.logical_axes, TT.lm_loss
        first = batches["inputs"][0]
    want = _jax_trajectory(jloss, jcfg, axes_fn, jp, batches, case.world,
                           _axes(case), case.dcn)
    _check_case(outs, want, _port_unsharded(tloss, tcfg, jp, batches), jp,
                first)


EMU_CASES = [c for c in LM_CASES + BERT_CASES if c.emu]
#: emulated with the group's own arithmetic: equal bit for bit
_SAME_ARITHMETIC = {"pp2_cp2", "pp2_cp2_1f1b", "bert_pp2"}


@pytest.mark.parametrize("case", EMU_CASES, ids=[c.name for c in EMU_CASES])
def test_dict_mesh_emulation_matches_the_gloo_group(case, group_results):
    for o in group_results(case.world)[case.name]:
        grads = [k[len("mesh/"):] for k in o if k.startswith("mesh/grad/")]
        assert grads
        if case.name in _SAME_ARITHMETIC:
            for k in ["logits", "loss"] + grads:
                np.testing.assert_array_equal(o[f"mesh/{k}"], o[f"emu/{k}"],
                                              k)
            continue
        if "ep" in case.axes:
            np.testing.assert_allclose(o["mesh/logits"], o["emu/logits"],
                                       rtol=0, atol=2e-5)
        else:
            np.testing.assert_array_equal(o["mesh/logits"], o["emu/logits"])
        np.testing.assert_allclose(o["mesh/loss"], o["emu/loss"], rtol=1e-6)
        for k in grads:
            np.testing.assert_allclose(o[f"mesh/{k}"], o[f"emu/{k}"],
                                       rtol=0, atol=1e-6, err_msg=k)


def test_pp_over_dcn_has_the_unpipelined_loss(group_results):
    """pp across the slices of a hybrid mesh: the first step's loss (the
    initial params') equals the JAX package's unpipelined loss at rtol
    1e-5, on every rank."""
    outs = group_results(4)["hybrid_dcn_pp2_dp2"]
    jcfg, _, jp, batches = _lm_setup({})
    ref = float(JT.lm_loss(jax.tree.map(jnp.asarray, jp),
                           {k: jnp.asarray(v[0]) for k, v in
                            batches.items()}, jcfg, None))
    for o in outs:
        np.testing.assert_allclose(float(o["loss"][0]), ref, rtol=1e-5)


def test_sharded_checkpoint_resumes_in_a_new_group(group_results,
                                                   tmp_path):
    """Save at step 2 under fsdp, then a new group restores (attempt 1,
    rank 0 deciding the step) into fresh params of another seed and
    trains on: the params equal the uninterrupted run's (the fsdp2
    case), bit for bit."""
    straight = group_results(2)["fsdp2"]
    try:
        run_group([Case("ckpt", 2, {"fsdp": 2}, steps=2, ckpt="save")], 2,
                  tmp_path)
        outs = run_group([Case("ckpt", 2, {"fsdp": 2}, ckpt="resume")], 2,
                         tmp_path)["ckpt"]
    except RuntimeError as e:
        pytest.fail(str(e))
    for o in outs:
        assert int(o["start"]) == 2 and int(o["count"]) == STEPS
        # every 2 steps, and the first step offered (as orbax does)
        assert list(o["ckpt_steps"]) == [1, 2]
        np.testing.assert_array_equal(o["loss"], straight[0]["loss"][2:])
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_1", "step_2"]
    for name, want in _gathered(straight[0], "p/").items():
        np.testing.assert_array_equal(outs[0]["p/" + name], want, name)


def test_ep_checkpoint_restores_at_another_world_size(group_results,
                                                     tmp_path):
    """An MoE state sharded over ep=2 (world 2), saved at step 2, is
    restored by a group of 4 on dp=2 x ep=2 (the experts resharded by the
    restore) and trains on to the uninterrupted ep2 run: its last loss
    and grad_norm at rtol 1e-4 and its params at the trajectory bounds
    (the batch now splits over dp, another summation order)."""
    straight = group_results(2)["ep2"]
    moe = {"num_experts": 4}
    try:
        run_group([Case("ckpt_ep", 2, {"ep": 2}, kw=moe, steps=2,
                        ckpt="save")], 2, tmp_path)
        outs = run_group([Case("ckpt_ep", 4, {"dp": 2, "ep": 2}, kw=moe,
                               ckpt="resume")], 4, tmp_path)["ckpt_ep"]
    except RuntimeError as e:
        pytest.fail(str(e))
    for o in outs:
        assert int(o["start"]) == 2 and int(o["count"]) == STEPS
        np.testing.assert_allclose(o["loss"], straight[0]["loss"][2:],
                                   rtol=1e-4)
        np.testing.assert_allclose(o["grad_norm"],
                                   straight[0]["grad_norm"][2:], rtol=1e-4)
    _assert_params_close(_gathered(outs[0], "p/"),
                         _gathered(straight[0], "p/"))


def test_cp_checkpoint_resumes_in_a_new_group(group_results, tmp_path):
    """A dp × cp state (params replicated over cp) saved at step 2 by a
    group of 4 is restored by a new group and trains on: the first loss
    equals the uninterrupted dp2_cp2_ulysses run's bit for bit (the
    restored params are its params), and the params after the step are
    held at the trajectory bounds. Not bit for bit there: MKL's CPU
    products round by the buffers' alignment, which a new process
    changes; under ``MKL_CBWR=COMPATIBLE`` the resume is bitwise."""
    straight = group_results(4)["dp2_cp2_ulysses"]
    kw = {"cp_strategy": "ulysses", "remat_policy": "dots"}
    try:
        run_group([Case("ckpt_cp", 4, {"dp": 2, "cp": 2}, kw=kw, steps=2,
                        ckpt="save")], 4, tmp_path)
        outs = run_group([Case("ckpt_cp", 4, {"dp": 2, "cp": 2}, kw=kw,
                               ckpt="resume")], 4, tmp_path)["ckpt_cp"]
    except RuntimeError as e:
        pytest.fail(str(e))
    for o in outs:
        assert int(o["start"]) == 2 and int(o["count"]) == STEPS
        np.testing.assert_array_equal(o["loss"], straight[0]["loss"][2:])
    _assert_params_close(_gathered(outs[0], "p/"),
                         _gathered(straight[0], "p/"))


#: the injected shard-write delay of the asynchronous-save group (s)
WRITE_DELAY_S = 2.0


@pytest.fixture(scope="module")
def async_save(tmp_path_factory):
    """Each rank's results of the ``async`` checkpoint case (the worker's
    ``run_async_checkpoint``) on fsdp 2, every shard write delayed by
    WRITE_DELAY_S and rank 1's write of step 5 failing; one group for the
    tests below (a failed group fails each of them)."""
    try:
        return run_group(
            [Case("ckpt_async", 2, {"fsdp": 2}, steps=1, ckpt="async")], 2,
            tmp_path_factory.mktemp("async"),
            env={"TONY_TEST_CKPT_WRITE_DELAY_S": str(WRITE_DELAY_S),
                 "TONY_TEST_CKPT_FAIL": "1:5"})["ckpt_async"]
    except RuntimeError as e:
        return e


def _async_outs(async_save):
    if isinstance(async_save, Exception):
        pytest.fail(str(async_save))
    return async_save


def test_sharded_save_returns_before_its_write_ends(async_save):
    for o in _async_outs(async_save):
        assert bool(o["saved"]) and bool(o["in_flight"])
        assert float(o["save_s"]) < WRITE_DELAY_S, float(o["save_s"])


def test_sharded_save_snapshots_the_state_before_it_returns(async_save):
    """The step after ``save`` writes into the params and moments in
    place; the checkpoint holds them as they were, bit for bit."""
    for o in _async_outs(async_save):
        assert bool(o["mutated"]) and bool(o["restored_equal"])


def test_off_interval_offers_run_no_collective(async_save):
    """Offers 2-4 (interval 5) while step 1's write is in flight: no
    ``broadcast_object_list`` or ``barrier`` call, and no join."""
    for o in _async_outs(async_save):
        assert [bool(o[f"offer{s}"]) for s in (2, 3, 4)] == [False] * 3
        assert int(o["offer_calls"]) == 0
        assert bool(o["offers_in_flight"])


def test_a_failed_sharded_write_commits_nothing_and_raises_on_every_rank(
        async_save):
    """Rank 1's write of step 5 fails: no rank's read sees step 5, the
    next save raises on both ranks (rank 0 wrote its shards), and the
    save offered again commits and clears the partial directory."""
    outs = _async_outs(async_save)
    for o in outs:
        assert bool(o["saved5"]) and int(o["latest_after_fail"]) == 1
        assert "injected write failure at step 5" in str(o["raised"])
        assert bool(o["saved_again"])
        assert str(o["listing"]) == "step_1 step_10"
    assert str(outs[0]["listing_after_fail"]) == "step_1 step_5.tmp"


def test_experts_must_split_over_ep():
    cfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, num_experts=3)
    toks = torch.zeros(2, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible over ep=2"):
        TT.lm_loss({}, {"tokens": toks}, cfg, mesh={"dp": 1, "ep": 2})


def test_fused_optimizer_refuses_a_mesh():
    opt = TR.default_optimizer(fused=True)
    with pytest.raises(ValueError, match="single-device"):
        TR.make_train_step(lambda p, b: None, opt, mesh={"fsdp": 2})
