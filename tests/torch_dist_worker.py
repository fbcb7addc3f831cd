"""One rank of sharded runs of the port, for tests/test_torch_distributed.py.

Run as ``python tests/torch_dist_worker.py IN_NPZ OUT_DIR`` with the jax
arm's bootstrap in the environment (``TONY_JAX_COORDINATOR_ADDRESS``,
``TONY_JAX_PROCESS_ID``, ``TONY_JAX_NUM_PROCESSES``), as the executor
exports it: the process boots its gloo group through
``tony_tpu_torch.runtime`` on the CPU, then runs every case of the plan
in turn, each on a mesh of its own over that group.

``IN_NPZ`` holds a JSON ``plan`` (the optimizer's arguments and a list of
cases: ``name``, ``model`` — ``lm``, ``bert`` or ``attn`` —, mesh
``axes``, the model's ``kw``, ``steps`` and ``ckpt``) and, per case, the
weights (``<name>/p/<path>``) and the global token batches
(``<name>/<leaf>``, ``[steps, B, S]``). Each rank feeds its local rows of a step's batch (by
``data_parallel_rank``) through ``global_batch``, runs the sharded train
step, and writes ``<name>.rank<r>.npz``: the loss and grad_norm of every
step, the assembled global batch of the first step next to its own
shard and data rank, the max error of the sharded forward's logits
against the unsharded forward (``logits_err``), and the params gathered
to full arrays (``p/<path>``; the sharded initial params under
``init/<path>``).

An ``attn`` case holds global ``q``, ``k``, ``v`` and an output
cotangent ``do`` (``[B, S, H, D]``) instead of weights and batches: each
rank runs the ring and the Ulysses bodies over the mesh's cp group on its
chunk (``Layout.local``), with the dense and the flash per-chunk
engines, causal and not, and writes its outputs and q/k/v gradients
under ``<engine>/<strategy>/<causal>/{o,dq,dk,dv}``.

A ``pipe`` case holds the toy stage problem of
``tests/test_parallel.py`` (stacked ``W``, ``b``, an input ``x``, targets
``tgt``, a head ``wo`` and an output cotangent ``cot``) and the
microbatch count (``kw["m"]``): each rank runs its stage of GPipe
(``pipeline_apply_local``, differentiated against ``cot``, once with the
input recording a gradient and once with the params alone) and of 1F1B
(``pipeline_value_and_grad_local``) over the mesh's pp group on its data
rank's rows, and writes ``gpipe/{out,dW,db,dx}``,
``gpipe_params_only/{dW,db}`` and ``1f1b/{loss,dW,db,dwo,dxs}``.

An ``lm`` case whose ``kw`` sets ``pp_schedule`` to ``1f1b`` on a mesh
with a pp axis trains through ``lm_value_and_grad`` (the step's
``value_and_grad_fn``).

A ``decode`` case (``tests/test_torch_tp_decode.py``) holds an LM's
weights and a ``prompt``; ``kw`` names the config (``cfg``: ``tiny`` or
``beam``, and its overrides), the entry point (``kind``: ``greedy``,
``sampled``, ``beam`` or ``long``) and whether the sharded tree is
quantized (``int8``). Each rank lays the weights out by ``shard_pytree``
(quantized after sharding), decodes on the mesh, and writes the outputs
(``tokens``, ``logprobs``, ``scores``, ``logits``), the quantized tree
gathered to full arrays (``q/<path>``, ``scale/<path>``), and, on rank
0, the same entry point on the dict mesh of the same sizes (every rank
emulated in this process) under ``emu/``. A ``mesh_env`` case builds
``runtime.mesh()`` from a mesh spec with dcn axes and this rank's slice
id in the environment (slice-major: rank // 2 of 2 slices), and writes
the mesh's names, shape and rank grid.

A ``resnet`` case (``tests/test_torch_resnet.py``) holds a ResNet's
``params`` and ``stats`` (under ``<name>/p/params/…`` and
``<name>/p/stats/…``), one global batch of ``image`` and ``label`` and
the depth (``kw["depth"]``): each rank feeds its rows through
``global_batch`` and differentiates ``classification_loss`` on the dp
mesh (sync-BN), then twice more as a faulty data-parallel BN would
run: with the statistics' sums all-reduced but with an identity
backward (``identity/``), and with each rank's statistics of its own
rows and the loss and gradients averaged over the ranks (``local/``).
It writes the loss, the new statistics (``stats/<path>``) and every
gradient gathered to a full array (``grad/<path>``) under each prefix.
The same three ways it runs one batch norm alone (``_batch_norm`` on
the global ``bn_x`` and a cotangent ``bn_cot``, its params and
statistics under ``<name>/p/bn/{p,s}/…``) and writes ``bn/y`` and
``bn/grad/x`` (this rank's rows), ``bn/grad/{scale,bias}`` (summed
over the ranks) and ``bn/stats/…``.

A case with ``dcn`` axes builds its mesh with them
(``runtime.mesh(axes, dcn_axes=dcn)``, a hybrid mesh).

``ckpt`` is ``save`` (a sharded checkpoint every 2 steps under
``OUT_DIR/<name>``) or ``resume`` (``restore_or_init`` from that
directory's latest step at attempt 1, then on to ``steps``); a resume
runs in a new group. ``async`` trains one step and then drives the
asynchronous sharded save itself (:func:`run_async_checkpoint`) under
faults the environment injects into the shard writer:
``TONY_TEST_CKPT_WRITE_DELAY_S`` sleeps before each rank writes its
shards, and ``TONY_TEST_CKPT_FAIL=<rank>:<step>`` fails that rank's write
of that step.
"""

import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import tony_tpu_torch.runtime as rt  # noqa: E402
from tony_tpu_torch import tree_leaves  # noqa: E402
from tony_tpu_torch.models import bert as B  # noqa: E402
from tony_tpu_torch.models import decode as D  # noqa: E402
from tony_tpu_torch.models import resnet as RN  # noqa: E402
from tony_tpu_torch.models.quantize import (QuantizedWeight,  # noqa: E402
                                            quantize_weights_int8)
from tony_tpu_torch.models import transformer as T  # noqa: E402
from tony_tpu_torch.models import train as TR  # noqa: E402
from tony_tpu_torch.models.checkpoint import CheckpointManager  # noqa: E402
from tony_tpu_torch.models.weights import (params_from_numpy,  # noqa: E402
                                           params_to_numpy)
from tony_tpu_torch.ops import prng  # noqa: E402
from tony_tpu_torch.parallel import constrain, mesh_shape  # noqa: E402
from tony_tpu_torch.parallel.sharding import shard_pytree  # noqa: E402
from tony_tpu_torch.parallel import pipeline as PL  # noqa: E402
from tony_tpu_torch.parallel import ring_attention as R  # noqa: E402
from tony_tpu_torch.parallel import spmd  # noqa: E402
from tony_tpu_torch.parallel import ulysses as U  # noqa: E402


def _unflat(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return tree


def _flat(tree, prefix) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def run_attention(case: dict, data) -> dict:
    name = case["name"]
    lay = spmd.Layout(rt.mesh(case["axes"], device="cpu"))
    q, k, v, do = (torch.from_numpy(data[f"{name}/{n}"])
                   for n in ("q", "k", "v", "do"))
    out = {}
    for engine in ("dense", "flash"):
        R._USE_FLASH_CHUNKS = engine == "flash"
        for strategy in ("ring", "ulysses"):
            for causal in (True, False):
                ql, kl, vl = (lay.local(x).clone().requires_grad_(True)
                              for x in (q, k, v))
                if strategy == "ring":
                    o = R.ring_attention_local(ql, kl, vl, lay.cp_group,
                                               causal=causal)
                else:
                    ke, ve = R.expand_kv_unless(kl, vl, q.shape[2],
                                                lay.cp_size)
                    o = U.ulysses_attention_local(ql, ke, ve, lay.cp_group,
                                                  causal=causal)
                grads = torch.autograd.grad(o, (ql, kl, vl), lay.local(do))
                key = f"{engine}/{strategy}/{int(causal)}"
                out[f"{key}/o"] = o.detach().numpy()
                for n, g in zip(("dq", "dk", "dv"), grads):
                    out[f"{key}/{n}"] = g.numpy()
    R._USE_FLASH_CHUNKS = None
    return out


def pipe_stage(p, h):
    w, b = p
    return torch.tanh(h @ w + b)


def pipe_head(hp, out, tgt):
    return torch.mean((out @ hp["wo"] - tgt) ** 2)


def pipe_shard(a, m: int, lay) -> torch.Tensor:
    """This data rank's rows of ``a`` ``[B, ...]`` as microbatches ``[M,
    mb/D, ...]``: the microbatch's rows split over the data ranks."""
    xs = a.reshape((m, a.shape[0] // m) + a.shape[1:])
    n = xs.shape[1] // lay.data_size
    return xs[:, lay.data_rank * n:(lay.data_rank + 1) * n]


def run_pipe(case: dict, data) -> dict:
    name = case["name"]
    lay = spmd.Layout(rt.mesh(case["axes"], device="cpu"))
    W, b, x, tgt, wo, cot = (torch.from_numpy(data[f"{name}/{n}"]) for n in
                             ("W", "b", "x", "tgt", "wo", "cot"))
    m, s = case["kw"]["m"], lay.pp_rank
    out = {}
    ws = W[s].clone().requires_grad_(True)
    bs = b[s].clone().requires_grad_(True)
    xs = pipe_shard(x, m, lay).clone().requires_grad_(True)
    o = PL.pipeline_apply_local(pipe_stage, (ws, bs), xs,
                                pp_group=lay.pp_group,
                                data_groups=lay._data_groups)
    grads = torch.autograd.grad((o * pipe_shard(cot, m, lay)).sum(),
                                (ws, bs, xs))
    out["gpipe/out"] = o.detach().numpy()
    for n, g in zip(("dW", "db", "dx"), grads):
        out[f"gpipe/{n}"] = g.numpy()
    # an input that records no gradient: the receive nodes hang on the
    # stage's params alone, and their backward still sends
    o = PL.pipeline_apply_local(pipe_stage, (ws, bs), xs.detach(),
                                pp_group=lay.pp_group,
                                data_groups=lay._data_groups)
    grads = torch.autograd.grad((o * pipe_shard(cot, m, lay)).sum(),
                                (ws, bs))
    out["gpipe_params_only/dW"] = grads[0].numpy()
    out["gpipe_params_only/db"] = grads[1].numpy()
    loss, g, hg, dxs = PL.pipeline_value_and_grad_local(
        pipe_stage, (W[s], b[s]), {"wo": wo}, pipe_shard(x, m, lay),
        pipe_shard(tgt, m, lay), loss_head=pipe_head,
        pp_group=lay.pp_group, data_groups=lay._data_groups)
    # the grads are this rank's shares: summed over the data ranks
    g = [spmd._all_reduce(t, lay._data_groups) for t in g]
    hg = {"wo": spmd._all_reduce(hg["wo"], lay._data_groups)}
    out.update({"1f1b/loss": loss.numpy(), "1f1b/dW": g[0].numpy(),
                "1f1b/db": g[1].numpy(), "1f1b/dwo": hg["wo"].numpy(),
                "1f1b/dxs": dxs.numpy(), "pp_rank": s,
                "data_rank": lay.data_rank})
    return out


#: the beam-search twin's config (tests/test_decode.py::TestBeamSearch,
#: its vocab cut to 16 so the lm_head splits over tp)
BEAM_CFG = T.TransformerConfig(vocab_size=16, d_model=24, n_layers=2,
                               n_heads=2, d_ff=48, max_seq=256,
                               dtype=torch.float32,
                               logits_dtype=torch.float32, remat=False)


def decode_cfg(kw: dict):
    model = {k: v for k, v in kw.items()
             if k not in ("cfg", "kind", "int8", "new")}
    base = BEAM_CFG if kw.get("cfg") == "beam" else T.PRESETS[
        "tiny"].scaled(dtype=torch.float32, remat=False)
    return base.scaled(**model)


def decode_run(kind: str, params, prompt, cfg, new: int, mesh) -> dict:
    """One decode entry point on ``params`` over ``mesh`` (a DeviceMesh,
    or a dict of sizes to emulate): its outputs as numpy."""
    if kind == "beam":
        o = D.beam_search(params, prompt, cfg, max_new_tokens=new,
                          beam_width=3, mesh=mesh)
        return {"tokens": o.tokens.numpy(), "scores": o.scores.numpy(),
                "lengths": o.lengths.numpy()}
    if kind == "long":
        sp = D.shard_params(params, cfg, mesh)
        _, cache = D.prefill(sp, prompt, cfg, max_len=600)
        nxt = torch.tensor([1, 2])
        logits, _ = D.decode_step(sp, nxt, cache, cache["length"], cfg)
        return {"logits": logits.numpy(),
                "cache_heads": np.int64(cache["k"].shape[3])}
    kw = (dict(rng=prng.PRNGKey(0), temperature=0.8, top_k=8)
          if kind == "sampled" else {})
    o = D.generate(params, prompt, cfg, new, mesh=mesh, **kw)
    return {"tokens": o.tokens.numpy(), "logprobs": o.logprobs.numpy()}


def run_decode(case: dict, data) -> dict:
    name, kw = case["name"], case["kw"]
    mesh = rt.mesh(case["axes"], device="cpu")
    cfg = decode_cfg(kw)
    weights = params_from_numpy(_unflat({
        k[len(name) + 3:]: data[k] for k in data.files
        if k.startswith(f"{name}/p/")}), device="cpu")
    prompt = torch.from_numpy(data[f"{name}/prompt"]).long()
    params = shard_pytree(weights, T.logical_axes(cfg), mesh)
    out = {}
    if kw.get("int8"):
        params = quantize_weights_int8(params)
        weights = quantize_weights_int8(weights)
        for path, w in _flat(params, "").items():
            if isinstance(w, QuantizedWeight):
                out[f"q/{path}"] = w.q.full_tensor().numpy()
                out[f"scale/{path}"] = w.scale.full_tensor().numpy()
    out.update(decode_run(kw["kind"], params, prompt, cfg, kw["new"], mesh))
    if dist.get_rank() == 0:
        emu = decode_run(kw["kind"], weights, prompt, cfg, kw["new"],
                         mesh_shape(mesh))
        out.update({f"emu/{k}": v for k, v in emu.items()})
    return out


def run_mesh_env(case: dict) -> dict:
    """``runtime.mesh()`` from the environment a multi-slice job's task
    gets: the mesh spec's axes and dcn axes, and this rank's slice."""
    rank, world = dist.get_rank(), dist.get_world_size()
    saved = {k: os.environ.get(k) for k in
             ("TONY_MESH_SPEC", "TONY_SLICE_ID", "TONY_NUM_SLICES")}
    os.environ.update(
        TONY_MESH_SPEC=json.dumps({"axes": case["axes"],
                                   "dcn_axes": case["kw"]["dcn"]}),
        TONY_SLICE_ID=str(rank // (world // 2)), TONY_NUM_SLICES="2")
    try:
        mesh = rt.mesh(device="cpu")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"names": np.array(mesh.mesh_dim_names),
            "shape": np.array(mesh.mesh.shape),
            "ranks": mesh.mesh.numpy()}


def inject_write_faults() -> None:
    """The environment's faults (module docstring) on DCP's shard
    writer."""
    delay = float(os.environ.get("TONY_TEST_CKPT_WRITE_DELAY_S", "0"))
    fail = os.environ.get("TONY_TEST_CKPT_FAIL", "")
    if not delay and not fail:
        return
    from torch.distributed.checkpoint import FileSystemWriter
    real = FileSystemWriter.write_data

    def write_data(self, plan, planner):
        time.sleep(delay)
        rank, _, step = fail.partition(":")
        if fail and dist.get_rank() == int(rank) and \
                str(self.path).endswith(f"step_{step}.tmp"):
            raise OSError(f"injected write failure at step {step}")
        return real(self, plan, planner)

    FileSystemWriter.write_data = write_data


def _gathered_state(state) -> dict:
    """Every tensor of the state (params and moments) as a full array."""
    return {k: (t.full_tensor() if hasattr(t, "placements")
                else t).numpy().copy()
            for part in ("params", "opt_state")
            for k, t in _flat(state[part], f"{part}/").items()
            if isinstance(t, torch.Tensor)}


def run_async_checkpoint(case: dict, state, fresh, out_dir: str) -> dict:
    """Drive the asynchronous sharded save on a trained ``state``: a save
    at step 1 (interval 5), the state written into in place right after
    it returns, three off-interval offers while the write is in flight
    (each counting the ``broadcast_object_list`` and ``barrier`` calls
    this thread makes), the restore of step 1 into ``fresh()``; then a
    save at step 5 whose write fails on one rank, a read, the next save
    (which raises), and that save offered again."""
    ckpt = os.path.join(out_dir, case["name"])
    mgr = CheckpointManager(ckpt, save_interval_steps=5)
    calls = []
    for name in ("broadcast_object_list", "barrier"):
        def counted(*a, _real=getattr(dist, name), _name=name, **k):
            if threading.current_thread() is threading.main_thread():
                calls.append(_name)
            return _real(*a, **k)
        setattr(dist, name, counted)
    before = _gathered_state(state)
    t0 = time.perf_counter()
    saved = mgr.save(1, state)
    out = dict(saved=saved, save_s=time.perf_counter() - t0,
               in_flight=mgr._writer.is_alive() and not os.path.exists(
                   os.path.join(ckpt, "step_1")))
    with torch.no_grad():               # the next step, in place
        for t in tree_leaves(state["params"]) + tree_leaves(
                state["opt_state"]):
            if isinstance(t, torch.Tensor):
                (t.to_local() if hasattr(t, "placements") else t).add_(1000)
    offer_s = []
    for s in (2, 3, 4):
        t0 = time.perf_counter()
        out[f"offer{s}"] = mgr.save(s, state)
        offer_s.append(time.perf_counter() - t0)
    out.update(offer_s=np.array(offer_s), offer_calls=len(calls),
               offers_in_flight=mgr._writer.is_alive())
    mgr.wait_until_finished()
    after = _gathered_state(mgr.restore(template=fresh(), step=1))
    out["restored_equal"] = all(np.array_equal(before[k], after[k])
                                for k in before)
    out["mutated"] = not all(np.array_equal(before[k], v) for k, v in
                             _gathered_state(state).items())
    # a write that fails on one rank
    out["saved5"] = mgr.save(5, state)
    out["latest_after_fail"] = mgr.latest_step()
    try:
        mgr.save(10, state)
        out["raised"] = ""
    except Exception as e:
        out["raised"] = f"{type(e).__name__}: {e}"
    out["listing_after_fail"] = " ".join(sorted(os.listdir(ckpt)))
    out["saved_again"] = mgr.save(10, state)
    mgr.close()
    out["listing"] = " ".join(sorted(os.listdir(ckpt)))
    return out


def _resnet_grads(params, stats, batch, depth, mesh):
    """(loss, new stats, grads as full arrays) of one sync-BN step's
    value_and_grad."""
    (loss, new), grads = TR.value_and_grad(
        RN.classification_loss, params, stats, batch, depth, mesh,
        has_aux=True)
    return (float(loss), _flat(params_to_numpy(new), ""),
            _flat(params_to_numpy(grads), ""))


def run_resnet(case: dict, data) -> dict:
    name, depth = case["name"], case["kw"]["depth"]
    mesh = rt.mesh(case["axes"], device="cpu")
    lay = spmd.Layout(mesh)
    tree = _unflat({k[len(name) + 3:]: data[k] for k in data.files
                    if k.startswith(f"{name}/p/")})
    plain = params_from_numpy(tree["params"], device="cpu")
    params = shard_pytree(plain, TR.replicated_axes(plain), mesh)
    stats = params_from_numpy(tree["stats"], device="cpu")
    local = {n: torch.from_numpy(data[f"{name}/{n}"][0]) for n in
             ("image", "label")}
    local = {n: lay.local(v) for n, v in local.items()}
    glob = TR.global_batch(TR.batch_sharding(mesh), local)
    out = {}

    def record(prefix, loss, new, grads):
        out[f"{prefix}/loss"] = loss
        out.update({f"{prefix}/stats/{k}": v for k, v in new.items()})
        out.update({f"{prefix}/grad/{k}": v for k, v in grads.items()})

    bn_x, bn_cot = (lay.local(torch.from_numpy(data[f"{name}/{n}"]))
                    for n in ("bn_x", "bn_cot"))
    bn_p = params_from_numpy(tree["bn"]["p"], device="cpu")
    bn_s = params_from_numpy(tree["bn"]["s"], device="cpu")

    def batch_norm(prefix, bn_lay):
        """One norm's output, statistics and gradients of ``sum(y ·
        cot)`` over the ranks: x's for this rank's rows, scale's and
        bias's summed over the ranks."""
        x = bn_x.clone().requires_grad_(True)
        p = {k: v.clone().requires_grad_(True) for k, v in bn_p.items()}
        y, new = RN._batch_norm(x, p, bn_s, True, lay=bn_lay)
        gx, gs, gb = torch.autograd.grad((y * bn_cot).sum(),
                                         [x, p["scale"], p["bias"]])
        for g in (gs, gb):
            dist.all_reduce(g)
        out.update({f"{prefix}/bn/y": y.detach().numpy(),
                    f"{prefix}/bn/grad/x": gx.numpy(),
                    f"{prefix}/bn/grad/scale": gs.numpy(),
                    f"{prefix}/bn/grad/bias": gb.numpy()})
        out.update({f"{prefix}/bn/stats/{k}": v.numpy()
                    for k, v in new.items()})

    record("sync", *_resnet_grads(params, stats, glob, depth, mesh))
    batch_norm("sync", lay)
    sync_data = spmd.Layout.sync_data
    spmd.Layout.sync_data = lambda self, x: spmd._SumOver.apply(
        x, self._data_groups)
    try:
        record("identity", *_resnet_grads(params, stats, glob, depth, mesh))
        batch_norm("identity", lay)
    finally:
        spmd.Layout.sync_data = sync_data
    # rank-local statistics: each rank a model of its own rows, the loss
    # and the gradients averaged over the ranks afterwards
    loss, new, grads = _resnet_grads(plain, stats, local, depth, None)
    world = dist.get_world_size()
    for k, g in grads.items():
        t = torch.from_numpy(g)
        dist.all_reduce(t)
        grads[k] = (t / world).numpy()
    t = torch.tensor([loss])
    dist.all_reduce(t)
    record("local", float(t[0]) / world, new, grads)
    batch_norm("local", None)
    return out


def run_case(case: dict, data, opt_kw: dict, out_dir: str) -> dict:
    name = case["name"]
    if case["model"] == "attn":
        return run_attention(case, data)
    if case["model"] == "pipe":
        return run_pipe(case, data)
    if case["model"] == "decode":
        return run_decode(case, data)
    if case["model"] == "mesh_env":
        return run_mesh_env(case)
    if case["model"] == "resnet":
        return run_resnet(case, data)
    mesh = rt.mesh(case["axes"], device="cpu", dcn_axes=case.get("dcn"))
    weights = _unflat({k[len(name) + 3:]: data[k] for k in data.files
                       if k.startswith(f"{name}/p/")})
    if case["model"] == "bert":
        cfg = dataclasses.replace(B.BERT_TINY, dtype=torch.float32)
        axes, loss = B.logical_axes(cfg), B.mlm_loss
        names = ("tokens", "targets")
    else:
        cfg = T.PRESETS["tiny"].scaled(dtype=torch.float32, **case["kw"])
        axes, loss = T.logical_axes(cfg), T.lm_loss
        names = ("inputs", "targets")
    batches = {n: data[f"{name}/{n}"] for n in names}
    opt = TR.default_optimizer(**opt_kw)
    state = TR.init_state(params_from_numpy(weights, device="cpu"), opt,
                          mesh, axes)
    out = _flat(params_to_numpy(state["params"]), "init/")
    if case["kw"].get("pp_schedule") == "1f1b" and \
            mesh_shape(mesh).get("pp", 1) > 1:
        step = TR.make_train_step(
            None, opt, mesh, value_and_grad_fn=lambda p, b:
            T.lm_value_and_grad(p, b, cfg, mesh))
    else:
        step = TR.make_train_step(lambda p, b: loss(p, b, cfg, mesh), opt,
                                  mesh)
    sharding = TR.batch_sharding(mesh, logical=("batch", "seq"))
    dp_rank = TR.data_parallel_rank(mesh)
    shape = mesh_shape(mesh)
    rows = batches[names[0]].shape[1] // (shape.get("dp", 1)
                                          * shape.get("fsdp", 1))

    def batch(i):
        local = {n: torch.from_numpy(
            batches[n][i, dp_rank * rows:(dp_rank + 1) * rows]).long()
            for n in names}
        return local, TR.global_batch(sharding, local)

    if case["ckpt"] == "async":
        state, _ = step(state, batch(0)[1])
        out.update(run_async_checkpoint(case, state, lambda: TR.init_state(
            T.init_params(torch.Generator().manual_seed(9), cfg,
                          device="cpu"), opt, mesh, axes), out_dir))
        return out
    start, mgr = 0, None
    if case["ckpt"]:
        mgr = CheckpointManager(os.path.join(out_dir, name),
                                save_interval_steps=2)
        if case["ckpt"] == "resume":
            os.environ["ATTEMPT_NUMBER"] = "1"
            fresh = T.init_params(torch.Generator().manual_seed(9), cfg,
                                  device="cpu")
            state = mgr.restore_or_init(
                lambda: TR.init_state(fresh, opt, mesh, axes))
            start = state["step"]
    out["dp_rank"] = dp_rank
    local0, global0 = batch(start)
    out["local0"] = local0[names[0]].numpy()
    out["global0"] = global0[names[0]].full_tensor().numpy()
    # constrain: the batch redistributed to a replicated layout
    whole = constrain(global0[names[0]], (None, None))
    assert all(p.is_replicate() for p in whole.placements)
    assert torch.equal(whole.to_local(), global0[names[0]].full_tensor())
    if not case["ckpt"]:
        # the sharded forward's logits (a DTensor split by batch and
        # vocab), from the global batch as a plain tensor, against the
        # unsharded forward on this rank
        tokens = torch.from_numpy(batches[names[0]][0]).long()
        ref = params_from_numpy(weights, device="cpu")
        with torch.no_grad():
            if case["model"] == "bert":
                got = B.forward(state["params"], tokens, cfg, mesh=mesh)
                want = B.forward(ref, tokens, cfg)
            else:
                got = T.forward(state["params"], tokens, cfg, mesh)[0]
                want = T.forward(ref, tokens, cfg)[0]
        out["logits_err"] = float((got.full_tensor() - want).abs().max())
    losses, gnorms = [], []
    for i in range(start, case["steps"]):
        state, metrics = step(state, batch(i)[1])
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        if mgr is not None:
            mgr.save(i + 1, state)
    out.update(loss=np.array(losses), grad_norm=np.array(gnorms),
               start=start, count=state["opt_state"]["count"])
    out.update(_flat(params_to_numpy(state["params"]), "p/"))
    if mgr is not None:
        out["ckpt_steps"] = np.array(mgr.all_steps())
    return out


def main() -> int:
    in_npz, out_dir = sys.argv[1:3]
    torch.set_num_threads(1)
    data = np.load(in_npz)
    plan = json.loads(str(data["plan"]))
    info = rt.initialize("cpu", timeout_s=120)
    inject_write_faults()
    for case in plan["cases"]:
        out = run_case(case, data, plan["opt"], out_dir)
        np.savez(os.path.join(out_dir, f"{case['name']}.rank"
                              f"{info.process_id}.npz"), **out)
    rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
