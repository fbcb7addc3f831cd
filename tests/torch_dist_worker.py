"""One rank of sharded runs of the port, for tests/test_torch_distributed.py.

Run as ``python tests/torch_dist_worker.py IN_NPZ OUT_DIR`` with the jax
arm's bootstrap in the environment (``TONY_JAX_COORDINATOR_ADDRESS``,
``TONY_JAX_PROCESS_ID``, ``TONY_JAX_NUM_PROCESSES``), as the executor
exports it: the process boots its gloo group through
``tony_tpu_torch.runtime`` on the CPU, then runs every case of the plan
in turn, each on a mesh of its own over that group.

``IN_NPZ`` holds a JSON ``plan`` (the optimizer's arguments and a list of
cases: ``name``, ``model`` — ``lm`` or ``bert`` —, mesh ``axes``, the
model's ``kw``, ``steps`` and ``ckpt``) and, per case, the weights
(``<name>/p/<path>``) and the global token batches (``<name>/<leaf>``,
``[steps, B, S]``). Each rank feeds its local rows of a step's batch (by
``data_parallel_rank``) through ``global_batch``, runs the sharded train
step, and writes ``<name>.rank<r>.npz``: the loss and grad_norm of every
step, the assembled global batch of the first step next to its own
shard and data rank, the max error of the sharded forward's logits
against the unsharded forward (``logits_err``), and the params gathered
to full arrays (``p/<path>``; the sharded initial params under
``init/<path>``).

``ckpt`` is ``save`` (a sharded checkpoint every 2 steps under
``OUT_DIR/<name>``) or ``resume`` (``restore_or_init`` from that
directory's latest step at attempt 1, then on to ``steps``); a resume
runs in a new group.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import tony_tpu_torch.runtime as rt  # noqa: E402
from tony_tpu_torch.models import bert as B  # noqa: E402
from tony_tpu_torch.models import transformer as T  # noqa: E402
from tony_tpu_torch.models import train as TR  # noqa: E402
from tony_tpu_torch.models.checkpoint import CheckpointManager  # noqa: E402
from tony_tpu_torch.models.weights import (params_from_numpy,  # noqa: E402
                                           params_to_numpy)
from tony_tpu_torch.parallel import constrain, mesh_shape  # noqa: E402


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


def run_case(case: dict, data, opt_kw: dict, out_dir: str) -> dict:
    name = case["name"]
    mesh = rt.mesh(case["axes"], device="cpu")
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
    step = TR.make_train_step(lambda p, b: loss(p, b, cfg, mesh), opt, mesh)
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
    for case in plan["cases"]:
        out = run_case(case, data, plan["opt"], out_dir)
        np.savez(os.path.join(out_dir, f"{case['name']}.rank"
                              f"{info.process_id}.npz"), **out)
    rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
