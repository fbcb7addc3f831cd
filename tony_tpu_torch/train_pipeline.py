"""Cross-slice pipeline-parallel training: one stage gang's program — the
port's counterpart of ``examples/lm/train_pipeline.py``.

The per-gang program of a pipeline job (``tony.pipeline.stages`` and
``tony.{job}.program``): every stage gang runs this script; the stage it
plays, the number of stages and where its neighbour gangs' channel hubs
listen arrive through the executor's environment (``TONY_PIPELINE_*`` /
``TONY_CHANNEL_*``, :func:`~tony_tpu_torch.channels.registry.stage_env`).

The model is the JAX script's residual-tanh stand-in, split layer-wise
across stages, with the same seeds: stage s holds stage s's block
params, the last stage the loss head. Each step every stage runs its
share of the cross-slice 1F1B schedule
(:class:`~tony_tpu_torch.parallel.pipeline.CrossSlicePipeline`) and an
SGD update; activations stream to stage+1 and cotangents back to stage-1
over TONYC1 channels while the stage computes the adjacent microbatches.
Losses and params land in ``--out`` as the JAX script writes them
(``<out>-stage<k>.npz``), so a harness can pin them to the in-slice
1F1B schedule on the same params and batches.

Submit shape (stage gangs are ordinary job types)::

    python -m tony_tpu.client.cli submit \\
      --conf tony.stage0.instances=1 --conf tony.stage1.instances=1 \\
      --conf tony.pipeline.stages=stage0,stage1 \\
      --conf tony.stage0.program='python -m tony_tpu_torch.train_pipeline' \\
      --conf tony.stage1.program='python -m tony_tpu_torch.train_pipeline' \\
      --executes 'python -m tony_tpu_torch.train_pipeline'

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tony_tpu_torch import resolve_device
from tony_tpu_torch.channels.registry import open_stage_links, stage_env
from tony_tpu_torch.models.loop import run_training
from tony_tpu_torch.parallel.pipeline import CrossSlicePipeline


def stage_fn(p, x):
    """One stage's block: residual tanh MLP, shape-preserving (the
    pipeline stage contract)."""
    return x + torch.tanh(x @ p["w"] + p["b"])


def loss_head(hp, out, tgt):
    """Mean-squared regression head: the per-microbatch scalar the last
    stage seeds its backward from."""
    return torch.mean((out @ hp["wo"] - tgt) ** 2)


def init_stage_params(stage: int, dim: int, seed: int = 0, device="cpu"):
    """Stage ``stage``'s block params, seeded by (seed, stage) as the JAX
    script seeds them."""
    rs = np.random.RandomState(seed * 1000 + stage)
    return {
        "w": torch.tensor(rs.randn(dim, dim).astype(np.float32) * 0.3,
                          device=device),
        "b": torch.tensor(rs.randn(dim).astype(np.float32) * 0.1,
                          device=device),
    }


def init_head_params(dim: int, seed: int = 0, device="cpu"):
    rs = np.random.RandomState(seed * 1000 + 999)
    return {"wo": torch.tensor(rs.randn(dim, dim).astype(np.float32) * 0.2,
                               device=device)}


def batch_for(step: int, m: int, mb: int, dim: int, seed: int = 0):
    """(inputs [M, mb, dim], targets [M, mb, dim]) of one step as numpy
    arrays, a function of (seed, step) only: stage 0 feeds the inputs,
    the last stage the targets."""
    rs = np.random.RandomState(seed * 100_000 + step)
    x = rs.randn(m, mb, dim).astype(np.float32)
    tgt = rs.randn(m, mb, dim).astype(np.float32)
    return x, tgt


def sgd(params, grads, lr: float):
    return {k: p - lr * grads[k] for k, p in params.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="train_pipeline")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--mb_rows", type=int, default=4)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--interleave", type=int, default=0,
                    help="virtual stages per gang (0 = take "
                    "TONY_PIPELINE_INTERLEAVE from the coordinator)")
    ap.add_argument("--channel_compression", default="",
                    choices=("", "none", "bf16", "int8"),
                    help="wire codec of the tensor channels ('' = take "
                    "TONY_CHANNEL_COMPRESSION from the coordinator; every "
                    "stage gang must pass the same value)")
    ap.add_argument("--out", default="", help="npz with losses + final "
                    "params (filename gains a -stage<k> suffix)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    env = stage_env()
    if env is None:
        print("train_pipeline must run as a pipeline stage "
              "(tony.pipeline.stages): no TONY_PIPELINE_STAGE in env",
              file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    if args.interleave > 0:
        env["interleave"] = args.interleave
    if args.channel_compression:
        env["compression"] = args.channel_compression
    links = open_stage_links(window=args.window, **env)
    m, mb, dim = args.microbatches, args.mb_rows, args.dim
    v = links.interleave
    # chunk j's block is virtual stage j*S + s of the model: the seeding
    # the in-slice reference uses for its stacked stage axis
    params = (init_stage_params(links.stage, dim, args.seed, dev) if v == 1
              else [init_stage_params(links.global_stage(j), dim, args.seed,
                                      dev) for j in range(v)])
    head = (init_head_params(dim, args.seed, dev) if links.is_last
            else None)
    pipe = CrossSlicePipeline(stage_fn, links,
                              loss_head=loss_head if links.is_last
                              else None, device=dev)
    print(f"stage {links.stage} of {links.num_stages} (interleave {v}, "
          f"codec {links.compression}) on {dev}", flush=True)
    losses: list[float] = []

    def feed():
        """This stage's input: the inputs at stage 0, the targets at the
        last stage (mid stages consume nothing)."""
        step = 0
        while True:
            x, tgt = batch_for(step, m, mb, dim, args.seed)
            yield ({"x": torch.tensor(x, device=dev)} if links.is_first
                   else {"tgt": torch.tensor(tgt, device=dev)})
            step += 1

    def step_fn(state, batch):
        params, head = state
        loss, grads, hgrads, _ = pipe.value_and_grad(
            params, num_microbatches=m,
            microbatches=batch["x"] if links.is_first else None,
            head_params=head,
            head_batches=batch["tgt"] if links.is_last else None)
        params = (sgd(params, grads, args.lr) if v == 1 else
                  [sgd(p, g, args.lr) for p, g in zip(params, grads)])
        metrics = {}
        if links.is_last:
            head = sgd(head, hgrads, args.lr)
            losses.append(float(loss))
            metrics["loss"] = losses[-1]
        return (params, head), metrics

    data = feed() if (links.is_first or links.is_last) else None
    try:
        (params, head), _ = run_training(
            step_fn, (params, head), data, args.steps,
            log_fn=lambda s, mtr, b: print(
                f"step {s} loss {mtr['loss']:.6f}" if "loss" in mtr
                else f"step {s}", flush=True),
            log_every=1)
    finally:
        pipe.close()
        links.close()
    print(f"done: {args.steps} steps, stage {links.stage} bubble "
          f"{pipe.last_step.get('bubble', 0.0):.4f}", flush=True)
    if args.out:
        def host(t):
            return t.detach().cpu().numpy()
        if v == 1:
            out = {f"p_{k}": host(a) for k, a in params.items()}
        else:
            out = {f"p{j}_{k}": host(a) for j, chunk in enumerate(params)
                   for k, a in chunk.items()}
        if links.is_last:
            out.update({f"h_{k}": host(a) for k, a in head.items()})
            out["losses"] = np.asarray(losses, np.float32)
        np.savez(f"{args.out}-stage{links.stage}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
