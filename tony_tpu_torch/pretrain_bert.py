"""BERT MLM pretraining, sharded over every process of the job — the
port's counterpart of ``examples/bert/pretrain_bert.py``.

    python -m tony_tpu_torch.pretrain_bert --config base --steps 100 \\
        --batch_size 16 --seq_len 512

As the JAX script does: the process group from the executor's
environment (``runtime.initialize``), the mesh (``runtime.mesh``;
``tony.application.mesh``, e.g. ``dp=-1``; a lone process gets a world-1
mesh), the params laid out by ``bert.logical_axes`` and the sharded
train step. Random weights from seed 0; synthetic masked tokens (15% of
positions masked), ``--batch_size`` rows per process seeded ``1000 +
data_parallel_rank(mesh)`` (the JAX script seeds by task index, the same
number on dp/fsdp meshes; the data rank keeps tp ranks' shards equal),
assembled into the global batch by a ``DevicePrefetcher``;
``default_optimizer`` and :func:`~tony_tpu_torch.models.loop.run_training`.
bf16 on the card, f32 on the CPU (``--device cpu``, gloo); with no card
and no ``--device cpu`` it raises. Prints the JAX script's lines:
``[job:index] N global devices mesh={…}``, ``step {i} mlm loss {l} tok/s
{r}`` (global tokens) every 20 steps and ``done: final loss {l}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import numpy as np
import torch

import tony_tpu_torch.runtime as rt
from tony_tpu_torch import resolve_device
from tony_tpu_torch.io.prefetch import DevicePrefetcher
from tony_tpu_torch.models import bert as B
from tony_tpu_torch.models.loop import run_training
from tony_tpu_torch.models.train import (batch_sharding, data_parallel_rank,
                                         default_optimizer, init_state,
                                         make_train_step)
from tony_tpu_torch.parallel import mesh_shape, shard_pytree

CONFIGS = {"base": B.BERT_BASE, "tiny": B.BERT_TINY}
MASK_FRACTION = 0.15


def synthetic_mlm_batches(seed, batch, seq, cfg):
    """Infinite host-side MLM batches, the JAX script's stream: random
    token ids with 15% of positions replaced by ``mask_id = vocab - 1``
    and kept as targets (-1 = ignore elsewhere). Numpy, so the
    prefetcher's producer thread builds the next batch while the card
    computes."""
    rs = np.random.RandomState(seed)
    mask_id = cfg.vocab_size - 1
    while True:
        tokens = rs.randint(0, cfg.vocab_size,
                            size=(batch, seq)).astype(np.int32)
        masked = rs.rand(batch, seq) < MASK_FRACTION
        yield {
            "tokens": np.where(masked, mask_id, tokens).astype(np.int32),
            "targets": np.where(masked, tokens, -1).astype(np.int32),
        }


def build(config: str, device=None):
    """(cfg, params) for ``config`` on ``device``: bf16 on the card, f32
    on the CPU, random weights from seed 0."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(CONFIGS[config], dtype=torch.bfloat16
                              if dev.type == "cuda" else torch.float32)
    return cfg, B.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)


def make_step(cfg, lr: float, steps: int, mesh=None):
    """(optimizer, train step) as the JAX script builds them, sharded
    over ``mesh`` when one is given."""
    opt = default_optimizer(lr=lr, total_steps=steps)
    return opt, make_train_step(lambda p, b: B.mlm_loss(p, b, cfg, mesh),
                                opt, mesh)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="tiny", choices=sorted(CONFIGS))
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--seq_len", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    info = rt.initialize(dev)
    mesh = rt.mesh(device=dev)
    print(f"[{info.job_name}:{info.task_index}] {mesh.size()} global "
          f"devices mesh={mesh_shape(mesh)}", flush=True)
    cfg, params = build(args.config, dev)
    seq = min(args.seq_len, cfg.max_seq)
    print(f"device={dev} config={args.config} dtype={cfg.dtype}", flush=True)
    params = shard_pytree(params, B.logical_axes(cfg), mesh)
    opt, step = make_step(cfg, args.lr, args.steps, mesh)
    state = init_state(params, opt)
    data = DevicePrefetcher(
        synthetic_mlm_batches(1000 + data_parallel_rank(mesh),
                              args.batch_size, seq, cfg),
        sharding=batch_sharding(mesh, logical=("batch", "seq")))
    t0 = time.perf_counter()

    def log_fn(i, metrics, batch):
        # global tokens: the assembled batch's leading dim is global
        tok_s = (batch["tokens"].shape[0] * seq * (i + 1)
                 / (time.perf_counter() - t0))
        print(f"step {i} mlm loss {float(metrics['loss']):.4f} "
              f"tok/s {tok_s:,.0f}", flush=True)

    state, metrics = run_training(step, state, data, args.steps,
                                  log_every=20, log_fn=log_fn)
    loss = float(metrics["loss"]) if metrics else float("nan")
    print(f"done: final loss {loss:.4f}", flush=True)
    return 0 if math.isfinite(loss) else 1


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        rt.shutdown()
    sys.exit(rc)
