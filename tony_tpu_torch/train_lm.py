"""Train the flagship decoder LM, sharded over every process of the job —
the port's counterpart of ``examples/lm/train_lm.py``.

    python -m tony_tpu_torch.train_lm --preset small --steps 100 \\
        --batch_size 16 --seq_len 1024 [--ckpt_dir DIR --ckpt_every N] \\
        [--data_files F ... [--elastic_data GLOBAL_BATCH]]

Under the orchestrator (``tony_tpu.client.cli submit --executes 'python
-m tony_tpu_torch.train_lm ...'``, mesh from ``tony.application.mesh``)
it boots the process group from the executor's environment
(``runtime.initialize``), builds the mesh (``runtime.mesh``; a lone
process gets a world-1 mesh, the same code path), lays the params out by
``transformer.logical_axes`` and trains with the sharded step. Random
weights from seed 0. The tokens, ``--batch_size`` rows per process,
assembled into the global batch by a ``DevicePrefetcher``
(``--prefetch_depth 0``: the synchronous feed), are synthetic, seeded by
``data_parallel_rank(mesh) + 1000 * attempt_number()`` as the JAX script
seeds them, or read from ``--data_files`` (records of ``seq_len + 1``
int32 ids): each data-parallel rank's byte-range split, reshuffled per
epoch from seed ``attempt_number()``, or with ``--elastic_data B`` the
world-size-invariant stream of global batch B from seed 0, resumed at the
restored step. The split is by data-parallel rank, so processes that
share a batch shard (pure tp) feed the same rows.
bf16 on the card, f32 on the CPU (``--device cpu``, gloo); with no card
and no ``--device cpu`` it raises. With ``--ckpt_dir`` holding a
checkpoint the run resumes from it (sharded, collectively). Prints the
JAX script's lines: ``[job:index] attempt=… mesh={…} devices=N``, ``step
{s} loss {l} tok/s {r}`` (global tokens) every 20 steps and ``done:
final loss {l}``.

Options of later slices (``--cp_strategy``, ``--num_experts``,
``--pp_schedule``) are not ported.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

import tony_tpu_torch.runtime as rt
from tony_tpu_torch import resolve_device
from tony_tpu_torch.io.prefetch import (DevicePrefetcher, elastic_epochs,
                                        reader_epochs, synchronous_batches)
from tony_tpu_torch.io.torch_feed import feed_split
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.checkpoint import CheckpointManager, attempt_number
from tony_tpu_torch.models.loop import GangLostError, run_training
from tony_tpu_torch.models.train import (batch_sharding, data_parallel_rank,
                                         default_optimizer, init_state,
                                         make_train_step)
from tony_tpu_torch.parallel import mesh_shape, shard_pytree


def synthetic_source(seed: int, batch: int, seq: int, vocab: int):
    """Infinite host-side token batches (numpy: the prefetcher's producer
    thread converts and copies them while the card computes)."""
    rs = np.random.RandomState(seed)
    while True:
        tokens = rs.randint(0, vocab, size=(batch, seq + 1)).astype(np.int32)
        yield {"inputs": tokens[:, :seq], "targets": tokens[:, 1:]}


def elastic_file_source(paths, global_batch: int, seq: int, seed: int,
                        start_step: int, mesh=None):
    """World-size-invariant feed for elastic jobs: the canonical
    single-reader stream sliced per data-parallel rank of ``mesh``, so
    the global batch at step s is identical before and after a shrink or
    regrow and the resumed loss curve continues where the checkpoint left
    it (``io.prefetch.elastic_epochs``; every process reads the whole
    dataset)."""
    pid, pcount = feed_split(mesh)
    rows, _ = elastic_epochs(paths, global_batch, np.int32, (seq + 1,),
                             shuffle=True, seed=seed, start_step=start_step,
                             process_index=pid, process_count=pcount)

    def batches():
        for tokens in rows:
            yield {"inputs": tokens[:, :seq], "targets": tokens[:, 1:]}

    return batches()


def file_source(paths, batch: int, seq: int, seed: int, mesh=None):
    """Epochal host-batch source over the sharded data-feed layer: each
    record is seq+1 int32 token ids; every data-parallel rank of ``mesh``
    reads only its byte-range split, reshuffled deterministically per
    epoch (seed + epoch). The prefetcher cycles epochs until the step
    loop stops pulling."""
    pid, pcount = feed_split(mesh)
    epoch_fn, per_epoch = reader_epochs(paths, batch, np.int32, (seq + 1,),
                                        shuffle=True, seed=seed,
                                        process_index=pid,
                                        process_count=pcount)
    if per_epoch == 0:
        raise ValueError(
            f"data files hold fewer than one full batch per process "
            f"(batch_size={batch}, seq_len={seq}) — nothing to train on")

    def epochs(epoch: int):
        for tokens in epoch_fn(epoch):
            yield {"inputs": tokens[:, :seq], "targets": tokens[:, 1:]}

    return epochs


def build(preset: str, device=None, attn_window: int = 0):
    """(cfg, params) for ``preset`` at full width on ``device``: bf16 on
    the card, f32 on the CPU, random weights from seed 0."""
    dev = resolve_device(device)
    cfg = T.PRESETS[preset].scaled(
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
        attn_window=attn_window)
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device=dev)
    return cfg, params


def make_data(source, device, prefetch_depth: int, sharding=None):
    """The batch iterator: a ``DevicePrefetcher`` of ``prefetch_depth``,
    or the synchronous feed when it is 0; with a ``sharding``, of global
    batches assembled from this process's shards."""
    if prefetch_depth > 0:
        return DevicePrefetcher(source, device=device, depth=prefetch_depth,
                                sharding=sharding)
    return synchronous_batches(source, device=device, sharding=sharding)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="tiny", choices=sorted(T.PRESETS))
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--seq_len", type=int, default=256)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--ckpt_dir", default="")
    parser.add_argument("--ckpt_every", type=int, default=50)
    parser.add_argument("--attn_window", type=int, default=0,
                        help="sliding-window attention: each token attends "
                             "its N most recent positions (0 = full causal)")
    parser.add_argument("--prefetch_depth", type=int, default=2,
                        help="device-prefetch queue depth; 0 = synchronous "
                             "inline feed (A/B contrast)")
    parser.add_argument("--data_files", nargs="*", default=[],
                        help="binary token files (records of seq_len+1 "
                             "int32 ids) fed through the sharded data "
                             "layer; empty = synthetic data")
    parser.add_argument("--elastic_data", type=int, default=0,
                        metavar="GLOBAL_BATCH",
                        help="feed --data_files through the world-size-"
                             "invariant elastic source with this fixed "
                             "global batch (it must divide over every "
                             "world size the job can shrink to)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.elastic_data and not args.data_files:
        raise SystemExit("--elastic_data requires --data_files")

    dev = resolve_device(args.device)
    info = rt.initialize(dev)
    mesh = rt.mesh(device=dev)
    print(f"[{info.job_name}:{info.task_index}] attempt={info.attempt} "
          f"mesh={mesh_shape(mesh)} devices={mesh.size()}", flush=True)
    cfg, params = build(args.preset, dev, args.attn_window)
    print(f"device={dev} preset={args.preset} dtype={cfg.dtype}", flush=True)
    params = shard_pytree(params, T.logical_axes(cfg), mesh)
    opt = default_optimizer(lr=args.lr, total_steps=args.steps)
    step_fn = make_train_step(lambda p, b: T.lm_loss(p, b, cfg, mesh), opt,
                              mesh)

    mgr = (CheckpointManager(args.ckpt_dir,
                             save_interval_steps=args.ckpt_every)
           if args.ckpt_dir else None)
    state = (mgr.restore_or_init(lambda: init_state(params, opt))
             if mgr else init_state(params, opt))
    start_step = int(state["step"])

    # split or seeded by the data-parallel rank, not the task index:
    # processes that share a batch shard (pure tp) must feed identical data
    if args.elastic_data:
        source = elastic_file_source(args.data_files, args.elastic_data,
                                     args.seq_len, seed=0,
                                     start_step=start_step, mesh=mesh)
    elif args.data_files:
        source = file_source(args.data_files, args.batch_size, args.seq_len,
                             seed=attempt_number(), mesh=mesh)
    else:
        source = synthetic_source(data_parallel_rank(mesh)
                                  + 1000 * attempt_number(),
                                  args.batch_size, args.seq_len,
                                  cfg.vocab_size)
    data = make_data(source, dev, args.prefetch_depth,
                     batch_sharding(mesh, logical=("batch", "seq")))
    t0 = time.perf_counter()

    def log_fn(step, metrics, batch):
        loss = float(metrics["loss"])
        # global tokens: the assembled batch's leading dim is global
        tok_s = (batch["inputs"].shape[0] * args.seq_len
                 * (step - start_step + 1) / (time.perf_counter() - t0))
        print(f"step {step} loss {loss:.4f} tok/s {tok_s:,.0f}", flush=True)

    try:
        state, metrics = run_training(
            step_fn, state, data, args.steps, start_step=start_step,
            checkpoint=mgr, log_every=20, log_fn=log_fn)
    except GangLostError as e:
        print(f"gang lost: {e}", flush=True)
        return e.exit_code
    if mgr:
        mgr.close()
    loss = float(metrics["loss"]) if metrics else float("nan")
    print(f"done: final loss {loss:.4f}", flush=True)
    return 0 if math.isfinite(loss) else 1


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        rt.shutdown()
    sys.exit(rc)
