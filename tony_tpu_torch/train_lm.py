"""Train the flagship decoder LM on one device — the port's counterpart of
``examples/lm/train_lm.py``.

    python -m tony_tpu_torch.train_lm --preset small --steps 100 \\
        --batch_size 16 --seq_len 1024 [--ckpt_dir DIR --ckpt_every N]

Random weights from seed 0 and synthetic tokens (seeded by the attempt
number, as the JAX script seeds them) through a ``DevicePrefetcher``
(``--prefetch_depth 0``: the synchronous feed), the train step of
:func:`~tony_tpu_torch.models.train.make_train_step` with
``default_optimizer`` and :func:`~tony_tpu_torch.models.loop.run_training`.
bf16 on the card, f32 on the CPU (``--device cpu``); with no card and no
``--device cpu`` it raises. With ``--ckpt_dir`` holding a checkpoint the
run resumes from it. Prints the JAX script's lines: ``step {s} loss {l}
tok/s {r}`` every 20 steps and ``done: final loss {l}``.

Options of later slices (``--data_files``, ``--elastic_data``,
``--cp_strategy``, ``--num_experts``, ``--pp_schedule``) are not ported.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from tony_tpu_torch import resolve_device
from tony_tpu_torch.io.prefetch import DevicePrefetcher, synchronous_batches
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.checkpoint import CheckpointManager, attempt_number
from tony_tpu_torch.models.loop import GangLostError, run_training
from tony_tpu_torch.models.train import (default_optimizer, init_state,
                                         make_train_step)


def synthetic_source(seed: int, batch: int, seq: int, vocab: int):
    """Infinite host-side token batches (numpy: the prefetcher's producer
    thread converts and copies them while the card computes)."""
    rs = np.random.RandomState(seed)
    while True:
        tokens = rs.randint(0, vocab, size=(batch, seq + 1)).astype(np.int32)
        yield {"inputs": tokens[:, :seq], "targets": tokens[:, 1:]}


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


def make_data(source, device, prefetch_depth: int):
    """The batch iterator: a ``DevicePrefetcher`` of ``prefetch_depth``,
    or the synchronous feed when it is 0."""
    if prefetch_depth > 0:
        return DevicePrefetcher(source, device=device, depth=prefetch_depth)
    return synchronous_batches(source, device=device)


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
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, params = build(args.preset, dev, args.attn_window)
    print(f"attempt={attempt_number()} device={dev} preset={args.preset} "
          f"dtype={cfg.dtype}", flush=True)
    opt = default_optimizer(lr=args.lr, total_steps=args.steps)
    step_fn = make_train_step(lambda p, b: T.lm_loss(p, b, cfg), opt)

    mgr = (CheckpointManager(args.ckpt_dir,
                             save_interval_steps=args.ckpt_every)
           if args.ckpt_dir else None)
    state = (mgr.restore_or_init(lambda: init_state(params, opt))
             if mgr else init_state(params, opt))
    start_step = int(state["step"])

    source = synthetic_source(1000 * attempt_number(), args.batch_size,
                              args.seq_len, cfg.vocab_size)
    data = make_data(source, dev, args.prefetch_depth)
    t0 = time.perf_counter()

    def log_fn(step, metrics, batch):
        loss = float(metrics["loss"])
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
    sys.exit(main())
