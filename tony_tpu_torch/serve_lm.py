"""Serve the flagship LM with continuous batching — the port's closed-batch
serving run.

    python -m tony_tpu_torch.serve_lm --preset small --requests 24 \\
        --slots 8 --prompt_len 256 --max_new_tokens 64

Random weights from a seed, random prompts of ``--prompt_len`` tokens,
random budgets between ``max_new_tokens / 4`` and ``max_new_tokens``,
all served greedily through ``--slots`` cache slots of ``prompt_len +
max_new_tokens`` positions by
:class:`~tony_tpu_torch.models.serve.ContinuousBatcher`. Runs on the
card in bf16 unless ``--device cpu`` is passed (then f32); with no card
and no ``--device cpu`` it raises. Prints the same lines as the JAX
package's ``examples/lm/serve_lm.py`` closed-batch run.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.serve import ContinuousBatcher


def make_workload(seed: int, requests: int, prompt_len: int,
                  max_new_tokens: int, vocab: int,
                  min_prompt_len: int | None = None):
    """(prompts, budgets): prompts of ``prompt_len`` tokens (uniform in
    [min_prompt_len, prompt_len] when given), budgets uniform in
    [max(1, max_new_tokens // 4), max_new_tokens], from ``seed``."""
    rs = np.random.RandomState(seed)
    lens = ([prompt_len] * requests if min_prompt_len is None
            else rs.randint(min_prompt_len, prompt_len + 1, size=requests))
    prompts = [list(rs.randint(0, vocab, size=int(n))) for n in lens]
    budgets = [int(b) for b in
               rs.randint(max(1, max_new_tokens // 4), max_new_tokens + 1,
                          size=requests)]
    return prompts, budgets


def build(preset: str, device=None):
    """(cfg, params) for ``preset`` at full width on ``device``: bf16 on
    the card, f32 on the CPU, random weights from seed 0."""
    dev = resolve_device(device)
    cfg = T.PRESETS[preset].scaled(
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
        remat=False)
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device=dev)
    return cfg, params


def serve(batcher: ContinuousBatcher, prompts, budgets) -> dict:
    """Serve the workload, print the run's lines, return its numbers."""
    t0 = time.perf_counter()
    outputs = batcher.serve(prompts, budgets)
    if batcher.device.type == "cuda":
        torch.cuda.synchronize(batcher.device)
    dt = time.perf_counter() - t0
    useful = sum(len(o) for o in outputs)
    util = useful / max(1, batcher.steps_executed * batcher.batch)
    print(f"served {len(prompts)} requests ({useful} tokens) through "
          f"{batcher.batch} slots in {dt:.2f}s incl. compile — greedy")
    print(f"decode steps: {batcher.steps_executed} "
          f"(slot-step utilization {util:.2f})")
    phases = batcher.phase_times.summary()
    if phases:
        print("host phases:",
              "  ".join(f"{name} {v['total_s']:.2f}s/{v['count']}"
                        for name, v in phases.items()))
    print("first request tokens:", outputs[0][:12])
    return {"outputs": outputs, "wall_s": dt, "tokens": useful,
            "utilization": util}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="tiny", choices=sorted(T.PRESETS))
    parser.add_argument("--requests", type=int, default=12)
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--prompt_len", type=int, default=16)
    parser.add_argument("--max_new_tokens", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_pipeline", action="store_true",
                        help="sequential serve loop (the A/B baseline)")
    parser.add_argument("--no_bucketed_admission", action="store_true",
                        help="admit one request per prefill forward")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg, params = build(args.preset, args.device)
    prompts, budgets = make_workload(args.seed, args.requests,
                                     args.prompt_len, args.max_new_tokens,
                                     cfg.vocab_size)
    batcher = ContinuousBatcher(
        params, cfg, batch=args.slots,
        max_len=args.prompt_len + args.max_new_tokens,
        pipeline=not args.no_pipeline,
        bucketed_admission=not args.no_bucketed_admission)
    serve(batcher, prompts, budgets)
    return 0


if __name__ == "__main__":
    sys.exit(main())
