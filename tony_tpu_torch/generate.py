"""Text generation from the flagship LM — the port's
``examples/lm/generate.py``.

Decodes one batch of random prompts with the KV-cache path (prefill,
then one decode step per token), sampled (top-k → temperature →
nucleus, from the threefry stream of ``--seed``) or, with
``--beam_width``, by beam search::

    python -m tony_tpu_torch.generate --preset small \\
        --max_new_tokens 64 --temperature 0.8
    python -m tony_tpu_torch.generate --device cpu --preset tiny \\
        --beam_width 4

The same flags as the JAX script. ``--ckpt_dir`` reads the port's own
``train_lm`` checkpoint (empty: random weights from seed 0). The prompts
are drawn with numpy from ``--seed`` (the JAX script draws them with
``jax.random.randint``, so the two scripts decode other prompts). The
model runs on the card in bf16 unless ``--device cpu`` is passed (then
f32); with no card and no ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.decode import beam_search, generate
from tony_tpu_torch.ops import prng
from tony_tpu_torch.serve_lm import build


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="tiny", choices=sorted(T.PRESETS))
    parser.add_argument("--ckpt_dir", default="",
                        help="a train_lm checkpoint directory (empty = "
                             "random params)")
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--prompt_len", type=int, default=16)
    parser.add_argument("--max_new_tokens", type=int, default=32)
    parser.add_argument("--temperature", type=float, default=0.8)
    parser.add_argument("--top_k", type=int, default=40)
    parser.add_argument("--top_p", type=float, default=0.0,
                        help="nucleus sampling mass (0 = off)")
    parser.add_argument("--beam_width", type=int, default=0,
                        help="beam search instead of sampling (> 0 "
                             "enables; returns the best beam)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg, params = build(args.preset, args.device, args.ckpt_dir)
    dev = params["embed"].device
    prompt = torch.as_tensor(np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, size=(args.batch_size, args.prompt_len)),
        device=dev)
    t0 = time.perf_counter()
    if args.beam_width > 0:
        beams = beam_search(params, prompt, cfg,
                            max_new_tokens=args.max_new_tokens,
                            beam_width=args.beam_width)
        best = beams.tokens[0, 0, args.prompt_len:].tolist()  # host fetch
        n = beams.tokens.shape[0] * args.max_new_tokens
        dt = time.perf_counter() - t0
        print(f"beam search W={args.beam_width}: best-beam shape "
              f"{tuple(beams.tokens.shape[::2])} in {dt:.2f}s "
              f"({n / dt:,.0f} tok/s)")
        print("best beam token ids:", best[:16])
        print("beam scores:", [round(float(x), 2) for x in beams.scores[0]])
        return 0
    out = generate(params, prompt, cfg, max_new_tokens=args.max_new_tokens,
                   rng=prng.PRNGKey(args.seed, device=dev),
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p)
    sample = out.tokens[0, args.prompt_len:].tolist()   # host fetch
    n = out.tokens.shape[0] * args.max_new_tokens
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.tokens.shape)} in {dt:.2f}s "
          f"({n / dt:,.0f} tok/s)")
    print("sample token ids:", sample[:16])
    print("mean logprob:", float(out.logprobs.mean()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
