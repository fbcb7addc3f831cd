"""Chip smoke test of the PyTorch / CUDA port (tony_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100. Phases,
each printing its own lines; any failure exits non-zero and prints no
result:

1. the card (name and power limit as nvidia-smi reports them), torch and
   CUDA versions — no card means exit 1;
2. build the serving path's CUDA kernel from ``tony_tpu_torch/csrc``;
3. hold the flash-attention forward kernel (K1) against its plain torch
   version on the card: f32 and bf16, MHA and GQA, causal / window 64 /
   non-causal, S in {17, 128, 512}, head_dim in {64, 128}; and at the
   serving path's shapes, [8, S_b, 8, 64] bf16 causal for every admission
   bucket S_b in {64, 128, 256, 512}; then time the kernel, the plain version and PyTorch's scaled_dot_product_attention
   (a yardstick only — the port never calls it) at the serving prefill
   shape, beside the bound computed from this call's FLOPs and bytes;
4. slice parity in f32: the ``small`` preset with one set of seeded
   weights on the card and on the CPU — bucketed prefill logits of 4
   prompts (max abs <= 1e-3) and the token agreement of 8 greedy
   requests of 16 tokens; then, on the card, 8 requests served on the
   blockwise cache walk each against ``generate`` of its prompt alone;
5. the serving slice at full width in bf16: ``small`` through
   ``tony_tpu_torch.serve_lm``'s code path, 24 mixed requests through 8
   slots, pipelined; every request gets its budget, every token is in the
   vocabulary, and K1 ran n_layers times per admit_rows call; then a
   short serve under torch.profiler gives the device busy share and the
   device launches per decode step;
6. a JSON line of per-kernel numbers, the card line, and the result
   line ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters``
    calls after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"{torch.cuda.get_device_name(0)}, power limit unknown"
    print(f"[1] card: {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from tony_tpu_torch.ops import _kernels
    seconds = _kernels.build()
    print(f"[2] built {os.path.relpath(_kernels.SOURCE, HERE)} in "
          f"{seconds:.1f}s", flush=True)
    for line in _kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"    {line.strip()}")
    return seconds


def _qkv(b, s, h, kv, d, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda heads: torch.randn(b, s, heads, d, device="cuda",
                                   generator=g).to(dtype)
    return mk(h), mk(kv), mk(kv)


def phase_kernel(report):
    import torch
    import torch.nn.functional as F
    from tony_tpu_torch.ops import attention as A
    limits = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-3)}
    worst = {dt: [0.0, 0.0, ""] for dt in limits}
    n = 0
    for dtype in limits:
        for kv in (8, 2):
            for causal, window in ((True, None), (True, 64), (False, None)):
                for s in (17, 128, 512):
                    for d in (64, 128):
                        q, k, v = _qkv(2, s, 8, kv, d, dtype, seed=n)
                        o, lse = A.flash_attention_with_lse(
                            q, k, v, causal=causal, window=window)
                        ro, rlse = A._dense_with_lse(
                            q.float(), k.float(), v.float(), causal=causal,
                            scale=None, window=window)
                        torch.cuda.synchronize()
                        eo = (o.float() - ro).abs().max().item()
                        el = (lse - rlse).abs().max().item()
                        w = worst[dtype]
                        if eo > w[0] or el > w[1]:
                            w[:] = [max(eo, w[0]), max(el, w[1]),
                                    f"kv={kv} causal={causal} "
                                    f"window={window} S={s} D={d}"]
                        n += 1
    for dtype, (lo, ll) in limits.items():
        eo, el, where = worst[dtype]
        name = str(dtype).replace("torch.", "")
        print(f"[3] K1 vs plain, {name}: max |o| err {eo:.3e} (limit "
              f"{lo:g}), max |lse| err {el:.3e} (limit {ll:g}); worst at "
              f"{where}", flush=True)
        if not (eo <= lo and el <= ll):
            fail(f"K1 disagrees with its plain version in {name}")
    report["k1_cases"] = n
    report["k1_worst"] = {str(k): v for k, v in worst.items()}

    # the serving path's shapes: [8, S_b, 8, 64] bf16 causal for every
    # admission bucket S_b the phase-5 workload makes; time at 512
    b, h, d = 8, 8, 64
    lo, ll = limits[torch.bfloat16]
    err = 0.0
    for s in (64, 128, 256, 512):
        q, k, v = _qkv(b, s, h, h, d, torch.bfloat16, seed=99 + s)
        o, lse = A.flash_attention_with_lse(q, k, v, causal=True)
        ro, rlse = A._dense_with_lse(q.float(), k.float(), v.float(),
                                     causal=True, scale=None)
        eo = (o.float() - ro).abs().max().item()
        el = (lse - rlse).abs().max().item()
        print(f"[3] K1 vs plain at [{b}, {s}, {h}, {d}] bf16 causal: "
              f"|o| err {eo:.3e} (limit {lo:g}), |lse| err {el:.3e} "
              f"(limit {ll:g})", flush=True)
        if not (eo <= lo and el <= ll):
            fail(f"K1 disagrees with its plain version at S={s}")
        err = max(err, eo)
    ms = time_ms(lambda: A.flash_attention_with_lse(q, k, v, causal=True))
    plain_ms = time_ms(lambda: A._dense_with_lse(q, k, v, causal=True,
                                                 scale=None))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    pairs = b * h * s * (s + 1) // 2                # attended (q, k) pairs
    flops = 4 * d * pairs
    nbytes = 4 * b * s * h * d * 2 + b * h * s * 4  # q, k, v, o + lse
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[3] K1 at B={b} S={s} H={h} D={d} bf16 causal: kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB); kernel at "
          f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    report["k1_timing"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               flops=flops, bytes=nbytes, max_abs_err=err)
    return dict(name="flash_fwd", route="cuda",
                source="tony_tpu_torch/csrc/flash_fwd.cu",
                replaces="tony_tpu/ops/attention.py:173", launches=None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


def phase_parity(report):
    import numpy as np
    import torch
    from tony_tpu_torch.models import decode as D
    from tony_tpu_torch.models import transformer as T
    cfg = T.PRESETS["small"].scaled(dtype=torch.float32, remat=False)
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    gpu = {n: ({k: a.cuda() for k, a in v.items()} if isinstance(v, dict)
               else v.cuda()) for n, v in cpu.items()}
    rs = np.random.RandomState(1)
    lens = np.array([37, 64, 100, 128], np.int32)
    toks = rs.randint(0, cfg.vocab_size, size=(4, 128))
    lg_c, _ = D.prefill_rows(cpu, torch.from_numpy(toks),
                             torch.from_numpy(lens), cfg)
    lg_g, _ = D.prefill_rows(gpu, torch.from_numpy(toks).cuda(),
                             torch.from_numpy(lens).cuda(), cfg)
    err = (lg_g.cpu() - lg_c).abs().max().item()
    prompts = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(8, 32)))
    out_c = D.generate(cpu, prompts, cfg, 16).tokens[:, 32:]
    out_g = D.generate(gpu, prompts.cuda(), cfg, 16).tokens[:, 32:].cpu()
    agree = (out_c == out_g).float().mean().item()
    same = int((out_c == out_g).all(dim=1).sum())
    print(f"[4] f32 small, card vs CPU: prefill logits max |err| {err:.3e} "
          f"(limit 1e-3); greedy tokens agree {agree:.4f} "
          f"({same}/8 requests identical)", flush=True)
    report["parity"] = dict(prefill_max_abs_err=err, token_agreement=agree,
                            identical_requests=same)
    if not err <= 1e-3:
        fail("f32 prefill logits differ between the card and the CPU")
    phase_serve_vs_generate(report, gpu, cfg)
    del gpu
    torch.cuda.empty_cache()


def phase_serve_vs_generate(report, params, cfg):
    """The batcher on the blockwise cache walk against each request
    decoded alone, in f32 on the card: 8 requests of 10-500 tokens
    through 4 slots of 1024 positions, so slots are reused and the
    longest live row crosses the 256- and 512-position block edges while
    decoding (the walk's bound is the largest frontier in the batcher's
    host mirror, so a mirror that fell behind would skip the new block).
    A served request must equal ``generate`` of its prompt, or first
    differ where the two tokens' logits lie within 1e-4 of each other: a
    near-tie that f32 rounding may break either way."""
    import numpy as np
    import torch
    from tony_tpu_torch.models import decode as D
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.models import transformer as T
    rs = np.random.RandomState(2)
    prompts = [[int(t) for t in rs.randint(0, cfg.vocab_size, size=n)]
               for n in (250, 100, 30, 200, 500, 240, 60, 10)]
    budgets = [40, 48, 16, 24, 30, 44, 20, 12]
    batcher = S.ContinuousBatcher(params, cfg, batch=4, max_len=1024,
                                  chunk=8, pipeline=True)
    outs = batcher.serve(prompts, budgets)
    identical, gaps = 0, []
    for p, n, out in zip(prompts, budgets, outs):
        solo = D.generate(params, torch.tensor([p], device="cuda"), cfg,
                          n).tokens[0, len(p):].tolist()
        if out == solo:
            identical += 1
            continue
        j = next(i for i, (a, b) in enumerate(zip(out, solo)) if a != b)
        logits, _ = T.forward(params, torch.tensor([p + solo[:j]],
                                                   device="cuda"), cfg)
        last = logits[0, -1].float()
        gap = (last[solo[j]] - last[out[j]]).abs().item()
        gaps.append(gap)
        if not gap <= 1e-4:
            fail(f"a served request differs from generate at token {j} "
                 f"where the logits are {gap:.3e} apart (limit 1e-4)")
    print(f"[4b] f32 small served at max_len 1024 ({batcher.steps_executed} "
          f"steps, 8 requests, 4 slots) vs generate per request: "
          f"{identical}/8 identical, {len(gaps)} first differing at a "
          f"near-tie (logit gaps {[f'{g:.2e}' for g in gaps]})", flush=True)
    report["serve_vs_generate"] = dict(identical=identical, tie_gaps=gaps,
                                       steps=batcher.steps_executed)


def phase_serve(report, card):
    import torch
    from tony_tpu_torch import serve_lm
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.ops import attention as A
    cfg, params = serve_lm.build("small", "cuda")
    prompts, budgets = serve_lm.make_workload(
        0, 24, 480, 64, cfg.vocab_size, min_prompt_len=64)
    batcher = S.ContinuousBatcher(params, cfg, batch=8, max_len=1024,
                                  chunk=8, pipeline=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.flash_forward.launches = 0
    S.CALL_COUNTS.clear()
    res = serve_lm.serve(batcher, prompts, budgets)
    launches = A.flash_forward.launches
    admits = sum(c for (name, _), c in S.CALL_COUNTS.items()
                 if name == "admit_rows")
    peak = torch.cuda.max_memory_allocated()
    outs = res["outputs"]
    tok_s = res["tokens"] / res["wall_s"]
    print(f"[5] small bf16 on {card}: {len(prompts)} requests, "
          f"{res['tokens']} tokens in {res['wall_s']:.3f}s "
          f"({tok_s:.1f} tokens/s), slot-step utilization "
          f"{res['utilization']:.3f}, peak memory {peak / 2**20:.1f} MiB, "
          f"K1 launches {launches} over {admits} admit_rows calls",
          flush=True)
    report["serve"] = dict(wall_s=res["wall_s"], tokens=res["tokens"],
                           tokens_per_s=tok_s,
                           utilization=res["utilization"],
                           steps=batcher.steps_executed,
                           peak_bytes=peak, k1_launches=launches,
                           admit_rows_calls=admits,
                           phases=batcher.phase_times.summary())
    if [len(o) for o in outs] != budgets:
        fail("a request did not get exactly its budget")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        fail("a generated token is outside the vocabulary")
    if admits == 0 or launches != cfg.n_layers * admits:
        fail(f"K1 launches {launches} != {cfg.n_layers} x {admits} "
             f"admit_rows calls")
    phase_profile(report, batcher, prompts[:8], budgets[:8])
    return launches


def phase_profile(report, batcher, prompts, budgets):
    """Device busy share of a short serve: the kernel time torch.profiler
    records on the card over the serve's host wall clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batcher.serve(prompts, budgets)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, launches = {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            dev[e.key] = us
            launches += e.count
    per_step = launches / max(1, batcher.steps_executed)
    total = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:5]
    k1 = sum(us for name, us in dev.items() if "flash_fwd" in name)
    if total == 0:
        print("[5b] device busy share: not measured (the profiler recorded "
              "no device time)", flush=True)
    else:
        print(f"[5b] profiled serve of {len(prompts)} requests: device busy "
              f"{total / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall "
              f"(share {total / wall_us:.3f}); {launches} device launches "
              f"over {batcher.steps_executed} decode steps ({per_step:.1f} "
              f"per step, admission included); K1 {k1 / 1e3:.2f} ms; top: "
              + "; ".join(f"{n[:48]} {us / 1e3:.1f} ms" for n, us in top),
              flush=True)
    report["profile"] = dict(wall_us=wall_us, device_us=total, k1_us=k1,
                             launches=launches,
                             steps=batcher.steps_executed, top=top)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tony_tpu_torch")):
        fail("run chip_smoke.py from the repository root (tony_tpu_torch/ "
             "not found beside it)")
    sys.path.insert(0, HERE)
    import torch
    card = phase_card()
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    report["build_s"] = phase_build()
    k1 = phase_kernel(report)
    phase_parity(report)
    k1["launches"] = phase_serve(report, card)
    report["wall_s"] = time.perf_counter() - t0
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": [k1]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
