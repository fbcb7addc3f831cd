"""Chip smoke test of the PyTorch / CUDA port (tony_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100. Phases,
each printing its own lines; any failure exits non-zero and prints no
result:

1. the card (name and power limit as nvidia-smi reports them), torch and
   CUDA versions — no card means exit 1;
2. build the five kernels from ``tony_tpu_torch/csrc`` (one nvcc per
   source, in parallel);
3. hold the flash-attention forward kernel (K1) against its plain torch
   version on the card: f32 and bf16, MHA and GQA, causal / windows 24,
   64 and 100 / non-causal, S in {17, 128, 512}, head_dim in {32, 64,
   128}; and at the main paths' shapes, [8, S_b, 8, 64] bf16 causal for
   every serving admission bucket S_b in {64, 128, 256, 512} and the
   training shape [16, 1024, 8, 64]; then time the kernel, the plain
   version and PyTorch's scaled_dot_product_attention (a yardstick only —
   the port never calls it) at the serving prefill shape, beside the
   bound computed from this call's FLOPs and bytes, and the kernel alone
   at the training shape;
6. hold the backward kernels, K2 (fused) and K3a + K3b (two-pass), against
   the plain backward (and K1's o and lse, which they read, against the
   plain forward): f32 and bf16, MHA and GQA, causal / windows 24, 64 and
   100 / non-causal, S in {17, 128, 512, 1024}, head_dim in {32, 64, 128},
   with and without an lse cotangent, both routes; then time both routes,
   the plain
   backward and SDPA's backward (yardstick) at [16, 1024, 8, 64] bf16
   causal, each beside its bound;
7. hold fused AdamW (K4) against its plain version over the ``small``
   parameter tree in bf16 and f32, 3 steps with a clip on one; then time
   it over the bf16 tree beside its byte bound, the plain version and
   ``torch.optim.AdamW(fused=True)`` (yardstick);
4. slice parity in f32: the ``small`` preset with one set of seeded
   weights on the card and on the CPU — bucketed prefill logits of 4
   prompts (max abs <= 1e-3) and the token agreement of 8 greedy
   requests of 16 tokens; then, on the card, 8 requests served on the
   blockwise cache walk each against ``generate`` of its prompt alone;
8. training parity in f32: 3 train steps of ``tiny`` on the card and on
   the CPU from one set of params, losses within 1e-4 relative, for the
   unfused and the fused optimizer;
5. the serving slice at full width in bf16: ``small`` through
   ``tony_tpu_torch.serve_lm``'s code path, 24 mixed requests through 8
   slots, pipelined; every request gets its budget, every token is in the
   vocabulary, and K1 ran n_layers times per admit_rows call; then a
   short serve under torch.profiler gives the device busy share and the
   device launches per decode step;
9. the training slice at full width: ``small`` bf16 through
   ``tony_tpu_torch.train_lm``'s code path, batch 16 x seq 1024, remat
   "full", DevicePrefetcher depth 2, 20 steps: every loss finite, K1
   launched 2 x n_layers per step (forward and remat recompute), K2
   n_layers per step, K3 never; step time, tokens/s, MFU, peak memory and
   data wait; a profiled window of 3 steps (device busy share); 3 steps
   with the fused optimizer (K4 once per leaf per step), 3 with the budget at 0
   (K3a and K3b n_layers per step each, K2 never), and a checkpoint at
   step 2 whose resume reaches the uninterrupted step-3 loss;
then a JSON line of per-kernel numbers, the card line, and the result
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

# (causal, window) cases of the attention kernels: windows 24 and 100 are
# not multiples of the kernels' 64-row tiles, so a window edge falls
# inside a tile
MASKS = ((True, None), (True, 24), (True, 64), (True, 100), (False, None))


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
    names = ", ".join(os.path.relpath(s, HERE) for s in _kernels.SOURCES)
    print(f"[2] built {names} in {seconds:.1f}s (one nvcc each, in "
          f"parallel)", flush=True)
    for src, log in _kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"    {src}: {line.strip()}")
    return seconds


def _k1_limits():
    """K1's limits against the plain forward, |o| and |lse| max abs:
    f32 (1e-4, 1e-5), bf16 (2e-2, 1e-3)."""
    import torch
    return {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-3)}


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
    limits = _k1_limits()
    worst = {dt: [0.0, 0.0, ""] for dt in limits}
    n = 0
    for dtype in limits:
        for kv in (8, 2):
            for causal, window in MASKS:
                for s in (17, 128, 512):
                    for d in (32, 64, 128):
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

    # the main paths' shapes, bf16 causal: [8, S_b, 8, 64] for every
    # admission bucket S_b the phase-5 workload makes, and phase 9's
    # training step [16, 1024, 8, 64]
    h, d = 8, 64
    lo, ll = limits[torch.bfloat16]
    err = 0.0
    for b, s in ((8, 64), (8, 128), (8, 256), (8, 512), (16, 1024)):
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
    train_ms = time_ms(lambda: A.flash_attention_with_lse(q, k, v,
                                                          causal=True))
    print(f"[3] K1 at the training shape [{b}, {s}, {h}, {d}] bf16 causal: "
          f"{train_ms:.4f} ms", flush=True)
    # timed at the serving prefill shape
    b, s = 8, 512
    q, k, v = _qkv(b, s, h, h, d, torch.bfloat16, seed=99 + s)
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
    report["k1_timing"] = dict(ms=ms, train_shape_ms=train_ms,
                               plain_ms=plain_ms, library_ms=lib_ms,
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


def _bwd_case(b, s, h, kv, d, dtype, causal, window, with_dlse, seed):
    """Inputs of one backward case on the card: q, k, v, do in ``dtype``,
    K1's o and lse (held to the plain forward at phase 3's limits), an
    lse cotangent or None, and the dense f32 gradient of the same inputs
    (the plain backward on f32 copies, with the plain forward's o and
    lse)."""
    import torch
    from tony_tpu_torch.ops import attention as A
    q, k, v = _qkv(b, s, h, kv, d, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 7919)
    do = torch.randn(q.shape, device="cuda", generator=g).to(dtype)
    dlse = (torch.randn((b, h, s), device="cuda", generator=g)
            if with_dlse else None)
    o, lse = A.flash_forward(q, k, v, causal=causal, scale=d ** -0.5,
                             window=window)
    f32 = [x.float() for x in (q, k, v)]
    ro, rlse = A._dense_with_lse(*f32, causal=causal, scale=None,
                                 window=window)
    eo = (o.float() - ro).abs().max().item()
    el = (lse - rlse).abs().max().item()
    lo, ll = _k1_limits()[dtype]
    if not (eo <= lo and el <= ll):
        fail(f"K1 disagrees with its plain version in a backward case: "
             f"|o| err {eo:.3e} (limit {lo:g}), |lse| err {el:.3e} (limit "
             f"{ll:g}) at B={b} S={s} H={h} KV={kv} D={d} {dtype} "
             f"causal={causal} window={window}")
    ref = A._dense_backward(*f32, ro, rlse, do.float(), dlse, causal=causal,
                            scale=None, window=window)
    return (q, k, v, o, lse, do, dlse), ref


def _run_route(route, args, causal, window):
    from tony_tpu_torch.ops import attention as A
    kw = dict(causal=causal, scale=args[0].shape[-1] ** -0.5, window=window)
    if route == "fused":
        return A.flash_backward_fused(*args, **kw)
    dq = A.flash_backward_dq(*args, **kw)
    return (dq,) + A.flash_backward_dkv(*args, **kw)


def phase_backward(report):
    """[6] K2 and K3a/K3b against the plain backward on the card, then
    timed at the training slice's shape."""
    import torch
    import torch.nn.functional as F
    from tony_tpu_torch.ops import attention as A
    # f32: 1e-4 of the reference's largest entry (at least 1e-4 absolute):
    # dK and dV sum up to 1024 query rows of a 4-head group in f32, so the
    # rounding grows with the gradient's size. bf16: 2% of the largest
    # entry, against the dense f32 gradient of the same bf16 inputs.
    rel = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = {}
    n = 0
    for dtype in rel:
        for kv in (8, 2):
            for causal, window in MASKS:
                for s in (17, 128, 512, 1024):
                    w_s = A._resolve_window(window, causal, s)
                    for d in (32, 64, 128):
                        for with_dlse in (False, True):
                            args, ref = _bwd_case(2, s, 8, kv, d, dtype,
                                                  causal, w_s, with_dlse,
                                                  seed=1000 + n)
                            for route in ("fused", "two_pass"):
                                got = _run_route(route, args, causal, w_s)
                                torch.cuda.synchronize()
                                for name, g, r in zip(("dq", "dk", "dv"),
                                                      got, ref):
                                    scale = r.abs().max().item()
                                    lim = rel[dtype] * (max(1.0, scale)
                                                        if dtype ==
                                                        torch.float32
                                                        else scale)
                                    err = (g.float() - r).abs().max().item()
                                    key = (str(dtype), route)
                                    w = worst.setdefault(key, [0.0, ""])
                                    if err / lim > w[0]:
                                        w[:] = [err / lim, (
                                            f"{name} err {err:.3e} limit "
                                            f"{lim:.3e} at kv={kv} "
                                            f"causal={causal} window={window}"
                                            f" S={s} D={d} dlse={with_dlse}")]
                                    if not err <= lim:
                                        fail(f"{route} backward disagrees "
                                             f"with the plain version: "
                                             f"{name} err {err:.3e} > "
                                             f"{lim:.3e} ({dtype}, kv={kv}, "
                                             f"causal={causal}, window="
                                             f"{window}, S={s}, D={d}, "
                                             f"dlse={with_dlse})")
                            n += 1
    for (dtype, route), (ratio, where) in sorted(worst.items()):
        print(f"[6] {route} backward vs plain, {dtype}: worst err/limit "
              f"{ratio:.3f} ({where})", flush=True)
    report["bwd_cases"] = n
    report["bwd_worst"] = {f"{a} {b}": v for (a, b), v in worst.items()}

    # the training slice's shape: [16, 1024, 8, 64] bf16 causal
    b, s, h, d = 16, 1024, 8, 64
    dt = torch.bfloat16
    args, ref = _bwd_case(b, s, h, h, d, dt, True, None, False, seed=4242)
    q, k, v, o, lse, do, _ = args
    errs, abs_errs = {}, {}
    for route in ("fused", "two_pass"):
        got = _run_route(route, args, True, None)
        diffs = [(g.float() - r).abs().max().item() for g, r in zip(got, ref)]
        abs_errs[route] = max(diffs)
        errs[route] = max(e / max(r.abs().max().item(), 1e-30)
                          for e, r in zip(diffs, ref))
        if not errs[route] <= 2e-2:
            fail(f"{route} backward at the slice shape: relative err "
                 f"{errs[route]:.3e} > 2e-2")
    del ref
    kw = dict(causal=True, scale=d ** -0.5, window=None)
    plain = lambda: A._dense_backward(q, k, v, o, lse, do, None, causal=True,
                                      scale=None)
    times = {
        "fused": time_ms(lambda: A.flash_backward_fused(
            q, k, v, o, lse, do, **kw), iters=10),
        "dq": time_ms(lambda: A.flash_backward_dq(
            q, k, v, o, lse, do, **kw), iters=10),
        "dkv": time_ms(lambda: A.flash_backward_dkv(
            q, k, v, o, lse, do, **kw), iters=10),
        "plain": time_ms(plain, iters=3),
    }
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    times["sdpa_bwd"] = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=10)
    del out
    pairs = b * h * s * (s + 1) // 2
    tensor = b * s * h * d * 2                     # one [B,S,H,D] bf16
    rows = b * h * s * 4                           # one [B,H,S] f32
    # products over the attended pairs and bytes read + written:
    # K2 and the whole backward: q k^T, do v^T, p^T do, ds^T q, ds k;
    # K3a: q k^T, do v^T, ds k (reads q k v do lse delta, writes dq);
    # K3b: q k^T, do v^T, p^T do, ds^T q (writes dk, dv)
    work = {"fused": (5, 5 * tensor + rows, 3 * tensor),
            "dq": (3, 4 * tensor + 2 * rows, tensor),
            "dkv": (4, 4 * tensor + 2 * rows, 2 * tensor)}
    out_rows = {}
    for name, (products, rd, wr) in work.items():
        flops = products * 2 * d * pairs
        t_ops = flops / BF16_FLOPS * 1e3
        t_bytes = (rd + wr) / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        out_rows[name] = dict(ms=times[name], bound_ms=bound,
                              bound_by="operations" if t_ops >= t_bytes
                              else "bytes", flops=flops, bytes=rd + wr)
        print(f"[6] {name} at B={b} S={s} H={h} D={d} bf16 causal: "
              f"{times[name]:.4f} ms, bound {bound:.5f} ms by "
              f"{out_rows[name]['bound_by']} ({flops / 1e9:.2f} GFLOP, "
              f"{(rd + wr) / 1e6:.2f} MB); {flops / times[name] / 1e9:.1f} "
              f"TFLOP/s", flush=True)
    print(f"[6] two-pass total {times['dq'] + times['dkv']:.4f} ms; plain "
          f"backward {times['plain']:.4f} ms; sdpa backward "
          f"{times['sdpa_bwd']:.4f} ms; err (max abs, relative to the "
          f"largest entry) fused {abs_errs['fused']:.3e} "
          f"({errs['fused']:.3e}), two-pass {abs_errs['two_pass']:.3e} "
          f"({errs['two_pass']:.3e})", flush=True)
    report["bwd_timing"] = dict(times=times, rows=out_rows, errs=errs,
                                abs_errs=abs_errs)
    entries = {}
    for name, kname, src_line in (
            ("fused", "flash_bwd_fused", "tony_tpu/ops/attention.py:339"),
            ("dq", "flash_bwd_dq", "tony_tpu/ops/attention.py:525"),
            ("dkv", "flash_bwd_dkv", "tony_tpu/ops/attention.py:571")):
        r = out_rows[name]
        entries[name] = dict(
            name=kname, route="cuda",
            source="tony_tpu_torch/csrc/flash_bwd.cu", replaces=src_line,
            launches=None, max_abs_err=abs_errs["fused" if name == "fused"
                                                else "two_pass"],
            ms=r["ms"], plain_ms=times["plain"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=times["sdpa_bwd"])
    return entries


def _ulps(got, want, mant_bits):
    """|got - want| in units of the last place of ``want`` in a type with
    ``mant_bits`` explicit mantissa bits."""
    import torch
    w = want.double()
    _, e = torch.frexp(w.abs().clamp(min=2.0 ** -120))
    ulp = torch.ldexp(torch.ones_like(w), e - 1 - mant_bits)
    return ((got.double() - w).abs() / ulp).max().item()


def phase_adamw(report):
    """[7] K4 against its plain version on the `small` tree, then timed."""
    import torch
    from tony_tpu_torch import tree_leaves
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.ops import optim as O
    mant = {torch.bfloat16: 7, torch.float32: 23}
    worst = {}
    for dtype in mant:
        cfg = T.PRESETS["small"].scaled(dtype=dtype)
        params = tree_leaves(T.init_params(
            torch.Generator().manual_seed(3), cfg, device="cuda"))
        opt = O.FusedAdamW(lambda c: 1e-3 * (c + 1), weight_decay=0.01)
        kern = [(p.clone(), torch.zeros_like(p, dtype=torch.float32),
                 torch.zeros_like(p, dtype=torch.float32)) for p in params]
        plain = [tuple(t.clone() for t in x) for x in kern]
        g = torch.Generator(device="cuda").manual_seed(11)
        w = worst.setdefault(str(dtype), [0.0, 0.0, 0.0])
        for count in range(3):
            scale = 5.0 if count == 1 else 1e-5   # only step 1 clips
            grads = [(torch.randn(p.shape, device="cuda", generator=g)
                      * scale).to(dtype) for p in params]
            gnorm = O._global_norm(grads)
            clip = torch.where(gnorm < 1.0, torch.ones_like(gnorm),
                               1.0 / gnorm)
            scalars = torch.cat([torch.from_numpy(
                opt.host_scalars(count)).cuda(), clip.reshape(1)])
            for (p, m, v), (pp, pm, pv), gr in zip(kern, plain, grads):
                O.adamw_update(p, gr, m, v, scalars)
                np_, nm, nv = O._plain_leaf_update(pp, gr, pm, pv, scalars)
                pp.copy_(np_)
                pm.copy_(nm)
                pv.copy_(nv)
            torch.cuda.synchronize()
            for (p, m, v), (pp, pm, pv) in zip(kern, plain):
                w[0] = max(w[0], _ulps(p, pp, mant[dtype]))
                w[2] = max(w[2], (p.float() - pp.float()).abs().max().item())
                for a, b_ in ((m, pm), (v, pv)):
                    r = ((a - b_).abs() / b_.abs().clamp(min=1e-30)).max()
                    w[1] = max(w[1], r.item())
            if (clip.item() < 1.0) != (count == 1):
                fail("phase 7 should clip on step 1 and only there")
        print(f"[7] K4 vs plain, {dtype} small tree ({len(params)} leaves, "
              f"3 steps, step 1 clipped): params max {w[0]:.2f} ulp (limit "
              f"1; max abs {w[2]:.2e}), moments max rel err {w[1]:.2e} "
              f"(limit 1e-6)", flush=True)
        if not (w[0] <= 1.0 and w[1] <= 1e-6):
            fail(f"K4 disagrees with its plain version in {dtype}")
    report["adamw_worst"] = worst

    # timed on the bf16 tree: every leaf once, as a training step does
    cfg = T.PRESETS["small"].scaled(dtype=torch.bfloat16)
    params = tree_leaves(T.init_params(torch.Generator().manual_seed(3),
                                         cfg, device="cuda"))
    grads = [torch.randn_like(p) * 1e-3 for p in params]
    ms_ = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    vs_ = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    scalars = torch.cat([torch.from_numpy(O.FusedAdamW(1e-4).host_scalars(
        0)).cuda(), torch.ones(1, device="cuda")])
    n = sum(p.numel() for p in params)

    def kernel():
        for p, gr, m, v in zip(params, grads, ms_, vs_):
            O.adamw_update(p, gr, m, v, scalars)

    def plain():
        for p, gr, m, v in zip(params, grads, ms_, vs_):
            O._plain_leaf_update(p, gr, m, v, scalars)

    ms = time_ms(kernel)
    plain_ms = time_ms(plain, iters=5)
    lib_params = [p.clone().requires_grad_() for p in params]
    for p, gr in zip(lib_params, grads):
        p.grad = gr.clone()
    lib = torch.optim.AdamW(lib_params, lr=1e-4, weight_decay=0.01,
                            fused=True)
    lib_ms = time_ms(lib.step)
    nbytes = 22 * n          # p, g bf16 and m, v f32 read; p, m, v written
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[7] K4 over the small bf16 tree ({n / 1e6:.2f} M params, "
          f"{len(params)} leaves): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.optim.AdamW(fused=True) {lib_ms:.4f} ms, bound "
          f"{bound:.4f} ms by bytes ({nbytes / 1e9:.3f} GB); kernel at "
          f"{nbytes / ms / 1e6:.0f} GB/s", flush=True)
    report["adamw_timing"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=bound, bytes=nbytes, params=n)
    return dict(name="adamw", route="cuda",
                source="tony_tpu_torch/csrc/adamw.cu",
                replaces="tony_tpu/ops/optim.py:40", launches=None,
                max_abs_err=worst[str(torch.bfloat16)][2], ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=lib_ms)


def _copy_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _copy_tree(v, device) for k, v in tree.items()}
    return tree.detach().to(device).clone()


def phase_train_parity(report):
    """[8] 3 train steps of `tiny` in f32 on the card and on the CPU from
    one set of params and batches: losses within 1e-4 relative."""
    import numpy as np
    import torch
    from tony_tpu_torch.models import train as TR
    from tony_tpu_torch.models import transformer as T
    cfg = T.PRESETS["tiny"].scaled(dtype=torch.float32)
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rs = np.random.RandomState(5)
    toks = [torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(4, 129)))
            for _ in range(3)]
    losses = {}
    for dev in ("cpu", "cuda"):
        for fused in (False, True):
            params = _copy_tree(cpu, dev)
            opt = TR.default_optimizer(lr=1e-2, warmup_steps=1,
                                       total_steps=10, fused=fused)
            step = TR.make_train_step(lambda p, b: T.lm_loss(p, b, cfg), opt)
            state = TR.init_state(params, opt)
            out = []
            for t in toks:
                t = t.to(dev)
                state, m = step(state, {"inputs": t[:, :-1],
                                        "targets": t[:, 1:]})
                out.append(float(m["loss"]))
            losses[(dev, fused)] = out
    worst = 0.0
    for fused in (False, True):
        a, b_ = np.array(losses[("cuda", fused)]), np.array(
            losses[("cpu", fused)])
        worst = max(worst, float(np.max(np.abs(a - b_) / np.abs(b_))))
    print(f"[8] f32 tiny, 3 train steps card vs CPU: losses "
          f"{[round(x, 6) for x in losses[('cuda', False)]]} (card, "
          f"unfused), worst relative difference {worst:.2e} over the "
          f"unfused and fused optimizers (limit 1e-4)", flush=True)
    report["train_parity"] = dict(losses={f"{d} fused={f}": v for (d, f), v
                                          in losses.items()}, worst=worst)
    if not worst <= 1e-4:
        fail("f32 training losses differ between the card and the CPU")


class _TimedData:
    """Wraps the batch iterator: records each ``next`` wall (the data
    wait) and forwards ``close``."""

    def __init__(self, data):
        self.data, self.waits = data, []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self.data)
        self.waits.append(time.perf_counter() - t0)
        return batch

    def close(self):
        close = getattr(self.data, "close", None)
        if close is not None:
            close()


def _train_run(cfg, params, steps, *, fused=False, batch=16, seq=1024,
               depth=2, seed=0, checkpoint=None, start=0, state=None,
               timed=False):
    """``steps`` train steps (from ``start``) through train_lm's code path:
    its source, prefetcher, ``default_optimizer`` (one schedule of 100
    warmup steps for every run, so a resumed run sees the same lr) and
    ``run_training``; returns (state, losses, step wall seconds, data
    waits)."""
    import torch
    from tony_tpu_torch import train_lm
    from tony_tpu_torch.models import train as TR
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.models.loop import run_training
    opt = TR.default_optimizer(lr=3e-4, total_steps=1000, fused=fused)
    step_fn = TR.make_train_step(lambda p, b: T.lm_loss(p, b, cfg), opt)
    if state is None:
        state = TR.init_state(params, opt)
    source = train_lm.synthetic_source(seed, batch, seq, cfg.vocab_size)
    for _ in range(start):
        next(source)
    data = _TimedData(train_lm.make_data(source, "cuda", depth))
    losses, walls = [], []

    def timed_step(st, b):
        t0 = time.perf_counter()
        st, m = step_fn(st, b)
        losses.append(m["loss"])
        if timed:
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return st, m

    state, _ = run_training(timed_step, state, data, start + steps,
                            start_step=start, checkpoint=checkpoint)
    return state, [float(x) for x in losses], walls, data.waits


def phase_train(report, card):
    """[9] The training slice at full width: `small` bf16, batch 16, seq
    1024, remat "full", DevicePrefetcher depth 2, 20 steps; then the fused
    optimizer, the two-pass backward, and a checkpoint resume."""
    import statistics
    import tempfile

    import torch
    from tony_tpu_torch import train_lm, tree_leaves
    from tony_tpu_torch.models import train as TR
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.models.checkpoint import CheckpointManager
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import optim as O
    steps, batch, seq = 20, 16, 1024
    cfg, params = train_lm.build("small", "cuda")
    if not (cfg.remat and cfg.remat_policy == "full"
            and cfg.dtype == torch.bfloat16):
        fail("the small preset should train with remat 'full' in bf16")
    L = cfg.n_layers

    def zero_counts():
        for fn in (A.flash_forward, A.flash_backward_fused,
                   A.flash_backward_dq, A.flash_backward_dkv,
                   O.adamw_update):
            fn.launches = 0

    def counts():
        return dict(k1=A.flash_forward.launches,
                    k2=A.flash_backward_fused.launches,
                    k3a=A.flash_backward_dq.launches,
                    k3b=A.flash_backward_dkv.launches,
                    k4=O.adamw_update.launches)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    state, losses, walls, waits = _train_run(cfg, params, steps, timed=True)
    wall = time.perf_counter() - t0
    c = counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(walls[-10:]) * 1e3
    tok_s = batch * seq / (step_ms / 1e3)
    fpt = T.train_flops_per_token(cfg, seq)
    mfu = tok_s * fpt / BF16_FLOPS
    wait_ms = statistics.median(waits) * 1e3
    print(f"[9] small bf16 training on {card}: {steps} steps of {batch}x{seq}"
          f" in {wall:.2f}s; step {step_ms:.2f} ms (median of the last 10), "
          f"{tok_s:,.0f} tokens/s, MFU {mfu:.4f} ({fpt / 1e6:.1f} MFLOP/"
          f"token vs 989 TFLOP/s), peak memory {peak / 2**30:.2f} GiB, data "
          f"wait median {wait_ms:.3f} ms; losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; launches {c}", flush=True)
    report["train"] = dict(step_ms=step_ms, tokens_per_s=tok_s, mfu=mfu,
                           flops_per_token=fpt, peak_bytes=peak,
                           data_wait_median_ms=wait_ms, losses=losses,
                           walls=walls, launches=c, wall_s=wall)
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        fail("a training loss is not finite")
    if c["k1"] != 2 * L * steps or c["k2"] != L * steps or \
            c["k3a"] or c["k3b"]:
        fail(f"launch counts {c} != K1 {2 * L * steps} (forward + remat), "
             f"K2 {L * steps}, K3 0")
    train_counts = c
    phase_train_profile(report, cfg, state)

    zero_counts()
    _, fl, _, _ = _train_run(cfg, state["params"], 3, fused=True)
    c = counts()
    print(f"[9] 3 steps with the fused optimizer: K4 launches {c['k4']}, "
          f"losses {[round(x, 4) for x in fl]}", flush=True)
    n_leaves = len(tree_leaves(state["params"]))
    if c["k4"] != 3 * n_leaves or not all(abs(x) < float("inf")
                                          for x in fl):
        fail(f"fused optimizer run: K4 launches {c['k4']} != 3 steps x "
             f"{n_leaves} leaves, or a loss is not finite")
    train_counts["k4"] = c["k4"]

    budget = A._FUSED_PARTIALS_BYTES
    A._FUSED_PARTIALS_BYTES = 0
    try:
        zero_counts()
        _, tl, _, _ = _train_run(cfg, state["params"], 3)
        c = counts()
    finally:
        A._FUSED_PARTIALS_BYTES = budget
    print(f"[9] 3 steps with the partials budget at 0: launches {c}, losses "
          f"{[round(x, 4) for x in tl]}", flush=True)
    if c["k3a"] != 3 * L or c["k3b"] != 3 * L or c["k2"] != 0:
        fail(f"two-pass run: launches {c}, want K3a = K3b = {3 * L}, K2 0")
    train_counts["k3a"], train_counts["k3b"] = c["k3a"], c["k3b"]

    # checkpoint at step 2, resume, and compare the third step's loss with
    # an uninterrupted run from the same params and batches
    base = _copy_tree(state["params"], "cuda")
    _, straight, _, _ = _train_run(cfg, _copy_tree(base, "cuda"), 3)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, save_interval_steps=2)
        _train_run(cfg, _copy_tree(base, "cuda"), 2, checkpoint=mgr)
        opt = TR.default_optimizer(lr=3e-4, total_steps=1000)
        resumed = mgr.restore_or_init(
            lambda: TR.init_state(_copy_tree(base, "cuda"), opt))
        if resumed["step"] != 2:
            fail(f"resume restored step {resumed['step']}, not 2")
        _, after, _, _ = _train_run(cfg, None, 1, start=2, state=resumed)
    diff = abs(after[0] - straight[2]) / abs(straight[2])
    print(f"[9] checkpoint at step 2 and resume: step-3 loss {after[0]:.6f} "
          f"vs {straight[2]:.6f} uninterrupted (relative difference "
          f"{diff:.2e}, limit 1e-3: K2 adds dQ with atomics, so two runs "
          f"differ in f32 rounding)", flush=True)
    report["train_resume"] = dict(resumed=after[0], straight=straight,
                                  rel_diff=diff)
    if not diff <= 1e-3:
        fail("the resumed run does not reach the uninterrupted loss")
    return train_counts


def phase_train_profile(report, cfg, state):
    """Device busy share of 3 profiled training steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    params = state["params"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _train_run(cfg, params, 3, seed=1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            dev[e.key] = us
    total = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    if total == 0:
        print("[9b] device busy share: not measured (the profiler recorded "
              "no device time)", flush=True)
    else:
        print(f"[9b] 3 profiled training steps: device busy "
              f"{total / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall (share "
              f"{total / wall_us:.3f}); top: "
              + "; ".join(f"{n[:48]} {us / 1e3:.1f} ms" for n, us in top),
              flush=True)
    report["train_profile"] = dict(wall_us=wall_us, device_us=total, top=top)


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
    bwd = phase_backward(report)
    k4 = phase_adamw(report)
    phase_parity(report)
    phase_train_parity(report)
    serve_k1 = phase_serve(report, card)
    counts = phase_train(report, card)
    # launches on the main paths, each counted from 0 over its own run:
    # K1 over the serve (phase 5) and the training run (phase 9); K2 over
    # the training run; K3a/K3b over the run with the budget at 0; K4 over
    # the run with the fused optimizer
    k1["launches"] = serve_k1 + counts["k1"]
    bwd["fused"]["launches"] = counts["k2"]
    bwd["dq"]["launches"] = counts["k3a"]
    bwd["dkv"]["launches"] = counts["k3b"]
    k4["launches"] = counts["k4"]
    report["wall_s"] = time.perf_counter() - t0
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"wall {report['wall_s']:.1f}s", flush=True)
    print(json.dumps({"kernels": [k1, bwd["fused"], bwd["dq"], bwd["dkv"],
                                  k4]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
