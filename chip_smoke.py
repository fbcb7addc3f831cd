"""Chip smoke test of the PyTorch / CUDA port (tony_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100. Phases,
each printing its own lines; any failure exits non-zero and prints no
result:

1. the card (name and power limit as nvidia-smi reports them), torch and
   CUDA versions — no card means exit 1;
2. build the seven kernels from ``tony_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and print ptxas's registers, spills and the
   dynamic shared memory of each tensor-core attention instantiation
   (K1, K2/K3b and K3a);
3. hold the flash-attention forward kernel (K1; bf16 runs its
   tensor-core kernel, f32 its FP32-pipe kernel) against its plain torch
   version on the card: f32 and bf16, MHA and GQA, causal / windows 24,
   64 and 100 / non-causal, S in {17, 128, 512}, head_dim in {32, 64,
   128}; and at the main paths' shapes, [8, S_b, 8, 64] bf16 causal for
   every serving admission bucket S_b in {64, 128, 256, 512}, the
   training shape [16, 1024, 8, 64] and BERT's [16, 512, 12, 64]
   non-causal; then time the kernel (CUDA events per call, and its
   device time with the calls queued ahead of the card) and PyTorch's
   scaled_dot_product_attention (a yardstick only — the port never calls
   it) at the serving prefill, training and BERT shapes, beside the
   bound computed from this call's FLOPs and bytes, and the plain version
   at the serving shape;
6. hold the backward kernels, K2 (fused) and K3a + K3b (two-pass), against
   the plain backward (and K1's o and lse, which they read, against the
   plain forward): f32 and bf16, MHA and GQA, causal / windows 24, 64 and
   100 / non-causal, S in {17, 128, 512, 1024}, head_dim in {32, 64, 128},
   with and without an lse cotangent, both routes, and K3a run twice per
   two-pass case for bitwise equal dQ (it has no atomics); then time K2,
   K3a and K3b and SDPA's backward (yardstick) at [16, 1024, 8, 64] bf16
   causal (with the plain backward) and at BERT's [16, 512, 12, 64]
   non-causal, by CUDA events per call and by device time with the
   calls queued ahead of the card (each kernel alone, and its whole
   wrapper), each beside its bound;
7. hold fused AdamW (K4) against its plain version over the ``small``
   parameter tree in bf16 and f32, 3 steps with a clip on one; then time
   it over the f32 tree beside its byte bound, the plain version and
   ``torch.optim.AdamW(fused=True)``, which computes the same function
   there (f32 p, g, m and v: 28 B/element; yardstick), and over the bf16
   tree, where that call keeps bf16 moments (14 B/element against K4's
   22) and is printed as another function; every timed call with its
   GB/s;
10. hold RMSNorm (K5) and LayerNorm (K6) against their plain versions: f32
   (max abs <= 1e-5) and bf16 (within one ulp + 1e-5), d in {64, 128,
   512, 768, 770, 4096}, rows in {1, 17, 8192, 16384}, and an x off
   16-byte alignment; f32 gradients through the autograd Function against
   autograd of the plain version (1e-4 of the largest entry); then time
   K6 at [8192, 768] and K5 at [16384, 512] bf16 (device time per call,
   from torch.profiler) beside the byte bound,
   the plain version and ``torch.nn.functional.layer_norm`` /
   ``rms_norm`` (yardsticks);
4. slice parity in f32: the ``small`` preset with one set of seeded
   weights on the card and on the CPU — bucketed prefill logits of 4
   prompts (max abs <= 1e-3) and the token agreement of 8 greedy
   requests of 16 tokens; then, on the card, 8 requests served on the
   blockwise cache walk each against ``generate`` of its prompt alone;
8. training parity in f32: 3 train steps of ``tiny`` on the card and on
   the CPU from one set of params, losses within 1e-4 relative, for the
   unfused and the fused optimizer;
11. BERT parity in f32: ``BERT_TINY`` on the card and on the CPU from one
   set of weights, MLM logits (max abs <= 1e-3), then 3 train steps with
   losses within 1e-4 relative;
5. the serving slice at full width in bf16: ``small`` through
   ``tony_tpu_torch.serve_lm``'s code path, 24 mixed requests through 8
   slots, pipelined; every request gets its budget, every token is in the
   vocabulary, K1 ran n_layers times per admit_rows call (each on its
   tensor-core kernel) and K5
   2 x n_layers + 1 times per model forward; then a short serve under
   torch.profiler gives the device busy share and the device launches
   per decode step;
9. the training slice at full width: ``small`` bf16 through
   ``tony_tpu_torch.train_lm``'s code path, batch 16 x seq 1024, remat
   "full", DevicePrefetcher depth 2, 20 steps: every loss finite, K1
   launched 2 x n_layers per step (forward and remat recompute), K2
   n_layers per step, K3 never, K5 4 x n_layers + 1 per step, every K1,
   K2, K3a and K3b launch on its tensor-core kernel; step time,
   tokens/s, MFU, peak memory and data wait; a profiled window of 3
   steps (device busy share); 3 steps
   with the fused optimizer (K4 once per leaf per step), 8 with the
   budget at 0 (K3a and K3b n_layers per step each, K2 never; the median
   step time and, over 3 more profiled steps, the device time per step,
   each beside the fused run's), and a checkpoint at
   step 2 whose resume reaches the uninterrupted step-3 loss;
12. the BERT slice at full width and depth: BERT-base bf16 through
   ``tony_tpu_torch.pretrain_bert``'s code path, batch 16 x seq 512,
   DevicePrefetcher depth 2, 20 steps: every loss finite, per step K1
   and K2 n_layers times (on their tensor-core kernels), K6 2 x n_layers
   + 2, K3 and K5 never; step
   time, tokens/s, MFU, peak memory, data wait; 3 profiled steps;
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


def device_ms(fn, iters: int = 30) -> float:
    """Mean device milliseconds per call: the time torch.profiler records
    on the card for every launch of ``iters`` calls (after a warm-up),
    over ``iters``. Unlike a CUDA-event window it leaves out the gaps
    where the card waits for the host to launch the next call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev, _ = _device_times(prof)
    return sum(dev.values()) / 1e3 / iters


def queued_ms(fn, iters: int = 30):
    """Mean device milliseconds per call with every call queued before
    the card reaches the first: a sleep kernel holds the stream while the
    host enqueues ``iters`` calls between two CUDA events, so the window
    holds the calls' device time, not the host's launch time (which
    exceeds a small kernel's). None if the host never got ahead of the
    card."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for attempt in range(3):
        # about 2 GHz: a sleep of 2, then 4, then 8 times the host's time
        # to enqueue the window
        torch.cuda._sleep(int(2e9 * host_s * iters * 2 ** (attempt + 1)))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()   # the card had not reached the window
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
    return None


def _ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def _sum(*ts):
    """The sum of times, None if any was not measured."""
    return None if None in ts else sum(ts)


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


def _tc_smem_bytes(kernel: str, args: list) -> int:
    """Dynamic shared memory of a tensor-core attention kernel's launch,
    as ``tc_smem_bytes`` (flash_fwd.cu), ``tc_dq_smem_bytes`` and
    ``tc_kv_smem_bytes`` (flash_bwd.cu) size it from the template
    arguments: the forward <D, MT> holds the q tile [64 MT, D] and two
    stages of K and V ([64, D] bf16 each); the dQ pass <D> (16 NW q rows,
    NW = 8 at D <= 64, else 4) the Q and dO tiles [16 NW, D] and two
    stages of K and V; the kv-major backward <D, WITH_DQ> (16 NW kv rows,
    NW as the dQ pass's) K and V [16 NW, D], two stages of Q and dO
    [64, D], the dS^T tile [16 NW, 64] (bf16) and two stages of lse and
    delta (64 f32 each)."""
    d = int(args[0])
    if kernel.startswith("flash_fwd"):
        return 2 * (64 * int(args[1]) + 4 * 64) * d
    rows = 16 * (8 if d <= 64 else 4)
    if kernel.startswith("flash_bwd_dq"):
        return 2 * (2 * rows + 4 * 64) * d
    return 2 * (2 * rows * d + 4 * 64 * d + rows * 64) + 4 * 4 * 64


def _ptxas_rows(log: str) -> list:
    """The tensor-core kernels of an nvcc ``-Xptxas=-v`` log: one dict per
    instantiation with its registers, stack frame and spill bytes."""
    import re
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(flash_[a-z_]+_tc_kernel)I((?:L[ib]\d+E)+)E",
                          m.group(1))
            cur = None
            if k:
                args = [("true" if v == "1" else "false") if t == "b" else v
                        for t, v in re.findall(r"L([ib])(\d+)E",
                                               k.group(2))]
                cur = dict(kernel=f"{k.group(1)}<{', '.join(args)}>",
                           args=args)
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def phase_build(report):
    from tony_tpu_torch.ops import _kernels
    seconds = _kernels.build()
    names = ", ".join(os.path.relpath(s, HERE) for s in _kernels.SOURCES)
    print(f"[2] built {names} in {seconds:.1f}s (one nvcc each, in "
          f"parallel)", flush=True)
    for src, log in _kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"    {src}: {line.strip()}")
    rows = [r for log in _kernels.BUILD_LOG.values()
            for r in _ptxas_rows(log)]
    for r in rows:
        r["dynamic_smem"] = _tc_smem_bytes(r["kernel"], r.pop("args"))
        print(f"[2] {r['kernel']}: {r.get('registers')} registers, "
              f"{r['dynamic_smem']} bytes of dynamic shared memory, stack "
              f"{r.get('stack')} bytes, spill stores {r.get('spill_stores')}"
              f" / loads {r.get('spill_loads')} bytes", flush=True)
    report["build_s"] = seconds
    report["tc_kernels"] = rows
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
    # the BERT slice's shape, non-causal
    b, s, h, d = 16, 512, 12, 64
    q, k, v = _qkv(b, s, h, h, d, torch.bfloat16, seed=77)
    o, lse = A.flash_attention_with_lse(q, k, v, causal=False)
    ro, rlse = A._dense_with_lse(q.float(), k.float(), v.float(),
                                 causal=False, scale=None)
    eo = (o.float() - ro).abs().max().item()
    el = (lse - rlse).abs().max().item()
    print(f"[3] K1 vs plain at [{b}, {s}, {h}, {d}] bf16 non-causal: |o| "
          f"err {eo:.3e} (limit {lo:g}), |lse| err {el:.3e} (limit {ll:g})",
          flush=True)
    if not (eo <= lo and el <= ll):
        fail("K1 disagrees with its plain version at the BERT shape")
    del q, k, v, o, lse, ro, rlse

    # timed at the serving prefill shape (with the plain version), the
    # training shape and the BERT shape: CUDA-event time per call (the
    # host wrapper included), device time with the calls queued ahead of
    # the card, and the same two for SDPA (a yardstick the port never
    # calls)
    timings = {}
    for key, (b, s, h, causal) in (("serve", (8, 512, 8, True)),
                                   ("train", (16, 1024, 8, True)),
                                   ("bert", (16, 512, 12, False))):
        q, k, v = _qkv(b, s, h, h, d, torch.bfloat16, seed=99 + s)
        kern = lambda: A.flash_attention_with_lse(q, k, v, causal=causal)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
        t = dict(shape=[b, s, h, d], causal=causal, ms=time_ms(kern),
                 device_ms=queued_ms(kern), library_ms=time_ms(sdpa),
                 library_device_ms=queued_ms(sdpa))
        if key == "serve":
            t["plain_ms"] = time_ms(lambda: A._dense_with_lse(
                q, k, v, causal=True, scale=None))
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        t["flops"] = 4 * d * pairs                  # attended (q, k) pairs
        t["bytes"] = 4 * b * s * h * d * 2 + b * h * s * 4  # q k v o, lse
        t_ops = t["flops"] / BF16_FLOPS * 1e3
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t["bound_ms"] = max(t_ops, t_bytes)
        t["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        plain = (f", plain {t['plain_ms']:.4f} ms" if "plain_ms" in t
                 else "")
        print(f"[3] K1 at B={b} S={s} H={h} D={d} bf16 "
              f"{'causal' if causal else 'non-causal'}: kernel "
              f"{t['ms']:.4f} ms per call ({_ms(t['device_ms'])} device)"
              f"{plain}, sdpa {t['library_ms']:.4f} ms "
              f"({_ms(t['library_device_ms'])} device), bound "
              f"{t['bound_ms']:.5f} ms by {t['bound_by']} "
              f"({t['flops'] / 1e9:.2f} GFLOP, {t['bytes'] / 1e6:.2f} MB); "
              f"kernel at {t['flops'] / (t['device_ms'] or t['ms']) / 1e9:.1f}"
              f" TFLOP/s of {'device' if t['device_ms'] else 'call'} time",
              flush=True)
        timings[key] = t
        del q, k, v, qt, kt, vt
    report["k1_timing"] = dict(timings, max_abs_err=err)
    # the kernels line: device times (the CUDA-event time per call where
    # the host never got ahead of the card)
    t = timings["serve"]
    return dict(name="flash_fwd", route="cuda",
                source="tony_tpu_torch/csrc/flash_fwd.cu",
                replaces="tony_tpu/ops/attention.py:173", launches=None,
                max_abs_err=err, ms=t["device_ms"] or t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"],
                library_ms=t["library_device_ms"] or t["library_ms"])


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


def _check_tc_variants(what):
    """Fail unless every bf16 launch of K1, K2, K3a and K3b since the
    counts were last zeroed went through the tensor-core kernels; return
    the per-variant counts."""
    from tony_tpu_torch.ops import attention as A
    out = {}
    for key, fn in (("k1", A.flash_forward), ("k2", A.flash_backward_fused),
                    ("k3a", A.flash_backward_dq),
                    ("k3b", A.flash_backward_dkv)):
        v = dict(fn.variant_launches)
        out[key] = v
        if v["fp32_pipe"] or v["tensor_core"] != fn.launches:
            fail(f"{what}: {key} launches {fn.launches}, by variant {v}: a "
                 f"bf16 launch missed the tensor-core kernel")
    return out


def phase_serve(report, card):
    import torch
    from tony_tpu_torch import serve_lm
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    cfg, params = serve_lm.build("small", "cuda")
    prompts, budgets = serve_lm.make_workload(
        0, 24, 480, 64, cfg.vocab_size, min_prompt_len=64)
    batcher = S.ContinuousBatcher(params, cfg, batch=8, max_len=1024,
                                  chunk=8, pipeline=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    N.rms_norm_forward.launches = 0
    S.CALL_COUNTS.clear()
    res = serve_lm.serve(batcher, prompts, budgets)
    launches = A.flash_forward.launches
    variants = _check_tc_variants("the bf16 serve")["k1"]
    k5 = N.rms_norm_forward.launches
    admits = sum(c for (name, _), c in S.CALL_COUNTS.items()
                 if name == "admit_rows")
    # model forwards: one per admission call, one per decode step
    forwards = sum(c * (shape[1] if name == "step_rows" else 1)
                   for (name, shape), c in S.CALL_COUNTS.items()
                   if name in ("admit_rows", "admit_row", "step_rows"))
    peak = torch.cuda.max_memory_allocated()
    outs = res["outputs"]
    tok_s = res["tokens"] / res["wall_s"]
    print(f"[5] small bf16 on {card}: {len(prompts)} requests, "
          f"{res['tokens']} tokens in {res['wall_s']:.3f}s "
          f"({tok_s:.1f} tokens/s), slot-step utilization "
          f"{res['utilization']:.3f}, peak memory {peak / 2**20:.1f} MiB, "
          f"K1 launches {launches} over {admits} admit_rows calls "
          f"({variants['tensor_core']} on the tensor-core kernel), K5 "
          f"launches {k5} over {forwards} model forwards", flush=True)
    report["serve"] = dict(wall_s=res["wall_s"], tokens=res["tokens"],
                           tokens_per_s=tok_s,
                           utilization=res["utilization"],
                           steps=batcher.steps_executed,
                           peak_bytes=peak, k1_launches=launches,
                           admit_rows_calls=admits, k5_launches=k5,
                           forwards=forwards,
                           phases=batcher.phase_times.summary())
    if [len(o) for o in outs] != budgets:
        fail("a request did not get exactly its budget")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        fail("a generated token is outside the vocabulary")
    if admits == 0 or launches != cfg.n_layers * admits:
        fail(f"K1 launches {launches} != {cfg.n_layers} x {admits} "
             f"admit_rows calls")
    if k5 != (2 * cfg.n_layers + 1) * forwards:
        fail(f"K5 launches {k5} != (2 x {cfg.n_layers} + 1) x {forwards} "
             f"model forwards")
    phase_profile(report, batcher, prompts[:8], budgets[:8])
    return launches, k5


def _device_times(prof):
    """({op name: self device microseconds}, device launches) of a
    torch.profiler run."""
    dev, launches = {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            dev[e.key] = us
            launches += e.count
    return dev, launches


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
    dev, launches = _device_times(prof)
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


def _raw_backward(name, args, causal):
    """A call of one backward kernel's C entry point alone ("fused" K2,
    "dq" K3a, "dkv" K3b) on inputs its wrapper prepares once (delta, the
    f32 dQ buffer, the outputs): the kernel's device time without the
    wrapper's other work. K2's dQ buffer is not zeroed again between
    calls, which the timing does not see."""
    import torch
    from tony_tpu_torch.ops import attention as A
    q, k, v, o, lse, do, dlse = args
    q, k, v, do, lse, delta = A._bwd_inputs(q, k, v, o, lse, do, dlse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ins = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    if name == "fused":
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        outs = [dq, dk, dv]
    else:
        dq = torch.empty_like(q)
        outs = [dq] if name == "dq" else [dk, dv]
    fn_name = {"fused": "tony_flash_bwd_fused", "dq": "tony_flash_bwd_dq",
               "dkv": "tony_flash_bwd_dkv"}[name]
    ptrs = ins + [t.data_ptr() for t in outs]
    keep = (q, k, v, do, lse, delta, dq, dk, dv)
    return lambda: A._launch_bwd(fn_name, keep[0], keep[1], ptrs,
                                 causal=causal, scale=q.shape[-1] ** -0.5,
                                 window=None)


def _check_dq_repeats(args, dq, causal, window):
    """Fail unless a second K3a run on the same inputs gives bitwise the
    same dQ: the q-major pass adds in a fixed order, with no atomics."""
    import torch
    from tony_tpu_torch.ops import attention as A
    again = A.flash_backward_dq(*args, causal=causal,
                                scale=args[0].shape[-1] ** -0.5,
                                window=window)
    if not torch.equal(again, dq):
        q = args[0]
        fail(f"K3a is not deterministic: two runs differ by "
             f"{(again.float() - dq.float()).abs().max().item():.3e} at "
             f"{tuple(q.shape)} {q.dtype} causal={causal} window={window}")


def phase_backward(report):
    """[6] K2 and K3a/K3b against the plain backward on the card (K3a
    twice, for bitwise equal dQ), then timed at the training and BERT
    shapes."""
    import torch
    import torch.nn.functional as F
    from tony_tpu_torch.ops import attention as A
    # f32: 1e-4 of the reference's largest entry (at least 1e-4 absolute):
    # dK and dV sum up to 1024 query rows of a 4-head group in f32, so the
    # rounding grows with the gradient's size. bf16: 2% of the largest
    # entry, against the dense f32 gradient of the same bf16 inputs.
    rel = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = {}
    n = n_det = 0
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
                                if route == "two_pass":
                                    _check_dq_repeats(args, got[0], causal,
                                                      w_s)
                                    n_det += 1
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
    print(f"[6] K3a deterministic: a second run gave bitwise equal dQ in "
          f"all {n_det} two-pass cases", flush=True)
    report["bwd_cases"] = n
    report["bwd_worst"] = {f"{a} {b}": v for (a, b), v in worst.items()}

    # the training slice's shape [16, 1024, 8, 64] bf16 causal (both
    # routes and the plain backward) and the BERT slice's [16, 512, 12,
    # 64] non-causal (K2): relative error, CUDA-event time per call (the
    # wrapper included: delta, the dQ buffer, the cast), device time with
    # the calls queued ahead of the card of the kernel alone and of the
    # whole wrapper, and SDPA's backward (a yardstick the port never
    # calls)
    shapes = {"train": (16, 1024, 8, True, ("fused", "two_pass")),
              "bert": (16, 512, 12, False, ("fused", "two_pass"))}
    d = 64
    dt = torch.bfloat16
    bwd_timing, entries = {}, {}
    for key, (b, s, h, causal, routes) in shapes.items():
        args, ref = _bwd_case(b, s, h, h, d, dt, causal, None, False,
                              seed=4242 + s)
        q, k, v, o, lse, do, _ = args
        errs, abs_errs, out_errs = {}, {}, {}
        for route in routes:
            got = _run_route(route, args, causal, None)
            if route == "two_pass":
                _check_dq_repeats(args, got[0], causal, None)
            diffs = [(g.float() - r).abs().max().item()
                     for g, r in zip(got, ref)]
            abs_errs[route] = max(diffs)
            out_errs[route] = diffs          # dq, dk, dv
            errs[route] = max(e / max(r.abs().max().item(), 1e-30)
                              for e, r in zip(diffs, ref))
            if not errs[route] <= 2e-2:
                fail(f"{route} backward at [{b}, {s}, {h}, {d}]: relative "
                     f"err {errs[route]:.3e} > 2e-2")
        del ref, got
        kw = dict(causal=causal, scale=d ** -0.5, window=None)
        fns = {"fused": lambda: A.flash_backward_fused(q, k, v, o, lse, do,
                                                       **kw),
               "dq": lambda: A.flash_backward_dq(q, k, v, o, lse, do, **kw),
               "dkv": lambda: A.flash_backward_dkv(q, k, v, o, lse, do,
                                                   **kw)}
        times = {name: time_ms(fn, iters=10) for name, fn in fns.items()}
        dev = {name: queued_ms(_raw_backward(name, args, causal), iters=10)
               for name in fns}
        wrapper_dev = {name: queued_ms(fn, iters=10)
                       for name, fn in fns.items()}
        if key == "train":
            times["plain"] = time_ms(lambda: A._dense_backward(
                q, k, v, o, lse, do, None, causal=True, scale=None), iters=3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2)
        sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True)
        times["sdpa_bwd"] = time_ms(sdpa_bwd, iters=10)
        dev["sdpa_bwd"] = queued_ms(sdpa_bwd, iters=10)
        del out
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        tensor = b * s * h * d * 2                     # one [B,S,H,D] bf16
        rows = b * h * s * 4                           # one [B,H,S] f32
        # products over the attended pairs and bytes read + written:
        # K2 and the whole backward: q k^T, do v^T, p^T do, ds^T q, ds k;
        # K3a: q k^T, do v^T, ds k (reads q k v do lse delta, writes dq);
        # K3b: q k^T, do v^T, p^T do, ds^T q (writes dk, dv)
        work = {"fused": (5, 5 * tensor + rows, 3 * tensor),
                "dq": (3, 4 * tensor + 2 * rows, tensor),
                "dkv": (4, 4 * tensor + 2 * rows, 2 * tensor)}
        rows_k = {}
        for name in fns:
            products, rd, wr = work[name]
            flops = products * 2 * d * pairs
            t_ops = flops / BF16_FLOPS * 1e3
            t_bytes = (rd + wr) / HBM_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            rows_k[name] = dict(ms=times[name], device_ms=dev[name],
                                wrapper_device_ms=wrapper_dev[name],
                                bound_ms=bound,
                                bound_by="operations" if t_ops >= t_bytes
                                else "bytes", flops=flops, bytes=rd + wr)
            print(f"[6] {name} at B={b} S={s} H={h} D={d} bf16 "
                  f"{'causal' if causal else 'non-causal'}: {times[name]:.4f}"
                  f" ms per call, {_ms(dev[name])} device (kernel), "
                  f"{_ms(wrapper_dev[name])} device (wrapper), bound "
                  f"{bound:.5f} ms by {rows_k[name]['bound_by']} "
                  f"({flops / 1e9:.2f} GFLOP, {(rd + wr) / 1e6:.2f} MB); "
                  f"{flops / (dev[name] or times[name]) / 1e9:.1f} TFLOP/s "
                  f"of {'device' if dev[name] else 'call'} time", flush=True)
        plain = (f"plain backward {times['plain']:.4f} ms; "
                 if "plain" in times else "")
        two = (f"two-pass total {times['dq'] + times['dkv']:.4f} ms per "
               f"call, {_ms(_sum(wrapper_dev['dq'], wrapper_dev['dkv']))} "
               f"device (wrappers; K2's wrapper "
               f"{_ms(wrapper_dev['fused'])}); ")
        print(f"[6] at [{b}, {s}, {h}, {d}]: {two}{plain}sdpa backward "
              f"{times['sdpa_bwd']:.4f} ms ({_ms(dev['sdpa_bwd'])} "
              f"device); err (max abs, relative to the largest entry) "
              + ", ".join(f"{r} {abs_errs[r]:.3e} ({errs[r]:.3e})"
                          for r in routes), flush=True)
        bwd_timing[key] = dict(times=times, device=dev, rows=rows_k,
                               errs=errs, abs_errs=abs_errs)
        if key == "train":
            for name, kname, src_line in (
                    ("fused", "flash_bwd_fused",
                     "tony_tpu/ops/attention.py:339"),
                    ("dq", "flash_bwd_dq", "tony_tpu/ops/attention.py:525"),
                    ("dkv", "flash_bwd_dkv",
                     "tony_tpu/ops/attention.py:571")):
                r = rows_k[name]
                entries[name] = dict(
                    name=kname, route="cuda",
                    source="tony_tpu_torch/csrc/flash_bwd.cu",
                    replaces=src_line, launches=None,
                    # each kernel's own outputs: K3a dq, K3b dk and dv
                    max_abs_err={"fused": abs_errs["fused"],
                                 "dq": out_errs["two_pass"][0],
                                 "dkv": max(out_errs["two_pass"][1:])}[name],
                    ms=r["wrapper_device_ms"] or r["ms"],
                    plain_ms=times["plain"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"],
                    library_ms=dev["sdpa_bwd"] or times["sdpa_bwd"])
        del args, q, k, v, o, lse, do, qt, kt, vt
    report["bwd_timing"] = bwd_timing
    # the BERT shape [16, 512, 12, 64] non-causal beside each backward
    # kernel's row (its kernels-line numbers are the training shape's)
    bert = bwd_timing["bert"]
    for name, e in entries.items():
        r = bert["rows"][name]
        e["bert_shape"] = dict(ms=r["wrapper_device_ms"] or r["ms"],
                               kernel_device_ms=r["device_ms"],
                               bound_ms=r["bound_ms"],
                               library_ms=bert["device"]["sdpa_bwd"]
                               or bert["times"]["sdpa_bwd"])
    return entries


def _ulps(got, want, mant_bits, atol=0.0):
    """|got - want| in units of (the last place of ``want`` in a type with
    ``mant_bits`` explicit mantissa bits, plus ``atol``)."""
    import torch
    w = want.double()
    _, e = torch.frexp(w.abs().clamp(min=2.0 ** -120))
    ulp = torch.ldexp(torch.ones_like(w), e - 1 - mant_bits)
    return ((got.double() - w).abs() / (ulp + atol)).max().item()


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

    # timed over the `small` tree in both dtypes, every leaf once as a
    # training step does: K4 through its per-leaf API (one launch a leaf),
    # the plain version, and torch.optim.AdamW(fused=True). On the f32
    # tree that call computes K4's function (f32 p, g, m and v read, p, m
    # and v written: 28 B/element); on the bf16 tree it keeps bf16
    # moments (14 B/element, against K4's 22), so it computes another
    # function and is printed as such, never as K4's yardstick
    timing = {}
    for dtype, bpe, lib_bpe in ((torch.float32, 28, 28),
                                (torch.bfloat16, 22, 14)):
        cfg = T.PRESETS["small"].scaled(dtype=dtype)
        params = tree_leaves(T.init_params(torch.Generator().manual_seed(3),
                                             cfg, device="cuda"))
        grads = [torch.randn_like(p) * 1e-3 for p in params]
        ms_ = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        vs_ = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        scalars = torch.cat([torch.from_numpy(O.FusedAdamW(
            1e-4).host_scalars(0)).cuda(), torch.ones(1, device="cuda")])
        n = sum(p.numel() for p in params)

        def per_leaf():
            for p, gr, m, v in zip(params, grads, ms_, vs_):
                O.adamw_update(p, gr, m, v, scalars)

        def plain():
            for p, gr, m, v in zip(params, grads, ms_, vs_):
                O._plain_leaf_update(p, gr, m, v, scalars)

        t = dict(per_leaf=time_ms(per_leaf), plain=time_ms(plain, iters=5))
        lib_params = [p.clone().requires_grad_() for p in params]
        for p, gr in zip(lib_params, grads):
            p.grad = gr.clone()
        lib = torch.optim.AdamW(lib_params, lr=1e-4, weight_decay=0.01,
                                fused=True)
        t["library"] = time_ms(lib.step)
        lib_moments = lib.state[lib_params[0]]["exp_avg"].dtype
        del lib, lib_params
        nbytes = bpe * n
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        gbs = {k: (lib_bpe if k == "library" else bpe) * n / ms / 1e6
               for k, ms in t.items()}
        same = ("the same function" if lib_bpe == bpe else
                f"{str(lib_moments)[6:]} moments, {lib_bpe} B/element: not "
                f"the same function")
        print(f"[7] K4 over the small {str(dtype)[6:]} tree ({n / 1e6:.2f} M "
              f"params, {len(params)} leaves, {bpe} B/element, bound "
              f"{bound:.4f} ms by bytes, {nbytes / 1e9:.3f} GB): "
              + ", ".join(f"{k} {ms:.4f} ms ({gbs[k]:.0f} GB/s)"
                          for k, ms in t.items() if k != "library")
              + f"; torch.optim.AdamW(fused=True) {t['library']:.4f} ms "
              f"({gbs['library']:.0f} GB/s; {same})", flush=True)
        timing[str(dtype)] = dict(times=t, gb_per_s=gbs, bound_ms=bound,
                                  bytes=nbytes, params=n, leaves=len(params),
                                  library_moments=str(lib_moments))
        del params, grads, ms_, vs_
    report["adamw_timing"] = timing
    # the kernels line: the f32 tree, where one PyTorch call computes the
    # same function; the bf16 tree (the main path's) beside it
    f32, bf16 = timing[str(torch.float32)], timing[str(torch.bfloat16)]
    return dict(name="adamw", route="cuda",
                source="tony_tpu_torch/csrc/adamw.cu",
                replaces="tony_tpu/ops/optim.py:40", launches=None,
                max_abs_err=worst[str(torch.bfloat16)][2],
                ms=f32["times"]["per_leaf"], plain_ms=f32["times"]["plain"],
                bound_ms=f32["bound_ms"], bound_by="bytes",
                library_ms=f32["times"]["library"],
                timed_on="small tree, f32 p/g/m/v (28 B/element); "
                         "library_ms is torch.optim.AdamW(fused=True) on it",
                bf16_tree=dict(ms=bf16["times"]["per_leaf"],
                               plain_ms=bf16["times"]["plain"],
                               bound_ms=bf16["bound_ms"],
                               library_bf16_moments_ms=bf16["times"][
                                   "library"]))


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
    from tony_tpu_torch.ops import norms as N
    from tony_tpu_torch.ops import optim as O
    steps, batch, seq = 20, 16, 1024
    cfg, params = train_lm.build("small", "cuda")
    if not (cfg.remat and cfg.remat_policy == "full"
            and cfg.dtype == torch.bfloat16):
        fail("the small preset should train with remat 'full' in bf16")
    L = cfg.n_layers

    def zero_counts():
        A.reset_launches()
        for fn in (O.adamw_update, N.rms_norm_forward):
            fn.launches = 0

    def counts():
        return dict(k1=A.flash_forward.launches,
                    k2=A.flash_backward_fused.launches,
                    k3a=A.flash_backward_dq.launches,
                    k3b=A.flash_backward_dkv.launches,
                    k4=O.adamw_update.launches,
                    k5=N.rms_norm_forward.launches)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    state, losses, walls, waits = _train_run(cfg, params, steps, timed=True)
    wall = time.perf_counter() - t0
    c = counts()
    variants = _check_tc_variants("bf16 small training")
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
          f"{losses[-1]:.4f}; launches {c}; K1 and K2 by variant "
          f"{variants['k1']}, {variants['k2']}", flush=True)
    report["train"] = dict(variants=variants, step_ms=step_ms, tokens_per_s=tok_s, mfu=mfu,
                           flops_per_token=fpt, peak_bytes=peak,
                           data_wait_median_ms=wait_ms, losses=losses,
                           walls=walls, launches=c, wall_s=wall)
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        fail("a training loss is not finite")
    if c["k1"] != 2 * L * steps or c["k2"] != L * steps or \
            c["k3a"] or c["k3b"] or c["k5"] != (4 * L + 1) * steps:
        fail(f"launch counts {c} != K1 {2 * L * steps} (forward + remat), "
             f"K2 {L * steps}, K3 0, K5 {(4 * L + 1) * steps} (2 per block "
             f"forward and remat recompute, and the final norm)")
    train_counts = c
    fused_dev = phase_train_profile(report, cfg, state)

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

    # the two-pass backward (K3a + K3b) with the partials budget at 0:
    # timed steps (median of the last 5) and 3 profiled ones, each beside
    # the fused run's
    two_steps = 8
    budget = A._FUSED_PARTIALS_BYTES
    A._FUSED_PARTIALS_BYTES = 0
    try:
        zero_counts()
        _, tl, two_walls, _ = _train_run(cfg, state["params"], two_steps,
                                         timed=True)
        c = counts()
        two_variants = _check_tc_variants("bf16 two-pass training")
        two_dev = phase_train_profile(report, cfg, state, two_pass=True)
    finally:
        A._FUSED_PARTIALS_BYTES = budget
    two_ms = statistics.median(two_walls[-5:]) * 1e3
    print(f"[9] {two_steps} steps with the partials budget at 0 (two-pass "
          f"backward): step {two_ms:.2f} ms (median of the last 5) against "
          f"{step_ms:.2f} ms fused; device {_ms(two_dev)} per step against "
          f"{_ms(fused_dev)} fused (3 profiled steps each); launches {c}, "
          f"K3a and K3b by variant {two_variants['k3a']}, "
          f"{two_variants['k3b']}; losses {[round(x, 4) for x in tl]}",
          flush=True)
    report["train_two_pass"] = dict(step_ms=two_ms, walls=two_walls,
                                    device_ms_per_step=two_dev,
                                    fused_step_ms=step_ms,
                                    fused_device_ms_per_step=fused_dev,
                                    launches=c, variants=two_variants,
                                    losses=tl)
    if not all(abs(x) < float("inf") for x in tl):
        fail("a two-pass training loss is not finite")
    if c["k3a"] != two_steps * L or c["k3b"] != two_steps * L or c["k2"]:
        fail(f"two-pass run: launches {c}, want K3a = K3b = "
             f"{two_steps * L}, K2 0")
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


def phase_train_profile(report, cfg, state, two_pass=False):
    """Device busy share of 3 profiled training steps (with the two-pass
    backward when the caller set the partials budget to 0); returns the
    device milliseconds per step, None if the profiler recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    params = state["params"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _train_run(cfg, params, 3, seed=1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, _ = _device_times(prof)
    total = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    what = "two-pass " if two_pass else ""
    if total == 0:
        print(f"[9b] {what}device busy share: not measured (the profiler "
              f"recorded no device time)", flush=True)
    else:
        print(f"[9b] 3 profiled {what}training steps: device busy "
              f"{total / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall (share "
              f"{total / wall_us:.3f}); top: "
              + "; ".join(f"{n[:48]} {us / 1e3:.1f} ms" for n, us in top),
              flush=True)
    key = "train_profile_two_pass" if two_pass else "train_profile"
    report[key] = dict(wall_us=wall_us, device_us=total, top=top)
    return total / 3 / 1e3 if total else None


# norm kind -> (name, the TPU kernel it replaces, f32 operations per
# element: RMSNorm squares and sums, then scales twice; LayerNorm sums,
# centres, squares and sums, then scales twice and shifts)
_NORMS = {"rms": ("rms_norm", "tony_tpu/ops/norms.py:27", 4),
          "ln": ("layer_norm", "tony_tpu/ops/norms.py:33", 7)}

# f32 operations outside the tensor cores (H100 SXM data sheet)
F32_FLOPS = 67e12


def _norm_fns(kind):
    """(kernel through the autograd Function, the kernel's wrapper, the
    plain version) of one norm."""
    from tony_tpu_torch.ops import norms as N
    if kind == "rms":
        return N.rms_norm, N.rms_norm_forward, N.rms_norm_reference
    return N.layer_norm, N.layer_norm_forward, N.layer_norm_reference


def _norm_inputs(kind, rows, d, dtype, seed, offset=0):
    """x [rows, d] at unit scale (LayerNorm's with a mean of 1, which the
    two-pass variance must remove), w near 1 and b near 0, in ``dtype``;
    ``offset`` elements into its storage (an offset of 1 leaves x off
    16-byte alignment)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows * d + offset, device="cuda", generator=g)
    x = x[offset:].view(rows, d) + (1.0 if kind == "ln" else 0.0)
    w = 1 + 0.1 * torch.randn(d, device="cuda", generator=g)
    b = 0.1 * torch.randn(d, device="cuda", generator=g)
    params = (w,) if kind == "rms" else (w, b)
    return x.to(dtype), tuple(p.to(dtype) for p in params)


def _rotating(fn, sets):
    """A call of ``fn`` on the next of ``sets`` (argument tuples whose
    total size exceeds the 50 MB L2 cache), so each timed launch reads
    its input from device memory."""
    import itertools
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def phase_norms(report):
    """[10] K5 and K6 against their plain versions on the card — f32 and
    bf16, d in {64, 128, 512, 768, 770, 4096} (770 is a multiple of
    neither 4 nor 8, and 4096 is wider than the rows the kernel keeps in
    registers: both take the scalar path), rows in {1, 17, 8192, 16384},
    and one x off 16-byte alignment; gradients in f32 through the
    autograd Function against autograd of the plain version; then each
    kernel timed at its path's shape.

    Limits: f32 max abs 1e-5 (the row sums run in another order than the
    plain version's); bf16 one unit in the last place of the plain output
    beyond that 1e-5 — each side rounds its f32 value once, and where a
    LayerNorm output is near 0 (x near the mean, or the bias cancelling)
    the f32 difference exceeds a bf16 ulp of the tiny result."""
    import torch
    import torch.nn.functional as F
    limits = {torch.float32: 1e-5, torch.bfloat16: 1.0}
    worst, n = {}, 0
    for kind in _NORMS:
        _, kernel, plain = _norm_fns(kind)
        for dtype in limits:
            cases = [(rows, d, 0) for d in (64, 128, 512, 768, 770, 4096)
                     for rows in (1, 17, 8192, 16384)] + [(17, 768, 1)]
            for rows, d, offset in cases:
                x, params = _norm_inputs(kind, rows, d, dtype, n, offset)
                got, want = kernel(x, *params), plain(x, *params)
                torch.cuda.synchronize()
                # f32: max abs; bf16: units of (an ulp of the plain output
                # + 1e-5)
                err = ((got - want).abs().max().item()
                       if dtype == torch.float32
                       else _ulps(got, want, 7, atol=1e-5))
                w = worst.setdefault((kind, dtype), [0.0, ""])
                if err >= w[0]:
                    w[:] = [err, f"rows={rows} d={d} offset={offset}"]
                if not err <= limits[dtype]:
                    fail(f"{kernel.__name__} disagrees with its plain "
                         f"version: err {err:.3e} > {limits[dtype]:g} "
                         f"({dtype}, rows={rows}, d={d}, offset={offset})")
                n += 1
    for (kind, dtype), (err, where) in worst.items():
        unit = "max abs" if dtype == torch.float32 else "ulp + 1e-5"
        print(f"[10] {_NORMS[kind][0]} kernel vs plain, {dtype}: worst "
              f"{unit} {err:.3e} (limit {limits[dtype]:g}) at {where}",
              flush=True)

    # gradients, f32: the Function (kernel forward, plain backward)
    # against autograd of the plain version, relative to the largest entry
    gworst = {}
    for kind in _NORMS:
        fn, _, plain = _norm_fns(kind)
        for d in (64, 128, 512, 768, 770):
            for rows in (17, 8192):
                x, params = _norm_inputs(kind, rows, d, torch.float32,
                                         500 + n)
                ct = torch.randn_like(x)
                grads = []
                for f in (fn, plain):
                    ins = [t.clone().requires_grad_() for t in (x, *params)]
                    grads.append(torch.autograd.grad((f(*ins) * ct).sum(),
                                                     ins))
                for name, got, want in zip(("dx", "dw", "db"), *grads):
                    rel = ((got - want).abs().max()
                           / want.abs().max().clamp(min=1e-30)).item()
                    if rel > gworst.get(kind, (0.0, ""))[0]:
                        gworst[kind] = (rel, f"{name} rows={rows} d={d}")
                    if not rel <= 1e-4:
                        fail(f"{_NORMS[kind][0]} gradient {name} disagrees "
                             f"with autograd of the plain version: "
                             f"{rel:.3e} of the largest entry > 1e-4 "
                             f"(rows={rows}, d={d})")
                n += 1
    for kind, (rel, where) in sorted(gworst.items()):
        print(f"[10] {_NORMS[kind][0]} f32 gradients vs autograd of the "
              f"plain version: worst {rel:.3e} of the largest entry (limit "
              f"1e-4) at {where}", flush=True)
    report["norm_cases"] = n
    report["norm_worst"] = {f"{k} {dt}": v for (k, dt), v in worst.items()}
    report["norm_grad_worst"] = gworst

    # timed at the paths' shapes, bf16: K6 at BERT-base's [16 x 512, 768],
    # K5 at the `small` training step's [16 x 1024, 512]; 6 input sets a
    # kernel so each launch finds its input out of L2. A call of the
    # kernel takes less time on the card than its launch takes on the
    # host, so back-to-back calls under CUDA events time the host: the
    # device time of each call comes from the profiler, and the CUDA-event
    # time per call is printed beside it
    entries = {}
    for kind, (rows, d) in (("ln", (8192, 768)), ("rms", (16384, 512))):
        name, replaces, ops = _NORMS[kind]
        _, kernel, plain = _norm_fns(kind)
        sets = [_norm_inputs(kind, rows, d, torch.bfloat16, 900 + i)
                for i in range(6)]
        sets = [(x, *params) for x, params in sets]
        err = (kernel(*sets[0]).float() - plain(*sets[0]).float()).abs() \
            .max().item()
        if kind == "rms":
            lib = getattr(F, "rms_norm", None)
            lib_fn = None if lib is None else (
                lambda x, w: lib(x, (d,), w, 1e-6))
        else:
            lib_fn = lambda x, w, b: F.layer_norm(x, (d,), w, b, 1e-6)
        fns = {"kernel": kernel, "plain": plain, "library": lib_fn}
        dev_ms = {k: None if f is None else device_ms(_rotating(f, sets))
                  for k, f in fns.items()}
        call_ms = {k: None if f is None else time_ms(_rotating(f, sets),
                                                     iters=60)
                   for k, f in fns.items()}
        ms, plain_ms, lib_ms = (dev_ms[k] for k in fns)
        itemsize = 2
        nparams = len(sets[0]) - 1
        nbytes = 2 * rows * d * itemsize + nparams * d * itemsize
        flops = rows * d * ops
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        txt = lambda t: "n/a" if t is None else f"{t:.4f} ms"
        print(f"[10] {name} at [{rows}, {d}] bf16, device time per call: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.nn.functional.{name} {txt(lib_ms)}; bound "
              f"{bound:.5f} ms by {bound_by} ({nbytes / 1e6:.2f} MB); kernel "
              f"at {nbytes / ms / 1e6:.0f} GB/s; CUDA-event time per call "
              f"(host launches included): kernel {txt(call_ms['kernel'])}, "
              f"plain {txt(call_ms['plain'])}, library "
              f"{txt(call_ms['library'])}; max abs err vs plain {err:.3e}",
              flush=True)
        report[f"{name}_timing"] = dict(ms=ms, plain_ms=plain_ms,
                                        library_ms=lib_ms, call_ms=call_ms,
                                        bound_ms=bound, bytes=nbytes,
                                        flops=flops, rows=rows, d=d)
        entries[kind] = dict(
            name=name, route="cuda", source="tony_tpu_torch/csrc/norms.cu",
            replaces=replaces, launches=None, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
            library_ms=lib_ms)
        del sets
    torch.cuda.empty_cache()
    return entries


def phase_bert_parity(report):
    """[11] BERT_TINY in f32 on the card and on the CPU from one set of
    weights: MLM logits within 1e-3, then 3 train steps with losses
    within 1e-4 relative."""
    import dataclasses

    import numpy as np
    import torch
    from tony_tpu_torch import pretrain_bert
    from tony_tpu_torch.models import bert as B
    from tony_tpu_torch.models import train as TR
    cfg = dataclasses.replace(B.BERT_TINY, dtype=torch.float32)
    cpu = B.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    source = pretrain_bert.synthetic_mlm_batches(7, 4, 128, cfg)
    batches = [{k: torch.from_numpy(v) for k, v in next(source).items()}
               for _ in range(3)]
    rs = np.random.RandomState(8)
    type_ids = torch.from_numpy(rs.randint(0, 2, size=(4, 128)))
    gpu = _copy_tree(cpu, "cuda")
    with torch.no_grad():
        lg_c = B.forward(cpu, batches[0]["tokens"], cfg, type_ids)
        lg_g = B.forward(gpu, batches[0]["tokens"].cuda(), cfg,
                         type_ids.cuda())
    err = (lg_g.cpu() - lg_c).abs().max().item()
    del gpu
    losses = {}
    for dev in ("cpu", "cuda"):
        opt = TR.default_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
        step = TR.make_train_step(lambda p, b: B.mlm_loss(p, b, cfg), opt)
        state = TR.init_state(_copy_tree(cpu, dev), opt)
        out = []
        for b in batches:
            state, m = step(state, {k: v.to(dev) for k, v in b.items()})
            out.append(float(m["loss"]))
        losses[dev] = out
    a, b_ = np.array(losses["cuda"]), np.array(losses["cpu"])
    worst = float(np.max(np.abs(a - b_) / np.abs(b_)))
    print(f"[11] f32 BERT_TINY, card vs CPU: MLM logits max |err| {err:.3e} "
          f"(limit 1e-3); 3 train steps, losses "
          f"{[round(x, 6) for x in losses['cuda']]} (card), worst relative "
          f"difference {worst:.2e} (limit 1e-4)", flush=True)
    report["bert_parity"] = dict(logits_max_abs_err=err, losses=losses,
                                 worst=worst)
    if not err <= 1e-3:
        fail("f32 BERT logits differ between the card and the CPU")
    if not worst <= 1e-4:
        fail("f32 BERT training losses differ between the card and the CPU")


def bert_train_flops_per_token(cfg, seq: int) -> float:
    """Model FLOPs per trained token of BERT: 3 x the forward's matmul
    FLOPs, L(8d^2 + 4df + 4Sd) + 2d^2 + 2dV — the projections, the MLP,
    attention counted in full (it is not causal), the MLM dense layer and
    the tied head."""
    d, f, L, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    return 3.0 * (L * (8 * d * d + 4 * d * f + 4 * seq * d)
                  + 2 * d * d + 2 * d * v)


def phase_bert(report, card):
    """[12] The BERT slice at full width and depth: BERT-base bf16
    through pretrain_bert's code path, batch 16 x seq 512,
    DevicePrefetcher depth 2, 20 steps: every loss finite; per step K1
    and K2 once per layer, K6 2 x n_layers + 2, K3 and K5 never; step
    time, tokens/s, MFU, peak memory and data wait; then 3 profiled
    steps."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    from tony_tpu_torch import pretrain_bert, tree_leaves
    from tony_tpu_torch.io.prefetch import DevicePrefetcher
    from tony_tpu_torch.models.loop import run_training
    from tony_tpu_torch.models.train import init_state
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    steps, batch, seq = 20, 16, 512
    cfg, params = pretrain_bert.build("base", "cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    L = cfg.n_layers
    fns = dict(k1=A.flash_forward, k2=A.flash_backward_fused,
               k3a=A.flash_backward_dq, k3b=A.flash_backward_dkv,
               k5=N.rms_norm_forward, k6=N.layer_norm_forward)
    opt, step_fn = pretrain_bert.make_step(cfg, 1e-4, steps)
    state = init_state(params, opt)

    def run(state, n, seed, walls=None):
        source = pretrain_bert.synthetic_mlm_batches(seed, batch, seq, cfg)
        data = _TimedData(DevicePrefetcher(source, device="cuda", depth=2))
        losses = []

        def timed_step(st, b):
            t0 = time.perf_counter()
            st, m = step_fn(st, b)
            losses.append(m["loss"])
            if walls is not None:
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            return st, m

        state, _ = run_training(timed_step, state, data, n)
        return state, [float(x) for x in losses], data.waits

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    for fn in fns.values():
        fn.launches = 0
    walls = []
    t0 = time.perf_counter()
    state, losses, waits = run(state, steps, 1000, walls)
    wall = time.perf_counter() - t0
    c = {k: fn.launches for k, fn in fns.items()}
    variants = _check_tc_variants("bf16 BERT training")
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(walls[-10:]) * 1e3
    tok_s = batch * seq / (step_ms / 1e3)
    fpt = bert_train_flops_per_token(cfg, seq)
    mfu = tok_s * fpt / BF16_FLOPS
    wait_ms = statistics.median(waits) * 1e3
    print(f"[12] BERT-base bf16 ({n_params / 1e6:.1f} M params) training on "
          f"{card}: {steps} steps of {batch}x{seq} in {wall:.2f}s; step "
          f"{step_ms:.2f} ms (median of the last 10), {tok_s:,.0f} tokens/s, "
          f"MFU {mfu:.4f} ({fpt / 1e6:.1f} MFLOP/token vs 989 TFLOP/s), peak "
          f"memory {peak / 2**30:.2f} GiB, data wait median {wait_ms:.3f} "
          f"ms; losses {losses[0]:.4f} -> {losses[-1]:.4f}; launches {c}; "
          f"K1 and K2 by variant {variants['k1']}, {variants['k2']}",
          flush=True)
    report["bert"] = dict(variants=variants, step_ms=step_ms, tokens_per_s=tok_s, mfu=mfu,
                          flops_per_token=fpt, peak_bytes=peak,
                          data_wait_median_ms=wait_ms, losses=losses,
                          walls=walls, launches=c, wall_s=wall,
                          params=n_params)
    if not all(x == x and abs(x) < float("inf") for x in losses):
        fail("a BERT training loss is not finite")
    want = dict(k1=L * steps, k2=L * steps, k3a=0, k3b=0, k5=0,
                k6=(2 * L + 2) * steps)
    if c != want:
        fail(f"BERT launch counts {c} != {want}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state, 3, 2000)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, _ = _device_times(prof)
    total = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    if total == 0:
        print("[12b] device busy share: not measured (the profiler recorded "
              "no device time)", flush=True)
    else:
        print(f"[12b] 3 profiled BERT-base steps: device busy "
              f"{total / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall (share "
              f"{total / wall_us:.3f}); top: "
              + "; ".join(f"{n[:48]} {us / 1e3:.1f} ms" for n, us in top),
              flush=True)
    report["bert_profile"] = dict(wall_us=wall_us, device_us=total, top=top)
    return c


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
    phase_build(report)
    k1 = phase_kernel(report)
    bwd = phase_backward(report)
    k4 = phase_adamw(report)
    norms = phase_norms(report)
    phase_parity(report)
    phase_train_parity(report)
    phase_bert_parity(report)
    serve_k1, serve_k5 = phase_serve(report, card)
    counts = phase_train(report, card)
    bert = phase_bert(report, card)
    # launches on the main paths, each counted from 0 over its own run:
    # K1 over the serve (phase 5), the LM training run (phase 9) and the
    # BERT run (phase 12); K2 over both training runs; K3a/K3b over the
    # run with the budget at 0; K4 over the run with the fused optimizer;
    # K5 over the serve and the LM training run; K6 over the BERT run
    k1["launches"] = serve_k1 + counts["k1"] + bert["k1"]
    bwd["fused"]["launches"] = counts["k2"] + bert["k2"]
    bwd["dq"]["launches"] = counts["k3a"]
    bwd["dkv"]["launches"] = counts["k3b"]
    k4["launches"] = counts["k4"]
    norms["rms"]["launches"] = serve_k5 + counts["k5"]
    norms["ln"]["launches"] = bert["k6"]
    report["wall_s"] = time.perf_counter() - t0
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"wall {report['wall_s']:.1f}s", flush=True)
    print(json.dumps({"kernels": [k1, bwd["fused"], bwd["dq"], bwd["dkv"],
                                  k4, norms["rms"], norms["ln"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
