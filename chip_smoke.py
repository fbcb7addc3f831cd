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
13. the mesh path (dp/fsdp/tp) on NCCL at world 1: the runtime booted
   from the jax arm's environment (a free local port, mesh spec
   ``{"fsdp": -1}`` then ``{"dp": -1}``); ``small`` bf16 16 x 1024
   trained 20 steps through train_lm's sharded functions (params laid
   out by ``logical_axes``, the sharded step, global batches): K1, K2
   and K5 launched per step as on the unsharded path (phase 9), all on
   the tensor-core kernels, the first 5 losses within 1e-3 relative of
   phase 9's (same seeds), step time and device time per step beside
   phase 9's; a sharded checkpoint at step 10 restored into a fresh
   state reaching steps 11-12's losses within 1e-3; then (13c) K1, K2
   and K3a on each tp rank's head slice, tp in {2, 4}, GQA [16, 1024, 8,
   64] with KV in {8, 2, 1} and BERT's [16, 512, 12, 64], against the
   slice of the full call (bitwise where the arithmetic is the same);
14. the serving host: the threefry stream on the card against the CPU
   (bits and uniforms of [8, 32000] bitwise, Gumbel noise within 2 ulp);
   then phase 5's ``small`` bf16 and 24 requests behind the port's
   ``ServingServer`` on 127.0.0.1:0, driven over the socket by the
   port's ``StreamingClient`` (8 slots, max_len 1024, chunk 8): greedy
   tokens equal to phase 5's; the slice's main path, sampled (T 0.8,
   top-k 50, top-p 0.95, seed 0) with the classes in rotation, K1 and K5
   counted from 0 over it, its tokens equal to the in-process batcher's
   and through 4 slots; 8 batch requests preempted by two waves of 4
   interactive ones, so that streams are preempted twice, in bf16 and in
   f32 (each preempted stream equal to the run without preemption up to
   its first preemption and to a replay of each resume: ``prompt +
   tokens`` at the stream offset; each resumed row's logits within twice
   the measured re-prefill-vs-decode spread of the decode path's at the
   same step; equal to the end in f32, where a first difference is
   allowed only at a decision margin within 1e-4 of a logit; reported in
   bf16, where the re-prefilled history runs other arithmetic);
   BUSY past a queue depth of 4 with every request served
   under retries; a dropped connection's requests cancelled and their
   slots readmitted; tokens/s, TTFT and ITL p50/p99 per class from the
   client's frame arrival times, the busy share, and device launches,
   device time and wall per greedy and per sampled decode step (a serve
   of 4 requests of at most 16 tokens);
15. the decode variants behind ``serve_lm``: K1 against its plain
   version at the draft's D = 32 and at window 256 with S not a multiple
   of 64, K5 at d 128 and 512; an int8 cache slot's bytes against bf16's
   ((1 + 4/hd)/2) and the int8 tree's matmul weight bytes (about half);
   then phase 5's model and 24 requests (8 slots, 1024 positions) with
   (a) int8 weights, (b) an int8 KV cache, (c) window 256 over a rolling
   cache of 384 rows, (d) a ``tiny`` draft (vocab 32000, seed 1)
   proposing 4 tokens a round, greedy, and (e) sampled at T 0.8, top-k
   50, top-p 0.95: each served in process with K1 and K5 counted from 0
   (both models' admissions, every round's forwards), its tokens/s and,
   per decode step or round of 4 requests of at most 16 tokens, device
   launches, device ms and wall ms beside the plain batcher's on the
   same 4, tokens per round and the acceptance rate for (d) and (e);
   the greedy variants' streams against ``generate`` per request (the
   quantized model, the int8 cache, the linear windowed cache, the
   target) on 4 requests of at most 16 tokens, in f32 token for
   token but for a first difference at a near-tie of the logits (1e-4;
   1e-2 for the int8 cache), in bf16 reported; and each variant once
   through ``serve_lm --listen`` and ``serve_lm --connect`` as two
   processes, 4 requests of serve_lm's workload, every stream equal to
   the in-process serve's of the same 4 (the five replicas boot
   together first, the five clients run together last);
16. shared-prefix serving: K1 against its plain version at the template
   prefill's [1, P, 8, 64] bf16 causal (P 1 and 509) and K5 at the
   suffix extensions' rows; then phase 5's model with a 509-token
   system prompt ahead of 24 suffixes of 16-256 tokens (budgets 16-64),
   8 slots of 1024 positions: (b) prefix-blind, then with the prefix
   resident (K1 n_layers times, for the template alone; the serve's
   prefill tokens the suffixes'), tokens/s and the admission's wall and
   device ms a request, f32 streams on 8 requests against the
   prefix-blind ones (a first difference only at a near-tie, 1e-4),
   bf16 reported; (c) sampled behind the ``ServingServer`` with the
   classes in rotation, half the ADMITs naming the prefix, every stream
   equal to the in-process prefix-hit serve; (d) the ``tiny`` draft at
   k = 4 through ``spec_prefix_admit_rows``, f32 against the
   non-speculative prefix-hit serve (near-tie rule); (e) ``serve_lm
   --shared_prefix_file --publish_prefix`` warming a cold ``serve_lm``
   replica, which serves with zero prefix forwards and the warm one's
   streams, the template's bytes and publish wall; (f) ``serve_lm
   --warm_from`` booting from the warm replica's weights lane, its
   digest and streams the warm one's, the pull's bytes and wall;
17. disaggregated prefill/decode and the router: (a) per admission
   bucket S_b in {64, 128, 256, 512}, 8 prompts admitted colocated
   (``admit_rows`` into slots r) and through prefill_ship_rows,
   extract_kv_rows, the kvship codec, _validate_package and
   land_kv_rows into slots r of a fresh cache — cache bytes over [0,
   length), frontiers, logits and rng keys bitwise equal, in bf16, an
   int8 cache and a 384-row ring with window 256 — and the bytes a row
   ships beside the reckoning; (b) the router, a prefill tier and a
   decode tier in process on the card (``serve_lm --disaggregate``'s
   deployment): phase 5's 24 requests greedy (agreement with phase 5
   reported), then the main path, sampled with the classes in rotation,
   K1 and K5 counted from 0 and split by the thread that launched them
   (the decode tier launches no K1; the prefill tier n_layers per wave),
   f32 8 x 16 tokens against the colocated ``ServingServer`` behind a
   router (near-tie rule), and the decode tier's launches, device and
   wall ms a step with landing in place of admission (phase 14's 4
   requests of at most 16 tokens); (c) ``serve_lm
   --role prefill`` and ``--role decode`` as processes behind a
   ``--route --route_decode`` router process against one colocated
   ``serve_lm --listen`` behind a ``--route`` router, each driven by a
   ``--connect --mixed_classes`` client: TTFT and ITL p50/p99 per class,
   tokens/s, and from the tiers' STATS the ship and land wall and bytes;
   (d) two decode processes: one SIGKILLed mid-stream, a third added,
   the other drained by ``serve_lm --connect ROUTER --drain``: every
   stream of its budget (bf16), and the same drill in process in f32
   equal to the unfailed run (near-tie rule);
18. file-fed training: (a) 8 files of 8184 records of 1025 int32 tokens
   (256 MiB) from ``numpy.random.default_rng``; (b) all of it read
   shuffled (capacity 1024) through ``FileSplitReader`` on the native
   engine (built from ``tony_tpu_torch/io/native/datafeed.cc`` in phase
   2; the default engine must be it) and on the Python one, MB/s and
   records/s; (c) ``small`` bf16 16 x 1024, 20 steps through
   ``train_lm``'s ``file_source`` and a DevicePrefetcher of depth 2, in
   turns with the synthetic source (synthetic, files, files, synthetic):
   step ms, tokens/s, data wait, K1, K2 and K5 launches as in phase 9;
   (d) ``--elastic_data 16`` on the two-pass backward, 20 steps with an
   asynchronous checkpoint at step 10, restored by a new manager and run
   again from step 10: every batch of steps 10-19 equal by sha256 and
   every loss bitwise; (e) on a world-1 NCCL runtime, for ``small``'s
   train state unsharded and as DTensors on the fsdp mesh: the ms the
   step loop blocks on a synchronous and on an asynchronous save, the
   background write's wall and the bytes (an asynchronous save must
   block less than the fastest synchronous one), then ``run_training``
   over 13 synchronised steps offering a save after each and saving
   every 5: the wall of each step right after a save against the steps
   with no save near them, and each offer's wall (a step after a save
   must not wait for the write: it may not exceed the quiet median by
   half the write's wall); (f) ``python -m
   tony_tpu_torch.train_lm --data_files`` itself (in process, its
   runtime on NCCL at world 1, the sharded step), 20 steps, then
   ``--elastic_data 16`` stopped at step 10 and resumed from its DCP
   checkpoint to 20: K1, K2 and K5 launches as in phase 9;
19. mixture of experts: (a) ``tiny`` with 4 experts in f32, lm_loss, the
   aux loss (1e-5 relative) and every gradient leaf (1e-3 of its largest
   entry) on the card against the CPU from one set of weights, K1, K2
   and K5 counted; (b) ``small`` with 8 experts (top 2, capacity factor
   1.25) in bf16 through train_lm's code path, 20 steps at 16 x 1024:
   every loss finite, K1, K2 and K5 launched as in phase 9, step ms,
   tokens/s, MFU, peak memory, the aux loss and the dropped fraction
   per layer of one forward, and over 2 profiled steps the device time
   a step by MoE piece (dispatch/combine einsums, expert products,
   routing, the rest); then 3 steps with the fused optimizer (K4 once a
   leaf a step, over the tree whose router is f32 among bf16 leaves);
   (c) ``python -m tony_tpu_torch.train_lm --preset small --num_experts
   8`` itself (in process, NCCL world 1, mesh ``{"ep": 1}``), 4 steps,
   then resumed from its DCP checkpoint to 8; (d) the ContinuousBatcher
   on the MoE model, 8 of phase 5's requests greedy through 8 slots:
   tokens/s, K1 and K5 against the admissions and steps, launches,
   device and wall ms a decode step beside the dense ``small``'s; then
   in f32 at capacity factor 4.0 (nothing drops, whatever the admission
   padding) every stream of 16 tokens against ``generate`` of its prompt
   alone (near-tie rule, 1e-4);
20. context parallelism on one card: (a) the ring and (b) Ulysses over
   4 simulated ranks (the distributed bodies' hop and layout functions,
   the pass and the all-to-all replaced by a list rotation and a
   reshuffle) at small's widths, [4, 4096, 8, 64] bf16 causal, MHA and
   kv_heads 2: o (phase 3's bf16 limit) and dq/dk/dv (phase 6's: 2% of
   the largest entry) against the plain full-sequence attention, K1 and
   K2 10 launches each for the ring (4 diagonal and 6 full chunks of
   [4, 1024, 8, 64]; the 6 future chunks launch nothing), 9 backward
   launches with a non-zero lse cotangent, 4 each for Ulysses at [4,
   4096, 2, 64], and the time of the forward and backward beside the
   unsplit K1 + K2; (c) ``small`` bf16 at 16 x 1024 under the remat
   policies "full", "dots" and "attn": one step's loss and grad norm
   against "full" (1e-3 relative), K1 16, 16 and 8 a step, K2 8, then
   6 steps each: step ms, device ms a step (2 profiled) and peak
   memory; (d) ``python -m tony_tpu_torch.train_lm --preset small
   --cp_strategy ring`` and ``ulysses``, 3 steps each through the
   runtime on a world-1 NCCL mesh ``{"cp": 1}`` (several cp ranks need
   a host with more cards);
21. pipeline parallelism on one card: (a) ``small`` bf16 at 16 x 1024
   (remat "full") trained by GPipe and by 1F1B over 2 simulated pp
   ranks (4 layers a stage, 4 microbatches) and over 4 (2 layers, 8
   microbatches), every rank emulated in this process: the first step's
   loss (1e-3 relative) and grad norm (1e-2) against the unpipelined
   step on the same batch and params, K1, K2 and K5 a step against the
   counts the schedules predict, then 2 timed steps and 1 profiled: step
   ms, device ms a step, peak memory; (b) the cross-slice 1F1B as two
   processes on the card, one stage gang each (4 + 4 of small's
   layers, stage 0 embedding, stage 1 holding the head) over TONYC1 on
   loopback, 4 microbatches of [4, 1024]: 3 calls with the transport
   overlapped and 3 with ``sync_transport``, each stage's launches, step
   ms, ``tony_pipeline_bubble_fraction``, wire bytes a step (4 hops of
   [4, 1024, 512] bf16) and peak memory, the loss against (a)'s pp-2
   1F1B (1e-3 relative); (c) ``python -m tony_tpu_torch.train_lm
   --pp_schedule gpipe`` and ``1f1b``, 3 steps each on a world-1 NCCL
   mesh ``{"pp": 1}`` (the unpipelined step, as the schedule line says),
   and ``python -m tony_tpu_torch.train_pipeline`` as two stage
   processes for 3 steps (pp ranks over NCCL need a host with more
   cards);
22. observability, what the orchestrator reads of a port process, in a
   process of its own and in a job's order: (b) ``maybe_start``'s
   listener on a free port (its warm-up session first), a 400 ms
   capture asked for from another thread during 10 steps: the trace
   holds K1, K2 and the training thread's aten ops, and an overlapping
   request is refused (409); (a) then 3 successive ``StepTracer`` traces,
   each over steps [1, 4) of 5 ``run_training`` steps of ``small`` bf16
   16 x 1024: each Chrome trace, counted by the port's kernel names,
   holds exactly the K1, K2 and K5 launches the counters count over
   those steps (16, 8 and 33 a step) and the marks
   ``ProfilerStep#1..3``; a marker capture (400 one-element kernels 50
   us apart after a capture starts) counts the launches a capture
   misses after its start; (c) a fresh goodput
   ledger around 10 steps as ``train_lm`` runs them (no
   synchronisation, one asynchronous save) and 12 synchronised ones:
   its categories sum to the host wall within 1 ms, every step closed;
   the step, data_wait, checkpoint and overhead shares and the device
   time left when the loop returned; (d) the quiet step wall (median of
   the last 8 synchronised steps, after (a) and (b)) beside phase 9's,
   and the host cost of one step's spans and ledger intervals alone;
   (e) a ``ServeEngine`` over 4 requests of at most 16 tokens, then
   0.5 s idle: step and idle seconds both > 0, summing with overhead to
   the wall within 1 ms; (f) back in this process, after 21 phases:
   marker captures 50 and 500 us apart and after 128 other kernels, and
   a step trace held against the launch counters (a capture here misses
   its first GPU records): the capture after 128 other kernels records
   every marker, and the trace lost only its first launches' kernels;
23. fleet operations over port replicas, phase 5's ``small`` bf16
   weights and 8 slots of 48 positions: (a) a ``FleetController``
   (hysteresis 2, cooldown 3, 1 to 2 replicas) over a ``ServingRouter``
   and one in-process ``ServingServer``, ticked every 0.1 s by this
   thread, its provider growing in-process replicas warmed by a
   ``ChannelWarmer`` the first one seeds: an ``open_loop_load`` burst of
   80 requests of 16 tokens 50 ms apart (classes in rotation) gives exactly one
   scale-up, warmed peer to peer (no fallback, no failure, the target's
   resident digest the seeder's, sessions served there), then a trickle
   of 12 gives exactly one scale-down by drain; every stream at its
   budget; TTFT and ITL p99 before, during and after the scale-up;
   ``start()``/``stop()`` tick the timer loop; (b) ``SubprocessProvider``
   grows ``python -m tony_tpu_torch.serve_lm --preset small --slots 8
   --listen 127.0.0.1:0 --weights_version v2`` on the card (booting
   beside (a)), and ``rolling_upgrade`` moves 8 live streams of 32
   tokens off two v1 in-process replicas onto it, one terminal frame
   each at its budget, the v1 replicas retired and released; the
   process exits 0 within 10 s of its release; (c) (a) in f32 with 8
   requests of 16 tokens, the scale-down draining the warmed replica's
   live streams: every stream equal to the unscaled colocated run (the
   near-tie rule); K1 and K5 counted from 0 over each drill against its
   admissions and forwards;
24. tensor-parallel decoding and hybrid meshes: (a) phase 5's ``small``
   weights decode 8 of its prompts (64-480 tokens) 32 tokens each
   through ``prefill_rows``, ``place_rows`` and ``decode_step`` with a
   dict mesh ``{"tp": 2}`` and ``{"tp": 4}`` (every rank emulated on
   the card): in f32 token-identical to the unsharded run; in bf16,
   teacher-forced on the unsharded run's tokens, logits within twice the
   unsharded step's bf16-vs-f32 spread, and a greedy token that differs
   only at a near tie by that bound; the same for GQA
   (``n_kv_heads=2``) at tp 4 and int8 weights at tp 2; a beam of width
   4 over 2 prompts at tp 2 in f32 (tokens equal, scores within 1e-3);
   K1 ``n_layers × tp`` a prefill and K5 ``(2·n_layers + 1) × tp`` a
   forward, counted from 0 over every run; launches, device and wall ms
   of the bf16 step at tp 1, 2 and 4; (b) ``small`` 3 steps through
   train_lm's sharded path at world 1 on NCCL on the hybrid mesh of dcn
   ``{"dp": 1}`` × ``{"fsdp": -1}``: losses bitwise the flat ``{"fsdp":
   -1}`` run's; ``train_lm`` itself on that mesh (its mesh line);
25. ResNet and MNIST, no kernel of the port's on the path (cuDNN's
   convolutions stand where XLA's do): (a) the model FLOPs of a training
   image of ResNet-50 at 224 x 224, 1000 classes (6 a multiply-add of the
   convs and the head); ``train_resnet``'s step (bf16, channels_last, SGD
   nesterov at lr 0.1) at batch 32 and 128 on two batches made on the
   card: 2 warm-up steps, 6 timed, the last 3 under the profiler: step
   ms and images/s (the 3 unprofiled), MFU against 989 TFLOP/s, device ms
   and launches a step (all, and by class: cuDNN's and cuBLAS's kernels,
   PyTorch's elementwise and reduction kernels, the rest), busy share,
   peak memory, the top 5 kernels, every loss finite; ``python -m tony_tpu_torch.train_resnet --steps 3`` as a
   process on the card (beside 25b-d, and done before (a)'s steps):
   ``done:`` and exit 0; (b) one set of f32 weights, batch 4 at 224:
   ``forward(train=True)`` on the card against the CPU (logits and
   statistics within 1e-3 of the largest entry), bf16 logits against f32
   (relative L2 within 0.25), and after a step each of the 53 norms' new
   statistics against 0.9 · old + 0.1 · the mean and biased variance of
   its input (1e-4); (c) 3 steps at batch 32 on a world-1 NCCL ``{"dp":
   1}`` mesh, sync-BN's 2 all-reduces a norm run over the dp group (the
   rules drop a size-1 axis, so the layouts are handed the group),
   against the plain step: losses bitwise (cuDNN deterministic); (d)
   ``mnist_distributed``'s loop (200 steps, global batch 256, hidden 256)
   in this process on a world-1 NCCL runtime: accuracy >= 0.95 and its
   img/s; ``mlp_forward`` and ``cnn_forward`` at batch 256, card against
   the CPU in f32 (1e-4 of the largest logit);
26. the last mesh combinations, every rank emulated on the card: (a) the
   MoE cp routing arm at small's widths, 8 experts top 2 factor 1.25,
   [2, 4096, 512] f32 (every token offset by one shared vector, so
   capacity drops tokens) over 4 chunks against the whole-sequence
   ``moe_ffn``: every dispatch slot and combine weight equal, the aux
   and the dropped fraction within 1e-6, the output within 1e-5 of its
   largest entry, the dropped fraction > 0; then one ``small`` 8-expert
   step at [2, 4096] unsplit and on ``{"cp": 4}`` (the ring), in f32
   (loss within 1e-5, grad norm 1e-4 relative) and bf16 (loss 1e-3,
   phase 9's; grad norm 1e-2, phase 21's for a split bf16 step; the
   split bf16 gradient's L2 distance from the f32 one within 2x the
   unsplit bf16 gradient's), K1 ``2·L·10``, K2 ``L·10`` a step (10
   causal hops), the bf16 step's wall and device ms beside the unsplit
   step's; (b) ``small`` bf16 8 x 1024 on ``{"pp": 2}`` and ``{"pp": 2,
   "cp": 2}`` (cp replicated inside the pipeline) under GPipe and 1F1B
   on the two-pass backward: loss and every gradient bit for bit (the
   same arithmetic by construction: a dict mesh's pipeline never reads
   cp), both within phase 21's limits of the unpipelined step, K1 a
   step; (c) BERT-base bf16 16 x 512 on ``{"cp": 2}`` (the non-causal
   ring: K1 and K2 4 a layer; also in f32) and ``{"pp": 2}`` (the
   unsharded forward by construction on a dict mesh) against the
   unsharded step (26a's limits; K1, K2 and K6 a step); (d) a
   ``small`` 8-expert MoE greedy in f32, 8 prompts of 16-64, 16 tokens,
   on ``{"tp": 2}`` and ``{"ep": 2, "tp": 2}``: every stream equal to
   the unsharded run's, K1/K5 by phase 24's formulas, launches, device
   and wall ms of the last 4 steps beside the unsharded run's;
then a line of each phase's wall, a JSON line of per-kernel numbers, the card line, and the result
line ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --trace-loss-bisect

runs the whole script with three marker captures (50 and 500 us apart,
and 50 after 128 other kernels) after every phase, printed as
``[loss bisect]`` lines: how many GPU records a capture misses at its
start after each phase of the process's history.

    python3 chip_smoke.py --checkpoint [TREE]

runs phase 18e alone against the ``tony_tpu_torch`` of the checkout at
TREE (this one by default), checks nothing, and prints its numbers as a
JSON line: a change to the checkpoint layer against its parent, both in
one call.

    python3 chip_smoke.py --observability [PHASE9_STEP_MS [ORIGIN]]

runs phase 22 (a)-(e) alone, with its checks, and prints its numbers as
a JSON line; PHASE9_STEP_MS is printed beside the quiet step, with
ORIGIN ("given on the command line" by default). The whole script runs
(a)-(e) so, in a process of its own, and passes its own phase 9 step.
"""

import json
import math
import os
import re
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
    """Print the failed check on both streams (a caller that keeps only
    the end of standard error still sees it) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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
    import threading

    from tony_tpu_torch.io import native
    from tony_tpu_torch.ops import _kernels
    feed = {}

    def build_feed():
        t0 = time.perf_counter()
        feed["lib"] = native.load_native()
        feed["s"] = time.perf_counter() - t0

    feed_build = threading.Thread(target=build_feed)
    feed_build.start()
    seconds = _kernels.build()
    feed_build.join()
    names = ", ".join(os.path.relpath(s, HERE) for s in _kernels.SOURCES)
    print(f"[2] built {names} in {seconds:.1f}s (one nvcc each, in "
          f"parallel)", flush=True)
    if feed["lib"] is None:
        fail("the native data-feed engine (tony_tpu_torch/io/native/"
             "datafeed.cc) did not build with g++")
    print(f"[2] built the native data-feed engine "
          f"{os.path.relpath(native.library_path(), HERE)} with g++ in "
          f"{feed['s']:.1f}s, beside the nvcc builds", flush=True)
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
    return dict(k1=launches, k5=k5, cfg=cfg, params=params,
                prompts=prompts, budgets=budgets, outputs=outs,
                preset="small")


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
               timed=False, mesh=None, source=None, on_batch=None,
               step_hook=None):
    """``steps`` train steps (from ``start``) through train_lm's code path:
    its source (synthetic, or the host-batch ``source`` given: a file
    source of train_lm), prefetcher, ``default_optimizer`` (one schedule
    of 100 warmup steps for every run, so a resumed run sees the same lr)
    and ``run_training``; with a ``mesh``, its sharded path (params laid
    out by ``logical_axes``, the sharded step, global batches assembled
    from this process's shard); ``on_batch(step, batch)`` sees each batch
    as the step receives it; ``step_hook`` goes to ``run_training``;
    returns (state, losses, step wall seconds, data waits)."""
    import torch
    from tony_tpu_torch import train_lm
    from tony_tpu_torch.models import train as TR
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.models.loop import run_training
    opt = TR.default_optimizer(lr=3e-4, total_steps=1000, fused=fused)
    step_fn = TR.make_train_step(lambda p, b: T.lm_loss(p, b, cfg, mesh),
                                 opt, mesh)
    if state is None:
        state = TR.init_state(params, opt, mesh, T.logical_axes(cfg))
    if source is None:
        source = train_lm.synthetic_source(seed, batch, seq, cfg.vocab_size)
        for _ in range(start):
            next(source)
    sharding = (None if mesh is None else
                TR.batch_sharding(mesh, logical=("batch", "seq")))
    data = _TimedData(train_lm.make_data(source, "cuda", depth, sharding))
    losses, walls = [], []

    def timed_step(st, b):
        if on_batch is not None:
            on_batch(st["step"], b)
        t0 = time.perf_counter()
        st, m = step_fn(st, b)
        losses.append(m["loss"])
        if timed:
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return st, m

    state, _ = run_training(timed_step, state, data, start + steps,
                            start_step=start, checkpoint=checkpoint,
                            step_hook=step_hook)
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


def phase_mesh(report, card):
    """[13] The mesh path on NCCL at world 1: the runtime booted from the
    jax arm's environment (fsdp, then dp), `small` bf16 16x1024 trained 20
    steps through train_lm's sharded functions against phase 9's
    unsharded run, a sharded checkpoint at step 10 restored into a fresh
    state, and the tp-local kernel calls (phase 13c)."""
    import socket
    import statistics
    import tempfile

    import torch
    import torch.distributed as dist
    import tony_tpu_torch.runtime as rt
    from tony_tpu_torch import train_lm
    from tony_tpu_torch.models import train as TR
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.models.checkpoint import CheckpointManager
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    from tony_tpu_torch.parallel import mesh_shape

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(TONY_JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      TONY_JAX_PROCESS_ID="0", TONY_JAX_NUM_PROCESSES="1")
    meshes = []
    for axes in ({"fsdp": -1}, {"dp": -1}):
        os.environ["TONY_MESH_SPEC"] = json.dumps({"axes": axes})
        info = rt.initialize()
        meshes.append(rt.mesh())
    shapes = [mesh_shape(m) for m in meshes]
    print(f"[13] runtime from the jax arm's env (127.0.0.1:{port}, process "
          f"{info.process_id} of {info.num_processes}): backend "
          f"{dist.get_backend()}, meshes {shapes} on {card}", flush=True)
    if dist.get_backend() != "nccl" or shapes != [{"fsdp": 1}, {"dp": 1}]:
        fail(f"runtime: backend {dist.get_backend()}, meshes {shapes}")
    mesh = meshes[0]

    steps, batch, seq = 20, 16, 1024
    cfg, params = train_lm.build("small", "cuda")
    L = cfg.n_layers
    A.reset_launches()
    N.rms_norm_forward.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, save_interval_steps=10)
        t0 = time.perf_counter()
        state, losses, walls, waits = _train_run(
            cfg, params, steps, timed=True, mesh=mesh, checkpoint=mgr)
        wall = time.perf_counter() - t0
        c = dict(k1=A.flash_forward.launches,
                 k2=A.flash_backward_fused.launches,
                 k3a=A.flash_backward_dq.launches,
                 k3b=A.flash_backward_dkv.launches,
                 k5=N.rms_norm_forward.launches)
        variants = _check_tc_variants("bf16 mesh-path training")
        saved = mgr.all_steps()
        # restore step 10 into a fresh state of other weights, then steps
        # 11 and 12 against the uninterrupted run's
        opt = TR.default_optimizer(lr=3e-4, total_steps=1000)
        fresh = TR.init_state(
            T.init_params(torch.Generator().manual_seed(9), cfg, "cuda"),
            opt, mesh, T.logical_axes(cfg))
        restored = mgr.restore(template=fresh, step=10)
        if restored["step"] != 10 or restored["opt_state"]["count"] != 10:
            fail(f"sharded restore gave step {restored['step']}, count "
                 f"{restored['opt_state']['count']}, not 10")
        _, after, _, _ = _train_run(cfg, None, 2, start=10, state=restored,
                                    mesh=mesh)
    step_ms = statistics.median(walls[-10:]) * 1e3
    mesh_dev = phase_train_profile(report, cfg, state, mesh=mesh)
    ref = report["train"]["losses"][:5]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:5], ref)]
    plain_ms = report["train"]["step_ms"]
    plain_dev = report["train_profile"]["device_us"] / 3 / 1e3 or None
    print(f"[13] small bf16 on the mesh path ({shapes[0]}, NCCL) on {card}: "
          f"{steps} steps of {batch}x{seq} in {wall:.2f}s; step "
          f"{step_ms:.2f} ms (median of the last 10) against {plain_ms:.2f} "
          f"ms unsharded (phase 9); device {_ms(mesh_dev)} per step against "
          f"{_ms(plain_dev)} unsharded (3 profiled steps each); data wait "
          f"median {statistics.median(waits) * 1e3:.3f} ms; launches {c}; "
          f"K1 and K2 by variant {variants['k1']}, {variants['k2']}",
          flush=True)
    print(f"[13] first 5 losses {[round(x, 6) for x in losses[:5]]} against "
          f"the unsharded run's {[round(x, 6) for x in ref]}: relative "
          f"differences {[f'{r:.2e}' for r in rel]} (limit 1e-3: K2 adds dQ "
          f"with f32 atomics, so two runs differ in rounding; step 0, before "
          f"any backward, {'bitwise equal' if losses[0] == ref[0] else 'not bitwise equal'})",
          flush=True)
    crel = [abs(a - b) / abs(b) for a, b in zip(after, losses[10:12])]
    print(f"[13] sharded checkpoint: saved steps {saved}; restored step 10 "
          f"into a fresh state; steps 11-12 losses "
          f"{[round(x, 6) for x in after]} against {[round(x, 6) for x in losses[10:12]]} "
          f"uninterrupted (relative {[f'{r:.2e}' for r in crel]}, limit "
          f"1e-3)", flush=True)
    report["mesh"] = dict(shapes=shapes, step_ms=step_ms, walls=walls,
                          device_ms_per_step=mesh_dev,
                          plain_step_ms=plain_ms,
                          plain_device_ms_per_step=plain_dev,
                          losses=losses, unsharded_losses=ref,
                          rel_diff=rel, launches=c, variants=variants,
                          saved_steps=saved, resumed=after, resume_rel=crel)
    if not all(abs(x) < float("inf") for x in losses):
        fail("a mesh-path training loss is not finite")
    want = dict(k1=2 * L * steps, k2=L * steps, k3a=0, k3b=0,
                k5=(4 * L + 1) * steps)
    if c != want:
        fail(f"mesh-path launch counts {c} != {want} (the unsharded "
             f"path's per step)")
    if not max(rel) <= 1e-3:
        fail("the mesh path's first 5 losses differ from the unsharded "
             "run's")
    if saved != [1, 10, 20] or not max(crel) <= 1e-3:
        fail("the sharded checkpoint did not resume to the uninterrupted "
             "losses")
    phase_tp_local(report)
    rt.shutdown()
    return c


def phase_tp_local(report):
    """[13c] K1 and K2 (and K3a) on each tp rank's head slice, on the
    card with no collectives, against the slice of the full call: GQA
    [16, 1024, 8, 64] causal with KV in {8, 2, 1} and BERT's [16, 512,
    12, 64] non-causal, tp in {2, 4}; each rank takes its query heads and
    the kv heads ``tp_kv_heads`` gives it. K1's o and lse must be bitwise
    equal. The backward outputs are held within one bf16 ulp of the full
    call's (plus 1e-5 of the largest entry, for f32 summation order), and
    whether they are bitwise equal is reported: K3a's dQ and K2's dK/dV
    of the kv heads a rank owns whole run the same arithmetic (delta, a
    plain torch reduction, is recomputed on the slice); K2's dQ adds with
    f32 atomics in no fixed order. Where tp > KV ranks share a kv head,
    their dK/dV partials, each rounded to bf16, are summed: held within
    one bf16 ulp of every rounded term."""
    import torch
    from tony_tpu_torch.ops import attention as A
    cases = [(16, 1024, 8, kv, True) for kv in (8, 2, 1)] + \
        [(16, 512, 12, 12, False)]
    rows = []
    for b, s, h, kv, causal in cases:
        q, k, v = _qkv(b, s, h, kv, 64, torch.bfloat16, seed=77 + kv + s)
        g = torch.Generator(device="cuda").manual_seed(5 + kv)
        do = torch.randn(q.shape, device="cuda", generator=g).to(q.dtype)
        kw = dict(causal=causal, scale=64 ** -0.5, window=None)
        o, lse = A.flash_forward(q, k, v, **kw)
        dq2, dk, dv = A.flash_backward_fused(q, k, v, o, lse, do, **kw)
        dq3 = A.flash_backward_dq(q, k, v, o, lse, do, **kw)
        for tp in (2, 4):
            hl = h // tp
            sums = [torch.zeros(dk.shape, dtype=torch.float32,
                                device="cuda") for _ in range(4)]
            fwd_bitwise, bwd_bitwise, ulps = True, True, 0.0
            for r in range(tp):
                lo, hi = A.tp_kv_heads(h, kv, r, tp)
                sl = slice(r * hl, (r + 1) * hl)
                args = [t.contiguous() for t in (
                    q[:, :, sl], k[:, :, lo:hi], v[:, :, lo:hi])]
                o_r, lse_r = A.flash_forward(*args, **kw)
                dor = do[:, :, sl].contiguous()
                dq2_r, dk_r, dv_r = A.flash_backward_fused(
                    *args, o_r, lse_r, dor, **kw)
                dq3_r = A.flash_backward_dq(*args, o_r, lse_r, dor, **kw)
                fwd_bitwise &= torch.equal(o_r, o[:, :, sl]) and \
                    torch.equal(lse_r, lse[:, sl])
                pairs = [(dq2_r, dq2[:, :, sl]), (dq3_r, dq3[:, :, sl])]
                bwd_bitwise &= torch.equal(dq3_r, dq3[:, :, sl])
                if kv % tp == 0:      # this rank owns kv heads lo:hi whole
                    pairs += [(dk_r, dk[:, :, lo:hi]),
                              (dv_r, dv[:, :, lo:hi])]
                    bwd_bitwise &= torch.equal(dk_r, dk[:, :, lo:hi]) and \
                        torch.equal(dv_r, dv[:, :, lo:hi])
                for got, want in pairs:
                    ulps = max(ulps, _ulps(got, want, 7,
                                           1e-5 * want.abs().max().item()))
                for acc, t in zip(sums, (dk_r, dv_r, dk_r.abs(),
                                         dv_r.abs())):
                    acc[:, :, lo:hi] += t.float()
            # the ranks' summed dK/dV: one bf16 ulp (2^-8 relative at
            # worst) of every rounded term, and 1e-5 of the largest entry
            ratio = 0.0
            for got, full, terms in ((sums[0], dk, sums[2]),
                                     (sums[1], dv, sums[3])):
                lim = 2.0 ** -8 * (terms + full.float().abs()) \
                    + 1e-5 * full.float().abs().max()
                ratio = max(ratio, ((got - full.float()).abs()
                                    / lim).max().item())
            ok = fwd_bitwise and ulps <= 1.0 and ratio <= 1.0
            rows.append(dict(shape=[b, s, h, 64], kv=kv, tp=tp,
                             causal=causal, fwd_bitwise=fwd_bitwise,
                             bwd_bitwise=bwd_bitwise, bwd_ulps=ulps,
                             kv_sum_ratio=ratio, ok=ok))
            owned = ", K2 dK/dV" if kv % tp == 0 else ""
            print(f"[13c] tp={tp} [{b}, {s}, {h}, 64] KV={kv} "
                  f"{'causal' if causal else 'non-causal'}: o, lse bitwise "
                  f"{fwd_bitwise}; K3a dQ{owned} bitwise {bwd_bitwise}; "
                  f"backward within {ulps:.3f} ulp (limit 1); summed dK/dV "
                  f"at {ratio:.3f} of their limit", flush=True)
            if not ok:
                fail(f"tp-local kernel calls disagree with the full call's "
                     f"slice: {rows[-1]}")
    report["tp_local"] = rows


def phase_train_profile(report, cfg, state, two_pass=False, mesh=None):
    """Device busy share of 3 profiled training steps (with the two-pass
    backward when the caller set the partials budget to 0; on the sharded
    path with a ``mesh``, continuing ``state``); returns the device
    milliseconds per step, None if the profiler recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if mesh is None:
            _train_run(cfg, state["params"], 3, seed=1)
        else:
            _train_run(cfg, None, 3, seed=1, state=state, mesh=mesh)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, _ = _device_times(prof)
    total = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    what = ("two-pass " if two_pass else "") + ("mesh-path " if mesh
                                                else "")
    tag = "[13b]" if mesh is not None else "[9b]"
    if total == 0:
        print(f"{tag} {what}device busy share: not measured (the profiler "
              f"recorded no device time)", flush=True)
    else:
        print(f"{tag} 3 profiled {what}training steps: device busy "
              f"{total / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall (share "
              f"{total / wall_us:.3f}); top: "
              + "; ".join(f"{n[:48]} {us / 1e3:.1f} ms" for n, us in top),
              flush=True)
    key = ("train_profile_mesh" if mesh is not None else
           "train_profile_two_pass" if two_pass else "train_profile")
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


#: phase 14's sampling settings (the slice's sampled client)
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95, seed=0)


def _stream_bits_on_card(report):
    """[14a] the threefry stream on the card against the CPU for 8 keys
    drawing [8, 32000]: bits and uniforms bitwise, Gumbel noise within 2
    f32 ulp."""
    import torch
    from tony_tpu_torch.ops import prng
    keys = prng.split(prng.PRNGKey(0), 8)
    shape = (32000,)
    bits_c, bits_g = (prng.random_bits(keys, shape),
                      prng.random_bits(keys.cuda(), shape).cpu())
    u_c, u_g = prng.uniform(keys, shape), prng.uniform(keys.cuda(),
                                                       shape).cpu()
    g_c, g_g = prng.gumbel(keys, shape), prng.gumbel(keys.cuda(),
                                                     shape).cpu()
    bits_eq = torch.equal(bits_c, bits_g)
    u_eq = torch.equal(u_c.view(torch.int32), u_g.view(torch.int32))
    g_ulps = _ulps(g_g, g_c, 23)
    g_equal = int((g_c.view(torch.int32) == g_g.view(torch.int32)).sum())
    print(f"[14a] threefry [8, 32000] on the card vs the CPU: bits "
          f"{'bitwise equal' if bits_eq else 'DIFFER'}, uniform "
          f"{'bitwise equal' if u_eq else 'DIFFERS'}, Gumbel within "
          f"{g_ulps:.2f} ulp ({g_equal}/{g_c.numel()} bitwise)", flush=True)
    report["serving_host"]["stream_bits"] = dict(
        bits_equal=bits_eq, uniform_equal=u_eq, gumbel_max_ulps=g_ulps,
        gumbel_bitwise=g_equal)
    if not (bits_eq and u_eq):
        fail("threefry bits or uniforms differ between the card and the CPU")
    if not g_ulps <= 2.0:
        fail(f"Gumbel noise {g_ulps:.2f} ulp from the CPU's (limit 2)")


def _decision_margin(params, cfg, prompt, toks, j, a, b, stream):
    """How close the choice between tokens ``a`` and ``b`` was at
    generated step ``j`` of a sampled request: the smallest change of each
    logit (in logit units) that could swap it, from the logits of prompt
    + toks[:j] by a full forward, the filters and the request's Gumbel
    noise at stream position j. A token the filters drop must first rise
    past the smallest kept logit."""
    import torch
    from tony_tpu_torch.models import decode as D
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.ops import prng
    logits, _ = T.forward(params, torch.tensor([list(prompt) + toks[:j]],
                                               device="cuda"), cfg)
    lg = logits[0, -1].float()
    t = SAMPLING["temperature"]
    kept = torch.isfinite(D._filter_logits(lg[None], t, SAMPLING["top_k"],
                                           SAMPLING["top_p"])[0])
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(SAMPLING["seed"]), stream),
                       j)
    score = prng.gumbel(key.cuda(), (cfg.vocab_size,)) + lg / t
    delta = (score[a] - score[b]).abs().item() * t / 2
    cut = lg[kept].min().item()
    for x in (a, b):
        if not kept[x]:
            delta = max(delta, (cut - lg[x].item()) / 2)
    return delta


def _replays(params, cfg, resumes) -> dict:
    """Replay resumed requests: each (prompt, tokens, k, budget, stream)
    submits prompt + tokens[:k] with its stream pinned at offset k to a
    fresh 8-slot sampled engine — what a preemption's reincarnation runs
    (rows do not affect each other). A stream resumed more than once
    replays each resume on an engine of its own round, since an engine
    admits one request per stream. Returns {index: tokens after k}."""
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    rounds: dict = {}
    seen: dict = {}
    for i, r in enumerate(resumes):
        n = seen[r[4]] = seen.get(r[4], -1) + 1
        rounds.setdefault(n, []).append(i)
    out: dict = {}
    for idx in rounds.values():
        b = S.ContinuousBatcher(params, cfg, batch=8, max_len=1024, chunk=8,
                                **SAMPLING)
        eng = S.ServeEngine(
            b, on_delta=lambda r, t: out.setdefault(r, []).extend(t),
            on_retired=lambda r, why, n, final: out.setdefault(
                r, []).extend(final), registry=MetricsRegistry())
        for i in idx:
            prompt, toks, k, budget, stream = resumes[i]
            eng.submit(i, list(prompt) + toks[:k], budget - k,
                       rng=(stream, k))
        eng.drain()
        eng.run()
    return out


def _check_preempted(what, got, want, points, params, cfg, prompts,
                     budgets, exact_limit=None):
    """Streams never preempted must give ``want``'s tokens (the run
    without preemption) exactly: the same arithmetic. A preempted stream
    must give them up to its first preemption, and after each preemption
    at ``k`` emitted tokens, exactly the tokens of :func:`_replay` from
    k. Whether it also equals ``want`` after k is reported, not
    required, in bf16: the re-prefilled history runs other arithmetic
    than decoding did. With ``exact_limit`` (f32) it is required too,
    but for a first difference at a decision margin within the limit.
    ``points``: (stream, emitted) of each preemption. Returns (preempted
    streams, how many equal ``want``, [(stream, first differing step, its
    decision margin)])."""
    by: dict = {}
    for stream, k in points:
        by.setdefault(stream, set()).add(k)
    bad = [i for i in range(len(want)) if i not in by and got[i] != want[i]]
    if bad:
        fail(f"{what}: requests {bad} were not preempted and differ")
    resumes, spans = [], []
    for s, ks in sorted(by.items()):
        ks = sorted(ks)
        if got[s][:ks[0]] != want[s][:ks[0]]:
            fail(f"{what}: stream {s} differs before its preemption")
        for i, k in enumerate(ks):
            end = ks[i + 1] if i + 1 < len(ks) else len(got[s])
            resumes.append((prompts[s], got[s], k, budgets[s], s))
            spans.append((s, k, end))
    replayed = _replays(params, cfg, resumes)
    for i, (s, k, end) in enumerate(spans):
        if replayed[i][:end - k] != got[s][k:end]:
            fail(f"{what}: stream {s} resumed at token {k} differs from "
                 f"its replay")
    same, diffs = 0, []
    for s in sorted(by):
        if got[s] == want[s]:
            same += 1
        else:
            j = next(i for i, (x, y) in enumerate(zip(got[s], want[s]))
                     if x != y)
            m = _decision_margin(params, cfg, prompts[s], want[s], j,
                                 got[s][j], want[s][j], s)
            diffs.append((s, j, round(m, 6)))
            if exact_limit is not None and not m <= exact_limit:
                fail(f"{what}: preempted stream {s} first differs from the "
                     f"run without preemption at token {j}, decision "
                     f"margin {m:.3e} (limit {exact_limit})")
    return sorted(by), same, diffs


def _serve_over_wire(batcher, prompts, budgets, classes=None, retries=0,
                     registry=None, **server_kw):
    """Serve the requests through a fresh ServingServer on 127.0.0.1:0,
    driven by the port's StreamingClient over the socket, one class per
    request (None: classless). Returns a dict: the WorkloadStreams, the
    wall, the server's stats at the end, the BUSY frames the client saw
    and the engine's preemptions (stream, tokens emitted)."""
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    from tony_tpu_torch.serve_lm import WorkloadStreams
    from tony_tpu_torch.serving.client import StreamingClient
    from tony_tpu_torch.serving.server import ServingServer

    class CountingClient(StreamingClient):
        busy = 0

        def _retry_busy(self, rid, hint_ms):    # reader thread only
            self.busy += 1
            return super()._retry_busy(rid, hint_ms)

    server = ServingServer(batcher, port=0,
                           registry=registry or MetricsRegistry(),
                           **server_kw)
    points = _record_preemptions(server.engine)
    port = server.start()
    try:
        with CountingClient("127.0.0.1", port) as c:
            run = WorkloadStreams(c)
            for i, (p, n) in enumerate(zip(prompts, budgets)):
                run.submit([p], [n], classes[i] if classes else None,
                           retries)
            wall = run.wait()
            stats = c.stats()
            busy = c.busy
    finally:
        server.stop(drain=True)
    return dict(run=run, wall=wall, stats=stats, busy=busy, points=points)


def _record_preemptions(engine) -> list:
    """(stream, tokens emitted) of every preemption ``engine`` makes, as
    it happens."""
    points = []
    preempt = engine._preempt_locked

    def recording():
        requeued, evicted = out = preempt()
        points.extend((r.stream, r.emitted) for r in requeued + evicted)
        return out

    engine._preempt_locked = recording
    return points


def _record_resume_logits(batcher) -> dict:
    """{(stream, k): f32 host logits} that ``batcher``'s admissions seed
    each RESUMED row with (a stream re-admitted at offset k after a
    preemption): what the reincarnation samples its first token from."""
    got: dict = {}
    admit = batcher._admit_batch

    def recording(pairs, prompts):
        resumed = [(row, s, batcher._stream_skip[s]) for row, s in pairs
                   if s in batcher._stream_skip]
        admit(pairs, prompts)
        for row, s, k in resumed:
            got[(s, k)] = batcher.logits[row].float().cpu()

    batcher._admit_batch = recording
    return got


def _decode_logits(params, cfg, prompt, toks):
    """f32 logits [len(toks), V] of every generated step of a request
    whose tokens were ``toks``, on the decode path: a prefill of the
    prompt (step 0), then one decode step per token fed back."""
    import torch
    from tony_tpu_torch.models import decode as D
    lg, cache = D.prefill(params, torch.tensor([list(prompt)],
                                               device="cuda"),
                          cfg, len(prompt) + len(toks))
    out = [lg[0].float()]
    for t in toks[:-1]:
        lg, cache = D.decode_step(
            params, torch.tensor([t], device="cuda"), cache,
            cache["length"], cfg)
        out.append(lg[0].float())
    return torch.stack(out)


def _prefill_logits(params, cfg, prompt, toks):
    """f32 logits [len(toks), V] of every generated step j from a
    re-prefill of prompt + toks[:j] through ``prefill_rows`` (what a
    resume at j runs), 16 contexts a forward."""
    import numpy as np
    import torch
    from tony_tpu_torch.models import decode as D
    from tony_tpu_torch.models import serve as S
    out = []
    for lo in range(0, len(toks), 16):
        ctx = [list(prompt) + toks[:j]
               for j in range(lo, min(lo + 16, len(toks)))]
        width = S.bucket_for(max(len(c) for c in ctx), 1024)
        pad = np.zeros((len(ctx), width), np.int64)
        for i, c in enumerate(ctx):
            pad[i, :len(c)] = c
        lg, _ = D.prefill_rows(
            params, torch.from_numpy(pad).cuda(),
            torch.tensor([len(c) for c in ctx], device="cuda"), cfg)
        out.append(lg.float())
    return torch.cat(out)


def _resume_logits_check(what, params, cfg, prompts, got, resumed):
    """Hold every resumed row's logits — the ones its first token after
    the preemption was drawn from — against the decode path's logits at
    the same step and context: the stream's own tokens ``got`` fed back
    one decode step at a time, as a run without preemption computes them
    (up to a stream's first departure these are the unpreempted run's
    logits; after it, a later resume's context is the stream's own). The
    tolerance comes from this run: twice the largest distance between a
    re-prefill and the decode path at any step of the same streams (the
    arithmetic a correct resume changes). It must lie below the smallest
    distance between a re-prefill one token short and the decode path
    (what a resume with a wrong context gives), or the check could not
    see a fault; both readings are printed. Returns the readings."""
    import torch
    streams = sorted({s for s, _ in resumed})
    spread, short, res, scale = [], [], {}, 0.0
    for s in streams:
        dec = _decode_logits(params, cfg, prompts[s], got[s])
        pre = _prefill_logits(params, cfg, prompts[s], got[s])
        d = (pre - dec).abs().amax(dim=-1)
        spread.append(d[1:])
        short.append((pre[:-1] - dec[1:]).abs().amax(dim=-1))
        scale = max(scale, dec.abs().max().item())
        for (s_, k), lg in resumed.items():
            if s_ == s:
                res[(s, k)] = (lg.cuda() - dec[k]).abs().max().item()
    spread, short = torch.cat(spread), torch.cat(short)
    limit = 2 * spread.max().item()
    blind = short.min().item()
    worst = max(res.values())
    print(f"[14d] {what}: resumed logits vs the decode path's at each "
          f"resume point, same context (max |diff| over the vocabulary) "
          f"{ {k: round(v, 6) for k, v in sorted(res.items())} }; "
          f"re-prefill vs decode at every step of those streams: median "
          f"{spread.median().item():.6f}, max {spread.max().item():.6f} "
          f"-> limit {limit:.6f}; a context one token short: min "
          f"{blind:.6f}; largest |logit| {scale:.4f}", flush=True)
    if not limit < blind:
        fail(f"{what}: resume-logits limit {limit:.6f} is not below the "
             f"one-token-short reading {blind:.6f}: the check is blind")
    if not worst <= limit:
        fail(f"{what}: resumed logits {worst:.6f} from the decode path's "
             f"(limit {limit:.6f}, twice the re-prefill spread)")
    return dict(resume_diff={f"{s}@{k}": v for (s, k), v in res.items()},
                spread_median=spread.median().item(),
                spread_max=spread.max().item(), limit=limit,
                one_short_min=blind, logit_max=scale)


def _preemption_run(label, params, cfg, prompts, exact_limit):
    """[14d] 8 batch requests fill the 8 slots of a sampled server; 4
    interactive ones arrive and evict batch rows; once those 4 are done
    and every evicted stream has resumed and emitted again, 4 more
    interactive ones arrive and evict again — the resumed rows, which lag
    the others, so streams are preempted twice. Every stream is held
    against the same 16 requests served without preemption
    (:func:`_check_preempted`), and every resumed row's logits against
    the unpreempted run's (:func:`_resume_logits_check`)."""
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    from tony_tpu_torch.serve_lm import WorkloadStreams
    from tony_tpu_torch.serving.client import StreamingClient
    from tony_tpu_torch.serving.server import ServingServer
    budgets = [96] * 8 + [16] * 8

    def batcher():
        return S.ContinuousBatcher(params, cfg, batch=8, max_len=1024,
                                   chunk=8, **SAMPLING)

    server = ServingServer(batcher(), port=0, registry=MetricsRegistry())
    points = _record_preemptions(server.engine)
    resumed = _record_resume_logits(server.engine.b)
    eng = server.engine

    def resumed_and_emitting(first):
        with eng._lock:
            live = {r.stream: r.emitted for r in eng._reqs.values()
                    if not r.done and r in eng._occupant}
        return all(live.get(s, -1) > k for s, k in first)

    port = server.start()
    try:
        with StreamingClient("127.0.0.1", port) as c:
            run = WorkloadStreams(c)
            run.submit(prompts[:8], budgets[:8], "batch")
            deadline = time.time() + 120
            while None in run.ttft[:8] and time.time() < deadline:
                time.sleep(0.002)
            run.submit(prompts[8:12], budgets[8:12], "interactive")
            while (None in run.outputs[8:12]
                   or not resumed_and_emitting(list(points))) \
                    and time.time() < deadline:
                time.sleep(0.002)
            first = len(points)
            run.submit(prompts[12:], budgets[12:], "interactive")
            run.wait()
            stats = c.stats()
    finally:
        server.stop(drain=True)
    twice = sorted({s for s, _ in points
                    if sum(1 for x, _ in points if x == s) > 1})
    if not first or not twice:
        fail(f"phase 14 ({label}): {first} preemptions by the first "
             f"interactive wave, streams preempted twice {twice}: the "
             f"run must preempt a stream twice")
    ref = batcher().serve(prompts, budgets)
    vic, same, diffs = _check_preempted(
        f"preemption ({label})", run.outputs, ref, points, params, cfg,
        prompts, budgets, exact_limit)
    if set(resumed) != set(points):
        fail(f"phase 14 ({label}): resumed admissions {sorted(resumed)} "
             f"!= preemptions {sorted(points)}")
    print(f"[14d] preemption, {label}: {stats['preemptions']} batch rows "
          f"evicted by two waves of 4 interactive requests ((stream, "
          f"tokens) {sorted(points)}; preempted twice: streams {twice}); "
          f"the other {16 - len(vic)} streams equal the run without "
          f"preemption; each preempted stream equals it up to its first "
          f"preemption and its replay from each; {same}/{len(vic)} equal "
          f"it to the end, first differences (stream, step, decision "
          f"margin in logits) {diffs}", flush=True)
    logit = _resume_logits_check(f"preemption ({label})", params, cfg,
                                 prompts, run.outputs, resumed)
    return dict(preemptions=stats["preemptions"], points=sorted(points),
                twice=twice, equal=same, diffs=diffs, logits=logit)


def _per_step(batcher, prompts, budgets) -> dict:
    """Device launches, device ms and wall ms per decode step (per round
    of a speculative batcher) of an in-process serve under torch.profiler
    — admission included, as phase 5b counts — and the top device time by
    kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batcher.serve(prompts, budgets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, launches = _device_times(prof)
    steps = batcher.rounds_executed or batcher.steps_executed
    return dict(launches=launches / steps,
                device_ms=sum(dev.values()) / 1e3 / steps,
                wall_ms=wall * 1e3 / steps, steps=steps,
                top=sorted(dev.items(), key=lambda kv: -kv[1])[:4])


def phase_serving_host(report, card, serve):
    """[14] the serving host on the card: ``small`` bf16 behind the
    port's ServingServer on 127.0.0.1:0, driven by the port's
    StreamingClient over the socket, 8 slots, max_len 1024, chunk 8,
    phase 5's 24 requests."""
    import torch
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    from tony_tpu_torch.serve_lm import WorkloadStreams
    from tony_tpu_torch.serving.client import StreamingClient
    from tony_tpu_torch.serving.server import ServingServer
    report["serving_host"] = rep = {}
    _stream_bits_on_card(report)
    cfg, params = serve["cfg"], serve["params"]
    prompts, budgets = serve["prompts"], serve["budgets"]
    n = len(prompts)

    def batcher(slots=8, **kw):
        return S.ContinuousBatcher(params, cfg, batch=slots, max_len=1024,
                                   chunk=8, **kw)

    # 14b greedy over the wire, equal to phase 5's in-process serve
    res = _serve_over_wire(batcher(), prompts, budgets)
    run, wall = res["run"], res["wall"]
    if run.outputs != serve["outputs"]:
        bad = [i for i in range(n) if run.outputs[i] != serve["outputs"][i]]
        fail(f"greedy over the wire differs from phase 5's serve in "
             f"requests {bad}")
    g_tok = sum(budgets)
    g_lat = run.latency_ms()
    print(f"[14b] greedy over the wire: {n}/{n} requests equal phase 5's "
          f"tokens; {g_tok} tokens in {wall:.3f}s ({g_tok / wall:.1f} "
          f"tokens/s); " + _lat_text(g_lat), flush=True)
    rep["greedy"] = dict(wall_s=wall, tokens=g_tok, tokens_per_s=g_tok / wall,
                         latency_ms=g_lat)

    # 14c the slice's main path: sampled, classes interactive / standard /
    # batch in rotation; the kernel counts are zeroed just before
    sampled = batcher(**SAMPLING)
    classes = [S.QOS_CLASSES[i % 3] for i in range(n)]
    A.reset_launches()
    N.rms_norm_forward.launches = 0
    S.CALL_COUNTS.clear()
    res = _serve_over_wire(sampled, prompts, budgets, classes)
    run, wall, stats = res["run"], res["wall"], res["stats"]
    k1 = A.flash_forward.launches
    k5 = N.rms_norm_forward.launches
    variants = _check_tc_variants("the sampled serve over the wire")["k1"]
    admits = sum(c for (name, _), c in S.CALL_COUNTS.items()
                 if name == "admit_rows")
    forwards = sum(c * (shape[1] if name == "step_rows" else 1)
                   for (name, shape), c in S.CALL_COUNTS.items()
                   if name in ("admit_rows", "admit_row", "step_rows"))
    if admits == 0 or k1 != cfg.n_layers * admits:
        fail(f"phase 14: K1 launches {k1} != {cfg.n_layers} x {admits} "
             f"admit_rows calls")
    if k5 != (2 * cfg.n_layers + 1) * forwards:
        fail(f"phase 14: K5 launches {k5} != (2 x {cfg.n_layers} + 1) x "
             f"{forwards} model forwards")
    s_tok = sum(len(o) for o in run.outputs if o)
    if [len(o or []) for o in run.outputs] != budgets:
        fail("a sampled request over the wire did not get its budget")
    if not all(0 <= t < cfg.vocab_size for o in run.outputs for t in o):
        fail("a sampled token is outside the vocabulary")
    want8 = batcher(**SAMPLING).serve(prompts, budgets)
    vic, same_v, diffs_v = _check_preempted(
        "sampled over the wire", run.outputs, want8, res["points"], params,
        cfg, prompts, budgets)
    want4 = batcher(slots=4, **SAMPLING).serve(prompts, budgets)
    if want4 != want8:
        bad = [i for i in range(n) if want4[i] != want8[i]]
        fail(f"sampled through 4 slots differs from 8 slots in requests "
             f"{bad}")
    lat = {c: run.latency_ms(c) for c in S.QOS_CLASSES}
    print(f"[14c] sampled (T 0.8, top-k 50, top-p 0.95, seed 0) over the "
          f"wire, classes in rotation: the {n - len(vic)} unpreempted "
          f"requests equal the in-process serve; {stats['preemptions']} "
          f"preemptions (streams {vic}, each equal to its replay, "
          f"{same_v} to the in-process serve, first differences "
          f"{diffs_v}); {s_tok} tokens in {wall:.3f}s ({s_tok / wall:.1f} "
          f"tokens/s); through 4 slots {n}/{n} equal; K1 launches {k1} "
          f"over {admits} admit_rows calls ({variants['tensor_core']} tensor-core), K5 "
          f"{k5} over {forwards} model forwards", flush=True)
    for c in S.QOS_CLASSES:
        print(f"[14c]   {c}: " + _lat_text(lat[c]), flush=True)
    rep["sampled"] = dict(wall_s=wall, tokens=s_tok,
                          tokens_per_s=s_tok / wall, latency_ms=lat,
                          preemptions=stats["preemptions"],
                          preempted=vic, preempted_equal=same_v,
                          preempted_diffs=diffs_v,
                          k1_launches=k1, k5_launches=k5,
                          admit_rows_calls=admits, forwards=forwards)

    # 14d preemption, in bf16 and in f32 (the same weights, widened)
    from tony_tpu_torch import tree_map
    cfg32 = cfg.scaled(dtype=torch.float32)
    params32 = tree_map(lambda v: v.float(), params)
    for label, p_, c_, limit in (("bf16", params, cfg, None),
                                 ("f32", params32, cfg32, 1e-4)):
        rep[f"preemption_{label}"] = _preemption_run(
            label, p_, c_, prompts[:16], limit)
    del params32

    # 14e BUSY: max_queue_depth 4, 16 submissions, retried until served
    busy_p, busy_b = prompts[:16], [16] * 16
    res = _serve_over_wire(batcher(**SAMPLING), busy_p, busy_b,
                           retries=50, max_queue_depth=4, busy_retry_ms=50)
    run, stats, busy = res["run"], res["stats"], res["busy"]
    done = sum(1 for o, nb in zip(run.outputs, busy_b)
               if o is not None and len(o) == nb)
    share = busy / (len(busy_p) + busy)
    print(f"[14e] BUSY: 16 submissions at max_queue_depth 4: {busy} BUSY "
          f"frames (busy share {share:.3f} of ADMIT frames), server shed "
          f"{stats['shed']}, {done}/16 completed under retries", flush=True)
    rep["busy"] = dict(busy_frames=busy, busy_share=share,
                       shed=stats["shed"], completed=done)
    if busy < 1 or done != 16:
        fail(f"phase 14 BUSY: {busy} BUSY frames, {done}/16 completed")

    # 14f disconnect: a client drops 8 streams mid-flight; their slots
    # readmit a second client's requests, which equal phase 5's
    reg = MetricsRegistry()
    server = ServingServer(batcher(), port=0, registry=reg)
    port = server.start()
    try:
        c1 = StreamingClient("127.0.0.1", port)
        doomed = WorkloadStreams(c1)
        doomed.submit(prompts[:8], [400] * 8)
        deadline = time.time() + 120
        while None in doomed.ttft and time.time() < deadline:
            time.sleep(0.002)
        c1.close()
        with StreamingClient("127.0.0.1", port) as c2:
            run = WorkloadStreams(c2)
            run.submit(prompts[8:16], budgets[8:16])
            run.wait()
            stats = c2.stats()
    finally:
        server.stop(drain=True)
    cancelled = reg.counter("tony_serve_requests_cancelled_total").value
    print(f"[14f] disconnect: 8 streams dropped mid-flight, {cancelled:.0f} "
          f"cancelled by the server; the next client's 8 requests equal "
          f"phase 5's: {run.outputs == serve['outputs'][8:16]}; active "
          f"after {stats['active']}", flush=True)
    rep["disconnect"] = dict(cancelled=cancelled, active=stats["active"])
    if (cancelled != 8 or stats["active"]
            or run.outputs != serve["outputs"][8:16]):
        fail("phase 14: a dropped connection did not cancel its 8 "
             "requests, or the readmitted slots served wrong tokens")

    # 14g per decode step, greedy and sampled (in-process, admission
    # included, as phase 5b; PER_STEP_REQUESTS requests of at most
    # SHORT_BUDGET tokens: the whole script's time limit)
    n_ps = PER_STEP_REQUESTS
    short = [min(b, SHORT_BUDGET) for b in budgets[:n_ps]]
    per = {"greedy": _per_step(batcher(), prompts[:n_ps], short),
           "sampled": _per_step(batcher(**SAMPLING), prompts[:n_ps],
                                short)}
    for mode, r in per.items():
        print(f"[14g] {mode}, per decode step over {r['steps']} (admission "
              f"included): {r['launches']:.1f} device launches, device "
              f"{r['device_ms']:.3f} ms, wall {r['wall_ms']:.3f} ms; top: "
              + "; ".join(f"{n[:40]} {us / 1e3 / r['steps']:.3f} ms"
                          for n, us in r["top"]), flush=True)
    print(f"[14g] tokens/s over the wire: greedy "
          f"{rep['greedy']['tokens_per_s']:.1f}, sampled "
          f"{rep['sampled']['tokens_per_s']:.1f} on {card}", flush=True)
    rep["per_step"] = per
    return k1, k5


# phase 15: the decode variants behind serve_lm ---------------------------

#: requests each variant serves through serve_lm --listen / --connect (4
#: of phase 5's 24: the whole script stays inside its time limit)
WIRE_REQUESTS = 4

#: requests each greedy variant holds against generate, one at a time,
#: and each variant's profiled serve of its per-step numbers serves (4 of
#: phase 5's 24, beside the plain batcher's on the same 4), of at most
#: SHORT_BUDGET tokens each: the whole script's time limit
HOLD_REQUESTS = PER_STEP_REQUESTS = 4
SHORT_BUDGET = 16

#: (label, serve_lm flags) of each variant, built from phase 5's weights
VARIANTS = (
    ("int8 weights", ["--quantize_weights"]),
    ("int8 KV cache", ["--kv_cache_dtype", "int8"]),
    ("rolling cache", ["--attn_window", "256", "--kv_cache_capacity",
                       "384"]),
    ("speculative greedy", ["--draft_preset", "tiny", "--num_speculative",
                            "4"]),
    ("speculative sampled", ["--draft_preset", "tiny", "--num_speculative",
                             "4", "--temperature", "0.8", "--top_k", "50",
                             "--top_p", "0.95"]),
)


def _flag(flags, name, default):
    return flags[flags.index(name) + 1] if name in flags else default


def _variant_parts(flags, cfg, params):
    """(cfg, params, (draft cfg, draft params) or None, sampling, k) of a
    variant, as serve_lm builds them from its flags on top of ``cfg`` and
    ``params`` (phase 5's seed-0 weights)."""
    from tony_tpu_torch import serve_lm
    from tony_tpu_torch.models.quantize import quantize_weights_int8
    cfg = cfg.scaled(
        kv_cache_dtype=_flag(flags, "--kv_cache_dtype", "model"),
        attn_window=int(_flag(flags, "--attn_window", 0)),
        kv_cache_capacity=int(_flag(flags, "--kv_cache_capacity", 0)))
    quant = "--quantize_weights" in flags
    if quant:
        params = quantize_weights_int8(params)
    draft = None
    if "--draft_preset" in flags:
        draft = serve_lm.build_draft(_flag(flags, "--draft_preset", ""),
                                     cfg, "cuda", quant)
    samp = dict(temperature=float(_flag(flags, "--temperature", 0.0)),
                top_k=int(_flag(flags, "--top_k", 0)),
                top_p=float(_flag(flags, "--top_p", 0.0)), seed=0)
    return cfg, params, draft, samp, int(_flag(flags, "--num_speculative", 4))


def _variant_batcher(parts, slots=8, greedy=False):
    """The variant's batcher with serve_lm's defaults (chunk 8, or 4
    rounds a sync with a draft), 1024 positions a slot."""
    from tony_tpu_torch.models import serve as S
    cfg, params, draft, samp, k = parts
    if greedy:
        samp = dict(samp, temperature=0.0)
    if draft is not None:
        return S.SpeculativeContinuousBatcher(
            params, cfg, draft[1], draft[0], batch=slots, max_len=1024,
            num_speculative=k, **samp)
    return S.ContinuousBatcher(params, cfg, batch=slots, max_len=1024,
                               **samp)


def _serve_counting(batcher, prompts, budgets):
    """Serve through a ServeEngine that also records, for every row whose
    request was live when a chunk was issued, the commit count of each
    round of that chunk (speculative batchers). Returns (outputs, wall
    seconds, counts)."""
    import torch
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    counts, last = [], {}
    fetch = batcher._fetch

    def fetch_keeping(handle):
        if hasattr(batcher, "k"):
            last["packed"] = handle.cpu().numpy()
        return fetch(handle)

    class Engine(S.ServeEngine):
        def _consume(self, host_toks, snap):
            if "packed" in last:
                for row, req in enumerate(snap):
                    if req is not None and not req.done:
                        counts.extend(int(c) for c in
                                      last["packed"][:, row, 0])
            return super()._consume(host_toks, snap)

    batcher._fetch = fetch_keeping
    outputs = [[] for _ in prompts]
    eng = Engine(batcher,
                 on_delta=lambda r, t: outputs[r].extend(t),
                 on_retired=lambda r, why, n, final: outputs[r].extend(final),
                 registry=MetricsRegistry())
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        eng.submit(i, p, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.drain()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batcher._fetch = fetch
    return outputs, wall, counts


def _expected_launches(cfg, draft_cfg, k):
    """(K1, K5, admission calls) the serve's device programs in
    CALL_COUNTS should have launched: K1 once a layer of each admission
    forward (both models' on the speculative path) and of each prefix
    template's prefill — a prefix hit's suffix runs the cached attention,
    not K1; K5 2 x layers + 1 a model forward, 2 x draft layers for the
    draft's head-free K/V write of each round."""
    from tony_tpu_torch.models import serve as S
    L, Ld = cfg.n_layers, (draft_cfg.n_layers if draft_cfg else 0)
    k1 = k5 = admits = 0
    for (name, shape), c in S.CALL_COUNTS.items():
        if name in ("admit_rows", "admit_row", "admit_row_ring"):
            k1, k5, admits = k1 + L * c, k5 + (2 * L + 1) * c, admits + c
        elif name == "step_rows":
            k5 += (2 * L + 1) * shape[1] * c
        elif name in ("spec_admit_rows", "spec_admit_row"):
            k1 += (L + Ld) * c
            k5 += (2 * L + 2 * Ld + 2) * c
            admits += c
        elif name == "spec_step_rows":
            k5 += shape[1] * (k * (2 * Ld + 1) + 2 * Ld + 2 * L + 1) * c
        elif name in ("prefix_admit_rows", "prefix_admit_row"):
            k5, admits = k5 + (2 * L + 1) * c, admits + c
        elif name in ("spec_prefix_admit_rows", "spec_prefix_admit_row"):
            k5, admits = k5 + (2 * L + 2 * Ld + 2) * c, admits + c
        elif name == "prefix_template":
            # one template a model per install: the target's, and the
            # draft's with a draft
            n = c // 2 if draft_cfg else c
            k1 += (L + Ld) * n
            k5 += (2 * L + 1 + (2 * Ld + 1 if draft_cfg else 0)) * n
    return k1, k5, admits


def _hold_vs_generate(label, parts, ref_cfg, prompts, budgets, limit):
    """Serve ``prompts`` greedily through an 8-slot batcher of the
    variant and each request alone through ``generate`` of ``ref_cfg``
    (the variant's model; the linear windowed cache for a ring, the
    target for a speculative batcher). A stream that differs must first
    differ where the two tokens' logits on ``generate``'s decode path
    lie within ``limit`` of each other (None: report only). Returns
    (equal streams, [(request, first differing step, logit gap)])."""
    import torch
    from tony_tpu_torch.models import decode as D
    params = parts[1]
    outs = _variant_batcher(parts, greedy=True).serve(prompts, budgets)
    solo = [D.generate(params, torch.tensor([p], device="cuda"), ref_cfg,
                       n).tokens[0, len(p):].tolist()
            for p, n in zip(prompts, budgets)]
    return _near_ties(f"phase 15, {label}", params, ref_cfg, prompts, outs,
                      solo, limit)


def _start_replica(flags, preset):
    """A ``serve_lm --listen`` process (small, 8 slots, 1024 positions a
    slot, the variant's flags) on 127.0.0.1:0."""
    env = dict(os.environ, PYTHONPATH=HERE)
    return subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.serve_lm", "--preset", preset,
         "--slots", "8", "--prompt_len", "960", "--max_new_tokens", "64",
         *flags, "--listen", "127.0.0.1:0"],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _replica_address(srv, flags):
    """(mode word, port) from a replica's serving line, once it serves."""
    import re
    while True:
        line = srv.stdout.readline()
        if not line:
            fail(f"phase 15: serve_lm {' '.join(flags)} --listen exited "
                 f"before serving")
        m = re.search(r"serving \S+ \((.*)\) on 127\.0\.0\.1:(\d+)", line)
        if m:
            return m.group(1), m.group(2)


def _start_client(address, tag, preset, requests):
    """``serve_lm --connect`` with serve_lm's workload of seed 0
    (``requests`` requests, prompts of 64-480 tokens, budgets 16-64)
    against the replica at ``address`` (mode, port), as a process:
    (the process, its outputs file, its start time)."""
    env = dict(os.environ, PYTHONPATH=HERE)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"phase15_{tag}.json")
    cli = subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.serve_lm", "--preset", preset,
         "--requests", str(requests), "--prompt_len", "480",
         "--min_prompt_len", "64", "--max_new_tokens", "64", "--connect",
         f"127.0.0.1:{address[1]}", "--outputs", path],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return cli, path, time.perf_counter()


def _finish_leg(srv, client):
    """Wait for a client of :func:`_start_client`, then stop its replica
    ``srv``: (every request's streamed tokens, the client's wall
    seconds)."""
    import signal
    cli, path, t0 = client
    try:
        out, _ = cli.communicate(timeout=600)
        wall = time.perf_counter() - t0
        if cli.returncode != 0:
            fail(f"phase 15: serve_lm --connect failed: {out[-2000:]}")
    finally:
        srv.send_signal(signal.SIGTERM)
        try:
            srv.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.communicate()
    with open(path) as f:
        return json.load(f), wall


def _variant_kernels(report):
    """[15 kernels] K1 and K5 against their plain versions at phase 15's shapes:
    K1 at the draft's D = 32 ([8, S_b, 4, 32] bf16 causal for each
    admission bucket) and at the rolling cache's window 256 with S not a
    multiple of 64 ([1, S, 8, 64]); K5 over the draft's d = 128 and the
    target's d = 512 at the rows of a decode step (8), a verify chunk
    (8 x 5) and a bucketed admission (8 x 512)."""
    import torch
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    lo, ll = _k1_limits()[torch.bfloat16]
    worst = [0.0, 0.0, ""]
    cases = ([(8, s, 4, 4, 32, None) for s in (64, 128, 256, 512)]
             + [(1, s, 8, 8, 64, 256) for s in (300, 417, 480)])
    for b, s, h, kv, d, window in cases:
        q, k, v = _qkv(b, s, h, kv, d, torch.bfloat16, seed=1500 + s + d)
        o, lse = A.flash_attention_with_lse(q, k, v, causal=True,
                                            window=window)
        ro, rlse = A._dense_with_lse(q.float(), k.float(), v.float(),
                                     causal=True, scale=None, window=window)
        eo = (o.float() - ro).abs().max().item()
        el = (lse - rlse).abs().max().item()
        if eo > worst[0] or el > worst[1]:
            worst = [max(eo, worst[0]), max(el, worst[1]),
                     f"[{b}, {s}, {h}, {d}] window={window}"]
        if not (eo <= lo and el <= ll):
            fail(f"K1 disagrees with its plain version at [{b}, {s}, {h}, "
                 f"{d}] window={window}: |o| {eo:.3e}, |lse| {el:.3e}")
    k5 = 0.0
    for d, rows in ((128, 8), (128, 40), (128, 4096), (512, 8), (512, 40)):
        x, (w,) = _norm_inputs("rms", rows, d, torch.bfloat16, 1600 + rows)
        err = _ulps(N.rms_norm_forward(x, w), N.rms_norm_reference(x, w), 7,
                    atol=1e-5)
        k5 = max(k5, err)
        if not err <= 1.0:
            fail(f"K5 disagrees with its plain version at [{rows}, {d}] "
                 f"bf16: {err:.3e} ulp + 1e-5")
    print(f"[15 kernels] K1 vs plain at the draft's D = 32 ([8, S_b, 4, 32], S_b "
          f"in 64-512) and window 256 at S in (300, 417, 480): max |o| err "
          f"{worst[0]:.3e} (limit {lo:g}), |lse| {worst[1]:.3e} (limit "
          f"{ll:g}), worst at {worst[2]}; K5 at d in (128, 512), rows in "
          f"(8, 40, 4096): worst {k5:.3f} ulp + 1e-5 (limit 1)", flush=True)
    report["k1_worst"] = worst
    report["k5_worst_ulps"] = k5


def phase_variants(report, card, serve):
    """[15] the decode variants behind serve_lm on the card: ``small``
    bf16 at full width with phase 5's 24 requests through 8 slots of 1024
    positions — int8 weights, an int8 KV cache, a rolling cache (window
    256, 384 rows), and a ``tiny`` draft proposing 4 tokens a round,
    greedy and sampled. Each variant in process (its K1 and K5 launches
    counted from 0, tokens/s, per decode step or round the device
    launches, device ms and wall ms) and once through ``serve_lm
    --listen`` and ``--connect`` in two processes (every stream equal to
    the in-process serve; the five client processes run at once, after
    the in-process work, so their walls share the card). Returns (K1, K5)
    launches of the in-process serves."""
    import torch
    from tony_tpu_torch import serve_lm, tree_leaves, tree_map
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.models.quantize import weight_bytes
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    report["variants"] = rep = {}
    _variant_kernels(rep)
    cfg, params = serve["cfg"], serve["params"]
    prompts, budgets = serve["prompts"], serve["budgets"]
    plain_tps = report["serve"]["tokens_per_s"]
    n_ps = PER_STEP_REQUESTS
    short = [min(b, SHORT_BUDGET) for b in budgets]
    plain_step = _per_step(_variant_batcher(_variant_parts((), cfg, params)),
                           prompts[:n_ps], short[:n_ps])
    rep["plain_per_step"] = plain_step
    cfg32 = cfg.scaled(dtype=torch.float32)
    params32 = tree_map(lambda v: v.float(), params)
    hd = cfg.head_dim

    # the layouts' bytes: an int8 cache slot against a bf16 one, the int8
    # tree's matmul weights (scales included) against the bf16 ones
    b8 = slot_bytes(cfg, "int8")
    b16 = slot_bytes(cfg.scaled(dtype=torch.bfloat16), "model")
    cache_ratio = b8 / b16
    qparts = _variant_parts(VARIANTS[0][1], cfg, params)
    mm = lambda t: {"lm_head": t["lm_head"], **{
        n: t["blocks"][n] for n in ("wq", "wk", "wv", "wo", "w_gate",
                                    "w_up", "w_down")}}
    # bf16 bytes: two a weight
    bf16 = lambda t: 2 * sum(a.numel() for a in tree_leaves(t))
    w_ratio = weight_bytes(mm(qparts[1])) / bf16(mm(params))
    tree_ratio = weight_bytes(qparts[1]) / bf16(params)
    print(f"[15 bytes] int8 KV cache: {b8} bytes per slot position against "
          f"bf16's {b16} (ratio "
          f"{cache_ratio:.5f}, (1 + 4/hd)/2 = {(1 + 4 / hd) / 2:.5f}); int8 "
          f"tree: matmul weights {w_ratio:.4f} of bf16's bytes, the whole "
          f"tree {tree_ratio:.4f} (the embedding stays bf16)", flush=True)
    rep["bytes"] = dict(cache_ratio=cache_ratio, matmul_ratio=w_ratio,
                        tree_ratio=tree_ratio)
    if abs(cache_ratio - (1 + 4 / hd) / 2) > 1e-9:
        fail(f"int8 cache bytes ratio {cache_ratio} != (1 + 4/hd)/2")
    # half, plus an f32 scale per output channel: every matmul contracts
    # at least d_model inputs
    if not 0.5 < w_ratio <= (1 + 4 / cfg.d_model) / 2:
        fail(f"int8 matmul weights take {w_ratio:.4f} of bf16's bytes "
             f"(limit (1 + 4/d_model)/2)")
    del qparts

    # the wire legs' replicas boot together, before anything is measured
    # (one boot after another took most of the phase), and wait idle
    replicas = [_start_replica(flags, serve["preset"])
                for _, flags in VARIANTS]
    clients = []
    try:
        addresses = [_replica_address(srv, flags)
                     for srv, (_, flags) in zip(replicas, VARIANTS)]
        wire_want = []
        k1_total = k5_total = 0
        for idx, (label, flags) in enumerate(VARIANTS):
            tag = "abcde"[idx]
            t_v = time.perf_counter()
            walls = {}
            parts = _variant_parts(flags, cfg, params)
            vcfg, _, draft, samp, k = parts
            dcfg = draft[0] if draft else None
            # the main path: 24 requests, counts from 0
            batcher = _variant_batcher(parts)
            torch.cuda.synchronize()
            A.reset_launches()
            N.rms_norm_forward.launches = 0
            S.CALL_COUNTS.clear()
            outs, wall, counts = _serve_counting(batcher, prompts, budgets)
            k1, k5 = A.flash_forward.launches, N.rms_norm_forward.launches
            want_k1, want_k5, admits = _expected_launches(vcfg, dcfg, k)
            _check_tc_variants(f"phase 15 {label}")
            if admits == 0 or k1 != want_k1 or k5 != want_k5:
                fail(f"phase 15 {label}: K1 {k1} (expected {want_k1}), K5 "
                     f"{k5} "
                     f"(expected {want_k5}) over {admits} admissions")
            if [len(o) for o in outs] != budgets or not all(
                    0 <= t < cfg.vocab_size for o in outs for t in o):
                fail(f"phase 15 {label}: a request did not get its budget of "
                     f"in-vocabulary tokens")
            k1_total += k1
            k5_total += k5
            tokens = sum(budgets)
            steps = batcher.rounds_executed or batcher.steps_executed
            r = dict(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
                     k1_launches=k1, k5_launches=k5, admissions=admits,
                     steps=steps)
            spec = ""
            if draft is not None:
                per_round = sum(counts) / max(1, len(counts))
                r.update(tokens_per_round=per_round,
                         acceptance=(per_round - 1) / k,
                         live_rounds=len(counts))
                spec = (f"; {per_round:.3f} tokens per live row-round, "
                        f"acceptance rate {(per_round - 1) / k:.4f} of k={k} "
                        f"(a random tiny draft of another seed: it accepts "
                        f"little)")
            walls["serve"] = time.perf_counter() - t_v
            per = _per_step(_variant_batcher(parts), prompts[:n_ps],
                            short[:n_ps])
            r["per_step"] = per
            walls["per_step"] = time.perf_counter() - t_v - sum(
                walls.values())
            unit = "round" if draft is not None else "decode step"
            print(f"[15{tag}] {label}: {len(prompts)} requests, {tokens} "
                  f"tokens in {wall:.3f}s ({tokens / wall:.1f} tokens/s; "
                  f"phase 5 plain {plain_tps:.1f}); per {unit} over "
                  f"{per['steps']} ({n_ps} requests of at most "
                  f"{SHORT_BUDGET} tokens, admission included): "
                  f"{per['launches']:.1f} device launches, device "
                  f"{per['device_ms']:.3f} ms, wall {per['wall_ms']:.3f} ms "
                  f"(plain per step on the same {n_ps}: "
                  f"{plain_step['launches']:.1f}, "
                  f"{plain_step['device_ms']:.3f} ms, "
                  f"{plain_step['wall_ms']:.3f} ms); K1 {k1} over {admits} "
                  f"admissions, K5 {k5}" + spec, flush=True)

            # the stream holds: f32 token for token (a first difference only
            # at a near-tie), bf16 reported
            if samp["temperature"] == 0.0:
                ref = vcfg.scaled(kv_cache_capacity=0)
                ref32 = ref.scaled(dtype=torch.float32)
                parts32 = _variant_parts(flags, cfg32, params32)
                limit = 1e-2 if vcfg.kv_quant else 1e-4
                n = HOLD_REQUESTS
                e32, d32 = _hold_vs_generate(f"{label} f32", parts32, ref32,
                                             prompts[:n], short[:n], limit)
                e16, d16 = _hold_vs_generate(f"{label} bf16", parts, ref,
                                             prompts[:n], short[:n], None)
                r.update(f32_equal=e32, f32_diffs=d32, bf16_equal=e16,
                         bf16_diffs=d16)
                extra = ""
                if draft is not None:
                    same = sum(a == b for a, b in zip(outs, serve["outputs"]))
                    r["bf16_equal_phase5"] = same
                    extra = (f"; all 24 bf16 streams vs phase 5's greedy "
                             f"serve: "
                             f"{same}/24 equal")
                what = ("the linear windowed cache" if vcfg.kv_cache_capacity
                        else "the target" if draft else "the same model")
                print(f"[15{tag}]   vs generate per request ({what}): f32 "
                      f"{e32}/{n} equal, first "
                      f"differences (request, step, logit gap; limit "
                      f"{limit:g}) "
                      f"{d32}; bf16 {e16}/{n} equal, first differences {d16}"
                      + extra, flush=True)
                del parts32
            walls["generate"] = time.perf_counter() - t_v - sum(
                walls.values())

            # once through serve_lm --listen / --connect (below), at the
            # depth of WIRE_REQUESTS (the whole script's time limit),
            # against the in-process serve of the same requests
            p_w, b_w = serve_lm.make_workload(
                0, WIRE_REQUESTS, 480, 64, cfg.vocab_size, min_prompt_len=64)
            wire_want.append((b_w, _variant_batcher(parts).serve(p_w, b_w)))
            walls["wire_want"] = time.perf_counter() - t_v - sum(
                walls.values())
            r["walls"] = walls
            print(f"[15{tag}]   walls: " + ", ".join(
                f"{k} {v:.1f}s" for k, v in walls.items()), flush=True)
            rep[label] = r
            del batcher, parts
            torch.cuda.empty_cache()
        # the five clients at once, each against its own replica
        clients = [_start_client(addr, "abcde"[i], serve["preset"],
                                 WIRE_REQUESTS)
                   for i, addr in enumerate(addresses)]
        for idx, (label, flags) in enumerate(VARIANTS):
            wire, wwall = _finish_leg(replicas[idx], clients[idx])
            b_w, want_w = wire_want[idx]
            mode = addresses[idx][0]
            same = sum(a == b for a, b in zip(wire, want_w))
            rep[label].update(wire_equal=same, wire_mode=mode,
                              wire_wall_s=wwall)
            print(f"[15{'abcde'[idx]}]   serve_lm {' '.join(flags)} "
                  f"--listen / --connect (mode '{mode}'): {same}/"
                  f"{len(want_w)} streams equal the in-process serve; client "
                  f"wall {wwall:.2f}s ({sum(b_w) / wwall:.1f} tokens/s, the "
                  f"five clients at once)", flush=True)
            if same != len(want_w):
                fail(f"phase 15 {label}: streams over the wire differ from "
                     f"the in-process serve")
    finally:
        for proc in replicas + [c[0] for c in clients]:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    del params32
    return k1_total, k5_total


PREFIX_LEN = 509


def _prefix_workload(vocab):
    """Phase 16's traffic: a 509-token system prompt from seed 16, and 24
    requests whose own suffixes are 16-256 tokens with budgets of 16-64
    (serve_lm's workload of seed 0, which its --connect client draws)."""
    import numpy as np
    from tony_tpu_torch import serve_lm
    prefix = [int(t) for t in
              np.random.RandomState(16).randint(0, vocab, PREFIX_LEN)]
    suffixes, budgets = serve_lm.make_workload(0, 24, 256, 64, vocab,
                                               min_prompt_len=16)
    return prefix, [[int(t) for t in s] for s in suffixes], budgets


def _near_ties(label, params, cfg, prompts, got, want, limit):
    """(equal streams, [(request, first differing step, logit gap)]) of
    ``got`` against ``want``: where a stream differs, the gap of the two
    tokens' logits on ``want``'s decode path at that step; past ``limit``
    fails (None: report only)."""
    equal, diffs = 0, []
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        if g == w:
            equal += 1
            continue
        j = next(t for t, (a, b) in enumerate(zip(g, w)) if a != b)
        lg = _decode_logits(params, cfg, p, w[:j + 1])[j]
        gap = (lg[w[j]] - lg[g[j]]).abs().item()
        diffs.append((i, j, round(gap, 7)))
        if limit is not None and not gap <= limit:
            fail(f"{label}: request {i} first differs at token {j} where "
                 f"the logits are {gap:.3e} apart (limit {limit:g})")
    return equal, diffs


def _prefix_kernels(report):
    """[16a] K1 against its plain version at the template prefill's [1,
    P, 8, 64] bf16 causal, P in {1, 509}, at phase 3's limits; K5 at the
    suffix extensions' rows (8 x S_b, S_b 16-256) and d 512."""
    import torch
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    lo, ll = _k1_limits()[torch.bfloat16]
    worst = [0.0, 0.0]
    for s in (1, PREFIX_LEN):
        q, k, v = _qkv(1, s, 8, 8, 64, torch.bfloat16, seed=1650 + s)
        o, lse = A.flash_attention_with_lse(q, k, v, causal=True)
        ro, rlse = A._dense_with_lse(q.float(), k.float(), v.float(),
                                     causal=True, scale=None)
        eo = (o.float() - ro).abs().max().item()
        el = (lse - rlse).abs().max().item()
        worst = [max(eo, worst[0]), max(el, worst[1])]
        if not (eo <= lo and el <= ll):
            fail(f"K1 disagrees with its plain version at [1, {s}, 8, 64]: "
                 f"|o| {eo:.3e}, |lse| {el:.3e}")
    k5 = 0.0
    for rows in (8 * 16, 8 * 64, 8 * 256):
        x, (w,) = _norm_inputs("rms", rows, 512, torch.bfloat16, 1660 + rows)
        err = _ulps(N.rms_norm_forward(x, w), N.rms_norm_reference(x, w), 7,
                    atol=1e-5)
        k5 = max(k5, err)
        if not err <= 1.0:
            fail(f"K5 disagrees with its plain version at [{rows}, 512] "
                 f"bf16: {err:.3e} ulp + 1e-5")
    print(f"[16a] K1 vs plain at [1, P, 8, 64] bf16 causal, P in (1, "
          f"{PREFIX_LEN}): max |o| err {worst[0]:.3e} (limit {lo:g}), |lse| "
          f"{worst[1]:.3e} (limit {ll:g}); K5 at [8 x S_b, 512], S_b in (16,"
          f" 64, 256): worst {k5:.3f} ulp + 1e-5 (limit 1)", flush=True)
    report["kernels"] = dict(k1_worst=worst, k5_worst_ulps=k5)


class _AdmitLog:
    """Mixin: record every ``_admit_rows`` call (the admission programs'
    arguments) so they can be replayed under the profiler."""

    def _admit_rows(self, *args, **kw):
        self.admit_log.append((args, kw))
        return super()._admit_rows(*args, **kw)


def _admission_cost(batcher, n_requests):
    """(wall ms, device ms, top kernels by device time) per admitted
    request of the admission programs a serve ran: its logged
    ``_admit_rows`` calls replayed into the same batcher, synchronised
    one by one (wall) and under torch.profiler (device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    log = list(batcher.admit_log)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args, kw in log:
        batcher._admit_rows(*args, **kw)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for args, kw in log:
            batcher._admit_rows(*args, **kw)
        torch.cuda.synchronize()
    dev, _ = _device_times(prof)
    device = sum(dev.values()) / 1e3
    top = [(n[:40], round(us / 1e3 / n_requests, 4)) for n, us in
           sorted(dev.items(), key=lambda kv: -kv[1])[:4]]
    return wall / n_requests, (device / n_requests if device else None), top


def _serve_lm_proc(preset, flags, tag):
    """Start ``serve_lm --listen 127.0.0.1:0`` (``preset``, 8 slots) with
    ``flags``; returns (process, port, the lines it printed up to the
    serving line)."""
    import re
    env = dict(os.environ, PYTHONPATH=HERE)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.serve_lm", "--preset",
         preset, "--slots", "8", "--max_new_tokens", "64", *flags,
         "--listen", "127.0.0.1:0"], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    while True:
        line = proc.stdout.readline()
        if not line:
            fail(f"phase 16: serve_lm {tag} exited before serving: "
                 + "".join(lines)[-2000:])
        lines.append(line)
        m = re.search(r"serving \S+ \((.*)\) on 127\.0\.0\.1:(\d+)", line)
        if m:
            return proc, int(m.group(2)), lines


def _stop_procs(procs):
    import signal
    for proc in procs:
        proc.send_signal(signal.SIGTERM)
    for proc in procs:
        try:
            proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


def _connect_all(preset, ports, pfile):
    """``serve_lm --connect`` with phase 16's workload (every prompt the
    prefix in ``pfile`` + its suffix) against each replica of ``ports``
    (``{tag: port}``), the clients at once; returns every stream by
    tag."""
    paths = {tag: os.path.join(HERE, "chiprun_out", f"phase16_{tag}.json")
             for tag in ports}
    clis = {tag: subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.serve_lm", "--preset",
         preset, "--requests", "24", "--prompt_len", "256",
         "--min_prompt_len", "16", "--max_new_tokens", "64", "--connect",
         f"127.0.0.1:{port}", "--shared_prefix_file", pfile, "--outputs",
         paths[tag]], cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tag, port in ports.items()}
    try:
        for tag, cli in clis.items():
            out, _ = cli.communicate(timeout=600)
            if cli.returncode != 0:
                fail(f"phase 16: serve_lm --connect {tag} failed: "
                     f"{out[-2000:]}")
    finally:
        for cli in clis.values():
            if cli.poll() is None:
                cli.kill()
                cli.communicate()
    outs = {}
    for tag, path in paths.items():
        with open(path) as f:
            outs[tag] = json.load(f)
    return outs


def _template_ship_and_warm_boot(rep, preset, prefix, suffixes, budgets):
    """[16e/16f] serve_lm as three processes: a cold replica B, a warm A
    that makes the prefix resident and publishes its template to B, and
    C booted from A's weights lane (with the prefix computed locally);
    each serves the workload over --connect."""
    import re
    from tony_tpu_torch.serving.client import StreamingClient
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    pfile = os.path.join(out_dir, "phase16_prefix.txt")
    with open(pfile, "w") as f:
        f.write(" ".join(map(str, prefix)))
    # every replica holds 509 + 256 + 64 = 829 positions a slot
    procs = []
    try:
        b, bport, _ = _serve_lm_proc(preset, ["--prompt_len", "765"],
                                     "B (cold)")
        procs.append(b)
        a, aport, alines = _serve_lm_proc(
            preset, ["--prompt_len", "256", "--shared_prefix_file", pfile,
             "--publish_prefix", f"127.0.0.1:{bport}"], "A (warm)")
        procs.append(a)
        m = re.search(r"published prefix \S+ to \S+ \((\d+) bytes in "
                      r"([0-9.]+)s", "".join(alines))
        if not m:
            fail("phase 16e: A did not publish its template: "
                 + "".join(alines)[-2000:])
        t_bytes, t_wall = int(m.group(1)), float(m.group(2))
        print(f"[16e] serve_lm A --shared_prefix_file --publish_prefix B: "
              f"template {t_bytes} bytes published in {t_wall:.3f}s",
              flush=True)
        c, cport, clines = _serve_lm_proc(
            preset, ["--prompt_len", "256", "--shared_prefix_file", pfile,
             "--warm_from", f"127.0.0.1:{aport}"], "C (warm boot)")
        procs.append(c)
        m = re.search(r"warm boot: pulled weights \S+ from \S+ \((\d+) "
                      r"bytes in ([0-9.]+)s", "".join(clines))
        if not m:
            fail("phase 16f: C's warm boot did not pull: "
                 + "".join(clines)[-2000:])
        w_bytes, w_wall = int(m.group(1)), float(m.group(2))
        outs = _connect_all(preset, {"A": aport, "B": bport, "C": cport},
                            pfile)
        stats = {}
        for tag, port in (("A", aport), ("B", bport), ("C", cport)):
            with StreamingClient("127.0.0.1", port) as cl:
                stats[tag] = cl.stats()
    finally:
        _stop_procs(procs)
    suffix_tokens = sum(len(s) for s in suffixes)
    sb = stats["B"]
    if [len(o or []) for o in outs["A"]] != budgets:
        fail("phase 16e: a request to A did not get its budget")
    if sb["prefix_admits"] != 24 or sb["prefill_tokens"] != suffix_tokens:
        fail(f"phase 16e: B ran prefix forwards: prefix_admits "
             f"{sb['prefix_admits']}, prefill_tokens {sb['prefill_tokens']} "
             f"(suffix tokens {suffix_tokens})")
    same_b = sum(x == y for x, y in zip(outs["B"], outs["A"]))
    if same_b != 24:
        fail(f"phase 16e: {24 - same_b} of B's streams differ from A's")
    print(f"[16e] B (cold) "
          f"served 24 requests with prefix_admits {sb['prefix_admits']}, "
          f"prefill_tokens {sb['prefill_tokens']} = the suffixes' "
          f"{suffix_tokens} (zero prefix forwards); 24/24 streams equal A's",
          flush=True)
    sa, sc = stats["A"], stats["C"]
    same_c = sum(x == y for x, y in zip(outs["C"], outs["A"]))
    if sc["weights_digest"] != sa["weights_digest"] or same_c != 24:
        fail(f"phase 16f: C's digest {sc['weights_digest']} (A's "
             f"{sa['weights_digest']}), {same_c}/24 streams equal A's")
    print(f"[16f] serve_lm C --warm_from A: pulled {w_bytes} bytes in "
          f"{w_wall:.3f}s; C advertises A's weights_digest "
          f"{sc['weights_digest'][:12]}...; 24/24 streams equal A's",
          flush=True)
    rep.update(template_bytes=t_bytes, publish_wall_s=t_wall,
               pull_bytes=w_bytes, pull_wall_s=w_wall,
               b_prefill_tokens=sb["prefill_tokens"],
               b_prefix_admits=sb["prefix_admits"])


def phase_prefix(report, card, serve):
    """[16] shared-prefix serving on the card: phase 5's ``small`` bf16,
    a 509-token system prompt and 24 requests (suffixes 16-256, budgets
    16-64) through 8 slots of 1024 positions, chunk 8, pipelined.
    Returns (K1, K5) launches of the runs with the prefix resident."""
    import threading

    import torch
    from tony_tpu_torch import serve_lm, tree_map
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    from tony_tpu_torch.serving.client import StreamingClient
    from tony_tpu_torch.serving.prefix import fingerprint
    from tony_tpu_torch.serving.server import ServingServer
    t_phase = time.perf_counter()
    report["prefix"] = rep = {}
    _prefix_kernels(rep)
    cfg, params = serve["cfg"], serve["params"]
    L = cfg.n_layers
    prefix, suffixes, budgets = _prefix_workload(cfg.vocab_size)
    prompts = [prefix + s for s in suffixes]
    pid = fingerprint(prefix)
    suffix_tokens = sum(len(s) for s in suffixes)

    class Logged(_AdmitLog, S.ContinuousBatcher):
        pass

    def batcher(p=params, c=cfg, **kw):
        b = Logged(p, c, batch=8, max_len=1024, chunk=8, **kw)
        b.admit_log = []
        return b

    def counted(fn):
        """(result, K1, K5, CALL_COUNTS) of ``fn`` with the counts from 0."""
        torch.cuda.synchronize()
        A.reset_launches()
        N.rms_norm_forward.launches = 0
        S.CALL_COUNTS.clear()
        out = fn()
        torch.cuda.synchronize()
        _check_tc_variants("phase 16")
        return (out, A.flash_forward.launches, N.rms_norm_forward.launches,
                dict(S.CALL_COUNTS))

    def timed_serve(b):
        t0 = time.perf_counter()
        out = b.serve(prompts, budgets)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # 16b prefix-blind, then the prefix resident: the slice's main path
    blind_b = batcher()
    (blind, blind_wall), bk1, _, bcalls = counted(lambda: timed_serve(blind_b))
    hit_b = batcher()

    def resident_serve():
        if not hit_b.install_prefix(pid, prefix):
            fail("phase 16: install_prefix refused the prefix")
        before = hit_b.prefill_forward_tokens
        out = timed_serve(hit_b)
        return out, hit_b.prefill_forward_tokens - before

    ((hits, hit_wall), fwd), k1, k5, calls = counted(resident_serve)
    want_k1, want_k5, admits = _expected_launches(cfg, None, 0)
    if k1 != L or want_k1 != L or k5 != want_k5 or fwd != suffix_tokens:
        fail(f"phase 16b: K1 {k1} (expected {L}, the template alone), K5 "
             f"{k5} (expected {want_k5}); prefill tokens {fwd} over the "
             f"serve (expected the suffixes' {suffix_tokens})")
    if hit_b.prefix_admits != 24 or [len(o) for o in hits] != budgets or \
            not all(0 <= t < cfg.vocab_size for o in hits for t in o):
        fail("phase 16b: a request missed the prefix or its budget")
    tokens = sum(budgets)
    bw, bd, btop = _admission_cost(blind_b, 24)
    hw, hd, htop = _admission_cost(hit_b, 24)
    blind_admits = sum(c for (n, _), c in bcalls.items()
                       if n == "admit_rows")
    same16 = sum(a == b for a, b in zip(hits, blind))
    bph = blind_b.phase_times.summary().get("admit", {})
    hph = hit_b.phase_times.summary().get("admit", {})
    print(f"[16b] small bf16, {PREFIX_LEN}-token prefix + suffixes of "
          f"16-256 ({suffix_tokens} tokens), 24 requests, {tokens} tokens: "
          f"prefix-blind {tokens / blind_wall:.1f} tokens/s (K1 {bk1} over "
          f"{blind_admits} admit_rows calls); prefix resident "
          f"{tokens / hit_wall:.1f} tokens/s, K1 {k1} (the template), K5 "
          f"{k5}, prefill tokens {fwd} = the suffixes, {admits} "
          f"prefix_admit_rows calls", flush=True)
    print(f"[16b]   admission per admitted request: prefix-blind wall "
          f"{bw:.3f} ms, device {_ms(bd)} (in the serve's admit phase "
          f"{bph.get('total_s', 0) * 1e3 / 24:.3f} ms); prefix-hit wall "
          f"{hw:.3f} ms, device {_ms(hd)} (in the serve "
          f"{hph.get('total_s', 0) * 1e3 / 24:.3f} ms); bf16 streams "
          f"prefix-hit vs prefix-blind: {same16}/24 equal", flush=True)
    print(f"[16b]   admission device ms a request by kernel: prefix-blind "
          f"{btop}; prefix-hit {htop}", flush=True)
    rep["inprocess"] = dict(
        tokens=tokens, blind_wall_s=blind_wall, hit_wall_s=hit_wall,
        blind_tokens_per_s=tokens / blind_wall,
        hit_tokens_per_s=tokens / hit_wall, k1=k1, k5=k5,
        prefill_tokens=fwd, admit_calls=admits, blind_admit_calls=blind_admits,
        blind_admit_wall_ms=bw, blind_admit_device_ms=bd,
        hit_admit_wall_ms=hw, hit_admit_device_ms=hd,
        blind_admit_top=btop, hit_admit_top=htop,
        blind_admit_phase_ms=bph.get("total_s", 0) * 1e3 / 24,
        hit_admit_phase_ms=hph.get("total_s", 0) * 1e3 / 24,
        bf16_equal=same16)
    k1_total, k5_total = k1, k5

    # f32 on 8 requests: prefix-hit against prefix-blind, near-tie rule
    cfg32 = cfg.scaled(dtype=torch.float32)
    params32 = tree_map(lambda v: v.float(), params)
    b32 = batcher(params32, cfg32)
    b32.install_prefix(pid, prefix)
    hit32 = b32.serve(prompts[:8], budgets[:8])
    blind32 = batcher(params32, cfg32).serve(prompts[:8], budgets[:8])
    e32, d32 = _near_ties("phase 16b f32", params32, cfg32, prompts[:8],
                          hit32, blind32, 1e-4)
    print(f"[16b]   f32, 8 requests: prefix-hit vs prefix-blind {e32}/8 "
          f"equal, first differences (request, step, logit gap; limit "
          f"1e-4) {d32}", flush=True)
    rep["inprocess"].update(f32_equal=e32, f32_diffs=d32)
    del b32

    # 16c sampled behind the ServingServer, the prefix resident; half the
    # ADMITs name the prefix, half are matched by their tokens; the
    # engine admits nothing until all 24 are queued, so the class order
    # seats every interactive request first (no preemption)
    gate = threading.Event()

    want = batcher(**SAMPLING)
    want.install_prefix(pid, prefix)
    want = want.serve(prompts, budgets)
    classes = [S.QOS_CLASSES[i % 3] for i in range(24)]

    def over_wire():
        srv = ServingServer(S.ContinuousBatcher(params, cfg, batch=8,
                                                max_len=1024, chunk=8,
                                                **SAMPLING),
                            registry=MetricsRegistry())
        admit = srv.engine._admit_free

        def gated_admit():
            gate.wait(timeout=120)
            return admit()

        srv.engine._admit_free = gated_admit
        port = srv.start()
        try:
            got = srv.install_prefix(prefix)
            if got != pid:
                fail(f"phase 16c: the server installed {got}, not {pid}")
            with StreamingClient("127.0.0.1", port) as c:
                t0 = time.perf_counter()
                rids = [c.submit(p, n, request_class=cls,
                                 prefix_id=pid if i % 2 == 0 else None)
                        for i, (p, n, cls) in
                        enumerate(zip(prompts, budgets, classes))]
                deadline = time.time() + 60
                while srv.engine.stats()["queue_depth"] < 24:
                    if time.time() > deadline:
                        fail("phase 16c: the ADMITs did not all arrive")
                    time.sleep(0.005)
                gate.set()
                outs = [c.result(r, timeout=300)[0] for r in rids]
                wall = time.perf_counter() - t0
                stats = c.stats()
        finally:
            gate.set()
            srv.stop(drain=True)
        return outs, wall, stats

    (outs, wall, stats), ck1, ck5, _ = counted(over_wire)
    want_k1, want_k5, _ = _expected_launches(cfg, None, 0)
    if outs != want:
        bad = [i for i in range(24) if outs[i] != want[i]]
        fail(f"phase 16c: sampled streams over the wire differ from the "
             f"in-process prefix-hit serve in requests {bad}")
    if (stats["prefix_admits"] != 24 or stats["preemptions"] != 0
            or ck1 != want_k1 or ck5 != want_k5):
        fail(f"phase 16c: prefix_admits {stats['prefix_admits']}, "
             f"preemptions {stats['preemptions']}, K1 {ck1} (expected "
             f"{want_k1}), K5 {ck5} (expected {want_k5})")
    print(f"[16c] sampled (T 0.8, top-k 50, top-p 0.95), classes in "
          f"rotation, behind the ServingServer: 24/24 streams equal the "
          f"in-process prefix-hit serve (12 ADMITs naming the prefix, 12 "
          f"matched); prefix_admits 24, prefill_tokens "
          f"{stats['prefill_tokens']}; {tokens / wall:.1f} tokens/s; K1 "
          f"{ck1}, K5 {ck5}", flush=True)
    rep["sampled"] = dict(wall_s=wall, tokens_per_s=tokens / wall,
                          k1=ck1, k5=ck5,
                          prefill_tokens=stats["prefill_tokens"])
    k1_total += ck1
    k5_total += ck5

    # 16d speculative: the tiny draft, k = 4, greedy
    dcfg, dparams = serve_lm.build_draft("tiny", cfg, "cuda")

    def spec(p, c, dp, dc, n):
        b = S.SpeculativeContinuousBatcher(p, c, dp, dc, batch=8,
                                           max_len=1024, num_speculative=4)
        b.install_prefix(pid, prefix)
        return b.serve(prompts[:n], budgets[:n]), b

    (sp, sb), sk1, sk5, scalls = counted(
        lambda: spec(params, cfg, dparams, dcfg, 24))
    want_k1, want_k5, sadmits = _expected_launches(cfg, dcfg, 4)
    spec_calls = sum(c for (n, _), c in scalls.items()
                     if n == "spec_prefix_admit_rows")
    if (sk1 != want_k1 or sk5 != want_k5 or spec_calls == 0
            or sb.prefix_admits != 24 or [len(o) for o in sp] != budgets):
        fail(f"phase 16d: K1 {sk1} (expected {want_k1}), K5 {sk5} "
             f"(expected {want_k5}), {spec_calls} spec_prefix_admit_rows "
             f"calls, prefix_admits {sb.prefix_admits}")
    same_sp = sum(a == b for a, b in zip(sp, hits))
    dcfg32 = dcfg.scaled(dtype=torch.float32)
    dparams32 = tree_map(lambda v: v.float(), dparams)
    sp32, _ = spec(params32, cfg32, dparams32, dcfg32, 8)
    e, d = _near_ties("phase 16d f32", params32, cfg32, prompts[:8], sp32,
                      hit32, 1e-4)
    print(f"[16d] speculative (tiny draft, k 4, greedy), prefix resident: "
          f"{spec_calls} spec_prefix_admit_rows calls, K1 {sk1} (both "
          f"templates), K5 {sk5}; bf16 24 streams vs the prefix-hit serve: "
          f"{same_sp}/24 equal; f32 8 requests: {e}/8 equal, first "
          f"differences {d} (limit 1e-4)", flush=True)
    rep["speculative"] = dict(k1=sk1, k5=sk5, calls=spec_calls,
                              bf16_equal=same_sp, f32_equal=e, f32_diffs=d)
    k1_total += sk1
    k5_total += sk5
    del params32, dparams32, sb, want, blind_b, hit_b
    torch.cuda.empty_cache()

    # 16e/16f: the template ship and the warm boot, as processes
    _template_ship_and_warm_boot(rep, serve["preset"], prefix, suffixes,
                                 budgets)
    rep["wall_s"] = time.perf_counter() - t_phase
    print(f"[16] phase wall {rep['wall_s']:.1f}s", flush=True)
    return k1_total, k5_total


# phase 17: disaggregated prefill/decode and the router ------------------

class _ThreadTally:
    """An int-like launch count that also tallies each increment by the
    thread that made it. The kernel wrappers count with ``wrapper.launches
    += 1``; with this object in place of the int, that statement lands in
    :meth:`__iadd__` under a lock, so the wrapper's own count stays exact
    while two tiers launch from their own threads, and each tier's share
    is read off by its thread's name."""

    def __init__(self) -> None:
        import collections
        import threading
        self.total = 0
        self.by = collections.Counter()
        self._lock = threading.Lock()

    def __iadd__(self, n):
        import threading
        with self._lock:
            self.total += n
            self.by[threading.current_thread().name] += n
        return self

    def __int__(self) -> int:
        return self.total

    __index__ = __int__

    def __eq__(self, other) -> bool:
        return self.total == other

    __hash__ = None


def _tallies():
    """Zero K1's and K5's counts as per-thread tallies; returns them."""
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    A.reset_launches()
    A.flash_forward.launches = _ThreadTally()
    N.rms_norm_forward.launches = _ThreadTally()
    return A.flash_forward.launches, N.rms_norm_forward.launches


def _untally():
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    A.reset_launches()
    N.rms_norm_forward.launches = 0


def _ship_chain(params, cfg, prompts, pairs, ring, seed):
    """The disaggregated chain for K prompts landing in slots ``pairs``:
    prefill_ship_rows (one K-row wave; a ring: prefill_ship_row each),
    extract_kv_rows, kvship.pack_shipment and unpack_shipment,
    _validate_package, then land_kv_rows into a fresh batcher. Returns
    (the landed batcher, bytes of each shipment, header bytes of each)."""
    import numpy as np
    import torch
    from tony_tpu_torch.models import decode as D
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.ops import prng
    from tony_tpu_torch.serving import kvship
    landed = S.ContinuousBatcher(params, cfg, batch=8, max_len=1024,
                                 chunk=8, **SAMPLING)
    lens = [len(p) for p in prompts]
    if ring:
        rows, lgs = [], []
        for p in prompts:
            lg, mini = S.prefill_ship_row(
                params, D.to_device(np.asarray([p], np.int64), "cuda"), cfg)
            rows += D.extract_kv_rows(mini, [mini["k"].shape[2]])
            lgs.append(lg[0].cpu())
    else:
        s_b = S.bucket_for(max(lens), 1024)
        toks = np.zeros((8, s_b), np.int64)
        tl = np.ones((8,), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
            tl[i] = len(p)
        lg, mini = S.prefill_ship_rows(params, D.to_device(toks, "cuda"),
                                       D.to_device(tl, "cuda"), cfg)
        rows = D.extract_kv_rows(mini, lens)
        lgs = list(lg.cpu())
    base = prng.PRNGKey(seed)
    pkgs, sizes, heads = {}, [], []
    for i, (bufs, lg) in enumerate(zip(rows, lgs)):
        key = prng.fold_in(base, i).numpy().astype(np.uint32)
        blob = kvship.pack_shipment(
            kvship.pack_kv_meta(i + 1, 16, lens[i], key),
            dict(bufs, logits=lg))
        sizes.append(len(blob))
        heads.append(4 + int.from_bytes(blob[:4], "little"))
        meta, got = kvship.unpack_shipment(blob)
        meta = kvship.parse_kv_meta(meta)
        pkg = S.KVPackage(got, meta["length"], got.pop("logits"),
                          meta["rng"], meta["rng_off"])
        landed._validate_package(pkg, 16)
        pkgs[i] = pkg
    landed._land_group(pairs, pkgs)
    torch.cuda.synchronize()
    return landed, sizes, heads


def _same_bytes(a, b) -> bool:
    import torch
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _landing_exactness(rep, params, cfg):
    """[17a] per bucket S_b in {64, 128, 256, 512}: the same 8 prompts
    admitted colocated (admit_rows into slots r) and through the shipping
    chain into slots r of a fresh cache — the slots' cache bytes over [0,
    length), frontiers, logits and rng keys bitwise equal; in bf16, an
    int8 cache, and a 384-row ring with window 256 (per-row admission at
    the exact length, the whole ring compared, 2 prompts a bucket)."""
    import numpy as np
    import torch
    from tony_tpu_torch.models import decode as D
    from tony_tpu_torch.models import serve as S
    L, kv, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    logit_bytes = cfg.vocab_size * torch.tensor(
        [], dtype=cfg.logits_storage_dtype).element_size()
    layouts = (("bf16", cfg, False),
               ("int8", cfg.scaled(kv_cache_dtype="int8"), False),
               ("ring", cfg.scaled(attn_window=256, kv_cache_capacity=384),
                True))
    out = {}
    for label, c, ring in layouts:
        proto = D.init_kv_cache(c, 1, 1, device="cpu")
        per_tok = sum(t.numel() * t.element_size() for t in D._kv_bufs(
            proto).values()) // proto["k"].shape[2]
        checked, sizes, heads, reck = 0, [], [], []
        for s_b in (64, 128, 256, 512):
            rs = np.random.RandomState(1700 + s_b)
            k = 2 if ring else 8
            lens = rs.randint(s_b // 2 + 1, s_b + 1, size=k)
            prompts = [[int(t) for t in rs.randint(0, cfg.vocab_size, n)]
                       for n in lens]
            pairs = [((3 * i + 1) % 8, i) for i in range(k)]
            colo = S.ContinuousBatcher(params, c, batch=8, max_len=1024,
                                       chunk=8, **SAMPLING)
            colo._admit_prompts(pairs, dict(enumerate(prompts)))
            landed, sz, hb = _ship_chain(params, c, prompts, pairs, ring,
                                         SAMPLING["seed"])
            for r, i in pairs:
                n = c.kv_cache_capacity if ring else len(prompts[i])
                for name, buf in D._kv_bufs(colo.cache).items():
                    if not _same_bytes(landed.cache[name][:, r, :n],
                                       buf[:, r, :n]):
                        fail(f"phase 17a {label}: slot {r} buffer {name} "
                             f"differs from colocated admission (S_b "
                             f"{s_b}, length {len(prompts[i])})")
                if (int(landed.cache["length"][r])
                        != int(colo.cache["length"][r])
                        or not _same_bytes(landed.logits[r], colo.logits[r])
                        or not torch.equal(landed._row_keys[r],
                                           colo._row_keys[r])
                        or landed._host_len[r] != colo._host_len[r]):
                    fail(f"phase 17a {label}: slot {r}'s frontier, logits "
                         f"or rng key differ from colocated admission")
                checked += 1
                w = c.kv_cache_capacity if ring else len(prompts[i])
                reck.append(per_tok * w + logit_bytes)
            sizes += sz
            heads += hb
        out[label] = dict(rows=checked, bytes_per_token=per_tok,
                          mean_bytes=float(np.mean(sizes)),
                          mean_reckoned=float(np.mean(reck)),
                          header_bytes=[min(heads), max(heads)],
                          over=max(s - r for s, r in zip(sizes, reck)))
        print(f"[17a] {label}: {checked} shipped rows bitwise equal to "
              f"colocated admission over [0, length) with their frontiers, "
              f"logits and rng keys (S_b 64-512); {per_tok} B per position "
              f"({L} layers x k, v x {kv} kv heads x {hd}"
              + (" + f32 scales" if label == "int8" else "")
              + f") + {logit_bytes} B of logits + a header of "
              f"{min(heads)}-{max(heads)} B: mean {np.mean(sizes):.0f} B a "
              f"row against {np.mean(reck):.0f} B reckoned before the "
              f"header", flush=True)
    rep["landing"] = out


def _stack(params, cfg, decode_batchers, regs, *, max_batch=8, seed=0):
    """The in-process disaggregated deployment ``serve_lm
    --disaggregate`` runs: a prefill tier, decode tiers and a router, on
    127.0.0.1. Returns (router, prefill, decodes)."""
    from tony_tpu_torch.serving.disagg import DecodeServer, PrefillServer
    from tony_tpu_torch.serving.router import ServingRouter
    pre = PrefillServer(params, cfg, max_len=1024, seed=seed,
                        max_batch=max_batch, registry=regs[0])
    decs = [DecodeServer(b, registry=regs[1]) for b in decode_batchers]
    router = ServingRouter([f"127.0.0.1:{pre.start()}"],
                           decode_replicas=[f"127.0.0.1:{d.start()}"
                                            for d in decs],
                           health_interval_s=0.2, registry=regs[2])
    router.start()
    return router, pre, decs


def _stop_stack(router, pre, decs):
    router.stop()
    pre.stop()
    for d in decs:
        d.stop()


def _stream(port, prompts, budgets, classes=None):
    """(WorkloadStreams, wall) of the requests over one client."""
    from tony_tpu_torch.serve_lm import WorkloadStreams
    from tony_tpu_torch.serving.client import StreamingClient
    with StreamingClient("127.0.0.1", port) as c:
        run = WorkloadStreams(c)
        for i, (p, n) in enumerate(zip(prompts, budgets)):
            run.submit([p], [n], classes[i] if classes else None)
        return run, run.wait()


def _landing_per_step(params, cfg, prompts, budgets):
    """Device launches, device ms and wall ms per decode step of a decode
    tier's engine (landing included in place of phase 14g's prefill
    admission): a package a prompt (phase 14g's), shipped beforehand,
    adopted through ``submit_prefilled`` and served under
    torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tony_tpu_torch.models import decode as D
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.ops import prng
    s_b = S.bucket_for(max(len(p) for p in prompts), 1024)
    toks = np.zeros((8, s_b), np.int64)
    tl = np.ones((8,), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
        tl[i] = len(p)
    lg, mini = S.prefill_ship_rows(params, D.to_device(toks, "cuda"),
                                   D.to_device(tl, "cuda"), cfg)
    rows = D.extract_kv_rows(mini, [len(p) for p in prompts])
    lgs = lg.cpu()
    b = S.ContinuousBatcher(params, cfg, batch=8, max_len=1024, chunk=8)
    engine = S.ServeEngine(b)
    for i, n in enumerate(budgets):
        key = prng.fold_in(prng.PRNGKey(0), i).numpy().astype(np.uint32)
        engine.submit_prefilled(i, S.KVPackage(rows[i], len(prompts[i]),
                                               lgs[i], key), n)
    engine.drain()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, launches = _device_times(prof)
    steps = b.steps_executed
    return dict(launches=launches / steps,
                device_ms=sum(dev.values()) / 1e3 / steps,
                wall_ms=wall * 1e3 / steps, steps=steps,
                top=sorted(dev.items(), key=lambda kv: -kv[1])[:4])


def _in_process_stack(rep, card, serve):
    """[17b] the router, a prefill tier and a decode tier in this
    process on the card, as ``serve_lm --disaggregate`` runs them: phase
    5's 24 requests greedy (agreement with phase 5 reported), then the
    main path, sampled with the classes in rotation, K1 and K5 counted
    from 0 and split by tier; f32, 8 requests of 16 tokens against the
    colocated ServingServer behind a router (near-tie rule); the decode
    tier's launches, device and wall ms a step. Returns (K1, K5)."""
    import torch
    from tony_tpu_torch import tree_map
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    from tony_tpu_torch.serving.router import ServingRouter
    from tony_tpu_torch.serving.server import ServingServer
    cfg, params = serve["cfg"], serve["params"]
    prompts, budgets = serve["prompts"], serve["budgets"]
    L, n = cfg.n_layers, len(prompts)

    def batcher(p=params, c=cfg, **kw):
        return S.ContinuousBatcher(p, c, batch=8, max_len=1024, chunk=8,
                                   **kw)

    # greedy, against phase 5's colocated streams
    regs = [MetricsRegistry() for _ in range(3)]
    stack = _stack(params, cfg, [batcher()], regs)
    try:
        run, wall = _stream(stack[0].port, prompts, budgets)
    finally:
        _stop_stack(*stack)
    if [len(o or []) for o in run.outputs] != budgets:
        fail("phase 17b: a greedy disaggregated request missed its budget")
    g_same = sum(a == b for a, b in zip(run.outputs, serve["outputs"]))
    g_lat = run.latency_ms()
    print(f"[17b] greedy, disaggregated in process: {g_same}/{n} streams "
          f"equal phase 5's colocated serve (bf16); {sum(budgets)} tokens "
          f"in {wall:.3f}s ({sum(budgets) / wall:.1f} tokens/s); "
          + _lat_text(g_lat), flush=True)
    rep["greedy"] = dict(equal=g_same, wall_s=wall, latency_ms=g_lat,
                         tokens_per_s=sum(budgets) / wall)

    # the main path: sampled, classes in rotation, counts from 0
    classes = [S.QOS_CLASSES[i % 3] for i in range(n)]
    regs = [MetricsRegistry() for _ in range(3)]
    stack = _stack(params, cfg, [batcher(**SAMPLING)], regs,
                   seed=SAMPLING["seed"])
    try:
        torch.cuda.synchronize()
        k1, k5 = _tallies()
        S.CALL_COUNTS.clear()
        run, wall = _stream(stack[0].port, prompts, budgets, classes)
        torch.cuda.synchronize()
        calls = dict(S.CALL_COUNTS)
        variants = _check_tc_variants("phase 17b")["k1"]
        k1_total, k5_total = int(k1), int(k5)
        k1_by, k5_by = dict(k1.by), dict(k5.by)
        dec_stats = stack[2][0].engine.stats()
    finally:
        _stop_stack(*stack)
        _untally()
    waves = sum(c for (name, _), c in calls.items()
                if name == "prefill_ship_rows")
    steps = sum(c * shape[1] for (name, shape), c in calls.items()
                if name == "step_rows")
    pk1 = k1_by.get("tony-prefill-worker", 0)
    dk1 = k1_by.get("tony-decode-engine", 0)
    pk5 = k5_by.get("tony-prefill-worker", 0)
    dk5 = k5_by.get("tony-decode-engine", 0)
    if dk1 != 0 or pk1 != L * waves or k1_total != pk1:
        fail(f"phase 17b: K1 launches {k1_by} (total {k1_total}); expected "
             f"{L} x {waves} waves at the prefill tier and none elsewhere")
    if (pk5 != (2 * L + 1) * waves or dk5 != (2 * L + 1) * steps
            or k5_total != pk5 + dk5):
        fail(f"phase 17b: K5 launches {k5_by} (total {k5_total}); expected "
             f"(2 x {L} + 1) x {waves} waves at the prefill tier and x "
             f"{steps} decode steps at the decode tier")
    if [len(o or []) for o in run.outputs] != budgets or not all(
            0 <= t < cfg.vocab_size for o in run.outputs for t in o):
        fail("phase 17b: a sampled disaggregated request missed its budget "
             "or left the vocabulary")
    want = batcher(**SAMPLING).serve(prompts, budgets)
    s_same = sum(a == b for a, b in zip(run.outputs, want))
    lat = {c: run.latency_ms(c) for c in S.QOS_CLASSES}
    ship = regs[0].histogram("tony_kv_ship_seconds")
    land = regs[1].histogram("tony_kv_land_seconds")
    shipped = regs[0].counter("tony_kv_ship_bytes_total").value
    print(f"[17b] sampled, classes in rotation (the main path): {s_same}/"
          f"{n} streams equal the colocated in-process serve ("
          f"{dec_stats['preemptions']} decode-tier preemptions); "
          f"{sum(budgets)} tokens in {wall:.3f}s ({sum(budgets) / wall:.1f}"
          f" tokens/s); K1 {k1_total} = {L} x {waves} prefill waves, all at "
          f"the prefill tier ({variants['tensor_core']} tensor-core), 0 at "
          f"the decode tier; K5 {k5_total}: prefill tier {pk5}, decode tier "
          f"{dk5} over {steps} steps; {ship.count} shipments, "
          f"{shipped / max(1, ship.count):.0f} B and "
          f"{ship.sum / max(1, ship.count) * 1e3:.2f} ms (ship) + "
          f"{land.sum / max(1, land.count) * 1e3:.2f} ms (land) each",
          flush=True)
    for c in S.QOS_CLASSES:
        print(f"[17b]   {c}: " + _lat_text(lat[c]), flush=True)
    rep["sampled"] = dict(equal=s_same, wall_s=wall, latency_ms=lat,
                          k1=k1_total, k5=k5_total, k1_by_thread=k1_by,
                          k5_by_thread=k5_by, waves=waves, steps=steps,
                          ship_s=ship.sum / max(1, ship.count),
                          land_s=land.sum / max(1, land.count),
                          ship_bytes=shipped / max(1, ship.count),
                          preemptions=dec_stats["preemptions"])

    # f32: 8 requests of 16 tokens, disaggregated vs colocated, each
    # behind a router
    cfg32 = cfg.scaled(dtype=torch.float32)
    params32 = tree_map(lambda v: v.float(), params)
    p8, b8 = prompts[:8], [16] * 8
    stack = _stack(params32, cfg32, [batcher(params32, cfg32)],
                   [MetricsRegistry() for _ in range(3)])
    try:
        disagg, _ = _stream(stack[0].port, p8, b8)
    finally:
        _stop_stack(*stack)
    srv = ServingServer(batcher(params32, cfg32), registry=MetricsRegistry())
    router = ServingRouter([f"127.0.0.1:{srv.start()}"],
                           registry=MetricsRegistry())
    try:
        router.start()
        colo, _ = _stream(router.port, p8, b8)
    finally:
        router.stop()
        srv.stop()
    equal, diffs = _near_ties("phase 17b f32", params32, cfg32, p8,
                              disagg.outputs, colo.outputs, 1e-4)
    del params32
    print(f"[17b] f32, 8 requests of 16 tokens: disaggregated {equal}/8 "
          f"equal to the colocated ServingServer behind a router (first "
          f"differences {diffs}, each a near-tie within 1e-4)", flush=True)
    rep["f32"] = dict(equal=equal, diffs=diffs)

    # the decode tier's step: landing in place of prefill admission
    n_ps = PER_STEP_REQUESTS
    per = _landing_per_step(params, cfg, prompts[:n_ps],
                            [min(b, SHORT_BUDGET) for b in budgets[:n_ps]])
    print(f"[17b] decode tier, per decode step over {per['steps']} (landing "
          f"included): {per['launches']:.1f} device launches, device "
          f"{per['device_ms']:.3f} ms, wall {per['wall_ms']:.3f} ms; top: "
          + "; ".join(f"{nm[:40]} {us / 1e3 / per['steps']:.3f} ms"
                      for nm, us in per["top"]), flush=True)
    rep["decode_per_step"] = per
    return k1_total, k5_total


def _spawn(argss):
    """Start a ``serve_lm`` process for each argument list, at once."""
    env = dict(os.environ, PYTHONPATH=HERE)
    return [subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.serve_lm", *args], cwd=HERE,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for args in argss]


def _await(procs, patterns, tag):
    """The first group of each process's first line matching its
    pattern (its address), in order; fails if one exits first."""
    import re
    out = []
    for proc, pattern in zip(procs, patterns):
        lines = []
        while True:
            line = proc.stdout.readline()
            if not line:
                fail(f"phase 17: serve_lm {tag} exited before serving: "
                     + "".join(lines)[-2000:])
            lines.append(line)
            m = re.search(pattern, line)
            if m:
                out.append(m.group(1))
                break
    return out


_ADDR = r"on (127\.0\.0\.1:\d+)"

#: phase 17's tier processes: a prefill tier, three decode tiers (17c
#: serves through the first; 17d kills one of the first two, adds the
#: third and drains the other) and one colocated replica (17c's
#: comparison), each with the line that gives its address
_TIERS = tuple(
    (["--preset", "small", "--slots", "8", "--prompt_len", "960",
      "--max_new_tokens", "64", "--listen", "127.0.0.1:0", *role], pattern)
    for role, pattern in (
        (["--role", "prefill"], "prefill tier.*" + _ADDR),
        (["--role", "decode"], "decode tier.*" + _ADDR),
        (["--role", "decode"], "decode tier.*" + _ADDR),
        (["--role", "decode"], "decode tier.*" + _ADDR),
        ([], r"serving \S+ .*" + _ADDR)))


def _client(addr, tag, extra=()):
    """``serve_lm --connect`` with phase 5's workload; returns (streams,
    {label: latency line numbers}, tokens/s)."""
    import re
    path = os.path.join(HERE, "chiprun_out", f"phase17_{tag}.json")
    cli = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.serve_lm", "--preset",
         "small", "--requests", "24", "--prompt_len", "480",
         "--min_prompt_len", "64", "--max_new_tokens", "64", "--connect",
         addr, "--outputs", path, *extra], cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
        text=True, timeout=600)
    if cli.returncode != 0:
        fail(f"phase 17: serve_lm --connect {tag} failed: "
             f"{(cli.stdout + cli.stderr)[-2000:]}")
    lat = {}
    for m in re.finditer(r"(\w+)(?: \(\d+ reqs\))?: ttft p50 ([\d.]+) ms  p99 "
                         r"([\d.]+) ms;  inter-token p50 ([\d.]+) ms  p99 "
                         r"([\d.]+) ms", cli.stdout):
        lat[m.group(1)] = dict(zip(("ttft_p50", "ttft_p99", "itl_p50",
                                    "itl_p99"),
                                   map(float, m.groups()[1:])))
    tok_s = float(re.search(r"— ([\d.]+) tok/s", cli.stdout).group(1))
    with open(path) as f:
        return json.load(f), lat, tok_s


def _tier_stats(addr):
    from tony_tpu_torch.serving.client import StreamingClient
    host, port = addr.rsplit(":", 1)
    with StreamingClient(host, int(port)) as c:
        return c.stats()


def _tiers_as_processes(rep, serve, procs, addrs):
    """[17c] ``serve_lm --role prefill`` and ``--role decode`` on the
    card behind a ``--listen --route --route_decode`` router, a
    ``--connect --mixed_classes`` client; the same traffic through a
    router to one colocated ``serve_lm --listen`` replica. [17d] two
    decode processes behind a router: one SIGKILLed mid-stream, a third
    added, the other drained with ``serve_lm --connect ROUTER --drain``
    while its sessions stream: every stream its budget, no token
    duplicated or dropped."""
    import signal
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    from tony_tpu_torch.serving.router import ServingRouter
    pre, d1, d2, d3, colo = addrs
    routers = []
    try:
        routers = _spawn([["--listen", "127.0.0.1:0", "--route", pre,
                           "--route_decode", d1],
                          ["--listen", "127.0.0.1:0", "--route", colo]])
        r_dis, r_colo = _await(routers, ["routing " + _ADDR] * 2, "routers")
        outs_d, lat_d, tps_d = _client(r_dis, "disagg", ["--mixed_classes"])
        pst, dst = _tier_stats(pre), _tier_stats(d1)
        outs_c, lat_c, tps_c = _client(r_colo, "colocated",
                                       ["--mixed_classes"])
    finally:
        _stop_procs(routers)
    budgets = serve["budgets"]
    if [len(o or []) for o in outs_d] != budgets or \
            [len(o or []) for o in outs_c] != budgets:
        fail("phase 17c: a request through a router missed its budget")
    same = sum(a == b for a, b in zip(outs_d, outs_c))
    ship = pst["series"]["tony_kv_ship_seconds"]
    land = dst["series"]["tony_kv_land_seconds"]
    bytes_ = pst["series"]["tony_kv_ship_bytes_total"]
    phases = dst["phases"]
    host_ms = sum(v["total_s"] for v in phases.values()) * 1e3 / max(
        1, dst["steps"])
    print(f"[17c] tiers as processes, {len(budgets)} requests with the "
          f"classes in rotation: disaggregated {tps_d:.1f} tokens/s, "
          f"colocated {tps_c:.1f} tokens/s; {same}/{len(budgets)} streams "
          f"equal; {ship['count']} shipments of {bytes_ / max(1, ship['count']):.0f}"
          f" B, ship {ship['sum'] / max(1, ship['count']) * 1e3:.2f} ms and "
          f"land {land['sum'] / max(1, land['count']) * 1e3:.2f} ms each "
          f"(STATS); the decode tier's host wall {host_ms:.3f} ms a step over "
          f"{dst['steps']} steps", flush=True)
    for label in ("all", "interactive", "standard", "batch"):
        for name, lat in (("disaggregated", lat_d), ("colocated", lat_c)):
            v = lat.get(label)
            if v:
                print(f"[17c]   {label}, {name}: TTFT p50 {v['ttft_p50']} ms "
                      f"p99 {v['ttft_p99']} ms, ITL p50 {v['itl_p50']} ms "
                      f"p99 {v['itl_p99']} ms", flush=True)
    rep["processes"] = dict(
        disagg=dict(latency_ms=lat_d, tokens_per_s=tps_d),
        colocated=dict(latency_ms=lat_c, tokens_per_s=tps_c), equal=same,
        ships=ship["count"], ship_s=ship["sum"] / max(1, ship["count"]),
        land_s=land["sum"] / max(1, land["count"]),
        ship_bytes=bytes_ / max(1, ship["count"]),
        decode_steps=dst["steps"], decode_host_ms_per_step=host_ms,
        decode_phases=phases)

    # 17d failover and drain, bf16, the tiers as processes. The drain is
    # serve_lm's --connect --drain, run in a process started beforehand
    # with its imports done (an interpreter's start would outlast the
    # streams it is meant to migrate)
    n, budget = 16, 256
    prompts = serve["prompts"][:n]
    drainer = subprocess.Popen(
        [sys.executable, "-c", _DRAIN_HELPER], cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE), stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reg = MetricsRegistry()
    router = ServingRouter([pre], decode_replicas=[d1, d2],
                           health_interval_s=0.2, registry=reg)
    try:
        router.start()
        from tony_tpu_torch.serving.client import StreamingClient
        with StreamingClient("127.0.0.1", router.port) as c:
            rids, got = _started_streams(c, prompts, budget)
            reps = router.stats()["replicas"]
            victim = max((d1, d2), key=lambda a: reps[a]["assigned"])
            survivor = d2 if victim == d1 else d1
            procs[(d1, d2).index(victim) + 1].send_signal(signal.SIGKILL)
            router.add_replicas([d3], role="decode")
            text, _ = drainer.communicate(
                f"--connect 127.0.0.1:{router.port} --drain {survivor}\n",
                timeout=300)
            _collect_streams(c, rids, got)
        outs = [got[r] for r in rids]
        res = text.strip().splitlines()[-1] if text.strip() else ""
        if (drainer.returncode != 0 or "'drained': True" not in res
                or "'migrated': 0," in res):
            fail(f"phase 17d: serve_lm --drain failed or migrated no live "
                 f"session: {text[-2000:]}")
        failovers = reg.counter("tony_router_failovers_total").value
        migrations = reg.counter("tony_router_migrations_total").value
    finally:
        router.stop()
        if drainer.poll() is None:
            drainer.kill()
            drainer.communicate()
    if [len(o) for o in outs] != [budget] * n:
        fail(f"phase 17d: streams of {[len(o) for o in outs]} tokens after "
             f"the kill and the drain (every one should have {budget}: a "
             f"token was duplicated or dropped)")
    if not failovers:
        fail("phase 17d: the kill caused no failover")
    print(f"[17d] bf16 processes: decode {victim} SIGKILLed mid-stream, "
          f"{d3} added, {survivor} drained ({res}); {n}/{n} streams of "
          f"{budget} tokens, none duplicated or dropped; {failovers:.0f} "
          f"failovers, {migrations:.0f} migrations", flush=True)
    rep["failover_bf16"] = dict(streams=n, budget=budget,
                                failovers=failovers, migrations=migrations,
                                drain=res)


#: ``serve_lm.main`` on the arguments of the first line of stdin, in a
#: process whose imports are done before the line arrives
_DRAIN_HELPER = ("import sys; from tony_tpu_torch import serve_lm; "
                 "sys.exit(serve_lm.main(sys.stdin.readline().split()))")


def _started_streams(c, prompts, budget, what="phase 17d"):
    """Submit; return once every stream has its first tokens."""
    import queue
    rids = [c.submit(p, budget) for p in prompts]
    got = {r: [] for r in rids}
    deadline = time.time() + 300
    while any(not got[r] for r in rids) and time.time() < deadline:
        for r in rids:
            if not got[r]:
                try:
                    ev = c.next_event(r, timeout=0.01)
                except queue.Empty:
                    continue
                if ev[0] != "tokens":
                    fail(f"{what}: stream {r} ended early: {ev}")
                got[r].extend(ev[1])
    if any(not got[r] for r in rids):
        fail(f"{what}: the streams never started")
    return rids, got


def _collect_streams(c, rids, got, what="phase 17d"):
    """Read every stream to its ONE terminal frame (RETIRED)."""
    for r in rids:
        while True:
            ev = c.next_event(r, timeout=300)
            if ev[0] == "tokens":
                got[r].extend(ev[1])
            elif ev[0] == "retired":
                break
            else:
                fail(f"{what}: stream {r}: {ev}")


def _paced(delay_s):
    """A ContinuousBatcher whose fetches wait ``delay_s`` (streams stay
    mid-flight while the fleet changes under them)."""
    from tony_tpu_torch.models import serve as S

    class Paced(S.ContinuousBatcher):
        def _fetch(self, handle):
            time.sleep(delay_s)
            return super()._fetch(handle)

    return Paced


def _failover_f32(rep, serve):
    """[17d] the same drill in f32, the tiers in process (``kill()`` for
    the loss): 8 requests of 128 tokens over two decode tiers of 4
    slots, one killed mid-stream, a third added, the other drained;
    every stream equal to the unfailed run (near-tie rule)."""
    import torch
    from tony_tpu_torch import tree_map
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    from tony_tpu_torch.serving.client import StreamingClient
    from tony_tpu_torch.serving.disagg import DecodeServer
    cfg = serve["cfg"].scaled(dtype=torch.float32)
    params = tree_map(lambda v: v.float(), serve["params"])
    prompts, budget = serve["prompts"][:8], 128

    def decoder():
        return _paced(0.02)(params, cfg, batch=4, max_len=1024, chunk=8)

    regs = [MetricsRegistry() for _ in range(3)]
    stack = _stack(params, cfg, [decoder(), decoder()], regs, max_batch=4)
    try:
        unfailed, _ = _stream(stack[0].port, prompts, [budget] * 8)
    finally:
        _stop_stack(*stack)
    regs = [MetricsRegistry() for _ in range(3)]
    router, pre, decs = _stack(params, cfg, [decoder(), decoder()], regs,
                               max_batch=4)
    third = DecodeServer(decoder(), registry=regs[1])
    try:
        with StreamingClient("127.0.0.1", router.port) as c:
            rids, got = _started_streams(c, prompts, budget)
            reps = router.stats()["replicas"]
            addrs = [f"127.0.0.1:{d.port}" for d in decs]
            k = max(range(2), key=lambda i: reps[addrs[i]]["assigned"])
            decs[k].kill()
            router.add_replicas([f"127.0.0.1:{third.start()}"],
                                role="decode")
            res = c.drain_replica(addrs[1 - k])
            _collect_streams(c, rids, got)
        failovers = regs[2].counter("tony_router_failovers_total").value
    finally:
        _stop_stack(router, pre, decs + [third])
    outs = [got[r] for r in rids]
    if [len(o) for o in outs] != [budget] * 8 or not res.get("drained"):
        fail(f"phase 17d f32: streams of {[len(o) for o in outs]} tokens, "
             f"drain {res}")
    equal, diffs = _near_ties("phase 17d f32", params, cfg, prompts, outs,
                              unfailed.outputs, 1e-4)
    print(f"[17d] f32 in process: a decode tier killed mid-stream, a third "
          f"added, the other drained ({res['migrated']} migrated); "
          f"{failovers:.0f} failovers; {equal}/8 streams of {budget} tokens "
          f"equal to the unfailed run (first differences {diffs}, each a "
          f"near-tie within 1e-4)", flush=True)
    rep["failover_f32"] = dict(equal=equal, diffs=diffs,
                               failovers=failovers, drain=res)


def phase_disagg(report, card, serve):
    """[17] disaggregated prefill/decode and the router on the card:
    phase 5's ``small`` bf16, 8 slots of 1024 positions, chunk 8, phase
    5's 24 requests. Returns (K1, K5) launches of the in-process main
    path (17b's sampled serve)."""
    t_phase = time.perf_counter()
    report["disagg"] = rep = {}
    # the tier processes boot while 17a runs (it measures no time)
    procs = _spawn([args for args, _ in _TIERS])
    walls = {}
    try:
        t0 = time.perf_counter()
        _landing_exactness(rep, serve["params"], serve["cfg"])
        addrs = _await(procs, [pat for _, pat in _TIERS], "tiers")
        walls["17a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        k1, k5 = _in_process_stack(rep, card, serve)
        walls["17b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _tiers_as_processes(rep, serve, procs, addrs)
        walls["17c-d"] = time.perf_counter() - t0
    finally:
        _stop_procs(procs)
    t0 = time.perf_counter()
    _failover_f32(rep, serve)
    walls["17d f32"] = time.perf_counter() - t0
    rep["wall_s"] = time.perf_counter() - t_phase
    rep["walls_s"] = walls
    print(f"[17] phase wall {rep['wall_s']:.1f}s ("
          + ", ".join(f"{k} {v:.1f}s" for k, v in walls.items()) + ")",
          flush=True)
    return k1, k5


# phase 18: file-fed training, elastic resume, asynchronous checkpoints ---

FEED_FILES, FEED_RECORDS = 8, 8184     # 8 x 8184 records of 4100 B: 256 MiB


def _write_token_files(directory, seq, vocab, seed=18):
    """FEED_FILES raw files of FEED_RECORDS int32 records of seq + 1
    tokens, from ``numpy.random.default_rng(seed)``; returns the paths
    and the bytes written."""
    import numpy as np
    rng = np.random.default_rng(seed)
    paths, total = [], 0
    for i in range(FEED_FILES):
        path = os.path.join(directory, f"tokens{i}.bin")
        rng.integers(0, vocab, size=(FEED_RECORDS, seq + 1),
                     dtype=np.int32).tofile(path)
        paths.append(path)
        total += os.path.getsize(path)
    return paths, total


def _read_all(paths, record_size, native):
    """Every record of ``paths`` through one shuffled FileSplitReader
    (capacity 1024) on one engine: (records, bytes, seconds)."""
    from tony_tpu_torch.io import FileSplitReader
    t0 = time.perf_counter()
    n = nbytes = 0
    with FileSplitReader(paths, record_size=record_size, shuffle=True,
                         seed=0, capacity=1024, use_native=native) as r:
        if r.is_native != native:
            fail(f"asked for the {'native' if native else 'python'} "
                 f"engine, got the other")
        while batch := r.next_batch(256):
            n += len(batch)
            nbytes += sum(map(len, batch))
    return n, nbytes, time.perf_counter() - t0


def _batch_digest(batch) -> str:
    import hashlib
    x = batch["inputs"]
    return hashlib.sha256(x.cpu().contiguous().numpy().tobytes()).hexdigest()


def _disk_bytes(path) -> int:
    """Bytes of a file, or of every file under a directory."""
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _checkpoint_stall(card, state, directory, label, check=True):
    """The ms the step loop blocks on one save of ``state``, synchronous
    (save, then wait for the write) and asynchronous (save returns after
    the snapshot), twice each, and the background write's wall."""
    import statistics

    import torch
    from tony_tpu_torch import tree_leaves
    from tony_tpu_torch.models.checkpoint import CheckpointManager
    state_bytes = sum(t.to_local().numel() * t.element_size()
                      if hasattr(t, "placements") else
                      t.numel() * t.element_size()
                      for t in tree_leaves(state)
                      if isinstance(t, torch.Tensor))
    mgr = CheckpointManager(directory, max_to_keep=1)
    sync, stall, write = [], [], []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(100 + i, state, force=True)
        t1 = time.perf_counter()
        mgr.wait_until_finished()
        t2 = time.perf_counter()
        if i % 2:
            stall.append((t1 - t0) * 1e3)
            write.append((t2 - t1) * 1e3)
        else:
            sync.append((t2 - t0) * 1e3)
    [last] = os.listdir(directory)
    disk = _disk_bytes(os.path.join(directory, last))
    mgr.close()
    out = dict(state_bytes=state_bytes, disk_bytes=disk, sync_ms=sync,
               async_stall_ms=stall, async_write_ms=write)
    print(f"[18e] checkpoint of the small bf16 train state, {label}, on "
          f"{card}: {state_bytes:,} bytes of tensors ({disk:,} B on disk, "
          f"{last}); the step loop blocks {statistics.median(sync):.1f} ms "
          f"on a synchronous save (save + wait: "
          f"{[round(x, 1) for x in sync]}), {statistics.median(stall):.1f} "
          f"ms on an asynchronous one (the host snapshot: "
          f"{[round(x, 1) for x in stall]}); the background write takes "
          f"{statistics.median(write):.1f} ms "
          f"({[round(x, 1) for x in write]})", flush=True)
    if check and not max(stall) < min(sync):
        fail(f"an asynchronous {label} save blocked the loop as long as a "
             f"synchronous one")
    return out


def _checkpoint_loop(card, cfg, params, directory, mesh, write_ms, label,
                     check=True):
    """``run_training`` over 13 synchronised steps of ``small`` offering a
    save after each, saved every 5 (offers 1, 5 and 10): each step's wall
    (from one ``step_hook`` to the next, so it holds the data wait, the
    step and the offer), each offer's wall, and the steps right after a
    save against the steps with no save near them (neither a save step
    nor right after one). A step after a save that exceeds the quiet
    median by half the background write's wall ``write_ms`` waited for
    the write: it fails the run under ``check``."""
    import statistics

    from tony_tpu_torch.models.checkpoint import CheckpointManager
    mgr = CheckpointManager(directory, save_interval_steps=5)
    offers, starts = {}, []
    real_save = mgr.save

    def save(step, state, force=False):
        t0 = time.perf_counter()
        saved = real_save(step, state, force)
        offers[step] = ((time.perf_counter() - t0) * 1e3, saved)
        return saved

    mgr.save = save
    _train_run(cfg, params, 13, timed=True, mesh=mesh, checkpoint=mgr,
               step_hook=lambda step: starts.append(time.perf_counter()))
    mgr.close()
    walls = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    saves = [s - 1 for s, (_, saved) in sorted(offers.items()) if saved]
    after = [s + 1 for s in saves if s + 1 < len(walls)]
    quiet = [s for s in range(1, len(walls)) if s not in saves + after]
    after_ms = [walls[s] for s in after]
    quiet_ms = statistics.median(walls[s] for s in quiet)
    out = dict(walls_ms=walls, offer_ms={s: o for s, (o, _) in
                                         offers.items()},
               save_steps=saves, after_steps=after, quiet_steps=quiet,
               after_ms=after_ms, quiet_median_ms=quiet_ms,
               write_ms=write_ms)
    print(f"[18e] run_training, {label}, on {card}: 13 synchronised steps, "
          f"a save offered after each and saved every 5 (steps {saves}): "
          f"steps right after a save {[round(x, 2) for x in after_ms]} ms "
          f"against {quiet_ms:.2f} ms (median of steps {quiet}, no save "
          f"near); save steps {[round(walls[s], 2) for s in saves]} ms; the "
          f"offers after a save "
          f"{[round(offers[s + 1][0], 3) for s in after]} ms, the slowest "
          f"quiet offer {max(offers[s + 1][0] for s in quiet):.3f} ms; "
          f"background write {write_ms:.1f} ms", flush=True)
    if check and not max(after_ms) < quiet_ms + 0.5 * write_ms:
        fail(f"a {label} step after a save waited for the write: "
             f"{after_ms} ms against {quiet_ms:.2f} ms quiet and a "
             f"{write_ms:.1f} ms write")
    return out


def _checkpoint_phase(card, cfg, params, directory, check=True) -> dict:
    """(e) On a world-1 NCCL runtime (fsdp mesh), for ``small``'s train
    state unsharded and as DTensors: the stall of a save
    (:func:`_checkpoint_stall`) and the steps around saves in
    ``run_training`` (:func:`_checkpoint_loop`)."""
    import statistics

    import tony_tpu_torch.runtime as rt
    from tony_tpu_torch.models import train as TR
    from tony_tpu_torch.models import transformer as T
    _world1_env({"fsdp": -1})
    rt.initialize()
    out = {}
    try:
        mesh = rt.mesh()
        # one step first: a process's first step loads and tunes the
        # card's libraries, seconds a save step must not be charged with
        _train_run(cfg, _copy_tree(params, "cuda"), 1)
        for label, m in (("unsharded", None),
                         ("sharded on the world-1 fsdp mesh", mesh)):
            key = "sharded" if m is not None else "unsharded"
            state = TR.init_state(_copy_tree(params, "cuda"),
                                  TR.default_optimizer(), m,
                                  T.logical_axes(cfg))
            stall = _checkpoint_stall(card, state,
                                      os.path.join(directory, key), label,
                                      check)
            del state
            loop = _checkpoint_loop(
                card, cfg, _copy_tree(params, "cuda"),
                os.path.join(directory, key + "_loop"), m,
                statistics.median(stall["async_write_ms"]), label, check)
            out[key] = dict(stall=stall, loop=loop)
    finally:
        rt.shutdown()
    return out


def _world1_env(axes, dcn=None) -> None:
    """The jax arm's environment, as the executor exports it, for a
    world-1 runtime on a free port with mesh ``axes`` (and the dcn axes
    ``dcn`` of a multi-slice job)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    spec = {"axes": axes, **({"dcn_axes": dcn} if dcn else {})}
    os.environ.update(TONY_JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      TONY_JAX_PROCESS_ID="0", TONY_JAX_NUM_PROCESSES="1",
                      TONY_MESH_SPEC=json.dumps(spec))


def _train_lm_cli(argv, axes=None, dcn=None):
    """``train_lm.main(argv)`` in this process, its runtime booted from the
    jax arm's environment at world 1 on a free port (NCCL, mesh ``axes``,
    ``{"fsdp": -1}`` by default, dcn axes ``dcn``) and shut down after:
    (exit code, printed lines)."""
    import contextlib
    import io

    import tony_tpu_torch.runtime as rt
    from tony_tpu_torch import train_lm
    _world1_env(axes or {"fsdp": -1}, dcn)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = train_lm.main(argv)
    finally:
        rt.shutdown()
    return rc, out.getvalue().splitlines()


def phase_files(report, card):
    """[18] File-fed training of `small` bf16 at 16 x 1024: (a) 256 MiB of
    token files from a seed, (b) the reader on each engine, (c) 20 steps
    through train_lm's file source and a DevicePrefetcher of depth 2
    beside phase 9's synthetic run, (d) --elastic_data 16 for 20 steps
    with an asynchronous checkpoint at step 10, restored by a new manager
    and run again from step 10 (batches by sha256, losses bitwise, on the
    two-pass backward), (e) the checkpoint stall and the steps around
    saves in run_training, unsharded and sharded, (f) train_lm's entry
    point itself on the files: the sharded step on a world-1 NCCL mesh,
    ``--data_files`` for 20 steps, then ``--elastic_data 16`` stopped at
    step 10 and resumed from its (DCP) checkpoint to 20."""
    import statistics
    import tempfile

    import torch
    from tony_tpu_torch import train_lm
    from tony_tpu_torch.io import FileSplitReader
    from tony_tpu_torch.models import train as TR
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.models.checkpoint import CheckpointManager
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    steps, batch, seq = 20, 16, 1024
    t_phase = time.perf_counter()
    cfg, params = train_lm.build("small", "cuda")
    L = cfg.n_layers
    base = _copy_tree(params, "cuda")
    rec_bytes = 4 * (seq + 1)
    out = {}

    def counts():
        return dict(k1=A.flash_forward.launches,
                    k2=A.flash_backward_fused.launches,
                    k3a=A.flash_backward_dq.launches,
                    k3b=A.flash_backward_dkv.launches,
                    k5=N.rms_norm_forward.launches)

    def zero_counts():
        A.reset_launches()
        N.rms_norm_forward.launches = 0

    with tempfile.TemporaryDirectory() as tmp:
        # (a) the data
        t0 = time.perf_counter()
        paths, total = _write_token_files(tmp, seq, cfg.vocab_size)
        records = total // rec_bytes
        print(f"[18a] wrote {FEED_FILES} files of {FEED_RECORDS} records of "
              f"{seq + 1} int32 tokens ({rec_bytes} B): {total:,} bytes, "
              f"{records:,} records in {time.perf_counter() - t0:.1f}s",
              flush=True)

        # (b) the reader, each engine over all of it (from the page cache)
        with FileSplitReader(paths, record_size=rec_bytes) as r:
            if not r.is_native:
                fail("the reader's default engine is not the native one")
        reads = {}
        for name, native in (("native", True), ("python", False)):
            n, nbytes, secs = _read_all(paths, rec_bytes, native)
            if n != records or nbytes != total:
                fail(f"the {name} engine read {n} records / {nbytes} B, "
                     f"want {records} / {total}")
            reads[name] = dict(records=n, bytes=nbytes, seconds=secs,
                               mb_s=nbytes / secs / 1e6,
                               records_s=n / secs)
            print(f"[18b] {name} engine on {card}: {nbytes:,} B shuffled "
                  f"(capacity 1024) in {secs:.3f}s: "
                  f"{nbytes / secs / 1e6:,.1f} MB/s, {n / secs:,.0f} "
                  f"records/s (files in the page cache)", flush=True)
        out["reader"] = reads

        # (c) 20 steps from the files, in turns with the synthetic source
        # (synthetic, files, files, synthetic) beside phase 9's run;
        # launches counted over the first file-fed run
        runs = {"synthetic": [], "files": []}
        for i, kind in enumerate(("synthetic", "files", "files",
                                  "synthetic")):
            source = (train_lm.file_source(paths, batch, seq, seed=0)
                      if kind == "files" else None)
            torch.cuda.synchronize()
            if i == 1:
                zero_counts()
            _, losses, walls, waits = _train_run(
                cfg, _copy_tree(base, "cuda"), steps, batch=batch, seq=seq,
                timed=True, source=source)
            if i == 1:
                c = counts()
                _check_tc_variants("bf16 file-fed training")
                file_losses = losses
            if not all(abs(x) < float("inf") for x in losses):
                fail(f"a {kind} training loss is not finite")
            runs[kind].append(dict(
                step_ms=statistics.median(walls[-10:]) * 1e3,
                wait_ms=statistics.median(waits) * 1e3, walls=walls,
                waits=waits))
        step_ms = statistics.median(r["step_ms"] for r in runs["files"])
        syn_ms = statistics.median(r["step_ms"] for r in runs["synthetic"])
        wait_ms = statistics.median(r["wait_ms"] for r in runs["files"])
        syn_wait = statistics.median(r["wait_ms"]
                                     for r in runs["synthetic"])
        tok_s = batch * seq / (step_ms / 1e3)
        p9 = report["train"]
        print(f"[18c] small bf16 from the files on {card}: {steps} steps of "
              f"{batch}x{seq} in turns synthetic, files, files, synthetic: "
              f"step {[round(r['step_ms'], 2) for r in runs['files']]} ms "
              f"from the files against "
              f"{[round(r['step_ms'], 2) for r in runs['synthetic']]} "
              f"synthetic (medians of the last 10; {step_ms / syn_ms:.3f}x;"
              f" phase 9: {p9['step_ms']:.2f} ms), {tok_s:,.0f} tokens/s; "
              f"data wait median {wait_ms:.3f} ms from the files against "
              f"{syn_wait:.3f} ms synthetic (phase 9: "
              f"{p9['data_wait_median_ms']:.3f} ms); losses "
              f"{file_losses[0]:.4f} -> {file_losses[-1]:.4f}; launches {c}",
              flush=True)
        if c["k1"] != 2 * L * steps or c["k2"] != L * steps or \
                c["k3a"] or c["k3b"] or c["k5"] != (4 * L + 1) * steps:
            fail(f"file-fed launch counts {c} != K1 {2 * L * steps}, K2 "
                 f"{L * steps}, K3 0, K5 {(4 * L + 1) * steps}")
        out["train"] = dict(step_ms=step_ms, tokens_per_s=tok_s,
                            data_wait_median_ms=wait_ms, runs=runs,
                            losses=file_losses, launches=c,
                            synthetic_step_ms=syn_ms,
                            synthetic_data_wait_median_ms=syn_wait,
                            phase9_step_ms=p9["step_ms"],
                            phase9_data_wait_median_ms=p9[
                                "data_wait_median_ms"])
        launches = dict(c)

        # (d) --elastic_data 16: an uninterrupted run with an asynchronous
        # checkpoint at step 10, then a new manager restores step 10 and
        # runs steps 10-19 again; on the two-pass backward (the partials
        # budget at 0: no atomics), so the losses can be bitwise
        budget = A._FUSED_PARTIALS_BYTES
        A._FUSED_PARTIALS_BYTES = 0
        try:
            ckpt = os.path.join(tmp, "ckpt")
            straight, resumed = {}, {}
            mgr = CheckpointManager(ckpt, save_interval_steps=10)
            zero_counts()
            _, a_losses, _, _ = _train_run(
                cfg, _copy_tree(base, "cuda"), steps, checkpoint=mgr,
                source=train_lm.elastic_file_source(paths, batch, seq, 0, 0),
                on_batch=lambda s, b: straight.__setitem__(
                    s, _batch_digest(b)))
            c = counts()
            _check_tc_variants("bf16 elastic training, two-pass backward")
            mgr.close()
            if c["k1"] != 2 * L * steps or c["k3a"] != L * steps or \
                    c["k3b"] != L * steps or c["k2"] or \
                    c["k5"] != (4 * L + 1) * steps:
                fail(f"elastic run launch counts {c}: want K1 "
                     f"{2 * L * steps}, K3a = K3b = {L * steps}, K2 0, K5 "
                     f"{(4 * L + 1) * steps}")
            for k in ("k1", "k5", "k3a", "k3b"):
                launches[k] += c[k]
            opt = TR.default_optimizer(lr=3e-4, total_steps=1000)
            new = CheckpointManager(ckpt, save_interval_steps=10)
            state = new.restore(template=TR.init_state(
                _copy_tree(base, "cuda"), opt), step=10)
            if state["step"] != 10:
                fail(f"the restore gave step {state['step']}, not 10")
            _, b_losses, _, _ = _train_run(
                cfg, None, steps - 10, start=10, state=state,
                source=train_lm.elastic_file_source(paths, batch, seq, 0,
                                                    10),
                on_batch=lambda s, b: resumed.__setitem__(
                    s, _batch_digest(b)))
            new.close()
        finally:
            A._FUSED_PARTIALS_BYTES = budget
        same_batches = [resumed.get(s) == straight[s]
                        for s in range(10, steps)]
        same_losses = [a == b for a, b in zip(a_losses[10:], b_losses)]
        print(f"[18d] --elastic_data {batch}, {steps} steps with an "
              f"asynchronous checkpoint at step 10, restored by a new "
              f"manager: steps 10-19's batches equal by sha256 "
              f"{sum(same_batches)}/10, losses bitwise "
              f"{sum(same_losses)}/10 (two-pass backward); uninterrupted "
              f"{[round(x, 6) for x in a_losses[10:]]}, resumed "
              f"{[round(x, 6) for x in b_losses]}; committed "
              f"{sorted(os.listdir(ckpt))}", flush=True)
        out["elastic"] = dict(straight=straight, resumed=resumed,
                              straight_losses=a_losses,
                              resumed_losses=b_losses)
        if sorted(resumed) != list(range(10, steps)) or not all(
                same_batches):
            fail("the resumed elastic run fed other batches than the "
                 "uninterrupted one")
        if not all(same_losses):
            fail("the resumed elastic run's losses are not bitwise the "
                 "uninterrupted run's on the two-pass backward")

        # (e) the checkpoint stall, and the steps around saves
        out["checkpoint"] = _checkpoint_phase(card, cfg, base,
                                              os.path.join(tmp, "stall"))

        # (f) the entry point a user calls, counted from 0 over its runs
        common = ["--preset", "small", "--batch_size", str(batch),
                  "--seq_len", str(seq), "--data_files", *paths]
        cli_dir = os.path.join(tmp, "cli")
        runs = [["--steps", str(steps)],
                ["--steps", "10", "--elastic_data", str(batch),
                 "--ckpt_dir", cli_dir, "--ckpt_every", "10"],
                ["--steps", str(steps), "--elastic_data", str(batch),
                 "--ckpt_dir", cli_dir, "--ckpt_every", "10"]]
        zero_counts()
        t0 = time.perf_counter()
        done = []
        for i, extra in enumerate(runs):
            if i == 2:
                os.environ["ATTEMPT_NUMBER"] = "1"
            try:
                rc, lines = _train_lm_cli(common + extra)
            finally:
                os.environ.pop("ATTEMPT_NUMBER", None)
            last = [x for x in lines if x.startswith("done: final loss ")]
            done.append(last[0] if last else None)
            if rc != 0 or not last or not abs(
                    float(last[0].split()[-1])) < float("inf"):
                fail(f"train_lm {' '.join(extra)} on the files: exit {rc}, "
                     f"last lines {lines[-3:]}")
            if i == 2 and any(x.startswith("step 0 ") for x in lines):
                fail("the resumed --elastic_data run did not start at its "
                     "checkpoint's step")
        c = counts()
        _check_tc_variants("bf16 train_lm on the files")
        committed = sorted(os.listdir(cli_dir))
        n = 2 * steps                   # 20 file-fed + 10 + 10 elastic
        print(f"[18f] python -m tony_tpu_torch.train_lm --preset small "
              f"--batch_size {batch} --seq_len {seq} --data_files (8 "
              f"files) on {card}, the sharded step on a world-1 NCCL mesh: "
              f"{steps} steps, then --elastic_data {batch} stopped at step "
              f"10 and resumed from its checkpoint to {steps}, in "
              f"{time.perf_counter() - t0:.1f}s: {done}; checkpoints "
              f"{committed}; launches {c}", flush=True)
        out["cli"] = dict(done=done, committed=committed, launches=c)
        if committed != ["step_1", "step_10", "step_20"]:
            fail(f"train_lm's elastic checkpoints {committed}")
        if c["k1"] != 2 * L * n or c["k2"] != L * n or c["k3a"] or \
                c["k3b"] or c["k5"] != (4 * L + 1) * n:
            fail(f"train_lm launch counts {c} != K1 {2 * L * n}, K2 "
                 f"{L * n}, K3 0, K5 {(4 * L + 1) * n}")
        for k in ("k1", "k2", "k5"):
            launches[k] += c[k]
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[18] phase wall {out['wall_s']:.1f}s", flush=True)
    report["files"] = out
    return launches


# the mixture-of-experts cell (phase 19): `small` with 8 experts a layer,
# top 2, capacity factor 1.25 (the JAX package's defaults)
MOE_EXPERTS = 8


def _mm_class(shapes, b, e, c):
    """The MoE piece of a bmm or mm by its operands' shapes: batched over
    E (the expert products), batched over B with an E*C dimension (the
    dispatch and combine einsums), or with an E dimension (the router's
    product) — None for the model's other products."""
    if not shapes:
        return None
    if len(shapes[0]) == 3 and shapes[0][0] == e:
        return "experts"
    if len(shapes[0]) == 3 and shapes[0][0] == b and any(
            e * c in s for s in shapes):
        return "dispatch/combine"
    if any(e in s[-2:] for s in shapes):
        return "routing"
    return None


def _first_product(node):
    """The first bmm or mm under a profiled op (depth first), or None."""
    for child in node.cpu_children:
        if child.name in ("aten::bmm", "aten::mm"):
            return child
        found = _first_product(child)
        if found is not None:
            return found
    return None


def _routing_shape(sh, b, seq, e, c, k) -> bool:
    """A tensor of the routing: [B, S*k, ...] (the token-major slots),
    [B, S, E] / [B, S, k] (probabilities, gates), [B, S, k, E] /
    [B, S, E, C] (one-hots, dispatch, combine), or any with a C
    dimension. Attention's [B, S, H, D] is not one, even at H = E."""
    if len(sh) < 3 or sh[0] != b:
        return False
    return (sh[1] == seq * k or c in sh
            or (len(sh) == 3 and sh[-1] in (e, k))
            or (len(sh) == 4 and sh[-1] in (e, c)))


def _moe_op_class(ev, b, seq, e, c, k):
    """The MoE piece a profiled CPU op belongs to: by its nearest bmm, mm
    or einsum (itself or an ancestor; an einsum by the first product
    under it, since the profiler records no shapes for its operand list)
    — ``dispatch/combine``, ``experts`` or ``routing`` by
    :func:`_mm_class` — else ``experts`` for the activation on [E, B, C,
    F], ``routing`` when it or an ancestor reads a routing tensor
    (:func:`_routing_shape`: softmax, top-k, one-hot, cumsum, the slot
    masks and casts); None for the rest of the step."""
    chain, node = [], ev
    while node is not None:
        chain.append(node)
        node = node.cpu_parent
    for node in chain:
        if node.name in ("aten::bmm", "aten::mm"):
            return _mm_class([tuple(s) for s in node.input_shapes if s],
                             b, e, c)
        if node.name == "aten::einsum":
            prod = _first_product(node)
            return None if prod is None else _mm_class(
                [tuple(s) for s in prod.input_shapes if s], b, e, c)
    for node in chain:
        shapes = [tuple(s) for s in (node.input_shapes or []) if s]
        if any(len(s) == 4 and s[0] == e and s[2] == c for s in shapes):
            return "experts"
        if any(_routing_shape(s, b, seq, e, c, k) for s in shapes):
            return "routing"
    return None


def _moe_pieces(prof, b, seq, e, c, k, attr="self_device_time_total"):
    """{piece: ms} summed over a profile's CPU ops by ``attr`` (their
    kernels' device time; another attribute in a CPU rehearsal), each op
    classed by :func:`_moe_op_class`, the rest under ``rest``."""
    import torch
    out = {"dispatch/combine": 0.0, "experts": 0.0, "routing": 0.0,
           "rest": 0.0}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        us = getattr(ev, attr, 0) or 0
        if us > 0:
            out[_moe_op_class(ev, b, seq, e, c, k) or "rest"] += us / 1e3
    return out


def _moe_profile(cfg, state, batch, seq):
    """2 profiled MoE training steps (CPU and CUDA activity, input shapes
    recorded): (device ms a step by MoE piece, wall ms a step, top
    kernels by device time)."""
    steps = 2
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tony_tpu_torch.parallel.moe import default_capacity
    c = default_capacity(seq, cfg.num_experts, cfg.moe_top_k,
                         cfg.moe_capacity_factor)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        _train_run(cfg, state["params"], steps, seed=1, batch=batch,
                   seq=seq)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    pieces = {n: ms / steps for n, ms in _moe_pieces(
        prof, batch, seq, cfg.num_experts, c, cfg.moe_top_k).items()}
    kernels = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        for kern in getattr(ev, "kernels", []):
            kernels[kern.name] = kernels.get(kern.name, 0) + kern.duration
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return pieces, wall_ms, c, [(n, us / 1e3 / steps) for n, us in top]


def _moe_metrics(cfg, params, tokens):
    """([(aux loss, dropped fraction)] of each layer, the summed aux) of
    one forward with no gradient over ``tokens``:
    ``transformer._moe`` wrapped to record its metrics."""
    import torch
    from tony_tpu_torch.models import transformer as T
    seen, orig = [], T._moe

    def record(h, p, cfg_, lay=None):
        out, m = orig(h, p, cfg_, lay)
        seen.append((float(m.aux_loss), float(m.dropped_fraction)))
        return out, m

    T._moe = record
    try:
        with torch.no_grad():
            _, aux = T.forward(params, tokens, cfg)
    finally:
        T._moe = orig
    return seen, float(aux)


def _moe_card_vs_cpu(out):
    """(19a) `tiny` with 4 experts in f32: lm_loss, the aux loss and every
    gradient leaf on the card against the CPU from one set of weights
    and one batch (remat on, so K1 runs twice a layer)."""
    import numpy as np
    import torch
    from tony_tpu_torch import tree_leaves
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    cfg = T.PRESETS["tiny"].scaled(dtype=torch.float32, num_experts=4)
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(19).randint(
        0, cfg.vocab_size, size=(4, 129)))
    res = {}
    for key, dev in (("cpu", "cpu"), ("card", "cuda")):
        params = _copy_tree(cpu, dev)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        t = toks.to(dev)
        A.reset_launches()
        N.rms_norm_forward.launches = 0
        loss = T.lm_loss(params, {"inputs": t[:, :-1], "targets": t[:, 1:]},
                         cfg)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            _, aux = T.forward(params, t[:, :-1], cfg)
        res[key] = (float(loss.detach()), float(aux),
                    [g.detach().cpu() for g in grads],
                    dict(k1=A.flash_forward.launches,
                         k2=A.flash_backward_fused.launches,
                         k5=N.rms_norm_forward.launches))
    (l_cpu, a_cpu, g_cpu, _), (l_dev, a_dev, g_dev, c) = \
        res["cpu"], res["card"]
    loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
    aux_rel = abs(a_dev - a_cpu) / abs(a_cpu)
    worst = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(g_dev, g_cpu))
    L = cfg.n_layers
    # the no-grad forward adds L K1 and 2L + 1 K5 launches
    want = dict(k1=3 * L, k2=L, k5=(4 * L + 1) + (2 * L + 1))
    print(f"[19a] f32 tiny with 4 experts, card vs CPU: loss {l_dev:.6f} vs "
          f"{l_cpu:.6f} (relative {loss_rel:.2e}, limit 1e-5), aux "
          f"{a_dev:.6f} vs {a_cpu:.6f} (relative {aux_rel:.2e}, limit "
          f"1e-5), worst gradient leaf max error / max entry {worst:.2e} "
          f"(limit 1e-3) over {len(g_cpu)} leaves; card launches {c}",
          flush=True)
    out["card_vs_cpu"] = dict(loss=(l_dev, l_cpu), aux=(a_dev, a_cpu),
                              loss_rel=loss_rel, aux_rel=aux_rel,
                              worst_grad=worst, launches=c)
    if not (loss_rel <= 1e-5 and aux_rel <= 1e-5 and worst <= 1e-3):
        fail("phase 19a: the MoE loss, aux or gradients differ between "
             "the card and the CPU")
    if c != want:
        fail(f"phase 19a: card launches {c} != {want}")


def phase_moe(report, card, serve):
    """[19] Mixture of experts: (a) `tiny` with 4 experts in f32, lm_loss
    and every gradient on the card against the CPU; (b) `small` with 8
    experts in bf16 through train_lm's code path, 20 steps at 16 x 1024
    (step ms, tokens/s, MFU, peak memory, device time by MoE piece, K1,
    K2 and K5 launches, the aux loss and the dropped fraction), then 3
    steps with the fused optimizer (K4 over the tree whose router is f32
    among bf16 leaves); (c) ``train_lm --preset small --num_experts 8``
    itself on a world-1 NCCL mesh with an ep axis, stopped at step 4 and
    resumed from its DCP checkpoint to 8; (d) the ContinuousBatcher on
    the MoE model: 8 greedy requests (tokens/s, and launches, device and
    wall ms a decode step beside the dense model's), then in f32 at
    capacity factor 4.0, where nothing drops, each stream of 16 tokens
    against ``generate`` of its prompt alone (near-tie rule, 1e-4).
    Returns the main paths' launches (b, c and d's bf16 serve)."""
    import statistics
    import tempfile

    import numpy as np
    import torch
    from tony_tpu_torch import train_lm, tree_leaves, tree_map
    from tony_tpu_torch.models import decode as D
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    from tony_tpu_torch.ops import optim as O
    t_phase = time.perf_counter()
    out = {"walls": {}}
    _moe_card_vs_cpu(out)
    out["walls"]["a"] = time.perf_counter() - t_phase

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

    launches = dict(k1=0, k2=0, k4=0, k5=0)

    # (b) training at full width
    steps, batch, seq = 20, 16, 1024
    cfg, params = train_lm.build("small", "cuda", num_experts=MOE_EXPERTS)
    L = cfg.n_layers
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_expert = sum(params["blocks"][n].numel()
                   for n in ("w_gate", "w_down"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    state, losses, walls, _ = _train_run(cfg, params, steps, timed=True,
                                         batch=batch, seq=seq)
    c = counts()
    variants = _check_tc_variants("bf16 small MoE training")
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(walls[-10:]) * 1e3
    tok_s = batch * seq / (step_ms / 1e3)
    fpt = T.train_flops_per_token(cfg, seq)
    mfu = tok_s * fpt / BF16_FLOPS
    tokens = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab_size, size=(batch, seq))).cuda()
    per_layer, aux = _moe_metrics(cfg, state["params"], tokens)
    dropped = statistics.mean(d for _, d in per_layer)
    dense_ms = report.get("train", {}).get("step_ms")
    print(f"[19b] small with {MOE_EXPERTS} experts (top {cfg.moe_top_k}, "
          f"capacity factor {cfg.moe_capacity_factor}) bf16 training on "
          f"{card}: {n_params / 1e6:.1f} M params ({n_expert / 1e6:.1f} M in "
          f"experts), {steps} steps of {batch}x{seq}; step {step_ms:.2f} ms "
          f"(median of the last 10; dense small {_ms(dense_ms)} in phase "
          f"9), {tok_s:,.0f} tokens/s, MFU {mfu:.4f} ({fpt / 1e6:.1f} "
          f"MFLOP/token vs 989 TFLOP/s), peak memory {peak / 2**30:.2f} "
          f"GiB; losses {losses[0]:.4f} -> {losses[-1]:.4f}; aux loss "
          f"{aux:.4f} (sum over {L} layers), dropped fraction "
          f"{dropped:.4f} (mean over layers; "
          f"{[round(d, 4) for _, d in per_layer]}); launches {c}",
          flush=True)
    out["train"] = dict(step_ms=step_ms, walls=walls, tokens_per_s=tok_s,
                        mfu=mfu, flops_per_token=fpt, peak_bytes=peak,
                        losses=losses, launches=c, variants=variants,
                        aux=aux, per_layer=per_layer, dropped=dropped,
                        params=n_params, expert_params=n_expert)
    if not all(abs(x) < float("inf") for x in losses):
        fail("phase 19b: a training loss is not finite")
    if c["k1"] != 2 * L * steps or c["k2"] != L * steps or \
            c["k3a"] or c["k3b"] or c["k5"] != (4 * L + 1) * steps:
        fail(f"phase 19b: launch counts {c} != K1 {2 * L * steps}, K2 "
             f"{L * steps}, K3 0, K5 {(4 * L + 1) * steps}")
    for k in ("k1", "k2", "k5"):
        launches[k] += c[k]
    t0 = time.perf_counter()
    pieces, prof_ms, cap, top = _moe_profile(cfg, state, batch, seq)
    total = sum(pieces.values())
    print(f"[19b] 2 profiled MoE steps ({time.perf_counter() - t0:.1f}s with "
          f"the events' analysis): device {total:.2f} ms a step "
          f"(wall {prof_ms:.2f} ms under the profiler), by piece: "
          + ", ".join(f"{n} {ms:.2f} ms" for n, ms in pieces.items())
          + f" (capacity {cap} a batch row); top kernels: "
          + "; ".join(f"{n[:40]} {ms:.2f} ms" for n, ms in top), flush=True)
    out["profile"] = dict(pieces_ms=pieces, device_ms=total,
                          wall_ms=prof_ms, capacity=cap, top=top)
    zero_counts()
    _, fl, _, _ = _train_run(cfg, state["params"], 3, fused=True,
                             batch=batch, seq=seq)
    c = counts()
    n_leaves = len(tree_leaves(state["params"]))
    print(f"[19b] 3 steps with the fused optimizer over the MoE tree (router "
          f"f32 among bf16 leaves): K4 launches {c['k4']}, losses "
          f"{[round(x, 4) for x in fl]}", flush=True)
    out["fused"] = dict(losses=fl, launches=c)
    if c["k4"] != 3 * n_leaves or not all(abs(x) < float("inf")
                                          for x in fl):
        fail(f"phase 19b: fused run K4 launches {c['k4']} != 3 x "
             f"{n_leaves} leaves, or a loss is not finite")
    if state["params"]["blocks"]["router"].dtype != torch.float32:
        fail("phase 19b: the router is no longer f32")
    for k in ("k1", "k2", "k4", "k5"):
        launches[k] += c[k]
    del state
    out["walls"]["b"] = time.perf_counter() - t_phase - sum(
        out["walls"].values())

    # (c) train_lm itself, with a DCP checkpoint and a resume
    common = ["--preset", "small", "--num_experts", str(MOE_EXPERTS),
              "--batch_size", str(batch), "--seq_len", str(seq)]
    with tempfile.TemporaryDirectory() as tmp:
        runs = [["--steps", "4", "--ckpt_dir", tmp, "--ckpt_every", "4"],
                ["--steps", "8", "--ckpt_dir", tmp, "--ckpt_every", "4"]]
        zero_counts()
        t0 = time.perf_counter()
        done, mesh_lines = [], []
        for i, extra in enumerate(runs):
            if i == 1:
                os.environ["ATTEMPT_NUMBER"] = "1"
            try:
                rc, lines = _train_lm_cli(common + extra, {"ep": -1})
            finally:
                os.environ.pop("ATTEMPT_NUMBER", None)
            last = [x for x in lines if x.startswith("done: final loss ")]
            mesh_lines += [x for x in lines if " mesh=" in x]
            done.append(last[0] if last else None)
            if rc != 0 or not last or not abs(
                    float(last[0].split()[-1])) < float("inf"):
                fail(f"phase 19c: train_lm {' '.join(extra)}: exit {rc}, "
                     f"last lines {lines[-3:]}")
            if i == 1 and any(x.startswith("step 0 ") for x in lines):
                fail("phase 19c: the resumed run did not start at its "
                     "checkpoint's step")
        c = counts()
        _check_tc_variants("bf16 train_lm --num_experts")
        committed = sorted(os.listdir(tmp))
    n = 8
    print(f"[19c] python -m tony_tpu_torch.train_lm {' '.join(common)} on "
          f"{card}, the sharded step on a world-1 NCCL mesh "
          f"({mesh_lines[0].split(' mesh=')[1] if mesh_lines else '?'}): 4 "
          f"steps, then resumed from its DCP checkpoint to 8, in "
          f"{time.perf_counter() - t0:.1f}s: {done}; checkpoints "
          f"{committed}; launches {c}", flush=True)
    out["cli"] = dict(done=done, committed=committed, launches=c,
                      mesh=mesh_lines)
    if committed != ["step_1", "step_4", "step_8"]:
        fail(f"phase 19c: train_lm's checkpoints {committed}")
    if not mesh_lines or "'ep': 1" not in mesh_lines[0]:
        fail(f"phase 19c: no ep axis in train_lm's mesh line {mesh_lines}")
    if c["k1"] != 2 * L * n or c["k2"] != L * n or c["k3a"] or \
            c["k3b"] or c["k5"] != (4 * L + 1) * n:
        fail(f"phase 19c: launch counts {c} != K1 {2 * L * n}, K2 "
             f"{L * n}, K3 0, K5 {(4 * L + 1) * n}")
    for k in ("k1", "k2", "k5"):
        launches[k] += c[k]
    out["walls"]["c"] = time.perf_counter() - t_phase - sum(
        out["walls"].values())

    # (d) serving the MoE model (19b's trained weights): the batcher,
    # greedy, 8 requests
    prompts, budgets = serve["prompts"][:8], serve["budgets"][:8]

    def batcher(p, c_):
        return S.ContinuousBatcher(p, c_, batch=8, max_len=1024, chunk=8,
                                   pipeline=True)

    t_d = time.perf_counter()
    b = batcher(params, cfg)
    torch.cuda.synchronize()
    zero_counts()
    S.CALL_COUNTS.clear()
    t0 = time.perf_counter()
    outs = b.serve(prompts, budgets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    _check_tc_variants("the bf16 MoE serve")
    k1_want, k5_want, admits = _expected_launches(cfg, None, 0)
    n_tok = sum(len(o) for o in outs)
    if [len(o) for o in outs] != budgets or not all(
            0 <= t < cfg.vocab_size for o in outs for t in o):
        fail("phase 19d: a request did not get its budget of in-vocabulary "
             "tokens")
    if c["k1"] != k1_want or c["k5"] != k5_want or c["k2"]:
        fail(f"phase 19d: launches {c} != K1 {k1_want}, K5 {k5_want} "
             f"({admits} admissions), K2 0")
    launches["k1"] += c["k1"]
    launches["k5"] += c["k5"]
    t_step = time.perf_counter()
    moe_step = _per_step(batcher(params, cfg), prompts, budgets)
    # phase 14g's greedy per-step figures are the dense model's on these
    # 8 requests and this batcher; measured here when phase 14 did not run
    dense_step = report.get("serving_host", {}).get("per_step", {}).get(
        "greedy") or _per_step(batcher(serve["params"], serve["cfg"]),
                               prompts, budgets)
    print(f"[19d] small with {MOE_EXPERTS} experts bf16 on {card}: 8 "
          f"requests, {n_tok} tokens in {wall:.3f}s ({n_tok / wall:.1f} "
          f"tokens/s), K1 {c['k1']} and K5 {c['k5']} launches over "
          f"{admits} admissions; per decode step (admission included): "
          f"MoE {moe_step['launches']:.1f} launches, device "
          f"{moe_step['device_ms']:.3f} ms, wall {moe_step['wall_ms']:.3f} "
          f"ms; dense small (phase 5's model) {dense_step['launches']:.1f} "
          f"launches, device {dense_step['device_ms']:.3f} ms, wall "
          f"{dense_step['wall_ms']:.3f} ms (serve {t_step - t_d:.1f}s, "
          f"profiled per-step serves {time.perf_counter() - t_step:.1f}s)",
          flush=True)
    out["serve"] = dict(tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                        launches=c, per_step=moe_step,
                        dense_per_step=dense_step)
    # f32 at capacity factor 4.0 (no drops, whatever the padding):
    # every stream of 16 tokens against generate of its prompt alone
    t_hold = time.perf_counter()
    cfg32 = cfg.scaled(dtype=torch.float32, moe_capacity_factor=4.0)
    params32 = tree_map(lambda v: v.float(), params)
    got = batcher(params32, cfg32).serve(prompts, 16)
    solo = [D.generate(params32, torch.tensor([p], device="cuda"), cfg32,
                       16).tokens[0, len(p):].tolist() for p in prompts]
    equal, diffs = _near_ties("phase 19d", params32, cfg32, prompts, got,
                              solo, 1e-4)
    print(f"[19d] f32, capacity factor 4.0: the batcher's 8 streams of 16 "
          f"tokens vs generate per request: {equal}/8 identical, first "
          f"differences at near-ties (request, step, logit gap) {diffs} "
          f"({time.perf_counter() - t_hold:.1f}s)", flush=True)
    out["serve"]["f32_vs_generate"] = dict(equal=equal, diffs=diffs)
    out["walls"]["d"] = time.perf_counter() - t_phase - sum(
        out["walls"].values())
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[19] phase wall {out['wall_s']:.1f}s ("
          + ", ".join(f"19{k} {v:.1f}s" for k, v in out["walls"].items())
          + ")", flush=True)
    report["moe"] = out
    return launches


# context parallelism: the simulated ranks of phase 20 and small's widths
CP = 4
CP_SHAPE = (4, 4096, 8, 64)


def _cp_inputs(kv, seed):
    """q, k, v and an output cotangent at CP_SHAPE in bf16 (k, v with
    ``kv`` heads)."""
    import torch
    b, s, h, d = CP_SHAPE
    q, k, v = _qkv(b, s, h, kv, d, torch.bfloat16, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 7919)
    do = torch.randn(q.shape, device="cuda", generator=g).to(torch.bfloat16)
    return q, k, v, do


def _cp_plain(q, k, v, do):
    """The plain full-sequence causal attention of the same bf16 inputs
    in f32: (o, dq, dk, dv)."""
    from tony_tpu_torch.ops import attention as A
    f32 = [x.float() for x in (q, k, v)]
    o, lse = A._dense_with_lse(*f32, causal=True, scale=None)
    return (o,) + A._dense_backward(*f32, o, lse, do.float(), None,
                                    causal=True, scale=None)


def _cp_emulated(strategy, q, k, v, do):
    """``strategy`` ("ring" or "ulysses") over CP simulated ranks on the
    card, each holding 1/CP of the sequence, the shared hop and layout
    functions of the distributed bodies: (o, dq, dk, dv) of the whole
    sequence. Ulysses expands K/V whose heads do not split over CP, as
    the model does."""
    import torch
    from tony_tpu_torch.parallel import ring_attention as R
    from tony_tpu_torch.parallel import ulysses as U
    ins = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    qs, ks, vs = ([c.contiguous() for c in x.chunk(CP, dim=1)]
                  for x in ins)
    if strategy == "ring":
        outs = R.ring_attention_emulated(qs, ks, vs, causal=True)
    else:
        pairs = [R.expand_kv_unless(a, b, q.shape[2], CP)
                 for a, b in zip(ks, vs)]
        outs = U.ulysses_attention_emulated(qs, [p[0] for p in pairs],
                                            [p[1] for p in pairs],
                                            causal=True)
    o = torch.cat(outs, dim=1)
    return (o.detach(),) + torch.autograd.grad(o, ins, do)


class _CpProbe:
    """While active: the q shapes of K1's launches through the ring and
    Ulysses modules' attention calls, and how many backward launches got
    a non-zero lse cotangent."""

    def __enter__(self):
        from tony_tpu_torch.ops import attention as A
        from tony_tpu_torch.parallel import ring_attention as R
        self.shapes, self.dlse, self.bwd = [], 0, 0
        self._saved = (R.flash_attention_with_lse, R.flash_attention,
                       A._bwd_inputs)

        def with_lse(q, *a, **kw):
            self.shapes.append(tuple(q.shape))
            return self._saved[0](q, *a, **kw)

        def plain(q, *a, **kw):
            self.shapes.append(tuple(q.shape))
            return self._saved[1](q, *a, **kw)

        def bwd_inputs(q, k, v, o, lse, do, dlse):
            self.bwd += 1
            if dlse is not None and bool((dlse != 0).any()):
                self.dlse += 1
            return self._saved[2](q, k, v, o, lse, do, dlse)

        R.flash_attention_with_lse, R.flash_attention = with_lse, plain
        A._bwd_inputs = bwd_inputs
        return self

    def __exit__(self, *exc):
        from tony_tpu_torch.ops import attention as A
        from tony_tpu_torch.parallel import ring_attention as R
        (R.flash_attention_with_lse, R.flash_attention,
         A._bwd_inputs) = self._saved


def _cp_attention_checks(out):
    """(20a, 20b) the ring and Ulysses over CP simulated ranks at
    CP_SHAPE bf16 causal, MHA and kv_heads 2: o and the gradients against
    the plain full-sequence attention, K1/K2 launches, the chunk shapes,
    the lse cotangents, and the time of a forward and backward beside
    the unsplit kernels'. Returns the launches (k1, k2)."""
    import torch
    from tony_tpu_torch.ops import attention as A
    lo, _ = _k1_limits()[torch.bfloat16]
    b, s, h, d = CP_SHAPE
    sl = s // CP
    # K1 and K2 launches a strategy makes for causal attention over CP
    # ranks: the ring 4 diagonal + 6 full hops (6 future hops launch
    # nothing), Ulysses one whole-sequence call a rank
    want = {"ring": CP * (CP + 1) // 2, "ulysses": CP}
    shape = {"ring": (b, sl, h, d), "ulysses": (b, s, h // CP, d)}
    # backward launches whose lse feeds the merge: all but rank 0's
    # single hop (the ring), none (Ulysses)
    want_dlse = {"ring": want["ring"] - 1, "ulysses": 0}
    total = dict(k1=0, k2=0)
    rows = {}
    for kv in (h, 2):
        q, k, v, do = _cp_inputs(kv, seed=2000 + kv)
        ref = _cp_plain(q, k, v, do)
        for strategy, tag in (("ring", "20a"), ("ulysses", "20b")):
            A.reset_launches()
            with _CpProbe() as probe:
                got = _cp_emulated(strategy, q, k, v, do)
                torch.cuda.synchronize()
            c = dict(k1=A.flash_forward.launches,
                     k2=A.flash_backward_fused.launches,
                     k3=A.flash_backward_dq.launches
                     + A.flash_backward_dkv.launches)
            _check_tc_variants(f"phase {tag} {strategy} kv={kv}")
            errs = {}
            for name, g, r in zip(("o", "dq", "dk", "dv"), got, ref):
                err = (g.float() - r).abs().max().item()
                lim = lo if name == "o" else 2e-2 * r.abs().max().item()
                errs[name] = (err, lim)
            kw = dict(causal=True, scale=d ** -0.5, window=None)

            def unsplit():
                o, lse = A.flash_forward(q, k, v, **kw)
                A.flash_backward_fused(q, k, v, o, lse, do, **kw)

            split_ms = time_ms(lambda: _cp_emulated(strategy, q, k, v, do),
                               iters=5)
            whole_ms = time_ms(unsplit, iters=5)
            kv_seen = sorted(set(probe.shapes))
            print(f"[{tag}] {strategy} over {CP} simulated ranks, q "
                  f"{list(CP_SHAPE)} k/v kv_heads {kv} bf16 causal: K1 "
                  f"{c['k1']} and K2 {c['k2']} launches (want {want[strategy]}"
                  f" each) at q {kv_seen}, {probe.dlse} of {probe.bwd} "
                  f"backward launches with a non-zero lse cotangent; max abs "
                  f"err vs the plain full-sequence attention: "
                  + ", ".join(f"{n} {e:.3e} (limit {lim:.3e})"
                              for n, (e, lim) in errs.items())
                  + f"; forward + backward {split_ms:.3f} ms (CUDA events, "
                  f"every rank on this card) against the unsplit K1 + K2 "
                  f"{whole_ms:.3f} ms", flush=True)
            rows[f"{strategy}_kv{kv}"] = dict(
                launches=c, shapes=kv_seen, dlse=probe.dlse,
                backward=probe.bwd, errs=errs, ms=split_ms,
                unsplit_ms=whole_ms)
            for n, (e, lim) in errs.items():
                if not e <= lim:
                    fail(f"phase {tag}: {strategy} kv={kv} {n} err {e:.3e} "
                         f"> {lim:.3e} against the plain attention")
            if c["k1"] != want[strategy] or c["k2"] != want[strategy] or \
                    c["k3"]:
                fail(f"phase {tag}: {strategy} kv={kv} launches {c}, want K1 "
                     f"= K2 = {want[strategy]}, K3 0")
            if kv_seen != [shape[strategy]]:
                fail(f"phase {tag}: {strategy} K1 at {kv_seen}, want "
                     f"{shape[strategy]}")
            if probe.dlse != want_dlse[strategy]:
                fail(f"phase {tag}: {strategy} {probe.dlse} backward launches "
                     f"with an lse cotangent, want {want_dlse[strategy]}")
            total["k1"] += c["k1"]
            total["k2"] += c["k2"]
        del q, k, v, do, ref, got
        torch.cuda.empty_cache()
    out["attention"] = rows
    return total


def _policy_step(cfg, params, tokens):
    """(loss, grad norm) of one lm_loss step of ``cfg``'s remat policy on
    ``tokens`` (the gradient of every leaf; nothing updated)."""
    import torch
    from tony_tpu_torch import tree_leaves
    from tony_tpu_torch.models import transformer as T
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = T.lm_loss(params, {"tokens": tokens}, cfg)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    return float(loss.detach()), float(norm)


def _policy_device_ms(cfg, params, steps=2):
    """Device milliseconds a training step over ``steps`` profiled steps
    (None if the profiler recorded none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _train_run(cfg, _copy_tree(params, "cuda"), steps, seed=1)
        torch.cuda.synchronize()
    dev, _ = _device_times(prof)
    total = sum(dev.values())
    return total / steps / 1e3 if total else None


def phase_cp(report, card):
    """[20] Context parallelism on one card: (a) the ring and (b) Ulysses
    over 4 simulated ranks at small's widths, [4, 4096, 8, 64] bf16
    causal, MHA and kv_heads 2 — o and dq/dk/dv against the plain
    full-sequence attention at phase 3's and 6's bf16 limits, K1 and K2
    launches a hop (the ring: 4 diagonal and 6 full chunks, each backward
    but rank 0's single hop with a non-zero lse cotangent), the chunk
    shapes, and the time beside the unsplit kernels; (c) the `small`
    training step at 16 x 1024 under the remat policies "full", "dots"
    and "attn": loss and grad norm of one step against "full" (1e-3
    relative, phase 9's limit), K1 launches a step (16, 16, 8), step ms,
    device ms a step and peak memory; (d) ``python -m
    tony_tpu_torch.train_lm --preset small --cp_strategy ring`` and
    ``ulysses``, 3 steps each on a world-1 NCCL mesh ``{"cp": 1}``.
    Several ranks of cp need a host with more cards. Returns the
    launches (K1, K2, K5)."""
    import statistics

    import numpy as np
    import torch
    from tony_tpu_torch import train_lm
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    t_phase = time.perf_counter()
    out = {"walls": {}}
    launches = _cp_attention_checks(out)
    launches["k5"] = 0
    out["walls"]["ab"] = time.perf_counter() - t_phase

    def zero_counts():
        A.reset_launches()
        N.rms_norm_forward.launches = 0

    def counts():
        return dict(k1=A.flash_forward.launches,
                    k2=A.flash_backward_fused.launches,
                    k3=A.flash_backward_dq.launches
                    + A.flash_backward_dkv.launches,
                    k5=N.rms_norm_forward.launches)

    # (c) the remat policies at full width
    steps, batch, seq = 6, 16, 1024
    cfg, params = train_lm.build("small", "cuda")
    L = cfg.n_layers
    tokens = torch.from_numpy(np.random.RandomState(20).randint(
        0, cfg.vocab_size, size=(batch, seq + 1))).cuda()
    k1_step = {"full": 2 * L, "dots": 2 * L, "attn": L}
    pol = {}
    for policy in ("full", "dots", "attn"):
        pcfg = cfg.scaled(remat_policy=policy)
        zero_counts()
        loss, norm = _policy_step(pcfg, params, tokens)
        c1 = counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        _, losses, walls, _ = _train_run(pcfg, _copy_tree(params, "cuda"),
                                         steps, timed=True)
        c = counts()
        peak = torch.cuda.max_memory_allocated()
        _check_tc_variants(f"phase 20c remat {policy!r}")
        dev_ms = _policy_device_ms(pcfg, params)
        pol[policy] = dict(loss=loss, grad_norm=norm, parity_launches=c1,
                           launches=c, peak_bytes=peak, losses=losses,
                           step_ms=statistics.median(walls[-3:]) * 1e3,
                           device_ms=dev_ms)
        if c1["k1"] != k1_step[policy] or c1["k2"] != L or \
                c["k1"] != k1_step[policy] * steps or c["k2"] != L * steps \
                or c["k3"]:
            fail(f"phase 20c: remat {policy!r} launches {c1} (one step), {c} "
                 f"({steps} steps), want K1 {k1_step[policy]} and K2 {L} a "
                 f"step, K3 0")
        if not (2 * L + 1) * steps <= c["k5"] <= (4 * L + 1) * steps:
            fail(f"phase 20c: remat {policy!r} K5 launches {c['k5']}")
        if not all(abs(x) < float("inf") for x in losses):
            fail(f"phase 20c: remat {policy!r} a loss is not finite")
        for k in ("k1", "k2", "k5"):
            launches[k] += c1[k] + c[k]
        torch.cuda.empty_cache()
    full = pol["full"]
    for policy, r in pol.items():
        r["loss_rel"] = abs(r["loss"] - full["loss"]) / abs(full["loss"])
        r["norm_rel"] = (abs(r["grad_norm"] - full["grad_norm"])
                         / abs(full["grad_norm"]))
        print(f"[20c] small bf16 {batch}x{seq} remat {policy!r} on {card}: "
              f"loss {r['loss']:.6f}, grad norm {r['grad_norm']:.6f} "
              f"(relative to 'full' {r['loss_rel']:.2e}, {r['norm_rel']:.2e};"
              f" limit 1e-3); K1 {r['parity_launches']['k1']} and K2 "
              f"{r['parity_launches']['k2']} a step; {steps} steps: step "
              f"{r['step_ms']:.2f} ms (median of the last 3), device "
              f"{_ms(r['device_ms'])} a step (2 profiled), peak memory "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; launches {r['launches']}",
              flush=True)
        if not (r["loss_rel"] <= 1e-3 and r["norm_rel"] <= 1e-3):
            fail(f"phase 20c: remat {policy!r} loss or grad norm differs "
                 f"from 'full'")
    out["remat"] = pol
    del params
    torch.cuda.empty_cache()
    out["walls"]["c"] = time.perf_counter() - t_phase - sum(
        out["walls"].values())

    # (d) train_lm --cp_strategy on a world-1 mesh with a cp axis
    out["cli"] = {}
    n = 3
    for strategy in ("ring", "ulysses"):
        zero_counts()
        t0 = time.perf_counter()
        rc, lines = _train_lm_cli(
            ["--preset", "small", "--steps", str(n), "--batch_size",
             str(batch), "--seq_len", str(seq), "--cp_strategy", strategy],
            {"cp": -1})
        c = counts()
        _check_tc_variants(f"train_lm --cp_strategy {strategy}")
        done = [x for x in lines if x.startswith("done: final loss ")]
        mesh_lines = [x for x in lines if " mesh=" in x]
        print(f"[20d] python -m tony_tpu_torch.train_lm --preset small "
              f"--cp_strategy {strategy} on {card}, NCCL world 1 "
              f"({mesh_lines[0].split(' mesh=')[1] if mesh_lines else '?'}):"
              f" {n} steps in {time.perf_counter() - t0:.1f}s: "
              f"{done[0] if done else None}; launches {c}", flush=True)
        out["cli"][strategy] = dict(done=done, mesh=mesh_lines, launches=c)
        if rc != 0 or not done or not abs(float(done[0].split()[-1])) < \
                float("inf"):
            fail(f"phase 20d: train_lm --cp_strategy {strategy}: exit {rc}, "
                 f"last lines {lines[-3:]}")
        if not mesh_lines or "'cp': 1" not in mesh_lines[0]:
            fail(f"phase 20d: no cp axis in train_lm's mesh line "
                 f"{mesh_lines}")
        if c["k1"] != 2 * L * n or c["k2"] != L * n or c["k3"] or \
                c["k5"] != (4 * L + 1) * n:
            fail(f"phase 20d: launch counts {c} != K1 {2 * L * n}, K2 "
                 f"{L * n}, K3 0, K5 {(4 * L + 1) * n}")
        for k in ("k1", "k2", "k5"):
            launches[k] += c[k]
    out["walls"]["d"] = time.perf_counter() - t_phase - sum(
        out["walls"].values())
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[20] phase wall {out['wall_s']:.1f}s ("
          + ", ".join(f"20{k} {v:.1f}s" for k, v in out["walls"].items())
          + "); several cp ranks need a host with more cards", flush=True)
    report["cp"] = out
    return launches


PP_STEPS = 2
PP_BATCH, PP_SEQ = 16, 1024
PP_PRESET, PP_DEVICE = "small", "cuda"


def _pp_counts():
    """(zero, read) of K1, K2, K3 and K5's launch counts."""
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N

    def zero():
        A.reset_launches()
        N.rms_norm_forward.launches = 0

    def read():
        return dict(k1=A.flash_forward.launches,
                    k2=A.flash_backward_fused.launches,
                    k3=A.flash_backward_dq.launches
                    + A.flash_backward_dkv.launches,
                    k5=N.rms_norm_forward.launches)
    return zero, read


def _pp_expected(L, pp, m, schedule):
    """K1, K2, K5 launches of one pipelined `small` step (remat "full"):
    GPipe runs each microbatch's blocks forward and their remat
    recompute (K1 2 a layer, K5 4 a layer) and the head once on the
    whole batch; 1F1B adds a forward tick on every stage but the last
    (which folds it into its backward tick), and the last stage's head
    runs a microbatch at a time."""
    if schedule == "gpipe":
        return dict(k1=2 * L * m, k2=L * m, k5=4 * L * m + 1)
    ls = L // pp
    return dict(k1=m * (3 * (L - ls) + 2 * ls), k2=L * m,
                k5=m * (6 * (L - ls) + 4 * ls + 1))


def _pp_tokens(vocab, device):
    import numpy as np
    import torch
    return torch.from_numpy(np.random.RandomState(21).randint(
        0, vocab, size=(PP_BATCH, PP_SEQ + 1))).to(device)


def _pp_step_fn(cfg, mesh, schedule):
    """The train step a user builds for ``schedule`` on ``mesh`` (a dict
    of sizes: every rank emulated on this card)."""
    from tony_tpu_torch.models import train as TR
    from tony_tpu_torch.models import transformer as T
    opt = TR.default_optimizer(lr=3e-4, total_steps=1000)
    if schedule == "1f1b":
        step = TR.make_train_step(None, opt, value_and_grad_fn=lambda p, b:
                                  T.lm_value_and_grad(p, b, cfg, mesh))
    else:
        step = TR.make_train_step(lambda p, b: T.lm_loss(p, b, cfg, mesh),
                                  opt)
    return step, opt


def _pp_in_slice(out, card, cfg, params, tokens):
    """21a: GPipe and 1F1B over pp 2 (M 4) and pp 4 (M 8) simulated
    ranks; returns the launches and the pp-2 1F1B loss."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    from tony_tpu_torch.models import train as TR
    zero, read = _pp_counts()
    L = cfg.n_layers
    batch = {"tokens": tokens}
    zero()
    ref_loss, ref_norm = _policy_step(cfg, params, tokens)
    torch.cuda.synchronize()
    ref = dict(loss=ref_loss, grad_norm=ref_norm, launches=read())
    out["unpipelined"] = ref
    launches = dict(k1=0, k2=0, k5=0)
    runs = {}
    for pp, m in ((2, 4), (4, 8)):
        for schedule in ("gpipe", "1f1b"):
            tag = f"pp{pp}_{schedule}"
            step, opt = _pp_step_fn(cfg, {"pp": pp}, schedule)
            state = TR.init_state(_copy_tree(params, "cuda"), opt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero()
            state, mtr = step(state, batch)
            loss, norm = float(mtr["loss"]), float(mtr["grad_norm"])
            c1 = read()
            peak = torch.cuda.max_memory_allocated()
            _check_tc_variants(f"phase 21a {tag}")
            walls = []
            zero()
            for _ in range(PP_STEPS):
                t0 = time.perf_counter()
                state, mtr = step(state, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            c = read()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, mtr = step(state, batch)
                torch.cuda.synchronize()
            dev, _ = _device_times(prof)
            dev_ms = sum(dev.values()) / 1e3 if dev else None
            want = _pp_expected(L, pp, m, schedule)
            r = dict(pp=pp, microbatches=m, loss=loss, grad_norm=norm,
                     loss_rel=abs(loss - ref_loss) / abs(ref_loss),
                     norm_rel=abs(norm - ref_norm) / abs(ref_norm),
                     launches=c1, want=want, peak_bytes=peak,
                     step_ms=statistics.median(walls) * 1e3,
                     device_ms=dev_ms)
            runs[tag] = r
            print(f"[21a] small bf16 {PP_BATCH}x{PP_SEQ} {schedule} over "
                  f"pp={pp} simulated ranks (M={m}) on {card}: loss "
                  f"{loss:.6f} vs unpipelined {ref_loss:.6f} (relative "
                  f"{r['loss_rel']:.2e}, limit 1e-3), grad norm {norm:.6f} "
                  f"vs {ref_norm:.6f} ({r['norm_rel']:.2e}, limit 1e-2); a "
                  f"step: K1 {c1['k1']}, K2 {c1['k2']}, K5 {c1['k5']} "
                  f"(predicted {want['k1']}, {want['k2']}, {want['k5']}), "
                  f"wall {r['step_ms']:.2f} ms (median of {PP_STEPS}), "
                  f"device {_ms(dev_ms)}; peak memory "
                  f"{peak / 2**30:.2f} GiB", flush=True)
            if {k: c1[k] for k in want} != want or c1["k3"]:
                fail(f"phase 21a {tag}: launches {c1}, want {want} and K3 0")
            if any(c[k] != want[k] * PP_STEPS for k in want):
                fail(f"phase 21a {tag}: {PP_STEPS} steps launched {c}")
            if not (r["loss_rel"] <= 1e-3 and r["norm_rel"] <= 1e-2):
                fail(f"phase 21a {tag}: loss or grad norm off the "
                     f"unpipelined step's")
            for k in launches:
                launches[k] += c1[k] + c[k]
            del state
            torch.cuda.empty_cache()
    out["in_slice"] = runs
    return launches, runs["pp2_1f1b"]["loss"]


def _pp_gang(stage, ports, steps, path, preset=PP_PRESET,
             device=PP_DEVICE):
    """One stage gang of 21b, run in a process of its own: half of
    ``preset``'s blocks (stage 0 the first) behind a
    ``CrossSlicePipeline`` over TONYC1 on loopback, stage 0 embedding,
    stage 1 holding the head; ``steps`` value-and-grad calls with the
    default (overlapped) transport, then ``steps`` with
    ``sync_transport=True``. Writes its measurements as JSON to
    ``path``."""
    sys.path.insert(0, HERE)
    import statistics

    import torch
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    from tony_tpu_torch import train_lm
    from tony_tpu_torch.channels.registry import open_stage_links
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.parallel.pipeline import CrossSlicePipeline
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    zero, read = _pp_counts()
    cfg, params = train_lm.build(preset, device)
    half = cfg.n_layers // 2
    blocks = {k: v[stage * half:(stage + 1) * half].contiguous()
              for k, v in params["blocks"].items()}
    reg = MetricsRegistry()
    links = open_stage_links(
        stage=stage, num_stages=2, hub_port=ports[stage],
        prev=f"127.0.0.1:{ports[0]}" if stage else "",
        next="" if stage else f"127.0.0.1:{ports[1]}", registry=reg)
    tokens = _pp_tokens(cfg.vocab_size, device)
    m = 4
    mb = PP_BATCH // m
    kw = {}
    if stage == 0:
        with torch.no_grad():
            x = params["embed"][tokens[:, :-1].long()].to(cfg.dtype)
        kw["microbatches"] = x.reshape(m, mb, PP_SEQ, cfg.d_model)
    else:
        kw["head_params"] = {k: params[k] for k in ("final_norm",
                                                    "lm_head")}
        kw["head_batches"] = tokens[:, 1:].reshape(m, mb, PP_SEQ)
    out = {"stage": stage, "layers": cfg.n_layers,
           "hop_bytes": mb * PP_SEQ * cfg.d_model
           * torch.empty((), dtype=cfg.dtype).element_size()}
    wire = reg.counter("tony_channel_bytes_total",
                       channel="act" if stage == 0 else "grad",
                       direction="send")
    try:
        for serial in (False, True):
            pipe = CrossSlicePipeline(
                T._stage_fn(cfg, None, with_aux=False), links,
                loss_head=T._loss_head(cfg) if stage else None,
                sync_transport=serial, registry=reg, device=device)
            walls, bubbles, losses, counts = [], [], [], []
            for i in range(steps):
                sync()
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                zero()
                sent0 = wire.value
                t0 = time.perf_counter()
                loss, grads, _, _ = pipe.value_and_grad(
                    blocks, num_microbatches=m, **kw)
                sync()
                walls.append(time.perf_counter() - t0)
                bubbles.append(pipe.last_step["bubble"])
                counts.append(read())
                if loss is not None:
                    losses.append(float(loss))
                out.setdefault("wire_bytes", wire.value - sent0)
            pipe.close()
            out["sync" if serial else "overlap"] = dict(
                step_ms=statistics.median(walls[1:]) * 1e3,
                walls_ms=[w * 1e3 for w in walls], bubble=bubbles,
                peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0,
                launches=counts, losses=losses)
    finally:
        links.close()
    with open(path, "w") as f:
        json.dump(out, f)


def _pp_cross_slice(out, card, loss_1f1b):
    """21b: the cross-slice 1F1B as two processes on the one card;
    returns the launches of both gangs' overlapped and synchronous
    calls."""
    import socket
    import statistics
    steps = 3
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    paths = [os.path.join(HERE, "build", f"pp_gang{s}.json")
             for s in (0, 1)]
    for p in paths:
        if os.path.exists(p):
            os.remove(p)
    env = dict(os.environ, PYTHONPATH=HERE)
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke as c; c._pp_gang({s}, "
         f"{ports}, {steps}, {paths[s]!r}, {PP_PRESET!r}, "
         f"{PP_DEVICE!r})"], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        fail("phase 21b: a stage gang failed: "
             + " | ".join(log[-1500:] for log in logs))
    gangs = [json.load(open(p)) for p in paths]
    out["cross_slice"] = gangs
    launches = dict(k1=0, k2=0, k5=0)
    half = gangs[0]["layers"] // 2
    # stage 0: a forward tick and a backward tick (recompute + remat) a
    # microbatch over its 4 blocks; stage 1: the backward tick and its
    # head a microbatch
    want = [dict(k1=4 * 3 * half, k2=4 * half, k5=4 * 6 * half),
            dict(k1=4 * 2 * half, k2=4 * half, k5=4 * (4 * half + 1))]
    for g in gangs:
        s = g["stage"]
        for mode in ("overlap", "sync"):
            r = g[mode]
            for c in r["launches"]:
                if {k: c[k] for k in want[s]} != want[s] or c["k3"]:
                    fail(f"phase 21b stage {s} {mode}: launches {c}, want "
                         f"{want[s]}")
                for k in launches:
                    launches[k] += c[k]
    last = gangs[1]
    rel = abs(last["overlap"]["losses"][0] - loss_1f1b) / abs(loss_1f1b)
    out["cross_slice_loss_rel"] = rel
    for g in gangs:
        for mode in ("overlap", "sync"):
            r = g[mode]
            print(f"[21b] cross-slice 1F1B stage {g['stage']} "
                  f"({'sync_transport' if mode == 'sync' else 'overlapped'}"
                  f"), small bf16 {PP_BATCH}x{PP_SEQ}, M=4, two processes "
                  f"time-slicing one {card}: step {r['step_ms']:.2f} ms "
                  f"(median of the last {steps - 1}), "
                  f"tony_pipeline_bubble_fraction "
                  f"{statistics.median(r['bubble']):.4f}, peak memory "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB, wire "
                  f"{g['wire_bytes'] / 2**20:.1f} MiB a step sent", flush=True)
    print(f"[21b] stage 1 loss {last['overlap']['losses'][0]:.6f} vs 21a's "
          f"pp=2 1F1B {loss_1f1b:.6f}: relative {rel:.2e} (limit 1e-3); "
          f"overlapped vs sync step (stage 0): "
          f"{gangs[0]['overlap']['step_ms']:.2f} vs "
          f"{gangs[0]['sync']['step_ms']:.2f} ms", flush=True)
    if rel > 1e-3 or not all(abs(x) < float("inf") for g in gangs[1:]
                             for mode in ("overlap", "sync")
                             for x in g[mode]["losses"]):
        fail("phase 21b: the cross-slice loss is off 21a's 1F1B")
    for g in gangs:
        if g["wire_bytes"] != 4 * g["hop_bytes"]:
            fail(f"phase 21b: stage {g['stage']} sent {g['wire_bytes']} "
                 f"bytes a step, want 4 hops of {g['hop_bytes']}")
    return launches


def _pp_entry_points(out, card):
    """21c: ``train_lm --pp_schedule gpipe|1f1b`` for 3 steps at world 1
    (``{"pp": 1}``: the degenerate path), and ``train_pipeline`` as two
    stage processes for 3 steps. Returns train_lm's launches."""
    import socket
    zero, read = _pp_counts()
    launches = dict(k1=0, k2=0, k5=0)
    n, L = 3, 8
    out["cli"] = {}
    for schedule in ("gpipe", "1f1b"):
        zero()
        t0 = time.perf_counter()
        rc, lines = _train_lm_cli(
            ["--preset", "small", "--steps", str(n), "--batch_size",
             str(PP_BATCH), "--seq_len", str(PP_SEQ), "--pp_schedule",
             schedule], {"pp": -1})
        c = read()
        _check_tc_variants(f"train_lm --pp_schedule {schedule}")
        done = [x for x in lines if x.startswith("done: final loss ")]
        sched = [x for x in lines if x.startswith("pipeline schedule: ")]
        print(f"[21c] python -m tony_tpu_torch.train_lm --preset small "
              f"--pp_schedule {schedule} on {card}, NCCL world 1: {n} "
              f"steps in {time.perf_counter() - t0:.1f}s: "
              f"{sched[0] if sched else None}; "
              f"{done[0] if done else None}; launches {c}", flush=True)
        out["cli"][schedule] = dict(done=done, schedule=sched, launches=c)
        if rc != 0 or not done or not sched or "pp=1" not in sched[0]:
            fail(f"phase 21c: train_lm --pp_schedule {schedule}: exit {rc}, "
                 f"last lines {lines[-3:]}")
        if c["k1"] != 2 * L * n or c["k2"] != L * n or c["k3"] or \
                c["k5"] != (4 * L + 1) * n:
            fail(f"phase 21c: launch counts {c}")
        for k in launches:
            launches[k] += c[k]
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    t0 = time.perf_counter()
    procs = []
    for s in (0, 1):
        env = dict(os.environ, PYTHONPATH=HERE, TONY_PIPELINE_STAGE=str(s),
                   TONY_PIPELINE_NUM_STAGES="2",
                   TONY_CHANNEL_PORT=str(ports[s]),
                   TONY_CHANNEL_PREV=f"127.0.0.1:{ports[0]}" if s else "",
                   TONY_CHANNEL_NEXT="" if s else f"127.0.0.1:{ports[1]}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tony_tpu_torch.train_pipeline",
             "--steps", "3", "--dim", "512", "--mb_rows", "64"], cwd=HERE,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    losses = [float(x.split()[-1]) for x in logs[1].splitlines()
              if x.startswith("step ") and " loss " in x]
    print(f"[21c] python -m tony_tpu_torch.train_pipeline as two stage "
          f"processes on {card}: 3 steps in "
          f"{time.perf_counter() - t0:.1f}s, exit "
          f"{[p.returncode for p in procs]}, stage 1 losses {losses}",
          flush=True)
    out["train_pipeline"] = dict(rc=[p.returncode for p in procs],
                                 losses=losses)
    if any(p.returncode for p in procs) or len(losses) != 3 or \
            not all(abs(x) < float("inf") for x in losses) or \
            "cuda" not in logs[0]:
        fail("phase 21c: train_pipeline: " + " | ".join(
            log[-1500:] for log in logs))
    return launches


def phase_pipeline(report, card):
    """[21] Pipeline parallelism on one card: (a) GPipe and 1F1B over pp
    2 (4 layers a stage, M 4) and pp 4 (M 8) simulated ranks, `small`
    bf16 16 x 1024 remat "full": the first step's loss and grad norm
    against the unpipelined step on the same batch and params, K1/K2/K5
    a step against the predicted counts, step wall, device ms, peak
    memory; (b) the cross-slice 1F1B as two processes on the card, one
    stage gang each (`small`'s blocks 4 + 4) over TONYC1 on loopback,
    overlapped and with ``sync_transport``: each stage's step, bubble
    fraction, wire bytes and peak memory, the loss against (a)'s pp-2
    1F1B; (c) ``train_lm --pp_schedule gpipe|1f1b`` at world 1 and
    ``train_pipeline`` as two stage processes. Several pp ranks over
    NCCL need a host with more cards. Returns the launches (K1, K2,
    K5)."""
    import torch
    from tony_tpu_torch import train_lm
    t_phase = time.perf_counter()
    out = {"walls": {}}
    cfg, params = train_lm.build("small", "cuda")
    tokens = _pp_tokens(cfg.vocab_size, "cuda")
    launches, loss_1f1b = _pp_in_slice(out, card, cfg, params, tokens)
    del params
    torch.cuda.empty_cache()
    out["walls"]["a"] = time.perf_counter() - t_phase
    b = _pp_cross_slice(out, card, loss_1f1b)
    out["walls"]["b"] = time.perf_counter() - t_phase - out["walls"]["a"]
    c = _pp_entry_points(out, card)
    out["walls"]["c"] = (time.perf_counter() - t_phase - out["walls"]["a"]
                         - out["walls"]["b"])
    for part in (b, c):
        for k in launches:
            launches[k] += part[k]
    out["wall_s"] = time.perf_counter() - t_phase
    out["launches"] = launches
    print(f"[21] phase wall {out['wall_s']:.1f}s ("
          + ", ".join(f"21{k} {v:.1f}s" for k, v in out["walls"].items())
          + "); pp ranks over NCCL need a host with more cards", flush=True)
    report["pipeline"] = out
    return launches


# phase 22: observability. The traced run's window and the live capture's
# length, the steps of the ledger and quiet runs, and the cost loop's
# iterations (kept short: the script's 1200 s limit)
OBS_PRESET = "small"
OBS_BATCH, OBS_SEQ = 16, 1024
OBS_TRACED = 3
OBS_TRACES = 3
OBS_MARKERS, OBS_MARKER_GAP_US = 400, 50.0
OBS_LEDGER_STEPS, OBS_QUIET_STEPS = 10, 12
OBS_LIVE_STEPS, OBS_LIVE_MS = 10, 2000
OBS_COST_ITERS = 20000


def _port_kernel(name: str):
    """The port's kernel ("K1" ... "K6") a CUDA kernel of a trace belongs
    to, by its name (demangled, or mangled: ``Lb1E`` is a ``true``
    template argument), or None for any other kernel. K2 and K3b are
    ``flash_bwd_kv*_kernel`` with and without ``WITH_DQ``; K5 and K6 are
    ``norm_*_kernel`` without and with ``LN``."""
    flag = "true>" in name or "Lb1E" in name
    if "flash_fwd" in name:
        return "K1"
    if "flash_bwd_dq" in name:
        return "K3a"
    if "flash_bwd_kv" in name:
        return "K2" if flag else "K3b"
    if "adamw_kernel" in name:
        return "K4"
    if "norm_vec_kernel" in name or "norm_scalar_kernel" in name:
        return "K6" if flag else "K5"
    return None


def _trace_counts(path):
    """({kernel: launches} of the port's kernels, {other device kernel
    names: launches}, the trace's events) of a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ours, others = {}, {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        k = _port_kernel(e.get("name", ""))
        if k is None:
            others[e.get("name", "")] = others.get(e.get("name", ""), 0) + 1
        else:
            ours[k] = ours.get(k, 0) + 1
    return ours, others, events


def _shares(snap) -> dict:
    cat = snap["cat"]
    total = sum(cat.values())
    return {k: cat.get(k, 0.0) / total
            for k in ("step", "data_wait", "checkpoint", "overhead")}


def _capture_request(port: int, ms: int):
    """(HTTP status, JSON answer) of a live-capture request."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/capture?ms={ms}",
                timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _obs_trace(card, cfg, params, counts, directory, tag, check=True):
    """(a) A StepTracer over OBS_TRACED steps of run_training: the trace's
    K1/K2/K5 against the launch counters over the same steps, and the
    marks; fails on a mismatch when ``check``. Returns its numbers."""
    from tony_tpu_torch.runtime import profiler as P
    L = cfg.n_layers
    per_step = {"K1": 2 * L, "K2": L, "K5": 4 * L + 1}
    tracer = P.StepTracer(start=1, stop=1 + OBS_TRACED,
                          logdir=os.path.join(directory, "steps"))
    at = {}

    def hook(step):
        tracer.step(step)
        at[step] = counts()

    t0 = time.perf_counter()
    try:
        _, losses, _, _ = _train_run(cfg, params, 2 + OBS_TRACED,
                                     batch=OBS_BATCH, seq=OBS_SEQ,
                                     step_hook=hook)
    finally:
        tracer.close()
    wall = time.perf_counter() - t0
    window = {k: at[1 + OBS_TRACED][k] - at[1][k] for k in per_step}
    traced, others, events = _trace_counts(tracer.path)
    # the host's ranges (the card's copies are "gpu_user_annotation")
    marks = sorted(e["name"] for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("ProfilerStep#"))
    mb = os.path.getsize(tracer.path) / 2 ** 20
    os.remove(tracer.path)
    want = {k: v * OBS_TRACED for k, v in per_step.items()}
    print(f"[{tag}] StepTracer [1, {1 + OBS_TRACED}) over {2 + OBS_TRACED} "
          f"{OBS_PRESET} bf16 {OBS_BATCH}x{OBS_SEQ} run_training steps on "
          f"{card}: trace {mb:.1f} MiB, {len(events)} events, marks "
          f"{marks}; the port's kernels in it {traced}, the launch "
          f"counters over the window {window}, expected {want} "
          f"(16 K1, 8 K2, 33 K5 a step); {sum(others.values())} other "
          f"kernel launches; run wall {wall:.2f} s", flush=True)
    res = dict(traced=traced, counters=window, expected=want, marks=marks,
               trace_mib=mb, events=len(events),
               other_kernels=sum(others.values()), wall_s=wall,
               losses=losses, held=traced == window == want)
    if not check:
        res["edges"] = _trace_edges(events)
        print(f"[{tag}] edges (ms from the first mark): {res['edges']}",
              flush=True)
        return res
    if not traced:
        fail("the step trace holds no kernel of the port: the capture "
             "recorded no CUDA activity")
    if marks != [f"ProfilerStep#{s}" for s in range(1, 1 + OBS_TRACED)]:
        fail(f"the step trace marks {marks}, not steps 1..{OBS_TRACED}")
    if traced != window or window != want:
        fail(f"trace counts {traced} != launch counters {window} != "
             f"expected {want}")
    return res


def _trace_edges(events) -> dict:
    """Where a trace's host ops, launches and kernels begin and end, in
    ms from its first ``ProfilerStep#`` mark, its instant events, and
    the kernel launches it holds with no kernel (by correlation id): a
    capture that misses kernels at an edge of its window shows here."""
    marks = [e["ts"] for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("ProfilerStep#")]
    if not marks:
        return {}
    t0 = min(marks)

    def rel(ts):
        return None if ts is None else round((ts - t0) / 1e3, 3)

    ops = [e for e in events if e.get("cat") == "cpu_op"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "aunch" in e.get("name", "")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    have = {e.get("args", {}).get("correlation") for e in kernels}
    orphans = [e["ts"] for e in launches
               if e.get("args", {}).get("correlation") not in have]
    corr = [(e.get("args", {}).get("correlation", -1), e.get("args", {})
             .get("correlation") in have) for e in launches]
    first_kept = min((c for c, kept in corr if kept), default=None)
    return dict(
        first_op=rel(min((e["ts"] for e in ops), default=None)),
        first_launch=rel(min((e["ts"] for e in launches), default=None)),
        first_kernel=rel(min((e["ts"] for e in kernels), default=None)),
        last_kernel_end=rel(max((e["ts"] + e.get("dur", 0)
                                 for e in kernels), default=None)),
        last_mark_end=rel(max(e["ts"] + e.get("dur", 0) for e in events
                              if e.get("cat") == "user_annotation"
                              and e.get("name", "").startswith(
                                  "ProfilerStep#"))),
        instants={e.get("name"): rel(e["ts"]) for e in events
                  if e.get("ph") == "i"},
        launches=len(launches), kernels=len(kernels),
        launches_without_kernel=len(orphans),
        # every launch whose kernel is missing came before the first
        # launch whose kernel is there (correlation ids grow by launch)
        lost_only_first=all(c < first_kept for c, kept in corr
                            if not kept) if first_kept is not None
        else False,
        orphan_first=rel(min(orphans, default=None)),
        orphan_last=rel(max(orphans, default=None)))


def _capture_markers(directory, gap_us=OBS_MARKER_GAP_US,
                     primer=0) -> dict:
    """A capture of the port's (``_Capture``) started on an idle card,
    then ``primer`` other one-element kernels, then OBS_MARKERS
    one-element kernels launched ``gap_us`` apart: how many it recorded,
    and the index of the first recorded (the launches it missed after
    its start)."""
    import torch
    from tony_tpu_torch.runtime import profiler as P
    x = torch.zeros(1, device="cuda")
    y = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    cap = P._Capture(os.path.join(directory, "markers"))
    for _ in range(primer):
        y.mul_(1.0)
    t0 = time.perf_counter()
    for _ in range(OBS_MARKERS):
        x.add_(1)
        until = time.perf_counter() + gap_us * 1e-6
        while time.perf_counter() < until:
            pass
    span_ms = (time.perf_counter() - t0) * 1e3
    path = cap.stop()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    ops = sorted((e["ts"], e["args"].get("External id")) for e in events
                 if e.get("cat") == "cpu_op" and e.get("name") == "aten::add_")
    order = {eid: i for i, (_, eid) in enumerate(ops)}
    kernels = [order.get(e.get("args", {}).get("External id"), -1)
               for e in events if e.get("cat") == "kernel"]
    kernels = [k for k in kernels if k >= 0]
    return dict(launched=OBS_MARKERS, ops=len(ops), kernels=len(kernels),
                first=min(kernels) if kernels else None, span_ms=span_ms,
                gap_us=gap_us, primer=primer)


def _markers_text(m) -> str:
    return (f"{m['kernels']} of {m['launched']} kernels ({m['ops']} aten "
            f"ops) recorded, the first recorded is launch {m['first']} "
            f"({m['gap_us']:.0f} us apart after {m['primer']} other "
            f"kernels, {m['span_ms']:.1f} ms in all)")


def _obs_ledger(out, report, card, cfg, params, directory):
    """(c) A fresh ledger around run_training: as train_lm runs it (no
    synchronisation, one asynchronous save) and with every step
    synchronised; the category sum against the host wall, the shares,
    the device time left after the loop returned; (d) the quiet step
    wall, after the captures of (a) and (b)."""
    import statistics

    import torch
    from tony_tpu_torch.models.checkpoint import CheckpointManager
    from tony_tpu_torch.runtime import goodput as G
    from tony_tpu_torch.runtime import metrics as M
    res = {}
    for label, timed, steps in (("as train_lm runs it", False,
                                 OBS_LEDGER_STEPS),
                                ("every step synchronised", True,
                                 OBS_QUIET_STEPS)):
        mgr = (None if timed else
               CheckpointManager(os.path.join(directory, "ckpt"),
                                 save_interval_steps=1000))
        torch.cuda.synchronize()
        led = G.GoodputLedger(registry=M.MetricsRegistry())
        G.set_ledger(led)
        try:
            t0 = time.perf_counter()
            _, _, walls, waits = _train_run(
                cfg, params, steps, batch=OBS_BATCH, seq=OBS_SEQ,
                checkpoint=mgr, timed=timed)
            t1 = time.perf_counter()
            snap = led.snapshot()
        finally:
            G.set_ledger(None)
            if mgr is not None:
                mgr.close()
        torch.cuda.synchronize()
        tail_ms = (time.perf_counter() - t1) * 1e3
        wall = t1 - t0
        total = sum(snap["cat"].values())
        shares = _shares(snap)
        r = dict(wall_s=wall, cat=snap["cat"], n=snap["n"], sw=snap["sw"],
                 shares=shares, sum_minus_wall_ms=(total - wall) * 1e3,
                 device_tail_ms=tail_ms)
        if timed:
            r["quiet_step_ms"] = statistics.median(walls[-8:]) * 1e3
            r["walls_ms"] = [w * 1e3 for w in walls]
        res["timed" if timed else "train_lm"] = r
        cats = {k: round(v, 4) for k, v in snap["cat"].items()}
        print(f"[22c] ledger over {steps} steps, {label}, on {card}: "
              f"categories {cats} s, sum - host wall "
              f"{r['sum_minus_wall_ms']:.4f} ms (limit 1 ms); shares step "
              f"{shares['step']:.4f}, data_wait {shares['data_wait']:.4f}, "
              f"checkpoint {shares['checkpoint']:.4f}, overhead "
              f"{shares['overhead']:.4f}; closed steps {snap['sw']['c']}; "
              f"device time left after the loop returned {tail_ms:.1f} ms",
              flush=True)
        if abs(total - wall) > 1e-3:
            fail(f"the ledger's categories sum to {total:.6f} s, the host "
                 f"wall is {wall:.6f} s")
        if snap["sw"]["c"] != steps or snap["cat"].get("step", 0) <= 0:
            fail(f"the ledger closed {snap['sw']['c']} steps of {steps}")
    quiet = res["timed"]["quiet_step_ms"]
    p9 = report.get("train", {}).get("step_ms")
    origin = report.get("train", {}).get("step_ms_origin", "not run")
    print(f"[22d] quiet step wall with the spans and the ledger: "
          f"{quiet:.2f} ms (median of the last 8 synchronised steps) "
          f"against phase 9's {_ms(p9)} ({origin}) on {card}", flush=True)
    res["phase9_step_ms"], res["phase9_origin"] = p9, origin
    out["ledger"] = res


def _obs_cost(out):
    """(d) The host cost of one step's spans and ledger intervals alone,
    the loop's own calls on a recording tracer and a fresh ledger."""
    from tony_tpu_torch.runtime import goodput as G
    from tony_tpu_torch.runtime import metrics as M
    from tony_tpu_torch.runtime import tracing as TT
    res = {}
    for label, ckpt in (("without", False), ("with", True)):
        tr = TT.Tracer(proc="cost", sample_rate=1.0, spool_path="")
        led = G.GoodputLedger(registry=M.MetricsRegistry())
        t0 = time.perf_counter()
        for step in range(OBS_COST_ITERS):
            with tr.span("train.step", step=step) as sp:
                with led.enter("data_wait"):
                    pass
                tr.record_span("train.data_wait", 0.0, parent=sp)
                with tr.span("train.dispatch"), led.enter("step"):
                    pass
                if ckpt:
                    with tr.span("train.checkpoint"), \
                            led.enter("checkpoint"):
                        pass
        res[label] = (time.perf_counter() - t0) / OBS_COST_ITERS * 1e6
    print(f"[22d] host cost of one step's spans and ledger intervals "
          f"({OBS_COST_ITERS} iterations, recording tracer): "
          f"{res['without']:.2f} us without a checkpoint offer, "
          f"{res['with']:.2f} us with one", flush=True)
    out["cost_us"] = res


def _obs_live(out, card, cfg, params, directory):
    """(b) A live capture through maybe_start, asked for from another
    thread while run_training runs steps on this one; a second request
    overlapping it is refused. Step 1 waits until the capture records and
    the last step until it has answered, so the window holds whole steps
    however slow the host is under the profiler."""
    import socket
    import threading

    from tony_tpu_torch.runtime import profiler as P
    recording = threading.Event()

    class _Signalled(P._Capture):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            recording.set()

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"TONY_PROFILE_ENABLED": "true", "TB_PORT": str(port),
           "TONY_PROFILE_DIR": os.path.join(directory, "live"),
           "JOB_NAME": "chip", "TASK_INDEX": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    answers = {}
    asker = threading.Thread(target=lambda: answers.update(
        live=_capture_request(port, OBS_LIVE_MS)))

    def hook(step):
        if step == 1:
            asker.start()
            if not recording.wait(60):
                fail("the live capture never started")
            answers["overlap"] = _capture_request(port, 50)
        elif step == OBS_LIVE_STEPS - 1:
            answers["open_at_last"] = asker.is_alive()
            asker.join(120)

    capture_class = P._Capture
    try:
        P._Capture = _Signalled
        P._reset_server_state_for_tests()
        t0 = time.perf_counter()
        if not P.maybe_start():
            fail("maybe_start did not bring the capture listener up")
        start_s = time.perf_counter() - t0
        _train_run(cfg, params, OBS_LIVE_STEPS, batch=OBS_BATCH,
                   seq=OBS_SEQ, step_hook=hook)
        asker.join(120)
    finally:
        P._Capture = capture_class
        P._reset_server_state_for_tests()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    code, body = answers.get("live", (None, {}))
    ocode, obody = answers.get("overlap", (None, {}))
    if code != 200:
        fail(f"the live capture answered {code}: {body}")
    traced, _, events = _trace_counts(body["trace"])
    main_tid = threading.get_native_id()
    ops = sum(1 for e in events if e.get("cat") == "cpu_op"
              and e.get("tid") == main_tid)
    print(f"[22b] live capture of {OBS_LIVE_MS} ms on port {port} (the "
          f"listener up in {start_s:.2f} s, its warm-up included), asked "
          f"for from another thread during {OBS_LIVE_STEPS} steps on "
          f"{card}: the port's kernels {traced}, {ops} aten ops of the "
          f"training thread (the window still open when step "
          f"{OBS_LIVE_STEPS - 1} began: {answers.get('open_at_last')}); an "
          f"overlapping request answered {ocode} ({obody.get('error')})",
          flush=True)
    out["live"] = dict(kernels=traced, training_thread_ops=ops,
                       overlap=[ocode, obody], listener_start_s=start_s,
                       open_at_last=answers.get("open_at_last"))
    if not traced.get("K1") or not traced.get("K2"):
        fail(f"the live capture holds K1/K2 {traced}, want both")
    if not ops:
        fail("the live capture holds no aten op of the training thread")
    if ocode != 409:
        fail(f"an overlapping live request answered {ocode}, not 409")


def _obs_engine(out, card):
    """(e) A ServeEngine over 4 requests of at most SHORT_BUDGET tokens,
    then 0.5 s with nothing to do: its step and idle seconds."""
    import threading

    from tony_tpu_torch import serve_lm
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.runtime import goodput as G
    from tony_tpu_torch.runtime import metrics as M
    cfg, params = serve_lm.build(OBS_PRESET, "cuda")
    prompts, budgets = serve_lm.make_workload(0, PER_STEP_REQUESTS, 480,
                                              SHORT_BUDGET, cfg.vocab_size,
                                              min_prompt_len=64)
    batcher = S.ContinuousBatcher(params, cfg, batch=8, max_len=1024,
                                  chunk=8, pipeline=True)
    done, retired = threading.Event(), []

    def on_retired(rid, reason, emitted, final):
        retired.append((rid, reason))
        if len(retired) == len(prompts):
            done.set()

    eng = S.ServeEngine(batcher, on_retired=on_retired,
                        registry=M.MetricsRegistry())
    at = {}

    def drive():
        at["run"] = time.perf_counter()
        eng.run()
        at["ran"] = time.perf_counter()

    th = threading.Thread(target=drive, daemon=True)
    led = G.GoodputLedger(registry=M.MetricsRegistry())
    G.set_ledger(led)
    try:
        t0 = time.perf_counter()
        th.start()
        for i, (p, b) in enumerate(zip(prompts, budgets)):
            eng.submit(i, p, b)
        if not done.wait(300):
            fail("the engine did not retire its requests")
        busy = time.perf_counter() - t0
        time.sleep(0.5)
        eng.drain()
        th.join(60)
        wall = time.perf_counter() - t0
        snap = led.snapshot()
    finally:
        G.set_ledger(None)
    cat = snap["cat"]
    total = sum(cat.values())
    print(f"[22e] ServeEngine on {card}: {len(prompts)} requests of at "
          f"most {SHORT_BUDGET} tokens served in {busy:.3f} s, then 0.5 s "
          f"with nothing to do: step {cat.get('step', 0):.4f} s, idle "
          f"{cat.get('idle', 0):.4f} s, overhead {cat.get('overhead', 0):.4f}"
          f" s (the engine thread entered run {at['run'] - t0:.4f} s "
          f"into the window and left it {t0 + wall - at['ran']:.4f} s "
          f"before its end); sum - wall {(total - wall) * 1e3:.4f} ms",
          flush=True)
    out["engine"] = dict(cat=cat, n=snap["n"], busy_s=busy, wall_s=wall,
                         retired=retired, run_entered_s=at["run"] - t0,
                         run_left_s=t0 + wall - at["ran"])
    if not (cat.get("step", 0) > 0 and cat.get("idle", 0) > 0):
        fail(f"the engine's ledger has step {cat.get('step')} and idle "
             f"{cat.get('idle')}, want both > 0")
    if abs(total - wall) > 1e-3:
        fail(f"the engine's ledger sums to {total:.6f} s, its wall is "
             f"{wall:.6f} s")


def phase_observability(report, card):
    """[22] What the orchestrator reads of a port process, on the card,
    in a process of its own (``chip_smoke.py --observability``), as a
    job's trainer runs; then (f) step traces in this long-lived process.
    Returns the launch counts of both."""
    import torch
    torch.cuda.empty_cache()
    cmd = [sys.executable, os.path.join(HERE, "chip_smoke.py"),
           "--observability"]
    p9 = report.get("train", {}).get("step_ms")
    if p9 is not None:
        cmd += [repr(p9), "measured by the parent process in this run"]
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=900)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines:
        print("\n".join(lines) + "\n" + proc.stderr[-4000:], flush=True)
        said = [x for x in lines if x.startswith("FAIL: ")]
        fail(f"phase 22's process exited {proc.returncode}: "
             + (said[-1] if said else proc.stderr[-1000:]))
    print("\n".join(lines[:-1]), flush=True)
    out = json.loads(lines[-1])
    report["observability"] = out["observability"]
    launches = out["launches"]
    for k, v in _obs_long_lived(report, card).items():
        launches[k] += v
    return launches


def _obs_long_lived(report, card):
    """(f) This process has run 21 phases: a capture here misses its
    first GPU records (a count that grows with the process's history,
    ``PERF.md`` §6). Marker captures 50 and 500 us apart and
    after 128 other kernels, and a step trace held against the launch
    counters; checks that 128 kernels launched first absorb the loss
    and that the step trace lost only its first launches' kernels.
    Returns the launch counts."""
    import tempfile

    from tony_tpu_torch import train_lm
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N

    def counts():
        return {"K1": A.flash_forward.launches,
                "K2": A.flash_backward_fused.launches,
                "K5": N.rms_norm_forward.launches}

    A.reset_launches()
    N.rms_norm_forward.launches = 0
    cfg, params = train_lm.build(OBS_PRESET, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        marks = _loss_markers(tmp, "22f", "21 phases, in their process")
        tr = _obs_trace(card, cfg, params, counts, tmp, "22f", check=False)
    report["observability"]["long_lived"] = dict(markers=marks, trace=tr)
    lost = {k: tr["counters"][k] - tr["traced"].get(k, 0)
            for k in tr["counters"]}
    print(f"[22f] after 21 phases the captures missed the first "
          f"{[m['first'] for m in marks[:2]]} markers (50, 500 us apart) "
          f"and {marks[2]['launched'] - marks[2]['kernels']} after 128 "
          f"other kernels; the step trace missed K1/K2/K5 {lost} and "
          f"{tr['edges'].get('launches_without_kernel')} launches' "
          f"kernels, only the first launches': "
          f"{tr['edges'].get('lost_only_first')}", flush=True)
    if marks[2]["kernels"] != marks[2]["launched"]:
        fail(f"after 128 other kernels the capture still missed markers: "
             f"{_markers_text(marks[2])}")
    if tr["edges"].get("launches_without_kernel") and not tr["edges"].get(
            "lost_only_first"):
        fail("the step trace lost kernels after its first recorded one")
    c = counts()
    return dict(k1=c["K1"], k2=c["K2"], k5=c["K5"])


def _observability(report, card):
    """Phase 22 in this process, in a job's order: (b) a live capture
    through maybe_start (after its warm-up session) from another thread,
    (a) OBS_TRACES successive StepTracer traces of run_training steps,
    each counting K1/K2/K5 as the launch counters do, and a marker
    capture, (c) the goodput ledger's carve-up of run_training's wall,
    (d) the quiet step wall with the spans and ledger (after the
    captures: no cost may linger) beside phase 9's, and their host cost
    alone, (e) ServeEngine's step and idle seconds; returns the launch
    counts."""
    import tempfile

    from tony_tpu_torch import train_lm
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N

    def counts():
        return {"K1": A.flash_forward.launches,
                "K2": A.flash_backward_fused.launches,
                "K5": N.rms_norm_forward.launches}

    A.reset_launches()
    N.rms_norm_forward.launches = 0
    cfg, params = train_lm.build(OBS_PRESET, "cuda")
    out = report["observability"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        _obs_live(out, card, cfg, params, tmp)
        out["traces"] = [
            _obs_trace(card, cfg, params, counts, tmp,
                       f"22a {i + 1} of {OBS_TRACES}")
            for i in range(OBS_TRACES)]
        m = out["markers"] = _capture_markers(tmp)
        print(f"[22a] marker capture: {_markers_text(m)}", flush=True)
        _obs_ledger(out, report, card, cfg, params, tmp)
        _obs_cost(out)
    _check_tc_variants("phase 22's training")
    _obs_engine(out, card)
    c = counts()
    return dict(k1=c["K1"], k2=c["K2"], k5=c["K5"])


def observability_main(phase9_step_ms, origin) -> int:
    """Phase 22 alone in this process (module docstring): its lines,
    then one JSON line of its numbers and launch counts."""
    sys.path.insert(0, HERE)
    card = phase_card()
    from tony_tpu_torch.ops import _kernels
    _kernels.build()
    report = ({} if phase9_step_ms is None
              else {"train": {"step_ms": phase9_step_ms,
                              "step_ms_origin": origin}})
    launches = _observability(report, card)
    print(json.dumps({"observability": report["observability"],
                      "launches": launches}, default=str), flush=True)
    return 0


def _loss_markers(tmp, tag, after) -> list:
    """Marker captures 50 and 500 us apart, and 50 after 128 other
    kernels, each printed; returns their numbers."""
    res = []
    for gap, primer in ((OBS_MARKER_GAP_US, 0), (500.0, 0),
                        (OBS_MARKER_GAP_US, 128)):
        m = _capture_markers(tmp, gap, primer)
        print(f"[{tag}] after {after}: {_markers_text(m)}", flush=True)
        res.append(m)
    return res


# phase 23: fleet operations ---------------------------------------------

#: the phase's replicas hold ``serve_lm --slots 8``'s cache (prompt_len
#: 16 + max_new_tokens 32 positions), so any stream of theirs fits the
#: process replica a rolling upgrade moves it to
FLEET_SLOTS, FLEET_MAX_LEN, FLEET_PROMPT = 8, 48, 8
FLEET_TICK_S = 0.1
#: the routers' STATS pings (3 unanswered mark a replica down)
FLEET_PING_S = 0.2
FLEET_UP_Q = 4.0
#: 23a's burst: 80 requests 50 ms apart, more than one replica serves,
#: arriving for 4 s: past the scale-up, whose warm ship takes seconds
#: (serving ``small`` is bound by the host's dispatch of each decode
#: step: PERF.md §5)
FLEET_BURST, FLEET_GAP_S = 80, 0.05
#: the process replica: phase 5's weights (``build`` seeds them alike)
#: as generation v2, on the card (no ``--device``)
FLEET_ARGV = ("-m", "tony_tpu_torch.serve_lm", "--preset", "small",
              "--slots", "8", "--listen", "127.0.0.1:0",
              "--weights_version", "v2")


class _Replicas:
    """The phase's capacity (a ``CapacityProvider``): ``grow`` starts
    ``ServingServer``s in this process over fresh batchers of one set of
    weights; ``release`` stops the server behind an address, or hands
    an address ``procs`` (a ``SubprocessProvider``) grew back to it."""

    def __init__(self, make_batcher, version, procs=None):
        self.make_batcher = make_batcher
        self.version = version
        self.procs = procs
        self.servers = {}                   # live
        self.grown = {}                     # every server grown
        self.released = []

    def grow(self, n):
        from tony_tpu_torch.runtime.metrics import MetricsRegistry
        from tony_tpu_torch.serving.server import ServingServer
        out = []
        for _ in range(n):
            srv = ServingServer(self.make_batcher(),
                                weights_version=self.version,
                                registry=MetricsRegistry())
            addr = f"127.0.0.1:{srv.start()}"
            self.servers[addr] = self.grown[addr] = srv
            out.append(addr)
        return out

    def release(self, addrs):
        for addr in addrs:
            self.released.append(addr)
            if addr in self.servers:
                self.servers.pop(addr).stop()
            elif self.procs is not None:
                self.procs.release([addr])

    def stop(self):
        for srv in self.servers.values():
            srv.stop()
        self.servers.clear()


def _zero_launches():
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    A.reset_launches()
    N.rms_norm_forward.launches = 0
    S.CALL_COUNTS.clear()


def _fleet_launches(what, cfg, bf16):
    """(K1, K5) since :func:`_zero_launches`, held against the model calls
    the replicas made (K1 n_layers an ``admit_rows`` call, K5 2 x
    n_layers + 1 a model forward); bf16 launches on the tensor-core K1."""
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N
    L = cfg.n_layers
    k1, k5 = A.flash_forward.launches, N.rms_norm_forward.launches
    admits = sum(c for (name, _), c in S.CALL_COUNTS.items()
                 if name == "admit_rows")
    forwards = sum(c * (shape[1] if name == "step_rows" else 1)
                   for (name, shape), c in S.CALL_COUNTS.items()
                   if name in ("admit_rows", "admit_row", "step_rows"))
    if bf16:
        _check_tc_variants(what)
    if admits == 0 or k1 != L * admits or k5 != (2 * L + 1) * forwards:
        fail(f"{what}: K1 {k1} over {admits} admit_rows calls, K5 {k5} over "
             f"{forwards} forwards (want {L} and {2 * L + 1} each)")
    return k1, k5


def _recorded_drains(router):
    """Record every drain summary the router returns (the controller
    keeps only a log line of them)."""
    drains, plain = [], router.drain

    def drain(addr, timeout_s=120.0):
        drains.append(plain(addr, timeout_s=timeout_s))
        return drains[-1]

    router.drain = drain
    return drains


def _itl_snapshot(reg):
    """The router's inter-token histograms, summed over the classes, as
    cumulative bucket counts."""
    from tony_tpu_torch.models.serve import QOS_CLASSES
    hs = [reg.histogram("tony_serve_intertoken_seconds", **{"class": c})
          for c in QOS_CLASSES]
    return [sum(col) for col in zip(*(h.cumulative() for h in hs))]


def _window_p99_ms(bounds, lo, hi):
    """p99 (ms) of the observations between two cumulative snapshots,
    interpolated in its bucket as Prometheus's ``histogram_quantile``
    does; None when the window saw none."""
    d = [b - a for a, b in zip(lo, hi)]
    if not d or d[-1] <= 0:
        return None
    rank, prev_c, prev_b = 0.99 * d[-1], 0, 0.0
    for b, c in zip(list(bounds) + [None], d):
        if c >= rank:
            if b is None:
                return prev_b * 1e3
            return (prev_b + (b - prev_b) * (rank - prev_c)
                    / max(c - prev_c, 1e-12)) * 1e3
        prev_c, prev_b = c, b
    return None


def _load(port, n, interval_s, seed_base):
    """``open_loop_load`` of ``n`` requests of 16 tokens, the classes in
    rotation, on a thread; returns (thread, box): ``box["t0"]`` its
    start, ``box["records"]`` its records once it ends."""
    import threading
    from tony_tpu_torch.models.serve import QOS_CLASSES
    from tony_tpu_torch.serving.simfleet import open_loop_load
    box = {}

    def run():
        box["t0"] = time.monotonic()
        box["records"] = open_loop_load(
            port, [QOS_CLASSES[i % 3] for i in range(n)],
            interval_s=interval_s, max_new=16, prompt_len=FLEET_PROMPT,
            seed_base=seed_base, event_timeout=120)

    th = threading.Thread(target=run, name="tony-fleet-load", daemon=True)
    th.start()
    return th, box


def _check_records(what, records, budget):
    bad = [(i, r["error"], r["shed"], len(r["tokens"]))
           for i, r in enumerate(records)
           if r["error"] or r["shed"] or len(r["tokens"]) != budget]
    if bad:
        fail(f"{what}: {len(bad)} of {len(records)} streams did not end at "
             f"their budget of {budget}: {bad[:5]}")


def _no_second_terminal(c, rids, what):
    """After every stream's terminal frame: 0.2 s later, no stream has
    another frame."""
    import queue
    time.sleep(0.2)
    for r in rids:
        try:
            ev = c.next_event(r, timeout=0)
        except queue.Empty:
            continue
        fail(f"{what}: stream {r} had a frame after its terminal: {ev}")


def _await_load(router, addr, at_least, what):
    """Wait until the router's STATS of ``addr`` report a load of at
    least ``at_least``."""
    deadline = time.time() + 60
    while time.time() < deadline:
        rep = router.stats()["replicas"].get(addr, {})
        if rep.get("reported_load", 0) >= at_least:
            return
        time.sleep(0.01)
    fail(f"{what}: {addr} never reported a load of {at_least}")


def _fleet_prompts(n, vocab, seed):
    import numpy as np
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(0, vocab, size=FLEET_PROMPT)]
            for _ in range(n)]


def _fleet_autoscale(rep, card, params, cfg):
    """[23a] a router over one in-process replica; a FleetController
    (hysteresis 2, cooldown 3, 1 to 2 replicas) growing in-process
    replicas of the same weights, warmed by a ChannelWarmer the first
    replica seeds, ticked by this thread every FLEET_TICK_S; an
    open-loop burst over the scale-up threshold, then a trickle under
    the scale-down one. Returns (K1, K5)."""
    from tony_tpu_torch import serve_lm
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.runtime.metrics import (TIME_BUCKETS_S,
                                                MetricsRegistry)
    from tony_tpu_torch.serving.fleet import FleetController
    from tony_tpu_torch.serving.router import ServingRouter
    from tony_tpu_torch.serving.weightstore import ChannelWarmer

    prov = _Replicas(lambda: S.ContinuousBatcher(
        params, cfg, batch=FLEET_SLOTS, max_len=FLEET_MAX_LEN, chunk=8),
        "v1")
    (seed,) = prov.grow(1)
    seeder = prov.servers[seed]
    rreg = MetricsRegistry()
    router = ServingRouter([seed], health_interval_s=FLEET_PING_S,
                           registry=rreg)
    router.start()
    warmer = ChannelWarmer(seeder.weights_digest, [seed], timeout_s=60)
    warm_walls, plain_warm = [], warmer.warm

    def timed_warm(targets):
        t = time.perf_counter()
        res = plain_warm(targets)
        warm_walls.append(time.perf_counter() - t)
        return res

    warmer.warm = timed_warm
    creg = MetricsRegistry()
    ctrl = FleetController(router, prov, min_replicas=1, max_replicas=2,
                           up_queue_per_replica=FLEET_UP_Q,
                           down_utilization=0.3, hysteresis_ticks=2,
                           cooldown_ticks=3, interval_s=FLEET_TICK_S,
                           drain_timeout_s=60, registry=creg, warmer=warmer)
    drains = _recorded_drains(router)
    ticks = []

    def tick():
        t0, lo = time.monotonic(), _itl_snapshot(rreg)
        action = ctrl.tick()
        ticks.append(dict(t0=t0, t1=time.monotonic(), action=action, lo=lo,
                          hi=_itl_snapshot(rreg)))
        time.sleep(max(0.0, t0 + FLEET_TICK_S - time.monotonic()))
        return action

    try:
        _zero_launches()
        snap0 = _itl_snapshot(rreg)
        burst, bbox = _load(router.port, FLEET_BURST, FLEET_GAP_S, 1000)
        while burst.is_alive():
            tick()
        snap1 = _itl_snapshot(rreg)
        n_burst = len(ticks)
        trickle, tbox = _load(router.port, 12, 0.25, 2000)
        deadline = time.monotonic() + 30
        while (trickle.is_alive() or "down" not in
               [t["action"] for t in ticks]) and time.monotonic() < deadline:
            tick()
        trickle.join(timeout=60)
        k1, k5 = _fleet_launches("phase 23a", cfg, bf16=True)
        actions = [t["action"] for t in ticks]
        ups = [i for i, a in enumerate(actions) if a == "up"]
        downs = [i for i, a in enumerate(actions) if a == "down"]
        if len(ups) != 1 or ups[0] >= n_burst or len(downs) != 1:
            fail(f"phase 23a: actions {actions} (burst ticks {n_burst}): "
                 f"want one 'up' under the burst, then one 'down'")
        _check_records("phase 23a burst", bbox["records"], 16)
        _check_records("phase 23a trickle", tbox["records"], 16)
        warm = ctrl.last_warm or {}
        grown = [a for a in prov.grown if a != seed]
        if (warm.get("warmed") != grown or len(grown) != 1
                or warm.get("fallback") or warm.get("failed")):
            fail(f"phase 23a: the warm pass {warm} (grown {grown}): want one "
                 f"peer ship, no fallback, no failure")
        new = prov.grown[grown[0]]
        resident = new.weight_store.resident_digests()
        if resident != [seeder.weights_digest]:
            fail(f"phase 23a: the warmed replica holds {resident}, the seeder "
                 f"{seeder.weights_digest}")
        if new.batcher.steps_executed == 0:
            up = ticks[ups[0]]
            fail(f"phase 23a: the router placed no session on the warmed "
                 f"replica ('up' {up['t0'] - bbox['t0']:.3f}s into the "
                 f"burst, for {up['t1'] - up['t0']:.3f}s; the warm pass "
                 f"{warm_walls}s; drains {drains})")
        drain = drains[0] if drains else {}
        if len(drains) != 1 or not drain.get("drained"):
            fail(f"phase 23a: drains {drains}")
        # the timer loop: start() ticks on its own thread until stop()
        timer_ticks, plain_tick = [], ctrl.tick
        ctrl.tick = lambda: timer_ticks.append(plain_tick()) or \
            timer_ticks[-1]
        ctrl.start()
        time.sleep(4.5 * FLEET_TICK_S)
        ctrl.stop()
        if len(timer_ticks) < 2 or set(timer_ticks) != {"hold"}:
            fail(f"phase 23a: the timer loop ticked {timer_ticks}")
    finally:
        ctrl.stop()
        router.stop()
        prov.stop()
    records = bbox["records"]
    up = ticks[ups[0]]
    submits = [bbox["t0"] + i * FLEET_GAP_S for i in range(len(records))]

    def ttft_p99(lo, hi):
        ts = [r["ttft_s"] for s, r in zip(submits, records) if lo <= s < hi]
        return serve_lm.percentile_ms(ts, 99), len(ts)

    windows = {
        "before": (ttft_p99(0.0, up["t0"]),
                   _window_p99_ms(TIME_BUCKETS_S, snap0, up["lo"])),
        "during": (ttft_p99(up["t0"], up["t1"]),
                   _window_p99_ms(TIME_BUCKETS_S, up["lo"], up["hi"])),
        "after": (ttft_p99(up["t1"], float("inf")),
                  _window_p99_ms(TIME_BUCKETS_S, up["hi"], snap1))}
    ship_bytes = seeder._weight_ship_bytes_c.value
    ship_h = seeder._weight_ship_h
    print(f"[23a] autoscale in process on {card}: {len(records)} + "
          f"{len(tbox['records'])} open-loop requests of 16 tokens, every "
          f"one at its budget; 'up' at tick {ups[0] + 1} of the burst "
          f"({up['t0'] - bbox['t0']:.3f}s after the load began; the "
          f"action {up['t1'] - up['t0']:.3f}s), 'down' by drain at tick "
          f"{downs[0] + 1} ({drain['migrated']} streams migrated, drain "
          f"{drain['wall_s']:.3f}s); warmed peer to peer {warm['warmed']} "
          f"({ship_bytes:.0f} B shipped, publish {ship_h.sum:.3f}s, the "
          f"warm pass {warm_walls[0]:.3f}s), resident digest "
          f"{seeder.weights_digest[:12]}… equal to the seeder's, "
          f"{new.batcher.steps_executed} decode steps served there; the timer "
          f"loop ticked {len(timer_ticks)} times; K1 {k1}, K5 {k5}",
          flush=True)
    for name, ((tt, n_tt), itl) in windows.items():
        print(f"[23a]   {name} the scale-up: TTFT p99 {tt:.1f} ms over {n_tt} "
              f"requests, ITL p99 "
              + (f"{itl:.1f} ms" if itl is not None else "n/a")
              + f" (router histogram, bucket-interpolated) on {card}",
              flush=True)
    rep["autoscale"] = dict(
        actions=actions, burst_ticks=n_burst, up_tick=ups[0] + 1,
        up_after_s=up["t0"] - bbox["t0"], up_wall_s=up["t1"] - up["t0"],
        down_tick=downs[0] + 1, drain=drain, warm=warm,
        ship_bytes=ship_bytes, publish_s=ship_h.sum,
        warm_wall_s=warm_walls[0], timer_ticks=len(timer_ticks),
        windows={k: dict(ttft_p99_ms=v[0][0], n=v[0][1], itl_p99_ms=v[1])
                 for k, v in windows.items()},
        k1=k1, k5=k5)
    return k1, k5


def _fleet_upgrade(rep, card, params, cfg, procs, boot):
    """[23b] two in-process v1 replicas (fetches paced 50 ms, so streams
    stay mid-flight) behind a router carry 8 streams of 32 tokens; a
    FleetController's rolling_upgrade onto the v2 ``serve_lm`` process
    ``procs`` grew: drained one by one, retired, released; then the
    process is released. Returns (K1, K5) of the in-process replicas."""
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    from tony_tpu_torch.serving.client import StreamingClient
    from tony_tpu_torch.serving.fleet import FleetController
    from tony_tpu_torch.serving.router import ServingRouter

    if "addr" not in boot:
        fail(f"phase 23b: the serve_lm process did not come up: "
             f"{boot.get('error')}")
    v2 = boot["addr"]
    proc = procs._procs[v2][0]
    prov = _Replicas(lambda: _paced(0.05)(
        params, cfg, batch=FLEET_SLOTS, max_len=FLEET_MAX_LEN, chunk=2),
        "v1", procs=procs)
    v1 = prov.grow(2)
    router = ServingRouter(v1, health_interval_s=FLEET_PING_S,
                           registry=MetricsRegistry())
    creg = MetricsRegistry()
    ctrl = FleetController(router, prov, drain_timeout_s=60, registry=creg)
    budget = 32
    try:
        _zero_launches()
        router.start()
        with StreamingClient("127.0.0.1", router.port) as c:
            hello = _tier_stats(v2)
            if hello.get("weights_version") != "v2":
                fail(f"phase 23b: the process replica reports {hello}")
            rids, got = _started_streams(
                c, _fleet_prompts(8, cfg.vocab_size, 23), budget,
                "phase 23b")
            t0 = time.perf_counter()
            results = ctrl.rolling_upgrade([v2])
            upgrade_wall = time.perf_counter() - t0
            _collect_streams(c, rids, got, "phase 23b")
            _no_second_terminal(c, rids, "phase 23b")
            after = c.stats()["replicas"]
        k1, k5 = _fleet_launches("phase 23b", cfg, bf16=True)
    finally:
        router.stop()
        prov.stop()
    if (sorted(results) != sorted(v1)
            or not all(r.get("drained") for r in results.values())
            or sorted(prov.released) != sorted(v1) or set(after) != {v2}
            or creg.counter("tony_fleet_upgrades_total").value != 1):
        fail(f"phase 23b: drains {results}, released {prov.released}, the "
             f"router's replicas after {sorted(after)}")
    if [len(got[r]) for r in rids] != [budget] * len(rids):
        fail(f"phase 23b: streams of {[len(got[r]) for r in rids]} tokens")
    migrated = sum(r["migrated"] for r in results.values())
    if migrated == 0:
        fail("phase 23b: the upgrade moved no live stream")
    t0 = time.perf_counter()
    procs.release([v2])
    release_wall = time.perf_counter() - t0
    if proc.returncode != 0 or release_wall > 10:
        fail(f"phase 23b: the serve_lm process exited {proc.returncode} "
             f"{release_wall:.1f}s after its release")
    walls = {a: r["wall_s"] for a, r in results.items()}
    print(f"[23b] rolling upgrade on {card}: `serve_lm --weights_version v2` "
          f"grown by SubprocessProvider in {boot['s']:.3f}s from spawn to "
          f"address (booted beside 23a), 8 streams of {budget} tokens moved "
          f"off two v1 replicas ({migrated} migrations; drains "
          + ", ".join(f"{w:.3f}s" for w in walls.values())
          + f"; the upgrade {upgrade_wall:.3f}s), each ending once at its "
          f"budget; both v1 replicas retired and released; the process "
          f"exited 0 {release_wall:.3f}s after its release; K1 {k1}, K5 "
          f"{k5} in the v1 replicas", flush=True)
    rep["upgrade"] = dict(boot_s=boot["s"], migrated=migrated,
                          drain_walls_s=list(walls.values()),
                          upgrade_wall_s=upgrade_wall,
                          release_wall_s=release_wall, k1=k1, k5=k5)
    return k1, k5


def _fleet_f32(rep, card, params, cfg):
    """[23c] drill (a) in f32 with 8 requests of 16 tokens: 5 on the one
    replica page in a warmed second (fetches paced 500 ms: streams stay
    mid-flight), 3 more land there, and the scale-down drains it onto
    the first; every stream equal to the unscaled colocated run (the
    near-tie rule). Returns (K1, K5)."""
    import torch
    from tony_tpu_torch import tree_map
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    from tony_tpu_torch.serving.client import StreamingClient
    from tony_tpu_torch.serving.fleet import FleetController
    from tony_tpu_torch.serving.router import ServingRouter
    from tony_tpu_torch.serving.server import ServingServer
    from tony_tpu_torch.serving.weightstore import ChannelWarmer

    cfg32 = cfg.scaled(dtype=torch.float32)
    params32 = tree_map(lambda v: v.float(), params)
    prompts, budget = _fleet_prompts(8, cfg.vocab_size, 2323), 16
    srv = ServingServer(S.ContinuousBatcher(
        params32, cfg32, batch=FLEET_SLOTS, max_len=FLEET_MAX_LEN, chunk=8),
        registry=MetricsRegistry())
    router = ServingRouter([f"127.0.0.1:{srv.start()}"],
                           registry=MetricsRegistry())
    try:
        router.start()
        unscaled, _ = _stream(router.port, prompts, [budget] * 8)
    finally:
        router.stop()
        srv.stop()
    prov = _Replicas(lambda: _paced(0.5)(
        params32, cfg32, batch=FLEET_SLOTS, max_len=FLEET_MAX_LEN, chunk=1),
        "v1")
    (a,) = prov.grow(1)
    router = ServingRouter([a], health_interval_s=FLEET_PING_S,
                           registry=MetricsRegistry())
    ctrl = FleetController(
        router, prov, min_replicas=1, max_replicas=2,
        up_queue_per_replica=4.5, down_utilization=0.6, hysteresis_ticks=2,
        cooldown_ticks=3, drain_timeout_s=60, registry=MetricsRegistry(),
        warmer=ChannelWarmer(prov.servers[a].weights_digest, [a],
                             timeout_s=60))
    drains = _recorded_drains(router)

    def tick_until(want, limit):
        seen = []
        while want not in seen and len(seen) < limit:
            t = time.monotonic()
            seen.append(ctrl.tick())
            time.sleep(max(0.0, t + FLEET_TICK_S - time.monotonic()))
        return seen

    try:
        _zero_launches()
        router.start()
        with StreamingClient("127.0.0.1", router.port) as c:
            rids, got = _started_streams(c, prompts[:5], budget,
                                         "phase 23c")
            _await_load(router, a, 5, "phase 23c")
            up = tick_until("up", 10)
            (b,) = [x for x in prov.grown if x != a]
            more, got_more = _started_streams(c, prompts[5:], budget,
                                              "phase 23c")
            rids += more
            got.update(got_more)
            _await_load(router, b, 3, "phase 23c")
            down = tick_until("down", 10)
            _collect_streams(c, rids, got, "phase 23c")
            _no_second_terminal(c, rids, "phase 23c")
        k1, k5 = _fleet_launches("phase 23c", cfg32, bf16=False)
    finally:
        router.stop()
        prov.stop()
    if up[-1] != "up" or down[-1] != "down" or len(drains) != 1:
        fail(f"phase 23c: ticks {up} then {down}, drains {drains}")
    if drains[0]["replica"] != b or drains[0]["migrated"] == 0:
        fail(f"phase 23c: the scale-down drained {drains[0]}, not the "
             f"warmed replica's live streams")
    outs = [got[r] for r in rids]
    if [len(o) for o in outs] != [budget] * 8:
        fail(f"phase 23c: streams of {[len(o) for o in outs]} tokens")
    equal, diffs = _near_ties("phase 23c f32", params32, cfg32, prompts,
                              outs, unscaled.outputs, 1e-4)
    del params32
    print(f"[23c] f32 in process on {card}: 'up' at tick {len(up)}, 3 streams "
          f"placed on the warmed replica, 'down' at tick {len(down)} drained "
          f"it ({drains[0]['migrated']} migrated, {drains[0]['wall_s']:.3f}s);"
          f" {equal}/8 streams of {budget} tokens equal to the unscaled "
          f"colocated run (first differences {diffs}, each a near-tie within "
          f"1e-4); K1 {k1}, K5 {k5}", flush=True)
    rep["f32"] = dict(up_ticks=len(up), down_ticks=len(down),
                      drain=drains[0], equal=equal, diffs=diffs, k1=k1,
                      k5=k5)
    return k1, k5


def phase_fleet(report, card, serve):
    """[23] fleet operations over port replicas on the card: phase 5's
    ``small`` bf16 weights, 8 slots. The v2 ``serve_lm`` process boots on
    a thread while (a) runs. Returns (K1, K5) launched by the phase's
    in-process replicas (the process replica's are its own)."""
    import threading
    from tony_tpu_torch.serving.fleet import SubprocessProvider
    t_phase = time.perf_counter()
    report["fleet"] = rep = {}
    params, cfg = serve["params"], serve["cfg"]
    procs = SubprocessProvider([sys.executable, *FLEET_ARGV],
                               spawn_timeout_s=60)
    boot = {}

    def grow():
        t = time.perf_counter()
        try:
            boot["addr"] = procs.grow(1)[0]
        except RuntimeError as e:
            boot["error"] = str(e)[-3000:]
        boot["s"] = time.perf_counter() - t

    path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(filter(None, (HERE, path)))
    booting = threading.Thread(target=grow, name="tony-fleet-boot",
                               daemon=True)
    booting.start()
    walls = {}
    try:
        t0 = time.perf_counter()
        a1, a5 = _fleet_autoscale(rep, card, params, cfg)
        walls["23a"] = time.perf_counter() - t0
        booting.join(timeout=90)
        t0 = time.perf_counter()
        b1, b5 = _fleet_upgrade(rep, card, params, cfg, procs, boot)
        walls["23b"] = time.perf_counter() - t0
    finally:
        booting.join(timeout=90)
        procs.release(list(procs._procs))
        if path is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = path
    t0 = time.perf_counter()
    c1, c5 = _fleet_f32(rep, card, params, cfg)
    walls["23c"] = time.perf_counter() - t0
    rep["wall_s"] = time.perf_counter() - t_phase
    rep["walls_s"] = walls
    print(f"[23] phase wall {rep['wall_s']:.1f}s ("
          + ", ".join(f"{k} {v:.1f}s" for k, v in walls.items())
          + f") on {card}", flush=True)
    return a1 + b1 + c1, a5 + b5 + c5


def slot_bytes(cfg, kv_dtype) -> int:
    """Cache bytes per slot position of ``cfg`` with ``kv_dtype``."""
    from tony_tpu_torch.models import decode as D
    c = D.init_kv_cache(cfg.scaled(kv_cache_dtype=kv_dtype), 1, 1,
                        device="cpu")
    return sum(t.numel() * t.element_size() for t in D._kv_bufs(c).values())


def _lat_text(lat) -> str:
    return (f"TTFT p50 {lat['ttft_p50']:.1f} ms p99 {lat['ttft_p99']:.1f} "
            f"ms, ITL p50 {lat['itl_p50']:.2f} ms p99 {lat['itl_p99']:.2f} "
            f"ms ({lat['n']} requests)")


# phase 24: tensor-parallel decoding (emulated tp ranks on one card) and
# hybrid meshes. Prompts, new tokens, the profiled steps a run, the beam's
# prompts, width and tokens, and the hybrid-mesh steps' batch
TP_PROMPTS, TP_NEW, TP_PROFILED = 8, 32, 4
TP_BEAM = (2, 64, 4, 16)
TP_HYBRID = (3, 8, 512)


def _tp_counts():
    """(zero, read) of K1, K2, K3a, K3b, K5 and K6's launch counts."""
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import norms as N

    def zero():
        A.reset_launches()
        N.rms_norm_forward.launches = 0
        N.layer_norm_forward.launches = 0

    def read():
        return dict(k1=A.flash_forward.launches,
                    k2=A.flash_backward_fused.launches,
                    k3a=A.flash_backward_dq.launches,
                    k3b=A.flash_backward_dkv.launches,
                    k5=N.rms_norm_forward.launches,
                    k6=N.layer_norm_forward.launches)
    return zero, read


def _tp_stream(params, cfg, prompts, new, mesh=None, forced=None,
               profiled=0):
    """Greedy decoding of ragged ``prompts`` as a user runs it without
    the batcher: ``prefill_rows`` of the padded prompts, ``place_rows``
    into a cache of ``init_kv_cache``, then ``decode_step`` with per-row
    frontiers, on ``mesh`` (a dict of sizes: every tp rank emulated) or
    unsharded. ``forced`` ``[B, new]`` feeds those tokens back instead of
    the run's own (teacher forcing). The last ``profiled`` decode steps
    run under torch.profiler. Returns (tokens ``[B, new]`` the run's
    argmaxes, f32 logits ``[B, new, V]``, {launches, device_ms, wall_ms}
    a profiled step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tony_tpu_torch.models import decode as D
    sp = D.shard_params(params, cfg, mesh) if mesh else params
    b, s_b = len(prompts), max(len(p) for p in prompts)
    pad = torch.zeros((b, s_b), dtype=torch.long)
    for i, p in enumerate(prompts):
        pad[i, :len(p)] = torch.tensor(p)
    lens = [len(p) for p in prompts]
    lengths = torch.tensor(lens, device="cuda")
    logits, mini = D.prefill_rows(sp, pad.cuda(), lengths, cfg)
    cache = D.init_kv_cache(cfg, b, s_b + new, device="cuda", mesh=mesh)
    cache["length"] = torch.zeros(b, dtype=torch.int32, device="cuda")
    cache = D.place_rows(cache, mini, list(range(b)), lengths)
    pos = lengths.clone()
    toks, outs, stats = [], [], {}
    prof, t0 = None, 0.0
    for i in range(new):
        outs.append(logits.float())
        toks.append(outs[-1].argmax(dim=-1))
        if i == new - 1:
            break
        if i == new - 1 - profiled and profiled:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            t0 = time.perf_counter()
        feed = toks[-1] if forced is None else forced[:, i]
        logits, cache = D.decode_step(sp, feed, cache, pos, cfg,
                                      pos_range=(min(lens) + i,
                                                 max(lens) + i))
        pos = pos + 1
    if prof is not None:
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.__exit__(None, None, None)
        dev, launches = _device_times(prof)
        stats = dict(launches=launches / profiled,
                     device_ms=sum(dev.values()) / 1e3 / profiled,
                     wall_ms=wall * 1e3 / profiled)
    return torch.stack(toks, dim=1), torch.stack(outs, dim=1), stats


def _tp_add(launches, c):
    for k in launches:
        launches[k] += c[k]


def _tp_check_launches(what, c, cfg, tp, prefills, forwards):
    """Fail unless K1 ran n_layers × tp times a prefill and K5 (2 ×
    n_layers + 1) × tp times a forward."""
    k1, k5 = cfg.n_layers * tp * prefills, \
        (2 * cfg.n_layers + 1) * tp * forwards
    if c["k1"] != k1 or c["k5"] != k5 or c["k2"] or c["k3a"] or c["k3b"]:
        fail(f"phase 24: {what}: launches {c}, expected K1 {k1} "
             f"(n_layers x {tp} x {prefills} prefills), K5 {k5} ((2 x "
             f"n_layers + 1) x {tp} x {forwards} forwards)")


def _tp_bf16_case(out, label, p16, p32, cfg16, prompts, tps, launches):
    """bf16 tensor-parallel streams against the unsharded bf16 run of the
    same weights: each tp run teacher-forced on the unsharded tokens,
    its logits within ``bound`` = twice the unsharded step's bf16-vs-f32
    spread (the f32 twin ``p32`` teacher-forced on the same tokens), and
    the first token where its greedy choice differs at a near tie by
    that bound on the unsharded logits. Returns the runs' profiled step
    stats by tp."""
    import torch
    zero, read = _tp_counts()
    cfg32 = cfg16.scaled(dtype=torch.float32)
    zero()
    base_t, base_l, base_s = _tp_stream(p16, cfg16, prompts, TP_NEW,
                                        profiled=TP_PROFILED)
    ref_t, ref_l, _ = _tp_stream(p32, cfg32, prompts, TP_NEW,
                                 forced=base_t)
    c = read()
    _tp_check_launches(f"{label} unsharded bf16 and f32", c, cfg16, 1, 2,
                       2 * TP_NEW)
    _tp_add(launches, c)
    spread = (base_l - ref_l).abs().max().item()
    bound = 2 * spread
    rec = dict(spread=spread, bound=bound, steps={1: base_s}, tp={})
    for tp in tps:
        zero()
        got_t, got_l, st = _tp_stream(p16, cfg16, prompts, TP_NEW,
                                      {"tp": tp}, forced=base_t,
                                      profiled=TP_PROFILED)
        c = read()
        _tp_check_launches(f"{label} tp {tp}", c, cfg16, tp, 1, TP_NEW)
        _tp_add(launches, c)
        err = (got_l - base_l).abs().max().item()
        diff = got_t != base_t
        ties = []
        for row in range(diff.shape[0]):
            if bool(diff[row].any()):
                j = int(diff[row].nonzero()[0])
                lg = base_l[row, j]
                ties.append((row, j, (lg[base_t[row, j]]
                                      - lg[got_t[row, j]]).abs().item()))
        equal = int((~diff).all(dim=1).sum())
        rec["steps"][tp] = st
        rec["tp"][tp] = dict(max_abs_err=err, equal=equal, ties=ties,
                             launches=c)
        print(f"[24a] {label} bf16 tp {tp} (emulated): teacher-forced "
              f"logits max |tp - unsharded| {err:.4e} (bound {bound:.4e} = "
              f"2 x the unsharded bf16-vs-f32 spread {spread:.4e}); greedy "
              f"{equal}/{len(prompts)} streams equal, first differences "
              f"(row, step, logit gap) {ties}; launches {c}", flush=True)
        if not err <= bound:
            fail(f"phase 24a: {label} tp {tp}: logits {err:.4e} from the "
                 f"unsharded run's, beyond {bound:.4e}")
        if any(not gap <= bound for _, _, gap in ties):
            fail(f"phase 24a: {label} tp {tp}: a greedy token differs "
                 f"where the logits are more than {bound:.4e} apart: "
                 f"{ties}")
    out[label] = rec
    return rec


def _tp_decode(out, card, serve):
    """24a: the decode streams (see the module docstring)."""
    import torch
    from tony_tpu_torch import tree_map
    from tony_tpu_torch.models import decode as D
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.models.quantize import quantize_weights_int8
    zero, read = _tp_counts()
    launches = dict.fromkeys(("k1", "k2", "k3a", "k3b", "k5"), 0)
    cfg16, p16 = serve["cfg"], serve["params"]
    prompts = [list(map(int, p)) for p in serve["prompts"][:TP_PROMPTS]]
    cfg32 = cfg16.scaled(dtype=torch.float32)
    p32 = tree_map(lambda t: t.float(), p16)
    # f32: every tp run token-identical to the unsharded run
    t0 = time.perf_counter()
    zero()
    base_t, _, _ = _tp_stream(p32, cfg32, prompts, TP_NEW)
    c = read()
    _tp_check_launches("f32 unsharded", c, cfg32, 1, 1, TP_NEW)
    _tp_add(launches, c)
    out["f32"] = {}
    for tp in (2, 4):
        zero()
        got_t, _, _ = _tp_stream(p32, cfg32, prompts, TP_NEW, {"tp": tp})
        c = read()
        _tp_check_launches(f"f32 tp {tp}", c, cfg32, tp, 1, TP_NEW)
        _tp_add(launches, c)
        equal = int((got_t == base_t).all(dim=1).sum())
        out["f32"][tp] = dict(equal=equal, launches=c)
        print(f"[24a] small f32 tp {tp} (emulated) on {card}: "
              f"{equal}/{len(prompts)} streams of {TP_NEW} tokens equal to "
              f"the unsharded run; launches {c}", flush=True)
        if equal != len(prompts):
            fail(f"phase 24a: f32 tp {tp}: {equal}/{len(prompts)} streams "
                 f"equal to the unsharded run")
    out["f32_s"] = time.perf_counter() - t0
    # bf16: dense at tp 2 and 4, GQA at tp 4, int8 weights at tp 2
    t0 = time.perf_counter()
    dense = _tp_bf16_case(out, "small", p16, p32, cfg16, prompts, (2, 4),
                          launches)
    cfg_g = cfg16.scaled(n_kv_heads=2)
    pg16 = T.init_params(torch.Generator().manual_seed(24), cfg_g, "cuda")
    _tp_bf16_case(out, "small GQA kv 2", pg16,
                  tree_map(lambda t: t.float(), pg16), cfg_g, prompts, (4,),
                  launches)
    del pg16
    _tp_bf16_case(out, "small int8 weights", quantize_weights_int8(p16),
                  quantize_weights_int8(p32), cfg16, prompts, (2,),
                  launches)
    out["bf16_s"] = time.perf_counter() - t0
    # a beam over 2 prompts at tp 2, f32
    t0 = time.perf_counter()
    nb, sb, width, bnew = TP_BEAM
    prompt = torch.tensor([p[:sb] for p in prompts[:nb]], device="cuda")
    zero()
    want = D.beam_search(p32, prompt, cfg32, bnew, beam_width=width)
    c1 = read()
    zero()
    got = D.beam_search(p32, prompt, cfg32, bnew, beam_width=width,
                        mesh={"tp": 2})
    c2 = read()
    _tp_check_launches("beam unsharded", c1, cfg32, 1, 1, bnew)
    _tp_check_launches("beam tp 2", c2, cfg32, 2, 1, bnew)
    _tp_add(launches, c1)
    _tp_add(launches, c2)
    same = torch.equal(got.tokens, want.tokens)
    serr = (got.scores - want.scores).abs().max().item()
    out["beam"] = dict(equal=same, scores_err=serr, launches=c2,
                       wall_s=time.perf_counter() - t0)
    print(f"[24a] small f32 beam width {width} over {nb} prompts of {sb}, "
          f"{bnew} tokens, tp 2 (emulated): tokens equal {same}, scores "
          f"max |tp - unsharded| {serr:.3e}; launches {c2}", flush=True)
    if not same or not serr <= 1e-3:
        fail(f"phase 24a: beam at tp 2: tokens equal {same}, scores "
             f"{serr:.3e} apart")
    steps = dense["steps"]
    print("[24a] small bf16 decode step at batch 8 (last "
          f"{TP_PROFILED} steps of a stream, profiled) on {card}: "
          + "; ".join(f"tp {tp}: {st['launches']:.1f} launches, "
                      f"{st['device_ms']:.3f} ms device, {st['wall_ms']:.2f}"
                      f" ms wall" for tp, st in steps.items()), flush=True)
    out["launches"] = launches
    return launches


def _hybrid_mesh_steps(out, card):
    """24b: train_lm's sharded path at world 1 (NCCL) on the hybrid mesh
    of dcn ``{"dp": 1}`` × ``{"fsdp": -1}`` and on the flat ``{"fsdp":
    -1}``, 3 steps each from the same seeds on the two-pass backward (K3a
    and K3b; K2 adds dQ with atomics, so its bits vary from run to run):
    bitwise equal losses; then ``train_lm`` itself on the hybrid mesh.
    Returns the launches of the three runs."""
    import torch.distributed as dist
    import tony_tpu_torch.runtime as rt
    from tony_tpu_torch import train_lm
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.parallel import mesh_shape
    zero, read = _tp_counts()
    steps, batch, seq = TP_HYBRID
    launches = dict.fromkeys(("k1", "k2", "k3a", "k3b", "k5"), 0)
    losses, shapes = {}, {}
    budget = A._FUSED_PARTIALS_BYTES
    A._FUSED_PARTIALS_BYTES = 0
    try:
        for name, axes, dcn in (("hybrid", {"fsdp": -1}, {"dp": 1}),
                                ("flat", {"fsdp": -1}, None)):
            _world1_env(axes, dcn)
            rt.initialize()
            mesh = rt.mesh()
            shapes[name] = mesh_shape(mesh)
            cfg, params = train_lm.build("small", "cuda")
            zero()
            _, losses[name], _, _ = _train_run(cfg, params, steps,
                                               batch=batch, seq=seq,
                                               mesh=mesh)
            c = read()
            L = cfg.n_layers
            if (c["k1"], c["k2"], c["k3a"], c["k3b"], c["k5"]) != (
                    2 * L * steps, 0, L * steps, L * steps,
                    (4 * L + 1) * steps):
                fail(f"phase 24b: {name} mesh: launches {c}")
            _tp_add(launches, c)
    finally:
        A._FUSED_PARTIALS_BYTES = budget
    backend = dist.get_backend()
    rt.shutdown()
    zero()
    rc, lines = _train_lm_cli(["--preset", "small", "--steps", str(steps),
                               "--batch_size", str(batch), "--seq_len",
                               str(seq)], {"fsdp": -1}, {"dp": 1})
    _tp_add(launches, read())
    head = [x for x in lines if " mesh=" in x]
    done = [x for x in lines if x.startswith("done: final loss ")]
    out["hybrid"] = dict(shapes=shapes, losses=losses, cli=head + done,
                         backend=backend)
    print(f"[24b] small bf16 {batch} x {seq}, {steps} steps, NCCL world 1 "
          f"({backend}) on {card}: hybrid mesh {shapes['hybrid']} losses "
          f"{losses['hybrid']}, flat {shapes['flat']} losses "
          f"{losses['flat']}; train_lm on the hybrid mesh: {head} {done}",
          flush=True)
    if shapes != {"hybrid": {"dp": 1, "fsdp": 1}, "flat": {"fsdp": 1}} or \
            backend != "nccl":
        fail(f"phase 24b: meshes {shapes} on {backend}")
    if losses["hybrid"] != losses["flat"]:
        fail(f"phase 24b: hybrid-mesh losses {losses['hybrid']} are not "
             f"the flat mesh's {losses['flat']}")
    if rc != 0 or not done or not head or \
            "mesh={'dp': 1, 'fsdp': 1}" not in head[0]:
        fail(f"phase 24b: train_lm on the hybrid mesh: exit {rc}, lines "
             f"{lines[-3:]}")
    return launches


def phase_tp(report, card, serve):
    """[24] Tensor-parallel decoding over emulated tp ranks and hybrid
    meshes at world 1 (module docstring). tp ranks over NCCL need a host
    with more cards. Returns the launches (K1, K5)."""
    t_phase = time.perf_counter()
    out = {}
    launches = _tp_decode(out, card, serve)
    out["decode_s"] = time.perf_counter() - t_phase
    _tp_add(launches, _hybrid_mesh_steps(out, card))
    out["wall_s"] = time.perf_counter() - t_phase
    out["launches"] = launches
    print(f"[24] phase wall {out['wall_s']:.1f}s (24a {out['decode_s']:.1f}"
          f"s: f32 {out['f32_s']:.1f}, bf16 {out['bf16_s']:.1f}, beam "
          f"{out['beam']['wall_s']:.1f}); launches {launches}; tp ranks "
          f"over NCCL need a host with more cards", flush=True)
    report["tp"] = out
    return launches


RN_BATCHES = (32, 128)
# cut from 3 + 10 steps for the whole script's 1200 s limit
RN_WARM, RN_TIMED, RN_PROFILED = 2, 6, 3
RN_IMAGE, RN_CLASSES, RN_DEPTH = 224, 1000, 50
RN_DEVICE = "cuda"
RN_PARITY_BATCH = 4
MNIST_BATCH = 256


def resnet_train_flops_per_image(depth: int, image: int,
                                 classes: int) -> float:
    """Model FLOPs of one training image, from the conv and head shapes:
    2 a multiply-add, times 3 (the forward, and a backward of twice
    its work). Norms, pools and ReLUs are not counted."""
    from tony_tpu_torch.models import resnet as R
    macs = 0

    def conv(h, k, s, cin, cout):
        nonlocal macs
        out = -(-h // s)
        macs += out * out * k * k * cin * cout
        return out

    h = -(-conv(image, 7, 2, 3, 64) // 2)       # the stem, the pool
    in_c = 64
    for si, blocks in enumerate(R.STAGE_SIZES[depth]):
        width = 64 * 2 ** si
        for bi in range(blocks):
            s = 2 if bi == 0 and si > 0 else 1
            if bi == 0:
                conv(h, 1, s, in_c, 4 * width)
            conv(h, 1, 1, in_c, width)
            h = conv(h, 3, s, width, width)
            conv(h, 1, 1, width, 4 * width)
            in_c = 4 * width
    macs += in_c * classes
    return 6.0 * macs


def _rn_images(n, size, seed, device):
    """A batch of the entry point's shape, made on ``device`` from a
    seed: the timed steps measure the step, not the host's numpy."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return {"image": torch.randn((n, size, size, 3), generator=g,
                                 device=device),
            "label": torch.randint(0, RN_CLASSES, (n,), generator=g,
                                   device=device, dtype=torch.int32)}


def _rn_setup(dtype, mesh=None, seed=0, lr=0.1, classes=RN_CLASSES):
    """(state, step) of train_resnet's code path on the card: random
    weights from ``seed``, SGD nesterov at ``lr``."""
    import torch
    from tony_tpu_torch import train_resnet
    from tony_tpu_torch.models import resnet as R
    from tony_tpu_torch.models.train import (SGD, init_state,
                                             replicated_axes)
    params, stats = R.init_resnet(torch.Generator().manual_seed(seed),
                                  RN_DEPTH, classes, dtype,
                                  device=RN_DEVICE)
    opt = SGD(lr, momentum=0.9, nesterov=True)
    return (dict(init_state(params, opt, mesh, replicated_axes(params)),
                 stats=stats),
            train_resnet.make_step(opt, RN_DEPTH, dtype, mesh))


#: substrings of the kernels cuDNN and cuBLAS run for the convolutions
#: and the head's product
_RN_CONV_NAMES = ("xmma", "cudnn", "conv", "implicit", "cutlass", "gemm",
                  "nhwc", "Nhwc", "sm90_", "sm80_")


def _rn_classes(prof) -> dict:
    """{class: [device microseconds, launches]} of a profiled window:
    ``conv`` (cuDNN's and cuBLAS's kernels), ``elementwise`` (PyTorch's
    elementwise and reduction kernels: the norms' f32 arithmetic, ReLUs,
    residual adds, casts and the optimizer), ``other``."""
    out = {"conv": [0.0, 0], "elementwise": [0.0, 0], "other": [0.0, 0]}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0:
            continue
        name = e.key
        cls = ("conv" if any(n in name for n in _RN_CONV_NAMES) else
               "elementwise" if "at::native" in name and (
                   "elementwise" in name or "reduce" in name) else "other")
        out[cls][0] += us
        out[cls][1] += e.count
    return out


def _rn_throughput(out, card, batch, flops):
    """25a at one batch size: RN_WARM steps, then RN_TIMED, the wall of
    all but the last RN_PROFILED, which run under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batches = [_rn_images(batch, RN_IMAGE, s, RN_DEVICE) for s in (1, 2)]
    torch.cuda.reset_peak_memory_stats()
    state, step = _rn_setup(torch.bfloat16)
    losses = []
    for i in range(RN_WARM):
        state, m = step(state, batches[i % 2])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = RN_TIMED - RN_PROFILED
    for i in range(timed):
        state, m = step(state, batches[i % 2])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / timed
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(RN_PROFILED):
            state, m = step(state, batches[i % 2])
            losses.append(m["loss"])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev, launches = _device_times(prof)
    classes = {k: (us / 1e3 / RN_PROFILED, n / RN_PROFILED)
               for k, (us, n) in _rn_classes(prof).items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 25a: batch {batch}: losses {losses}")
    total_us = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:5]
    img_s = batch / wall
    row = dict(batch=batch, step_ms=wall * 1e3, images_s=img_s,
               mfu=flops * img_s / BF16_FLOPS,
               device_ms=total_us / 1e3 / RN_PROFILED if total_us else None,
               launches=launches / RN_PROFILED,
               busy=total_us / 1e6 / prof_wall if total_us else None,
               peak_gib=peak, losses=losses, classes=classes,
               top=[(n, us / 1e3 / RN_PROFILED) for n, us in top])
    out.setdefault("train", []).append(row)
    print(f"[25a] ResNet-50 bf16 {batch} x {RN_IMAGE}^2 on {card}: step "
          f"{row['step_ms']:.2f} ms, {img_s:,.1f} images/s, MFU "
          f"{row['mfu']:.4f}; {RN_PROFILED} profiled steps: "
          f"{_ms(row['device_ms'])} device and {row['launches']:.1f} "
          f"launches a step, busy share "
          + ("not measured" if row["busy"] is None else f"{row['busy']:.3f}")
          + f"; peak {peak:.2f} GiB; losses {losses[0]:.4f} .. "
          f"{losses[-1]:.4f}; a step by class: "
          + ", ".join(f"{k} {ms:.2f} ms in {n:.1f} launches"
                      for k, (ms, n) in classes.items())
          + "; top: "
          + "; ".join(f"{n[:56]} {ms:.2f} ms" for n, ms in row["top"]),
          flush=True)


def _rn_cli_start():
    """``python -m tony_tpu_torch.train_resnet --steps 3`` on the card,
    as a user runs it (a lone process: its world-1 group in memory)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TONY_JAX_", "TONY_MESH_SPEC"))}
    env["PYTHONPATH"] = HERE
    return subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.train_resnet", "--steps",
         "3"], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _rn_cli_finish(out, proc, t0):
    try:
        text, _ = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        proc.kill()
        text, _ = proc.communicate()
        fail(f"phase 25a: train_resnet did not finish in 240 s: "
             f"{text[-2000:]}")
    lines = text.splitlines()
    out["cli"] = dict(rc=proc.returncode, lines=lines[-6:],
                      wall_s=time.perf_counter() - t0)
    print(f"[25a] python -m tony_tpu_torch.train_resnet --steps 3: exit "
          f"{proc.returncode} in {out['cli']['wall_s']:.1f} s: "
          f"{lines[:1] + lines[-2:]}", flush=True)
    if proc.returncode != 0 or not any(x.startswith("done: final loss ")
                                       for x in lines):
        fail(f"phase 25a: train_resnet exit {proc.returncode}: "
             f"{text[-2000:]}")


def _tree_err(got, want) -> float:
    """The largest error of any leaf over that leaf's largest entry."""
    from tony_tpu_torch import tree_leaves
    return max(float((g.float().cpu() - w.float().cpu()).abs().max()
                     / max(float(w.float().abs().max()), 1e-30))
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def _rn_parity(out, card):
    """25b: at one set of f32 weights and one batch of RN_PARITY_BATCH at
    RN_IMAGE, forward(train=True) on the card against the CPU (logits,
    new statistics), bf16 against f32 on the card, and each norm's new
    statistics after a step against 0.9 · old + 0.1 · the batch's (the
    mean and biased variance of the norm's input, in f64)."""
    import torch
    from tony_tpu_torch import tree_map
    from tony_tpu_torch.models import resnet as R
    params, stats = R.init_resnet(torch.Generator().manual_seed(1),
                                  RN_DEPTH, RN_CLASSES, torch.float32,
                                  device="cpu")
    x = _rn_images(RN_PARITY_BATCH, RN_IMAGE, 3, "cpu")
    with torch.no_grad():
        want, want_s = R.forward(params, stats, x["image"], RN_DEPTH)
        dev = lambda t: t.to(RN_DEVICE)                     # noqa: E731
        p32, s32 = tree_map(dev, params), tree_map(dev, stats)
        img = x["image"].to(RN_DEVICE)
        got, got_s = R.forward(p32, s32, img, RN_DEPTH)
        p16 = tree_map(lambda t: t.to(torch.bfloat16), p32)
        b16, _ = R.forward(p16, s32, img.to(torch.bfloat16), RN_DEPTH)
    scale = float(want.abs().max())
    logit_err = float((got.cpu() - want).abs().max()) / scale
    stat_err = _tree_err(got_s, want_s)
    bf16_l2 = float((b16 - got).norm() / got.norm())
    # the statistics' rule, on two steps of the f32 model on the card
    state, step = _rn_setup(torch.float32, seed=1)
    batch = {k: v.to(RN_DEVICE) for k, v in x.items()}
    seen = []
    orig = R._batch_norm

    def recording(x, p, s, train, momentum=0.9, eps=1e-5, lay=None):
        y, new = orig(x, p, s, train, momentum, eps, lay)
        seen.append((x.detach().double(), s, new))
        return y, new

    losses = []
    state, m = step(state, batch)
    losses.append(float(m["loss"]))
    R._batch_norm = recording
    try:
        state, m = step(state, batch)
    finally:
        R._batch_norm = orig
    losses.append(float(m["loss"]))
    rule_err = 0.0
    for xin, old, new in seen:
        mean = xin.mean(dim=(0, 1, 2))
        var = xin.var(dim=(0, 1, 2), unbiased=False)
        for k, batch_v in (("mean", mean), ("var", var)):
            want_v = 0.9 * old[k].double() + 0.1 * batch_v
            rule_err = max(rule_err, float(
                (new[k].double() - want_v).abs().max()
                / max(float(want_v.abs().max()), 1e-30)))
    out["parity"] = dict(logit_err=logit_err, stat_err=stat_err,
                         bf16_l2=bf16_l2, rule_err=rule_err,
                         norms=len(seen), losses=losses)
    print(f"[25b] f32 forward(train=True) at {RN_PARITY_BATCH} x "
          f"{RN_IMAGE}^2, card ({card}) against the CPU: logits "
          f"{logit_err:.3e} of the largest (limit 1e-3), statistics "
          f"{stat_err:.3e} (limit 1e-3); bf16 logits against f32 "
          f"{bf16_l2:.4f} in relative L2 (limit 0.25); after a step, "
          f"{len(seen)} norms' statistics against 0.9 old + 0.1 batch "
          f"(biased variance): {rule_err:.3e} (limit 1e-4); losses "
          f"{losses}", flush=True)
    if logit_err > 1e-3 or stat_err > 1e-3 or bf16_l2 > 0.25 or \
            rule_err > 1e-4 or len(seen) != 53 or not all(
                math.isfinite(v) for v in losses):
        fail(f"phase 25b: {out['parity']}")


def _rn_dp_mesh(out, card):
    """25c: 3 steps of batch 32 through the mesh path on a world-1 NCCL
    ``{"dp": 1}`` against 3 plain steps from the same weights and
    batches, cuDNN deterministic: bitwise. The rules drop an axis of
    size 1 (as the reference's do), so a world-1 layout has no data
    group; here its layouts are given the dp group, and sync-BN's
    all-reduces (and their all-reduce backwards) run over NCCL."""
    import torch
    import torch.distributed as dist
    import tony_tpu_torch.runtime as rt
    from tony_tpu_torch.parallel import mesh_shape, spmd
    batches = [_rn_images(32, RN_IMAGE, s, RN_DEVICE) for s in (4, 5, 6)]
    syncs = []
    orig_sync, orig_init = spmd.Layout.sync_data, spmd.Layout.__init__

    def counting(self, x):
        syncs.append(len(self._data_groups))
        return orig_sync(self, x)

    def with_dp_group(self, mesh, *args, **kw):
        orig_init(self, mesh, *args, **kw)
        self._data_groups = self._data_groups or [mesh.get_group("dp")]

    losses = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _world1_env({"dp": -1})
    spmd.Layout.sync_data = counting
    spmd.Layout.__init__ = with_dp_group
    try:
        rt.initialize(RN_DEVICE)
        mesh = rt.mesh(device=RN_DEVICE)
        shape, backend = mesh_shape(mesh), dist.get_backend()
        for name, m in (("plain", None), ("mesh", mesh)):
            state, step = _rn_setup(torch.bfloat16, mesh=m)
            losses[name] = []
            for b in batches:
                state, metrics = step(state, b)
                losses[name].append(float(metrics["loss"]))
    finally:
        spmd.Layout.sync_data, spmd.Layout.__init__ = orig_sync, orig_init
        torch.backends.cudnn.deterministic = det
        rt.shutdown()
    out["dp"] = dict(shape=shape, backend=backend, losses=losses,
                     syncs=len(syncs), groups=sorted(set(syncs)))
    print(f"[25c] batch 32, 3 steps on {card}: mesh {shape} ({backend}) "
          f"losses {losses['mesh']}, plain {losses['plain']}; "
          f"{len(syncs)} sync-BN all-reduces over "
          f"{sorted(set(syncs))} group(s)", flush=True)
    if shape != {"dp": 1} or backend != "nccl" or \
            losses["mesh"] != losses["plain"] or \
            len(syncs) != 2 * 53 * 3 or set(syncs) != {1}:
        fail(f"phase 25c: {out['dp']}")


def _mnist(out, card):
    """25d: mnist_distributed's loop as the JAX script runs it (200
    steps, global batch 256, hidden 256) in this process on a world-1
    NCCL runtime; then ``mlp_forward`` and ``cnn_forward`` at batch 256
    on the card against the CPU (f32)."""
    import contextlib
    import io

    import torch
    import tony_tpu_torch.runtime as rt
    from tony_tpu_torch import mnist_distributed, tree_map
    from tony_tpu_torch.models import mnist as M
    _world1_env({"dp": -1})
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            rc = mnist_distributed.main(["--device", RN_DEVICE])
    finally:
        rt.shutdown()
    lines = text.getvalue().splitlines()
    done = [x for x in lines if x.startswith("done: ")]
    m = re.search(r"\((\d+) img/s\).* acc ([\d.]+)", done[0] if done
                  else "")
    errs = {}
    for name, init, fwd in (("mlp", M.init_mlp, M.mlp_forward),
                            ("cnn", M.init_cnn, M.cnn_forward)):
        params = init(torch.Generator().manual_seed(2), device="cpu")
        x = M.synthetic_batch(torch.Generator().manual_seed(3),
                              MNIST_BATCH, device="cpu")["image"]
        with torch.no_grad():
            want = fwd(params, x)
            got = fwd(tree_map(lambda t: t.to(RN_DEVICE), params),
                      x.to(RN_DEVICE)).cpu()
        errs[name] = float((got - want).abs().max() / want.abs().max())
    out["mnist"] = dict(rc=rc, lines=lines[-3:], errs=errs,
                        img_s=int(m.group(1)) if m else None,
                        acc=float(m.group(2)) if m else None)
    print(f"[25d] mnist_distributed on {card} (200 steps, global batch "
          f"256, hidden 256): {done[:1]}, exit {rc}; f32 at batch "
          f"{MNIST_BATCH}, card against the CPU: mlp_forward "
          f"{errs['mlp']:.3e}, cnn_forward {errs['cnn']:.3e} of the "
          f"largest logit (limit 1e-4)", flush=True)
    if rc != 0 or m is None or float(m.group(2)) < 0.95 or \
            max(errs.values()) > 1e-4:
        fail(f"phase 25d: {out['mnist']}")


def phase_resnet(report, card):
    """[25] ResNet-50 data-parallel training with sync-BN and the MNIST
    recipe (module docstring). No kernel of the port's is on this path:
    cuDNN's convolutions stand where XLA's do in the reference."""
    t_phase = time.perf_counter()
    out = {}
    flops = resnet_train_flops_per_image(RN_DEPTH, RN_IMAGE, RN_CLASSES)
    out["flops_per_image"] = flops
    print(f"[25a] ResNet-{RN_DEPTH} at {RN_IMAGE}^2, {RN_CLASSES} classes: "
          f"{flops / 1e9:.3f} G model FLOPs a training image (convs and "
          f"head, 6 a multiply-add)", flush=True)
    # the entry point's process first, beside the checks; the timed steps
    # after it has exited, with the card and the host to themselves
    t_cli = time.perf_counter()
    cli = _rn_cli_start()
    try:
        _rn_parity(out, card)
        _rn_dp_mesh(out, card)
        _mnist(out, card)
    except BaseException:
        cli.kill()
        cli.wait()
        raise
    out["checks_s"] = time.perf_counter() - t_cli
    _rn_cli_finish(out, cli, t_cli)
    t_train = time.perf_counter()
    for batch in RN_BATCHES:
        _rn_throughput(out, card, batch, flops)
    out["train_s"] = time.perf_counter() - t_train
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[25] phase wall {out['wall_s']:.1f}s (25b-d {out['checks_s']:.1f}"
          f" s beside the train_resnet process's {out['cli']['wall_s']:.1f}"
          f" s, then 25a's steps {out['train_s']:.1f} s)", flush=True)
    report["resnet"] = out


#: phase 26's shapes: the MoE routing arm and step (batch, sequence,
#: experts, emulated cp ranks), the pipelined steps (batch, sequence),
#: BERT's steps (batch, sequence) and the MoE decode (prompts, new
#: tokens, their shortest and longest prompt)
COMBO_MOE = (2, 4096, 8, 4)
COMBO_PP = (8, 1024)
COMBO_BERT = (16, 512)
COMBO_DECODE = (8, 16, 16, 64)
COMBO_DEVICE = "cuda"


def _combo_grads(value_and_grad, params):
    """(loss, grad norm, grads) of ``value_and_grad(params) -> (loss,
    grads)``, the norm in f32 over every leaf."""
    import torch
    from tony_tpu_torch import tree_leaves
    loss, grads = value_and_grad(params)
    flat = tree_leaves(grads)
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in flat))
    return float(loss), float(norm), flat


def _combo_step(label, card, value_and_grad, params, want, timed=True):
    """One gradient step of ``value_and_grad`` counted from 0 (its
    launches must equal ``want``, the keys it names), then, ``timed``
    (bf16: its attention launches all on the tensor cores), a second
    on the host's clock (the first carries a fresh process's one-time
    costs) and a third profiled: (loss, grad norm, grads, record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    zero, read = _tp_counts()
    torch.cuda.synchronize()
    zero()
    t0 = time.perf_counter()
    loss, norm, grads = _combo_grads(value_and_grad, params)
    wall = time.perf_counter() - t0
    c = read()
    if any(c[k] != n for k, n in want.items()):
        fail(f"phase 26 {label}: launches {c}, want {want}")
    if not (math.isfinite(loss) and math.isfinite(norm)):
        fail(f"phase 26 {label}: loss {loss}, grad norm {norm}")
    if not timed:
        return loss, norm, grads, dict(loss=loss, grad_norm=norm,
                                       launches=c, step_ms=wall * 1e3)
    _check_tc_variants(f"phase 26 {label}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _combo_grads(value_and_grad, params)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _combo_grads(value_and_grad, params)
        torch.cuda.synchronize()
    dev, _ = _device_times(prof)
    rec = dict(loss=loss, grad_norm=norm, launches=c,
               step_ms=wall * 1e3,
               device_ms=sum(dev.values()) / 1e3 if dev else None)
    return loss, norm, grads, rec


def _combo_rel(label, rec, ref, loss_lim, norm_lim):
    """Hold ``rec``'s loss and grad norm to ``ref``'s (relative)."""
    rec["loss_rel"] = abs(rec["loss"] - ref["loss"]) / abs(ref["loss"])
    rec["norm_rel"] = (abs(rec["grad_norm"] - ref["grad_norm"])
                       / abs(ref["grad_norm"]))
    if not (rec["loss_rel"] <= loss_lim and rec["norm_rel"] <= norm_lim):
        fail(f"phase 26 {label}: loss {rec['loss']} and grad norm "
             f"{rec['grad_norm']} against {ref['loss']} and "
             f"{ref['grad_norm']}: relative {rec['loss_rel']:.2e}, "
             f"{rec['norm_rel']:.2e} (limits {loss_lim}, {norm_lim})")


def _grad_dist(grads, ref) -> float:
    """The relative L2 distance of ``grads`` from ``ref`` over every
    leaf: |grads - ref| / |ref|, in f32."""
    import torch
    num = sum(((g.float() - r.float()) ** 2).sum()
              for g, r in zip(grads, ref))
    den = sum((r.float() ** 2).sum() for r in ref)
    return float(torch.sqrt(num / den))


def _combo_split(label, run, params, cfg, mesh, want, card):
    """A step split over ``mesh`` (emulated) against the unsplit step,
    bf16 and f32. ``run(cfg, mesh)`` is the step's value_and_grad on
    ``cfg``'s dtype. f32, the check of the function: the split step's
    loss within 1e-5 and grad norm within 1e-4 of the unsplit step's
    (relative). bf16: loss within 1e-3 (phase 9's limit) and grad norm
    within 1e-2 (phase 21's, for a bf16 step split over emulated ranks:
    a bf16 step's grad norm moves by ~1e-3 with the order of its sums
    alone, which a split changes), and the check that can tell rounding
    from a fault: the split bf16 gradient's L2 distance from the unsplit
    f32 gradient within 2x the unsplit bf16 gradient's. ``want(mesh)``
    gives a step's launches. Returns (bf16 unsplit record, bf16 split
    record, every record)."""
    import dataclasses

    import torch
    from tony_tpu_torch import tree_map
    p32 = tree_map(lambda t: t.float(), params)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    recs, grads = {}, {}
    for tag, m in (("unsplit", None), ("split", mesh)):
        _, _, grads[tag], recs[tag] = _combo_step(
            f"{label} bf16 {tag}", card, run(cfg, m), params, want(m))
        _, _, g32, recs[f"{tag}_f32"] = _combo_step(
            f"{label} f32 {tag}", card, run(c32, m), p32, want(m),
            timed=False)
        if tag == "unsplit":
            grads["f32"] = g32
        del g32
    del p32
    ref, r = recs["unsplit"], recs["split"]
    ref32, r32 = recs["unsplit_f32"], recs["split_f32"]
    ref["f32_dist"] = _grad_dist(grads["unsplit"], grads["f32"])
    r["f32_dist"] = _grad_dist(grads["split"], grads["f32"])
    del grads
    torch.cuda.empty_cache()
    _combo_rel(f"{label} f32", r32, ref32, 1e-5, 1e-4)
    _combo_rel(f"{label} bf16 rounding", ref, ref32, float("inf"),
               float("inf"))
    _combo_rel(f"{label} bf16", r, ref, *_BF16_SPLIT_LIMITS)
    if not r["f32_dist"] <= _BF16_DIST_RATIO * ref["f32_dist"]:
        fail(f"phase 26 {label}: the split bf16 gradient lies "
             f"{r['f32_dist']:.4e} from the f32 gradient, the unsplit bf16 "
             f"one {ref['f32_dist']:.4e} (limit {_BF16_DIST_RATIO}x)")
    return ref, r, recs


#: (loss, grad norm) relative limits of a bf16 step split over emulated
#: ranks against the unsplit step: phase 9's and phase 21's
_BF16_SPLIT_LIMITS = (1e-3, 1e-2)
#: the split bf16 gradient's L2 distance from the f32 gradient, at most
#: this many times the unsplit bf16 gradient's
_BF16_DIST_RATIO = 2.0


def _combo_limits(r, ref, r32) -> str:
    """The printed account of :func:`_combo_split`'s checks."""
    return (f"relative to unsplit: loss {r['loss_rel']:.2e}, grad norm "
            f"{r['norm_rel']:.2e} (limits 1e-3, 1e-2; the unsplit bf16 "
            f"step's own distance from f32: {ref['loss_rel']:.2e}, "
            f"{ref['norm_rel']:.2e}); L2 distance of the gradient from "
            f"the f32 one: split {r['f32_dist']:.4e}, unsplit "
            f"{ref['f32_dist']:.4e} (ratio "
            f"{r['f32_dist'] / ref['f32_dist']:.3f}, limit "
            f"{_BF16_DIST_RATIO}); f32 split vs unsplit: loss "
            f"{r32['loss_rel']:.2e} (limit 1e-5), grad norm "
            f"{r32['norm_rel']:.2e} (limit 1e-4)")


def _lm_vag(cfg, batch, mesh, schedule="gpipe"):
    from tony_tpu_torch.models import train as TR
    from tony_tpu_torch.models import transformer as T
    if schedule == "1f1b":
        return lambda p: T.lm_value_and_grad(p, batch, cfg, mesh)
    return lambda p: TR.value_and_grad(
        lambda q, b: T.lm_loss(q, b, cfg, mesh), p, batch)


def _combo_moe(out, card, cfg, params):
    """26a: the MoE cp routing arm over emulated chunks against the
    whole sequence (f32), then a step of the `small` MoE ``params``
    under an emulated cp mesh against the unsplit step. Returns the
    launches."""
    import torch
    import torch.nn.functional as F
    from tony_tpu_torch.parallel import moe as M
    from tony_tpu_torch.parallel import spmd
    t_routing = time.perf_counter()
    b, s, e, cp = COMBO_MOE
    d, f, k, cf = (cfg.d_model, cfg.d_ff, cfg.moe_top_k,
                   cfg.moe_capacity_factor)
    dev = COMBO_DEVICE
    g = torch.Generator(device=dev).manual_seed(26)
    # one offset shared by every token skews the router toward some
    # experts: capacity drops tokens, so the lower chunks' counts decide
    # the upper chunks' slots
    x = (torch.randn((b, s, d), generator=g, device=dev)
         + torch.randn((d,), generator=g, device=dev))
    router = torch.randn((d, e), generator=g, device=dev) * d ** -0.5
    w_in = torch.randn((e, d, f), generator=g, device=dev) * d ** -0.5
    w_out = torch.randn((e, f, d), generator=g, device=dev) * f ** -0.5
    cap = M.default_capacity(s, e, k, cf)
    with torch.no_grad():
        logits = torch.einsum("bsd,de->bse", x, router)
        wd, wc, _ = M.router_dispatch(logits, e, top_k=k, capacity=cap)
        chunks = logits.chunk(cp, dim=1)
        lowers = M._exclusive_scan([M.assignments(M._gates(c, k))
                                    for c in chunks])
        n = s // cp
        slots_equal = True
        for i, (c, lo) in enumerate(zip(chunks, lowers)):
            gd, gc, _ = M.router_dispatch(c, e, top_k=k, capacity=cap,
                                          lower=lo)
            sl = slice(i * n, (i + 1) * n)
            slots_equal &= (torch.equal(gd, wd[:, sl])
                            and torch.equal(gc, wc[:, sl]))
        del wd, wc, gd, gc
        whole, m1 = M.moe_ffn(x, router, w_in, w_out, top_k=k,
                              capacity_factor=cf, activation=F.silu)
        emu, m2 = M.moe_ffn(x, router, w_in, w_out, top_k=k,
                            capacity_factor=cf, activation=F.silu,
                            lay=spmd.EmulatedCp(cp))
    err = (emu - whole).abs().max().item()
    scale = whole.abs().max().item()
    aux = (float(m1.aux_loss), float(m2.aux_loss))
    dropped = (float(m1.dropped_fraction), float(m2.dropped_fraction))
    routing = dict(capacity=cap, slots_equal=slots_equal, max_abs_err=err,
                   bound=1e-5 * scale, aux=aux, dropped=dropped,
                   wall_s=time.perf_counter() - t_routing)
    out["moe_routing"] = routing
    print(f"[26a] MoE cp routing arm, {e} experts top {k} factor {cf}, "
          f"[{b}, {s}, {d}] f32 over {cp} emulated chunks on {card}: "
          f"capacity {cap}, every dispatch slot and combine weight equal "
          f"to the whole sequence's: {slots_equal}; output max |chunks - "
          f"whole| {err:.3e} (bound {1e-5 * scale:.3e}, 1e-5 of the "
          f"largest entry); aux {aux[1]:.8f} vs {aux[0]:.8f}, dropped "
          f"fraction {dropped[1]:.6f} vs {dropped[0]:.6f} (limit 1e-6); "
          f"{routing['wall_s']:.1f} s", flush=True)
    if not slots_equal or not err <= 1e-5 * scale or \
            abs(aux[0] - aux[1]) > 1e-6 or abs(dropped[0] - dropped[1]) > \
            1e-6 or not dropped[0] > 0:
        fail(f"phase 26a: the cp routing arm against the whole sequence: "
             f"{routing}")
    del x, w_in, w_out, whole, emu, logits
    torch.cuda.empty_cache()
    # one training step of the MoE LM, unsplit and over cp ranks
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g,
                           device=dev)
    L, hops = cfg.n_layers, cp * (cp + 1) // 2

    def want(mesh):
        h = hops if mesh else 1
        return dict(k1=2 * L * h, k2=L * h, k3a=0, k3b=0, k5=4 * L + 1)
    ref, r, steps = _combo_split(
        "a MoE step", lambda c, m: _lm_vag(c, {"tokens": tokens}, m),
        params, cfg, {"cp": cp}, want, card)
    print(f"[26a] small MoE ({e} experts) bf16 {b}x{s} step, {{'cp': {cp}}} "
          f"emulated (ring) on {card}: loss {r['loss']:.6f} vs unsplit "
          f"{ref['loss']:.6f}, grad norm {r['grad_norm']:.6f} vs "
          f"{ref['grad_norm']:.6f}; "
          + _combo_limits(r, ref, steps["split_f32"])
          + f"; a step: K1 {r['launches']['k1']} and K2 "
          f"{r['launches']['k2']} (unsplit "
          f"{ref['launches']['k1']}, {ref['launches']['k2']}), wall "
          f"{r['step_ms']:.2f} ms (unsplit {ref['step_ms']:.2f}), device "
          f"{_ms(r['device_ms'])} (unsplit {_ms(ref['device_ms'])}); the "
          f"f32 steps' walls {steps['split_f32']['step_ms']:.1f} and "
          f"{steps['unsplit_f32']['step_ms']:.1f} ms", flush=True)
    out["moe_step"] = steps
    torch.cuda.empty_cache()
    return _combo_sum(steps.values())


def _combo_sum(recs):
    total = dict.fromkeys(("k1", "k2", "k3a", "k3b", "k5", "k6"), 0)
    for r in recs:
        for key in total:
            total[key] += r["launches"][key]
    return total


def _combo_pp(out, card):
    """26b: `small` bf16 under {pp: 2, cp: 2} (cp replicated inside the
    pipeline), GPipe and 1F1B, against {pp: 2} bit for bit and the
    unpipelined step within phase 21's limits, on the two-pass backward
    (K3a, K3b: K2's dQ atomics change a gradient's bits from run to
    run). On a dict mesh the pipeline never reads cp, so the bitwise
    check holds by construction: it shows the emulation takes the mesh;
    the distributed code of pp x cp (the layout dropping cp under pp)
    runs in the CPU's gloo groups only. Returns the launches."""
    import numpy as np
    import torch
    from tony_tpu_torch import train_lm
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.ops import attention as A
    batch_n, seq = COMBO_PP
    cfg, params = train_lm.build("small", COMBO_DEVICE)
    L = cfg.n_layers
    tokens = torch.from_numpy(np.random.RandomState(26).randint(
        0, cfg.vocab_size, size=(batch_n, seq + 1))).to(COMBO_DEVICE)
    batch = {"tokens": tokens}
    pp, m = T._pp_layout(cfg, {"pp": 2}, batch_n)
    recs = {}
    budget = A._FUSED_PARTIALS_BYTES
    A._FUSED_PARTIALS_BYTES = 0
    try:
        _, _, _, ref = _combo_step(
            "b unpipelined", card, _lm_vag(cfg, batch, None), params,
            dict(k1=2 * L, k2=0, k3a=L, k3b=L, k5=4 * L + 1))
        recs["unpipelined"] = ref
        for schedule in ("gpipe", "1f1b"):
            want = _pp_expected(L, pp, m, schedule)
            want = dict(k1=want["k1"], k2=0, k3a=want["k2"],
                        k3b=want["k2"], k5=want["k5"])
            got = {}
            for tag, mesh in (("pp2", {"pp": 2}),
                              ("pp2_cp2", {"pp": 2, "cp": 2})):
                got[tag] = _combo_step(f"b {schedule} {tag}", card,
                                       _lm_vag(cfg, batch, mesh, schedule),
                                       params, want,
                                       timed=tag == "pp2_cp2")
            (l0, _, g0, r0), (l1, _, g1, r1) = got["pp2"], got["pp2_cp2"]
            same = l0 == l1 and all(torch.equal(a, c)
                                    for a, c in zip(g0, g1))
            _combo_rel(f"b {schedule}", r1, ref, 1e-3, 1e-2)
            r1["bitwise_pp2"] = same
            recs[f"{schedule}_pp2"], recs[f"{schedule}_pp2_cp2"] = r0, r1
            print(f"[26b] small bf16 {batch_n}x{seq} {schedule} on "
                  f"{{'pp': 2, 'cp': 2}} emulated (M={m}) on {card}: loss "
                  f"and every gradient equal to {{'pp': 2}}'s bit for bit "
                  f"(the same arithmetic by construction: a dict mesh's "
                  f"pipeline never reads cp): {same}; loss {r1['loss']:.6f} vs unpipelined "
                  f"{ref['loss']:.6f} (relative {r1['loss_rel']:.2e}, "
                  f"limit 1e-3), grad norm {r1['grad_norm']:.6f} vs "
                  f"{ref['grad_norm']:.6f} ({r1['norm_rel']:.2e}, limit "
                  f"1e-2); a step: K1 {r1['launches']['k1']} (unpipelined "
                  f"{ref['launches']['k1']}), wall {r1['step_ms']:.2f} ms, "
                  f"device {_ms(r1['device_ms'])} (unpipelined "
                  f"{ref['step_ms']:.2f} ms, {_ms(ref['device_ms'])})",
                  flush=True)
            if not same:
                fail(f"phase 26b {schedule}: {{'pp': 2, 'cp': 2}} differs "
                     f"from {{'pp': 2}}")
            del got, g0, g1
    finally:
        A._FUSED_PARTIALS_BYTES = budget
    out["pp"] = recs
    del params
    torch.cuda.empty_cache()
    return _combo_sum(recs.values())


def _combo_bert(out, card):
    """26c: BERT-base bf16 under an emulated {cp: 2} (the non-causal
    ring) and {pp: 2} against the unsharded step. BERT on a dict mesh
    without cp runs the unsharded forward itself, so its {pp: 2} step is
    the unsharded step's arithmetic by construction; the distributed
    code of BERT under pp (its blocks gathered over pp) runs in the
    CPU's gloo groups only. Returns the launches."""
    import torch
    from tony_tpu_torch import pretrain_bert
    from tony_tpu_torch.models import bert as B
    from tony_tpu_torch.models import train as TR
    batch_n, seq = COMBO_BERT
    cfg, params = pretrain_bert.build("base", COMBO_DEVICE)
    L = cfg.n_layers
    batch = {k: torch.from_numpy(v).to(COMBO_DEVICE) for k, v in next(
        pretrain_bert.synthetic_mlm_batches(26, batch_n, seq, cfg)).items()}

    def run(c, mesh):
        return lambda p: TR.value_and_grad(
            lambda q, bt: B.mlm_loss(q, bt, c, mesh), p, batch)

    def want(mesh):
        h = 4 if mesh and mesh.get("cp") else 1
        return dict(k1=L * h, k2=L * h, k3a=0, k3b=0, k5=0, k6=2 * L + 2)
    ref, cp_rec, recs = _combo_split("c BERT cp2", run, params, cfg,
                                     {"cp": 2}, want, card)
    recs["pp2"] = _combo_step("c BERT pp2", card, run(cfg, {"pp": 2}),
                              params, want({"pp": 2}))[3]
    pp_rec = recs["pp2"]
    _combo_rel("c BERT pp2", pp_rec, ref, *_BF16_SPLIT_LIMITS)
    for tag, r in (("cp", cp_rec), ("pp", pp_rec)):
        checks = (_combo_limits(r, ref, recs["split_f32"]) if tag == "cp"
                  else f"relative to unsharded: loss {r['loss_rel']:.2e}, "
                  f"grad norm {r['norm_rel']:.2e} (the limits of cp; the "
                  f"unsharded forward by construction on a dict mesh)")
        print(f"[26c] BERT-base bf16 {batch_n}x{seq} on {{'{tag}': 2}} "
              f"emulated on {card}: loss {r['loss']:.6f} vs unsharded "
              f"{ref['loss']:.6f}, grad norm {r['grad_norm']:.6f} vs "
              f"{ref['grad_norm']:.6f}; {checks}; a step: K1 "
              f"{r['launches']['k1']}, K2 {r['launches']['k2']}, K6 "
              f"{r['launches']['k6']} (unsharded {ref['launches']['k1']}, "
              f"{ref['launches']['k2']}, {ref['launches']['k6']}), wall "
              f"{r['step_ms']:.2f} ms, device {_ms(r['device_ms'])} "
              f"(unsharded {ref['step_ms']:.2f} ms, "
              f"{_ms(ref['device_ms'])})", flush=True)
    out["bert"] = recs
    del params
    torch.cuda.empty_cache()
    return _combo_sum(recs.values())


def _combo_decode(out, card, cfg, params):
    """26d: greedy decoding of the `small` 8-expert MoE ``params`` in f32
    over emulated {tp: 2} and {ep: 2, tp: 2}: tokens equal to the
    unsharded run's, launches by phase 24's formulas, the profiled
    steps' launches, device and wall ms beside the unsharded run's.
    Returns the launches."""
    import numpy as np
    import torch
    from tony_tpu_torch import tree_map
    n, new, lo, hi = COMBO_DECODE
    cfg = cfg.scaled(dtype=torch.float32)
    params = tree_map(lambda t: t.float(), params)
    rs = np.random.RandomState(26)
    prompts = [list(map(int, rs.randint(0, cfg.vocab_size,
                                        size=rs.randint(lo, hi + 1))))
               for _ in range(n)]
    zero, read = _tp_counts()
    launches = dict.fromkeys(("k1", "k2", "k3a", "k3b", "k5", "k6"), 0)
    runs = {}
    base = None
    for tag, mesh in (("unsharded", None), ("tp2", {"tp": 2}),
                      ("ep2_tp2", {"ep": 2, "tp": 2})):
        tp = mesh["tp"] if mesh else 1
        zero()
        toks, _, st = _tp_stream(params, cfg, prompts, new, mesh,
                                 profiled=TP_PROFILED)
        c = read()
        _tp_check_launches(f"26d MoE {tag}", c, cfg, tp, 1, new)
        for key in launches:
            launches[key] += c[key]
        if base is None:
            base = toks
        equal = int((toks == base).all(dim=1).sum())
        runs[tag] = dict(equal=equal, launches=c, step=st)
        print(f"[26d] small MoE (8 experts) f32, {n} prompts of {lo}-{hi}, "
              f"{new} tokens, {tag}{' (emulated)' if mesh else ''} on "
              f"{card}: {equal}/{n} "
              f"streams equal to the unsharded run; a decode step "
              f"(last {TP_PROFILED} profiled): {st['launches']:.1f} "
              f"launches, {st['device_ms']:.3f} ms device, "
              f"{st['wall_ms']:.2f} ms wall; launches {c}", flush=True)
        if equal != n:
            fail(f"phase 26d: MoE {tag}: {equal}/{n} streams equal to the "
                 f"unsharded run")
    out["decode"] = runs
    del params
    torch.cuda.empty_cache()
    return launches


def phase_combos(report, card):
    """[26] The last mesh combinations, every rank emulated on one card:
    (a) the MoE cp routing arm and a MoE step under cp, (b) pp × cp under
    GPipe and 1F1B, (c) BERT under cp and pp, (d) MoE decoding under tp
    and ep × tp (module docstring). Returns the launches (K1, K2, K3a,
    K3b, K5, K6)."""
    import torch
    from tony_tpu_torch.models import transformer as T
    t_phase = time.perf_counter()
    out = {"walls": {}}
    launches = dict.fromkeys(("k1", "k2", "k3a", "k3b", "k5", "k6"), 0)
    # one `small` MoE for 26a and 26d (its draw takes seconds on the host)
    moe_cfg = T.PRESETS["small"].scaled(num_experts=COMBO_MOE[2])
    moe = T.init_params(torch.Generator().manual_seed(26), moe_cfg,
                        COMBO_DEVICE)
    for part, fn, args in (("a", _combo_moe, (moe_cfg, moe)),
                           ("d", _combo_decode, (moe_cfg, moe)),
                           ("b", _combo_pp, ()), ("c", _combo_bert, ())):
        t = time.perf_counter()
        _tp_add(launches, fn(out, card, *args))
        out["walls"][part] = round(time.perf_counter() - t, 1)
        if part == "d":
            del moe
            torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    out["launches"] = launches
    print(f"[26] phase wall {out['wall_s']:.1f}s ({out['walls']}); "
          f"launches {launches}", flush=True)
    report["combos"] = out
    return launches


def main(bisect: bool = False) -> int:
    """The whole script; with ``bisect`` (``--trace-loss-bisect``) marker
    captures follow every phase, to find the one after which a capture
    misses its first kernels."""
    if not os.path.isdir(os.path.join(HERE, "tony_tpu_torch")):
        fail("run chip_smoke.py from the repository root (tony_tpu_torch/ "
             "not found beside it)")
    sys.path.insert(0, HERE)
    import torch
    card = phase_card()
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    walls = report["phase_walls"] = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t, 1)
        if bisect:
            import tempfile
            with tempfile.TemporaryDirectory() as tmp:
                _loss_markers(tmp, "loss bisect", f"phase {name}")
        return out

    timed("2 build", phase_build, report)
    k1 = timed("3 kernel", phase_kernel, report)
    bwd = timed("6 backward", phase_backward, report)
    k4 = timed("7 adamw", phase_adamw, report)
    norms = timed("10 norms", phase_norms, report)
    timed("4 parity", phase_parity, report)
    timed("8 train parity", phase_train_parity, report)
    timed("11 bert parity", phase_bert_parity, report)
    serve = timed("5 serve", phase_serve, report, card)
    counts = timed("9 train", phase_train, report, card)
    bert = timed("12 bert", phase_bert, report, card)
    mesh = timed("13 mesh", phase_mesh, report, card)
    host_k1, host_k5 = timed("14 serving host", phase_serving_host, report,
                             card, serve)
    var_k1, var_k5 = timed("15 variants", phase_variants, report, card,
                           serve)
    pre_k1, pre_k5 = timed("16 prefix", phase_prefix, report, card, serve)
    dis_k1, dis_k5 = timed("17 disagg", phase_disagg, report, card, serve)
    files = timed("18 files", phase_files, report, card)
    moe = timed("19 moe", phase_moe, report, card, serve)
    cp = timed("20 cp", phase_cp, report, card)
    pp = timed("21 pipeline", phase_pipeline, report, card)
    obs = timed("22 observability", phase_observability, report, card)
    fleet_k1, fleet_k5 = timed("23 fleet", phase_fleet, report, card, serve)
    tp = timed("24 tp", phase_tp, report, card, serve)
    timed("25 resnet", phase_resnet, report, card)
    combos = timed("26 combos", phase_combos, report, card)
    print("[phase walls] " + ", ".join(f"{k} {v}s" for k, v in walls.items()),
          flush=True)
    # launches on the main paths, each counted from 0 over its own run:
    # K1 over the serve (phase 5), the LM training run (phase 9), the
    # BERT run (phase 12), the mesh-path run (phase 13), the sampled
    # serve over the wire (phase 14), the five decode variants' serves
    # (phase 15), the prefix-resident serves (phase 16: the template
    # prefills) and the disaggregated serve (phase 17b: both tiers); K2
    # over the three training runs; K3a/K3b over the run with the budget
    # at 0; K4 over the run with the fused optimizer; K5 over the serves
    # of phases 5, 14, 15, 16 and 17 and the two LM training runs; K6
    # over the BERT run; phase 18's file-fed run (K1, K2, K5), its
    # elastic run on the two-pass backward (K1, K3a, K3b, K5) and
    # train_lm's runs (K1, K2, K5); and phase 19's MoE runs: training
    # (K1, K2, K5), its fused-optimizer steps (K4 too), train_lm
    # --num_experts (K1, K2, K5) and the MoE serve (K1, K5); phase 20's
    # ring and Ulysses over simulated ranks (K1, K2), the training steps
    # under the three remat policies and train_lm --cp_strategy (K1, K2,
    # K5); phase 21's pipelined steps over simulated pp ranks, the
    # cross-slice stage gangs and train_lm --pp_schedule (K1, K2, K5);
    # phase 22's run_training steps (traced, under the ledger, under a
    # live capture: K1, K2, K5) and its ServeEngine (K1, K5); phase 23's
    # in-process replicas (K1, K5: the autoscale, the v1 tier of the
    # rolling upgrade, the f32 drill); phase 24's decode streams over
    # emulated tp ranks and their unsharded twins (K1, K5) and the hybrid
    # and flat meshes' training runs (K1, K3a, K3b, K5) and train_lm's
    # (K1, K2, K5); phase 26's steps over emulated ranks: MoE × cp (K1,
    # K2, K5), pp × cp on the two-pass backward (K1, K3a, K3b, K5), BERT
    # under cp and pp (K1, K2, K6), and its MoE decode streams (K1, K5)
    k1["launches"] = (serve["k1"] + counts["k1"] + bert["k1"] + mesh["k1"]
                      + host_k1 + var_k1 + pre_k1 + dis_k1 + files["k1"]
                      + moe["k1"] + cp["k1"] + pp["k1"] + obs["k1"]
                      + fleet_k1 + tp["k1"] + combos["k1"])
    bwd["fused"]["launches"] = (counts["k2"] + bert["k2"] + mesh["k2"]
                                + files["k2"] + moe["k2"] + cp["k2"]
                                + pp["k2"] + obs["k2"] + tp["k2"]
                                + combos["k2"])
    bwd["dq"]["launches"] = (counts["k3a"] + files["k3a"] + tp["k3a"]
                             + combos["k3a"])
    bwd["dkv"]["launches"] = (counts["k3b"] + files["k3b"] + tp["k3b"]
                              + combos["k3b"])
    k4["launches"] = counts["k4"] + moe["k4"]
    norms["rms"]["launches"] = (serve["k5"] + counts["k5"] + mesh["k5"]
                                + host_k5 + var_k5 + pre_k5 + dis_k5
                                + files["k5"] + moe["k5"] + cp["k5"]
                                + pp["k5"] + obs["k5"] + fleet_k5 + tp["k5"]
                                + combos["k5"])
    norms["ln"]["launches"] = bert["k6"] + combos["k6"]
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


def checkpoint_main(tree: str) -> int:
    """Phase 18e alone against the ``tony_tpu_torch`` of ``tree``
    (module docstring): its lines, then one JSON line of its numbers."""
    import tempfile
    sys.path.insert(0, os.path.abspath(tree))
    card = phase_card()
    from tony_tpu_torch import train_lm
    from tony_tpu_torch.ops import _kernels
    _kernels.build()
    cfg, params = train_lm.build("small", "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        out = _checkpoint_phase(card, cfg, params, tmp, check=False)
    print(json.dumps({"tree": tree, "card": card, "checkpoint": out},
                     default=str))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--observability"]:
        sys.exit(observability_main(
            float(sys.argv[2]) if len(sys.argv) > 2 else None,
            sys.argv[3] if len(sys.argv) > 3
            else "given on the command line"))
    if sys.argv[1:2] == ["--trace-loss-bisect"]:
        sys.exit(main(bisect=True))
    if sys.argv[1:2] == ["--checkpoint"]:
        sys.exit(checkpoint_main(sys.argv[2] if len(sys.argv) > 2 else HERE))
    sys.exit(main())
