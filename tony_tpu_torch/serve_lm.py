"""Serve the flagship LM with continuous batching — the port's
``examples/lm/serve_lm.py``.

A closed batch (the default): random prompts of ``--prompt_len`` tokens
and random budgets between ``max_new_tokens / 4`` and ``max_new_tokens``
through ``--slots`` cache slots of ``prompt_len + max_new_tokens``
positions, greedy or sampled (``--temperature/--top_k/--top_p`` from
per-request streams of ``--seed``)::

    python -m tony_tpu_torch.serve_lm --preset small --requests 24 \\
        --slots 8 --prompt_len 256 --max_new_tokens 64

A serving replica: the same batcher behind the TONYS1 streaming server,
a live admission queue with QoS classes, until interrupted (SIGINT or
SIGTERM drains and exits)::

    python -m tony_tpu_torch.serve_lm --preset small --slots 8 \\
        --temperature 0.8 --top_k 50 --top_p 0.95 --listen 0.0.0.0:7070

A streaming client (no model): the synthetic workload over one
persistent connection, with client-side TTFT and inter-token latency,
per class with ``--mixed_classes``::

    python -m tony_tpu_torch.serve_lm --preset small --requests 24 \\
        --connect host:7070 --mixed_classes --busy_retries 4

The decode variants, alone or together, in every mode::

    # speculative: a draft preset (scaled to the target's vocab and
    # dtype, weights from seed 1) proposes 4 tokens per round
    python -m tony_tpu_torch.serve_lm --preset small \
        --draft_preset tiny --num_speculative 4
    # int8 weights (both models) and an int8 KV cache
    python -m tony_tpu_torch.serve_lm --preset small --quantize_weights \
        --kv_cache_dtype int8
    # sliding-window attention over a rolling cache of 384 rows a slot
    python -m tony_tpu_torch.serve_lm --preset small --attn_window 256 \
        --kv_cache_capacity 384

Shared prefixes: with ``--shared_prefix_file F`` (token ids, separated
by whitespace or commas) every prompt continues that prefix. In process
the prefix is resident and each admission runs only its suffix; a
``--listen`` replica makes it resident (one local prefill) and with
``--publish_prefix HOST:PORT`` ships the template to that peer's prefix
lane, which then serves the prefix with zero prefix forwards; a
``--connect`` client sends prompts that continue it (the replica
matches them)::

    python -m tony_tpu_torch.serve_lm --preset small --listen :7071
    python -m tony_tpu_torch.serve_lm --preset small --listen :7070 \
        --shared_prefix_file sys.txt --publish_prefix 127.0.0.1:7071
    python -m tony_tpu_torch.serve_lm --preset small --connect :7071 \
        --shared_prefix_file sys.txt

Warm boot: ``--warm_from HOST:PORT`` pulls the params from a running
replica's weights lane (digest-checked) instead of building them; if the
pull fails it says so and falls back to the storage load.

A router (no model, no device): one front door over several replicas,
placing each session by queue depth, failing streams over to a survivor
with nothing duplicated or dropped; with ``--route_decode`` it places
DISAGGREGATED — ``--route`` names the prefill tier, ``--route_decode``
the decode tier. The tiers are ``--role prefill`` (prompts in, KV
shipments out) and ``--role decode`` (KV shipments in, tokens out)::

    python -m tony_tpu_torch.serve_lm --preset small --slots 8 \
        --role prefill --listen :7071
    python -m tony_tpu_torch.serve_lm --preset small --slots 8 \
        --role decode --listen :7072
    python -m tony_tpu_torch.serve_lm --listen :7070 --route :7071 \
        --route_decode :7072
    python -m tony_tpu_torch.serve_lm --preset small --connect :7070

``--disaggregate`` runs both tiers and a router in this process and
streams the synthetic workload through them. ``--connect ROUTER --drain
REPLICA`` fences a replica and live-migrates its sessions to the others
(planned maintenance), prints the router's summary and exits.

The client speaks to the JAX package's replicas and routers too, and
theirs to this replica; the prefix and weights lanes, the KV shipments
and the router cross between the packages the same way. ``--ckpt_dir``
serves the params of the port's own ``train_lm`` checkpoint. The model
runs on the card in bf16 unless ``--device cpu`` is passed (then f32);
with no card and no ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time

import numpy as np
import torch

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.quantize import quantize_weights_int8
from tony_tpu_torch.models.serve import (QOS_CLASSES, ContinuousBatcher,
                                         SpeculativeContinuousBatcher)

def make_workload(seed: int, requests: int, prompt_len: int,
                  max_new_tokens: int, vocab: int,
                  min_prompt_len: int | None = None):
    """(prompts, budgets): prompts of ``prompt_len`` tokens (uniform in
    [min_prompt_len, prompt_len] when given), budgets uniform in
    [max(1, max_new_tokens // 4), max_new_tokens], from ``seed`` — the
    JAX script's draws when ``min_prompt_len`` is None."""
    rs = np.random.RandomState(seed)
    lens = ([prompt_len] * requests if min_prompt_len is None
            else rs.randint(min_prompt_len, prompt_len + 1, size=requests))
    prompts = [list(rs.randint(0, vocab, size=int(n))) for n in lens]
    budgets = [int(b) for b in
               rs.randint(max(1, max_new_tokens // 4), max_new_tokens + 1,
                          size=requests)]
    return prompts, budgets


def load_prefix_tokens(path: str) -> list[int]:
    """Token ids from a whitespace- or comma-separated file: the shared
    prefix (system prompt) the prefix paths install, publish and
    continue."""
    with open(path) as f:
        toks = [int(t) for t in f.read().replace(",", " ").split()]
    if not toks:
        raise SystemExit(f"{path}: no tokens")
    return toks


def warm_boot(seeder: str, device=None):
    """Params pulled from the running replica ``seeder``'s weights lane
    (digest-checked), on ``device``; None when the pull fails — printed,
    and the caller falls back to the storage load."""
    from tony_tpu_torch.models.weights import params_from_numpy
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    from tony_tpu_torch.serving.weightstore import pull_weights
    reg = MetricsRegistry()
    t0 = time.perf_counter()
    try:
        meta, tree = pull_weights(seeder, registry=reg)
    except Exception as e:              # noqa: BLE001 — degrade
        print(f"warm boot from {seeder} failed ({e}); falling back to a "
              f"storage load", flush=True)
        return None
    params = params_from_numpy(tree, resolve_device(device))
    moved = int(reg.counter("tony_channel_bytes_total", channel="weights",
                            direction="recv").value)
    print(f"warm boot: pulled weights {meta['digest'][:12]}… from "
          f"{seeder} ({moved} bytes in {time.perf_counter() - t0:.3f}s)",
          flush=True)
    return params


def build(preset: str, device=None, ckpt_dir: str = "",
          quantize: bool = False, params=None, **cfg_kw):
    """(cfg, params) for ``preset`` at full width on ``device``: bf16 on
    the card, f32 on the CPU, random weights from seed 0 — or, with
    ``ckpt_dir``, the params of the latest train-state checkpoint the
    port's ``train_lm`` saved there, cast to the serving dtype; or the
    ``params`` given (a warm boot's). ``cfg_kw`` sets the serving fields
    of the config (``kv_cache_dtype``, ``attn_window``,
    ``kv_cache_capacity``); ``quantize`` returns the int8 weight
    snapshot."""
    dev = resolve_device(device)
    cfg = T.PRESETS[preset].scaled(
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
        remat=False, **cfg_kw)
    if params is not None:
        return cfg, (quantize_weights_int8(params) if quantize else params)
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device=dev)
    if ckpt_dir:
        from tony_tpu_torch.models.checkpoint import CheckpointManager
        from tony_tpu_torch.models.train import (default_optimizer,
                                                 init_state)
        mgr = CheckpointManager(ckpt_dir)
        state = mgr.restore(template=init_state(params, default_optimizer()))
        params = state["params"]
        print(f"restored step {int(state['step'])} from {ckpt_dir}",
              flush=True)
    if quantize:
        params = quantize_weights_int8(params)
    return cfg, params


def build_draft(draft_preset: str, cfg, device=None,
                quantize: bool = False):
    """(draft_cfg, draft_params): ``draft_preset`` scaled to the target
    ``cfg``'s vocab, dtype, KV cache dtype and window (speculation
    compares token ids), random weights from seed 1, quantized with the
    target under ``quantize``."""
    dcfg = T.PRESETS[draft_preset].scaled(
        dtype=cfg.dtype, remat=False, vocab_size=cfg.vocab_size,
        kv_cache_dtype=cfg.kv_cache_dtype, attn_window=cfg.attn_window)
    dparams = T.init_params(torch.Generator().manual_seed(1), dcfg,
                            device=resolve_device(device))
    if quantize:
        dparams = quantize_weights_int8(dparams)
    return dcfg, dparams


def mode_of(batcher) -> str:
    """The mode line's word: greedy or sampled, speculative or not."""
    return (("speculative " if isinstance(batcher,
                                          SpeculativeContinuousBatcher)
             else "") + ("sampled" if batcher.sampled else "greedy"))


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
          f"{batcher.batch} slots in {dt:.2f}s incl. compile — "
          f"{mode_of(batcher)}")
    if isinstance(batcher, SpeculativeContinuousBatcher):
        per = useful / max(1, batcher.rounds_executed * batcher.batch)
        print(f"speculative rounds: {batcher.rounds_executed} "
              f"({per:.2f} tokens/slot-round)")
    else:
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


def _parse_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def _install_and_publish(args, server, toks,
                         resident_deadline_s: float = 30.0) -> None:
    """--shared_prefix_file on a replica: make the prefix resident (ONE
    local prefill); --publish_prefix also warms a peer replica with one
    template ship over its prefix lane (the peer runs ZERO prefix
    forwards). The channel acks the ship when the frame arrives and the
    peer's install thread makes the template resident later, so the
    publish is reported once the peer's STATS list the prefix; past
    ``resident_deadline_s`` it raises."""
    from tony_tpu_torch.serving.client import StreamingClient

    pid = server.install_prefix(toks)
    if pid is None:
        print("prefix NOT resident (rolling-cache layout); serving "
              "prefix-blind", flush=True)
        return
    print(f"prefix {pid} resident ({len(toks)} tokens)", flush=True)
    if args.publish_prefix:
        host, port = _parse_addr(args.publish_prefix)
        with StreamingClient(host, port) as peer:
            lane = peer.hello.get("prefix_port")
            if lane is None:
                raise SystemExit(f"{args.publish_prefix} advertises no "
                                 f"prefix lane")
            t0 = time.perf_counter()
            n = server.publish_prefix(pid, f"{host}:{lane}")
            deadline = t0 + resident_deadline_s
            while pid not in peer.stats().get("prefixes", []):
                if time.perf_counter() > deadline:
                    raise TimeoutError(
                        f"prefix {pid} shipped to {host}:{lane} but not "
                        f"resident there after {resident_deadline_s}s")
                time.sleep(0.02)
        print(f"published prefix {pid} to {host}:{lane} ({n} bytes in "
              f"{time.perf_counter() - t0:.3f}s — the peer warmed without "
              f"recomputing)", flush=True)


def _wait_for_signal() -> None:
    """Block until SIGINT or SIGTERM."""
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    while not stop.wait(3600):
        pass


def _run_server(args, batcher, shared) -> int:
    """--listen: drive the batcher's engine behind a streaming server
    until SIGINT or SIGTERM, then drain gracefully."""
    from tony_tpu_torch.serving.server import ServingServer

    host, port = _parse_addr(args.listen)
    server = ServingServer(batcher, bind_host=host, port=port,
                           weights_version=args.weights_version or None)
    bound = server.start()
    if shared:
        _install_and_publish(args, server, shared)
    print(f"serving {args.preset} ({mode_of(batcher)}) on {host}:{bound} "
          f"with {args.slots} slots — ^C drains and exits", flush=True)
    _wait_for_signal()
    print("draining in-flight requests ...", flush=True)
    server.stop(drain=True)
    return 0


def _addrs(spec: str) -> list[str]:
    return [a.strip() for a in spec.split(",") if a.strip()]


def _run_router(args) -> int:
    """--listen + --route: the model-free front door. With --route_decode
    the router places DISAGGREGATED: --route names the prefill tier,
    --route_decode the decode tier."""
    from tony_tpu_torch.serving.router import ServingRouter

    host, port = _parse_addr(args.listen)
    replicas, decodes = _addrs(args.route), _addrs(args.route_decode)
    router = ServingRouter(replicas, bind_host=host, port=port,
                           decode_replicas=decodes or None)
    if args.shared_prefix_file:
        pid = router.register_prefix(
            load_prefix_tokens(args.shared_prefix_file))
        print(f"prefix {pid} registered for tokenized matching",
              flush=True)
    bound = router.start()
    shape = (f"{len(replicas)} prefill + {len(decodes)} decode replicas"
             if decodes else f"{len(replicas)} replicas")
    print(f"routing on {host}:{bound} over {shape} — ^C exits",
          flush=True)
    _wait_for_signal()
    router.stop()
    return 0


def _prefill_tier(args, params, cfg, max_len, **kw):
    from tony_tpu_torch.serving.disagg import PrefillServer
    return PrefillServer(params, cfg, max_len=max_len, seed=args.seed,
                         max_batch=args.slots, **kw)


def _run_prefill(args, params, cfg, shared) -> int:
    """--role prefill --listen: the stateless prefill tier — no cache
    slots, no decode loop; prompts in, KV shipments out."""
    host, port = _parse_addr(args.listen)
    server = _prefill_tier(
        args, params, cfg, len(shared) + args.prompt_len
        + args.max_new_tokens, bind_host=host, port=port,
        weights_version=args.weights_version or None)
    bound = server.start()
    if shared:
        _install_and_publish(args, server, shared)
    print(f"prefill tier ({args.preset}) on {host}:{bound} ({args.slots}"
          f"-row waves) — ^C exits", flush=True)
    _wait_for_signal()
    server.stop()
    return 0


def _run_decode(args, batcher) -> int:
    """--role decode --listen: the decode tier — admissions arrive as KV
    shipments on the channel hub, never as prompts."""
    from tony_tpu_torch.serving.disagg import DecodeServer

    host, port = _parse_addr(args.listen)
    server = DecodeServer(batcher, bind_host=host, port=port,
                          weights_version=args.weights_version or None)
    bound = server.start()
    print(f"decode tier ({args.preset}, {mode_of(batcher)}) on "
          f"{host}:{bound} with {args.slots} slots; kv channel on "
          f":{server.hub.port} — ^C drains and exits", flush=True)
    _wait_for_signal()
    print("draining in-flight requests ...", flush=True)
    server.stop(drain=True)
    return 0


def _run_disaggregate(args, params, cfg, batcher, shared, prompts,
                      budgets) -> int:
    """--disaggregate: both tiers and the router in this process, the
    synthetic workload streamed through the split (--role is the real
    multi-host shape)."""
    from tony_tpu_torch.runtime import metrics as M
    from tony_tpu_torch.serving.client import StreamingClient
    from tony_tpu_torch.serving.disagg import DecodeServer
    from tony_tpu_torch.serving.router import ServingRouter

    pre = _prefill_tier(args, params, cfg, batcher.max_len)
    dec = DecodeServer(batcher)
    router = ServingRouter([f"127.0.0.1:{pre.start()}"],
                           decode_replicas=[f"127.0.0.1:{dec.start()}"])
    try:
        if shared:
            pid = pre.install_prefix(shared)
            if pid is not None:
                router.register_prefix(shared, prefix_id=pid)
                print(f"prefix {pid} resident at the prefill tier "
                      f"({len(shared)} tokens); suffix-only prefill "
                      f"waves", flush=True)
        rport = router.start()
        print(f"disaggregated: prefill :{pre.port} -> decode :{dec.port} "
              f"(kv channel :{dec.hub.port}), router :{rport}", flush=True)
        with StreamingClient("127.0.0.1", rport) as client:
            run = WorkloadStreams(client)
            for p, n in zip(prompts, budgets):
                run.submit([p], [n])
            dt = run.wait()
    finally:
        router.stop()
        pre.stop()
        dec.stop()
    useful = sum(len(o) for o in run.outputs if o)
    print(f"streamed {len(prompts)} requests ({useful} tokens) in "
          f"{dt:.2f}s — {useful / max(dt, 1e-9):.1f} tok/s")
    print(latency_line("all", run.latency_ms()))
    ship = M.get_default().histogram("tony_kv_ship_seconds")
    if ship.count:
        print(f"kv handoff: {ship.count} shipments, mean wall "
              f"{ship.sum / ship.count * 1e3:.1f} ms")
    print("first request tokens:", (run.outputs[0] or [])[:12])
    return 0 if all(o is not None for o in run.outputs) else 1


def percentile_ms(values, q: float) -> float:
    """The ``q``-th percentile of seconds ``values``, in milliseconds
    (numpy's linear interpolation); NaN when empty."""
    return float(np.percentile(values, q)) * 1e3 if values else float("nan")


class WorkloadStreams:
    """Requests streamed over one :class:`StreamingClient` connection,
    one reader thread per request, timed by frame arrival: TTFT from
    submit to the first TOKENS frame, and each later frame's gap over
    its token count (the inter-token latency). Index ``i`` is the
    ``i``-th submission; a request the server shed past its retry budget
    has output None and ``shed[i]`` True, one whose connection failed
    has output None."""

    def __init__(self, client) -> None:
        self.client = client
        self.outputs: list = []
        self.ttft: list = []
        self.gaps: list = []
        self.shed: list = []
        self.classes: list = []
        self._threads: list = []
        self.t0 = time.perf_counter()

    def submit(self, prompts, budgets, request_class=None,
               retries: int = 0) -> None:
        for p, n in zip(prompts, budgets):
            i = len(self.outputs)
            self.outputs.append(None)
            self.ttft.append(None)
            self.gaps.append([])
            self.shed.append(False)
            self.classes.append(request_class or "standard")
            t_submit = time.perf_counter()
            rid = self.client.submit(p, n, request_class=request_class,
                                     retries=retries)
            th = threading.Thread(target=self._drain,
                                  args=(i, rid, t_submit), daemon=True)
            th.start()
            self._threads.append(th)

    def _drain(self, i, rid, t_submit) -> None:
        from tony_tpu_torch.serving.client import (ServerBusy,
                                                   ServingConnectionError)
        toks, last = [], None
        try:
            for delta in self.client.deltas(rid):
                now = time.perf_counter()
                if last is None:
                    self.ttft[i] = now - t_submit
                else:
                    self.gaps[i].append((now - last) / len(delta))
                last = now
                toks.extend(delta)
        except ServerBusy:
            self.shed[i] = True
            return
        except ServingConnectionError:
            return
        self.outputs[i] = toks

    def wait(self) -> float:
        """Join every stream; returns the wall since construction."""
        for th in self._threads:
            th.join()
        return time.perf_counter() - self.t0

    def latency_ms(self, request_class=None) -> dict:
        """TTFT and inter-token p50/p99 (ms) over completed requests,
        of one class or all."""
        idx = [i for i, c in enumerate(self.classes)
               if request_class in (None, c) and self.outputs[i] is not None]
        tt = [self.ttft[i] for i in idx]
        gp = [g for i in idx for g in self.gaps[i]]
        return {"n": len(idx),
                "shed": sum(1 for i, c in enumerate(self.classes)
                            if request_class in (None, c) and self.shed[i]),
                "ttft_p50": percentile_ms(tt, 50),
                "ttft_p99": percentile_ms(tt, 99),
                "itl_p50": percentile_ms(gp, 50),
                "itl_p99": percentile_ms(gp, 99)}


def latency_line(label: str, lat: dict) -> str:
    if not lat["n"]:
        return f"{label}: no completed requests ({lat['shed']} shed)"
    return (f"{label}: ttft p50 {lat['ttft_p50']:.1f} ms  p99 "
            f"{lat['ttft_p99']:.1f} ms;  inter-token p50 "
            f"{lat['itl_p50']:.1f} ms  p99 {lat['itl_p99']:.1f} ms"
            + (f"  ({lat['shed']} shed)" if lat["shed"] else ""))


def _run_client(args) -> int:
    """--connect: submit the synthetic workload over one persistent
    streaming connection; report client-side TTFT and inter-token
    latency, per class with classes. No model is built — prompt tokens
    draw from the preset's vocab, which must match the server's."""
    from tony_tpu_torch.serving.client import StreamingClient

    host, port = _parse_addr(args.connect)
    if args.drain:
        # operator mode: the ROUTER fences the replica and live-migrates
        # every session off it
        with StreamingClient(host, port) as client:
            res = client.drain_replica(args.drain)
        print(f"drain {args.drain}: {res}", flush=True)
        return 0 if res.get("ok") else 1
    prompts, budgets = make_workload(args.seed, args.requests,
                                     args.prompt_len, args.max_new_tokens,
                                     T.PRESETS[args.preset].vocab_size,
                                     args.min_prompt_len or None)
    if args.shared_prefix_file:
        # prefix-heavy traffic: every prompt continues the shared prefix
        # (no prefix id is sent; the replica matches the tokens)
        shared = load_prefix_tokens(args.shared_prefix_file)
        prompts = [shared + p for p in prompts]
    classes = None
    if args.mixed_classes:
        classes = [QOS_CLASSES[i % len(QOS_CLASSES)]
                   for i in range(args.requests)]
    elif args.request_class:
        classes = [args.request_class] * args.requests
    with StreamingClient(host, port) as client:
        print(f"connected to {host}:{port}: {client.hello}", flush=True)
        run = WorkloadStreams(client)
        for i in range(args.requests):
            run.submit(prompts[i:i + 1], budgets[i:i + 1],
                       classes[i] if classes else None, args.busy_retries)
        dt = run.wait()
    useful = sum(len(o) for o in run.outputs if o)
    print(f"streamed {args.requests} requests ({useful} tokens) in "
          f"{dt:.2f}s — {useful / max(dt, 1e-9):.1f} tok/s")
    print(latency_line("all", run.latency_ms()))
    if classes:
        for c in QOS_CLASSES:
            n = classes.count(c)
            if n:
                print(latency_line(f"  {c} ({n} reqs)", run.latency_ms(c)))
    first = next((o for o in run.outputs if o), [])
    print("first request tokens:", first[:12])
    if args.outputs:
        with open(args.outputs, "w") as f:
            json.dump(run.outputs, f)
    lost = [i for i, (o, s) in enumerate(zip(run.outputs, run.shed))
            if o is None and not s]
    return 1 if lost else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="tiny", choices=sorted(T.PRESETS))
    parser.add_argument("--ckpt_dir", default="",
                        help="a train_lm checkpoint directory (empty = "
                             "random params)")
    parser.add_argument("--requests", type=int, default=12)
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--prompt_len", type=int, default=16)
    parser.add_argument("--max_new_tokens", type=int, default=32)
    parser.add_argument("--draft_preset", default="",
                        choices=("",) + tuple(sorted(T.PRESETS)),
                        help="enable speculative serving with this preset "
                             "as the draft (random params, seed 1)")
    parser.add_argument("--num_speculative", type=int, default=4)
    parser.add_argument("--kv_cache_dtype", default="model",
                        choices=("model", "int8"),
                        help="int8 = quantized KV cache (about half the "
                             "cache memory per slot)")
    parser.add_argument("--quantize_weights", action="store_true",
                        help="serve with weight-only int8 matmul weights "
                             "(models/quantize.py)")
    parser.add_argument("--attn_window", type=int, default=0,
                        help="sliding-window attention (0 = full causal)")
    parser.add_argument("--kv_cache_capacity", type=int, default=0,
                        help="rolling KV cache rows per slot (0 = linear "
                             "cache of max_len rows); requires "
                             "--attn_window and lifts the request-length "
                             "ceiling")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top_k", type=int, default=0)
    parser.add_argument("--top_p", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_pipeline", action="store_true",
                        help="sequential serve loop (the A/B baseline)")
    parser.add_argument("--no_bucketed_admission", action="store_true",
                        help="admit one request per prefill forward")
    parser.add_argument("--listen", default="", metavar="HOST:PORT",
                        help="serve a LIVE admission queue over the "
                             "TONYS1 streaming protocol")
    parser.add_argument("--connect", default="", metavar="HOST:PORT",
                        help="run as a streaming CLIENT against a "
                             "--listen server or router (no local model; "
                             "prints TTFT/ITL)")
    parser.add_argument("--weights_version", default="",
                        help="with --listen: the weights generation this "
                             "replica advertises (HELLO/STATS)")
    parser.add_argument("--request_class", default="",
                        choices=("",) + QOS_CLASSES,
                        help="with --connect: submit every request at "
                             "this QoS tier (empty = classless wire)")
    parser.add_argument("--mixed_classes", action="store_true",
                        help="with --connect: rotate requests through "
                             "interactive/standard/batch and report "
                             "TTFT/ITL per class")
    parser.add_argument("--min_prompt_len", type=int, default=0,
                        help="with --connect: prompt lengths uniform in "
                             "[min_prompt_len, prompt_len] (0 = all "
                             "prompt_len)")
    parser.add_argument("--outputs", default="", metavar="FILE",
                        help="with --connect: write every request's "
                             "streamed tokens to FILE as JSON")
    parser.add_argument("--busy_retries", type=int, default=0,
                        help="with --connect: transparent re-admissions "
                             "per request when the server sheds it with "
                             "BUSY")
    parser.add_argument("--shared_prefix_file", default="",
                        metavar="FILE",
                        help="token ids every prompt continues (a system "
                             "prompt): resident in process and on a "
                             "--listen replica, prepended by a --connect "
                             "client")
    parser.add_argument("--publish_prefix", default="", metavar="HOST:PORT",
                        help="with --listen + --shared_prefix_file: ship "
                             "the prefix template to this peer replica's "
                             "prefix lane")
    parser.add_argument("--warm_from", default="", metavar="HOST:PORT",
                        help="pull the params from this running replica's "
                             "weights lane instead of building them "
                             "(falls back to the storage load)")
    parser.add_argument("--route", default="",
                        metavar="HOST:PORT,HOST:PORT",
                        help="with --listen: route sessions across these "
                             "replicas by queue depth (no local model)")
    parser.add_argument("--route_decode", default="",
                        metavar="HOST:PORT,HOST:PORT",
                        help="with --route: DISAGGREGATED placement — "
                             "--route names the prefill tier, this the "
                             "decode tier")
    parser.add_argument("--role", default="", choices=("", "prefill",
                                                       "decode"),
                        help="with --listen: run ONE tier of "
                             "disaggregated serving instead of a "
                             "colocated replica")
    parser.add_argument("--disaggregate", action="store_true",
                        help="run the prefill tier, the decode tier and "
                             "a router in this process and stream the "
                             "synthetic workload through them")
    parser.add_argument("--drain", default="", metavar="HOST:PORT",
                        help="with --connect to a ROUTER: fence this "
                             "replica, live-migrate its sessions off it, "
                             "print the summary and exit")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if (args.mixed_classes or args.request_class) and not args.connect:
        parser.error("--request_class/--mixed_classes require "
                     "--connect (they shape CLIENT traffic)")
    if args.mixed_classes and args.request_class:
        parser.error("--mixed_classes and --request_class are "
                     "mutually exclusive")
    if (args.busy_retries or args.min_prompt_len or args.outputs) \
            and not args.connect:
        parser.error("--busy_retries/--min_prompt_len/--outputs require "
                     "--connect")
    if args.weights_version and not args.listen:
        parser.error("--weights_version requires --listen")
    if args.drain and not args.connect:
        parser.error("--drain requires --connect (a router address)")
    if (args.route or args.route_decode) and not args.listen:
        parser.error("--route requires --listen")
    if args.route_decode and not args.route:
        parser.error("--route_decode requires --route")
    if args.role and not args.listen:
        parser.error("--role requires --listen")
    if args.role and (args.route or args.disaggregate):
        parser.error("--role runs one tier; --route and --disaggregate "
                     "run others")
    if (args.role or args.disaggregate) and args.draft_preset:
        parser.error("speculative serving is not supported "
                     "disaggregated (the KV shipment carries no "
                     "draft-model cache)")
    if args.disaggregate and args.listen:
        parser.error("--disaggregate serves the synthetic workload in "
                     "process; --role with --listen serves a tier")
    if args.publish_prefix and not (args.shared_prefix_file
                                    and args.listen):
        parser.error("--publish_prefix requires --listen and "
                     "--shared_prefix_file")
    if args.warm_from and args.connect:
        parser.error("--warm_from builds a replica's model; --connect "
                     "has none")
    if args.listen and args.connect:
        parser.error("--listen and --connect are mutually exclusive")

    if args.connect:
        return _run_client(args)
    if args.route:
        return _run_router(args)
    warm = warm_boot(args.warm_from, args.device) if args.warm_from \
        else None
    cfg, params = build(args.preset, args.device, args.ckpt_dir,
                        quantize=args.quantize_weights, params=warm,
                        kv_cache_dtype=args.kv_cache_dtype,
                        attn_window=args.attn_window,
                        kv_cache_capacity=args.kv_cache_capacity)
    if args.quantize_weights:
        print("serving with weight-only int8 matmul weights", flush=True)
    shared = (load_prefix_tokens(args.shared_prefix_file)
              if args.shared_prefix_file else [])
    if args.role == "prefill":
        return _run_prefill(args, params, cfg, shared)
    kw = dict(batch=args.slots,
              max_len=len(shared) + args.prompt_len + args.max_new_tokens,
              temperature=args.temperature, top_k=args.top_k,
              top_p=args.top_p, seed=args.seed,
              pipeline=not args.no_pipeline,
              bucketed_admission=not args.no_bucketed_admission)
    if args.draft_preset:
        dcfg, dparams = build_draft(args.draft_preset, cfg, args.device,
                                    args.quantize_weights)
        batcher = SpeculativeContinuousBatcher(
            params, cfg, dparams, dcfg,
            num_speculative=args.num_speculative, **kw)
    else:
        batcher = ContinuousBatcher(params, cfg, **kw)
    if args.role == "decode":
        return _run_decode(args, batcher)
    if args.listen:
        return _run_server(args, batcher, shared)
    prompts, budgets = make_workload(args.seed, args.requests,
                                     args.prompt_len, args.max_new_tokens,
                                     cfg.vocab_size)
    if args.disaggregate:
        return _run_disaggregate(args, params, cfg, batcher, shared,
                                 [shared + p for p in prompts], budgets)
    if shared:
        # the admission fast path in process: a resident template,
        # suffix-only admissions
        from tony_tpu_torch.serving.prefix import fingerprint
        prompts = [shared + p for p in prompts]
        if batcher.install_prefix(fingerprint(shared), shared):
            print(f"prefix resident locally ({len(shared)} tokens); "
                  f"prefix-hit admissions run suffix-only", flush=True)
    serve(batcher, prompts, budgets)
    return 0


if __name__ == "__main__":
    sys.exit(main())
