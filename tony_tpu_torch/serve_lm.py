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

The client speaks to the JAX package's replicas and routers too, and
theirs to this replica. ``--ckpt_dir`` serves the params of the port's
own ``train_lm`` checkpoint. The model runs on the card in bf16 unless
``--device cpu`` is passed (then f32); with no card and no ``--device
cpu`` it raises. Flags of the JAX script whose features are not ported
(speculative, disaggregated, router, prefix, weights lane, int8, rolling
caches) fail with "not ported yet".
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

import numpy as np
import torch

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.serve import QOS_CLASSES, ContinuousBatcher

#: flags of the JAX script whose features are not ported, with the value
#: that leaves them off
_NOT_PORTED = {"draft_preset": "", "route": "", "route_decode": "",
               "role": "", "disaggregate": False, "shared_prefix_file": "",
               "publish_prefix": "", "warm_from": "", "drain": "",
               "kv_cache_dtype": "model", "quantize_weights": False,
               "kv_cache_capacity": 0}


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


def build(preset: str, device=None, ckpt_dir: str = ""):
    """(cfg, params) for ``preset`` at full width on ``device``: bf16 on
    the card, f32 on the CPU, random weights from seed 0 — or, with
    ``ckpt_dir``, the params of the latest train-state checkpoint the
    port's ``train_lm`` saved there, cast to the serving dtype."""
    dev = resolve_device(device)
    cfg = T.PRESETS[preset].scaled(
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
        remat=False)
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
    mode = "sampled" if batcher.sampled else "greedy"
    print(f"served {len(prompts)} requests ({useful} tokens) through "
          f"{batcher.batch} slots in {dt:.2f}s incl. compile — {mode}")
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


def _run_server(args, batcher) -> int:
    """--listen: drive the batcher's engine behind a streaming server
    until SIGINT or SIGTERM, then drain gracefully."""
    from tony_tpu_torch.serving.server import ServingServer

    host, port = _parse_addr(args.listen)
    server = ServingServer(batcher, bind_host=host, port=port,
                           weights_version=args.weights_version or None)
    bound = server.start()
    mode = "sampled" if batcher.sampled else "greedy"
    print(f"serving {args.preset} ({mode}) on {host}:{bound} with "
          f"{args.slots} slots — ^C drains and exits", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    while not stop.wait(3600):
        pass
    print("draining in-flight requests ...", flush=True)
    server.stop(drain=True)
    return 0


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
    prompts, budgets = make_workload(args.seed, args.requests,
                                     args.prompt_len, args.max_new_tokens,
                                     T.PRESETS[args.preset].vocab_size)
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
    parser.add_argument("--busy_retries", type=int, default=0,
                        help="with --connect: transparent re-admissions "
                             "per request when the server sheds it with "
                             "BUSY")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    # the JAX script's flags whose features are not ported yet
    for name, off in _NOT_PORTED.items():
        if isinstance(off, bool):
            parser.add_argument(f"--{name}", action="store_true",
                                help=argparse.SUPPRESS)
        else:
            parser.add_argument(f"--{name}", type=type(off), default=off,
                                help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    for name, off in _NOT_PORTED.items():
        if getattr(args, name) != off:
            parser.error(f"--{name} is not ported yet")
    if (args.mixed_classes or args.request_class) and not args.connect:
        parser.error("--request_class/--mixed_classes require "
                     "--connect (they shape CLIENT traffic)")
    if args.mixed_classes and args.request_class:
        parser.error("--mixed_classes and --request_class are "
                     "mutually exclusive")
    if args.busy_retries and not args.connect:
        parser.error("--busy_retries requires --connect")
    if args.weights_version and not args.listen:
        parser.error("--weights_version requires --listen")
    if args.listen and args.connect:
        parser.error("--listen and --connect are mutually exclusive")

    if args.connect:
        return _run_client(args)
    cfg, params = build(args.preset, args.device, args.ckpt_dir)
    batcher = ContinuousBatcher(
        params, cfg, batch=args.slots,
        max_len=args.prompt_len + args.max_new_tokens,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.seed, pipeline=not args.no_pipeline,
        bucketed_admission=not args.no_bucketed_admission)
    if args.listen:
        return _run_server(args, batcher)
    prompts, budgets = make_workload(args.seed, args.requests,
                                     args.prompt_len, args.max_new_tokens,
                                     cfg.vocab_size)
    serve(batcher, prompts, budgets)
    return 0


if __name__ == "__main__":
    sys.exit(main())
