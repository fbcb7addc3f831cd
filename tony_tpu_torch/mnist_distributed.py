"""Distributed MNIST, the north-star recipe — the port's counterpart of
``examples/mnist/mnist_distributed.py``.

    python -m tony_tpu_torch.mnist_distributed [--steps 200] \\
        [--batch_size 256] [--lr 0.05] [--hidden 256] [--data_dir DIR] \\
        [--target_acc 0.95] [--device cpu]

One data-parallel program over every process of the job, as the JAX
script's: ``runtime.initialize`` boots the process group from the
executor's environment, ``runtime.mesh`` builds the mesh (its first axis
is the data axis; ``tony.application.mesh=dp=-1``), each process feeds
its ``--batch_size / processes`` rows of the global batch, and the
params replicate over the mesh (``init_state``), so
``make_train_step(…, mesh)`` sums their gradients over the data ranks.
The model is the script's 2-layer MLP (``w1``, ``b1``, ``w2``, ``b2``;
``--hidden`` units) under softmax cross-entropy, trained by
``optax.sgd(lr, momentum=0.9)``'s semantics
(:class:`~tony_tpu_torch.models.train.SGD`). Its init draws ``N(0,
0.05²)`` from a ``torch.Generator`` seeded with the session id, as the
JAX script draws from ``PRNGKey(session_id)``: the same distribution,
other bits.

Data: ``synthetic_mnist`` (class templates plus noise, the JAX script's
numpy bytes) or, with ``--data_dir``, the IDX files
(``train-images-idx3-ubyte.gz``, ``train-labels-idx1-ubyte.gz``). The
rows are drawn from ``RandomState(1234 + process id)``; the first draw is
the held-out global batch of the accuracy hook, run every 50 steps by
:func:`~tony_tpu_torch.models.loop.run_training`. f32 on the card and
on the CPU (``--device cpu``, gloo); with no card and no ``--device
cpu`` it raises. Process 0 prints the JAX script's lines: ``step {s}
loss {l} acc {a}`` every 50 steps and ``done: {steps} steps in {t}s ({r}
img/s), final loss {l}, acc {a}``; every process prints ``[job:index]
process p/n, N global devices, mesh {…}``. The exit code is 1 when the
final accuracy is below ``--target_acc``.
"""

from __future__ import annotations

import argparse
import gzip
import os
import struct
import sys
import time

import numpy as np
import torch

import tony_tpu_torch.runtime as rt
from tony_tpu_torch import resolve_device
from tony_tpu_torch.io.prefetch import DevicePrefetcher
from tony_tpu_torch.models.loop import run_training
from tony_tpu_torch.models.train import (SGD, batch_sharding, global_batch,
                                         init_state, make_train_step,
                                         replicated_axes)
from tony_tpu_torch.parallel import mesh_shape, spmd


def synthetic_mnist(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Class-conditioned synthetic digits: each class c gets a fixed random
    28x28 template; samples are noisy templates."""
    rng = np.random.RandomState(seed)
    templates = np.random.RandomState(0).rand(10, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, size=(n,)).astype(np.int32)
    images = templates[labels] + 0.3 * rng.randn(n, 28, 28).astype(np.float32)
    return images, labels


def load_idx_images(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        return (np.frombuffer(f.read(), dtype=np.uint8)
                .reshape(n, rows, cols).astype(np.float32) / 255.0)


def load_idx_labels(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        struct.unpack(">II", f.read(8))
        return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)


def init_params(gen: torch.Generator, hidden: int, device) -> dict:
    def normal(shape):
        x = torch.randn(shape, generator=gen, dtype=torch.float32)
        return (x * 0.05).to(device)

    return {"w1": normal((784, hidden)),
            "b1": torch.zeros((hidden,), device=device),
            "w2": normal((hidden, 10)),
            "b2": torch.zeros((10,), device=device)}


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def make_fns(mesh):
    """(loss_fn, accuracy) over ``mesh``'s global batches: each rank's
    rows and params, the sums over the data ranks."""
    lay = spmd.Layout(mesh)

    def loss_fn(params, batch):
        logits = forward(lay.local_params(params), lay.local(batch["x"]))
        y = lay.local(batch["y"]).long()
        logp = torch.log_softmax(logits, dim=-1)
        total = -logp.gather(-1, y[:, None])[:, 0].sum()
        return lay.sum_data(total) / (y.shape[0] * lay.data_size)

    @torch.no_grad()
    def accuracy(params, batch):
        logits = forward(lay.local_params(params), lay.local(batch["x"]))
        y = lay.local(batch["y"])
        hits = lay.count_data((logits.argmax(-1) == y).sum().float())
        return hits / (y.shape[0] * lay.data_size)

    return loss_fn, accuracy


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch_size", type=int, default=256,
                        help="GLOBAL batch size")
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--data_dir", default="",
                        help="dir with train-images-idx3-ubyte.gz etc.; "
                             "synthetic data when unset")
    parser.add_argument("--target_acc", type=float, default=0.95)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    info = rt.initialize(dev)
    mesh = rt.mesh(device=dev)
    print(f"[{info.job_name}:{info.task_index}] process {info.process_id}/"
          f"{info.num_processes}, {mesh.size()} global devices, "
          f"mesh {mesh_shape(mesh)}", flush=True)

    if args.data_dir:
        images = load_idx_images(os.path.join(
            args.data_dir, "train-images-idx3-ubyte.gz"))
        labels = load_idx_labels(os.path.join(
            args.data_dir, "train-labels-idx1-ubyte.gz"))
    else:
        images, labels = synthetic_mnist(60000, seed=info.process_id)

    params = init_params(torch.Generator().manual_seed(info.session_id),
                         args.hidden, dev)
    tx = SGD(args.lr, momentum=0.9)
    state = init_state(params, tx, mesh, replicated_axes(params))
    loss_fn, accuracy = make_fns(mesh)
    train_step = make_train_step(loss_fn, tx, mesh)

    local_bs = args.batch_size // info.num_processes
    rng = np.random.RandomState(1234 + info.process_id)

    def host_batches():
        while True:
            idx = rng.randint(0, len(images), size=(local_bs,))
            yield {"x": images[idx].reshape(local_bs, 784), "y": labels[idx]}

    # the held-out global batch of the periodic eval hook: the first draw
    sharding = batch_sharding(mesh)
    eval_batch = global_batch(sharding, {
        k: torch.from_numpy(v).to(dev)
        for k, v in next(host_batches()).items()})

    t0 = time.time()

    def log_fn(step, metrics, batch):
        if info.process_id == 0:
            eval_s = (f" acc {float(metrics['eval']):.3f}"
                      if "eval" in metrics else "")
            print(f"step {step} loss {float(metrics['loss']):.4f}{eval_s}",
                  flush=True)

    state, metrics = run_training(
        train_step, state,
        DevicePrefetcher(host_batches(), sharding=sharding), args.steps,
        eval_fn=lambda s: accuracy(s["params"], eval_batch),
        eval_every=50, log_every=50, log_fn=log_fn)
    wall = time.time() - t0

    loss = float(metrics["loss"]) if metrics else float("nan")
    acc = float(accuracy(state["params"], eval_batch))
    throughput = args.steps * args.batch_size / wall
    if info.process_id == 0:
        print(f"done: {args.steps} steps in {wall:.1f}s "
              f"({throughput:.0f} img/s), final loss {loss:.4f}, "
              f"acc {acc:.3f}", flush=True)
    if acc < args.target_acc:
        print(f"FAILED: accuracy {acc:.3f} < target {args.target_acc}",
              file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        rt.shutdown()
    sys.exit(rc)
