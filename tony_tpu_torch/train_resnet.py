"""ResNet data-parallel training over every process of the job, with
synchronised batch norm — the port's counterpart of
``examples/resnet/train_resnet.py``.

    python -m tony_tpu_torch.train_resnet --steps 100 [--depth 50] \\
        [--batch_size 32] [--image_size 224] [--num_classes 1000] \\
        [--lr 0.1] [--device cpu]

As the JAX script does: the process group from the executor's
environment (``runtime.initialize``), the mesh (``runtime.mesh``;
``tony.application.mesh=dp=-1``; a lone process gets a world-1 mesh),
random weights from seed 0, ``optax.sgd(lr, momentum=0.9,
nesterov=True)`` (:class:`~tony_tpu_torch.models.train.SGD`), and its own
step: the batch-norm statistics ride in the state (``{"params", "stats",
"opt_state", "step"}``), the step differentiates
``resnet.classification_loss`` on the mesh (each rank's rows, the
statistics over the global batch, the params' gradients summed over the
data ranks) and updates the params. Synthetic ImageNet-shaped batches,
``--batch_size`` per process, from ``numpy.random.RandomState(task
index)`` (the JAX script's bytes), assembled into the global batch by a
``DevicePrefetcher`` and driven by
:func:`~tony_tpu_torch.models.loop.run_training`. bf16 on the card, f32
on the CPU (``--device cpu``, gloo); with no card and no ``--device
cpu`` it raises. Prints the JAX script's lines: ``[job:index] devices=N
mesh={…}``, ``step {i} loss {l} images/s {r}`` (global images) every 10
steps and ``done: final loss {l}``; exits 0 if and only if the loss is
finite.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

import tony_tpu_torch.runtime as rt
from tony_tpu_torch import resolve_device
from tony_tpu_torch.io.prefetch import DevicePrefetcher
from tony_tpu_torch.models import resnet as R
from tony_tpu_torch.models.loop import run_training
from tony_tpu_torch.models.train import (SGD, _instrument_step,
                                         batch_sharding, init_state,
                                         replicated_axes, value_and_grad)
from tony_tpu_torch.parallel import mesh_shape


def synthetic_batches(seed, batch, image_size, num_classes):
    """Infinite host-side image batches (f32 numpy; the train step casts
    to the model dtype on the device)."""
    rs = np.random.RandomState(seed)
    while True:
        yield {
            "image": rs.randn(batch, image_size, image_size, 3)
                       .astype(np.float32),
            "label": rs.randint(0, num_classes, size=(batch,))
                       .astype(np.int32),
        }


def make_step(opt, depth: int, dtype, mesh=None):
    """``step(state, batch) -> (state, {"loss", "grad_norm", "step"})``,
    the JAX script's ``step_impl``: the image cast to ``dtype``, the loss
    and new statistics of the batch (global over ``mesh``), the update."""

    def step(state, batch):
        batch = dict(batch, image=batch["image"].to(dtype))
        (loss, stats), grads = value_and_grad(
            R.classification_loss, state["params"], state["stats"], batch,
            depth, mesh, has_aux=True)
        params, opt_state, gnorm = opt.apply(grads, state["opt_state"],
                                             state["params"])
        new = {"params": params, "stats": stats, "opt_state": opt_state,
               "step": state["step"] + 1}
        return new, {"loss": loss, "grad_norm": gnorm, "step": new["step"]}

    return _instrument_step(step)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--depth", type=int, default=50,
                        choices=sorted(R.STAGE_SIZES))
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=32,
                        help="batch size PER PROCESS (global = this x "
                             "processes)")
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--num_classes", type=int, default=1000)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    info = rt.initialize(dev)
    mesh = rt.mesh(device=dev)
    print(f"[{info.job_name}:{info.task_index}] devices={mesh.size()} "
          f"mesh={mesh_shape(mesh)}", flush=True)

    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params, stats = R.init_resnet(torch.Generator().manual_seed(0),
                                  depth=args.depth,
                                  num_classes=args.num_classes, dtype=dtype,
                                  device=dev)
    opt = SGD(args.lr, momentum=0.9, nesterov=True)
    state = dict(init_state(params, opt, mesh, replicated_axes(params)),
                 stats=stats)
    step = make_step(opt, args.depth, dtype, mesh)
    data = DevicePrefetcher(
        synthetic_batches(info.task_index, args.batch_size,
                          args.image_size, args.num_classes),
        sharding=batch_sharding(mesh))
    t0 = time.perf_counter()

    def log_fn(i, metrics, batch):
        img_s = (args.batch_size * info.num_processes * (i + 1)
                 / (time.perf_counter() - t0))
        print(f"step {i} loss {float(metrics['loss']):.4f} "
              f"images/s {img_s:,.1f}", flush=True)

    state, metrics = run_training(step, state, data, args.steps,
                                  log_every=10, log_fn=log_fn)
    loss = float(metrics["loss"]) if metrics else float("nan")
    print(f"done: final loss {loss:.4f}", flush=True)
    return 0 if math.isfinite(loss) else 1


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        rt.shutdown()
    sys.exit(rc)
