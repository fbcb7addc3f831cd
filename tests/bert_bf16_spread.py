"""How far a bf16 BERT step's gradient moves from its f32 step, on the CPU:
the JAX package's unsplit step and its steps on ``{"dp": 1, "cp": 2}`` and
``{"dp": 2}`` meshes, and the port's unsplit step at several thread
counts (the same arithmetic summed in another order) and its step on an
emulated ``{"cp": 2}`` (the non-causal ring over two chunks, through the
kernels' plain versions).

For each step it prints the loss, the grad norm relative to its
package's f32 unsplit step, and (port) the relative L2 distance of the
whole gradient from the f32 one. It is the CPU side of ``chip_smoke.py``
phase 26's bf16 checks: the grad norm of a bf16 step moves by about 1e-3
with the order of its sums alone, so it cannot tell rounding from a
fault at that level; the L2 distance from f32 can.

    PYTHONPATH= JAX_PLATFORMS=cpu python tests/bert_bf16_spread.py \\
        [--layers 12] [--batch 4] [--seq 512]

BERT-base widths; weights from the JAX package's ``init_params`` at
``PRNGKey(0)``, the MLM batch ``synthetic_mlm_batches(26, ...)``. About
two minutes and a few GiB at the defaults.
"""

import argparse
import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=2").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tony_tpu.models import bert as JB  # noqa: E402
from tony_tpu.parallel.mesh import make_mesh  # noqa: E402
from tony_tpu.parallel.sharding import shard_pytree  # noqa: E402
from tony_tpu_torch import pretrain_bert, tree_leaves, tree_map  # noqa: E402
from tony_tpu_torch.models import bert as TB  # noqa: E402
from tony_tpu_torch.models import train as TR  # noqa: E402
from tony_tpu_torch.models.weights import params_from_numpy  # noqa: E402
from tony_tpu_torch.parallel import ring_attention as R  # noqa: E402


def _norm(leaves) -> float:
    return float(np.sqrt(sum((np.asarray(x, np.float64) ** 2).sum()
                             for x in leaves)))


def _dist(leaves, ref) -> float:
    num = sum(((np.asarray(a, np.float64) - np.asarray(b, np.float64))
               ** 2).sum() for a, b in zip(leaves, ref))
    return float(np.sqrt(num)) / _norm(ref)


def _jax_steps(p32, batch, jcfg):
    """{name: (loss, grads as numpy f32)} of the JAX package's steps."""
    out = {}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for dname, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        cfg = dataclasses.replace(jcfg, dtype=dtype)
        params = jax.tree.map(lambda a: jnp.asarray(a, dtype), p32)
        for mname, sizes in (("unsplit", None), ("cp2", {"dp": 1, "cp": 2}),
                             ("dp2", {"dp": 2})):
            mesh = (None if sizes is None
                    else make_mesh(sizes, devices=jax.devices()[:2]))
            p = (params if mesh is None
                 else shard_pytree(params, JB.logical_axes(cfg), mesh))
            loss, g = jax.jit(jax.value_and_grad(
                lambda q, b: JB.mlm_loss(q, b, cfg, mesh)))(p, jb)
            out[f"{dname} {mname}"] = (float(loss), [
                np.asarray(x, np.float32) for x in jax.tree.leaves(g)])
    return out


def _port_steps(p32, batch, tcfg):
    """{name: (loss, grads as numpy f32)} of the port's steps."""
    R._USE_FLASH_CHUNKS = True          # the kernels' plain versions
    out = {}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = (("f32", torch.float32, "unsplit", None, 8),
            ("bf16", torch.bfloat16, "unsplit", None, 8),
            ("bf16", torch.bfloat16, "unsplit", None, 4),
            ("bf16", torch.bfloat16, "unsplit", None, 2),
            ("bf16", torch.bfloat16, "cp2", {"cp": 2}, 8),
            ("bf16", torch.bfloat16, "cp2", {"cp": 2}, 4))
    for dname, dtype, mname, mesh, threads in runs:
        torch.set_num_threads(threads)
        cfg = dataclasses.replace(tcfg, dtype=dtype)
        params = tree_map(lambda t: t.to(dtype),
                          params_from_numpy(p32, device="cpu"))
        loss, g = TR.value_and_grad(
            lambda q, b: TB.mlm_loss(q, b, cfg, mesh), params, tb)
        out[f"{dname} {mname} {threads} threads"] = (float(loss), [
            x.float().numpy() for x in tree_leaves(g)])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args()
    jcfg = dataclasses.replace(JB.BERT_BASE, n_layers=args.layers,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(TB.BERT_BASE, n_layers=args.layers,
                               dtype=torch.float32)
    p32 = jax.device_get(jax.jit(JB.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    batch = next(pretrain_bert.synthetic_mlm_batches(
        26, args.batch, args.seq, tcfg))
    print(f"BERT-base widths, {args.layers} layers, {args.batch} x "
          f"{args.seq}, CPU", flush=True)
    for fam, steps in (("JAX package", _jax_steps(p32, batch, jcfg)),
                       ("port", _port_steps(p32, batch, tcfg))):
        ref = next(g for k, (_, g) in steps.items() if k.startswith("f32"))
        n32 = _norm(ref)
        for name, (loss, g) in steps.items():
            n = _norm(g)
            print(f"{fam} {name}: loss {loss:.7f}, grad norm {n:.7f} "
                  f"({(n - n32) / n32:+.3e} from f32 unsplit), L2 distance "
                  f"from f32 unsplit {_dist(g, ref):.4e}", flush=True)


if __name__ == "__main__":
    main()
