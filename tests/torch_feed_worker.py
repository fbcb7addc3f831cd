"""One rank of the port's file feed in a gloo group, for
tests/test_torch_feed.py.

Run as ``python tests/torch_feed_worker.py OUT_DIR FILE...`` with the jax
arm's bootstrap in the environment (``TONY_JAX_COORDINATOR_ADDRESS``,
``TONY_JAX_PROCESS_ID``, ``TONY_JAX_NUM_PROCESSES``). The rank boots its
group through ``tony_tpu_torch.runtime`` on the CPU and writes
``rank<r>.npz``:

- ``dp/local<i>``, ``dp/full<i>``: ``global_batches`` over a ``{"dp": 2}``
  mesh (3 rows of 5 int32 a rank, unshuffled): the rank's shard and the
  assembled DTensor's full tensor;
- ``tp/file<i>``, ``tp/elastic<i>``: the first batches' ``inputs`` of
  train_lm's ``file_source`` and ``elastic_file_source`` over a
  ``{"tp": 2}`` mesh (the batch replicated over both ranks), as the rank
  feeds them through a ``DevicePrefetcher`` with the train step's batch
  sharding (the local tensor, and whether it is replicated);
- ``tp/error``: ``to_global_tensor``'s refusal of batch axes the mesh
  lacks.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import tony_tpu_torch.runtime as rt  # noqa: E402
from tony_tpu_torch import train_lm  # noqa: E402
from tony_tpu_torch.io import global_batches, to_global_tensor  # noqa: E402
from tony_tpu_torch.io.prefetch import DevicePrefetcher  # noqa: E402
from tony_tpu_torch.models.train import batch_sharding  # noqa: E402
from tony_tpu_torch.parallel.mesh import make_mesh  # noqa: E402


def main(out_dir: str, paths: list[str]) -> None:
    info = rt.initialize("cpu")
    out = {}
    mesh = make_mesh({"dp": 2}, device_type="cpu")
    for i, g in enumerate(global_batches(paths, 3, np.int32, (5,), mesh)):
        out[f"dp/local{i}"] = g.to_local().numpy()
        out[f"dp/full{i}"] = g.full_tensor().numpy()

    mesh = make_mesh({"tp": 2}, device_type="cpu")
    sharding = batch_sharding(mesh, logical=("batch", "seq"))
    sources = {"file": train_lm.file_source(paths, 2, 4, seed=0, mesh=mesh),
               "elastic": train_lm.elastic_file_source(
                   paths, 4, 4, seed=0, start_step=1, mesh=mesh)}
    for name, source in sources.items():
        with DevicePrefetcher(source, device="cpu", depth=2,
                              sharding=sharding) as batches:
            for i, b in zip(range(3), batches):
                x = b["inputs"]
                out[f"tp/{name}{i}"] = x.to_local().numpy()
                out[f"tp/{name}_replicated"] = np.array(
                    all(p.is_replicate() for p in x.placements))
    try:
        to_global_tensor(np.zeros((2, 5), np.int32), mesh)
    except ValueError as e:
        out["tp/error"] = np.array(str(e))
    np.savez(os.path.join(out_dir, f"rank{info.process_id}.npz"), **out)
    rt.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
