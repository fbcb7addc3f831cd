"""Task-side runtime: boot ``torch.distributed`` from the environment the
executor exports, and build the job's mesh.

Port of ``tony_tpu/runtime/__init__.py``. A user script calls::

    import tony_tpu_torch.runtime as rt
    rt.initialize()          # process group: NCCL on the card, gloo on CPU
    mesh = rt.mesh()         # DeviceMesh over ALL processes, axes from config

The executor exports one of two bootstraps (``tony_tpu_torch.constants``):

- the jax arm (the default framework): the coordinator address (process
  0's registered ``host:port``, which is free: the executor reserves the
  port and releases it before the user process starts), the process id,
  the process count and the mesh spec. The coordinator address is the
  ``tcp://`` rendezvous: rank 0 binds its store there;
- the pytorch arm (``tony.application.framework=pytorch``):
  ``INIT_METHOD=tcp://<first worker>``, ``RANK`` and ``WORLD``, and no
  mesh spec. Rank 0 binds the store on the first worker's registered
  port. That arm gets a 1-D ``dp`` mesh only; a mesh spec asking for more
  is refused.

A single process (a bare run, or a one-task job) still builds a world-1
group, so that one code path — the mesh, DTensor params, the sharded step
and checkpoints — serves 1 and N processes. The helpers here read the
environment only; the submodules ``metrics`` and ``profiler`` hold the
host-side timing and metrics.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from dataclasses import dataclass

from tony_tpu_torch import constants

log = logging.getLogger(__name__)

#: how long a rank waits for its peers (rendezvous and every collective)
#: before it fails: a lost peer fails the task instead of hanging it
GROUP_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class TaskInfo:
    job_name: str
    task_index: int
    task_num: int
    session_id: int
    attempt: int
    process_id: int
    num_processes: int
    coordinator_address: str
    cluster_spec: dict
    init_method: str = ""     # the tcp:// rendezvous ("" = none given)
    framework: str = "jax"    # the executor arm: "jax" or "pytorch"

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def task_info() -> TaskInfo:
    """Parse the executor-exported environment (works outside tony too,
    defaulting to a single local process). The pytorch arm is recognized
    by ``INIT_METHOD`` with no jax-arm coordinator address: its ``RANK``
    and ``WORLD`` stand for the process id and count."""
    env = os.environ
    spec = env.get(constants.CLUSTER_SPEC, "")
    coordinator = env.get(constants.JAX_COORDINATOR_ADDRESS, "")
    pytorch = bool(env.get(constants.INIT_METHOD)) and not coordinator
    if pytorch:
        pid, nproc = env.get(constants.RANK, "0"), env.get(constants.WORLD,
                                                           "1")
        init_method = env[constants.INIT_METHOD]
    else:
        pid = env.get(constants.JAX_PROCESS_ID, "0")
        nproc = env.get(constants.JAX_NUM_PROCESSES, "1")
        init_method = f"tcp://{coordinator}" if coordinator else ""
    return TaskInfo(
        job_name=env.get(constants.JOB_NAME, "worker"),
        task_index=int(env.get(constants.TASK_INDEX, "0")),
        task_num=int(env.get(constants.TASK_NUM, "1")),
        session_id=int(env.get(constants.SESSION_ID, "0")),
        attempt=int(env.get(constants.ATTEMPT_NUMBER, "0")),
        process_id=int(pid),
        num_processes=int(nproc),
        coordinator_address=coordinator,
        cluster_spec=json.loads(spec) if spec else {},
        init_method=init_method,
        framework="pytorch" if pytorch else "jax",
    )


def local_rank(info: TaskInfo, device_count: int) -> int:
    """The card this process takes: ``process_id % device_count``. The
    executor exports no local rank; process ids are dense, and a host's
    tasks hold consecutive ids when every host runs one task per card,
    so the remainder numbers the cards of a host."""
    return info.process_id % max(device_count, 1)


def initialize(device=None, timeout_s: float = GROUP_TIMEOUT_S) -> TaskInfo:
    """Boot the default process group from the task's identity: NCCL when
    the device is the card (the default; each process takes
    ``cuda:(local rank)``, see :func:`local_rank`), gloo on the CPU
    (``device="cpu"``). With a rendezvous in the environment it is used
    (rank 0 binds it); a lone process with none builds its world-1 group
    in memory. Idempotent: a process that already has a group keeps it
    (on the same backend)."""
    import torch
    import torch.distributed as dist

    from tony_tpu_torch import resolve_device
    info = task_info()
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}"
                               f", not {backend} for {dev}")
        return info
    if info.is_distributed and not info.init_method:
        raise RuntimeError(f"{info.num_processes} processes but no "
                           f"rendezvous address in the environment")
    kw = dict(rank=info.process_id, world_size=info.num_processes,
              timeout=datetime.timedelta(seconds=timeout_s))
    if dev.type == "cuda":
        card = torch.device("cuda", local_rank(info,
                                               torch.cuda.device_count()))
        torch.cuda.set_device(card)
        kw["device_id"] = card
    if info.init_method:
        log.info("init_process_group(%s, %s, rank=%d, world=%d)", backend,
                 info.init_method, info.process_id, info.num_processes)
        dist.init_process_group(backend, init_method=info.init_method, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), **kw)
    return info


def shutdown() -> None:
    """Destroy the default process group, if any."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_axes() -> dict[str, int]:
    """The mesh layout shipped by the coordinator
    (``tony.application.mesh``), or ``{}`` when unset."""
    raw = os.environ.get(constants.MESH_SPEC, "")
    if not raw:
        return {}
    return json.loads(raw).get("axes", {})


def mesh_dcn_axes() -> dict[str, int]:
    """The cross-slice mesh layout (``tony.application.mesh.dcn``), or
    ``{}`` for single-slice jobs."""
    raw = os.environ.get(constants.MESH_SPEC, "")
    if not raw:
        return {}
    return json.loads(raw).get("dcn_axes", {})


def slice_info() -> tuple[int, int]:
    """(slice_id, num_slices) of this host's gang — (0, 1) for
    single-slice job types."""
    return (int(os.environ.get(constants.SLICE_ID, "0")),
            int(os.environ.get(constants.NUM_SLICES, "1")))


def mesh(axes: dict[str, int] | None = None,
         axis_order: tuple[str, ...] | None = None,
         dcn_axes: dict[str, int] | None = None, device=None):
    """A ``DeviceMesh`` over ALL processes (booting the group first, see
    :func:`initialize`). ``axes`` default to the config-shipped layout;
    one axis given as -1/0 is inferred from the process count; nothing
    configured gives ``{"dp": world}``. Under the pytorch arm the mesh is
    ``{"dp": world}`` and a mesh spec asking for any other axis raises.
    Multi-slice (dcn) layouts are not ported and raise."""
    from tony_tpu_torch.parallel.mesh import make_mesh
    info = initialize(device)
    axes = dict(axes if axes is not None else mesh_axes())
    if info.framework == "pytorch":
        extra = {k: v for k, v in axes.items() if k != "dp" and v != 1}
        if extra:
            raise ValueError(f"the pytorch arm (INIT_METHOD/RANK/WORLD) "
                             f"runs a dp mesh only; the mesh spec asks for "
                             f"{extra}: submit the job with the jax arm")
        axes = {"dp": -1}
    if dcn_axes if dcn_axes is not None else mesh_dcn_axes():
        raise NotImplementedError("multi-slice (dcn) meshes are not ported "
                                  "yet")
    return make_mesh(axes, axis_order=axis_order)
