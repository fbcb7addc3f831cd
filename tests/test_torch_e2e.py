"""The port's ``train_lm`` as a job under the real orchestrator: client →
coordinator → 2 local executors → ``runtime.initialize`` from the
executor's environment → a gloo group of 2 → the sharded train step.

Built as ``tests/test_e2e.py`` builds its jobs (``TonyClient`` on the
local backend). Two arms: the default (jax) framework with
``tony.application.mesh=fsdp=-1``, and the pytorch framework
(``INIT_METHOD``/``RANK``/``WORLD``), which gets a dp mesh. Both
workers' stdout must show the world-2 mesh line and ``done:``, and the
job must exit 0. A job that another test's executor sweep killed (see
``_killed_from_outside``) is submitted once more.
"""

import os
import re
import sys

import pytest

from tony_tpu.client.client import TonyClient
from tony_tpu.conf.config import TonyConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _killed_from_outside(job_dir: str) -> bool:
    """Every task of the job died of SIGKILL. Nothing in the job sends
    one; the TPU backend's tests tear their fake slices down with
    ``pkill -9 -f tony_tpu.cluster.executor``, which reaches the
    executors of every job on the machine when they run beside this
    one."""
    with open(os.path.join(job_dir, "logs", "am.stderr")) as f:
        codes = re.findall(r"task \S+ exited with code (-?\d+)", f.read())
    return bool(codes) and all(c == "-9" for c in codes)


@pytest.mark.parametrize("framework,mesh,want", [
    ("jax", "fsdp=-1", "mesh={'fsdp': 2} devices=2"),
    ("pytorch", None, "mesh={'dp': 2} devices=2"),
])
def test_port_train_lm_runs_as_a_two_worker_job(framework, mesh, want,
                                                tmp_path):
    conf = {
        "tony.history.location": str(tmp_path / "tony-history"),
        "tony.application.timeout": "120000",
        "tony.worker.instances": "2",
        "tony.application.framework": framework,
    }
    if mesh:
        conf["tony.application.mesh"] = mesh
    command = (f"{sys.executable} -m tony_tpu_torch.train_lm --device cpu "
               f"--preset tiny --steps 3 --batch_size 2 --seq_len 32")
    for attempt in range(2):
        conf["tony.staging.dir"] = str(tmp_path / f"staging{attempt}")
        client = TonyClient(TonyConfig(conf), command,
                            shell_env={"PYTHONPATH": REPO,
                                       "OMP_NUM_THREADS": "2"})
        rc = client.run()
        if rc == 0 or not _killed_from_outside(client.job_dir):
            break
    assert rc == 0
    for i in range(2):
        out = open(os.path.join(client.job_dir, "logs",
                                f"worker-{i}.stdout")).read()
        assert f"[worker:{i}] attempt=0 {want}" in out, out
        assert "done: final loss" in out, out
