"""The port's ``train_lm`` as a job under the real orchestrator, and its
``serve_lm`` as a replica and a client in two processes.

``train_lm`` under the orchestrator: client →
coordinator → 2 local executors → ``runtime.initialize`` from the
executor's environment → a gloo group of 2 → the sharded train step.

Built as ``tests/test_e2e.py`` builds its jobs (``TonyClient`` on the
local backend). Two arms: the default (jax) framework with
``tony.application.mesh=fsdp=-1``, and the pytorch framework
(``INIT_METHOD``/``RANK``/``WORLD``), which gets a dp mesh. Both
workers' stdout must show the world-2 mesh line and ``done:``, and the
job must exit 0. A job that another test's executor sweep killed (see
``_killed_from_outside``) is submitted again, up to 4 times: those
sweeps come in series.
"""

import os
import re
import signal
import subprocess
import sys
import time

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
    for attempt in range(4):
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


def _serve_lm(*args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.serve_lm", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, **kw)


def test_serve_lm_replica_and_client_processes(tmp_path):
    """``serve_lm --device cpu --listen`` in one process, sampled, and
    ``--connect --mixed_classes`` in another: every request streams its
    budget, per-class TTFT/ITL lines print, and SIGTERM drains the
    replica to exit 0. The client's first request streams the tokens a
    closed-batch sampled serve of the same workload gives it in-process
    (request i samples stream i of the replica's seed, whatever its
    class)."""
    from tony_tpu_torch import serve_lm
    from tony_tpu_torch.models.serve import ContinuousBatcher
    cfg, params = serve_lm.build("tiny", "cpu")
    prompts, budgets = serve_lm.make_workload(0, 5, 16, 32, cfg.vocab_size)
    want = ContinuousBatcher(params, cfg, batch=2, max_len=48,
                             temperature=0.8, top_k=50, top_p=0.95,
                             seed=0).serve(prompts, budgets)
    srv = _serve_lm("--device", "cpu", "--preset", "tiny", "--slots", "2",
                    "--temperature", "0.8", "--top_k", "50", "--top_p",
                    "0.95", "--listen", "127.0.0.1:0")
    try:
        line = srv.stdout.readline()
        m = re.search(r"on (127\.0\.0\.1:\d+) with 2 slots", line)
        assert m, line
        cli = _serve_lm("--preset", "tiny", "--requests", "5",
                        "--connect", m.group(1), "--mixed_classes",
                        "--busy_retries", "2")
        out, _ = cli.communicate(timeout=240)
        assert cli.returncode == 0, out
        assert f"streamed 5 requests ({sum(budgets)} tokens)" in out, out
        for cls in ("interactive", "standard", "batch"):
            assert re.search(rf"{cls} \(\d reqs\): ttft p50 [\d.]+ ms "
                             rf" p99 [\d.]+ ms;  inter-token p50", out), out
        assert f"first request tokens: {want[0][:12]}" in out, out
    finally:
        srv.send_signal(signal.SIGTERM)
        rest, _ = srv.communicate(timeout=120)
    assert srv.returncode == 0, rest
    assert "draining in-flight requests" in rest


def test_serve_lm_restores_a_train_lm_checkpoint(tmp_path, capsys):
    """What the port trains, the port serves: ``serve_lm --ckpt_dir``
    loads the params of ``train_lm``'s checkpoint (its last step)."""
    from tony_tpu_torch import serve_lm, train_lm
    ckpt = str(tmp_path / "ckpt")
    assert train_lm.main(["--device", "cpu", "--preset", "tiny",
                          "--steps", "2", "--batch_size", "2", "--seq_len",
                          "16", "--ckpt_dir", ckpt, "--ckpt_every",
                          "1"]) == 0
    cfg, params = serve_lm.build("tiny", "cpu", ckpt_dir=ckpt)
    assert "restored step 2 from" in capsys.readouterr().out
    fresh = serve_lm.build("tiny", "cpu")[1]
    assert not all((params[k] == fresh[k]).all() for k in params)
    assert serve_lm.main(["--device", "cpu", "--preset", "tiny",
                          "--requests", "2", "--slots", "2",
                          "--prompt_len", "6", "--max_new_tokens", "4",
                          "--ckpt_dir", ckpt]) == 0
    assert "served 2 requests" in capsys.readouterr().out
