"""The port's ``train_lm`` as a job under the real orchestrator, and its
``serve_lm`` as a replica and a client in two processes.

``train_lm`` under the orchestrator: client →
coordinator → 2 local executors → ``runtime.initialize`` from the
executor's environment → a gloo group of 2 → the sharded train step.

Built as ``tests/test_e2e.py`` builds its jobs (``TonyClient`` on the
local backend). Two arms: the default (jax) framework with
``tony.application.mesh=fsdp=-1``, and the pytorch framework
(``INIT_METHOD``/``RANK``/``WORLD``), which gets a dp mesh, and an MoE
job (``--num_experts 4``) on ``tony.application.mesh=ep=2,dp=-1``, the
twin of ``tests/test_e2e.py::test_distributed_moe_lm_trains``: each
worker holds half the experts, and a context-parallel job
(``--cp_strategy ulysses``) on ``tony.application.mesh=cp=2,dp=-1``:
each worker trains on half of every sequence, and a pipeline job
(``--pp_schedule 1f1b``) on ``tony.application.mesh=pp=2,dp=-1``: each
worker holds one stage of the blocks (the twin of
``tests/test_e2e.py::test_distributed_pipeline_parallel_lm_trains``) and
prints the schedule it resolved. The north-star MNIST recipe
(``tony_tpu_torch.mnist_distributed``) and ResNet with synchronised
batch norm (``tony_tpu_torch.train_resnet``) run as 2-worker jobs on
``dp=-1``, the twins of ``tests/test_e2e.py``'s
``test_distributed_jax_mnist_trains`` and
``test_distributed_resnet_dp_trains``. Both workers' stdout must
show the world-2 mesh line (``'ep': 2``, ``'cp': 2``, ``'pp': 2``) and
``done:``, and the job must exit 0. A job of 4 workers in 2 slices
(``tony.worker.slices=2``, ``tony.application.mesh.dcn=dp=2``) trains
on the hybrid mesh, dp across the slices and tp inside. A ten-step job with
``tony.task.profile.*`` set shows what the orchestrator reads of it: each
worker's ``GOODPUT`` entry, the ``train.step`` spans of both, and a
trace of steps [5, 8) in each task's profile directory. The job's
executors run through :func:`_executor_launcher`, so the machine-wide
executor sweeps of the TPU backend's tests (see ``_killed_from_outside``)
cannot reach them; a job that was killed from outside all the same is
submitted again, up to 4 times.
"""

import glob
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


def _executor_launcher(tmp_path) -> str:
    """A ``tony.application.python-binary-path`` for the job: a script
    that takes the coordinator's ``-m tony_tpu.cluster.executor ARGS``
    and execs this interpreter on the same module through ``runpy``, so
    no process of the job has ``tony_tpu.cluster.executor`` on its
    command line. The TPU backend's tests tear their fake slices down
    with ``pkill -9 -f tony_tpu.cluster.executor``, which matches every
    executor on the machine; running beside them (``pytest -n``), all of
    a job's resubmissions were killed within 35 s."""
    path = tmp_path / "python-executor"
    path.write_text(
        "#!/bin/sh\n"
        "shift 2\n"
        f"exec {sys.executable} -c 'import runpy; runpy.run_module("
        "\"tony_tpu\" \".cluster\" \".executor\", run_name=\"__main__\", "
        "alter_sys=True)' \"$@\"\n")
    path.chmod(0o755)
    return str(path)


def _killed_from_outside(job_dir: str) -> bool:
    """Every task of the job died of SIGKILL. Nothing in the job sends
    one; the TPU backend's tests tear their fake slices down with
    ``pkill -9 -f tony_tpu.cluster.executor``, which reaches the
    executors of every job on the machine when they run beside this
    one."""
    with open(os.path.join(job_dir, "logs", "am.stderr")) as f:
        codes = re.findall(r"task \S+ exited with code (-?\d+)", f.read())
    return bool(codes) and all(c == "-9" for c in codes)


def _run_job(tmp_path, conf, command):
    """Submit ``command`` as a job of ``conf`` (plus the launcher and a
    staging directory a try) until it was not killed from outside, up
    to 4 times: (exit code, the client)."""
    conf = dict(conf, **{
        "tony.application.python-binary-path": _executor_launcher(tmp_path)})
    for attempt in range(4):
        conf["tony.staging.dir"] = str(tmp_path / f"staging{attempt}")
        client = TonyClient(TonyConfig(conf), command,
                            shell_env={"PYTHONPATH": REPO,
                                       "OMP_NUM_THREADS": "2"})
        rc = client.run()
        if rc == 0 or not _killed_from_outside(client.job_dir):
            break
    return rc, client


def test_port_train_lm_runs_as_a_two_slice_job(tmp_path):
    """``tony.worker.slices=2`` with a dcn mesh (the twin of
    ``tests/test_e2e.py::TestE2E::test_multi_slice_env``): 4 workers in 2
    gangs, ``runtime.mesh()`` builds the hybrid mesh, dp across the
    slices and tp inside each, and every worker trains 2 steps."""
    rc, client = _run_job(tmp_path, {
        "tony.history.location": str(tmp_path / "tony-history"),
        "tony.application.timeout": "180000",
        "tony.worker.instances": "4",
        "tony.worker.slices": "2",
        "tony.application.mesh": "tp=-1",
        "tony.application.mesh.dcn": "dp=2",
    }, f"{sys.executable} -m tony_tpu_torch.train_lm --device cpu --preset "
       f"tiny --steps 2 --batch_size 2 --seq_len 32")
    assert rc == 0
    for i in range(4):
        out = open(os.path.join(client.job_dir, "logs",
                                f"worker-{i}.stdout")).read()
        assert (f"[worker:{i}] attempt=0 mesh={{'dp': 2, 'tp': 2}} "
                f"devices=4") in out, out
        assert "done: final loss" in out, out


@pytest.mark.parametrize("framework,mesh,want", [
    ("jax", "fsdp=-1", "mesh={'fsdp': 2} devices=2"),
    ("pytorch", None, "mesh={'dp': 2} devices=2"),
    ("jax", "ep=2,dp=-1", "mesh={'dp': 1, 'ep': 2} devices=2"),
    ("jax", "cp=2,dp=-1", "mesh={'dp': 1, 'cp': 2} devices=2"),
    ("jax", "pp=2,dp=-1", "mesh={'pp': 2, 'dp': 1} devices=2"),
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
    if mesh and "ep" in mesh:
        command += " --num_experts 4"
    if mesh and "cp" in mesh:
        command += " --cp_strategy ulysses"
    if mesh and "pp" in mesh:
        command += " --pp_schedule 1f1b"
    rc, client = _run_job(tmp_path, conf, command)
    assert rc == 0
    for i in range(2):
        out = open(os.path.join(client.job_dir, "logs",
                                f"worker-{i}.stdout")).read()
        assert f"[worker:{i}] attempt=0 {want}" in out, out
        assert "done: final loss" in out, out
        if mesh and "pp" in mesh:
            assert "pipeline schedule: 1f1b" in out, out


def _both_stdouts(client) -> str:
    return "".join(open(os.path.join(client.job_dir, "logs",
                                     f"worker-{i}.stdout")).read()
                   for i in range(2))


def test_port_mnist_runs_as_a_two_worker_job(tmp_path):
    """The north-star recipe (the twin of
    ``tests/test_e2e.py::TestE2E::test_distributed_jax_mnist_trains``):
    2 workers on ``dp=-1`` federate into one data-parallel program, and
    the job exits 0 only if it reached its target accuracy."""
    rc, client = _run_job(tmp_path, {
        "tony.history.location": str(tmp_path / "tony-history"),
        "tony.application.timeout": "120000",
        "tony.worker.instances": "2",
        "tony.application.mesh": "dp=-1",
    }, f"{sys.executable} -m tony_tpu_torch.mnist_distributed --device cpu "
       f"--steps 60 --batch_size 128")
    out = _both_stdouts(client)
    assert rc == 0, out
    assert "2 global devices" in out, out
    assert "done:" in out, out


def test_port_resnet_runs_as_a_two_worker_job(tmp_path):
    """ResNet with sync-BN across 2 processes (the twin of
    ``tests/test_e2e.py::TestE2E::test_distributed_resnet_dp_trains``)."""
    rc, client = _run_job(tmp_path, {
        "tony.history.location": str(tmp_path / "tony-history"),
        "tony.application.timeout": "180000",
        "tony.worker.instances": "2",
        "tony.application.mesh": "dp=-1",
    }, f"{sys.executable} -m tony_tpu_torch.train_resnet --device cpu "
       f"--steps 3 --batch_size 4 --image_size 32 --num_classes 10 "
       f"--lr 0.01")
    out = _both_stdouts(client)
    assert rc == 0, out
    assert "[worker:0] devices=2 mesh={'dp': 2}" in out, out
    assert out.count("done: final loss") == 2, out


def test_port_train_lm_job_feeds_goodput_spans_and_traces(tmp_path):
    """The orchestrator sees inside a port job: each worker's final
    ``GOODPUT`` entry carves its wall into categories (``step`` > 0, ten
    closed steps), ``train.step`` spans of both workers reach
    ``TRACE_SPAN`` events, and ``tony.task.profile.*`` leaves each task a
    Chrome trace of steps [5, 8) in its own profile directory."""
    import json
    from tony_tpu.events import events as ev
    prof = tmp_path / "profiles"
    conf = {
        "tony.history.location": str(tmp_path / "tony-history"),
        "tony.application.timeout": "120000",
        "tony.worker.instances": "2",
        "tony.task.heartbeat-interval-ms": "100",
        "tony.task.profile.enabled": "true",
        "tony.task.profile.dir": str(prof),
        "tony.application.python-binary-path": _executor_launcher(tmp_path),
    }
    command = (f"{sys.executable} -m tony_tpu_torch.train_lm --device cpu "
               f"--preset tiny --steps 10 --batch_size 2 --seq_len 32")
    for attempt in range(4):
        conf["tony.staging.dir"] = str(tmp_path / f"staging{attempt}")
        conf["tony.history.location"] = str(tmp_path / f"hist{attempt}")
        client = TonyClient(TonyConfig(conf), command,
                            shell_env={"PYTHONPATH": REPO,
                                       "OMP_NUM_THREADS": "2"})
        rc = client.run()
        if rc == 0 or not _killed_from_outside(client.job_dir):
            break
    assert rc == 0
    events = [e for path in ev.find_job_files(conf["tony.history.location"])
              for e in ev.parse_events(path)]
    goodputs = [e for e in events if e.event_type == ev.GOODPUT]
    assert goodputs, "no GOODPUT events reached the jhist"
    tasks = goodputs[-1].payload["tasks"]
    for tid in ("worker:0", "worker:1"):
        entry = tasks[tid]
        wall = entry["now"] - entry["t0"]
        assert sum(entry["cat"].values()) == pytest.approx(wall, abs=0.02)
        assert entry["cat"]["step"] > 0
        assert entry["sw"]["c"] == 10
    steps = {}
    for e in events:
        if e.event_type == ev.TRACE_SPAN:
            for span in e.payload.get("spans", []):
                if span["n"] == "train.step":
                    steps.setdefault(e.payload.get("task"), set()).add(
                        span["a"]["step"])
    assert steps.get("worker:0") and steps.get("worker:1"), steps
    for i in range(2):
        traces = glob.glob(str(prof / f"worker-{i}" / "*.pt.trace.json"))
        assert len(traces) == 1, traces
        with open(traces[0]) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        assert sorted(n for n in names if n.startswith("ProfilerStep#")) \
            == ["ProfilerStep#5", "ProfilerStep#6", "ProfilerStep#7"]


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
