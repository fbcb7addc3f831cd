"""tony_tpu_torch stands alone: it imports neither ``jax`` nor anything of
``tony_tpu``, its entry points never fall back from the card to the CPU,
and chip_smoke.py refuses to report a result without a card or outside
the repository."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import tony_tpu_torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
before = set(sys.modules)
import tony_tpu_torch
names = ["tony_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    tony_tpu_torch.__path__, "tony_tpu_torch.")]
for n in names:
    importlib.import_module(n)
new = sorted(set(sys.modules) - before)
print(json.dumps({"modules": names, "new": new}))
"""


def test_port_modules_import_neither_jax_nor_tony_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    import json
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("models.serve", "ops.attention", "ops.optim",
                "models.train", "models.loop", "models.checkpoint",
                "io.prefetch", "train_lm", "ops.prng", "serve_lm",
                "runtime.tracing", "runtime.metrics", "runtime.goodput",
                "runtime.profiler", "serving.protocol",
                "serving.client", "serving.server", "serving.weightstore",
                "conf.keys", "models.quantize", "models.decode",
                "models.weights", "generate", "channels.channel",
                "serving.blobcodec", "serving.kvship", "serving.prefix",
                "serving.disagg", "serving.router", "storage", "io.split",
                "io.snappy", "io.framed", "io.avro", "io.native",
                "io.reader", "io.torch_feed", "parallel.moe",
                "parallel.spmd", "parallel.ring_attention",
                "parallel.ulysses", "parallel.pipeline",
                "channels.registry", "train_pipeline", "serving.fleet",
                "serving.simfleet", "serving.netem", "models.resnet",
                "models.mnist", "train_resnet", "mnist_distributed"):
        assert f"tony_tpu_torch.{mod}" in rep["modules"]
    bad = [m for m in rep["new"]
           if m == "jax" or m.startswith(("jax.", "jaxlib", "ml_dtypes"))
           or m == "tony_tpu" or m.startswith("tony_tpu.")]
    assert bad == []


def test_router_loads_no_model_stack():
    """The router and the fleet's modules (the controller, the simulated
    fleet, the latency proxy) are deployable on a host with no model
    stack: none imports torch, and importing them (with everything they
    import) leaves torch unloaded."""
    for name in ("router", "fleet", "simfleet", "netem"):
        path = os.path.join(REPO, "tony_tpu_torch", "serving",
                            name + ".py")
        names = list(_imports_of(path))
        assert not [m for m in names if m.split(".")[0] == "torch"], \
            (name, names)
    code = ("import sys, tony_tpu_torch.serving.router, "
            "tony_tpu_torch.serving.client, tony_tpu_torch.serving.fleet, "
            "tony_tpu_torch.serving.simfleet, "
            "tony_tpu_torch.serving.netem; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def _imports_of(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_file_names_jax_or_the_jax_package():
    """Static check over every module of the port and chip_smoke.py,
    lazy imports inside functions included."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for m in pkgutil.walk_packages(tony_tpu_torch.__path__,
                                   "tony_tpu_torch."):
        paths.append(m.module_finder.find_spec(m.name).origin)
    for path in paths:
        for mod in _imports_of(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "ml_dtypes", "tony_tpu"), \
                f"{path} imports {mod}"


def test_entry_points_raise_without_a_card(monkeypatch):
    from tony_tpu_torch import mnist_distributed, train_resnet
    from tony_tpu_torch.models import decode, mnist, resnet, transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = transformer.PRESETS["tiny"].scaled(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.init_kv_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet.init_resnet(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mnist.init_mlp(torch.Generator().manual_seed(0))
    for main in (train_resnet.main, mnist_distributed.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tony_tpu_torch.resolve_device("cuda")
    assert tony_tpu_torch.resolve_device("cpu").type == "cpu"


def test_the_copied_data_feed_sources_name_no_jax():
    """The reader stack is the port's own copy: its sources (docstrings
    and comments included) do not name JAX or the JAX package."""
    import re
    root = os.path.join(REPO, "tony_tpu_torch")
    names = ["storage/__init__.py", "io/split.py", "io/snappy.py",
             "io/framed.py", "io/avro.py", "io/reader.py",
             "io/torch_feed.py", "io/native/__init__.py",
             "io/native/datafeed.cc"]
    for name in names:
        text = open(os.path.join(root, name), encoding="utf-8").read()
        assert not re.search(r"jax|tony_tpu(?!_torch)", text,
                             re.IGNORECASE), name


def test_datafeed_library_is_built_into_the_repositorys_build_dir():
    """The reader's C++ engine loads from the repository's build/ (named
    by a hash of its source and flags), never from the JAX package's
    cache under ~/.cache/tony_tpu."""
    from tony_tpu_torch.io import native
    if native.load_native() is None:
        pytest.skip("no C++ toolchain (g++) on this host")
    path = os.path.realpath(native.load_native()._name)
    assert path == os.path.realpath(native.library_path())
    assert os.path.dirname(path) == os.path.realpath(
        os.path.join(REPO, "build"))
    assert ".cache" not in path and "_tony_datafeed.so" not in path


def test_train_lm_data_files_without_device_raises_without_a_card(
        monkeypatch, tmp_path):
    from tony_tpu_torch import train_lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tmp_path / "tokens.bin"
    data.write_bytes(bytes(4 * 33 * 8))
    for extra in ([], ["--elastic_data", "4"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_lm.main(["--preset", "tiny", "--steps", "1", "--seq_len",
                           "32", "--data_files", str(data)] + extra)


def test_pipeline_entry_points_raise_without_a_card(monkeypatch):
    """``train_lm --pp_schedule``, ``train_pipeline`` and a
    ``CrossSlicePipeline`` resolve the card as every entry point does."""
    from tony_tpu_torch import train_lm, train_pipeline
    from tony_tpu_torch.channels import open_local_pipeline
    from tony_tpu_torch.parallel.pipeline import CrossSlicePipeline
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.main(["--preset", "tiny", "--steps", "1", "--pp_schedule",
                       "1f1b"])
    links = open_local_pipeline(2, registry=MetricsRegistry())
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CrossSlicePipeline(lambda p, x: x, links[0])
    finally:
        for link in links:
            link.close()
    monkeypatch.setenv("TONY_PIPELINE_STAGE", "0")
    monkeypatch.setenv("TONY_PIPELINE_NUM_STAGES", "2")
    monkeypatch.setenv("TONY_CHANNEL_NEXT", "127.0.0.1:1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_pipeline.main(["--steps", "1"])


def test_serve_lm_without_device_raises_without_a_card(monkeypatch):
    from tony_tpu_torch import serve_lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--preset", "tiny", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--preset", "tiny", "--listen", "127.0.0.1:0"])


class _StubReplica:
    """A model-free TONYS1 replica: HELLO with a role, STATS with an idle
    load — enough for a router to place on it and drain it."""

    def __init__(self, role):
        from tony_tpu_torch.serving import protocol as P
        from tony_tpu_torch.serving.server import FrameServerBase

        class Stub(FrameServerBase):
            def _hello_payload(self):
                return {"v": 1, "role": role, "slots": 2,
                        "channel_port": 1}

            def _handle_frame(self, conn, ftype, rid, payload):
                if ftype == P.STATS:
                    conn.send(P.STATS, 0, P.pack_json(
                        {"queue_depth": 0, "active": 0, "slots": 2}))

            def _on_conn_closed(self, conn):
                pass

        self.server = Stub()
        self.addr = f"127.0.0.1:{self.server.start()}"

    def stop(self):
        self.server._stopping.set()
        self.server._close_listener()
        self.server._close_conns()


def _route(monkeypatch, capsys, flags, roles):
    """``serve_lm --listen --route ...`` over stub replicas: the router
    comes up model-free (no card asked for), answers a client as a
    router, and exits 0 on the signal."""
    import re
    from tony_tpu_torch import serve_lm
    from tony_tpu_torch.serving.client import StreamingClient
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stubs = [_StubReplica(r) for r in roles]
    seen = {}

    def on_signal():
        out = capsys.readouterr().out
        host, port = re.search(r"routing on (\S+):(\d+)", out).groups()
        with StreamingClient(host, int(port)) as c:
            seen.update(hello=c.hello, stats=c.stats())
        seen["out"] = out

    monkeypatch.setattr(serve_lm, "_wait_for_signal", on_signal)
    try:
        argv = ["--listen", "127.0.0.1:0"]
        for flag, n in flags:
            argv += [flag, ",".join(s.addr for s in stubs[n])]
        assert serve_lm.main(argv) == 0
    finally:
        for s in stubs:
            s.stop()
    assert seen["hello"]["router"] is True
    assert set(seen["stats"]["replicas"]) == {s.addr for s in stubs}
    return seen["out"]


def _drain(monkeypatch, capsys):
    """``serve_lm --connect ROUTER --drain REPLICA``: a client operation,
    no model; the router fences the (idle) replica and reports."""
    from tony_tpu_torch import serve_lm
    from tony_tpu_torch.runtime.metrics import MetricsRegistry
    from tony_tpu_torch.serving.router import ServingRouter
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stubs = [_StubReplica("engine") for _ in range(2)]
    router = ServingRouter([s.addr for s in stubs],
                           registry=MetricsRegistry())
    try:
        port = router.start()
        assert serve_lm.main(["--connect", f"127.0.0.1:{port}", "--drain",
                              stubs[0].addr]) == 0
        assert router.stats()["replicas"][stubs[0].addr]["draining"]
    finally:
        router.stop()
        for s in stubs:
            s.stop()
    out = capsys.readouterr().out
    assert f"drain {stubs[0].addr}: " in out and "'drained': True" in out


@pytest.mark.parametrize("flag", ["role-prefill", "role-decode",
                                  "disaggregate", "route",
                                  "route-route_decode", "drain"])
def test_serve_lm_fleet_flags(flag, monkeypatch, capsys):
    """The fleet flags of the JAX script: the model roles resolve the
    device as every entry point does (no card and no ``--device cpu``:
    they raise), the router and the drain load no model and touch no
    device."""
    from tony_tpu_torch import serve_lm
    if flag in ("role-prefill", "role-decode", "disaggregate"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        argv = (["--disaggregate"] if flag == "disaggregate" else
                ["--role", flag.split("-")[1], "--listen", "127.0.0.1:0"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_lm.main(["--preset", "tiny"] + argv)
    elif flag == "route":
        out = _route(monkeypatch, capsys, [("--route", slice(0, 2))],
                     ["engine", "engine"])
        assert "over 2 replicas" in out
    elif flag == "route-route_decode":
        out = _route(monkeypatch, capsys, [("--route", slice(0, 1)),
                                           ("--route_decode", slice(1, 2))],
                     ["prefill", "decode"])
        assert "over 1 prefill + 1 decode replicas" in out
    else:
        _drain(monkeypatch, capsys)


def test_generate_and_draft_without_device_raise_without_a_card(
        monkeypatch):
    from tony_tpu_torch import generate, serve_lm
    from tony_tpu_torch.models import transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--max_new_tokens", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--beam_width", "2", "--max_new_tokens", "2"])
    cfg = transformer.PRESETS["small"].scaled(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.build_draft("tiny", cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--preset", "tiny", "--quantize_weights",
                       "--kv_cache_dtype", "int8"])


def test_serve_lm_runs_on_the_cpu_when_asked(capsys):
    from tony_tpu_torch import serve_lm
    assert serve_lm.main(["--preset", "tiny", "--requests", "3",
                          "--slots", "2", "--prompt_len", "6",
                          "--max_new_tokens", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "slot-step utilization" in out


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
