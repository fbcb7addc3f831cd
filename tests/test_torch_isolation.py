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
    assert "tony_tpu_torch.models.serve" in rep["modules"]
    assert "tony_tpu_torch.ops.attention" in rep["modules"]
    bad = [m for m in rep["new"]
           if m == "jax" or m.startswith(("jax.", "jaxlib", "ml_dtypes"))
           or m == "tony_tpu" or m.startswith("tony_tpu.")]
    assert bad == []


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
    from tony_tpu_torch.models import decode, transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = transformer.PRESETS["tiny"].scaled(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.init_kv_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tony_tpu_torch.resolve_device("cuda")
    assert tony_tpu_torch.resolve_device("cpu").type == "cpu"


def test_serve_lm_without_device_raises_without_a_card(monkeypatch):
    from tony_tpu_torch import serve_lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--preset", "tiny", "--requests", "1"])


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
