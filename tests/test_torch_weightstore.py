"""tony_tpu_torch's weights lane against the JAX package's.

``tiny`` with the JAX weights converted to torch. Covered:

- ``pack_weights``: one tree packs to the same bytes in either package,
  f32, bf16 (torch tensors here, ``ml_dtypes`` arrays there) and int8
  on the wire; each package lands the other's artifact with the
  seeder's ``tree_digest``; a flipped byte, a foreign artifact part or a
  gapped tree is refused (``ProtocolError``), and the store keeps only
  digest-verified artifacts;
- ``pull_weights`` across the packages over a real weights lane: a JAX
  replica seeds the port and the port seeds JAX, the landed tree's
  digest equal to the seeder's, and the port's pulled params serve the
  seeder's tokens;
- the WEIGHTS ops (list, resident, publish, an unknown op) on the port's
  server;
- ``serve_lm --listen --warm_from`` as a process: it advertises the
  seeder's digest and streams the seeder's tokens; a failed pull falls
  back to the storage load and says so.
"""

import os
import re
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tony_tpu.models import serve as JS
from tony_tpu.models import transformer as JT
from tony_tpu.serving import server as JSRV
from tony_tpu.serving import weightstore as JW
from tony_tpu_torch import serve_lm
from tony_tpu_torch.models import serve as TS
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy
from tony_tpu_torch.runtime import metrics as M
from tony_tpu_torch.serving import blobcodec
from tony_tpu_torch.serving import weightstore as W
from tony_tpu_torch.serving.client import StreamingClient
from tony_tpu_torch.serving.protocol import ProtocolError
from tony_tpu_torch.serving.server import ServingServer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False)
TCFG = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arm", ["f32", "bf16", "int8-wire"])
def test_pack_weights_byte_identical_between_packages(params, arm):
    jp, tp = params
    if arm == "bf16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tp = params_from_numpy(jax.device_get(jp), device="cpu")
        assert tp["embed"].dtype == torch.bfloat16
    quant = arm == "int8-wire"
    jblob = JW.pack_weights(_host(jp), version="v7", quantize=quant)
    tblob = W.pack_weights(tp, version="v7", quantize=quant)
    assert jblob == tblob
    jmeta, jtree = JW.unpack_weights(tblob)
    tmeta, ttree = W.unpack_weights(jblob)
    assert tmeta == jmeta and tmeta["version"] == "v7"
    assert tmeta["quantized"] is quant
    assert tmeta["digest"] == W.tree_digest(ttree) == JW.tree_digest(jtree)
    if not quant:
        assert tmeta["digest"] == W.tree_digest(tp) == JW.tree_digest(
            _host(jp))
    emb = ttree["embed"]
    if arm == "bf16":
        assert emb.dtype == torch.bfloat16
        assert jtree["embed"].dtype == ml_dtypes.bfloat16
    # the landed tree becomes the port's params, digest unchanged
    back = params_from_numpy(ttree, device="cpu")
    assert W.tree_digest(back) == tmeta["digest"]
    assert W.peek_weights_meta(tblob) == tmeta


def test_corrupt_and_foreign_artifacts_are_refused(params):
    _, tp = params
    blob = bytearray(W.pack_weights(tp))
    blob[-5] ^= 0x40
    with pytest.raises(ProtocolError, match="REFUSED"):
        W.unpack_weights(bytes(blob))
    store = W.WeightStore(M.MetricsRegistry())
    with pytest.raises(ProtocolError):
        store.put(bytes(blob))
    cc = blobcodec.WEIGHTS.pack({"part": "compile_cache",
                                 "digest": "0" * 64}, {})
    with pytest.raises(ProtocolError, match="not ported"):
        store.put(cc)
    with pytest.raises(ProtocolError, match="not a weight"):
        W.unpack_weights(cc)
    with pytest.raises(ProtocolError, match="gapped"):
        W.unflatten_tree({"a/#0": 1, "a/#2": 2})
    good = W.pack_weights(tp)
    digest = store.put(good)
    assert store.resident_digests() == [digest] == store.digests()
    assert store.get(digest) == good
    with pytest.raises(ValueError, match="not resident"):
        store.get("f" * 64)


def _serve_tokens(addr_port, prompts):
    with StreamingClient("127.0.0.1", addr_port) as c:
        rids = [c.submit(p, 5) for p in prompts]
        return [c.result(r)[0] for r in rids]


@pytest.mark.parametrize("seeder", ["jax", "port"])
def test_pull_weights_between_packages(params, seeder):
    """A replica of one package seeds the other's pull over the weights
    lane; the landed tree digests as the seeder advertises, and (a port
    pull) serves the seeder's tokens."""
    jp, tp = params
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    if seeder == "jax":
        srv = JSRV.ServingServer(JS.ContinuousBatcher(jp, JCFG, batch=2,
                                                      max_len=32))
    else:
        srv = ServingServer(TS.ContinuousBatcher(tp, TCFG, batch=2,
                                                 max_len=32),
                            registry=M.MetricsRegistry())
    try:
        port = srv.start()
        addr = f"127.0.0.1:{port}"
        with StreamingClient("127.0.0.1", port) as c:
            advertised = c.hello["weights_digest"]
            assert c.hello["weights_resident"] == []
        assert advertised == W.tree_digest(tp)
        if seeder == "jax":
            meta, tree = W.pull_weights(addr, timeout_s=60)
            assert W.tree_digest(tree) == advertised
            pulled = params_from_numpy(tree, device="cpu")
            assert W.tree_digest(pulled) == advertised
            b = TS.ContinuousBatcher(pulled, TCFG, batch=2, max_len=32)
            assert b.serve(prompts, 5) == _serve_tokens(port, prompts)
        else:
            meta, tree = JW.pull_weights(addr, timeout_s=60)
            assert JW.tree_digest(tree) == advertised
        assert meta["digest"] == advertised
        # the seeder's export is resident now; the ops say so
        listed = W.weights_rpc(addr, {"op": "resident"})
        assert listed["ok"] and listed["resident"] == [advertised]
        bad = W.weights_rpc(addr, {"op": "frobnicate"})
        assert not bad["ok"] and "unknown weights op" in bad["error"]
        bad = W.weights_rpc(addr, {"op": "publish", "digest": "0" * 64,
                                   "target": "127.0.0.1:1"})
        assert not bad["ok"]
    finally:
        srv.kill()


def test_pull_of_an_artifact_larger_than_the_lane_window(params,
                                                        monkeypatch):
    """An artifact of more chunks than the puller's hub holds plus the
    seeder's send window (here 64 KiB chunks of the 3 MB tiny tree)
    lands: the port's pull consumes while the seeder publishes. The
    JAX package's pull waits for the publish to finish first and times
    out on the same artifact (ROADMAP queue 3)."""
    _, tp = params
    monkeypatch.setattr(W, "CHUNK_BYTES_DEFAULT", 1 << 16)
    srv = ServingServer(TS.ContinuousBatcher(tp, TCFG, batch=1,
                                             max_len=16),
                        registry=M.MetricsRegistry())
    try:
        addr = f"127.0.0.1:{srv.start()}"
        meta, tree = W.pull_weights(addr, timeout_s=30)
        assert meta["digest"] == W.tree_digest(tree) == srv.weights_digest
        blob = srv.weight_store.get(meta["digest"])
        assert len(blob) > 12 * (1 << 16)
        with pytest.raises(OSError):        # ChannelError or a timeout
            JW.pull_weights(addr, timeout_s=3)
    finally:
        srv.kill()


def test_warm_boot_falls_back_when_the_pull_fails(capsys):
    import socket
    with socket.socket() as s:       # a port nobody serves
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    assert serve_lm.warm_boot(f"127.0.0.1:{dead}", "cpu") is None
    assert "falling back to a storage load" in capsys.readouterr().out


def test_serve_lm_warm_from_process(params):
    """``serve_lm --listen --warm_from A`` boots from A's weights lane:
    its HELLO carries A's digest and it streams A's tokens, though its
    own seed-0 build would give other weights (A serves seed 7's)."""
    _, tp = params
    cfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)
    seeded = TT.init_params(torch.Generator().manual_seed(7), cfg,
                            device="cpu")
    srv = ServingServer(TS.ContinuousBatcher(seeded, cfg, batch=2,
                                             max_len=32),
                        registry=M.MetricsRegistry())
    proc = None
    try:
        aport = srv.start()
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
        proc = subprocess.Popen(
            [sys.executable, "-m", "tony_tpu_torch.serve_lm", "--device",
             "cpu", "--preset", "tiny", "--slots", "2", "--prompt_len",
             "16", "--max_new_tokens", "16", "--listen", "127.0.0.1:0",
             "--warm_from", f"127.0.0.1:{aport}"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines, cport = [], None
        while cport is None:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            m = re.search(r"serving tiny \(greedy\) on 127\.0\.0\.1:(\d+)",
                          line)
            cport = int(m.group(1)) if m else None
        assert any("warm boot: pulled weights" in x for x in lines), lines
        with StreamingClient("127.0.0.1", cport) as c:
            assert c.hello["weights_digest"] == srv.weights_digest
        assert srv.weights_digest != W.tree_digest(
            serve_lm.build("tiny", "cpu")[1])
        prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5]]
        assert _serve_tokens(cport, prompts) == _serve_tokens(aport, prompts)
    finally:
        if proc is not None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
        srv.kill()
