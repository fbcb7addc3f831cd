"""tony_tpu_torch's cross-slice pipeline: the stage links of
``channels/registry.py`` and ``CrossSlicePipeline`` over TONYC1, against
the port's in-slice 1F1B and the JAX package's.

- Registry parity with ``tests/test_channels.py::TestChannelRegistry``:
  the lanes a stage opens (names, ends, the ring interleave closes),
  ``stage_env`` parsing interleave and codec, the spec decoder, and the
  refusals; both packages' lane names equal.
- The port's ``CrossSlicePipeline`` over ``open_local_pipeline`` (each
  gang a thread) is bit-identical to its in-slice
  ``pipeline_value_and_grad`` (``TestCrossSliceBitIdentity`` of the
  reference), with ``lookahead``, ``sync_transport``, and v = 2 chunks a
  gang at 4 virtual stages over a 3-step training run
  (``TestInterleavedBitIdentity``).
- Its loss and grads against the JAX package's ``CrossSlicePipeline`` on
  the same params (loss rtol 1e-5, grads atol 3e-5).
- A mixed pipeline: a JAX stage 0 and a port stage 1, each on its own
  TONYC1 hub, in one process: the loss equals the all-JAX run's within
  rtol 1e-5 (the stage wire is the same).
- The deterministic per-step trace and span ids: the stage spans share
  one trace id, parented on the step's root span, the microbatch spans
  carry the hop's channel seq on both ends, and the ids equal the JAX
  package's for the same job trace and call (``tests/test_tracing.py``'s
  ``TestPipelineTracing``).
- Under the orchestrator: ``python -m tony_tpu_torch.train_pipeline``
  as two stage gangs on the local backend, whose losses and params equal
  the port's in-slice 1F1B bit for bit (``tests/test_e2e.py``'s
  ``test_pipeline_job_bit_identical_to_in_slice``).
"""

import os
import socket
import sys
import threading

import numpy as np
import pytest
import torch

from tony_tpu_torch.channels import registry as R
from tony_tpu_torch.parallel import pipeline as P
from tony_tpu_torch.runtime import tracing as TRC
from tony_tpu_torch.runtime.metrics import MetricsRegistry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, MB, NM = 8, 4, 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
class TestStageLinks:
    def test_lane_names_equal_the_jax_package(self):
        from tony_tpu.channels import registry as JR
        assert (R.ACT_CHANNEL, R.GRAD_CHANNEL) == (JR.ACT_CHANNEL,
                                                   JR.GRAD_CHANNEL)
        for j in range(3):
            assert R.act_channel(j) == JR.act_channel(j)
            assert R.grad_channel(j) == JR.grad_channel(j)
        assert R.grad_channel(0) != R.grad_channel(1)

    def test_two_stage_wiring(self):
        links = R.open_local_pipeline(2, registry=MetricsRegistry())
        try:
            first, last = links
            assert first.is_first and not first.is_last
            assert last.is_last and not last.is_first
            assert first.act_in is None and first.grad_out is None
            assert last.act_out is None and last.grad_in is None
            assert first.act_out.channel == "act"
            assert last.grad_out.channel == "grad"
            assert first.act_out.address[1] == last.hub.port
            assert last.grad_out.address[1] == first.hub.port
        finally:
            for link in links:
                link.close()

    def test_three_stages_pair_neighbours(self):
        links = R.open_local_pipeline(3, registry=MetricsRegistry())
        try:
            mid = links[1]
            assert mid.act_out.address[1] == links[2].hub.port
            assert mid.grad_out.address[1] == links[0].hub.port
            assert mid.act_in is not None and mid.grad_in is not None
        finally:
            for link in links:
                link.close()

    def test_interleave_closes_the_ring(self):
        """With v = 2 chunks a gang every chunk boundary crosses gangs:
        the boundary gangs get neighbours too, the lanes named by the
        consuming chunk, the model's ends open."""
        links = R.open_local_pipeline(2, interleave=2,
                                      registry=MetricsRegistry())
        try:
            g0, g1 = links
            assert g0.num_virtual == 4 and g1.global_stage(1) == 3
            # gang 1's chunk 0 (virtual 1) feeds gang 0's chunk 1
            assert g1.act_outs[0].channel == "act.1"
            assert g1.act_outs[0].address[1] == g0.hub.port
            # gang 0's chunk 1 (virtual 2) sends its cotangent to gang
            # 1's chunk 0
            assert g0.grad_outs[1].channel == "grad"
            assert g0.grad_outs[1].address[1] == g1.hub.port
            assert g0.act_ins[0] is None and g1.grad_ins[1] is None
            assert g1.act_outs[1] is None and g0.grad_outs[0] is None
        finally:
            for link in links:
                link.close()

    def test_stage_env_parses_interleave_and_codec(self):
        env = {"TONY_PIPELINE_STAGE": "1",
               "TONY_PIPELINE_NUM_STAGES": "2",
               "TONY_CHANNEL_PREV": "h0:1", "TONY_CHANNEL_NEXT": "h0:2",
               "TONY_PIPELINE_INTERLEAVE": "2",
               "TONY_CHANNEL_COMPRESSION": "int8",
               "TONY_CHANNEL_PORT": "4321"}
        from tony_tpu.channels import stage_env as jax_stage_env
        parsed = R.stage_env(env)
        assert parsed == jax_stage_env(env)
        assert parsed["interleave"] == 2
        assert parsed["compression"] == "int8"
        assert parsed["hub_port"] == 4321
        env.pop("TONY_PIPELINE_INTERLEAVE")
        env.pop("TONY_CHANNEL_COMPRESSION")
        parsed = R.stage_env(env)
        assert parsed["interleave"] == 1
        assert parsed["compression"] == "none"
        assert R.stage_env({}) is None

    def test_channel_spec_decoding(self):
        spec = '{"stage": 1, "num_stages": 2, "prev": "h:1", "next": ""}'
        assert R.parse_channel_spec(spec)["stage"] == 1
        assert R.parse_channel_spec("") is None
        assert R.parse_channel_spec("{not json") is None
        assert R.parse_channel_spec('{"rank": 0}') is None

    def test_open_stage_links_refuses_missing_neighbours(self):
        with pytest.raises(ValueError, match="outside"):
            R.open_stage_links(stage=2, num_stages=2)
        with pytest.raises(ValueError, match="upstream"):
            R.open_stage_links(stage=1, num_stages=2)
        with pytest.raises(ValueError, match="downstream"):
            R.open_stage_links(stage=0, num_stages=2)
        with pytest.raises(ValueError, match="interleave"):
            R.open_stage_links(stage=0, num_stages=2, next="h:1",
                               interleave=0)

    def test_links_from_env_bind_the_reserved_port(self):
        port = _free_port()
        links = R.open_stage_links_from_env(
            {"TONY_PIPELINE_STAGE": "0", "TONY_PIPELINE_NUM_STAGES": "2",
             "TONY_CHANNEL_NEXT": "127.0.0.1:1",
             "TONY_CHANNEL_PORT": str(port)}, registry=MetricsRegistry())
        try:
            assert links.hub.port == port and links.stage == 0
        finally:
            links.close()
        assert R.open_stage_links_from_env({}) is None


# ---------------------------------------------------------------------------
# cross-slice == in-slice, bit for bit
# ---------------------------------------------------------------------------
def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _head(hp, out, tgt):
    return torch.mean((out @ hp["wo"] - tgt) ** 2)


def _model():
    rs = np.random.RandomState(0)
    stacked = {"w": rs.randn(2, DIM, DIM).astype(np.float32) * 0.3,
               "b": rs.randn(2, DIM).astype(np.float32) * 0.1}
    head = {"wo": rs.randn(DIM, DIM).astype(np.float32) * 0.2}
    x = rs.randn(NM * MB, DIM).astype(np.float32)
    tgt = rs.randn(NM * MB, DIM).astype(np.float32)
    return stacked, head, x, tgt


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _run_gangs(run, n):
    """``run(stage)`` in one thread a gang; returns {stage: result}."""
    out, failures = {}, []

    def main(s):
        try:
            out[s] = run(s)
        except BaseException as exc:
            failures.append(exc)

    threads = [threading.Thread(target=main, args=(s,)) for s in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    if failures:
        raise failures[0]
    assert len(out) == n, "a gang thread did not finish"
    return out


def _cross_slice(stacked, head, x, tgt, **kw):
    links = R.open_local_pipeline(2, registry=MetricsRegistry())
    xs = torch.tensor(x).reshape(NM, MB, DIM)
    tgts = torch.tensor(tgt).reshape(NM, MB, DIM)

    def run(s):
        pipe = P.CrossSlicePipeline(_stage, links[s],
                                    loss_head=_head if s == 1 else None,
                                    registry=MetricsRegistry(),
                                    device="cpu", **kw)
        try:
            return pipe.value_and_grad(
                {k: torch.tensor(v[s]) for k, v in stacked.items()},
                num_microbatches=NM, microbatches=xs if s == 0 else None,
                head_params=_t(head) if s == 1 else None,
                head_batches=tgts if s == 1 else None)
        finally:
            pipe.close()

    try:
        return _run_gangs(run, 2)
    finally:
        for link in links:
            link.close()


class TestCrossSliceBitIdentity:
    pytestmark = pytest.mark.exact

    def test_loss_and_grads_bit_identical_to_in_slice(self):
        stacked, head, x, tgt = _model()
        loss, g, hg, dx = P.pipeline_value_and_grad(
            _stage, _t(stacked), torch.tensor(x), _t(head),
            torch.tensor(tgt), {"pp": 2}, loss_head=_head,
            num_microbatches=NM)
        out = _cross_slice(stacked, head, x, tgt)
        assert torch.equal(out[1][0], loss), (float(out[1][0]), float(loss))
        for s in (0, 1):
            for k in ("w", "b"):
                assert torch.equal(out[s][1][k], g[k][s]), (s, k)
        assert torch.equal(out[1][2]["wo"], hg["wo"])
        assert torch.equal(out[0][3].reshape(dx.shape), dx)

    def test_lookahead_and_sync_do_not_change_math(self):
        stacked, head, x, tgt = _model()
        base = _cross_slice(stacked, head, x, tgt)
        for kw in ({"lookahead": 3}, {"sync_transport": True}):
            other = _cross_slice(stacked, head, x, tgt, **kw)
            assert torch.equal(base[1][0], other[1][0]), kw
            for s in (0, 1):
                for k in ("w", "b"):
                    assert torch.equal(base[s][1][k], other[s][1][k]), kw

    def test_bf16_activations_cross_as_bfloat16(self):
        """A bf16 stage ships ``torch.bfloat16`` tensors (the JAX
        package's 16-bit payload) and stays bitwise the in-slice 1F1B."""
        stacked, head, x, tgt = _model()
        bf = torch.bfloat16
        sp = {k: torch.tensor(v).to(bf) for k, v in stacked.items()}
        hp = {"wo": torch.tensor(head["wo"]).to(bf)}
        xb, tb = torch.tensor(x).to(bf), torch.tensor(tgt).to(bf)

        def head_fn(hp, out, t):
            return torch.mean((out @ hp["wo"] - t).float() ** 2)

        loss, g, hg, dx = P.pipeline_value_and_grad(
            _stage, sp, xb, hp, tb, {"pp": 2}, loss_head=head_fn,
            num_microbatches=NM)
        links = R.open_local_pipeline(2, registry=MetricsRegistry())

        def run(s):
            pipe = P.CrossSlicePipeline(_stage, links[s],
                                        loss_head=head_fn if s else None,
                                        registry=MetricsRegistry(),
                                        device="cpu")
            try:
                return pipe.value_and_grad(
                    {k: v[s] for k, v in sp.items()}, num_microbatches=NM,
                    microbatches=xb.reshape(NM, MB, DIM) if s == 0
                    else None, head_params=hp if s else None,
                    head_batches=tb.reshape(NM, MB, DIM) if s else None)
            finally:
                pipe.close()

        try:
            out = _run_gangs(run, 2)
        finally:
            for link in links:
                link.close()
        assert torch.equal(out[1][0], loss)
        assert out[0][1]["w"].dtype == bf
        for s in (0, 1):
            assert torch.equal(out[s][1]["w"], g["w"][s]), s
        assert torch.equal(out[0][3].reshape(dx.shape), dx)

    def test_matches_the_jax_cross_slice_pipeline(self):
        import jax.numpy as jnp

        from tony_tpu.channels import open_local_pipeline as jax_links
        from tony_tpu.parallel.pipeline import CrossSlicePipeline as JCS
        from tony_tpu.runtime.metrics import MetricsRegistry as JReg
        stacked, head, x, tgt = _model()
        links = jax_links(2, registry=JReg())

        def run(s):
            pipe = JCS(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), links[s],
                       loss_head=(lambda hp, o, t: jnp.mean(
                           (o @ hp["wo"] - t) ** 2)) if s == 1 else None,
                       registry=JReg())
            return pipe.value_and_grad(
                {k: jnp.asarray(v[s]) for k, v in stacked.items()},
                num_microbatches=NM,
                microbatches=jnp.asarray(x.reshape(NM, MB, DIM))
                if s == 0 else None,
                head_params={"wo": jnp.asarray(head["wo"])}
                if s == 1 else None,
                head_batches=jnp.asarray(tgt.reshape(NM, MB, DIM))
                if s == 1 else None)

        try:
            want = _run_gangs(run, 2)
        finally:
            for link in links:
                link.close()
        got = _cross_slice(stacked, head, x, tgt)
        np.testing.assert_allclose(float(got[1][0]), float(want[1][0]),
                                   rtol=1e-5)
        for s in (0, 1):
            for k in ("w", "b"):
                np.testing.assert_allclose(got[s][1][k].numpy(),
                                           np.asarray(want[s][1][k]),
                                           atol=3e-5)
        np.testing.assert_allclose(got[1][2]["wo"].numpy(),
                                   np.asarray(want[1][2]["wo"]), atol=3e-5)
        np.testing.assert_allclose(got[0][3].numpy(),
                                   np.asarray(want[0][3]), atol=3e-5)


# ---------------------------------------------------------------------------
# interleaved 1F1B: a training run, bit for bit
# ---------------------------------------------------------------------------
_LR = 0.1


def _block(g):
    rs = np.random.RandomState(100 + g)
    return {"w": rs.randn(DIM, DIM).astype(np.float32) * 0.3,
            "b": rs.randn(DIM).astype(np.float32) * 0.1}


def _h_head():
    rs = np.random.RandomState(999)
    return {"wo": rs.randn(DIM, DIM).astype(np.float32) * 0.2}


def _h_batch(step):
    rs = np.random.RandomState(5000 + step)
    return (torch.tensor(rs.randn(NM, MB, DIM).astype(np.float32)),
            torch.tensor(rs.randn(NM, MB, DIM).astype(np.float32)))


def _sgd(p, g):
    return {k: v - _LR * g[k] for k, v in p.items()}


def _train_cross_slice(steps, S=2, v=1):
    links = R.open_local_pipeline(S, interleave=v,
                                  registry=MetricsRegistry())

    def run(s):
        pipe = P.CrossSlicePipeline(_stage, links[s],
                                    loss_head=_head if s == S - 1 else None,
                                    registry=MetricsRegistry(),
                                    device="cpu")
        params = (_t(_block(s)) if v == 1
                  else [_t(_block(j * S + s)) for j in range(v)])
        head = _t(_h_head()) if s == S - 1 else None
        losses = []
        try:
            for step in range(steps):
                x, tgt = _h_batch(step)
                loss, grads, hgrads, _ = pipe.value_and_grad(
                    params, num_microbatches=NM,
                    microbatches=x if s == 0 else None, head_params=head,
                    head_batches=tgt if s == S - 1 else None)
                params = (_sgd(params, grads) if v == 1 else
                          [_sgd(p, g) for p, g in zip(params, grads)])
                if s == S - 1:
                    head = _sgd(head, hgrads)
                    losses.append(loss)
        finally:
            pipe.close()
        return params, head, losses

    try:
        out = _run_gangs(run, S)
    finally:
        for link in links:
            link.close()
    by_virtual = {}
    for s in range(S):
        chunks = [out[s][0]] if v == 1 else out[s][0]
        for j, chunk in enumerate(chunks):
            by_virtual[j * S + s] = chunk
    return out[S - 1][2], by_virtual, out[S - 1][1]


def _train_in_slice(steps, V):
    blocks = [_block(g) for g in range(V)]
    stacked = {k: torch.tensor(np.stack([b[k] for b in blocks]))
               for k in ("w", "b")}
    head = _t(_h_head())
    losses = []
    for step in range(steps):
        x, tgt = _h_batch(step)
        loss, g, hg, _ = P.pipeline_value_and_grad(
            _stage, stacked, x.reshape(-1, DIM), head, tgt.reshape(-1, DIM),
            {"pp": V}, loss_head=_head, num_microbatches=NM)
        stacked = _sgd(stacked, g)
        head = _sgd(head, hg)
        losses.append(loss)
    return losses, {g: {k: v[g] for k, v in stacked.items()}
                    for g in range(V)}, head


class TestInterleavedBitIdentity:
    pytestmark = pytest.mark.exact
    STEPS = 3

    @pytest.mark.parametrize("v", [1, 2])
    def test_training_bit_identical_to_in_slice(self, v):
        losses, by_virtual, head = _train_cross_slice(self.STEPS, v=v)
        ref_losses, ref_virtual, ref_head = _train_in_slice(self.STEPS,
                                                            2 * v)
        for a, b in zip(losses, ref_losses):
            assert torch.equal(a, b), (float(a), float(b))
        for g, chunk in ref_virtual.items():
            for k in chunk:
                assert torch.equal(by_virtual[g][k], chunk[k]), (g, k)
        assert torch.equal(head["wo"], ref_head["wo"])


# ---------------------------------------------------------------------------
# one wire: a JAX stage and a port stage in one pipeline
# ---------------------------------------------------------------------------
def test_mixed_jax_and_port_stages_share_the_wire():
    import jax.numpy as jnp

    from tony_tpu.channels import open_local_pipeline as jax_links
    from tony_tpu.channels import open_stage_links as jax_open
    from tony_tpu.parallel.pipeline import CrossSlicePipeline as JCS
    from tony_tpu.runtime.metrics import MetricsRegistry as JReg
    stacked, head, x, tgt = _model()

    def jstage(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def jhead(hp, o, t):
        return jnp.mean((o @ hp["wo"] - t) ** 2)

    xs = jnp.asarray(x.reshape(NM, MB, DIM))
    tg = tgt.reshape(NM, MB, DIM)

    def jax_stage0(link):
        return JCS(jstage, link, registry=JReg()).value_and_grad(
            {k: jnp.asarray(v[0]) for k, v in stacked.items()},
            num_microbatches=NM, microbatches=xs)

    # the all-JAX run
    links = jax_links(2, registry=JReg())
    try:
        want = _run_gangs(lambda s: jax_stage0(links[0]) if s == 0 else
                          JCS(jstage, links[1], loss_head=jhead,
                              registry=JReg()).value_and_grad(
                              {k: jnp.asarray(v[1])
                               for k, v in stacked.items()},
                              num_microbatches=NM,
                              head_params={"wo": jnp.asarray(head["wo"])},
                              head_batches=jnp.asarray(tg)), 2)
    finally:
        for link in links:
            link.close()
    # a JAX stage 0 on a JAX hub, a port stage 1 on a port hub
    p0, p1 = _free_port(), _free_port()
    j0 = jax_open(stage=0, num_stages=2, next=f"127.0.0.1:{p1}",
                  hub_port=p0, registry=JReg())
    t1 = R.open_stage_links(stage=1, num_stages=2, prev=f"127.0.0.1:{p0}",
                            hub_port=p1, registry=MetricsRegistry())

    def port_stage1():
        pipe = P.CrossSlicePipeline(_stage, t1, loss_head=_head,
                                    registry=MetricsRegistry(),
                                    device="cpu")
        try:
            return pipe.value_and_grad(
                {k: torch.tensor(v[1]) for k, v in stacked.items()},
                num_microbatches=NM, head_params=_t(head),
                head_batches=torch.tensor(tg))
        finally:
            pipe.close()

    try:
        got = _run_gangs(lambda s: jax_stage0(j0) if s == 0
                         else port_stage1(), 2)
    finally:
        j0.close()
        t1.close()
    np.testing.assert_allclose(float(got[1][0]), float(want[1][0]),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got[0][1]["w"]),
                               np.asarray(want[0][1]["w"]), atol=3e-5)


# ---------------------------------------------------------------------------
# deterministic trace ids
# ---------------------------------------------------------------------------
def test_stage_spans_share_deterministic_trace_id(monkeypatch):
    from tony_tpu.runtime import tracing as JTRC
    monkeypatch.setenv("TONY_TRACE_CTX", f"{'ab' * 16}:{'cd' * 8}")
    monkeypatch.setenv("SESSION_ID", "7")
    tracer = TRC.Tracer(proc="test:0", sample_rate=1.0, ring_size=256)
    saved = TRC.set_tracer(tracer)
    try:
        stacked, head, x, tgt = _model()
        _cross_slice(stacked, head, x, tgt)
    finally:
        TRC.set_tracer(saved)
    spans = tracer.drain(10_000)
    stage_spans = [s for s in spans if s["n"] == "pipeline.stage"]
    assert {s["a"]["stage"] for s in stage_spans} == {0, 1}
    tids = {s["tid"] for s in stage_spans}
    assert len(tids) == 1, tids
    (tid,) = tids
    # the id every gang, JAX or port, derives for call 1 of this job
    seed = f"{'ab' * 16}:7:0:step:1"
    assert tid == TRC.deterministic_trace_id(seed) \
        == JTRC.deterministic_trace_id(seed)
    root_sid = TRC.deterministic_span_id(f"{tid}:root")
    assert root_sid == JTRC.deterministic_span_id(f"{tid}:root")
    assert all(s["pid"] == root_sid for s in stage_spans)
    for s in stage_spans:
        assert s["sid"] == JTRC.deterministic_span_id(
            f"{tid}:s{s['a']['stage']}")
    roots = [s for s in spans if s["n"] == "pipeline.step"]
    assert len(roots) == 1 and roots[0]["sid"] == root_sid
    fwd = [s for s in spans if s["n"] == "pipeline.forward"]
    f0 = {s["a"]["mb"]: s["a"]["seq"] for s in fwd if s["a"]["stage"] == 0}
    f1 = {s["a"]["mb"]: s["a"]["seq"] for s in fwd if s["a"]["stage"] == 1}
    assert f0 and f0 == f1


def test_metrics_bubble_and_microbatches():
    reg = MetricsRegistry()
    links = R.open_local_pipeline(2, registry=reg)
    stacked, head, x, tgt = _model()
    pipes = [P.CrossSlicePipeline(_stage, links[s],
                                  loss_head=_head if s else None,
                                  registry=reg, device="cpu")
             for s in range(2)]
    xs = torch.tensor(x).reshape(NM, MB, DIM)
    try:
        _run_gangs(lambda s: pipes[s].value_and_grad(
            {k: torch.tensor(v[s]) for k, v in stacked.items()},
            num_microbatches=NM, microbatches=xs if s == 0 else None,
            head_params=_t(head) if s else None,
            head_batches=torch.tensor(tgt).reshape(NM, MB, DIM)
            if s else None), 2)
    finally:
        for p in pipes:
            p.close()
        for link in links:
            link.close()
    for s in (0, 1):
        stage = str(s)
        assert reg.counter("tony_pipeline_microbatches_total",
                           stage=stage).value == NM
        assert reg.histogram("tony_pipeline_step_seconds",
                             stage=stage).count == 1
        bubble = reg.gauge("tony_pipeline_bubble_fraction",
                           stage=stage).value
        assert bubble == pipes[s].last_step["bubble"]
        assert 0.0 <= bubble < 1.0
        assert pipes[s].last_step["busy_s"] <= pipes[s].last_step["wall_s"]


# ---------------------------------------------------------------------------
# under the orchestrator
# ---------------------------------------------------------------------------
def _in_slice_reference(mod, steps, m, mb, dim):
    stacked = {k: torch.stack([mod.init_stage_params(s, dim)[k]
                               for s in (0, 1)]) for k in ("w", "b")}
    head = mod.init_head_params(dim)
    losses = []
    for step in range(steps):
        x, tgt = mod.batch_for(step, m, mb, dim)
        loss, g, hg, _ = P.pipeline_value_and_grad(
            mod.stage_fn, stacked, torch.tensor(x.reshape(m * mb, dim)),
            head, torch.tensor(tgt.reshape(m * mb, dim)), {"pp": 2},
            loss_head=mod.loss_head, num_microbatches=m)
        stacked = mod.sgd(stacked, g, 0.1)
        head = mod.sgd(head, hg, 0.1)
        losses.append(float(loss))
    return stacked, head, losses


def test_train_pipeline_job_bit_identical_to_in_slice(tmp_path):
    """Two stage gangs of ``python -m tony_tpu_torch.train_pipeline`` on
    the local backend (the coordinator's channel registry wires them):
    stage 1's losses and both stages' params equal the in-slice 1F1B on
    the same params and batches, bit for bit."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_e2e import _executor_launcher, _killed_from_outside

    from tony_tpu.client.client import TonyClient
    from tony_tpu.conf.config import TonyConfig
    from tony_tpu_torch import train_pipeline as mod
    steps, m, mb, dim = 3, 4, 4, 8
    out = tmp_path / "pipe"
    prog = (f"{sys.executable} -m tony_tpu_torch.train_pipeline --device "
            f"cpu --steps {steps} --microbatches {m} --mb_rows {mb} --dim "
            f"{dim} --lr 0.1 --out {out}")
    conf = {
        "tony.history.location": str(tmp_path / "tony-history"),
        "tony.application.timeout": "150000",
        "tony.stage0.instances": "1",
        "tony.stage1.instances": "1",
        "tony.pipeline.stages": "stage0,stage1",
        "tony.stage0.program": prog,
        "tony.stage1.program": prog,
        "tony.application.python-binary-path": _executor_launcher(tmp_path),
    }
    for attempt in range(4):
        conf["tony.staging.dir"] = str(tmp_path / f"staging{attempt}")
        client = TonyClient(TonyConfig(conf),
                            f"{sys.executable} -c 'raise SystemExit(7)'",
                            shell_env={"PYTHONPATH": REPO,
                                       "OMP_NUM_THREADS": "2"})
        rc = client.run()
        if rc == 0 or not _killed_from_outside(client.job_dir):
            break
    assert rc == 0
    ref_stacked, ref_head, ref_losses = _in_slice_reference(mod, steps, m,
                                                            mb, dim)
    got1 = np.load(f"{out}-stage1.npz")
    got0 = np.load(f"{out}-stage0.npz")
    assert np.array_equal(got1["losses"],
                          np.asarray(ref_losses, np.float32)), (
        list(got1["losses"]), ref_losses)
    for stage, got in ((0, got0), (1, got1)):
        for k in ("w", "b"):
            assert np.array_equal(got[f"p_{k}"],
                                  ref_stacked[k][stage].numpy()), (stage, k)
    assert np.array_equal(got1["h_wo"], ref_head["wo"].numpy())
    log0 = open(os.path.join(client.job_dir, "logs",
                             "stage0-0.stdout")).read()
    log1 = open(os.path.join(client.job_dir, "logs",
                             "stage1-0.stdout")).read()
    assert "loss" not in log0 and "stage 0 of 2" in log0
    assert f"step {steps - 1} loss" in log1
