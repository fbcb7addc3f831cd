"""tony_tpu_torch's shared-prefix serving against the JAX package's.

``tiny`` in f32 with the JAX weights converted to torch. Covered:

- the K/V template (``prefix_template``) against JAX's, buffer by buffer
  (1e-5 abs; an int8 cache's values equal but for one-step rounding
  flips at boundaries, its scales within 1e-5);
- ``prefix_admit_rows`` against JAX's: the seeded logits within 1e-4,
  the landed rows and frontiers;
- batcher streams against the JAX batcher's, token for token: resident
  templates (``install_prefix``) and the legacy ``shared_prefix=`` mode,
  greedy and sampled, bucketed and per-row admission, and the
  speculative batcher's prefix admissions; the port's prefix-hit
  streams against its prefix-blind ones (token for token but for a
  first difference at a decision margin within 1e-4 — the suffix runs
  the cached attention, the prefix-blind prompt the prompt forward, so
  their f32 sums differ);
- mirrors of ``tests/test_prefix.py``: explicit and wrong prefix ids, a
  prompt equal to the prefix, install validation, the ring degrade,
  a shipped template serving with zero prefix forwards;
- a preempted prefix-hit stream re-admits through the same resident
  prefix (suffix-only) and resumes token-identically;
- the template wire: blobs byte-identical between the packages (f32 and
  bf16), each package unpacks and installs the other's bit for bit,
  truncated or mistagged blobs raise ``ProtocolError``, and garbage on a
  live lane costs only itself;
- a JAX ``ServingServer`` publishing to a port server and the reverse
  over a real TONYC1 lane (the PREFIX ops install / publish / list): the
  receiver serves with zero prefix forwards and the sender's streams;
- ``serve_lm --shared_prefix_file/--publish_prefix`` as two CPU
  processes, a third as the client.
"""

import logging
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tony_tpu.models import decode as JD
from tony_tpu.models import serve as JS
from tony_tpu.models import transformer as JT
from tony_tpu.serving import kvship as JK
from tony_tpu.serving import server as JSRV
from tony_tpu_torch import serve_lm
from tony_tpu_torch.channels.channel import ChannelSender
from tony_tpu_torch.models import decode as TD
from tony_tpu_torch.models import serve as TS
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy
from tony_tpu_torch.runtime import metrics as M
from tony_tpu_torch.serving import kvship
from tony_tpu_torch.serving.client import StreamingClient
from tony_tpu_torch.serving.prefix import fingerprint, match_prefix
from tony_tpu_torch.serving.protocol import ProtocolError
from tony_tpu_torch.serving.server import ServingServer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False)
TCFG = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)
SAMPLED = dict(temperature=0.9, top_k=12, top_p=0.95, seed=11)


def _pair(seed, jcfg=JCFG):
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def params():
    return _pair(0)


def _prefix_and_suffixes(seed, prefix_len, suffix_lens):
    rs = np.random.RandomState(seed)
    prefix = [int(t) for t in rs.randint(0, 1024, size=prefix_len)]
    return prefix, [[int(t) for t in rs.randint(0, 1024, size=n)]
                    for n in suffix_lens]


def _reference(tp, prompt, n):
    out = TD.generate(tp, torch.tensor([prompt]), TCFG, n)
    return out.tokens[0, len(prompt):].tolist()


def _logits_after(tp, tokens):
    lg, _ = TD.prefill(tp, torch.tensor([tokens]), TCFG,
                       max_len=len(tokens))
    return lg[0]


def _near_tie_diffs(tp, prompts, got, want, limit=1e-4):
    """Every stream of ``got`` equals ``want``'s, or first differs where
    the two tokens' logits (after the prompt and ``want``'s tokens so
    far) lie within ``limit``. Returns the (request, step, gap) of each
    difference."""
    diffs = []
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        if g == w:
            continue
        j = next(t for t, (a, b) in enumerate(zip(g, w)) if a != b)
        lg = _logits_after(tp, p + w[:j])
        gap = abs(float(lg[w[j]] - lg[g[j]]))
        assert gap <= limit, (i, j, gap)
        diffs.append((i, j, gap))
    return diffs


def _wait_resident(host, pid, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pid in host.resident_prefixes():
            return True
        time.sleep(0.02)
    return False


# --- the template and the admission against JAX's ---------------------

@pytest.mark.parametrize("layout", ["f32", "int8", "window"])
def test_prefix_template_matches_jax(layout):
    kw = {"f32": {}, "int8": dict(kv_cache_dtype="int8"),
          "window": dict(attn_window=8)}[layout]
    jcfg, tcfg = JCFG.scaled(**kw), TCFG.scaled(**kw)
    jp, tp = _pair(0, jcfg)
    prefix, _ = _prefix_and_suffixes(1, 23, ())
    want = {n: np.asarray(a) for n, a in
            JS.prefix_template(jp, prefix, jcfg).items()}
    got = TS.prefix_template(tp, prefix, tcfg)
    assert set(got) == set(want)
    for n, a in want.items():
        g = got[n].numpy()
        assert g.shape == a.shape and g.dtype == a.dtype, n
        if g.dtype == np.int8:
            # the documented one-step flips at rounding boundaries
            d = np.abs(g.astype(np.int32) - a.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, n
        else:
            assert np.abs(g - a).max() <= 1e-5, n


def test_prefix_admit_rows_logits_match_jax(params):
    """Two suffixes of one bucket land in slots 2 and 0 of a 3-slot
    cache against the template (a sentinel row drops): the seeded
    logits within 1e-4 of JAX's, the landed K/V within 1e-5, the
    frontiers at P + suffix length."""
    jp, tp = params
    prefix, sfx = _prefix_and_suffixes(2, 19, (5, 9))
    toks = np.zeros((3, 16), np.int64)
    lens = np.array([5, 9, 1], np.int32)
    for i, s in enumerate(sfx):
        toks[i, :len(s)] = s
    rows = np.array([2, 0, 5])
    jt = JS.prefix_template(jp, prefix, JCFG)
    jc = dict(JD.init_kv_cache(JCFG, 3, 48),
              length=jnp.zeros((3,), jnp.int32))
    jc, jl = JS.prefix_admit_rows(
        jp, jc, jnp.zeros((3, JCFG.vocab_size), jnp.float32),
        jnp.asarray(rows), jt, jnp.asarray(toks, jnp.int32),
        jnp.asarray(lens), JCFG)
    tc = dict(TD.init_kv_cache(TCFG, 3, 48, device="cpu"),
              length=torch.zeros((3,), dtype=torch.int32))
    tl = torch.zeros((3, TCFG.vocab_size))
    TS.prefix_admit_rows(tp, tc, tl, rows, TS.prefix_template(tp, prefix,
                                                              TCFG),
                         torch.from_numpy(toks), torch.from_numpy(lens),
                         TCFG)
    assert np.abs(tl.numpy()[[2, 0]] - np.asarray(jl)[[2, 0]]).max() <= 1e-4
    assert tc["length"].tolist() == np.asarray(jc["length"]).tolist() \
        == [19 + 9, 0, 19 + 5]
    for n in ("k", "v"):
        a, b = np.asarray(jc[n]), tc[n].numpy()
        assert np.abs(a[:, [0, 2], :28] - b[:, [0, 2], :28]).max() <= 1e-5


# --- batcher streams against the JAX batcher's ------------------------

_ARMS = {"install greedy": ("install", {}),
         "install sampled": ("install", SAMPLED),
         "install per-row": ("install", dict(bucketed_admission=False)),
         "legacy greedy": ("legacy", {}),
         "legacy sampled": ("legacy", SAMPLED)}


@pytest.mark.parametrize("arm", sorted(_ARMS))
def test_batcher_streams_match_jax(params, arm):
    """A mixed workload (hits and a prefix-blind bystander) through a
    resident template, or every prompt a suffix of the legacy
    ``shared_prefix``: the port's streams and counters equal the JAX
    batcher's; against the port's own prefix-blind serve, equal but for
    a near-tie."""
    jp, tp = params
    kind, kw = _ARMS[arm]
    prefix, sfx = _prefix_and_suffixes(3, 17, (4, 2, 6, 3))
    if kind == "install":
        prompts = [prefix + s for s in sfx]
        prompts.insert(2, [7] * 9)
    else:
        prompts = sfx
    budgets = [5, 7, 4, 6, 5][:len(prompts)]
    extra = dict(shared_prefix=prefix) if kind == "legacy" else {}
    runs = []
    for mod, p, cfg in ((JS, jp, JCFG), (TS, tp, TCFG)):
        b = mod.ContinuousBatcher(p, cfg, batch=2, max_len=64, chunk=3,
                                  **kw, **extra)
        if kind == "install":
            assert b.install_prefix(fingerprint(prefix), prefix)
        runs.append((b.serve(prompts, budgets), b))
    (want, jb), (got, tb) = runs
    assert got == want
    for c in ("prefix_admits", "prefix_copied_tokens",
              "prefill_forward_tokens", "steps_executed"):
        assert getattr(tb, c) == getattr(jb, c), c
    assert tb.prefix_admits == (4 if kind == "install" else 0)
    full = prompts if kind == "install" else [prefix + s for s in sfx]
    blind = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=64, chunk=3,
                                 **kw).serve(full, budgets)
    if kw.get("temperature"):
        assert got == blind
    else:
        _near_tie_diffs(tp, full, got, blind)


@pytest.mark.parametrize("sampling", [{}, SAMPLED],
                         ids=["greedy", "sampled"])
def test_speculative_prefix_admission_matches_jax(params, sampling):
    """The speculative batcher's prefix hits (spec_prefix_admit_rows;
    the draft template computed at install) give the JAX speculative
    batcher's streams and rounds, and greedy, the non-speculative
    prefix-hit serve's streams."""
    jp, tp = params
    jd, td = _pair(99)
    prefix, sfx = _prefix_and_suffixes(5, 11, (3, 5, 2))
    prompts = [prefix + s for s in sfx]
    budgets = [6, 4, 7]
    runs = []
    for mod, p, d, cfg in ((JS, jp, jd, JCFG), (TS, tp, td, TCFG)):
        b = mod.SpeculativeContinuousBatcher(
            p, cfg, d, cfg, batch=2, max_len=64, num_speculative=3,
            chunk=2, **sampling)
        assert b.install_prefix("sys", prefix)
        runs.append((b.serve(prompts, budgets), b))
    (want, jb), (got, tb) = runs
    assert got == want and tb.rounds_executed == jb.rounds_executed
    assert tb.prefix_admits == 3
    assert tb._prefix_store["sys"].draft_template is not None
    if not sampling:    # speculative SAMPLING draws other numbers
        plain = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=64,
                                     chunk=3)
        plain.install_prefix("sys", prefix)
        assert got == plain.serve(prompts, budgets)


def test_exact_length_speculative_prefix_admission(params):
    """The per-row arm (spec_prefix_admit_row) gives the bucketed arm's
    streams, greedy and sampled."""
    _, tp = params
    prefix, sfx = _prefix_and_suffixes(6, 10, (4, 7))
    prompts = [prefix + s for s in sfx]
    for sampling in ({}, SAMPLED):
        outs = []
        for bucketed in (True, False):
            b = TS.SpeculativeContinuousBatcher(
                tp, TCFG, tp, TCFG, batch=2, max_len=48, num_speculative=2,
                chunk=2, bucketed_admission=bucketed, **sampling)
            b.install_prefix("sys", prefix)
            TS.CALL_COUNTS.clear()
            outs.append(b.serve(prompts, [5, 6]))
            name = ("spec_prefix_admit_rows" if bucketed
                    else "spec_prefix_admit_row")
            assert any(n == name for n, _ in TS.CALL_COUNTS)
        assert outs[0] == outs[1]


# --- mirrors of tests/test_prefix.py ----------------------------------

def test_identity_and_matching():
    assert fingerprint([1, 2, 3]) == fingerprint([1, 2, 3])
    assert fingerprint([1, 2, 3]) != fingerprint([1, 2, 4])
    assert len(fingerprint(list(range(100)))) == 16
    catalog = {"a": [1, 2], "b": [1, 2, 3], "c": [9]}
    assert match_prefix([1, 2, 3, 4], catalog) == "b"
    assert match_prefix([1, 2, 3], catalog) == "a"
    assert match_prefix([1, 2], catalog) is None
    assert match_prefix([], {}) is None


def test_explicit_and_wrong_prefix_ids_are_both_safe(params):
    """submit(prefix_id=) takes the named entry; a wrong or unknown id
    falls back to the token match — the JAX engine's tokens every time,
    and generate's but for a near-tie."""
    jp, tp = params
    prefix, (sfx,) = _prefix_and_suffixes(13, 9, (4,))
    ref = _reference(tp, prefix + sfx, 5)
    for pid in ("sys", "no-such-prefix", None):
        jb = JS.ContinuousBatcher(jp, JCFG, batch=1, max_len=64, chunk=3)
        assert jb.install_prefix("sys", prefix)
        jout = {}
        jeng = JS.ServeEngine(
            jb, on_delta=lambda r, t: jout.setdefault(r, []).extend(t),
            on_retired=lambda r, why, n, final:
                jout.setdefault(r, []).extend(final))
        jeng.submit("r1", prefix + sfx, 5, prefix_id=pid)
        jeng.drain()
        jeng.run()
        b = TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=64, chunk=3)
        assert b.install_prefix("sys", prefix)
        outs = {}
        eng = TS.ServeEngine(
            b, on_delta=lambda r, t: outs.setdefault(r, []).extend(t),
            on_retired=lambda r, why, n, final:
                outs.setdefault(r, []).extend(final),
            registry=M.MetricsRegistry())
        eng.submit("r1", prefix + sfx, 5, prefix_id=pid)
        eng.drain()
        eng.run()
        assert outs["r1"] == jout["r1"], pid
        _near_tie_diffs(tp, [prefix + sfx], [outs["r1"]], [ref])
        assert b.prefix_admits == jb.prefix_admits == 1, pid


def test_prompt_equal_to_prefix_is_not_a_hit(params):
    _, tp = params
    prefix, _ = _prefix_and_suffixes(15, 12, ())
    b = TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=64, chunk=3)
    assert b.install_prefix("sys", prefix)
    assert b.serve([prefix], 4) == [_reference(tp, prefix, 4)]
    assert b.prefix_admits == 0


def test_install_validation(params):
    _, tp = params
    b = TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=16)
    with pytest.raises(ValueError, match="non-empty"):
        b.install_prefix("x", [])
    with pytest.raises(ValueError, match="no room"):
        b.install_prefix("x", list(range(15)))
    legacy = TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=32,
                                  shared_prefix=[1, 2, 3])
    with pytest.raises(ValueError, match="shared_prefix"):
        legacy.install_prefix("x", [4, 5])
    with pytest.raises(ValueError, match="non-empty"):
        TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=32,
                             shared_prefix=[])
    assert b.install_prefix("s", list(range(10)))
    eng = TS.ServeEngine(b, registry=M.MetricsRegistry())
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit("r", list(range(10)) + [1, 2], 8)
    # a template of a differently-shaped model is request-scoped
    src = TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=32)
    src.install_prefix("sys", [1, 2, 3])
    meta, bufs = kvship.unpack_template(src.export_prefix_blob("sys"))
    with pytest.raises(ValueError, match="vocab"):
        b.install_prefix_template(dict(meta, vocab=TCFG.vocab_size + 1),
                                  bufs)
    with pytest.raises(ValueError, match="layer"):
        b.install_prefix_template(meta, {n: a[:1] for n, a in bufs.items()})
    with pytest.raises(ValueError, match="positions"):
        b.install_prefix_template(dict(meta, tokens=[1, 2]), bufs)
    with pytest.raises(ValueError, match="layout"):
        b.install_prefix_template(meta, {"k": bufs["k"]})
    assert b.resident_prefixes() == ["s"]
    with pytest.raises(ValueError, match="not resident"):
        b.export_prefix_blob("ghost")


def test_ring_cache_degrades_with_one_warning(caplog):
    ring = dict(attn_window=8, kv_cache_capacity=8)
    jp, tp = _pair(0, JCFG.scaled(**ring))
    cfg = TCFG.scaled(**ring)
    b = TS.ContinuousBatcher(tp, cfg, batch=1, max_len=32)
    with caplog.at_level(logging.WARNING, "tony_tpu_torch.models.serve"):
        assert b.install_prefix("sys", [1, 2, 3]) is False
        assert b.install_prefix("sys2", [4, 5]) is False
    assert sum("ring" in r.getMessage() for r in caplog.records) == 1
    assert b.resident_prefixes() == []
    with pytest.raises(ValueError, match="rolling"):
        b.install_prefix_template({"id": "x", "tokens": [1],
                                   "vocab": cfg.vocab_size}, {})
    with pytest.raises(ValueError, match="linear KV cache"):
        TS.ContinuousBatcher(tp, cfg, batch=1, max_len=32,
                             shared_prefix=[1, 2])
    want = JS.ContinuousBatcher(jp, JCFG.scaled(**ring), batch=1,
                                max_len=32).serve([[5, 6, 7]], 3)
    assert b.serve([[5, 6, 7]], 3) == want


def test_shipped_template_serves_with_zero_prefix_forwards(params):
    _, tp = params
    prefix, sfx = _prefix_and_suffixes(9, 21, (3, 4, 2, 5))
    src = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=64)
    src.install_prefix("sys", prefix)
    meta, bufs = kvship.unpack_template(src.export_prefix_blob("sys"))
    warm = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=64, chunk=3)
    assert warm.install_prefix_template(meta, bufs) == "sys"
    assert warm.prefill_forward_tokens == 0
    prompts = [prefix + s for s in sfx]
    want = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=64, chunk=3)
    want.install_prefix("sys", prefix)
    assert warm.serve(prompts, 5) == want.serve(prompts, 5)
    assert warm.prefill_forward_tokens == sum(len(s) for s in sfx)
    assert warm.prefix_admits == len(sfx)


def test_installs_race_a_live_engine(params):
    """Install threads land templates (computed and shipped) while the
    engine admits prefix hits, under a shortened switch interval: every
    stream equals the serve without the race and the forward-token count
    loses no update (installs and admissions share the store's lock)."""
    _, tp = params
    prefix, sfx = _prefix_and_suffixes(51, 12, (3, 5, 2, 4, 6, 3))
    prompts = [prefix + s for s in sfx]
    others = [_prefix_and_suffixes(60 + i, 8, ())[0] for i in range(6)]
    src = TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=48)
    src.install_prefix("shipped", others[0])
    meta, bufs = kvship.unpack_template(src.export_prefix_blob("shipped"))
    want = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=48, chunk=2)
    want.install_prefix("sys", prefix)
    want = want.serve(prompts, 6)
    b = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=48, chunk=2)
    b.install_prefix("sys", prefix)
    got = {}
    eng = TS.ServeEngine(
        b, on_delta=lambda r, t: got.setdefault(r, []).extend(t),
        on_retired=lambda r, why, n, final:
            got.setdefault(r, []).extend(final),
        registry=M.MetricsRegistry())
    for i, p in enumerate(prompts):
        eng.submit(i, p, 6)

    def installs():
        for i, toks in enumerate(others[1:]):
            b.install_prefix(f"o{i}", toks)
        b.install_prefix_template(meta, bufs)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=installs)
        th.start()
        eng.drain()
        eng.run()
        th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not th.is_alive()
    assert [got[i] for i in range(len(prompts))] == want
    assert sorted(b.resident_prefixes()) == sorted(
        ["sys", "shipped"] + [f"o{i}" for i in range(5)])
    assert b.prefill_forward_tokens == (len(prefix) + 5 * 8
                                        + sum(map(len, sfx)))


# --- preemption of a prefix-hit stream --------------------------------

def test_preempted_prefix_hit_resumes_token_identically(params):
    """Batch-class prefix hits evicted by interactive arrivals re-admit
    through the same resident prefix (suffix + history only) and stream
    exactly what the unpreempted run streams, greedy and sampled."""
    _, tp = params
    prefix, sfx = _prefix_and_suffixes(21, 14, (5, 3, 6))
    batch_prompts = [prefix + s for s in sfx]
    inter = [[int(t) for t in np.random.RandomState(22).randint(0, 1024, 4)]
             for _ in range(2)]
    for sampling in ({}, SAMPLED):
        class Arrivals(TS.ContinuousBatcher):
            fetches = 0
            engine = None

            def _fetch(self, handle):
                out = super()._fetch(handle)
                self.fetches += 1
                if self.fetches == 2:
                    for i, p in enumerate(inter):
                        self.engine.submit(f"i{i}", p, 4,
                                           request_class="interactive",
                                           rng=(10 + i, 0))
                    self.engine.drain()
                return out

            def _admit_batch(self, pairs, prompts):
                self.waves.extend((s, prompts[s]) for _, s in pairs)
                return super()._admit_batch(pairs, prompts)

        b = Arrivals(tp, TCFG, batch=2, max_len=64, chunk=3, **sampling)
        b.waves = []
        b.install_prefix("sys", prefix)
        got = {}
        eng = TS.ServeEngine(
            b, on_delta=lambda r, t: got.setdefault(r, []).extend(t),
            on_retired=lambda r, why, n, final:
                got.setdefault(r, []).extend(final),
            registry=M.MetricsRegistry())
        b.engine = eng
        for i, p in enumerate(batch_prompts):
            eng.submit(i, p, 12, request_class="batch")
        eng.run()
        assert eng.preemptions >= 1
        plain = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=64,
                                     chunk=3, **sampling)
        plain.install_prefix("sys", prefix)
        want = plain.serve(batch_prompts, 12)
        assert [got[i] for i in range(3)] == want
        # every admission of a batch stream, resumes included, was a hit
        # on the resident prefix: only suffix + history ran the model
        batch_waves = [p for s, p in b.waves if s < 3]
        assert len(batch_waves) == 3 + eng.preemptions
        assert all(isinstance(p, TS._PrefixHit) and p.entry.id == "sys"
                   for p in batch_waves)
        assert b.prefix_admits == 3 + eng.preemptions
        assert b.prefix_copied_tokens == len(prefix) * b.prefix_admits


# --- the template wire ------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_template_blobs_byte_identical_between_packages(params, dtype):
    """One set of template buffers packs to the same bytes in either
    package; each package unpacks the other's blob, and a port batcher
    installs a JAX blob bit for bit."""
    jp, _ = params
    jcfg = JCFG.scaled(dtype=jnp.bfloat16) if dtype == "bf16" else JCFG
    tcfg = TCFG.scaled(dtype=torch.bfloat16) if dtype == "bf16" else TCFG
    jp = jax.tree.map(lambda a: a.astype(jcfg.dtype), jp)
    prefix, _ = _prefix_and_suffixes(4, 10, ())
    jbufs = {n: np.asarray(a) for n, a in
             JS.prefix_template(jp, prefix, jcfg).items()}
    tbufs = params_from_numpy(jbufs, device="cpu")
    jblob = JK.pack_template("sys", prefix, jbufs, jcfg.vocab_size)
    tblob = kvship.pack_template("sys", prefix, tbufs, tcfg.vocab_size)
    assert jblob == tblob
    meta, got = kvship.unpack_template(jblob)
    assert meta == {"id": "sys", "tokens": prefix,
                    "vocab": tcfg.vocab_size, "kind": "prefix_template"}
    _, back = JK.unpack_template(tblob)
    for n, a in jbufs.items():
        assert back[n].dtype == a.dtype and back[n].tobytes() == a.tobytes()
        if dtype == "bf16":
            assert got[n].dtype == torch.bfloat16
            assert a.dtype == ml_dtypes.bfloat16
        assert (got[n].view(torch.int16).numpy().tobytes()
                if dtype == "bf16" else got[n].tobytes()) == a.tobytes()
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    b = TS.ContinuousBatcher(tp, tcfg, batch=1, max_len=32)
    assert b.install_prefix_template(meta, got) == "sys"
    assert b.prefill_forward_tokens == 0
    assert b.export_prefix_blob("sys") == jblob


def test_truncated_and_mistagged_blobs_are_protocol_errors(params):
    _, tp = params
    src = TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=32)
    src.install_prefix("sys", [1, 2, 3, 4])
    blob = src.export_prefix_blob("sys")
    for cut in (1, 10, len(blob) // 2, len(blob) - 1):
        with pytest.raises(ProtocolError):
            kvship.unpack_template(blob[:cut])
    row_blob = kvship.pack_shipment(
        kvship.pack_kv_meta(1, 4, 3, np.zeros(2, np.uint32)),
        {"k": np.zeros((2, 1, 3, 1, 4), np.float32)})
    with pytest.raises(ProtocolError, match="not a prefix"):
        kvship.unpack_template(row_blob)


def test_garbage_on_the_live_lane_costs_only_itself(params):
    _, tp = params
    server = ServingServer(TS.ContinuousBatcher(tp, TCFG, batch=1,
                                                max_len=32),
                           registry=M.MetricsRegistry())
    try:
        server.start()
        target = f"127.0.0.1:{server.prefix_port}"
        s = ChannelSender(target, "prefix", window=2,
                          registry=M.MetricsRegistry())
        try:
            s.send_bytes(b"not a template at all", sync=True, timeout=20)
            wrong = kvship.pack_template(
                "sys", [1, 2, 3],
                {"k": np.zeros((2, 1, 3, 1, 4), np.float32)},
                vocab=TCFG.vocab_size + 7)
            s.send_bytes(wrong, sync=True, timeout=20)
            time.sleep(0.3)
            assert server.resident_prefixes() == []
            src = TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=32)
            src.install_prefix("sys", [1, 2, 3, 4])
            s.send_bytes(src.export_prefix_blob("sys"), sync=True,
                         timeout=20)
        finally:
            s.close(drain=False)
        assert _wait_resident(server, "sys")
        with StreamingClient("127.0.0.1", server.port) as c:
            out, _ = c.result(c.submit([5, 6, 7], 3))
        assert out == _reference(tp, [5, 6, 7], 3)
    finally:
        server.kill()


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_template_ship_between_jax_and_port_servers(params, direction):
    """The warm replica installs the prefix over a PREFIX ``install`` op
    and publishes it to the cold one's lane (PREFIX ``publish``); the
    cold replica lists it, holds the warm one's template bit for bit,
    serves prefix-heavy traffic with zero prefix forwards
    (``prefill_tokens`` = the suffixes) and streams what the warm
    replica streams."""
    jp, tp = params
    prefix, sfx = _prefix_and_suffixes(31, 20, (3, 6, 4))
    prompts = [prefix + s for s in sfx]
    jsrv = JSRV.ServingServer(JS.ContinuousBatcher(jp, JCFG, batch=2,
                                                   max_len=48, chunk=3))
    tsrv = ServingServer(TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=48,
                                              chunk=3),
                         registry=M.MetricsRegistry())
    warm, cold = (jsrv, tsrv) if direction == "jax-to-port" \
        else (tsrv, jsrv)
    try:
        jsrv.start()
        tsrv.start()
        with StreamingClient("127.0.0.1", warm.port) as cw, \
                StreamingClient("127.0.0.1", cold.port) as cc:
            res = cw.prefix_op("install", tokens=prefix, id="sys")
            assert res["ok"] and res["resident"] == ["sys"]
            assert not cw.prefix_op("install", tokens=[])["ok"]
            assert not cw.prefix_op("publish", id="ghost",
                                    target="127.0.0.1:1")["ok"]
            res = cw.prefix_op("publish", id="sys",
                               target=f"127.0.0.1:{cold.prefix_port}")
            assert res["ok"] and res["bytes"] > 0
            assert _wait_resident(cold, "sys")
            assert cc.prefix_op("list")["resident"] == ["sys"]
            outs = []
            for c in (cw, cc):
                rids = [c.submit(p, 5) for p in prompts]
                outs.append([c.result(r)[0] for r in rids])
            st = cc.stats()
        assert outs[1] == outs[0]
        # the cold replica holds the warm one's template bit for bit
        for n, a in jsrv.batcher._prefix_store["sys"].template.items():
            t = tsrv.batcher._prefix_store["sys"].template[n]
            assert np.asarray(a).tobytes() == t.numpy().tobytes(), n
        assert st["prefixes"] == ["sys"]
        assert st["prefill_tokens"] == sum(len(s) for s in sfx)
        assert st["prefix_admits"] == len(sfx)
    finally:
        jsrv.kill()
        tsrv.kill()


# --- serve_lm as processes --------------------------------------------

def _serve_lm(*args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.serve_lm", "--device", "cpu",
         "--preset", "tiny", *args], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _port_of(proc):
    import re
    lines = []
    while True:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError("serve_lm exited: " + "".join(lines))
        lines.append(line)
        m = re.search(r"serving tiny \(\w+\) on 127\.0\.0\.1:(\d+)", line)
        if m:
            return int(m.group(1)), lines


def test_serve_lm_publish_prefix_processes(tmp_path):
    """``serve_lm --listen A --shared_prefix_file F --publish_prefix B``
    warms a cold ``serve_lm --listen B``; a ``--connect B
    --shared_prefix_file F`` client streams, and B ran zero prefix
    forwards and gave the in-process prefix-hit serve's streams."""
    prefix, _ = _prefix_and_suffixes(41, 24, ())
    pfile = tmp_path / "prefix.txt"
    pfile.write_text(",".join(map(str, prefix)))
    cold = _serve_lm("--slots", "2", "--prompt_len", "40",
                     "--max_new_tokens", "8", "--listen", "127.0.0.1:0")
    warm = None
    try:
        bport, _ = _port_of(cold)
        warm = _serve_lm("--slots", "2", "--prompt_len", "8",
                         "--max_new_tokens", "8", "--listen", "127.0.0.1:0",
                         "--shared_prefix_file", str(pfile),
                         "--publish_prefix", f"127.0.0.1:{bport}")
        _, lines = _port_of(warm)
        text = "".join(lines)
        assert f"prefix {fingerprint(prefix)} resident (24 tokens)" in text
        assert "published prefix" in text
        with StreamingClient("127.0.0.1", bport) as c:
            assert c.stats()["prefixes"] == [fingerprint(prefix)]
        out = tmp_path / "outs.json"
        cli = subprocess.run(
            [sys.executable, "-m", "tony_tpu_torch.serve_lm", "--preset",
             "tiny", "--requests", "4", "--prompt_len", "8",
             "--max_new_tokens", "8", "--connect", f"127.0.0.1:{bport}",
             "--shared_prefix_file", str(pfile), "--outputs", str(out)],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=120)
        assert cli.returncode == 0, cli.stdout + cli.stderr
        with StreamingClient("127.0.0.1", bport) as c:
            st = c.stats()
        assert st["prefill_tokens"] == 4 * 8 and st["prefix_admits"] == 4
        import json
        got = json.loads(out.read_text())
        cfg, p = serve_lm.build("tiny", "cpu")
        prompts, budgets = serve_lm.make_workload(0, 4, 8, 8, cfg.vocab_size)
        b = TS.ContinuousBatcher(p, cfg, batch=2, max_len=48)
        b.install_prefix("sys", prefix)
        assert got == b.serve([prefix + q for q in prompts], budgets)
    finally:
        for proc in (warm, cold):
            if proc is not None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.communicate(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.communicate()
