"""tony_tpu_torch's tensor-parallel decoding and multi-slice meshes vs the
JAX package's.

The port decodes in a gloo group of 4 CPU processes
(``tests/torch_dist_worker.py``'s ``decode`` cases, one group under its
own time limit), each rank on the params that ``shard_pytree`` laid out
(quantized after sharding for int8); the JAX package runs the same mesh
on the conftest's virtual CPU devices (the first 4) under
``jax.set_mesh``, and unsharded. Inputs are numpy from a seed, the
weights the JAX ``init_params``, f32 ``tiny`` (and the beam twin's small
config):

- greedy ``generate`` on ``{"tp": 2, "dp": 2}`` and ``{"tp": 4}``, and
  GQA with 2 kv heads at tp 4 (K/V replicated, each rank cutting its kv
  heads), token-identical to JAX's sharded and unsharded runs (the twins
  of ``tests/test_decode.py::TestDecode::test_tp_sharded_decode_matches_unsharded``
  and ``TestGQA::test_tp_sharded_gqa_decode``);
- ``decode_step`` over a 600-row cache (the blockwise walk) at tp 4
  within rtol/atol 3e-4 of JAX's (``test_tp_sharded_long_cache_decode``);
- beam search with ``vocab_size=16`` at tp 2: tokens equal, scores
  within 1e-4 (``TestBeamSearch::test_tp_sharded_beams_match_unsharded``);
- int8 weights quantized after sharding on ``{"fsdp": 2, "tp": 2}``: q
  and scale of every leaf, gathered, bitwise the JAX package's
  quantization of the same sharded tree (``wo`` and ``w_down`` contract
  over tp, every ``d``-contracting leaf over fsdp: the absmax takes the
  max over those axes), tokens equal to JAX's quantized runs
  (``tests/test_quantize.py::test_tp_sharded_quant_decode_matches_unsharded``);
- one sampled ``generate`` (temperature 0.8, top-k 8) at tp 4, token-
  identical to JAX's: every rank draws the same threefry noise over the
  gathered vocab;
- the emulation (a dict mesh: every rank in one process, the form one
  card runs) equals the gloo group bit for bit, every case;
- ``runtime.mesh()`` from a mesh spec with dcn axes, as a task of a
  2-slice job gets it, has the JAX hybrid mesh's names, shape and
  slice-major rank grid.

In one process: the emulation's attention and RMSNorm calls match the
launch formulas the card checks (K1 ``n_layers × tp`` a prefill, K5
``(2·n_layers + 1) × tp`` a forward), the cache holds each rank's kv
heads, speculative decoding takes sharded params, a dict mesh without
tp is the unsharded decode bit for bit, and the unported axes (cp, pp,
ep; MoE under tp) and a tp the heads do not divide are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import decode as JD
from tony_tpu.models import transformer as JT
from tony_tpu.models.quantize import QuantizedWeight as JQ
from tony_tpu.models.quantize import quantize_weights_int8 as jquantize
from tony_tpu.parallel.mesh import make_hybrid_mesh as jax_make_hybrid_mesh
from tony_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tony_tpu.parallel.sharding import shard_pytree as jax_shard_pytree
from tony_tpu_torch.models import decode as TD
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy

import test_torch_distributed as TDIST

torch.set_num_threads(2)

#: the beam twin's config (tests/test_decode.py::TestBeamSearch.BCFG,
#: vocab 16 so its lm_head splits over tp)
JBEAM = JT.TransformerConfig(vocab_size=16, d_model=24, n_layers=2,
                             n_heads=2, d_ff=48, max_seq=256,
                             dtype=jnp.float32, logits_dtype=jnp.float32,
                             remat=False)


class DecodeCase(TDIST.Case):
    """A decode case of the worker: ``kw`` = the config's overrides plus
    ``cfg`` (tiny or beam), ``kind``, ``new`` (tokens) and ``int8``;
    ``seed`` the weights' JAX key, ``prompt`` the prompt's shape and
    numpy seed."""

    def __init__(self, name, axes, kw, seed=0, prompt=((2, 8), 9)):
        super().__init__(name, 4, axes, model="decode", kw=kw)
        self.seed, self.prompt = seed, prompt

    def jax_cfg(self):
        model = {k: v for k, v in self.kw.items()
                 if k not in ("cfg", "kind", "int8", "new")}
        base = JBEAM if self.kw.get("cfg") == "beam" else JT.PRESETS[
            "tiny"].scaled(dtype=jnp.float32, remat=False)
        return base.scaled(**model)


DECODE_CASES = [
    DecodeCase("greedy_tp2_dp2", {"tp": 2, "dp": 2},
               {"kind": "greedy", "new": 6}),
    DecodeCase("greedy_tp4", {"tp": 4}, {"kind": "greedy", "new": 6}),
    DecodeCase("gqa_tp4", {"tp": 4},
               {"kind": "greedy", "new": 5, "n_kv_heads": 2}, seed=6,
               prompt=((2, 8), 7)),
    DecodeCase("long_tp4", {"tp": 4}, {"kind": "long", "new": 1},
               prompt=((2, 6), 31)),
    DecodeCase("beam_tp2_dp2", {"tp": 2, "dp": 2},
               {"kind": "beam", "new": 5, "cfg": "beam"}, seed=2,
               prompt=((2, 5), 8)),
    DecodeCase("int8_fsdp2_tp2", {"fsdp": 2, "tp": 2},
               {"kind": "greedy", "new": 10, "int8": True},
               prompt=((2, 8), 10)),
    DecodeCase("sampled_tp4", {"tp": 4},
               {"kind": "sampled", "new": 6}, prompt=((2, 8), 11)),
]
MESH_ENV = TDIST.Case("mesh_env", 4, {"tp": -1}, model="mesh_env",
                      kw={"dcn": {"dp": 2}})


def _jax_params(case):
    return JT.init_params(jax.random.PRNGKey(case.seed), case.jax_cfg())


def _prompt(case):
    shape, seed = case.prompt
    return np.random.RandomState(seed).randint(
        0, case.jax_cfg().vocab_size, size=shape).astype(np.int32)


def _setup(case):
    """run_group's per-case inputs: the weights and the prompt."""
    if case.model == "mesh_env":
        return None, None, {}, {}
    return None, None, jax.device_get(_jax_params(case)), {
        "prompt": _prompt(case)}


@pytest.fixture(scope="module")
def decode_group(tmp_path_factory):
    """Every rank's outputs of every decode case and of the mesh_env
    case, from one gloo group of 4 (a failed group fails each test)."""
    try:
        return TDIST.run_group(DECODE_CASES + [MESH_ENV], 4,
                               tmp_path_factory.mktemp("tp_decode"),
                               setup=_setup)
    except RuntimeError as e:
        return e


def _outs(group, name):
    if isinstance(group, Exception):
        pytest.fail(str(group))
    return group[name]


def _case(name):
    return next(c for c in DECODE_CASES if c.name == name)


def _jax_mesh(case):
    return jax_make_mesh(case.axes, devices=jax.devices()[:case.world])


def _jax_run(case, params, mesh=None):
    """The JAX package's run of ``case``'s entry point, sharded on
    ``mesh`` (under ``jax.set_mesh``) or unsharded."""
    cfg, prompt = case.jax_cfg(), jnp.asarray(_prompt(case))
    kind, new = case.kw["kind"], case.kw["new"]
    if mesh is not None:
        params = jax_shard_pytree(params, JT.logical_axes(cfg), mesh)
        if case.kw.get("int8"):
            params = jquantize(params)

    def run():
        if kind == "beam":
            return JD.beam_search(params, prompt, cfg, max_new_tokens=new,
                                  beam_width=3)
        if kind == "long":
            _, cache = JD.prefill(params, prompt, cfg, max_len=600)
            return JD.decode_step(params, jnp.array([1, 2]), cache,
                                  cache["length"], cfg)[0]
        kw = (dict(temperature=0.8, top_k=8) if kind == "sampled" else {})
        return JD.generate(params, prompt, cfg, new, jax.random.PRNGKey(0),
                           **kw)

    if mesh is None:
        return run()
    with jax.set_mesh(mesh):
        return run()


def _unsharded_params(case):
    p = _jax_params(case)
    return jquantize(p) if case.kw.get("int8") else p


@pytest.mark.parametrize("name", ["greedy_tp2_dp2", "greedy_tp4", "gqa_tp4",
                                  "int8_fsdp2_tp2", "sampled_tp4"])
def test_generate_matches_jax_sharded_and_unsharded(name, decode_group):
    case = _case(name)
    outs = _outs(decode_group, name)
    want = np.asarray(_jax_run(case, _unsharded_params(case)).tokens)
    sharded = np.asarray(_jax_run(case, _jax_params(case),
                                  _jax_mesh(case)).tokens)
    np.testing.assert_array_equal(sharded, want)
    for o in outs:          # every rank returns the full batch's tokens
        np.testing.assert_array_equal(o["tokens"], want)


def test_long_cache_decode_step_matches_jax(decode_group):
    case = _case("long_tp4")
    outs = _outs(decode_group, case.name)
    want = np.asarray(_jax_run(case, _jax_params(case)))
    sharded = np.asarray(_jax_run(case, _jax_params(case), _jax_mesh(case)))
    for o in outs:
        assert int(o["cache_heads"]) == 1       # 4 heads over tp 4
        np.testing.assert_allclose(o["logits"], want, rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(o["logits"], sharded, rtol=3e-4,
                                   atol=3e-4)


def test_beam_search_matches_jax(decode_group):
    case = _case("beam_tp2_dp2")
    outs = _outs(decode_group, case.name)
    want = _jax_run(case, _jax_params(case))
    sharded = _jax_run(case, _jax_params(case), _jax_mesh(case))
    np.testing.assert_array_equal(np.asarray(sharded.tokens),
                                  np.asarray(want.tokens))
    for o in outs:
        np.testing.assert_array_equal(o["tokens"], np.asarray(want.tokens))
        np.testing.assert_allclose(o["scores"], np.asarray(want.scores),
                                   atol=1e-4)


def test_int8_quantized_after_sharding_is_bitwise_jax(decode_group):
    """q and scale of every quantized leaf, gathered from the port's
    DTensors, equal the JAX package's quantization of the same sharded
    tree bit for bit — the row-parallel ``wo`` and ``w_down`` (contracted
    axis split over tp) and every leaf contracting ``d`` (split over
    fsdp) included."""
    case = _case("int8_fsdp2_tp2")
    outs = _outs(decode_group, case.name)
    mesh = _jax_mesh(case)
    cfg = case.jax_cfg()
    jq = jquantize(jax_shard_pytree(_jax_params(case), JT.logical_axes(cfg),
                                    mesh))
    leaves = dict(("blocks/" + n, w) for n, w in jq["blocks"].items()
                  if isinstance(w, JQ))
    leaves["lm_head"] = jq["lm_head"]
    assert {"blocks/wo", "blocks/w_down"} <= set(leaves)
    for o in outs:
        assert {k[2:] for k in o if k.startswith("q/")} == set(leaves)
        for path, w in leaves.items():
            np.testing.assert_array_equal(o[f"q/{path}"], np.asarray(w.q),
                                          err_msg=path)
            np.testing.assert_array_equal(o[f"scale/{path}"],
                                          np.asarray(w.scale), err_msg=path)


@pytest.mark.parametrize("name", [c.name for c in DECODE_CASES])
def test_emulation_equals_the_gloo_group(name, decode_group):
    """Rank 0's emulation of the dict mesh of the same sizes (every rank
    in one process) against every rank of the group, bit for bit."""
    outs = _outs(decode_group, name)
    emu = {k[4:]: v for k, v in outs[0].items() if k.startswith("emu/")}
    if "cache_heads" in emu:      # every emulated rank's heads, side by side
        assert int(emu.pop("cache_heads")) == 4 * int(outs[0]["cache_heads"])
    assert emu
    for o in outs:
        for k, v in emu.items():
            np.testing.assert_array_equal(o[k], v, err_msg=k)


def test_runtime_mesh_from_the_env_is_jax_hybrid_mesh(decode_group):
    """``runtime.mesh()`` under a mesh spec of axes ``{"tp": -1}`` and
    dcn axes ``{"dp": 2}`` (each rank in slice rank // 2): the names and
    shape of the JAX package's ``make_hybrid_mesh`` over 4 devices, and
    its device grid as the rank grid (a slice is a contiguous block of
    the dcn axis)."""
    outs = _outs(decode_group, "mesh_env")
    jm = jax_make_hybrid_mesh({"tp": -1}, {"dp": 2},
                              devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(np.asarray(jm.devices))
    for o in outs:
        assert tuple(o["names"]) == tuple(jm.axis_names) == ("dp", "tp")
        assert tuple(o["shape"]) == tuple(jm.devices.shape)
        np.testing.assert_array_equal(o["ranks"], ids)
        assert list(o["ranks"][0]) == [0, 1]        # slice 0


# -- in one process ------------------------------------------------------

def _tiny(**kw):
    jcfg = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False, **kw)
    tcfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False,
                                     **kw)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp),
                                             device="cpu")


@pytest.mark.parametrize("tp,kv", [(2, None), (4, None), (4, 2), (4, 1)])
def test_emulated_calls_follow_the_launch_formulas(tp, kv, monkeypatch):
    """Per emulated prefill every rank runs attention once a layer on
    its H/tp query heads and its kv heads (K1 ``n_layers × tp`` on the
    card) and every rank its norms (K5 ``(2·n_layers + 1) × tp`` a
    forward); the cache holds each rank's kv heads side by side."""
    _, tcfg, _, tp_params = _tiny(n_kv_heads=kv)
    calls = {"attn": [], "norm": 0}
    real_attn, real_norm = TT._attention, TD.rms_norm

    def attn(q, k, v, *a, **k2):
        calls["attn"].append((q.shape[2], k.shape[2]))
        return real_attn(q, k, v, *a, **k2)

    def norm(*a, **k2):
        calls["norm"] += 1
        return real_norm(*a, **k2)
    monkeypatch.setattr(TT, "_attention", attn)
    monkeypatch.setattr(TD, "rms_norm", norm)
    prompt = torch.from_numpy(np.random.RandomState(3).randint(
        0, 1024, size=(2, 8)))
    _, cache = TD.prefill(tp_params, prompt, tcfg, 16, mesh={"tp": tp})
    L, H = tcfg.n_layers, tcfg.n_heads
    kv_local = max(tcfg.kv_heads // tp, 1)
    assert calls["attn"] == [(H // tp, kv_local)] * (L * tp)
    assert calls["norm"] == (2 * L + 1) * tp
    assert cache["k"].shape[3] == kv_local * tp
    empty = TD.init_kv_cache(tcfg, 2, 16, device="cpu", mesh={"tp": tp})
    assert empty["k"].shape == cache["k"].shape
    calls["norm"] = 0
    TD.decode_step(tp_params, torch.tensor([1, 2]), cache, 8, tcfg,
                   mesh={"tp": tp})
    assert calls["norm"] == (2 * L + 1) * tp


def test_a_tp_the_heads_do_not_divide_is_refused():
    """``tiny``'s 4 heads split at most 4 ways."""
    _, tcfg, _, tp_params = _tiny()
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError):
        TD.generate(tp_params, prompt, tcfg, 2, mesh={"tp": 8})


@pytest.mark.parametrize("mesh,match", [
    ({"tp": 2, "cp": 2}, "cp"), ({"pp": 2, "tp": 2}, "pp"),
    ({"ep": 2, "tp": 2}, "ep")])
def test_unported_axes_are_refused(mesh, match):
    _, tcfg, _, tp_params = _tiny()
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match=match):
        TD.generate(tp_params, prompt, tcfg, 2, mesh=mesh)


def test_moe_under_tp_is_refused():
    tcfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, num_experts=4)
    params = TT.init_params(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    with pytest.raises(NotImplementedError, match="experts"):
        TD.shard_params(params, tcfg, {"tp": 2})


def test_speculative_decoding_takes_sharded_params():
    """The speculative entry points take a ``ShardedParams`` for the
    target and the draft (both emulated at tp 2): greedy speculation
    keeps the target's greedy tokens, batched and at batch 1."""
    _, tcfg, _, tp_params = _tiny()
    draft = TT.init_params(torch.Generator().manual_seed(1), tcfg,
                           device="cpu")
    prompt = torch.from_numpy(np.random.RandomState(5).randint(
        0, 1024, size=(3, 6)))
    want = TD.generate(tp_params, prompt, tcfg, 8).tokens
    target, draft = (TD.shard_params(p, tcfg, {"tp": 2})
                     for p in (tp_params, draft))
    got = TD.speculative_generate_device(target, draft, prompt, tcfg, tcfg,
                                         8, num_speculative=3)
    assert torch.equal(got, want)
    got = TD.speculative_generate(target, draft, prompt[:1], tcfg, tcfg, 8,
                                  num_speculative=3)
    assert torch.equal(got, want[:1])


def test_a_dict_mesh_without_tp_is_the_unsharded_decode():
    """A mesh of data axes only replicates: the same bits as no mesh."""
    jcfg, tcfg, jp, tp_params = _tiny()
    prompt = torch.from_numpy(np.random.RandomState(4).randint(
        0, 1024, size=(2, 8)))
    want = TD.generate(tp_params, prompt, tcfg, 4)
    got = TD.generate(tp_params, prompt, tcfg, 4, mesh={"dp": 2})
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.logprobs, want.logprobs)
