"""tony_tpu_torch's meshes, sharding rules and task runtime vs the JAX
package's, with no process group.

- ``mesh_layout`` / ``hybrid_mesh_layout`` give the axis names and shape
  of the JAX package's ``make_mesh`` / ``make_hybrid_mesh`` on the
  conftest's 8 virtual CPU devices (the twins of
  ``tests/test_parallel.py::TestMesh`` and ``TestHybridMesh``: explicit,
  inferred and default axes, the canonical order, the errors);
  ``parse_mesh_string`` and the presets are the same;
- ``logical_to_spec`` resolves every leaf of both models' logical axes
  (the LM with MHA and GQA, BERT) as JAX's does on four meshes, and the
  port's logical-axis trees equal the JAX package's; specs become
  DTensor placements in mesh order;
- ``task_info``, ``mesh_axes``, ``mesh_dcn_axes`` and ``slice_info``
  against ``tony_tpu.runtime``'s under the jax arm's and the pytorch
  arm's environment; the env names equal ``tony_tpu.constants``'s;
- ``tp_kv_heads`` against a brute-force check of the kernels' GQA rule,
  and the local-shard layout's refusals (cp, pp, ep; rules that split
  the residual stream).
"""

import dataclasses

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import tony_tpu.runtime as jrt
from tony_tpu import constants as jconst
from tony_tpu.models import bert as JB
from tony_tpu.models import transformer as JT
from tony_tpu.parallel import mesh as JM
from tony_tpu.parallel import sharding as JS
import tony_tpu_torch.runtime as rt
from tony_tpu_torch import constants
from tony_tpu_torch.models import bert as TB
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.ops.attention import tp_kv_heads
from tony_tpu_torch.parallel import mesh as PM
from tony_tpu_torch.parallel import sharding as PS
from tony_tpu_torch.parallel import spmd

torch.set_num_threads(2)


def _jax_layout(mesh):
    return tuple(mesh.axis_names), tuple(mesh.devices.shape)


# -- meshes --------------------------------------------------------------

@pytest.mark.parametrize("axes,order", [
    ({"dp": 2, "tp": 4}, None),
    ({"dp": -1, "tp": 2}, None),
    (None, None),
    ({}, None),
    ({"tp": 2, "pp": 2, "dp": 2}, None),
    ({"fsdp": 0}, None),
    ({"tp": 2, "dp": 2, "fsdp": 2}, None),
    ({"dp": 2, "custom": 4}, None),
    ({"dp": 2, "tp": 4}, ("tp", "dp")),
], ids=["explicit", "inferred", "default", "empty", "canonical_order",
        "zero_inferred", "three_axes", "custom_axis", "axis_order"])
def test_mesh_layout_matches_jax(axes, order):
    want = _jax_layout(JM.make_mesh(axes, axis_order=order))
    assert PM.mesh_layout(axes, 8, order) == want


@pytest.mark.parametrize("axes", [{"dp": 3}, {"dp": -1, "tp": -1},
                                  {"dp": -1, "tp": 3}])
def test_mesh_layout_errors_match_jax(axes):
    with pytest.raises(ValueError) as jerr:
        JM.make_mesh(axes)
    with pytest.raises(ValueError) as terr:
        PM.mesh_layout(axes, 8)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("ici,dcn", [
    ({"tp": 2, "fsdp": 2}, {"dp": 2}),
    ({"tp": -1}, {"dp": 2}),
    ({"dp": 8}, {}),
    ({}, {"dp": 2}),
    ({}, {"fsdp": 2, "dp": 2}),
], ids=["dcn_major", "ici_inference", "no_dcn", "default_name",
        "two_dcn_axes"])
def test_hybrid_mesh_layout_matches_jax(ici, dcn):
    want = _jax_layout(JM.make_hybrid_mesh(ici, dcn))
    assert PM.hybrid_mesh_layout(ici, dcn, 8) == want


@pytest.mark.parametrize("ici,dcn,match", [
    ({"tp": 4}, {"dp": -1}, "explicit"),
    ({"tp": 4}, {"dp": 3}, "do not split"),
    ({"dp": 4}, {"dp": 2}, "both"),
    ({"tp": 3}, {"dp": 2}, "require"),
])
def test_hybrid_mesh_layout_errors_match_jax(ici, dcn, match):
    with pytest.raises(ValueError, match=match) as jerr:
        JM.make_hybrid_mesh(ici, dcn)
    with pytest.raises(ValueError, match=match) as terr:
        PM.hybrid_mesh_layout(ici, dcn, 8)
    assert str(terr.value) == str(jerr.value)


def test_parse_mesh_string_and_presets_match_jax():
    for spec in ("dp=2, tp=4", "", "fsdp=-1", "pp=2,dp=-1"):
        assert PM.parse_mesh_string(spec) == JM.parse_mesh_string(spec)
    for bad in ("dp", "dp=2,tp"):
        with pytest.raises(ValueError):
            PM.parse_mesh_string(bad)
    assert PM.AXIS_ORDER == JM.AXIS_ORDER
    assert PM.PRESETS.keys() == JM.PRESETS.keys()
    for name, fn in PM.PRESETS.items():
        args = (2,) * fn.__code__.co_argcount
        assert fn(*args) == JM.PRESETS[name](*args), name


# -- sharding rules ------------------------------------------------------

MESHES = [{"dp": 8}, {"fsdp": 8}, {"dp": 2, "fsdp": 2, "tp": 2},
          {"fsdp": 4, "tp": 2}]


def _leaves(tree, prefix=""):
    if PS.is_axes_leaf(tree):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _leaves(v, f"{prefix}/{k}")


def _spec_tuple(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _model_axes():
    return [
        ("lm_mha", TT.logical_axes(TT.PRESETS["tiny"]),
         JT.logical_axes(JT.PRESETS["tiny"])),
        ("lm_gqa", TT.logical_axes(TT.PRESETS["tiny"].scaled(n_kv_heads=2)),
         JT.logical_axes(JT.PRESETS["tiny"].scaled(n_kv_heads=2))),
        ("bert", TB.logical_axes(TB.BERT_TINY),
         JB.logical_axes(JB.BERT_TINY)),
    ]


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
def test_every_param_leaf_resolves_as_jax(axes):
    jmesh = JM.make_mesh(axes)
    for model, taxes, jaxes in _model_axes():
        tleaves, jleaves = dict(_leaves(taxes)), dict(_leaves(jaxes))
        assert tleaves == jleaves, model
        for path, logical in tleaves.items():
            want = _spec_tuple(JS.logical_to_spec(logical, jmesh))
            assert PS.logical_to_spec(logical, axes) == want, (model, path)
    for logical in (("batch", "seq", "embed"), ("batch", "seq", "heads",
                                                "kv"),
                    ("batch", "seq", "mlp"), ("batch", "seq", "vocab"),
                    ("nonesuch",), ("embed", "mlp")):
        want = _spec_tuple(JS.logical_to_spec(logical, jmesh))
        assert PS.logical_to_spec(logical, axes) == want, logical


def test_param_shardings_give_each_leaf_its_spec_and_placements():
    mesh = {"fsdp": 2, "tp": 2}
    axes = TT.logical_axes(TT.PRESETS["tiny"])
    got = PS.param_shardings(axes, mesh)
    assert got["blocks"]["wq"].spec == (None, "fsdp", "tp", None)
    assert got["blocks"]["wq"].placements == [Shard(1), Shard(2)]
    assert got["embed"].placements == [Shard(1), Shard(0)]
    assert got["final_norm"].placements == [Replicate(), Replicate()]
    for path, logical in _leaves(axes):
        node = got
        for k in path.strip("/").split("/"):
            node = node[k]
        assert node.spec == PS.logical_to_spec(logical, mesh), path


def test_spec_placements_follow_mesh_order():
    mesh = {"dp": 2, "fsdp": 2, "tp": 2}
    spec = PS.logical_to_spec(("batch", "seq", "vocab"), mesh)
    assert spec == (("dp", "fsdp"), None, "tp")
    assert PS.spec_placements(spec, mesh) == [Shard(0), Shard(0), Shard(2)]
    assert PS.spec_placements(PS.logical_to_spec(("embed", "mlp"), mesh),
                              mesh) == [Replicate(), Shard(0), Shard(1)]
    # a dimension split over axes against the mesh order is refused
    with pytest.raises(NotImplementedError):
        PS.spec_placements((("fsdp", "dp"),), mesh)


def test_layout_refuses_unported_axes_and_rules():
    for axis in ("cp", "pp", "ep"):
        with pytest.raises(NotImplementedError):
            spmd.Layout({"dp": 2, axis: 2})
    rules = dict(PS.DEFAULT_RULES)
    with pytest.raises(NotImplementedError, match="one mesh axis"):
        spmd.Layout({"dp": 2, "tp": 2}, tuple({**rules,
                                                "mlp": None}.items()))
    with pytest.raises(NotImplementedError, match="embed"):
        spmd.Layout({"dp": 2, "tp": 2}, tuple({**rules,
                                                "embed": "tp"}.items()))


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (4, 1), (8, 2), (8, 8),
                                  (16, 2), (8, 1)])
def test_tp_kv_heads_give_the_kernels_rule_the_global_pairs(h, kv):
    for size in (1, 2, 4, 8):
        if h % size or (kv % size and size % kv):
            with pytest.raises(ValueError):
                tp_kv_heads(h, kv, 0, size)
            continue
        hl = h // size
        for rank in range(size):
            lo, hi = tp_kv_heads(h, kv, rank, size)
            kvl = hi - lo
            assert hl % kvl == 0
            for i in range(hl):       # the kernel reads i // (hl / kvl)
                g = rank * hl + i
                assert lo + i // (hl // kvl) == g // (h // kv)


# -- runtime -------------------------------------------------------------

JAX_ARM = {
    "JOB_NAME": "worker", "TASK_INDEX": "1", "TASK_NUM": "2",
    "SESSION_ID": "3", "ATTEMPT_NUMBER": "1",
    "CLUSTER_SPEC": '{"worker": ["h:1", "h:2"]}',
    "TONY_JAX_COORDINATOR_ADDRESS": "h:1", "TONY_JAX_PROCESS_ID": "1",
    "TONY_JAX_NUM_PROCESSES": "2",
    "TONY_MESH_SPEC": '{"axes": {"fsdp": -1}, "dcn_axes": {"dp": 2}}',
    "TONY_SLICE_ID": "1", "TONY_NUM_SLICES": "2",
}
PYTORCH_ARM = {
    "JOB_NAME": "worker", "TASK_INDEX": "1", "TASK_NUM": "2",
    "SESSION_ID": "0", "ATTEMPT_NUMBER": "0",
    "CLUSTER_SPEC": '{"worker": ["h:1", "h:2"]}',
    "INIT_METHOD": "tcp://h:1", "RANK": "1", "WORLD": "2",
}
ALL_VARS = set(JAX_ARM) | set(PYTORCH_ARM)


@pytest.mark.parametrize("arm", ["jax", "pytorch"])
def test_task_info_matches_the_jax_runtime(arm, monkeypatch):
    for k in ALL_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in (JAX_ARM if arm == "jax" else PYTORCH_ARM).items():
        monkeypatch.setenv(k, v)
    want, got = jrt.task_info(), rt.task_info()
    for f in dataclasses.fields(want):
        if arm == "pytorch" and f.name in ("process_id", "num_processes"):
            continue    # the JAX runtime reads only the jax arm's ids
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert rt.mesh_axes() == jrt.mesh_axes()
    assert rt.mesh_dcn_axes() == jrt.mesh_dcn_axes()
    assert rt.slice_info() == jrt.slice_info()
    assert got.framework == arm
    if arm == "jax":
        assert got.init_method == "tcp://h:1"
    else:
        assert (got.process_id, got.num_processes) == (1, 2)
        assert got.init_method == "tcp://h:1"
        assert got.is_distributed


def test_local_rank_numbers_the_cards_of_a_host(monkeypatch):
    monkeypatch.setenv("TONY_JAX_PROCESS_ID", "5")
    monkeypatch.setenv("TONY_JAX_NUM_PROCESSES", "8")
    assert rt.local_rank(rt.task_info(), 4) == 1
    assert rt.local_rank(rt.task_info(), 1) == 0


def test_pytorch_arm_refuses_a_mesh_beyond_dp(monkeypatch):
    for k in ALL_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("INIT_METHOD", "tcp://127.0.0.1:1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD", "1")
    monkeypatch.setattr(rt, "initialize", lambda device=None: rt.task_info())
    with pytest.raises(ValueError, match="dp mesh only"):
        rt.mesh({"fsdp": 2}, device="cpu")


def test_env_names_equal_the_jax_package_constants():
    names = [n for n in dir(constants) if n.isupper()]
    assert len(names) == 15
    for n in names:
        assert getattr(constants, n) == getattr(jconst, n), n
