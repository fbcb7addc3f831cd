"""tony_tpu_torch BERT vs the JAX package's.

``BERT_TINY`` in f32, the JAX ``init_params`` converted to torch through
numpy, and the same seeded MLM batches through both packages:

- ``forward`` logits to atol 1e-4, with and without ``type_ids``;
- ``mlm_loss`` and every leaf of its gradient against
  ``jax.value_and_grad`` (rtol 1e-4, atol 1e-6 for entries near 0);
- a 3-step trajectory of ``make_train_step`` + ``default_optimizer``:
  losses and grad norms to rtol 1e-4, final params as in
  ``tests/test_torch_train.py`` (all but 1% of each leaf within 1e-5,
  each leaf within 1e-3 in relative L2 norm);
- the tree's keys, shapes and dtypes, its bit-exact round trip and
  ``tree_digest`` across packages, f32 and bf16;
- ``synthetic_mlm_batches`` equal to the JAX example's, and the
  ``pretrain_bert`` CLI on the CPU (and raising without a card).
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import bert as JB
from tony_tpu.models import train as JTR
from tony_tpu.serving.weightstore import tree_digest
from tony_tpu_torch import pretrain_bert, tree_leaves
from tony_tpu_torch.models import bert as TB
from tony_tpu_torch.models import train as TR
from tony_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from tony_tpu_torch.parallel.sharding import param_shardings

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = dataclasses.replace(JB.BERT_TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(TB.BERT_TINY, dtype=torch.float32)
B, S = 2, 32


@pytest.fixture(scope="module")
def jax_params():
    return _jax_init(JCFG)


def _jax_init(cfg):
    init = jax.jit(JB.init_params, static_argnums=1)
    return jax.device_get(init(jax.random.PRNGKey(0), cfg))


def _batches(n, seed=0, type_ids=False):
    src = pretrain_bert.synthetic_mlm_batches(seed, B, S, TCFG)
    rs = np.random.RandomState(seed + 100)
    out = []
    for _ in range(n):
        b = next(src)
        if type_ids:
            b["type_ids"] = rs.randint(0, 2, size=(B, S)).astype(np.int32)
        out.append(b)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("type_ids", [False, True],
                         ids=["no_type_ids", "type_ids"])
def test_forward_logits_match_jax(jax_params, type_ids):
    batch = _batches(1, seed=1, type_ids=type_ids)[0]
    tt = batch.get("type_ids")
    fwd = jax.jit(JB.forward, static_argnums=2)
    want = fwd(jax_params, jnp.asarray(batch["tokens"]), JCFG,
               None if tt is None else jnp.asarray(tt))
    params = params_from_numpy(jax_params, device="cpu")
    with torch.no_grad():
        got = TB.forward(params, torch.from_numpy(batch["tokens"]), TCFG,
                         None if tt is None else torch.from_numpy(tt))
    assert got.dtype == torch.float32 and got.shape == (B, S, TCFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("type_ids", [False, True],
                         ids=["no_type_ids", "type_ids"])
def test_loss_and_every_gradient_leaf_match_jax(jax_params, type_ids):
    batch = _batches(1, seed=2, type_ids=type_ids)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JB.mlm_loss(p, jb, JCFG)))(jax_params)
    want = _flat(jax.device_get(grads))

    params = params_from_numpy(jax_params, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    got_loss = TB.mlm_loss(params, _torch_batch(batch), TCFG)
    tgrads = torch.autograd.grad(got_loss, leaves, allow_unused=True)
    got = {}
    for (name, leaf), g in zip(_flat(params).items(), tgrads):
        got[name] = np.zeros_like(leaf) if g is None else g.numpy()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=1e-4)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_three_step_trajectory_matches_jax(jax_params):
    batches = _batches(3, seed=3)
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)

    jopt = JTR.default_optimizer(**opt_kw)
    jstep = JTR.make_train_step(lambda p, b: JB.mlm_loss(p, b, JCFG), jopt,
                                donate=False)
    jstate = JTR.init_state(jax.tree.map(jnp.asarray, jax_params), jopt)
    want = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(m["loss"]), float(m["grad_norm"])))

    opt = TR.default_optimizer(**opt_kw)
    step = TR.make_train_step(lambda p, b: TB.mlm_loss(p, b, TCFG), opt)
    state = TR.init_state(params_from_numpy(jax_params, device="cpu"), opt)
    got = []
    for b in batches:
        state, m = step(state, _torch_batch(b))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    want_p = _flat(jax.device_get(jstate["params"]))
    got_p = _flat(state["params"])
    assert sorted(got_p) == sorted(want_p)
    for name in want_p:
        diff = np.abs(got_p[name] - want_p[name])
        assert np.mean(diff > 1e-5) <= 0.01, (name, np.mean(diff > 1e-5))
        rel = np.linalg.norm(diff) / max(np.linalg.norm(want_p[name]), 1e-30)
        assert rel <= 1e-3, (name, rel)


_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_keys_shapes_dtypes_round_trip_and_digest(dtype):
    jcfg = dataclasses.replace(JB.BERT_TINY, dtype=jnp.dtype(dtype))
    tree = _jax_init(jcfg)
    converted = params_from_numpy(tree, device="cpu")
    own = TB.init_params(torch.Generator().manual_seed(0),
                         dataclasses.replace(TB.BERT_TINY,
                                             dtype=_TORCH_DTYPE[dtype]),
                         device="cpu")
    want = _flat(tree)
    for t in (converted, own):
        got = dict(_named_leaves(t))
        assert got.keys() == want.keys()
        for name, a in want.items():
            assert tuple(got[name].shape) == a.shape, name
            assert got[name].dtype == _TORCH_DTYPE[a.dtype.name], name
    back = params_to_numpy(converted, bf16_dtype=jnp.bfloat16)
    for name, a in want.items():
        b = _flat(back)[name]
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert tree_digest(back) == tree_digest(tree)


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _example_module():
    path = os.path.join(REPO, "examples", "bert", "pretrain_bert.py")
    spec = importlib.util.spec_from_file_location("_jax_pretrain_bert", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_mlm_batches_equal_the_examples():
    ex = _example_module()
    assert pretrain_bert.MASK_FRACTION == ex.MASK_FRACTION
    want = ex.synthetic_mlm_batches(1000, 3, 40, JB.BERT_TINY)
    got = pretrain_bert.synthetic_mlm_batches(1000, 3, 40, TB.BERT_TINY)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_unported_sharding_arguments_raise(jax_params):
    params = params_from_numpy(jax_params, device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.int32)
    # dp, fsdp, tp and ep are ported; cp and pp still raise
    for axis in ("cp", "pp"):
        with pytest.raises(NotImplementedError):
            TB.forward(params, toks, TCFG, mesh={"fsdp": 1, axis: 2})
        with pytest.raises(NotImplementedError):
            TB.mlm_loss(params, {"tokens": toks, "targets": toks}, TCFG,
                        mesh={axis: 2})
    # BERT has no experts: on an ep axis every parameter replicates
    shardings = param_shardings(TB.logical_axes(TCFG), {"ep": 2})
    assert all(e is None for s in tree_leaves(shardings) for e in s.spec)


def test_pretrain_bert_cli_on_the_cpu(capsys):
    assert pretrain_bert.main(["--device", "cpu", "--config", "tiny",
                               "--steps", "3", "--batch_size", "2",
                               "--seq_len", "32"]) == 0
    out = capsys.readouterr().out
    assert "step 0 mlm loss" in out and "step 2 mlm loss" in out
    assert "done: final loss" in out and "tok/s" in out


def test_pretrain_bert_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_bert.main(["--config", "tiny", "--steps", "1"])
