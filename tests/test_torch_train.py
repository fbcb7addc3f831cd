"""tony_tpu_torch training vs the JAX package's.

The JAX ``tiny`` preset in f32, its parameters converted to torch through
numpy, and the same seeded token batches through both packages:

- ``lm_loss`` to 1e-5, and every leaf of its gradient to atol 1e-5 /
  rtol 1e-4 against ``jax.grad``, with remat on and off (the two must give
  the same gradient);
- a 5-step trajectory of ``make_train_step`` with
  ``default_optimizer(lr=1e-2, warmup_steps=2, total_steps=10)``, unfused
  and fused: per-step loss and grad_norm to rtol 1e-4; final params to
  atol 1e-5 for all but 1% of each leaf's elements and 1e-3 in relative
  L2 norm per leaf (f32, different summation orders, which Adam's
  per-element normalization magnifies where a gradient element is small);
- ``train_flops_per_token``, the same formula;
- the same three for an MoE config (4 experts, the aux loss in the loss),
  at the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import train as JTR
from tony_tpu.models import transformer as JT
from tony_tpu_torch.models import train as TR
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy
from tony_tpu_torch import tree_leaves

torch.set_num_threads(2)


def _setup(remat=True, **kw):
    jcfg = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=remat, **kw)
    tcfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=remat, **kw)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jax.device_get(jp)


def _batches(vocab, n, seed=0, b=2, s=32):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rs.randint(0, vocab, size=(b, s + 1)).astype(np.int32)
        out.append({"inputs": t[:, :s], "targets": t[:, 1:]})
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix[:-1]: np.asarray(tree)}


def _port_loss_and_grads(np_params, tcfg, batch):
    params = params_from_numpy(np_params, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = TT.lm_loss(params, _torch_batch(batch), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    flat = _flat({k: ({n: next(it) for n in v} if isinstance(v, dict)
                      else next(it)) for k, v in params.items()})
    return float(loss.detach()), flat


def _jax_loss_and_grads(**kw):
    jcfg, _, jp = _setup(**kw)
    batch = _batches(jcfg.vocab_size, 1)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jb, jcfg))(jp)
    return float(loss), _flat(jax.device_get(grads))


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    return _jax_loss_and_grads()


@pytest.fixture(scope="module")
def jax_moe_loss_and_grads():
    return _jax_loss_and_grads(num_experts=4)


def _check_loss_and_grads(remat, want_loss, want, **kw):
    jcfg, tcfg, jp = _setup(remat=remat, **kw)
    batch = _batches(jcfg.vocab_size, 1)[0]
    loss, got = _port_loss_and_grads(jp, tcfg, batch)
    assert abs(loss - want_loss) <= 1e-5
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_loss_and_every_gradient_leaf_match_jax(remat, jax_loss_and_grads):
    _check_loss_and_grads(remat, *jax_loss_and_grads)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_moe_loss_and_every_gradient_leaf_match_jax(remat,
                                                    jax_moe_loss_and_grads):
    """The aux loss comes back out of every checkpointed block."""
    _check_loss_and_grads(remat, *jax_moe_loss_and_grads, num_experts=4)


def test_remat_gives_the_same_gradient():
    jcfg, tcfg, jp = _setup(remat=True)
    batch = _batches(jcfg.vocab_size, 1, seed=1)[0]
    _, with_remat = _port_loss_and_grads(jp, tcfg, batch)
    _, without = _port_loss_and_grads(jp, tcfg.scaled(remat=False), batch)
    for name in with_remat:
        np.testing.assert_allclose(with_remat[name], without[name],
                                   atol=1e-6, rtol=1e-6, err_msg=name)


def test_unported_remat_policies_raise():
    """Every remat policy is ported: "dots" and "attn" train (their
    checkpointed forward gives the logits of inference, which checkpoints
    nothing; gradients against "full" and JAX in test_torch_cp.py), and
    only an unknown policy raises, at config time."""
    _, tcfg, jp = _setup(remat=True)
    params = params_from_numpy(jp, device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    for policy in ("dots", "attn"):
        cfg = tcfg.scaled(remat_policy=policy)
        with torch.no_grad():
            want = TT.forward(params, toks, cfg)[0]
        for t in tree_leaves(params):
            t.requires_grad_(True)
        try:
            got = TT.forward(params, toks, cfg)[0]
        finally:
            for t in tree_leaves(params):
                t.requires_grad_(False)
        torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="remat_policy"):
        tcfg.scaled(remat_policy="selective")


def _check_five_step_trajectory(fused, **kw):
    jcfg, tcfg, jp = _setup(**kw)
    batches = _batches(jcfg.vocab_size, 5, seed=2)
    opt_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, fused=fused)

    jopt = JTR.default_optimizer(**opt_kw)
    jstep = JTR.make_train_step(lambda p, b: JT.lm_loss(p, b, jcfg), jopt,
                                donate=False)
    jstate = JTR.init_state(jax.tree.map(jnp.asarray, jp), jopt)
    want = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(m["loss"]), float(m["grad_norm"])))

    opt = TR.default_optimizer(**opt_kw)
    step = TR.make_train_step(lambda p, b: TT.lm_loss(p, b, tcfg), opt)
    state = TR.init_state(params_from_numpy(jp, device="cpu"), opt)
    got = []
    for b in batches:
        state, m = step(state, _torch_batch(b))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    assert state["step"] == 5 and state["opt_state"]["count"] == 5
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    want_p = _flat(jax.device_get(jstate["params"]))
    got_p = _flat(state["params"])
    for name in want_p:
        # Adam divides each element's step by the root of its own second
        # moment, so where a gradient element is a small difference of
        # large terms, the two packages' f32 summation orders reach the
        # update at up to lr scale, and later steps carry it on (at most
        # 0.34% of a leaf's elements differ by more than 1e-5 here, one
        # embedding element by 6e-3): all but 1% of each leaf's elements
        # within 1e-5, and each leaf within 1e-3 in relative L2 norm
        diff = np.abs(got_p[name] - want_p[name])
        assert np.mean(diff > 1e-5) <= 0.01, (name, np.mean(diff > 1e-5))
        rel = np.linalg.norm(diff) / np.linalg.norm(want_p[name])
        assert rel <= 1e-3, (name, rel)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_five_step_trajectory_matches_jax(fused):
    _check_five_step_trajectory(fused)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_moe_five_step_trajectory_matches_jax(fused):
    _check_five_step_trajectory(fused, num_experts=4)


def test_eval_step_records_no_gradient():
    _, tcfg, jp = _setup()
    params = params_from_numpy(jp, device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    batch = _torch_batch(_batches(tcfg.vocab_size, 1)[0])
    loss = TR.make_eval_step(lambda p, b: TT.lm_loss(p, b, tcfg))(params,
                                                                  batch)
    assert not loss.requires_grad and loss.dim() == 0


@pytest.mark.parametrize("preset,kw", [("tiny", {}), ("small", {}),
                                       ("small", {"attn_window": 128}),
                                       ("base", {"n_kv_heads": 4}),
                                       ("small", {"num_experts": 8})])
def test_train_flops_per_token_matches_jax(preset, kw):
    jcfg = JT.PRESETS[preset].scaled(**kw)
    tcfg = TT.PRESETS[preset].scaled(**kw)
    for seq in (256, 1024):
        assert TT.train_flops_per_token(tcfg, seq) == \
            JT.train_flops_per_token(jcfg, seq)


def test_masked_cross_entropy_matches_jax():
    r = np.random.RandomState(3)
    logits = r.randn(2, 7, 50).astype(np.float32)
    targets = r.randint(0, 50, size=(2, 7)).astype(np.int32)
    targets[0, :3] = -1                                  # ignored positions
    want = JTR.masked_cross_entropy(jnp.asarray(logits),
                                    jnp.asarray(targets))
    got = TR.masked_cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(targets).long())
    assert abs(float(got) - float(want)) <= 1e-6
