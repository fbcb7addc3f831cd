"""tony_tpu_torch ResNet and its SGD vs the JAX package's and optax.

ResNet-50 in f32 with the JAX ``init_resnet`` tree (built once for the
module) converted through numpy, and seeded numpy images through both
packages on the CPU:

- ``"SAME"`` padding: ``_conv`` against ``lax.conv_general_dilated`` and
  ``_max_pool`` against ``lax.reduce_window`` at (H, k, s) in {(32, 7,
  2), (33, 7, 2), (16, 3, 2), (16, 1, 2)}, to 1e-5;
- ``forward`` at images of 32 and 33, batch 2, 10 classes, train and
  eval: the logits and every new statistic. Eval, and train at 33, to
  5e-4 of the largest logit and 1e-4 relative to each statistic's
  largest entry. Train at 32 is chaotic in the reference itself: stage
  3 runs at 1x1, so its batch norms see 2 values a channel, and the JAX
  forward moves its logits by up to 3 under a 1e-7 relative change of
  the input. There the port is held to twice that spread of the JAX
  forward (a 1e-7 relative perturbation, three draws), and the stem's
  to stage 2's statistics to the tight bound;
- ``classification_loss`` and every gradient leaf against
  ``jax.value_and_grad(..., has_aux=True)`` at 33 (batch 2) and 64
  (batch 4, where stage 3's norms see 16 values a channel): the loss to
  1e-5 relative at 33 and 5e-5 at 64 (where the reference's own loss
  moves by 2.2e-5 under a 1e-6 relative change of the images), the
  statistics to 1e-4; each gradient leaf in relative
  L2 within twice the JAX gradient's own change under a 1e-5 relative
  perturbation of the images (two draws), or 1e-3, and never above
  TRAIN_GRAD_CAP (10%) however far the reference moves. In training
  mode the reference's f32 gradient is noisy at every size tried (33 to
  96 px, batch 2 to 8): a perturbation of 1e-8, below one rounding of
  the images, moves its leaves by 1-3% in L2 (the median leaf), 1e-5 by
  9-16% (the largest); the head, read off the pooled features, moves by
  1e-4 or less. The port's leaves differ from it by 1.2-4% (the median
  leaf) and 1.5-5.5% (the largest) over these cases, the identity
  backward's by 70% and 400%. In eval mode (no coupling through the
  statistics) every leaf holds to 2e-3 of its largest entry, and one
  batch norm alone (training mode, its output, statistics and the
  gradients of x, scale and bias) to 1e-5;
- 3 steps of the JAX example's step (``optax.sgd(0.01, momentum=0.9,
  nesterov=True)``) against ``train_resnet.make_step``, each from the
  JAX run's state: losses at rtol 1e-4, new statistics to 1e-4, updates
  within the gradients' bound;
- :class:`SGD` alone against ``optax.sgd`` over 5 steps, with and
  without Nesterov, to 1e-7;
- the init's keys, shapes and dtypes against the JAX tree at depths 50,
  101 and 152, each conv leaf's std within 5% of He fan-out and the
  head's of ``in_c ** -0.5``;
- the weights' round trip bit for bit, f32 and bf16, with the JAX tree's
  ``tree_digest``;
- sync-BN in a gloo group of 2 (``tests/torch_dist_worker.py``, each
  rank half of a batch of 4 at 33): the loss, the new statistics and
  every gradient leaf against the JAX package's single-device step on
  the whole batch (the bounds above), and one batch norm alone to
  1e-5; an identity backward on the statistics' all-reduce, or
  rank-local statistics, misses those bounds;
- ``train_resnet --device cpu`` and the JAX example's data stream.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu.models import resnet as JR
from tony_tpu.serving.weightstore import tree_digest
from tony_tpu_torch import train_resnet
from tony_tpu_torch.models import resnet as TR
from tony_tpu_torch.models.train import SGD, value_and_grad
from tony_tpu_torch.models.weights import params_from_numpy, params_to_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_distributed as TD  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = 10
LOGIT_TOL = 5e-4     # of the largest logit
STAT_TOL = 1e-4      # of each statistic's largest entry
GRAD_TOL = 2e-3      # of each gradient leaf's largest entry
TRAIN_GRAD_CAP = 0.1  # relative L2 of a training-mode gradient leaf


def _jax_init(depth=50, dtype=jnp.float32, classes=CLASSES):
    init = jax.jit(lambda k: JR.init_resnet(k, depth, classes, dtype))
    return jax.device_get(init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_tree():
    return _jax_init()


@pytest.fixture(scope="module")
def port_tree(jax_tree):
    return tuple(params_from_numpy(t, device="cpu") for t in jax_tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            if isinstance(v, torch.Tensor):
                v = v.detach().float().numpy()
            out[prefix + k] = np.asarray(v)
    return out


def _images(n, size, seed):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


def _assert_rel(got: dict, want: dict, tol, what, skip=()):
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith(skip):
            continue
        scale = max(np.abs(want[k]).max(), 1e-30)
        err = np.abs(got[k] - want[k]).max() / scale
        assert err <= tol, (what, k, err)


# ---------------------------------------------------------------------------
# "SAME" padding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h,k,s", [(32, 7, 2), (33, 7, 2), (16, 3, 2),
                                   (16, 1, 2)])
def test_same_padding_conv_and_max_pool_match_lax(h, k, s):
    rs = np.random.RandomState(h * 100 + k)
    x = rs.randn(2, h, h + 1, 4).astype(np.float32)
    w = rs.randn(k, k, 4, 8).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = TR._conv(torch.from_numpy(x), torch.from_numpy(w), s)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, k, k, 1),
                                 (1, s, s, 1), "SAME")
    got = TR._max_pool(torch.from_numpy(x), k, s)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_same_padding_splits_as_xla():
    assert TR._same(224, 7, 2) == (2, 3)     # the stem
    assert TR._same(56, 3, 2) == (0, 1)      # a stage's first 3x3/2
    assert TR._same(112, 3, 2) == (0, 1)     # the max pool
    assert TR._same(56, 3, 1) == (1, 1)
    assert TR._same(56, 1, 2) == (0, 0)      # the projection
    assert TR._same(33, 7, 2) == (3, 3)


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------
_JAX_FORWARD = jax.jit(lambda p, s, x, train: JR.forward(p, s, x, 50, train),
                       static_argnums=3)


def _jax_forward(jp, js, x, train):
    return _JAX_FORWARD(jp, js, x, train)


def _port_forward(port_tree, x, train):
    with torch.no_grad():
        return TR.forward(*port_tree, torch.from_numpy(x), 50, train)


@pytest.mark.parametrize("size,train", [(33, True), (33, False),
                                        (32, False)])
def test_forward_matches_jax(jax_tree, port_tree, size, train):
    x = _images(2, size, seed=size)
    logits, stats = _jax_forward(*jax_tree, x, train)
    got, got_stats = _port_forward(port_tree, x, train)
    assert got.dtype == torch.float32 and got.shape == (2, CLASSES)
    scale = np.abs(np.asarray(logits)).max()
    assert np.abs(got.numpy() - np.asarray(logits)).max() <= \
        LOGIT_TOL * scale
    _assert_rel(_flat(got_stats), _flat(jax.device_get(stats)), STAT_TOL,
                "stats")


def test_forward_at_32_in_training_within_the_references_own_spread(
        jax_tree, port_tree):
    """Module docstring: stage 3's norms see 2 values a channel."""
    x = _images(2, 32, seed=32)
    logits, stats = _jax_forward(*jax_tree, x, True)
    rs = np.random.RandomState(7)
    spread = max(
        np.abs(np.asarray(_jax_forward(
            *jax_tree, (x * (1 + 1e-7 * rs.randn(*x.shape))).astype(
                np.float32), True)[0]) - np.asarray(logits)).max()
        for _ in range(3))
    got, got_stats = _port_forward(port_tree, x, True)
    assert np.abs(got.numpy() - np.asarray(logits)).max() <= 2 * spread
    _assert_rel(_flat(got_stats), _flat(jax.device_get(stats)), STAT_TOL,
                "stats", skip=("stage3",))


def _batch(n, size, seed):
    return {"image": _images(n, size, seed),
            "label": np.random.RandomState(seed + 1).randint(
                0, CLASSES, size=(n,)).astype(np.int32)}


_JAX_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(
    lambda p, s, b: JR.classification_loss(p, s, b, 50), has_aux=True))


def _jax_value_and_grad(jp, js, batch):
    return _JAX_VALUE_AND_GRAD(jp, js, batch)


def _l2(got: dict, want: dict) -> dict:
    """Each leaf's relative L2 error."""
    assert sorted(got) == sorted(want)
    return {k: np.linalg.norm(got[k] - want[k])
            / max(np.linalg.norm(want[k]), 1e-30) for k in want}


def _own_spread(jax_tree, batch, draws=2, eps=1e-5) -> dict:
    """Each gradient leaf's relative L2 change of the JAX step under an
    ``eps`` relative perturbation of the images (the most of ``draws``):
    how far f32 rounding alone moves the reference's gradient."""
    (_, _), grads = _jax_value_and_grad(*jax_tree, batch)
    want = _flat(jax.device_get(grads))
    rs = np.random.RandomState(11)
    out = {k: 0.0 for k in want}
    for _ in range(draws):
        image = batch["image"] * (1 + eps * rs.randn(*batch["image"].shape))
        (_, _), g = _jax_value_and_grad(
            *jax_tree, dict(batch, image=image.astype(np.float32)))
        for k, v in _l2(_flat(jax.device_get(g)), want).items():
            out[k] = max(out[k], v)
    return out


def _assert_within_spread(got: dict, want: dict, spread: dict, what):
    """Every leaf's relative L2 error within twice the reference's own
    spread, or 1e-3, and never above TRAIN_GRAD_CAP: a leaf the
    reference cannot pin down does not widen its bound past the cap."""
    for k, err in _l2(got, want).items():
        bound = min(TRAIN_GRAD_CAP, max(1e-3, 2 * spread[k]))
        assert err <= bound, (what, k, err, spread[k])


@pytest.mark.parametrize("n,size,loss_rtol", [(2, 33, 1e-5),
                                               (4, 64, 5e-5)])
def test_loss_and_every_gradient_leaf_match_jax(jax_tree, port_tree, n,
                                                size, loss_rtol):
    """Training mode. The loss to ``loss_rtol`` and the statistics to
    STAT_TOL; the gradients within twice the reference's own spread
    under a 1e-5 relative change of the images (the scale at which the
    two packages' f32 activations part), capped at TRAIN_GRAD_CAP
    (module docstring). At 64 px and batch 4 stage 3's norms see 16
    values a channel, twice what they see at 33 and batch 2; the
    reference is as noisy there: its loss moves by 1.2e-5 relative
    under a 1e-7 relative change of the images and by 2.2e-5 under
    1e-6, so the loss is held to 5e-5 there."""
    batch = _batch(n, size, seed=5)
    (loss, stats), grads = _jax_value_and_grad(*jax_tree, batch)
    (got_loss, got_stats), got = value_and_grad(
        TR.classification_loss, *port_tree,
        {k: torch.from_numpy(v) for k, v in batch.items()}, 50,
        has_aux=True)
    np.testing.assert_allclose(float(got_loss), float(loss),
                               rtol=loss_rtol)
    _assert_rel(_flat(got_stats), _flat(jax.device_get(stats)), STAT_TOL,
                "stats")
    _assert_within_spread(_flat(got), _flat(jax.device_get(grads)),
                          _own_spread(jax_tree, batch), "grad")


def test_every_gradient_leaf_matches_jax_in_eval_mode(jax_tree,
                                                      port_tree):
    """With the stored statistics the rows do not couple, and every leaf
    holds to GRAD_TOL of its largest entry."""
    batch = _batch(2, 33, seed=6)

    def jloss(p, s, b):
        logits, _ = JR.forward(p, s, b["image"], 50, train=False)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, b["label"][:, None], -1).mean()

    loss, grads = jax.jit(jax.value_and_grad(jloss))(*jax_tree, batch)

    def tloss(p, s, b):
        logits, _ = TR.forward(p, s, b["image"], 50, train=False)
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, b["label"][:, None].long())[:, 0].mean()

    got_loss, got = value_and_grad(
        tloss, *port_tree, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    _assert_rel(_flat(got), _flat(jax.device_get(grads)), GRAD_TOL, "grad")


def _bn_problem(seed, n=4, dtype=np.float32):
    rs = np.random.RandomState(seed)
    c = 8
    return (rs.randn(n, 5, 5, c).astype(dtype) * 3 + 1,
            {"scale": (1 + 0.1 * rs.randn(c)).astype(dtype),
             "bias": (0.1 * rs.randn(c)).astype(dtype)},
            {"mean": (0.1 * rs.randn(c)).astype(np.float32),
             "var": (1 + 0.1 * rs.rand(c)).astype(np.float32)},
            rs.randn(n, 5, 5, c).astype(np.float32))


def _jax_bn(x, p, s, cot):
    """The JAX ``_batch_norm``'s output, new statistics and the VJP of
    ``sum(y · cot)`` with respect to x, scale and bias."""
    def f(x, p):
        y, new = JR._batch_norm(x, p, s, True)
        return (y.astype(jnp.float32) * cot).sum(), (y, new)
    (_, (y, new)), (gx, gp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(x, p)
    return jax.device_get((y, new, {"x": gx, **gp}))


def test_batch_norm_training_forward_and_gradient_match_jax():
    x, p, s, cot = _bn_problem(0)
    y, new, grads = _jax_bn(x, p, s, cot)
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    ty, tnew = TR._batch_norm(tx, tp, params_from_numpy(s, device="cpu"),
                              True)
    got = dict(zip(("x", "scale", "bias"), torch.autograd.grad(
        (ty * torch.from_numpy(cot)).sum(), [tx, tp["scale"], tp["bias"]])))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y),
                               atol=1e-5)
    _assert_rel(_flat(tnew), _flat(new), 1e-6, "stats")
    _assert_rel(_flat(got), _flat(grads), 1e-5, "grad")
    # the biased variance, moved by 0.9 · old + 0.1 · batch
    np.testing.assert_allclose(
        tnew["var"].numpy(), 0.9 * s["var"] + 0.1 * x.var(axis=(0, 1, 2)),
        rtol=1e-5)


def test_three_sgd_nesterov_steps_match_optax(jax_tree):
    """The JAX example's step (``optax.sgd(0.01, momentum=0.9,
    nesterov=True)``) against ``train_resnet.make_step``, teacher-forced:
    each port step starts from the JAX run's params, statistics and
    trace. Each step's loss at rtol 1e-4 and new statistics to STAT_TOL;
    each leaf's update (new params minus old, the trace's too) within
    the gradients' bound (twice the reference's own spread, capped at
    TRAIN_GRAD_CAP).
    (Run freely, the two trajectories part at the reference's own rate:
    a 1e-6 relative change of the images moves its second loss by 0.36
    at lr 1e-4, the gradient's norm being ~5e3 at init.)"""
    batches = [_batch(2, 33, seed=10 + i) for i in range(3)]
    opt = optax.sgd(0.01, momentum=0.9, nesterov=True)

    @jax.jit
    def jstep(params, stats, opt_state, batch):
        (loss, stats), grads = jax.value_and_grad(
            lambda p: JR.classification_loss(p, stats, batch, 50),
            has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, loss

    topt = SGD(0.01, momentum=0.9, nesterov=True)
    step = train_resnet.make_step(topt, 50, torch.float32)
    jp, js = jax_tree
    jo = opt.init(jp)
    for i, b in enumerate(batches):
        state = {"params": params_from_numpy(jp, device="cpu"),
                 "stats": params_from_numpy(js, device="cpu"),
                 "opt_state": {"count": i, "trace": params_from_numpy(
                     jax.device_get(jo[0].trace), device="cpu")},
                 "step": i}
        old_p, old_t = _flat(jax.device_get(jp)), _flat(
            jax.device_get(jo[0].trace))
        spread = _own_spread((jp, js), b)
        jp, js, jo, loss = jstep(jp, js, jo, b)
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        assert state["step"] == i + 1 and state["opt_state"]["count"] == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(loss), rtol=1e-4)
        _assert_rel(_flat(state["stats"]), _flat(jax.device_get(js)),
                    STAT_TOL, "stats")
        for got, want, old in (
                (state["params"], jp, old_p),
                (state["opt_state"]["trace"], jo[0].trace, old_t)):
            want = {k: v - old[k] for k, v in _flat(
                jax.device_get(want)).items()}
            got = {k: v - old[k] for k, v in _flat(got).items()}
            _assert_within_spread(got, want, spread, "update")


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nesterov", [True, False])
def test_sgd_matches_optax(nesterov):
    rs = np.random.RandomState(3)
    tree = {"a": rs.randn(64, 32).astype(np.float32),
            "b": {"c": rs.randn(7).astype(np.float32)}}
    grads = [jax.tree.map(lambda v: rs.randn(*v.shape).astype(np.float32),
                          tree) for _ in range(5)]
    opt = optax.sgd(0.05, momentum=0.9, nesterov=nesterov)
    jp, js = tree, opt.init(tree)
    topt = SGD(0.05, momentum=0.9, nesterov=nesterov)
    tp = params_from_numpy(tree, device="cpu")
    ts = topt.init(tp)
    for g in grads:
        u, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts, gnorm = topt.apply(params_from_numpy(g, device="cpu"), ts,
                                   tp)
        np.testing.assert_allclose(float(gnorm),
                                   float(optax.global_norm(g)), rtol=1e-6)
    assert ts["count"] == 5
    for k, v in _flat(jax.device_get(jp)).items():
        np.testing.assert_allclose(_flat(tp)[k], v, atol=1e-7, rtol=0)


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("depth", [50, 101, 152])
def test_init_tree_matches_jax(depth):
    want = jax.eval_shape(lambda k: JR.init_resnet(k, depth, CLASSES,
                                                   jnp.bfloat16),
                          jax.random.PRNGKey(0))
    got = TR.init_resnet(torch.Generator().manual_seed(0), depth, CLASSES,
                         torch.bfloat16, device="cpu")
    for g, w in zip(got, want):
        fw = {k: v for k, v in _flat_shapes(w)}
        fg = {k: v for k, v in _flat_shapes(g)}
        assert fg == fw
    if depth != 50:
        return
    for name, leaf in _flat(got[0]).items():
        if leaf.ndim == 4:
            fan_out = leaf.shape[0] * leaf.shape[1] * leaf.shape[3]
            assert abs(leaf.std() / (2.0 / fan_out) ** 0.5 - 1) < 0.05, name
    head = _flat(got[0])["head/w"]
    assert abs(head.std() * head.shape[0] ** 0.5 - 1) < 0.05
    with pytest.raises(ValueError, match="unsupported depth"):
        TR.init_resnet(torch.Generator(), 34, device="cpu")


def _flat_shapes(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_shapes(v, f"{prefix}{k}/")
        else:
            dtype = str(v.dtype).replace("torch.", "")
            yield prefix + k, (tuple(v.shape), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_round_trip_and_digest(jax_tree, dtype):
    tree = _jax_init(dtype=jnp.dtype(dtype)) if dtype == "bfloat16" \
        else jax_tree
    for part in tree:
        converted = params_from_numpy(part, device="cpu")
        back = params_to_numpy(converted, bf16_dtype=jnp.bfloat16)
        want, got = _flat_np(part), _flat_np(back)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k].view(np.uint8),
                                          want[k].view(np.uint8))
        assert tree_digest(back) == tree_digest(part)
    cast = params_from_numpy(jax_tree[0], device="cpu",
                             dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in _leaves(cast))


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# sync-BN across processes
# ---------------------------------------------------------------------------
def test_sync_batch_norm_in_a_gloo_group_matches_the_whole_batch(
        jax_tree, tmp_path):
    batch = _batch(4, 33, seed=21)
    bn_x, bn_p, bn_s, bn_cot = _bn_problem(1)

    def setup(case):
        return None, None, {"params": jax_tree[0], "stats": jax_tree[1],
                            "bn": {"p": bn_p, "s": bn_s}}, \
            dict({k: v[None] for k, v in batch.items()}, bn_x=bn_x,
                 bn_cot=bn_cot)

    case = TD.Case("resnet_dp2", 2, {"dp": 2}, model="resnet",
                   kw={"depth": 50})
    ranks = TD.run_group([case], 2, tmp_path, setup=setup)[case.name]
    (loss, stats), grads = _jax_value_and_grad(*jax_tree, batch)
    want_g = _flat(jax.device_get(grads))
    want_s = _flat(jax.device_get(stats))
    spread = _own_spread(jax_tree, batch)
    y, new, bn_grads = _jax_bn(bn_x, bn_p, bn_s, bn_cot)
    bn_want = {"y": np.asarray(y), "stats": _flat(new),
               "grad": _flat(bn_grads)}

    def part(out, prefix):
        return ({k[len(prefix) + 1:]: v for k, v in out.items()
                 if k.startswith(prefix + "/")})

    def bn_check(out, prefix, rank):
        rows = slice(2 * rank, 2 * rank + 2)
        np.testing.assert_allclose(out[f"{prefix}/bn/y"],
                                   bn_want["y"][rows], atol=1e-5)
        _assert_rel(part(out, f"{prefix}/bn/stats"), bn_want["stats"], 1e-6,
                    "stats")
        got = part(out, f"{prefix}/bn/grad")
        _assert_rel(got, dict(bn_want["grad"], x=bn_want["grad"]["x"][rows]),
                    1e-5, "grad")

    for rank, out in enumerate(ranks):
        np.testing.assert_allclose(float(out["sync/loss"]), float(loss),
                                   rtol=1e-5)
        _assert_rel(part(out, "sync/stats"), want_s, STAT_TOL, "stats")
        _assert_within_spread(part(out, "sync/grad"), want_g, spread,
                              "grad")
        bn_check(out, "sync", rank)
        # an identity backward: the forward is right, the gradients of
        # everything below a norm are not
        np.testing.assert_allclose(float(out["identity/loss"]),
                                   float(loss), rtol=1e-5)
        with pytest.raises(AssertionError, match="'grad', 'x'"):
            bn_check(out, "identity", rank)
        with pytest.raises(AssertionError, match="grad"):
            _assert_within_spread(part(out, "identity/grad"), want_g,
                                  spread, "grad")
        # rank-local statistics: the data-parallel step of local BN
        with pytest.raises(AssertionError):
            bn_check(out, "local", rank)
        with pytest.raises(AssertionError, match="stats"):
            _assert_rel(part(out, "local/stats"), want_s, STAT_TOL,
                        "stats")


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
def _example_module():
    path = os.path.join(REPO, "examples", "resnet", "train_resnet.py")
    spec = importlib.util.spec_from_file_location("_jax_train_resnet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_batches_equal_the_examples():
    want = _example_module().synthetic_batches(3, 2, 16, CLASSES)
    got = train_resnet.synthetic_batches(3, 2, 16, CLASSES)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_train_resnet_cli_on_the_cpu(capsys):
    assert train_resnet.main(["--device", "cpu", "--steps", "3",
                              "--batch_size", "2", "--image_size", "33",
                              "--num_classes", "10", "--lr", "0.01"]) == 0
    out = capsys.readouterr().out
    assert "] devices=1 mesh={'dp': 1}" in out
    assert "step 0 loss" in out and "step 2 loss" in out
    assert "images/s" in out and "done: final loss" in out


def test_train_resnet_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_resnet.main(["--steps", "1"])
