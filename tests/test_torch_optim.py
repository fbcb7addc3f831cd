"""tony_tpu_torch optimizers vs the JAX package's and optax.

``FusedAdamW`` (its plain arm: the leaves lie on the CPU) against the JAX
``FusedAdamW.fused_apply`` (Pallas interpret mode) and against
``optax.chain(clip_by_global_norm(1.0), adamw(..., mu_dtype=f32))`` over
tests/test_ops.py's parameter tree, 6 steps with a clip on step 2: params
to 2e-6 absolute and the global norm to 1e-5 relative (the JAX test's
limits). ``default_optimizer(fused=False)`` — optax's semantics written
out in torch — against the optax chain it mirrors, its schedule included
(lr at each count to 1e-7 relative). Gradients come from a seeded numpy
generator and go to every side.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu.ops.optim import FusedAdamW as JaxFusedAdamW
from tony_tpu_torch.models import train as TR
from tony_tpu_torch.ops import optim as O

torch.set_num_threads(2)


def _tree(seed=3):
    r = np.random.RandomState(seed)
    return {"big": (r.randn(512, 128) * 0.1).astype(np.float32),
            "proj": (r.randn(520, 8, 64) * 0.1).astype(np.float32),
            "w": (r.randn(4, 128) * 0.1).astype(np.float32),
            "norm": np.ones(256, np.float32),
            "odd": (r.randn(5) * 0.1).astype(np.float32)}


def _grads(tree, r, step):
    scale = 40.0 if step == 2 else 0.3       # step 2 triggers the clip
    return {k: (r.randn(*v.shape) * scale).astype(np.float32)
            for k, v in tree.items()}


def _torch_tree(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _optax_chain(sched, mu_dtype=None):
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(sched, weight_decay=0.01,
                                   mu_dtype=mu_dtype))


def _run_optax(chain, params, grads_seq):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = chain.init(p)
    out = []
    for g in grads_seq:
        g = {k: jnp.asarray(v) for k, v in g.items()}
        updates, state = chain.update(g, state, p)
        p = optax.apply_updates(p, updates)
        out.append(({k: np.asarray(v) for k, v in p.items()},
                    float(optax.global_norm(g))))
    return out


def _run_port(opt, params, grads_seq, apply):
    p = _torch_tree(params)
    state = opt.init(p)
    out = []
    for g in grads_seq:
        p, state, gnorm = apply(opt, _torch_tree(g), state, p)
        out.append(({k: v.numpy().copy() for k, v in p.items()},
                    float(gnorm)))
    return out, state


def _same(got, want, atol=2e-6):
    for i, ((gp, gn), (wp, wn)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gn, wn, rtol=1e-5, err_msg=f"step {i}")
        for k in wp:
            np.testing.assert_allclose(gp[k], wp[k], atol=atol,
                                       err_msg=f"step {i} leaf {k}")


def _grads_seq(params, n=6):
    r = np.random.RandomState(4)
    return [_grads(params, r, i) for i in range(n)]


def test_fused_adamw_matches_jax_fused_and_optax():
    params = _tree()
    grads_seq = _grads_seq(params)
    sched = TR.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 20)
    port, state = _run_port(
        O.FusedAdamW(sched, weight_decay=0.01, clip_norm=1.0), params,
        grads_seq, lambda o, g, s, p: o.fused_apply(g, s, p))
    assert state["count"] == 6
    assert all(m.dtype == torch.float32 for m in state["mu"].values())

    jsched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 20)
    jopt = JaxFusedAdamW(jsched, weight_decay=0.01, clip_norm=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    jax_out = []
    for g in grads_seq:
        jp, jstate, gn = jopt.fused_apply(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jax_out.append(({k: np.asarray(v) for k, v in jp.items()},
                        float(gn)))
    _same(port, jax_out)
    _same(port, _run_optax(_optax_chain(jsched, jnp.float32), params,
                           grads_seq))


def test_default_optimizer_matches_optax_chain():
    """The unfused arm with optax's semantics, schedule included."""
    params = _tree(seed=5)
    grads_seq = _grads_seq(params)
    opt = TR.default_optimizer(lr=1e-2, weight_decay=0.01, warmup_steps=3,
                               total_steps=20)
    assert isinstance(opt, TR.ClippedAdamW)
    port, state = _run_port(opt, params, grads_seq,
                            lambda o, g, s, p: o.apply(g, s, p))
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 20)
    _same(port, _run_optax(_optax_chain(sched), params, grads_seq))
    # optax keeps the moments in the grads' dtype
    assert all(m.dtype == torch.float32 for m in state["nu"].values())


@pytest.mark.parametrize("warmup,total", [(2, 10), (3, 20), (100, 1000)])
def test_schedule_matches_optax(warmup, total):
    """default_optimizer's schedule equals optax's
    warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1))
    at every count the first steps read, and past the decay's end."""
    mine = TR.warmup_cosine_decay_schedule(0.0, 3e-4, warmup,
                                           max(total, warmup + 1))
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup,
                                             max(total, warmup + 1))
    for count in list(range(6)) + [warmup, total - 1, total, total + 5]:
        want = float(ref(jnp.asarray(count, jnp.int32)))
        got = float(mine(count))
        assert abs(got - want) <= 1e-7 * abs(want), (count, got, want)


@pytest.mark.parametrize("fused", [True, False])
def test_bf16_params_moments(fused):
    """The fused optimizer keeps f32 moments for bf16 params (the JAX
    FusedAdamW's numerics upgrade); the optax-semantics arm keeps them in
    the grads' dtype, as optax does. Params stay bf16 and move downhill."""
    params = {"w": torch.ones((2, 128), dtype=torch.bfloat16)}
    opt = (O.FusedAdamW(0.1) if fused else TR.ClippedAdamW(0.1))
    state = opt.init(params)
    grads = {"w": torch.full((2, 128), 0.5, dtype=torch.bfloat16)}
    apply = opt.fused_apply if fused else opt.apply
    new_p, new_state, _ = apply(grads, state, params)
    assert new_p["w"].dtype == torch.bfloat16
    want = torch.float32 if fused else torch.bfloat16
    assert new_state["mu"]["w"].dtype == want
    assert new_state["nu"]["w"].dtype == want
    assert bool((new_p["w"] < 1).all())


def test_plain_leaf_update_matches_jax_xla_leaf_update():
    """The plain version of K4 against the JAX package's plain version
    of its kernel, one leaf, the same eight scalars."""
    from tony_tpu.ops.optim import _xla_leaf_update
    r = np.random.RandomState(6)
    p, g = r.randn(64, 32).astype(np.float32), r.randn(64, 32).astype(
        np.float32)
    m, v = r.randn(64, 32).astype(np.float32) * 0.1, np.abs(
        r.randn(64, 32)).astype(np.float32) * 0.01
    sc = np.array([1e-3, 0.9, 0.999, 1e-8, 0.01, 1 / 0.19, 1 / 0.002,
                   0.5], np.float32)
    got = O._plain_leaf_update(*(torch.from_numpy(x) for x in
                                 (p, g, m, v, sc)))
    want = _xla_leaf_update(*(jnp.asarray(x) for x in (p, g, m, v, sc)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_adamw_update_checks_and_counts():
    p = torch.ones(8)
    m, v = torch.zeros(8), torch.zeros(8)
    sc = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.0, 10.0, 1000.0, 1.0])
    with pytest.raises(TypeError):
        O.adamw_update(p, torch.ones(8, dtype=torch.bfloat16), m, v, sc)
    with pytest.raises(TypeError):
        O.adamw_update(p, torch.ones(8), m.double(), v, sc)
    with pytest.raises(ValueError):
        O.adamw_update(p, torch.ones(4), m, v, sc)
    with pytest.raises(ValueError):                 # params aliasing
        O.FusedAdamW(1e-3).fused_apply({"a": p, "b": p},
                                       O.FusedAdamW(1e-3).init(
                                           {"a": p, "b": torch.ones(8)}),
                                       {"a": p, "b": p})
    O.adamw_update(p, torch.ones(8), m, v, sc)      # a CPU leaf: plain
    assert O.adamw_update.launches == 0
    assert bool((p < 1).all()) and bool((m > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_adamw_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    p = torch.randn(3000, 70, device="cuda", generator=g).to(dtype)
    grad = torch.randn(3000, 70, device="cuda", generator=g).to(dtype)
    m = torch.randn(3000, 70, device="cuda", generator=g) * 0.1
    v = torch.rand(3000, 70, device="cuda", generator=g) * 0.01
    sc = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.01, 1 / 0.19, 1 / 0.002,
                       0.5], device="cuda")
    want = O._plain_leaf_update(p, grad, m, v, sc)
    O.adamw_update(p, grad, m, v, sc)
    torch.cuda.synchronize()
    for a, b in zip((p, m, v), want):
        assert torch.equal(a, b)
