"""tony_tpu_torch transformer forward vs the JAX package's.

The JAX ``tiny`` preset in f32, its parameters converted to torch
through numpy, and the same seeded tokens through both ``forward``s:
logits agree to atol 1e-4 / rtol 1e-4 (f32, different matmul
summation orders), for MHA, GQA and a sliding window, and for an MoE
config (4 experts), whose aux loss agrees to 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as JT
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

VARIANTS = {"mha": {}, "gqa": {"n_kv_heads": 2}, "window": {"attn_window": 8}}


def _configs(**kw):
    return (JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False, **kw),
            TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False, **kw))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_match_jax(variant):
    jcfg, tcfg = _configs(**VARIANTS[variant])
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, size=(2, 23))
    want, _ = JT.forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    got, aux = TT.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_rope_tables_and_apply_match_jax():
    pos = np.arange(40).reshape(2, 20)
    jc, js = JT.rope_tables(jnp.asarray(pos), 32)
    tc, ts = TT.rope_tables(torch.from_numpy(pos), 32)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    x = np.random.RandomState(1).randn(2, 20, 3, 32).astype(np.float32)
    np.testing.assert_allclose(
        TT.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(JT.apply_rope(jnp.asarray(x), jc, js)), atol=1e-5)


def test_expand_kv_is_blocked_like_jax():
    q = np.zeros((1, 3, 8, 4), np.float32)
    k = np.random.RandomState(2).randn(1, 3, 2, 4).astype(np.float32)
    jk, _ = JT.expand_kv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k))
    tk, _ = TT.expand_kv(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(k))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_init_params_tree_matches_jax_layout():
    jcfg, tcfg = _configs(n_kv_heads=2)
    jp = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg,
                        device="cpu")
    assert set(tp) == set(jp) and set(tp["blocks"]) == set(jp["blocks"])
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(tp[name].shape) == jp[name].shape
    for name, a in jp["blocks"].items():
        assert tuple(tp["blocks"][name].shape) == a.shape, name
        # same init scale: std within 10% of the JAX draw's
        if name.startswith("w"):
            assert abs(float(tp["blocks"][name].std()) / a.std() - 1) < 0.1


def test_config_validation_and_unported_branches():
    for bad in ({"n_kv_heads": 3}, {"remat_policy": "x"},
                {"kv_cache_dtype": "fp8"}, {"attn_window": -1},
                {"kv_cache_capacity": 8}):
        with pytest.raises(ValueError):
            TT.PRESETS["tiny"].scaled(**bad)
    cfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32)
    assert cfg.logits_storage_dtype == torch.float32
    assert TT.PRESETS["small"].logits_storage_dtype == torch.bfloat16
    assert TT.PRESETS["small"].head_dim == 64
    # MoE is ported: an f32 router and two expert matrices, no w_up
    moe_cfg = cfg.scaled(num_experts=3)
    moe = TT.init_params(torch.Generator(), moe_cfg, device="cpu")
    assert "w_up" not in moe["blocks"]
    assert moe["blocks"]["router"].dtype == torch.float32
    assert tuple(moe["blocks"]["w_gate"].shape) == (2, 3, 128, 512)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    # pp is ported (a dict mesh emulates its ranks; tests/
    # test_torch_pipeline.py), with cp too (cp replicates inside the
    # pipeline); cp is, but not with a window (tests/test_torch_cp.py)
    with torch.no_grad():
        torch.testing.assert_close(
            TT.forward(params, toks, cfg, mesh={"dp": 1, "pp": 2})[0],
            TT.forward(params, toks, cfg)[0])
        torch.testing.assert_close(
            TT.forward(params, toks, cfg, mesh={"pp": 2, "cp": 2})[0],
            TT.forward(params, toks, cfg)[0])
    with pytest.raises(NotImplementedError, match="attn_window"):
        TT.forward(params, toks, cfg.scaled(attn_window=2),
                   mesh={"dp": 1, "cp": 2})
    # ep is: experts that do not split evenly over it are refused first
    with pytest.raises(ValueError, match="not divisible over ep=2"):
        TT.forward(moe, toks, moe_cfg, mesh={"dp": 1, "ep": 2})


def test_moe_params_and_axes_match_jax():
    """The MoE tree's keys, shapes and dtypes (the router f32 in a bf16
    model) and its logical axes are the JAX package's."""
    for dtype in ("float32", "bfloat16"):
        jcfg = JT.PRESETS["tiny"].scaled(dtype=jnp.dtype(dtype),
                                         num_experts=4)
        tcfg = TT.PRESETS["tiny"].scaled(dtype=getattr(torch, dtype),
                                         num_experts=4)
        jp = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
        tp = TT.init_params(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
        assert set(tp["blocks"]) == set(jp["blocks"])
        for name, a in jp["blocks"].items():
            t = tp["blocks"][name]
            assert tuple(t.shape) == a.shape, name
            assert str(t.dtype).split(".")[-1] == a.dtype.name, name
        assert TT.logical_axes(tcfg) == JT.logical_axes(jcfg)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_moe_forward_logits_and_aux_match_jax(remat):
    jcfg, tcfg = _configs(num_experts=4)
    jcfg, tcfg = jcfg.scaled(remat=remat), tcfg.scaled(remat=remat)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, size=(2, 23))
    want, want_aux = JT.forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    got, aux = TT.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)
