"""tony_tpu_torch transformer forward vs the JAX package's.

The JAX ``tiny`` preset in f32, its parameters converted to torch
through numpy, and the same seeded tokens through both ``forward``s:
logits agree to atol 1e-4 / rtol 1e-4 (f32, different matmul
summation orders), for MHA, GQA and a sliding window.
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
    with pytest.raises(NotImplementedError):
        TT.init_params(torch.Generator(), cfg.scaled(num_experts=4),
                       device="cpu")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    # cp, pp and ep are not ported: a mesh with any of them live raises
    # before it is read further (its sizes are all the check needs)
    for axis in ("cp", "pp", "ep"):
        with pytest.raises(NotImplementedError):
            TT.forward(params, torch.zeros(1, 4, dtype=torch.long), cfg,
                       mesh={"dp": 1, axis: 2})
