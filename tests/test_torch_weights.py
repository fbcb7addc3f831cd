"""Parameter trees between the JAX package and tony_tpu_torch.

Conversion keeps keys, shapes and dtypes (bf16 included, without the
port importing ml_dtypes), the round trip is bit-exact, and the JAX
weight store's ``tree_digest`` is the same for a JAX tree and its
converted copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as JT
from tony_tpu.serving.weightstore import tree_digest
from tony_tpu_torch.models.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _jax_tree(dtype, **kw):
    cfg = JT.PRESETS["tiny"].scaled(dtype=dtype, remat=False, **kw)
    return jax.device_get(JT.init_params(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conversion_keeps_keys_shapes_dtypes(dtype):
    tree = _jax_tree(jnp.dtype(dtype), n_kv_heads=2)
    tp = params_from_numpy(tree, device="cpu")
    got, want = dict(_leaves(tp)), dict(_leaves(tree))
    assert got.keys() == want.keys()
    for name, a in want.items():
        assert tuple(got[name].shape) == a.shape, name
        assert got[name].dtype == _TORCH_DTYPE[a.dtype.name], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact(dtype):
    tree = _jax_tree(jnp.dtype(dtype))
    back = params_to_numpy(params_from_numpy(tree, device="cpu"),
                           bf16_dtype=jnp.bfloat16)
    for (name, a), (_, b) in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_digest_equal_across_packages(dtype):
    tree = _jax_tree(jnp.dtype(dtype))
    tp = params_from_numpy(tree, device="cpu")
    assert tree_digest(params_to_numpy(tp, bf16_dtype=jnp.bfloat16)) == \
        tree_digest(tree)


def test_bf16_leaves_come_back_as_bits_without_a_bf16_dtype():
    t = torch.tensor([1.0, -2.5, 3.0e38], dtype=torch.bfloat16)
    bits = params_to_numpy({"w": t})["w"]
    assert bits.dtype == np.uint16
    assert torch.equal(torch.from_numpy(bits.view(np.int16))
                       .view(torch.bfloat16), t)


def test_dtype_cast_on_load_matches_jax_cast():
    tree = _jax_tree(jnp.float32)
    tp = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    want = np.asarray(jnp.asarray(tree["lm_head"]).astype(jnp.bfloat16))
    got = params_to_numpy(tp, bf16_dtype=jnp.bfloat16)["lm_head"]
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_tree_crosses_with_an_f32_router(dtype):
    """An MoE tree keeps its keys, shapes and dtypes (the router f32 in a
    bf16 tree) both ways, bit for bit, with the JAX tree's digest; a cast
    to bf16 on load leaves the router f32, as the model keeps it."""
    tree = _jax_tree(jnp.dtype(dtype), num_experts=4)
    assert tree["blocks"]["router"].dtype == np.float32
    tp = params_from_numpy(tree, device="cpu")
    assert tp["blocks"]["router"].dtype == torch.float32
    for name, a in _leaves(tree):
        assert tuple(dict(_leaves(tp))[name].shape) == a.shape, name
    back = params_to_numpy(tp, bf16_dtype=jnp.bfloat16)
    for (name, a), (_, b) in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert tree_digest(back) == tree_digest(tree)
    cast = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert cast["blocks"]["router"].dtype == torch.float32
    assert cast["blocks"]["w_gate"].dtype == torch.bfloat16
