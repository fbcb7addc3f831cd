"""tony_tpu_torch MNIST models and the north-star recipe vs the JAX
package's.

The JAX ``init_mlp`` / ``init_cnn`` trees (f32) converted through numpy
and seeded numpy images through both packages on the CPU:

- ``mlp_forward`` (depth 1 and 2) and ``cnn_forward`` (flat and NHWC
  input) logits to 1e-5 of the largest logit;
- ``nll_loss`` to 1e-6 relative, ``accuracy`` exactly;
- the trees' keys, shapes and dtypes against the JAX inits, the weights'
  std near ``fan_in ** -0.5``, the round trip and ``tree_digest``;
- ``synthetic_batch``: labels in range, each image its label's one-hot
  tiled over 784 pixels plus noise of std 0.3 (JAX draws labels and
  noise from ``jax.random``; the port from ``torch``, so the patterns
  are compared given the labels, the noise by its distribution);
- ``synthetic_mnist`` and the IDX loaders against the JAX example's, and
  ``mnist_distributed --device cpu`` reaching its target accuracy.
"""

import gzip
import importlib.util
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import mnist as JM
from tony_tpu.serving.weightstore import tree_digest
from tony_tpu_torch import mnist_distributed
from tony_tpu_torch.models import mnist as TM
from tony_tpu_torch.models.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(n, seed):
    return np.random.RandomState(seed).randn(n, 784).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("depth", [1, 2])
def test_mlp_forward_matches_jax(depth):
    jp = jax.device_get(JM.init_mlp(jax.random.PRNGKey(depth), hidden=64,
                                    depth=depth))
    x = _images(8, depth)
    want = np.asarray(JM.mlp_forward(jp, x))
    got = TM.mlp_forward(params_from_numpy(jp, device="cpu"),
                         torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("nhwc", [False, True], ids=["flat", "nhwc"])
def test_cnn_forward_matches_jax(nhwc):
    jp = jax.device_get(JM.init_cnn(jax.random.PRNGKey(3)))
    x = _images(4, 5)
    if nhwc:
        x = x.reshape(4, 28, 28, 1)
    want = np.asarray(JM.cnn_forward(jp, x))
    got = TM.cnn_forward(params_from_numpy(jp, device="cpu"),
                         torch.from_numpy(x))
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_nll_loss_and_accuracy_match_jax():
    rs = np.random.RandomState(0)
    logits = rs.randn(16, 10).astype(np.float32) * 3
    labels = rs.randint(0, 10, size=(16,)).astype(np.int32)
    labels[:5] = logits[:5].argmax(-1)
    np.testing.assert_allclose(
        float(TM.nll_loss(torch.from_numpy(logits),
                          torch.from_numpy(labels))),
        float(JM.nll_loss(logits, labels)), rtol=1e-6)
    assert float(TM.accuracy(torch.from_numpy(logits),
                             torch.from_numpy(labels))) == \
        float(JM.accuracy(logits, labels))


def _shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _flat(tree).items()}


def test_trees_match_jax_and_round_trip_with_the_digest():
    gen = torch.Generator().manual_seed(0)
    for jtree, ttree in (
            (JM.init_mlp(jax.random.PRNGKey(0), hidden=128, depth=2),
             TM.init_mlp(gen, hidden=128, depth=2, device="cpu")),
            (JM.init_cnn(jax.random.PRNGKey(0)),
             TM.init_cnn(gen, device="cpu"))):
        jtree = jax.device_get(jtree)
        assert _shapes(ttree) == _shapes(jtree)
        for k, v in _flat(ttree).items():
            if k.endswith("w"):
                fan_in = int(np.prod(v.shape[:-1]))
                assert abs(float(v.std()) * fan_in ** 0.5 - 1) < 0.1, k
        back = params_to_numpy(params_from_numpy(jtree, device="cpu"))
        for k, v in _flat(jtree).items():
            np.testing.assert_array_equal(_flat(back)[k], v)
        assert tree_digest(back) == tree_digest(jtree)
    assert TM.mlp_logical_axes({"layer_0": None}) == \
        JM.mlp_logical_axes({"layer_0": None})


def test_synthetic_batch_patterns_and_noise():
    want = jax.device_get(JM.synthetic_batch(jax.random.PRNGKey(0), 512))
    got = TM.synthetic_batch(torch.Generator().manual_seed(0), 512,
                             device="cpu")
    for b in (want, got):
        image, label = np.asarray(b["image"]), np.asarray(b["label"])
        assert image.shape == (512, 784) and image.dtype == np.float32
        assert label.shape == (512,) and label.dtype == np.int32
        assert label.min() >= 0 and label.max() < 10
        # the pattern: pixel j lights for class j % 10
        pattern = (np.arange(784)[None] % 10 == label[:, None])
        noise = image - pattern
        assert abs(noise.std() - 0.3) < 0.01 and abs(noise.mean()) < 0.01
        assert len(np.unique(label)) == 10


def _example_module():
    path = os.path.join(REPO, "examples", "mnist", "mnist_distributed.py")
    spec = importlib.util.spec_from_file_location("_jax_mnist", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_data_equals_the_examples(tmp_path):
    ex = _example_module()
    for a, b in zip(mnist_distributed.synthetic_mnist(100, 3),
                    ex.synthetic_mnist(100, 3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    imgs = np.random.RandomState(0).randint(0, 256, size=(3, 28, 28),
                                            dtype=np.uint8)
    with gzip.open(tmp_path / "i.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 3, 28, 28) + imgs.tobytes())
    with gzip.open(tmp_path / "l.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 3) + bytes([1, 7, 9]))
    for name in ("load_idx_images", "load_idx_labels"):
        path = str(tmp_path / ("i.gz" if "images" in name else "l.gz"))
        np.testing.assert_array_equal(getattr(mnist_distributed, name)(path),
                                      getattr(ex, name)(path))


def test_mnist_distributed_reaches_its_target_on_the_cpu(capsys):
    assert mnist_distributed.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "process 0/1, 1 global devices, mesh {'dp': 1}" in out
    assert "step 50 loss" in out and " acc " in out
    assert "done: 200 steps in" in out and "img/s" in out


def test_mnist_distributed_misses_an_unreachable_target(capsys):
    assert mnist_distributed.main(["--device", "cpu", "--steps", "1",
                                   "--target_acc", "1.01"]) == 1
    assert "FAILED: accuracy" in capsys.readouterr().err


def test_mnist_distributed_without_device_raises_without_a_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mnist_distributed.main(["--steps", "1"])
