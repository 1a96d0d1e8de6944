"""The port's AlexNets against the flax models, on carried weights.

The flax parameter tree comes from the flax model itself
(``jax.eval_shape`` of its ``init``); its values are drawn with numpy
from a fixed seed at He-normal scale, with nonzero biases, so that the
logits are of order one and every bias is carried too (flax's own init
gives zero biases and shrinking activations, a weaker check).
``flax_to_torch`` carries the tree into the port's module and both run
the same numpy input. Logits agree to 1e-4: float32 convolution sums are
taken in a different order by XLA:CPU and by ATen.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.models import get_model as flax_get_model
from deepvision_tpu_torch.convert.from_flax import flax_to_torch
from deepvision_tpu_torch.models import get_model
from deepvision_tpu_torch.models import layers
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)


def _flax_variables(name, size, classes):
    model = flax_get_model(name, num_classes=classes)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(0)

    def draw(leaf):
        if len(leaf.shape) == 1:
            return rng.normal(0, 0.01, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, np.sqrt(2 / fan_in), leaf.shape).astype(
            np.float32)

    return model, jax.tree_util.tree_map(draw, shapes)


def _port_module(name, variables, size, classes):
    kw = {"num_classes": classes, "input_size": size}
    module = get_model(name, **kw)
    module.load_state_dict(flax_to_torch(name, variables, **kw))
    return module.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("name,size,classes,batch", [
    ("alexnet1", 64, 10, 2),
    ("alexnet2_tf", 64, 10, 2),
    ("alexnet1", 224, 1000, 1),
    ("alexnet2_tf", 224, 1000, 1),
])
def test_logits_match_flax(name, size, classes, batch):
    model, variables = _flax_variables(name, size, classes)
    x = (np.random.default_rng(1).normal(0, 1, (batch, size, size, 3))
         .astype(np.float32))
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    module = _port_module(name, variables, size, classes)
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == (batch, classes)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_v1_geometry_224():
    """224 -> 55 -> 27 -> 13 -> 6: the 6x6x256 flatten of the FC stack."""
    module = get_model("alexnet1")
    assert module.fc6.in_features == 6 * 6 * 256
    assert sum(p.numel() for p in module.parameters()) == 62_378_344


def test_max_pool_explicit_padding_pads_with_neg_inf():
    x = -torch.ones(1, 3, 3, 1)
    y = layers.max_pool(x, (2, 2), (2, 2), [(0, 1), (0, 1)])
    assert y.shape == (1, 2, 2, 1)
    assert torch.all(y == -1)  # a padded cell never wins
    with pytest.raises(ValueError, match="VALID"):
        layers.max_pool(x, (2, 2), (2, 2), "SAME")


@pytest.mark.parametrize("damage", ["missing", "extra", "shape"])
def test_flax_to_torch_rejects_bad_trees(damage):
    _, variables = _flax_variables("alexnet1", 64, 10)
    params = variables["params"]
    if damage == "missing":
        del params["conv3"]["bias"]
        match = "lack params/conv3/bias"
    elif damage == "extra":
        params["fc9"] = {"kernel": np.zeros((4, 4), np.float32)}
        match = "does not use"
    else:
        params["fc8"]["bias"] = np.zeros((11,), np.float32)
        match = "fc8/bias has shape"
    with pytest.raises(ValueError, match=match):
        flax_to_torch("alexnet1", variables, num_classes=10, input_size=64)
