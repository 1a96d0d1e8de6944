"""The port's converters (``deepvision_tpu_torch/convert/``) against the
JAX package's (``deepvision_tpu/convert/``), on the CPU.

Torchvision-layout modules (independent re-statements of the reference
nets, whose state-dict keys are the converters' input contract, copied
from ``tests/test_convert.py`` into ``tests/torch_reference_nets.py``,
which ``chip_smoke.py`` shares) with seeded weights and non-trivial BN
statistics feed both converters. The port's converter composes the
JAX key rules with ``convert/from_flax.py``; the port model on its
state dict must give the JAX model's logits on the JAX converter's
variables within 1e-4 (atol and rtol), and both the source module's
within the JAX suite's own bounds: ResNet-50 and MobileNet V1 at 64 px,
VGG-16 and AlexNet V2 at 224 (their flatten grids need it), Inception V1
at 96 (main logits) and its aux head on a 14x14x512 activation. Also:
the ``module.`` prefix, the checkpoint dict of everything, unmapped
keys, the Keras HDF5 path (``tf.keras`` ResNet50V2 at 64 px), the
digest check, the activation differ (clean, and a corrupted layer
localized), and the CLI end to end into ``load_served``.
"""

import shutil

import numpy as np
import pytest
import torch
import torch.nn as tnn

from deepvision_tpu.convert import torch_import as jax_ti
from deepvision_tpu.models import get_model as flax_get_model
from deepvision_tpu_torch.convert import diff, pretrained, torch_import
from deepvision_tpu_torch.convert.__main__ import main as convert_main
from deepvision_tpu_torch.models import create_model
from tests.torch_reference_nets import (
    TorchAlexNetV2,
    TorchInceptionV1,
    TorchMobileNetV1,
    TorchResNet50,
    TorchVGG16,
)
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)


@pytest.fixture(autouse=True)
def _delete_what_the_test_wrote(tmp_path):
    """The shards, checkpoints and images a test writes go with it (the
    suite's workers share one temp disk)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)

TOL = 1e-4


def _with_bn_statistics(m: tnn.Module, seed: int) -> tnn.Module:
    """Running statistics away from 0 and 1, so that eval mode reads
    them."""
    g = torch.Generator().manual_seed(seed)
    for mod in m.modules():
        if isinstance(mod, tnn.BatchNorm2d):
            mod.running_mean.normal_(0, 0.05, generator=g)
            mod.running_var.uniform_(0.8, 1.2, generator=g)
    return m.eval()


def _image(seed: int, size: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(1, size, size, 3)).astype(np.float32)


def _source_logits(tm, img) -> np.ndarray:
    with torch.no_grad():
        return tm(torch.from_numpy(img.transpose(0, 3, 1, 2).copy())).numpy()


def _port_logits(name, state_dict, img, **kw) -> np.ndarray:
    module = create_model(name, device=torch.device("cpu"), **kw)
    module.load_state_dict(state_dict)
    module.eval()
    with torch.no_grad():
        return module(torch.from_numpy(img)).numpy()


def _jax_logits(name, variables, img, **kw) -> np.ndarray:
    model = flax_get_model(name, **kw)
    v = {"params": variables["params"]}
    if variables.get("batch_stats"):
        v["batch_stats"] = variables["batch_stats"]
    return np.asarray(model.apply(v, img, train=False))


def _sequential(tm, layers, grid):
    return jax_ti.sequential_torch_to_flax(tm.state_dict(), layers,
                                           flatten_grid=grid)


# name, torch module factory, JAX converter, input size, bound against the
# source module (the JAX suite's: 1e-4 for ResNet-50, else 2e-3)
CASES = {
    "resnet50": (lambda: _with_bn_statistics(TorchResNet50(10), 0),
                 lambda tm: jax_ti.resnet_torch_to_flax(tm.state_dict()),
                 64, 1e-4),
    "vgg16": (lambda: TorchVGG16(10).eval(),
              lambda tm: _sequential(tm, jax_ti.VGG16_LAYERS, (7, 7)),
              224, 2e-3),
    "alexnet2": (lambda: TorchAlexNetV2(10).eval(),
                 lambda tm: _sequential(tm, jax_ti.ALEXNET2_LAYERS, (6, 6)),
                 224, 2e-3),
    "mobilenet1": (lambda: _with_bn_statistics(TorchMobileNetV1(10), 5),
                   lambda tm: jax_ti.mobilenet_torch_to_flax(
                       tm.state_dict()), 64, 2e-3),
    "inception1_ref": (lambda: TorchInceptionV1(10).eval(),
                       lambda tm: jax_ti.inception_torch_to_flax(
                           tm.state_dict()), 96, 2e-3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_logits_equal_jax_and_the_source(name):
    make, jax_convert, size, source_tol = CASES[name]
    torch.manual_seed(sorted(CASES).index(name))
    tm = make()
    img = _image(1, size)
    port_sd = torch_import.convert_state_dict(name, tm.state_dict(),
                                              num_classes=10)
    got = _port_logits(name, port_sd, img, num_classes=10)
    want = _jax_logits(name, jax_convert(tm), img, num_classes=10)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, _source_logits(tm, img), atol=source_tol)


def test_inception_aux_head_equals_jax_and_the_source():
    """The aux heads' weights, the fc1 flatten turned NHWC included: the
    port's ``aux1`` on a 14x14x512 activation against the JAX
    ``AuxiliaryClassifier`` on the JAX converter's weights."""
    from deepvision_tpu.models.inception import AuxiliaryClassifier

    torch.manual_seed(7)
    tm = TorchInceptionV1(10).eval()
    port_sd = torch_import.convert_state_dict("inception1_ref",
                                              tm.state_dict(),
                                              num_classes=10)
    module = create_model("inception1_ref", device=torch.device("cpu"),
                          num_classes=10)
    module.load_state_dict(port_sd)
    module.eval()
    act = np.random.default_rng(8).normal(
        size=(1, 14, 14, 512)).astype(np.float32)
    with torch.no_grad():
        got = module.aux1(torch.from_numpy(act), False, None).numpy()
    variables = jax_ti.inception_torch_to_flax(tm.state_dict())
    want = np.asarray(AuxiliaryClassifier(10, bn=False).apply(
        {"params": variables["params"]["aux1"]}, act, train=False))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    with torch.no_grad():
        source = tm.aux1(torch.from_numpy(
            np.ascontiguousarray(act.transpose(0, 3, 1, 2)))).numpy()
    np.testing.assert_allclose(got, source, atol=2e-3)


@pytest.fixture(scope="module")
def resnet():
    torch.manual_seed(0)
    return _with_bn_statistics(TorchResNet50(10), 0)


def test_prefix_stripped_and_checkpoint_dict_unwrapped(tmp_path, resnet):
    """``module.`` keys and the reference's ``{"epoch", "model", ...}``
    dict give the same state dict as the bare one, as in JAX."""
    sd = resnet.state_dict()
    prefixed = {"module." + k: v for k, v in sd.items()}
    assert torch_import.strip_module_prefix(prefixed).keys() == sd.keys()
    path = tmp_path / "ckpt.pt"
    torch.save({"epoch": 3, "model": prefixed, "optimizer": {},
                "loggers": {"train_loss": {"epochs": [0], "value": [1.0]}}},
               path)
    loaded = torch_import.load_torch_checkpoint(path)
    assert loaded.keys() == jax_ti.load_torch_checkpoint(path).keys()
    want = torch_import.convert_state_dict("resnet50", sd, num_classes=10)
    got = torch_import.convert_state_dict("resnet50", loaded, num_classes=10)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_unmapped_and_missing_keys_raise(resnet):
    sd = dict(resnet.state_dict())
    sd["mystery.weight"] = torch.zeros(1)
    with pytest.raises(KeyError, match="mystery"):
        torch_import.convert_state_dict("resnet50", sd, num_classes=10)
    with pytest.raises(KeyError, match="mystery"):
        jax_ti.resnet_torch_to_flax(sd)
    sd = dict(resnet.state_dict())
    del sd["linear.bias"]
    with pytest.raises(ValueError, match="fc/bias"):
        torch_import.convert_state_dict("resnet50", sd, num_classes=10)
    with pytest.raises(ValueError, match="BN-free"):
        torch_import.convert_state_dict("inception1", sd)


def test_keras_h5_equals_jax_and_keras(tmp_path):
    """tf.keras ResNet50V2 (random init) -> a layer-name-keyed HDF5 file
    -> both converters: the port's logits against the JAX model's on the
    JAX converter's variables and against Keras's own."""
    tf = pytest.importorskip("tensorflow")
    h5py = pytest.importorskip("h5py")
    from deepvision_tpu.convert.keras_import import keras_h5_to_flax

    from deepvision_tpu_torch.convert.keras_import import keras_h5_to_port

    keras_model = tf.keras.applications.ResNet50V2(
        weights=None, input_shape=(64, 64, 3), classes=10,
        classifier_activation=None)
    path = tmp_path / "weights.h5"
    with h5py.File(path, "w") as f:
        for layer in keras_model.layers:
            values = layer.get_weights()
            if not values:
                continue
            group = f.create_group(layer.name).create_group(layer.name)
            for w, v in zip(layer.weights, values):
                group.create_dataset(w.name.split("/")[-1], data=v)
    img = _image(0, 64)
    got = _port_logits("resnet50v2", keras_h5_to_port(path, num_classes=10),
                       img, num_classes=10)
    want = _jax_logits("resnet50v2", keras_h5_to_flax(path), img,
                       num_classes=10)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        got, keras_model(img, training=False).numpy(), atol=TOL)


def test_pretrained_digest_checked(tmp_path, resnet):
    """The digest matches JAX's; a wrong one raises before any load; the
    file loads to the port's state dict; an unknown suffix raises."""
    from deepvision_tpu.convert.pretrained import file_digest as jax_digest

    path = tmp_path / "resnet50.pt"
    torch.save(resnet.state_dict(), path)
    digest = pretrained.file_digest(path)
    assert digest == jax_digest(path)
    assert pretrained.file_digest(path, "md5") == jax_digest(path, "md5")
    assert pretrained.verify_artifact(path, digest.upper()) == path
    with pytest.raises(ValueError, match="mismatch"):
        pretrained.verify_artifact(path, "0" * 64)
    with pytest.raises(ValueError, match="mismatch"):
        pretrained.load_pretrained(path, expected_digest="0" * 64)
    sd = pretrained.load_pretrained(path, expected_digest=digest,
                                    num_classes=10)
    want = torch_import.convert_state_dict("resnet50", resnet.state_dict(),
                                           num_classes=10)
    assert sd.keys() == want.keys()
    with pytest.raises(ValueError, match="unrecognized"):
        pretrained.load_pretrained(tmp_path / "weights.xyz")


def _port_resnet(resnet):
    module = create_model("resnet50", device=torch.device("cpu"),
                          num_classes=10)
    module.load_state_dict(torch_import.convert_state_dict(
        "resnet50", resnet.state_dict(), num_classes=10))
    return module


def test_diff_activations_clean_and_localizes_corruption(resnet):
    """Every block of the converted port model within 1e-3 of its source
    block (the JAX suite's bound); a corrupted conv is flagged at its
    block while the blocks before it stay clean."""
    img = _image(0, 64)
    names = diff.resnet_name_map((3, 4, 6, 3))
    module = _port_resnet(resnet)
    report = diff.diff_activations(module, resnet, img, names)
    assert set(report) == set(names)
    for name, err in report.items():
        assert np.isfinite(err) and err < 1e-3, (name, err)
    with torch.no_grad():
        module.stage3_block1.conv2.conv.weight.add_(0.5)
    report = diff.diff_activations(module, resnet, img, names)
    assert report["stage2_block4"] < 1e-3
    assert report["stage3_block1"] > 1e-2


def test_cli_end_to_end_into_load_served(tmp_path, capsys):
    """``python -m deepvision_tpu_torch.convert`` on a reference
    checkpoint dict writes ``<workdir>/mobilenet1/ckpt``, which
    ``load_served`` restores: its top-5 equal the source module's, the
    probabilities within 1e-4; the default device is the card, which
    raises here."""
    from deepvision_tpu_torch.serve.models import load_served

    torch.manual_seed(9)
    tm = _with_bn_statistics(TorchMobileNetV1(10), 9)
    pt = tmp_path / "mobilenet.pt"
    torch.save({"epoch": 3, "model": tm.state_dict()}, pt)
    out = tmp_path / "out"
    args = [str(pt), "-m", "mobilenet1", "-o", str(out), "--num-classes",
            "10", "--input-size", "64"]
    with pytest.raises(RuntimeError, match="CUDA"):
        convert_main(args)
    assert convert_main([*args, "--device", "cpu"]) == 0
    assert "converted" in capsys.readouterr().out
    served = load_served("mobilenet1", str(out / "mobilenet1"),
                         device="cpu")
    assert served.input_shape == (64, 64, 3)
    img = _image(10, 64)
    res = served.postprocess(served.run(img), 0)
    probs = torch.softmax(torch.from_numpy(_source_logits(tm, img)), -1)[0]
    want = torch.argsort(-probs, stable=True)[:5]
    assert res["classes"] == want.tolist()
    np.testing.assert_allclose(res["probs"], probs[want].numpy(), atol=TOL)
