"""The port's training pieces against the JAX package's, on the CPU.

Losses, top-k, the optimizer and its schedules, the numerics policy, the
device-side normalization, the host data copies, the fresh-weight init,
and the classification train and eval steps: each held against its JAX
twin on the same seeded numpy inputs. The steps start from a JAX train
state carried across mid-training (params, momentum, step, LR scale) by
``convert.from_flax``; dropout is off on both sides (the two frameworks'
random streams never agree, trap C6), the JAX side through
``model.apply(..., train=False)``, which for AlexNet only turns dropout
off. float32 to 1e-4 on losses and 1e-5 on parameters (sums taken in
another order by XLA:CPU and ATen); bf16 to the JAX package's own
bf16-twin band (``CLS_LOSS_RTOL``) with identical top-1 decisions.
"""

import contextlib
import dataclasses
import re
import shutil

import flax
import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.core.precision import DynamicLossScale as JaxLossScale
from deepvision_tpu.core.precision import get_policy as jax_get_policy
from deepvision_tpu.data import mnist as jax_mnist
from deepvision_tpu.data import padding as jax_padding
from deepvision_tpu.data.synthetic import (
    synthetic_classification as jax_synthetic,
)
from deepvision_tpu.losses import classification as jax_losses
from deepvision_tpu.models import get_model as flax_get_model
from deepvision_tpu.models import inception as jax_inception
from deepvision_tpu.models import layers as jax_layers
from deepvision_tpu.ops import normalize as jax_normalize
from deepvision_tpu.train import optimizers as jax_optimizers
from deepvision_tpu.train import schedules as jax_schedules
from deepvision_tpu.train.configs import get_config as jax_get_config
from deepvision_tpu.train.state import TrainState as JaxTrainState
from deepvision_tpu.train.state import create_train_state
from deepvision_tpu.train.steps import (
    aggregate_eval_parts as jax_aggregate_eval_parts,
    classification_eval_step as jax_eval_step,
    classification_train_step as jax_train_step,
)
from deepvision_tpu_torch.convert.from_flax import (
    flax_to_torch,
    flax_train_state_to_torch,
    load_flax_train_state,
)
from deepvision_tpu_torch.core.precision import (
    DynamicLossScale,
    all_finite,
    get_policy,
    precision_metrics,
)
from deepvision_tpu_torch.core.prng import KeySeq
from deepvision_tpu_torch.data import mnist, padding
from deepvision_tpu_torch.data.synthetic import synthetic_classification
from deepvision_tpu_torch.losses import classification as losses
from deepvision_tpu_torch.models import create_model
from deepvision_tpu_torch.ops import normalize
from deepvision_tpu_torch.train import schedules
from deepvision_tpu_torch.models import inception as port_inception
from deepvision_tpu_torch.models import layers
from deepvision_tpu_torch.train.configs import TRAINABLE, get_config
from deepvision_tpu_torch.train.optimizers import (
    ScheduledSGD,
    make_optimizer,
    set_lr_scale,
    set_update_count,
)
from deepvision_tpu_torch.train.state import TrainState
from deepvision_tpu_torch.train.steps import (
    aggregate_eval_parts,
    classification_eval_step,
    classification_train_step,
)
from tests.test_torch_inception import _draw as inception_draw
from tests.test_torch_inception import flax_variables
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

CPU = torch.device("cpu")
SIZE, CLASSES, BATCH = 64, 10, 4
# the JAX package's bf16-twin band for classification losses
# (tests/test_precision.py CLS_LOSS_RTOL)
CLS_LOSS_RTOL = 0.05


# ------------------------------------------------------ losses, top-k


def test_cross_entropy_and_topk_with_ties_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (6, 7)).astype(np.float32)
    logits[0, :] = 1.0          # every class tied: a hit at any k
    logits[1, [2, 4]] = 5.0     # the label ties with one other above all
    labels = np.array([3, 2, 0, 6, 1, 5], np.int32)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    lj, yj = jnp.asarray(logits), jnp.asarray(labels)
    for smooth in (0.0, 0.1):
        np.testing.assert_allclose(
            losses.softmax_cross_entropy_per_sample(
                lt, yt, label_smoothing=smooth).numpy(),
            np.asarray(jax_losses.softmax_cross_entropy_per_sample(
                lj, yj, label_smoothing=smooth)), rtol=1e-6, atol=1e-6)
    got = losses.topk_correct(lt, yt, ks=(1, 2, 5))
    want = jax_losses.topk_correct(lj, yj, ks=(1, 2, 5))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["top1"][0] == 1.0 and got["top1"][1] == 1.0  # ties hit


# ------------------------------------------- optimizer and schedules


def _tiny_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
            "b": rng.normal(0, 1, (4,)).astype(np.float32)}


def test_sgd_weight_decay_momentum_and_plateau_match_optax():
    """L2 before momentum, and a plateau LR drop mid-way written into the
    param groups, against optax's chain under inject_hyperparams."""
    cfg = jax_get_config("alexnet1")
    params = _tiny_params()
    tx, _ = jax_optimizers.make_optimizer(cfg, 10)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt, plateau = make_optimizer(get_config("alexnet1"), list(tp.values()))
    assert plateau is not None
    rng = np.random.default_rng(1)
    for step in range(5):
        if step == 2:  # the plateau cuts the LR by its factor
            opt_state = jax_optimizers.set_lr_scale(opt_state, 0.1)
            set_lr_scale(opt, 0.1)
        grads = {k: rng.normal(0, 1, v.shape).astype(np.float32)
                 for k, v in params.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6)


def test_constant_lr_matches_optax_through_the_train_state():
    cfg = {"optimizer": "sgd",
           "optimizer_params": {"lr": 0.1, "momentum": 0.9,
                                "weight_decay": 1e-3}}
    tx, _ = jax_optimizers.make_optimizer(cfg, 2)
    params = _tiny_params(2)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(
            torch.from_numpy(v.copy())))
    opt, plateau = make_optimizer(cfg, module.parameters())
    assert plateau is None
    state = TrainState(module, opt)
    rng = np.random.default_rng(3)
    for _ in range(5):
        grads = {k: rng.normal(0, 1, v.shape).astype(np.float32)
                 for k, v in params.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        state.apply_gradients()
    assert state.step == 5
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6)


@pytest.mark.parametrize("opt,scheduler,match", [
    ("rmsprop", "cosine", "scheduler 'cosine'"),
    ("adam", "cosine", "scheduler 'cosine'"),
    ("sgd", "cosine", "scheduler 'cosine'")])
def test_unported_optimizers_and_schedulers_raise(opt, scheduler, match):
    cfg = {"optimizer": opt, "optimizer_params": {"lr": 0.1},
           "scheduler": scheduler}
    with pytest.raises(NotImplementedError, match=match):
        make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])


def test_plateau_controller_and_schedules_match_jax():
    metrics = [0.5, 0.6, 0.6, 0.6, 0.6, 0.7, 0.7, 0.7, 0.7, 0.71]
    for mode, patience in (("max", 2), ("min", 1)):
        ours = schedules.PlateauController(mode=mode, factor=0.1,
                                           patience=patience)
        theirs = jax_schedules.PlateauController(mode=mode, factor=0.1,
                                                 patience=patience)
        assert ([ours.update(m) for m in metrics]
                == [theirs.update(m) for m in metrics])
        assert ours.state_dict() == theirs.state_dict()
        again = schedules.PlateauController()
        again.load_state_dict(ours.state_dict())
        assert again.state_dict() == ours.state_dict()
    pairs = [
        (schedules.step_decay(0.1, 10, 2, 0.5),
         jax_schedules.step_decay(0.1, 10, 2, 0.5)),
        (schedules.inception_poly(0.05, 7),
         jax_schedules.inception_poly(0.05, 7)),
        (schedules.linear_decay(2e-4, 200, 100),
         jax_schedules.linear_decay(2e-4, 200, 100)),
    ]
    for ours, theirs in pairs:
        for count in (0, 1, 19, 20, 45, 99, 150, 200, 419, 420, 524, 600):
            assert float(ours(count)) == pytest.approx(
                float(theirs(count)), rel=1e-6, abs=1e-12)


# -------------------------------------------------- numerics policy


def test_get_policy_names_and_aliases():
    assert get_policy("bf16").compute_dtype == torch.bfloat16
    assert not get_policy("bf16").loss_scaling
    assert get_policy("bf16_scaled").loss_scaling
    assert get_policy("f32").compute_dtype == torch.float32
    assert get_policy("bfloat16").name == "bf16"
    assert get_policy("mixed_scaled").name == "bf16_scaled"
    with pytest.raises(ValueError, match="unknown precision"):
        get_policy("fp8")
    assert get_policy("bf16").make_loss_scale(device="cpu") is None
    ls = get_policy("bf16_scaled").make_loss_scale(device="cpu")
    assert float(ls.scale) == 2.0 ** 15 and ls.growth_interval == 200
    assert ls.scale.device.type == "cpu"


def test_loss_scale_defaults_to_the_card(monkeypatch):
    """Without ``device`` the loss scale goes where the gradients are, the
    card: without one it raises instead of quietly taking the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        DynamicLossScale()
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        get_policy("bf16_scaled").make_loss_scale()
    assert get_policy("bf16").make_loss_scale() is None


def test_loss_scale_grow_backoff_and_clamps_match_jax():
    t, f = torch.tensor(True), torch.tensor(False)
    ours = DynamicLossScale(2.0, device="cpu", growth_interval=2,
                            min_scale=1.0, max_scale=8.0)
    theirs = JaxLossScale.create(init_scale=2.0, growth_interval=2,
                                 min_scale=1.0, max_scale=8.0)
    for finite in [1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0, 0, 1]:
        ours.adjust(t if finite else f)
        theirs = theirs.adjust(jnp.bool_(bool(finite)))
        assert float(ours.scale) == float(theirs.scale)
        assert int(ours.good_steps) == int(theirs.good_steps)
        assert float(ours.last_finite) == float(theirs.last_finite)
    assert float(ours.scale) == 1.0  # floored, then one clean step


def test_loss_scale_unscale_is_exact_at_pow2():
    ls = DynamicLossScale(float(2 ** 15), device="cpu")
    grads = [torch.tensor([1.5, -2.25, 3e-4]), torch.tensor([[7.0]])]
    want = [g.clone() for g in grads]
    scaled = [ls.scale_loss(g) for g in grads]
    ls.unscale_(scaled)
    for a, b in zip(scaled, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool(all_finite(want))
    assert not bool(all_finite([torch.tensor([1.0, float("inf")])]))
    assert bool(all_finite([torch.tensor([1, 2])]))  # ints are skipped


def _tiny_state(policy):
    torch.manual_seed(0)
    module = torch.nn.Linear(3, 4)
    opt = torch.optim.SGD(module.parameters(), lr=0.1, momentum=0.9,
                          weight_decay=5e-4)
    for group in opt.param_groups:
        group.update(base_lr=0.1, lr_scale=1.0)
    return TrainState(module, opt,
                      loss_scale=policy.make_loss_scale(device="cpu"))


def _snapshot(state):
    return ([p.detach().clone() for p in state.module.parameters()],
            [{k: v.clone() for k, v in state.optimizer.state[p].items()}
             for p in state.module.parameters()])


def test_nonfinite_grads_skip_the_update_and_back_off():
    state = _tiny_state(get_policy("bf16_scaled"))
    scale0 = float(state.loss_scale.scale)
    for p in state.module.parameters():  # one clean step: momentum exists
        p.grad = torch.ones_like(p) * scale0
    state.apply_gradients()
    assert float(precision_metrics(state)["mp_grads_finite"]) == 1.0
    params, buffers = _snapshot(state)
    assert all("momentum_buffer" in b for b in buffers)
    for p in state.module.parameters():
        p.grad = torch.full_like(p, float("inf"))
    state.apply_gradients()
    # masters and momentum untouched; step counted; scale halved
    after_p, after_b = _snapshot(state)
    for a, b in zip(after_p, params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(after_b, buffers):
        torch.testing.assert_close(a["momentum_buffer"],
                                   b["momentum_buffer"], rtol=0, atol=0)
    assert state.step == 2
    assert float(state.loss_scale.scale) == scale0 / 2
    assert float(precision_metrics(state)["mp_grads_finite"]) == 0.0
    # a finite step then moves the parameters again
    for p in state.module.parameters():
        p.grad = torch.ones_like(p) * float(state.loss_scale.scale)
    state.apply_gradients()
    assert any(not torch.equal(a, b) for a, b in
               zip(state.module.parameters(), params))


def test_first_step_nonfinite_leaves_zero_momentum():
    state = _tiny_state(get_policy("bf16_scaled"))
    params, _ = _snapshot(state)
    for p in state.module.parameters():
        p.grad = torch.full_like(p, float("nan"))
    state.apply_gradients()
    for p, old in zip(state.module.parameters(), params):
        torch.testing.assert_close(p.detach(), old, rtol=0, atol=0)
        assert not state.optimizer.state[p]["momentum_buffer"].any()


def test_scaled_update_bit_matches_unscaled_at_pow2_scale():
    plain = _tiny_state(get_policy("f32"))
    scaled = _tiny_state(get_policy("bf16_scaled"))
    for st, mult in ((plain, 1.0), (scaled, float(scaled.loss_scale.scale))):
        for p in st.module.parameters():
            p.grad = torch.full_like(p, 0.125 * mult)
        st.apply_gradients()
    for a, b in zip(plain.module.parameters(), scaled.module.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ----------------------------------------- normalization, PRNG, data


def test_normalize_matches_jax():
    img = np.random.default_rng(0).integers(0, 256, (2, 4, 4, 3),
                                            dtype=np.uint8)
    for fn in ("imagenet_normalize", "torch_normalize", "tanh_normalize"):
        np.testing.assert_allclose(
            getattr(normalize, fn)(torch.from_numpy(img)).numpy(),
            np.asarray(getattr(jax_normalize, fn)(jnp.asarray(img))),
            rtol=1e-6, atol=1e-6)
    for kind in ("imagenet", "torch", "tanh"):
        np.testing.assert_allclose(
            normalize.maybe_normalize(torch.from_numpy(img), kind).numpy(),
            np.asarray(jax_normalize.maybe_normalize(jnp.asarray(img),
                                                     kind)),
            rtol=1e-6, atol=1e-6)
    f = torch.ones(1, 2, 2, 3)
    assert normalize.maybe_normalize(f, "torch") is f  # only uint8
    with pytest.raises(ValueError, match="unknown normalization"):
        normalize.maybe_normalize(f, "zscore")


def test_keyseq_streams_are_deterministic_and_distinct():
    def draws(seq, n=3):
        return [torch.rand(4, generator=next(seq)) for _ in range(n)]

    a, b = draws(KeySeq(1, 0)), draws(KeySeq(1, 0))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], a[1])  # one fresh stream a draw
    assert not torch.equal(a[0], draws(KeySeq(1, 1))[0])  # by epoch
    assert not torch.equal(a[0], draws(KeySeq(2, 0))[0])  # by seed


def test_data_copies_match_jax_byte_for_byte():
    ours = synthetic_classification(40, 8, 3, 5, 4)
    theirs = jax_synthetic(40, 8, 3, 5, 4)
    for a, b in zip(ours[:2], theirs[:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert ours[2] == theirs[2]
    imgs, labels, _ = ours
    for kw in ({"rng": 7}, {"drop_remainder": False}):
        def run(fn):
            k = dict(kw)
            if "rng" in k:
                k["rng"] = np.random.default_rng(k["rng"])
            return list(fn(imgs[:11], labels[:11], 4, **k))
        got, want = run(mnist.batches), run(jax_mnist.batches)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in g:
                assert g[key].tobytes() == w[key].tobytes()
    got = padding.pad_partial_batch({"x": imgs[:3]}, 5)
    want = jax_padding.pad_partial_batch({"x": imgs[:3]}, 5)
    for key in want:
        assert got[key].tobytes() == want[key].tobytes()
    got = list(padding.iter_array_batches(
        {"x": imgs, "y": labels}, 16, rng=np.random.default_rng(3),
        drop_remainder=False))
    want = list(jax_padding.iter_array_batches(
        {"x": imgs, "y": labels}, 16, rng=np.random.default_rng(3),
        drop_remainder=False))
    assert [sorted(g) for g in got] == [sorted(w) for w in want]
    for g, w in zip(got, want):
        for key in w:
            assert g[key].tobytes() == w[key].tobytes()


# ------------------------------------------------------- fresh init


def test_fresh_init_matches_flax_lecun_normal():
    module = create_model("alexnet1", device=CPU, seed=0,
                          num_classes=CLASSES, input_size=SIZE)
    flax_params = flax_get_model("alexnet1", num_classes=CLASSES).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    for name in ("conv1", "conv2", "conv3", "conv4", "conv5", "fc6", "fc7",
                 "fc8"):
        w = getattr(module, name).weight.detach()
        kernel = np.asarray(flax_params[name]["kernel"])
        fan_in = w[0].numel()
        assert fan_in == int(np.prod(kernel.shape[:-1]))
        want = 1.0 / np.sqrt(fan_in)  # lecun_normal's std after the cut
        assert abs(w.std().item() / want - 1) < 0.03, name
        assert abs(w.std().item() / kernel.std() - 1) < 0.03, name
        # truncated at two standard deviations of the untruncated normal
        assert w.abs().max().item() <= 2 * want / 0.87962566103423978 \
            * (1 + 1e-6)  # float32 rounding at the cut
        assert not getattr(module, name).bias.any()


# --------------------------------------------- train and eval steps


def _jax_state(dtype=jnp.float32):
    """A JAX train state for alexnet1 at the test's size, its step with
    dropout off (jitted), and the flax model."""
    model = flax_get_model("alexnet1", num_classes=CLASSES, dtype=dtype)
    cfg = jax_get_config("alexnet1")
    tx, _ = jax_optimizers.make_optimizer(cfg, 10)
    state = create_train_state(model, tx, np.zeros((1, SIZE, SIZE, 3),
                                                   np.float32), rng=0)

    def no_dropout(variables, x, train=True, **kw):
        kw.pop("rngs", None)
        return model.apply(variables, x, train=False, **kw)

    def step(state, batch, key):
        s = state.replace(apply_fn=no_dropout)
        new, metrics = jax_train_step(s, batch, key, normalize_kind="torch")
        return new.replace(apply_fn=state.apply_fn), metrics

    return model, state, jax.jit(step)


def _find(opt_state, kind):
    """The ``kind`` part of an optax state (chains, inject_hyperparams)."""
    if isinstance(opt_state, kind):
        return opt_state
    if isinstance(opt_state, tuple):
        for part in opt_state:
            found = _find(part, kind)
            if found is not None:
                return found
    inner = getattr(opt_state, "inner_state", None)
    return None if inner is None else _find(inner, kind)


def _find_trace(opt_state):
    return _find(opt_state, optax.TraceState).trace


def _carry(jstate, model_dtype=torch.float32):
    """The JAX state in the port: module, optimizer, step, LR scale."""
    host = jax.tree.map(np.asarray, jstate)
    carried = flax_train_state_to_torch(
        "alexnet1", params=host.params, trace=_find_trace(host.opt_state),
        step=int(host.step),
        lr_scale=float(host.opt_state.hyperparams["lr_scale"]),
        num_classes=CLASSES, input_size=SIZE)
    module = create_model("alexnet1", device=CPU, num_classes=CLASSES,
                          input_size=SIZE, dtype=model_dtype)
    module.dropout_rate = 0.0
    opt, _ = make_optimizer(get_config("alexnet1"), module.parameters())
    state = TrainState(module, opt)
    load_flax_train_state(state, carried)
    return state


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(0, 1, (n, SIZE, SIZE, 3)).astype(np.float32),
            "label": rng.integers(0, CLASSES, n).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _params_close(state, jstate, atol):
    want = flax_train_state_to_torch(
        "alexnet1", params=jax.tree.map(np.asarray, jstate.params),
        trace=jax.tree.map(np.asarray, jstate.params), step=0,
        num_classes=CLASSES, input_size=SIZE)["model"]
    for name, p in state.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def mid_training():
    """A JAX state one step into training (nonzero momentum), with the
    plateau's LR scale lowered, and its carried port twin."""
    _, jstate, jstep = _jax_state()
    jstate, _ = jstep(jstate, _batch(100), jax.random.key(0))
    jstate = jstate.replace(opt_state=jax_optimizers.set_lr_scale(
        jstate.opt_state, 0.5))
    return jstate, jstep


def test_f32_train_step_matches_jax_from_carried_state(mid_training):
    jstate, jstep = mid_training
    state = _carry(jstate)
    assert state.step == 1
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(0.005)
    gen = KeySeq(1, 0)
    for i in range(3):
        batch = _batch(i)
        jstate, jm = jstep(jstate, batch, jax.random.key(i))
        m = classification_train_step(state, _torch_batch(batch), next(gen),
                                      normalize_kind="torch")
        assert set(m) == {"loss", "top1", "top5"}
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
    assert state.step == int(jstate.step) == 4
    _params_close(state, jstate, atol=1e-5)


def test_carried_loss_scale_lands_in_the_port_state(mid_training):
    jstate, _ = mid_training
    host = jax.tree.map(np.asarray, jstate)
    kw = dict(params=host.params, trace=_find_trace(host.opt_state),
              step=int(host.step), num_classes=CLASSES, input_size=SIZE)
    module = create_model("alexnet1", device=CPU, num_classes=CLASSES,
                          input_size=SIZE)
    opt, _ = make_optimizer(get_config("alexnet1"), module.parameters())
    state = TrainState(module, opt, loss_scale=DynamicLossScale(device="cpu"))
    load_flax_train_state(state, flax_train_state_to_torch(
        "alexnet1", loss_scale={"scale": np.float32(4096.0),
                                "good_steps": np.int32(7)}, **kw))
    assert float(state.loss_scale.scale) == 4096.0
    assert int(state.loss_scale.good_steps) == 7
    with pytest.raises(ValueError, match="loss scaling"):
        load_flax_train_state(TrainState(module, opt),
                              flax_train_state_to_torch(
                                  "alexnet1", loss_scale={
                                      "scale": 1.0, "good_steps": 0}, **kw))


def test_eval_step_and_aggregation_match_jax(mid_training):
    jstate, _ = mid_training
    state = _carry(jstate)
    model = flax_get_model("alexnet1", num_classes=CLASSES)
    images, labels = _batch(7, n=7).values()
    parts, jparts = [], []
    for b in mnist.batches(images, labels, BATCH, drop_remainder=False):
        parts.append(classification_eval_step(state, _torch_batch(b),
                                              normalize_kind="torch"))
        jparts.append(jax_eval_step(
            jstate.replace(apply_fn=model.apply), jax.tree.map(jnp.asarray,
                                                               b),
            normalize_kind="torch"))
    assert float(parts[-1]["count"]) == 3.0  # the padded last batch
    for p, jp in zip(parts, jparts):
        for k in jp:
            np.testing.assert_allclose(float(p[k]), float(jp[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    got, n = aggregate_eval_parts(parts)
    want = jax_aggregate_eval_parts(jparts)
    assert n == want[1] == 7.0
    assert got.keys() == want[0].keys() == {"val_loss", "val_top1",
                                            "val_top5"}
    for k in got:
        assert got[k] == pytest.approx(want[0][k], rel=1e-4)


def test_bf16_train_step_twin_of_jax_bf16():
    """Port bf16 against JAX bf16 from the same carried weights: the loss
    per step within CLS_LOSS_RTOL, the same top-1 decisions on a
    held-out batch."""
    model, jstate, jstep = _jax_state(jnp.bfloat16)
    state = _carry(jstate, torch.bfloat16)
    gen = KeySeq(1, 0)
    for i in range(3):
        batch = _batch(10 + i)
        jstate, jm = jstep(jstate, batch, jax.random.key(i))
        m = classification_train_step(state, _torch_batch(batch), next(gen),
                                      normalize_kind="torch")
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=CLS_LOSS_RTOL)
    held = _batch(99, n=8)["image"]
    with torch.no_grad():
        got = state.module(torch.from_numpy(held)).argmax(-1).numpy()
    want = np.asarray(model.apply({"params": jstate.params},
                                  jnp.asarray(held)).argmax(-1))
    np.testing.assert_array_equal(got, want)


def test_port_model_casts_at_use_in_bf16():
    module = create_model("alexnet1", device=CPU, num_classes=CLASSES,
                          input_size=SIZE, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in module.parameters())
    seen = {}
    module.lrn = lambda x: seen.setdefault(len(seen), x.dtype) and x
    out = module(torch.zeros(2, SIZE, SIZE, 3))
    assert out.dtype == torch.float32  # fc8 computes in float32
    assert set(seen.values()) == {torch.bfloat16}
    out.float().sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in module.parameters())


def test_dropout_needs_a_generator_and_follows_it():
    module = create_model("alexnet1", device=CPU, num_classes=CLASSES,
                          input_size=SIZE)
    x = torch.from_numpy(_batch(5)["image"])
    with pytest.raises(ValueError, match="generator"):
        module(x, train=True)
    a = module(x, train=True, generator=torch.Generator().manual_seed(1))
    b = module(x, train=True, generator=torch.Generator().manual_seed(1))
    c = module(x, train=True, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    torch.testing.assert_close(module(x), module(x, train=False))


def test_config_carries_the_jax_training_fields():
    assert TRAINABLE == ("alexnet1", "alexnet2", "centernet", "cyclegan",
                         "darknet53", "dcgan", "hourglass104", "inception1",
                         "inception1_ref", "inception3", "lenet5",
                         "mobilenet1", "resnet152", "resnet34", "resnet50",
                         "resnet50v2", "shufflenet1", "vgg16", "vgg19",
                         "yolov3")
    for name in TRAINABLE:
        ours, theirs = get_config(name), jax_get_config(name)
        for key in ("precision", "augment", "batch_size", "input_size",
                    "channels", "num_classes", "dataset", "optimizer",
                    "optimizer_params", "scheduler", "scheduler_params",
                    "total_epochs", "name", "model_kwargs", "remat",
                    "steps", "num_heatmaps", "noise_dim", "decay_epochs",
                    "save_every"):
            assert ours.get(key) == theirs.get(key), (name, key)
    assert get_config("resnet50")["model_kwargs"] == {"s2d_stem": True}
    assert "augment" not in get_config("resnet50v2")
    assert "optimizer" not in get_config("alexnet2_tf")
    ours = get_config("alexnet1")
    ours["optimizer_params"]["lr"] = 1.0  # a copy, not the table
    assert get_config("alexnet1")["optimizer_params"]["lr"] == 0.01


def test_policy_dataclass_is_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        get_policy("bf16").loss_scaling = True


# ------------------------------------------ Inception V1 train steps


INC_SIZE, INC_STEPS_PER_EPOCH = 96, 2
# (size, batch) of each variant's three f32 steps against JAX: the BN
# variant's at a batch BN can normalize, its aux heads' features 2x2 at
# 128 px (32 values a channel)
INC_STEPS_SHAPE = {"inception1_ref": (96, 2), "inception1": (128, 8)}


@contextlib.contextmanager
def _flax_dropout_off():
    """flax's Dropout at rate 0 while the JAX step traces: the Inception
    heads' rates are fixed in the module, and ``train=False`` would also
    turn off BN's batch statistics and the aux heads."""
    dropout = flax_nn.Dropout
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn, "Dropout",
                   lambda rate, **kw: dropout(0.0, **kw))
        yield


def _inc_batch(seed, n=2, size=INC_SIZE):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(0, 1, (n, size, size, 3))
            .astype(np.float32),
            "label": rng.integers(0, CLASSES, n).astype(np.int32)}


def _jax_inc_state(model, variables, policy=None):
    """A JAX train state on numpy ``variables`` with the inception1
    config's optimizer (inception_poly over 2-step epochs), and its
    jitted step."""
    tx, _ = jax_optimizers.make_optimizer(jax_get_config("inception1"),
                                          INC_STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray,
                                 variables.get("batch_stats", {})),
        opt_state=tx.init(params), apply_fn=model.apply, tx=tx,
        loss_scale=None if policy is None else policy.make_loss_scale())
    step = jax.jit(lambda s, b, k: jax_train_step(s, b, k,
                                                  normalize_kind="torch"))
    return state, step


def _inc_jax(name, dtype=jnp.float32, policy=None, size=INC_SIZE):
    model = flax_get_model(name, num_classes=CLASSES, dtype=dtype)
    _, variables = flax_variables(name, size, CLASSES, seed=2, gain=1.0)
    return _jax_inc_state(model, variables, policy)


def _inc_carry(name, jstate, dtype=torch.float32, size=INC_SIZE):
    host = jax.tree.map(np.asarray, jstate)
    count = _find(host.opt_state, optax.ScaleByScheduleState).count
    carried = flax_train_state_to_torch(
        name, params=host.params, batch_stats=host.batch_stats,
        trace=_find_trace(host.opt_state), step=int(host.step),
        count=int(count), num_classes=CLASSES, input_size=size)
    module = create_model(name, device=CPU, num_classes=CLASSES,
                          input_size=size, dtype=dtype)
    for m in (module, module.aux1, module.aux2):
        m.dropout_rate = 0.0
    opt, _ = make_optimizer(get_config(name), module.parameters(),
                            INC_STEPS_PER_EPOCH)
    state = TrainState(module, opt)
    load_flax_train_state(state, carried)
    return state


def _inc_variables(name, jstate, size):
    """The JAX state's parameters and BN statistics as the port's
    ``state_dict``."""
    host = jax.tree.map(np.asarray, jstate)
    variables = {"params": host.params}
    if host.batch_stats:
        variables["batch_stats"] = host.batch_stats
    return flax_to_torch(name, variables, num_classes=CLASSES,
                         input_size=size)


def _leaf_gap(a, b):
    return float((a - b).abs().max())


def _steps_against_jax(carry, jstate, jstep, batches, orders=()):
    """f32 steps, one a batch, of the port's state (``carry()``) and the
    JAX ``jstate`` from the same carried point, with a second carried
    state that takes them without momentum. ``orders`` reorder
    each batch for more JAX runs: their largest gaps to the JAX run, in
    the loss at each step and in each leaf at the end, are the float32
    noise floors. -> (the port's state, JAX's, the port's starting
    state_dict, the no-momentum twin's, the reordered JAX states)."""
    state, twin = carry(), carry()
    start = {k: v.clone() for k, v in state.module.state_dict().items()}
    for group in twin.optimizer.param_groups:
        group["momentum"] = 0.0
    reordered = [jstate] * len(orders)
    gen, twin_gen = KeySeq(1, 0), KeySeq(1, 0)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, batch, jax.random.key(i))
        floor = 0.0
        for j, order in enumerate(orders):
            reordered[j], fm = jstep(
                reordered[j], {k: order(v) for k, v in batch.items()},
                jax.random.key(i))
            floor = max(floor, abs(float(fm["loss"]) - float(jm["loss"])))
        m = classification_train_step(state, _torch_batch(batch), next(gen),
                                      normalize_kind="torch")
        classification_train_step(twin, _torch_batch(batch), next(twin_gen),
                                  normalize_kind="torch")
        assert abs(float(m["loss"]) - float(jm["loss"])) <= (
            1e-4 * abs(float(jm["loss"])) + 4 * floor), (i, floor)
    return state, jstate, start, twin.module.state_dict(), reordered


def _hold_leaves(got, want, tol, start, no_momentum):
    """Every leaf of ``got`` within ``tol[leaf]`` of ``want``; the state
    before the steps and the steps without momentum each fail that on
    most leaves, so the comparison sees both."""
    for key, tensor in got.items():
        np.testing.assert_allclose(tensor.numpy(), want[key].numpy(),
                                   rtol=0, atol=tol[key], err_msg=key)
    for wrong in (start, no_momentum):
        beyond = [k for k in want if _leaf_gap(wrong[k], want[k]) > tol[k]]
        assert len(beyond) > len(want) // 2, (len(beyond), len(want))


@pytest.mark.parametrize("name", ["inception1_ref", "inception1"])
def test_inception_f32_train_steps_match_jax(name):
    """Three f32 steps from a carried mid-training JAX state (momentum,
    update count, BN statistics): aux heads on at 0.3, dropout off, the
    LR moving with inception_poly's epochs of 2 steps, the update count
    exactly.

    ``inception1_ref``: loss to 1e-4, every parameter to 1e-5.
    ``inception1`` trains BN on the batch's statistics, and there float32
    cannot give 1e-5 over the whole model, not even to JAX against
    itself: a few of its millions of pre-ReLU values lie nearer 0 than
    the forward's rounding (7 at this state, against float64), each
    flips its ReLU in one run and not in another, and every gradient
    below it moves by up to 1%; three steps compound that. Two more JAX
    runs, on each batch reversed and rolled by 3, measure that floor
    leaf by leaf: each parameter and BN statistic is held to 1e-5 plus
    three times its own floor, the loss to 1e-4 plus four times the
    step's. The block test below holds the same BN path to a flat 1e-5
    at a depth where no ReLU flips."""
    size, n = INC_STEPS_SHAPE[name]
    orders = ((lambda a: a[::-1].copy(), lambda a: np.roll(a, 3, axis=0))
              if name == "inception1" else ())
    with _flax_dropout_off():
        jstate, jstep = _inc_jax(name, size=size)
        jstate, _ = jstep(jstate, _inc_batch(100, n, size),
                          jax.random.key(0))
        state, jstate, start, no_momentum, reordered = _steps_against_jax(
            lambda: _inc_carry(name, jstate, size=size), jstate, jstep,
            [_inc_batch(i, n, size) for i in range(3)], orders)
    assert state.step == 4
    count = _find(jstate.opt_state, optax.ScaleByScheduleState).count
    assert isinstance(state.optimizer, ScheduledSGD)
    assert float(state.optimizer.count) == int(count) == 4
    want = _inc_variables(name, jstate, size)
    floors = [_inc_variables(name, s, size) for s in reordered]
    tol = {k: 1e-5 + 3 * max((_leaf_gap(f[k], want[k]) for f in floors),
                             default=0.0) for k in want}
    _hold_leaves(state.module.state_dict(), want, tol, start, no_momentum)


class _FlaxInceptionBlock(flax_nn.Module):
    """The BN variant's blocks at the depth of one module: a ConvBN stem
    (3x3/2, SAME), an Inception module, an aux head, the main head."""

    @flax_nn.compact
    def __call__(self, x, train=False):
        x = jax_layers.ConvBN(16, (3, 3), (2, 2), name="stem")(x, train)
        x = jax_inception.InceptionModule(8, 8, 16, 4, 8, 8,
                                          name="mod")(x, train)
        main = flax_nn.Dense(CLASSES, name="fc")(
            jax_layers.global_avg_pool(x))
        if not train:
            return main
        return main, jax_inception.AuxiliaryClassifier(
            CLASSES, name="aux")(x, train)


class _InceptionBlock(torch.nn.Module):
    def __init__(self):
        super().__init__()
        f32 = torch.float32
        self.stem = layers.ConvBN(3, 16, (3, 3), (2, 2))
        self.mod = port_inception.InceptionModule(16, 8, 8, 16, 4, 8, 8,
                                                  f32, True)
        self.fc = torch.nn.Linear(40, CLASSES)
        self.aux = port_inception.AuxiliaryClassifier(40, 2, CLASSES, f32,
                                                      True)
        self.aux.dropout_rate = 0.0

    def forward(self, x, train=False, generator=None):
        x = self.mod(self.stem(x, train), train)
        main = self.fc(layers.global_avg_pool(x))
        if not train:
            return main
        return main, self.aux(x, train, generator)


def _port_leaves(module, variables):
    """flax ``variables`` under the names of ``module``'s state_dict (or
    of its parameters alone, for a tree of ``params`` only), conv and
    Dense kernels in torch's layout."""
    flat = flax.traverse_util.flatten_dict(variables)
    buffers = {name for name, _ in module.named_buffers()}
    names = (module.state_dict() if "batch_stats" in variables
             else dict(module.named_parameters()))
    out = {}
    for name in names:
        *path, leaf = name.split(".")
        a = np.asarray(flat["batch_stats" if name in buffers else "params",
                            *path, "kernel" if leaf == "weight" else leaf])
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T if a.ndim == 2 \
            else a
        out[name] = torch.from_numpy(a.copy())
    return out


def test_inception_bn_block_f32_train_steps_match_jax():
    """The BN variant's training path at a depth where float32 is exact
    enough for 1e-5: an Inception module of ConvBNs between a ConvBN stem
    and an aux head with its BN, at 16 px and batch 8 (the stem's BN
    normalizes 512 values a channel, the aux head's 32). Three f32 steps
    from a carried mid-training JAX state under the inception1 config's
    SGD (momentum 0.9 on every kernel, BN scale and bias, L2 2e-4,
    inception_poly): the loss within 1e-4, every parameter and BN
    statistic within a flat 1e-5, the update count exactly; the state
    before the steps and the same steps without momentum fail that."""
    model = _FlaxInceptionBlock()
    rng = np.random.default_rng(7)
    batches = [{"image": rng.normal(0, 1, (8, 16, 16, 3)).astype(np.float32),
                "label": rng.integers(0, CLASSES, 8).astype(np.int32)}
               for _ in range(4)]
    with _flax_dropout_off():
        shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=True),
                                jax.random.PRNGKey(0),
                                jnp.asarray(batches[0]["image"]))
        variables = jax.tree_util.tree_map_with_path(
            lambda p, leaf: inception_draw(p, leaf, rng), shapes)
        jstate, jstep = _jax_inc_state(model, variables)
        jstate, _ = jstep(jstate, batches[0], jax.random.key(0))

        host = jax.tree.map(np.asarray, jstate)

        def carry():
            module = _InceptionBlock()
            module.load_state_dict(_port_leaves(module, {
                "params": host.params, "batch_stats": host.batch_stats}))
            opt, _ = make_optimizer(get_config("inception1"),
                                    module.parameters(), INC_STEPS_PER_EPOCH)
            trace = _port_leaves(module,
                                 {"params": _find_trace(host.opt_state)})
            for name, p in module.named_parameters():
                opt.state[p]["momentum_buffer"] = trace[name]
            set_update_count(opt, int(_find(
                host.opt_state, optax.ScaleByScheduleState).count))
            return TrainState(module, opt)

        state, jstate, start, no_momentum, _ = _steps_against_jax(
            carry, jstate, jstep, batches[1:])
    assert float(state.optimizer.count) == int(
        _find(jstate.opt_state, optax.ScaleByScheduleState).count) == 4
    host = jax.tree.map(np.asarray, jstate)
    want = _port_leaves(state.module, {"params": host.params,
                                       "batch_stats": host.batch_stats})
    _hold_leaves(state.module.state_dict(), want, dict.fromkeys(want, 1e-5),
                 start, no_momentum)


def test_inception_bf16_train_step_twin_of_jax_bf16():
    """One bf16 step of the BN variant against JAX bf16 from the same
    carried state: the loss within the bf16-twin band."""
    with _flax_dropout_off():
        jstate, jstep = _inc_jax("inception1", jnp.bfloat16)
        state = _inc_carry("inception1", jstate, torch.bfloat16)
        batch = _inc_batch(10)
        jstate, jm = jstep(jstate, batch, jax.random.key(0))
    m = classification_train_step(state, _torch_batch(batch), KeySeq(1, 0)
                                  .__next__(), normalize_kind="torch")
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=CLS_LOSS_RTOL)


class _FlaxTinyBN(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, x, train=False):
        x = jax_layers.ConvBN(4, (3, 3), name="block")(x, train)
        return flax_nn.Dense(CLASSES, name="fc")(jnp.mean(x, axis=(1, 2)))


class _TinyBN(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.block = layers.ConvBN(3, 4, (3, 3))
        self.fc = torch.nn.Linear(4, CLASSES)

    def forward(self, x, train=False, generator=None):
        return self.fc(self.block(x, train).mean(dim=(1, 2)))


def test_nonfinite_step_keeps_bn_statistics_and_schedule_count():
    """Under loss scaling a batch with an inf pixel makes the gradients
    non-finite after its forward wrote NaN into the BN statistics: both
    states keep the pre-step parameters, momentum, BN statistics and the
    schedule's update count (so the LR does not advance), count the step,
    and halve the scale; the next finite steps agree again."""
    model = _FlaxTinyBN()
    x0 = np.zeros((1, 8, 8, 3), np.float32)
    variables = model.init(jax.random.PRNGKey(0), x0, train=True)
    tx, _ = jax_optimizers.make_optimizer(jax_get_config("inception1"),
                                          INC_STEPS_PER_EPOCH)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), apply_fn=model.apply, tx=tx,
        loss_scale=jax_get_policy("bf16_scaled").make_loss_scale())
    jstep = jax.jit(lambda s, b: jax_train_step(s, b, jax.random.key(0),
                                                normalize_kind="torch"))

    module = _TinyBN()
    p, bs = jax.tree.map(np.asarray, variables["params"]), \
        jax.tree.map(np.asarray, variables["batch_stats"])
    module.load_state_dict({
        "block.conv.weight": torch.from_numpy(
            p["block"]["conv"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "block.bn.scale": torch.tensor(p["block"]["bn"]["scale"]),
        "block.bn.bias": torch.tensor(p["block"]["bn"]["bias"]),
        "block.bn.mean": torch.tensor(bs["block"]["bn"]["mean"]),
        "block.bn.var": torch.tensor(bs["block"]["bn"]["var"]),
        "fc.weight": torch.tensor(p["fc"]["kernel"].T),
        "fc.bias": torch.tensor(p["fc"]["bias"])})
    opt, _ = make_optimizer(get_config("inception1"), module.parameters(),
                            INC_STEPS_PER_EPOCH)
    state = TrainState(module, opt, loss_scale=get_policy(
        "bf16_scaled").make_loss_scale(device="cpu"))

    def snapshot():
        return ({k: v.clone() for k, v in module.state_dict().items()},
                [{k: v.clone() for k, v in opt.state[q].items()}
                 for q in module.parameters()]
                + [{"count": opt.count.clone()}])

    def jax_count(s):
        return int(_find(s.opt_state, optax.ScaleByScheduleState).count)

    def agree():
        np.testing.assert_allclose(
            module.block.bn.var.numpy(),
            np.asarray(jstate.batch_stats["block"]["bn"]["var"]), atol=1e-5)
        np.testing.assert_allclose(
            module.fc.weight.detach().numpy(),
            np.asarray(jstate.params["fc"]["kernel"]).T, atol=1e-5)
        assert float(opt.count) == jax_count(jstate)
        assert float(state.loss_scale.scale) == float(jstate.loss_scale.scale)

    rng = np.random.default_rng(0)
    for i in range(4):
        batch = {"image": rng.normal(0, 1, (2, 8, 8, 3)).astype(np.float32),
                 "label": rng.integers(0, CLASSES, 2).astype(np.int32)}
        if i == 2:
            batch["image"][0, 3, 3, 1] = np.inf
            before, before_opt = snapshot()
            jbefore = jstate
        jstate, jm = jstep(jstate, batch)
        m = classification_train_step(state, _torch_batch(batch),
                                      torch.Generator(),
                                      normalize_kind="torch")
        assert float(m["mp_grads_finite"]) == float(jm["mp_grads_finite"])
        if i == 2:
            assert float(m["mp_grads_finite"]) == 0.0
            after, after_opt = snapshot()
            for k in before:  # BN statistics, parameters: bit for bit
                torch.testing.assert_close(after[k], before[k], rtol=0,
                                           atol=0, msg=k)
            for a, b in zip(after_opt, before_opt):
                for k in b:  # momentum and the update count
                    torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
            for a, b in zip(jax.tree.leaves(jstate.batch_stats),
                            jax.tree.leaves(jbefore.batch_stats)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert jax_count(jstate) == jax_count(jbefore) == 2
            assert state.step == int(jstate.step) == 3
        agree()
    assert jax_count(jstate) == 3


def test_inception_poly_through_make_optimizer_matches_optax():
    """The config's SGD under inception_poly over 2-step epochs, through
    both train states with loss scaling, for 9 updates with a skipped one
    among them: the same parameters after each, and the LR keeps
    following the count the select kept (optax's), not the step."""
    cfg = jax_get_config("inception1")
    tx, _ = jax_optimizers.make_optimizer(cfg, INC_STEPS_PER_EPOCH)
    params = _tiny_params(4)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=jp, batch_stats={},
        opt_state=tx.init(jp), apply_fn=None, tx=tx,
        loss_scale=jax_get_policy("bf16_scaled").make_loss_scale())
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(
            torch.from_numpy(v.copy())))
    opt, plateau = make_optimizer(get_config("inception1"),
                                  module.parameters(), INC_STEPS_PER_EPOCH)
    assert plateau is None and isinstance(opt, ScheduledSGD)
    state = TrainState(module, opt, loss_scale=get_policy(
        "bf16_scaled").make_loss_scale(device="cpu"))
    schedule = schedules.inception_poly(0.01, INC_STEPS_PER_EPOCH)
    rng = np.random.default_rng(5)
    for i in range(9):
        grads = {k: rng.normal(0, 1, v.shape).astype(np.float32)
                 for k, v in params.items()}
        if i == 3:
            grads["w"][0, 0] = np.nan
        scale = float(jstate.loss_scale.scale)
        jstate = jstate.apply_gradients(jax.tree.map(
            lambda g: jnp.asarray(g * scale), grads))
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(grads[k] * scale)
        count = float(opt.count)
        state.apply_gradients()
        updated = float(opt.count)
        assert updated == count + (i != 3)
        assert updated == int(_find(jstate.opt_state,
                                    optax.ScaleByScheduleState).count)
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jstate.params[k]),
                                       atol=1e-6, err_msg=f"{k} step {i}")
    assert state.step == 9 and updated == 8
    # epochs 0..3 of 2 updates: four distinct rates were used
    assert float(schedule(7)) < float(schedule(5)) < float(schedule(0))
    with pytest.raises(ValueError, match="steps_per_epoch"):
        make_optimizer(get_config("inception1"), module.parameters())


# ------------------------------------------ the CLI over ImageNet records


@pytest.fixture(scope="module")
def record_dir(tmp_path_factory):
    from tests.test_torch_imagenet import _write

    d = tmp_path_factory.mktemp("records")
    _write(d)
    return d


def _cli(record_dir, workdir, *flags):
    from tests.test_torch_imagenet import N_RAW, SIZE

    return ["-m", "resnet50", "--device", "cpu", "--data-dir",
            str(record_dir), "--input-size", str(SIZE), "--num-classes",
            str(N_RAW), "--batch-size", "4", "--steps-per-epoch", "2",
            "--lr", "0.001", "--workdir", str(workdir), *flags]


@pytest.mark.parametrize("flags", [
    ("--raw",), ("--raw", "--device-aug", "--mixup", "0.2")])
def test_cli_trains_resnet50_from_raw_records(record_dir, tmp_path, capsys,
                                              flags):
    """A tiny ``resnet50`` trained from test-written ``raw-train-*`` and
    ``validation-*`` shards: validation over the JPEGs, a checkpoint and
    a resume; the feed reports the uint8 wire at size²·3 image bytes an
    image (and the 4 bytes of its label beside them)."""
    from deepvision_tpu_torch.train.__main__ import main as train_main
    from tests.test_torch_imagenet import SIZE

    assert train_main([*_cli(record_dir, tmp_path, *flags),
                       "--epochs", "1"]) == 0
    out = capsys.readouterr().out
    assert "[pre-train] val_loss=" in out
    assert ("[device-aug] DeviceAugment(classification, flip, jitter=0.2, "
            "mixup=0.2)" in out) == ("--device-aug" in flags)
    image_bytes = SIZE * SIZE * 3
    assert (f"[feed] epoch 0: wire uint8, {image_bytes + 4.0} bytes an image "
            f"crossed ({float(image_bytes)} of them image bytes)") in out
    loss = [float(v) for v in re.findall(r"\] train_loss=(\S+)", out)]
    assert len(loss) == 1 and np.isfinite(loss[0])
    assert "val_top1=" in out.split("[epoch 0]")[1]
    assert train_main([*_cli(record_dir, tmp_path, *flags),
                       "--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed at epoch 1" in out and "[epoch 1]" in out
    state = torch.load(tmp_path / "resnet50" / "ckpt" / "1" / "state.pt",
                       weights_only=True)
    assert state["step"] == 4
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_trains_from_jpeg_records(record_dir, tmp_path, capsys):
    """``--no-raw --device-aug``: the JPEG shards cross packed and decode
    on the feed (PIL on the CPU, so the card's ``ycc_to_rgb`` kernel is
    never launched); the feed counts the JPEG bytes."""
    from deepvision_tpu_torch.train.__main__ import main as train_main

    assert train_main([*_cli(record_dir, tmp_path, "--no-raw",
                             "--device-aug"), "--epochs", "1"]) == 0
    captured = capsys.readouterr()
    assert "[feed] epoch 0: wire jpeg" in captured.out
    assert "raw-frame fast path" not in captured.out
    assert "'ycc_to_rgb': 0, 'nms_sweep': 0}" in captured.err.splitlines()[-1]
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("flags,needs_dir,message", [
    (("--raw",), False, "--raw/--no-raw only applies"),
    (("--no-raw",), False, "--raw/--no-raw only applies"),
    (("--device-aug",), False, "--device-aug splits a record-backed"),
    (("--mixup", "0.2"), False, "--mixup is a device-side"),
    (("--mixup", "0.2"), True, "--mixup is a device-side"),
    (("--device-aug", "--mixup", "-1"), True, "--mixup must be >= 0"),
])
def test_cli_refuses_the_data_flags_as_train_py_does(
        record_dir, tmp_path, monkeypatch, flags, needs_dir, message):
    """Each refusal of ``train.py`` reproduced by the port's CLI, with the
    same leading words; both refuse before touching data or a device."""
    import sys

    import train as jax_train
    from deepvision_tpu_torch.train.__main__ import main as train_main

    data = ("--data-dir", str(record_dir)) if needs_dir else ()
    args = ["-m", "resnet50", *data, *flags, "--workdir", str(tmp_path)]
    with pytest.raises(SystemExit, match=message.replace("+", r"\+")) as ours:
        train_main(args)
    monkeypatch.setattr(sys, "argv", ["train.py", *args])
    with pytest.raises(SystemExit) as theirs:
        jax_train.main()
    assert str(theirs.value).startswith(message), theirs.value
    assert str(ours.value).split(" (this run")[0][:20] \
        == str(theirs.value)[:20]
