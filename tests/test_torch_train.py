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

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.core.precision import DynamicLossScale as JaxLossScale
from deepvision_tpu.data import mnist as jax_mnist
from deepvision_tpu.data import padding as jax_padding
from deepvision_tpu.data.synthetic import (
    synthetic_classification as jax_synthetic,
)
from deepvision_tpu.losses import classification as jax_losses
from deepvision_tpu.models import get_model as flax_get_model
from deepvision_tpu.ops import normalize as jax_normalize
from deepvision_tpu.train import optimizers as jax_optimizers
from deepvision_tpu.train import schedules as jax_schedules
from deepvision_tpu.train.configs import get_config as jax_get_config
from deepvision_tpu.train.state import create_train_state
from deepvision_tpu.train.steps import (
    aggregate_eval_parts as jax_aggregate_eval_parts,
    classification_eval_step as jax_eval_step,
    classification_train_step as jax_train_step,
)
from deepvision_tpu_torch.convert.from_flax import (
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
from deepvision_tpu_torch.train.configs import get_config
from deepvision_tpu_torch.train.optimizers import make_optimizer, set_lr_scale
from deepvision_tpu_torch.train.state import TrainState
from deepvision_tpu_torch.train.steps import (
    aggregate_eval_parts,
    classification_eval_step,
    classification_train_step,
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
    ("rmsprop", None, "C7"), ("adam", None, "C7"),
    ("sgd", "step", "scheduler 'step'")])
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
            assert ours(count) == pytest.approx(float(theirs(count)),
                                                rel=1e-6, abs=1e-12)


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


def _find_trace(opt_state):
    if isinstance(opt_state, optax.TraceState):
        return opt_state.trace
    if isinstance(opt_state, tuple):
        for part in opt_state:
            found = _find_trace(part)
            if found is not None:
                return found
    inner = getattr(opt_state, "inner_state", None)
    return None if inner is None else _find_trace(inner)


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
    for name in ("alexnet1", "alexnet2"):
        ours, theirs = get_config(name), jax_get_config(name)
        for key in ("precision", "augment", "batch_size", "input_size",
                    "channels", "num_classes", "dataset", "optimizer",
                    "optimizer_params", "scheduler", "scheduler_params",
                    "total_epochs", "name"):
            assert ours[key] == theirs[key], (name, key)
    assert "optimizer" not in get_config("alexnet2_tf")
    ours = get_config("alexnet1")
    ours["optimizer_params"]["lr"] = 1.0  # a copy, not the table
    assert get_config("alexnet1")["optimizer_params"]["lr"] == 0.01


def test_policy_dataclass_is_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        get_policy("bf16").loss_scaling = True
