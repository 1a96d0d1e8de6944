"""GAN training: the two-optimizer state, the DCGAN and CycleGAN steps,
the image pool and the epoch loop, the twin of
``deepvision_tpu/train/gan.py``.

- :class:`GANState`: the nets by role name (``generator`` and
  ``discriminator`` for DCGAN; ``gen_a2b``, ``gen_b2a``, ``dis_a`` and
  ``dis_b`` for CycleGAN), a ``"generator"`` optimizer over every
  generator's parameters and a ``"discriminator"`` one over every
  critic's, one optional :class:`DynamicLossScale` shared by both tapes,
  the image pools and the step. :meth:`GANState.apply_gradients` is the
  JAX ``_gan_apply_gradients``: with a loss scale, both tapes' gradients
  are unscaled, their finiteness is taken jointly, non-finite gradients
  are zeroed before either optimizer runs, and on a non-finite step
  everything keeps its value (every parameter, both optimizers' state
  and counts, every BN statistic, both pools) while the scale backs off:
  half a GAN update is worse than none.
- :func:`dcgan_train_step`: both gradients at the pre-update parameters
  of one shared forward. The noise and the discriminator's dropout masks
  come from :func:`dcgan_draws`; the fake pass's masks are the SAME
  masks in the generator's tape and the discriminator's, and the
  discriminator's tape runs its real pass before its fake pass.
- :func:`cyclegan_train_step`: phase 1 runs the six generator
  applications and two critic applications in training mode, BN
  statistics chaining in the JAX order, and takes gradients for the
  generators only; each pool is then queried on the detached fakes
  (:func:`pool_query`, with coins and indices from
  :func:`pool_query_params`); phase 2 runs the critics on real and pooled
  images from the statistics phase 1 left. Gradients are taken with
  ``torch.autograd.grad`` for the phase's own parameters, never
  accumulated into another net's ``.grad``.
- :func:`fit_gan`: the epoch loop with what the port's Trainer has: a
  checkpoint every ``save_every`` epochs (and the last) keeping 3,
  resume, the epoch's stream ``KeySeq(1234, epoch)`` (the JAX loop folds
  the epoch into ``key(1234)``), metrics fetched every ``log_every``
  steps and at the epoch's end, the prefetch feed and its telemetry.

Every draw (noise, masks, pool coins and indices) is made on the
device by a ``torch.Generator`` in a function that returns it, and the
steps take the draws as arguments (trap C6): a test passes the JAX run's
values. No step waits for the host.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Iterable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepvision_tpu_torch.core.precision import (
    DynamicLossScale,
    all_finite,
    precision_metrics,
)
from deepvision_tpu_torch.train.state import guarded_step

__all__ = ["LAMBDA_CYCLE", "LAMBDA_ID", "POOL_SIZE", "GANState",
           "create_dcgan_state", "dcgan_draws", "dcgan_train_step",
           "dcgan_sample", "create_pool", "pool_query_params", "pool_query",
           "create_cyclegan_state", "cyclegan_draws", "cyclegan_train_step",
           "cyclegan_translate", "fit_gan", "DCGAN_ROLES", "CYCLEGAN_ROLES"]

LAMBDA_CYCLE = 10.0
LAMBDA_ID = 5.0
POOL_SIZE = 50
# the nets each optimizer spans, by optimizer
DCGAN_ROLES = {"generator": ("generator",),
               "discriminator": ("discriminator",)}
CYCLEGAN_ROLES = {"generator": ("gen_a2b", "gen_b2a"),
                  "discriminator": ("dis_a", "dis_b")}
# the epoch loop's base seed, the JAX loop's key(1234)
_BASE_SEED = 1234


class GANState:
    """The two-network train state, updated in place. ``modules`` maps
    each net's role name to its module (parameters: float32 masters;
    buffers: BN statistics); ``optimizers`` maps ``"generator"`` and
    ``"discriminator"`` to the optimizer over the nets ``roles`` assigns
    it; ``pools`` maps a pool's name to ``{"images", "count"}`` device
    tensors; ``step`` counts updates on the host, skipped ones
    included."""

    def __init__(self, modules: Mapping[str, nn.Module],
                 optimizers: Mapping[str, torch.optim.Optimizer],
                 roles: Mapping[str, tuple[str, ...]], *,
                 loss_scale: DynamicLossScale | None = None,
                 pools: Mapping[str, dict] | None = None,
                 noise_dim: int = 100):
        self.modules = dict(modules)
        self.optimizers = dict(optimizers)
        self.roles = {k: tuple(v) for k, v in roles.items()}
        self.loss_scale = loss_scale
        self.pools = {k: dict(v) for k, v in (pools or {}).items()}
        self.noise_dim = noise_dim
        self.step = 0

    @property
    def device(self) -> torch.device:
        return next(next(iter(self.modules.values())).parameters()).device

    def params(self, optimizer: str) -> list[nn.Parameter]:
        """The parameters ``optimizer`` updates, in its order."""
        return [p for name in self.roles[optimizer]
                for p in self.modules[name].parameters()]

    def buffers(self) -> list[torch.Tensor]:
        return [b for m in self.modules.values() for b in m.buffers()]

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        if self.loss_scale is None:
            return loss
        return self.loss_scale.scale_loss(loss)

    @torch.no_grad()
    def copy_batch_stats(self) -> list[torch.Tensor] | None:
        """Copies of every net's BN statistics before the step's
        forwards, restored on a non-finite step; None without loss
        scaling."""
        if self.loss_scale is None:
            return None
        return [b.clone() for b in self.buffers()]

    @torch.no_grad()
    def apply_gradients(self, grads: Mapping[str, Iterable[torch.Tensor]],
                        batch_stats: list[torch.Tensor] | None = None,
                        pools: Mapping[str, dict] | None = None) -> None:
        """One update of both optimizers from ``grads`` (optimizer name
        -> the gradients of :meth:`params` in order, scaled by the loss
        scale if any). ``batch_stats``: :meth:`copy_batch_stats` before
        the forwards; ``pools``: the pools the step queried, which
        replace the state's unless the step is not finite."""
        self.step += 1
        for name, gs in grads.items():
            for p, g in zip(self.params(name), gs):
                p.grad = g
        ls = self.loss_scale
        if ls is None:
            for opt in self.optimizers.values():
                opt.step()
            if pools is not None:
                self.pools = {k: dict(v) for k, v in pools.items()}
            return
        every = {name: [p for p in self.params(name) if p.grad is not None]
                 for name in self.optimizers}
        grads_all = [p.grad for ps in every.values() for p in ps]
        ls.unscale_(grads_all)
        finite = all_finite(grads_all).to(ls.scale.device)
        ls.adjust(finite)
        for g in grads_all:  # zeroed before either optimizer (inf * 0)
            g.masked_fill_(~finite, 0.0)
        for name, opt in self.optimizers.items():
            guarded_step(opt, every[name], finite)
        for b, old in zip(self.buffers(), batch_stats or ()):
            b.copy_(torch.where(finite, b, old))
        if pools is not None:
            self.pools = {k: {leaf: torch.where(finite, v, self.pools[k][leaf])
                              for leaf, v in pool.items()}
                          for k, pool in pools.items()}

    def state_dict(self) -> dict:
        return {"modules": {k: m.state_dict()
                            for k, m in self.modules.items()},
                "optimizers": {k: o.state_dict()
                               for k, o in self.optimizers.items()},
                "pools": {k: dict(v) for k, v in self.pools.items()},
                "step": self.step,
                "loss_scale": (None if self.loss_scale is None
                               else self.loss_scale.state_dict())}

    def load_state_dict(self, d: dict) -> None:
        if set(d["modules"]) != set(self.modules):
            raise ValueError(f"checkpoint nets {sorted(d['modules'])} are "
                             f"not this state's {sorted(self.modules)}")
        for k, m in self.modules.items():
            m.load_state_dict(d["modules"][k])
        for k, o in self.optimizers.items():
            o.load_state_dict(d["optimizers"][k])
        dev = self.device
        self.pools = {k: {leaf: t.to(dev) for leaf, t in v.items()}
                      for k, v in d["pools"].items()}
        self.step = int(d["step"])
        if (d["loss_scale"] is None) != (self.loss_scale is None):
            raise ValueError(
                "checkpoint and train state disagree on loss scaling")
        if self.loss_scale is not None:
            self.loss_scale.load_state_dict(d["loss_scale"])


def _bce(logits: torch.Tensor, is_real: bool,
         smooth: float = 0.0) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy`` against 1 - ``smooth``
    (real) or 0 (fake), averaged; ``smooth`` is one-sided label
    smoothing of the real targets."""
    target = 1.0 - smooth if is_real else 0.0
    return torch.mean(-target * F.logsigmoid(logits)
                      - (1.0 - target) * F.logsigmoid(-logits))


def _lsgan(pred: torch.Tensor, is_real: bool) -> torch.Tensor:
    return torch.mean((pred - (1.0 if is_real else 0.0)) ** 2)


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def _net_seed(seed: int, i: int) -> int:
    seq = np.random.SeedSequence(int(seed), spawn_key=(i,))
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _build(name: str, device: torch.device, seed: int, **kw) -> nn.Module:
    from deepvision_tpu_torch.models import create_model

    return create_model(name, device=device, seed=seed, **kw)


# --------------------------------------------------------------- DCGAN


def create_dcgan_state(*, noise_dim: int = 100, lr: float = 1e-4,
                       seed: int = 0, policy=None,
                       dtype: torch.dtype = torch.float32,
                       device: torch.device | str | None = None
                       ) -> GANState:
    """The DCGAN pair with fresh weights from ``seed`` on ``device`` (the
    card unless the caller asks for the CPU) in the compute ``dtype``,
    two Adams at ``lr`` (optax's ``adam(lr)``), and the policy's shared
    loss scale."""
    from deepvision_tpu_torch.device import resolve_device
    from deepvision_tpu_torch.train.optimizers import make_optimizer

    dev = resolve_device(device)
    modules = {
        "generator": _build("dcgan_generator", dev, _net_seed(seed, 0),
                            noise_dim=noise_dim, dtype=dtype),
        "discriminator": _build("dcgan_discriminator", dev,
                                _net_seed(seed, 1), dtype=dtype)}
    cfg = {"optimizer": "adam", "optimizer_params": {"lr": lr}}
    optimizers = {role: make_optimizer(cfg, modules[role].parameters())[0]
                  for role in DCGAN_ROLES}
    return GANState(modules, optimizers, DCGAN_ROLES,
                    loss_scale=(policy.make_loss_scale(dev)
                                if policy is not None else None),
                    noise_dim=noise_dim)


def dcgan_draws(generator: torch.Generator, batch: int,
                noise_dim: int) -> dict:
    """One DCGAN step's draws on the generator's device: ``z`` (``(batch,
    noise_dim)``, N(0, 1)), and the discriminator's two dropout keep
    masks for the fake pass (``masks_fake``, shared by both tapes) and
    for the real pass (``masks_real``)."""
    from deepvision_tpu_torch.models.gan import (
        DROPOUT_RATE,
        DCGANDiscriminator,
    )

    dev = generator.device
    z = torch.randn((batch, noise_dim), generator=generator, device=dev)

    def masks():
        return tuple(torch.rand(s, generator=generator, device=dev)
                     < 1.0 - DROPOUT_RATE
                     for s in DCGANDiscriminator.mask_shapes(batch))

    return {"z": z, "masks_fake": masks(), "masks_real": masks()}


def dcgan_train_step(state: GANState, batch: dict, draws,
                     label_smooth: float = 0.0) -> dict:
    """One simultaneous G and D update on ``{"image"}`` (``(B, 28, 28,
    1)`` in [-1, 1]); ``draws`` is :func:`dcgan_draws`' dict, or a
    ``torch.Generator`` to draw it from. ``label_smooth`` smooths the
    discriminator's real targets only. Returns ``g_loss``, ``d_loss``
    and the precision metrics (device tensors)."""
    real = batch["image"]
    if isinstance(draws, torch.Generator):
        draws = dcgan_draws(draws, real.shape[0], state.noise_dim)
    gen, dis = state.modules["generator"], state.modules["discriminator"]
    batch_stats = state.copy_batch_stats()
    fake = gen(draws["z"], train=True)
    g_loss = _bce(dis(fake, train=True, masks=draws["masks_fake"]), True)
    g_grads = torch.autograd.grad(state.scale_loss(g_loss),
                                  state.params("generator"))
    real_logits = dis(real, train=True, masks=draws["masks_real"])
    fake_logits = dis(fake.detach(), train=True, masks=draws["masks_fake"])
    d_loss = (_bce(real_logits, True, smooth=label_smooth)
              + _bce(fake_logits, False))
    d_grads = torch.autograd.grad(state.scale_loss(d_loss),
                                  state.params("discriminator"))
    state.apply_gradients({"generator": g_grads, "discriminator": d_grads},
                          batch_stats)
    return {"g_loss": g_loss.detach(), "d_loss": d_loss.detach(),
            **precision_metrics(state)}


@torch.no_grad()
def dcgan_sample(state: GANState, z: torch.Tensor) -> torch.Tensor:
    """Images of the generator in evaluation mode from noise ``z``."""
    return state.modules["generator"](z.to(state.device), train=False)


# ----------------------------------------------------------- ImagePool


def create_pool(size: int, image_shape, device: torch.device,
                dtype: torch.dtype = torch.float32) -> dict:
    return {"images": torch.zeros((size, *image_shape), dtype=dtype,
                                  device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def pool_query_params(generator: torch.Generator, n: int, size: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One query's draws for ``n`` images on the generator's device:
    each image's coin, U[0, 1) (swap when above 0.5), and its stored
    image's index in [0, ``size``)."""
    dev = generator.device
    coins = torch.rand(n, generator=generator, device=dev)
    index = torch.randint(0, size, (n,), generator=generator, device=dev)
    return coins, index


def pool_query(pool: dict, images: torch.Tensor, coins: torch.Tensor,
               index: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """The historical-fake buffer, image by image as the JAX scan: while
    the buffer is not full, store the image and return it; afterwards, if
    the coin is above 0.5, swap it with stored image ``index`` and return
    the stored one, else return it. -> (images out, the new pool); the
    given pool is not modified. The fill-or-swap choice is a
    ``torch.where`` on device tensors: no host sync."""
    buf, count = pool["images"], pool["count"]
    size = buf.shape[0]
    index = index.to(count.device)
    outs = []
    for i in range(images.shape[0]):
        img = images[i]
        fill = count < size
        take = ~fill & (coins[i] > 0.5)
        slot = torch.where(fill, count.long(), index[i]).reshape(1)
        stored = buf.index_select(0, slot)[0]
        kept = torch.where(fill | take, img, stored)
        buf = buf.index_copy(0, slot, kept[None])
        outs.append(torch.where(take, stored, img))
        count = count + fill.to(count.dtype)
    return torch.stack(outs), {"images": buf, "count": count}


# ------------------------------------------------------------ CycleGAN


def create_cyclegan_state(*, lr_schedule, image_size: int = 256,
                          beta1: float = 0.5, pool_size: int = POOL_SIZE,
                          seed: int = 0, policy=None,
                          dtype: torch.dtype = torch.float32,
                          device: torch.device | str | None = None,
                          **model_kw) -> GANState:
    """Two generators and two PatchGANs with fresh weights from ``seed``
    on ``device`` in ``dtype`` (``model_kw``: ``norm``, and the
    generators' ``n_blocks``), two Adams (β1 ``beta1``) over
    {``gen_a2b``, ``gen_b2a``} and {``dis_a``, ``dis_b``} whose learning
    rate is ``lr_schedule`` of the update count (``schedules.linear_decay``
    as the config trains), two empty pools of
    ``pool_size`` images of ``image_size``², and the policy's shared loss
    scale."""
    from deepvision_tpu_torch.device import resolve_device
    from deepvision_tpu_torch.train.optimizers import ScheduledAdam

    dev = resolve_device(device)
    d_kw = {k: v for k, v in model_kw.items() if k == "norm"}
    modules = {}
    for i, name in enumerate(("gen_a2b", "gen_b2a", "dis_a", "dis_b")):
        kind = "cyclegan_generator" if name.startswith("gen") \
            else "cyclegan_discriminator"
        modules[name] = _build(kind, dev, _net_seed(seed, i), dtype=dtype,
                               **(model_kw if name.startswith("gen")
                                  else d_kw))
    base = float(lr_schedule(0))
    optimizers = {}
    for role, names in CYCLEGAN_ROLES.items():
        opt = ScheduledAdam([p for n in names
                             for p in modules[n].parameters()],
                            lr_schedule, lr=base, betas=(beta1, 0.999))
        for group in opt.param_groups:
            group["base_lr"], group["lr_scale"] = base, 1.0
        optimizers[role] = opt
    shape = (image_size, image_size, 3)
    return GANState(modules, optimizers, CYCLEGAN_ROLES,
                    loss_scale=(policy.make_loss_scale(dev)
                                if policy is not None else None),
                    pools={k: create_pool(pool_size, shape, dev)
                           for k in ("pool_a2b", "pool_b2a")})


def cyclegan_draws(generator: torch.Generator, batch: int,
                   pool_size: int) -> dict:
    """One CycleGAN step's draws: each pool's query params
    (:func:`pool_query_params`)."""
    return {k: pool_query_params(generator, batch, pool_size)
            for k in ("pool_a2b", "pool_b2a")}


def cyclegan_train_step(state: GANState, batch: dict, draws) -> dict:
    """One two-phase step on ``{"a", "b"}`` image batches in [-1, 1];
    ``draws`` is :func:`cyclegan_draws`' dict, or a ``torch.Generator``
    to draw it from. Returns the generators' losses (``loss_gen_*``,
    ``loss_cycle_*``, ``loss_id_*``), the critics' (``loss_dis_*``) and
    the precision metrics (device tensors)."""
    real_a, real_b = batch["a"], batch["b"]
    if isinstance(draws, torch.Generator):
        draws = cyclegan_draws(draws, real_a.shape[0],
                               state.pools["pool_a2b"]["images"].shape[0])
    m = state.modules
    gab, gba, da, db = m["gen_a2b"], m["gen_b2a"], m["dis_a"], m["dis_b"]
    batch_stats = state.copy_batch_stats()
    # phase 1: the generators, the critics' statistics updating too
    fake_a2b = gab(real_a, train=True)
    recon_b2a = gba(fake_a2b, train=True)
    fake_b2a = gba(real_b, train=True)
    recon_a2b = gab(fake_b2a, train=True)
    identity_a2b = gab(real_b, train=True)
    identity_b2a = gba(real_a, train=True)
    logits_b = db(fake_a2b, train=True)
    logits_a = da(fake_b2a, train=True)
    g = {"loss_gen_a2b": _lsgan(logits_b, True),
         "loss_gen_b2a": _lsgan(logits_a, True),
         "loss_cycle_a2b2a": _l1(recon_b2a, real_a),
         "loss_cycle_b2a2b": _l1(recon_a2b, real_b),
         "loss_id_a2b": _l1(identity_a2b, real_b),
         "loss_id_b2a": _l1(identity_b2a, real_a)}
    g["loss_gen_total"] = (
        g["loss_gen_a2b"] + g["loss_gen_b2a"]
        + (g["loss_cycle_a2b2a"] + g["loss_cycle_b2a2b"]) * LAMBDA_CYCLE
        + (g["loss_id_a2b"] + g["loss_id_b2a"]) * LAMBDA_ID)
    g_grads = torch.autograd.grad(state.scale_loss(g["loss_gen_total"]),
                                  state.params("generator"))
    # the pools, on the fresh fakes
    pooled_a2b, pool_a2b = pool_query(state.pools["pool_a2b"],
                                      fake_a2b.detach(), *draws["pool_a2b"])
    pooled_b2a, pool_b2a = pool_query(state.pools["pool_b2a"],
                                      fake_b2a.detach(), *draws["pool_b2a"])
    # phase 2: the critics on real and pooled images
    ra = da(real_a, train=True)
    fa = da(pooled_b2a, train=True)
    rb = db(real_b, train=True)
    fb = db(pooled_a2b, train=True)
    d = {"loss_dis_a": (_lsgan(ra, True) + _lsgan(fa, False)) * 0.5,
         "loss_dis_b": (_lsgan(rb, True) + _lsgan(fb, False)) * 0.5}
    d["loss_dis_total"] = d["loss_dis_a"] + d["loss_dis_b"]
    d_grads = torch.autograd.grad(state.scale_loss(d["loss_dis_total"]),
                                  state.params("discriminator"))
    state.apply_gradients({"generator": g_grads, "discriminator": d_grads},
                          batch_stats,
                          {"pool_a2b": pool_a2b, "pool_b2a": pool_b2a})
    return {**{k: v.detach() for k, v in {**g, **d}.items()},
            **precision_metrics(state)}


@torch.no_grad()
def cyclegan_translate(state: GANState, images: torch.Tensor,
                       direction: str = "a2b") -> torch.Tensor:
    """Translation by ``gen_{direction}`` in evaluation mode."""
    return state.modules[f"gen_{direction}"](images.to(state.device),
                                             train=False)


# ---------------------------------------------------------- epoch loop


def fit_gan(state: GANState, train_step: Callable, train_data, *,
            epochs: int, workdir: str | Path = "runs/gan",
            save_every: int = 2, log_every: int = 50, resume: bool = False,
            resume_epoch: int | None = None, prefetch_depth: int = 2,
            config: dict | None = None):
    """The GAN epoch loop: ``train_step(state, device_batch, generator)``
    over ``train_data(epoch)`` (host batches, through the device feed),
    one generator a step from the epoch's stream ``KeySeq(1234, epoch)``;
    a checkpoint under ``{workdir}/ckpt`` every ``save_every`` epochs and
    at the last, keeping 3, with ``config``'s model geometry; ``resume``
    restores the newest (or ``resume_epoch``'s) verified checkpoint and
    goes on at the next epoch. Returns the metric history."""
    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.data.prefetch import (
        DevicePrefetcher,
        FeedTelemetry,
    )
    from deepvision_tpu_torch.train.checkpoint import CheckpointManager
    from deepvision_tpu_torch.train.loggers import Loggers

    if prefetch_depth < 1:
        raise ValueError(f"prefetch_depth must be >= 1, got {prefetch_depth}")
    mgr = CheckpointManager(Path(workdir) / "ckpt")
    loggers = Loggers()
    start = 0
    if resume and mgr.latest_epoch() is not None:
        meta = mgr.restore(state, resume_epoch)
        start = meta["epoch"] + 1
        if meta.get("loggers"):
            loggers = meta["loggers"]
        print(f"resumed at epoch {start}", flush=True)
    device = state.device
    for epoch in range(start, epochs):
        keys = KeySeq(_BASE_SEED, epoch, device=device)
        pending: list[dict] = []
        fetched: list[dict] = []
        images = 0

        def drain():
            if not pending:
                return
            names = list(pending[0])
            values = torch.stack([torch.stack([m[k].float() for k in names])
                                  for m in pending]).tolist()
            fetched.extend(dict(zip(names, row)) for row in values)
            pending.clear()

        tel = FeedTelemetry()
        t0 = time.perf_counter()
        feed = DevicePrefetcher(train_data(epoch), device,
                                depth=prefetch_depth, telemetry=tel)
        try:
            for i, batch in enumerate(feed):
                images += len(next(iter(batch.values())))
                pending.append(train_step(state, batch, next(keys)))
                if log_every and i % log_every == 0:
                    drain()
                    print(f"[epoch {epoch} batch {i}] " + " ".join(
                        f"{k}={v:.4f}"
                        for k, v in sorted(fetched[-1].items())), flush=True)
        finally:
            feed.close()
        drain()  # waits for the epoch's last step
        dt = time.perf_counter() - t0
        summary = tel.summary()
        metrics = {k: float(np.mean([m[k] for m in fetched]))
                   for k in (fetched[0] if fetched else {})}
        metrics.update({f"input_{k}": float(summary[k]) for k in (
            "host_wait_ms", "shard_ms", "h2d_wait_ms", "step_ms",
            "wait_frac", "h2d_bytes_per_image", "image_bytes_per_image")})
        metrics["examples_per_sec"] = images / dt
        loggers.log_metrics(epoch, metrics)
        print(f"[feed] epoch {epoch}: wire {summary['wire_dtype']}, "
              f"{summary['h2d_bytes_per_image']} bytes an image crossed, "
              f"h2d_wait {summary['h2d_wait_ms']} ms and host_wait "
              f"{summary['host_wait_ms']} ms a batch", flush=True)
        print(f"[epoch {epoch}] " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
            + f" time={dt:.1f}s", flush=True)
        if (epoch + 1) % save_every == 0 or epoch == epochs - 1:
            mgr.save(epoch, state, loggers=loggers, config=config)
    return loggers
