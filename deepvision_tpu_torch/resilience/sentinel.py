"""Silent-failure defense on one host: sentinel scalars computed in the
step, an EWMA z-score detector, bit-exact state fingerprints and the
SDC drills, the port's twin of ``deepvision_tpu/resilience/sentinel.py``.

- :func:`sentinel_step` wraps a train step so that it also returns
  ``sent_update_norm`` (the L2 norm of the parameter update, the
  stand-in for the global gradient norm), ``sent_param_norm`` and their
  ratio ``sent_update_ratio``, as 0-d tensors on the device. They ride
  the step's metrics, which the Trainer fetches on its drain cadence:
  no host sync a step.
- :class:`EwmaDetector` z-scores each watched series against its own
  exponentially weighted history; :class:`SentinelMonitor` folds the
  drained ``loss`` and ``sent_*`` into it and raises
  :class:`SentinelTrip` (a :class:`NumericDivergence`, so the Trainer's
  rollback handles it) on an anomaly.
- :func:`tree_fingerprint` is the JAX function, bit for bit, over a tree
  of numpy or torch leaves: a seeded random-sign projection and the
  energies of the leaves, accumulated in float64 and digested.
  :func:`state_tree` gives a module's weights as the JAX Trainer's
  ``{"params": ..., "batch_stats": ...}`` tree: the flax paths (the
  port's parameter names are them, ``convert/from_flax.py``) and the
  flax layouts (conv kernels ``(KH, KW, I, O)``, dense kernels ``(in,
  out)``), so that the same weights fingerprint to the same digest on
  both sides. Trap C28: the digest depends on the leaf order (sorted
  keys), the path strings (which seed the signs) and the float64
  accumulation in that order.
- :func:`apply_sdc` applies an ``sdc_grad`` (scale the largest
  parameter) or ``sdc_param`` (flip the low mantissa bit of its first
  element) fault in place.

The cross-host agreement audit (the fingerprint compared across hosts
every ``audit_every`` steps) waits for the port's cluster; the
fingerprint already rides the checkpoint manifest (audited checkpoints,
``train/checkpoint.py``).
"""

from __future__ import annotations

import hashlib
import math
import struct

import numpy as np
import torch

from deepvision_tpu_torch.obs.metrics import default_registry
from deepvision_tpu_torch.resilience.recovery import NumericDivergence

__all__ = [
    "EwmaDetector",
    "SENTINEL_KEYS",
    "SentinelMonitor",
    "SentinelTrip",
    "apply_sdc",
    "fingerprint_deviation",
    "fingerprints_agree",
    "sentinel_step",
    "state_tree",
    "tree_fingerprint",
]

SENTINEL_KEYS = ("sent_update_norm", "sent_param_norm",
                 "sent_update_ratio")
_FP_BUCKETS = 8  # projection components per fingerprint
# sdc_grad's default scale: a wrong-magnitude update, silent to the
# z-score at this size (the cross-host audit's case); ":ARG" overrides
# it for the loud single-host drills
SDC_GRAD_SCALE = 1.0 + 2.0 ** -10


class SentinelTrip(NumericDivergence):
    """A sentinel series z-scored outside its history: the silent twin
    of the NaN tripwire, handled by the same rollback."""

    def __init__(self, epoch: int, step_in_epoch: int, key: str,
                 value: float, z: float):
        self.key = key
        self.value = float(value)
        self.z = float(z)
        super().__init__(epoch, step_in_epoch)
        self.args = (
            f"sentinel {key}={value:.6g} tripped (|z|={z:.1f}) at "
            f"epoch {epoch} step {step_in_epoch}",)

    def __str__(self) -> str:
        return self.args[0]


# ------------------------------------------------------------ in the step


def _float_params(module) -> list[torch.Tensor]:
    return [p for p in module.parameters() if p.is_floating_point()]


def sentinel_step(step_fn):
    """Wrap ``step_fn(state, batch, generator) -> metrics`` (a step that
    updates ``state.module``'s parameters in place) so that its metrics
    also carry the sentinel scalars, computed on the device from a copy
    of the parameters taken before the step: a few reductions a step and
    no host sync."""

    def wrapped(state, batch, generator):
        params = _float_params(state.module)
        with torch.no_grad():
            before = [p.detach().float().clone() for p in params]
        metrics = step_fn(state, batch, generator)
        with torch.no_grad():
            after = [p.detach().float() for p in params]
            delta = torch._foreach_sub(after, before)
            update = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(delta)))
            param = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(after)))
        return {**metrics, "sent_update_norm": update,
                "sent_param_norm": param,
                "sent_update_ratio": update / (param + 1e-12)}

    return wrapped


# ----------------------------------------------------------- the detector


class EwmaDetector:
    """Per-series EWMA mean/variance z-score anomaly detector.

    Follows benign drift while a step-function anomaly lands many sigma
    outside the band. ``warmup`` observations per key must land before
    any z-test; a non-finite value trips at once, warmup included. A
    relative sigma floor keeps a converged, near-constant series from
    shrinking its band to machine epsilon."""

    def __init__(self, *, z_threshold: float = 8.0, warmup: int = 16,
                 alpha: float = 0.2, min_rel_sigma: float = 1e-3):
        if z_threshold <= 0:
            raise ValueError(f"z_threshold must be > 0, got {z_threshold}")
        if warmup < 2:
            raise ValueError(f"warmup must be >= 2, got {warmup}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.z_threshold = float(z_threshold)
        self.warmup = int(warmup)
        self.alpha = float(alpha)
        self.min_rel_sigma = float(min_rel_sigma)
        self._stats: dict[str, list] = {}  # key -> [count, mean, var]

    def reset(self) -> None:
        """Forget all history (after a rollback, every series jumps)."""
        self._stats.clear()

    def observe(self, key: str, value: float) -> float | None:
        """Fold one sample in; returns the |z|-score when it TRIPS
        (non-finite, or outside the band after the warmup), else None."""
        value = float(value)
        if not math.isfinite(value):
            return float("inf")
        st = self._stats.get(key)
        if st is None:
            st = self._stats[key] = [0, value, 0.0]
        count, mean, var = st
        z = None
        if count >= self.warmup:
            sigma = math.sqrt(var)
            floor = self.min_rel_sigma * max(abs(mean), 1e-12)
            sigma = max(sigma, floor)
            z = abs(value - mean) / sigma
        # the update comes after the test, so that an anomaly does not
        # move its own band (West 1979's incremental form)
        a = self.alpha if count else 1.0
        d = value - mean
        st[0] = count + 1
        st[1] = mean + a * d
        st[2] = (1.0 - a) * (var + a * d * d) if count else 0.0
        if z is not None and z > self.z_threshold:
            return z
        return None


# ---------------------------------------------------------- fingerprints


def _to_flax_layout(a: np.ndarray) -> np.ndarray:
    """The inverse of ``convert/from_flax._to_torch_layout``."""
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)  # (O, I, KH, KW) -> (KH, KW, I, O)
    if a.ndim == 2:
        return a.T                      # (out, in) -> (in, out)
    return a


@torch.no_grad()
def state_tree(module) -> dict:
    """The module's weights as the JAX Trainer's tree, numpy leaves in
    flax layouts: ``{"params": ...}`` and, when the module has buffers
    (BN running statistics), ``{"batch_stats": ...}``; each leaf sits at
    its flax path (``conv1.weight`` at ``params/conv1/kernel``)."""
    buffers = {name for name, _ in module.named_buffers()}
    tree: dict = {}
    for name, t in module.state_dict().items():
        *mods, leaf = name.split(".")
        collection = "batch_stats" if name in buffers else "params"
        node = tree.setdefault(collection, {})
        for m in mods:
            node = node.setdefault(m, {})
        a = t.detach().float().cpu().numpy() if t.is_floating_point() \
            else t.detach().cpu().numpy()
        node[{"weight": "kernel"}.get(leaf, leaf)] = np.ascontiguousarray(
            _to_flax_layout(a))
    return tree


def _leaves_with_paths(tree):
    """(path, leaf) pairs in ``jax.tree_util``'s order over nested dicts
    (keys sorted at every level) and its ``keystr`` path strings
    (``['params']['conv1']['kernel']``)."""
    out = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}[{i}]")
        else:
            out.append((prefix, node))

    walk(tree, "")
    return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def tree_fingerprint(tree, *, seed: int = 0,
                     signs_cache: dict | None = None) -> dict:
    """Seeded random-sign projection and energy fingerprint of a tree.

    Each floating leaf, flattened in float64, is dotted with a ±1 sign
    vector drawn from ``seed`` and the leaf's path, and with itself;
    leaf ``i`` adds into bucket ``i % 8`` of the projections and of the
    energies, and SHA-256 of the 16 packed doubles, cut to 16 hex
    digits, is the digest. Same tree and seed -> the same digest; one
    ulp anywhere -> another. Returns ``{"digest", "proj", "seed"}``;
    ``signs_cache`` (keyed by (seed, path, size)) keeps the signs across
    repeated fingerprints of one tree shape."""
    proj = np.zeros(2 * _FP_BUCKETS, np.float64)
    for i, (path, leaf) in enumerate(_leaves_with_paths(tree)):
        arr = _host(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        flat = arr.astype(np.float64, copy=False).reshape(-1)
        ck = (seed, path, flat.size)
        signs = signs_cache.get(ck) if signs_cache is not None else None
        if signs is None:
            rng = np.random.default_rng(
                np.uint64(seed)
                + np.frombuffer(
                    hashlib.sha256(path.encode()).digest()[:8],
                    np.uint64)[0])
            signs = (rng.integers(0, 2, size=flat.size,
                                  dtype=np.int8) * 2 - 1
                     ).astype(np.float64)
            if signs_cache is not None:
                signs_cache[ck] = signs
        proj[i % _FP_BUCKETS] += float(np.dot(flat, signs))
        proj[_FP_BUCKETS + i % _FP_BUCKETS] += float(np.dot(flat, flat))
    digest = hashlib.sha256(
        struct.pack(f"<{len(proj)}d", *proj)).hexdigest()[:16]
    return {"digest": digest, "proj": [float(p) for p in proj],
            "seed": int(seed)}


def fingerprints_agree(a: dict, b: dict) -> bool:
    """The bit-exact digest test."""
    return a["digest"] == b["digest"]


def fingerprint_deviation(a: dict, b: dict) -> float:
    """Normalized distance between two fingerprints' projections: per
    half (projections, then energies), ``max |pa - pb| / max(|half|)``,
    the larger of the two halves."""
    pa = np.asarray(a["proj"], np.float64)
    pb = np.asarray(b["proj"], np.float64)
    half = len(pa) // 2 or 1
    dev = 0.0
    for sl in (slice(0, half), slice(half, None)):
        ha, hb = pa[sl], pb[sl]
        if ha.size == 0:
            continue
        scale = max(float(np.max(np.abs(ha))),
                    float(np.max(np.abs(hb))), 1e-9)
        dev = max(dev, float(np.max(np.abs(ha - hb))) / scale)
    return dev


# ------------------------------------------------------------- injection


def _sdc_target(module) -> torch.Tensor | None:
    """The JAX ``apply_sdc``'s leaf: the largest floating parameter, the
    first in flax tree order among equals."""
    named = dict(module.named_parameters())
    order = {}
    for name in named:
        *mods, leaf = name.split(".")
        order[name] = (*mods, {"weight": "kernel"}.get(leaf, leaf))
    best = None
    for name in sorted(named, key=lambda n: order[n]):
        p = named[name]
        if p.is_floating_point() and (best is None
                                      or p.numel() > best.numel()):
            best = p
    return best


@torch.no_grad()
def apply_sdc(state, spec) -> None:
    """Apply one scheduled silent corruption, in place, to the largest
    floating parameter of ``state.module``: ``sdc_grad`` scales it by
    ``spec.arg`` (default ``SDC_GRAD_SCALE``); ``sdc_param`` XORs the
    lowest mantissa bit of its first element (the same element in flax's
    layout and the port's)."""
    p = _sdc_target(state.module)
    if p is None:
        return
    if spec.kind == "sdc_grad":
        p.mul_(spec.arg if spec.arg is not None else SDC_GRAD_SCALE)
        return
    first = p.view(-1)[:1]
    if p.dtype == torch.float32:
        bits = first.view(torch.int32)
        bits.bitwise_xor_(1)
    else:
        first.copy_(torch.nextafter(first, torch.full_like(first,
                                                           math.inf)))


# -------------------------------------------------------------- monitor


class SentinelMonitor:
    """The Trainer's sentinel: the detector over the drained ``loss`` and
    ``sent_*`` series, the fingerprint with its sign cache, and the
    counters ``sentinel_trips`` and ``sentinel_scale_backoffs``.
    ``audit_every`` (run steps) is the cross-host audit's cadence, kept
    for the cluster, which the port does not have yet."""

    WATCH_KEYS = ("loss",) + SENTINEL_KEYS

    def __init__(self, *, z_threshold: float = 8.0, warmup: int = 16,
                 audit_every: int = 16, fingerprint_seed: int = 0,
                 registry=None):
        if audit_every < 1:
            raise ValueError(
                f"audit_every must be >= 1, got {audit_every}")
        self.detector = EwmaDetector(z_threshold=z_threshold,
                                     warmup=warmup)
        self.audit_every = int(audit_every)
        self.fingerprint_seed = int(fingerprint_seed)
        self._signs_cache: dict = {}
        reg = registry if registry is not None else default_registry()
        self.trips = reg.counter("sentinel_trips")
        self.scale_backoffs = reg.counter("sentinel_scale_backoffs")

    def observe(self, epoch: int, step_in_epoch: int,
                metrics: dict) -> None:
        """Fold one drained step's metrics in; raises
        :class:`SentinelTrip` on the first watched series out of band.
        A step whose ``mp_grads_finite`` is 0 was a loss-scale backoff
        (the update skipped on the device): neither tested nor folded
        in, and counted in ``sentinel_scale_backoffs``."""
        if metrics.get("mp_grads_finite", 1.0) < 0.5:
            self.scale_backoffs.inc()
            return
        for key in self.WATCH_KEYS:
            if key not in metrics:
                continue
            z = self.detector.observe(key, metrics[key])
            if z is not None:
                self.trips.inc()
                raise SentinelTrip(epoch, step_in_epoch, key,
                                   metrics[key], z)

    def reset(self) -> None:
        self.detector.reset()

    def fingerprint_state(self, state) -> dict:
        """The fingerprint of the model's weights (``params`` and
        ``batch_stats``, the JAX tree), as the checkpoint manifest keeps
        it."""
        tree = state_tree(state.module)
        if not tree.get("batch_stats"):
            tree.pop("batch_stats", None)
        return tree_fingerprint(tree, seed=self.fingerprint_seed,
                                signs_cache=self._signs_cache)
