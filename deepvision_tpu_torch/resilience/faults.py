"""Deterministic fault injection for chaos tests (and drills), the
port's twin of ``deepvision_tpu/resilience/faults.py``: the same
grammar, sites, aliases and seeded draws, so that one schedule string
fires at the same occurrences on both sides.

Which sites the port consults: the training sites, ``nan_step`` and
``stall`` (the Trainer's feed, per train batch), ``data_io`` (the device
feed's producer per upstream pull, ``data/prefetch.py``, and
``data/tfrecord.read_records`` per record when given an injector),
``ckpt_corrupt`` (``train/checkpoint.py``, per committed save),
``worker_kill`` (``data/loader.py``, per merged batch) and ``sdc_grad``
/ ``sdc_param`` (the Trainer, per run step); the serving sites,
``dispatch_crash`` (``serve/engine.py``, per batch), ``replica_kill`` and
``replica_slow`` (``serve/router.py``, per routed attempt),
``session_kill`` (``serve/sessions.py``, per committed frame) and
``snapshot_corrupt`` (there, per written snapshot). The cluster sites
(``host_preempt``, ``host_stall``) parse and have their hooks, but
nothing in the port consults them until their modules are ported. Where the table
below names the JAX package's checkify tripwire, the port's Trainer
reads its per-step finite flag.

A :class:`FaultInjector` holds a parsed schedule of :class:`FaultSpec`s
and a per-site consultation counter. Each layer that can fail consults
its site hook at a well-defined point; the injector fires a spec when
the site's occurrence counter enters the spec's window. Because the
counters advance one per consultation and every consumer consults at a
deterministic program point, a schedule replays bit-identically on CPU
— the property the chaos matrix in ``tests/test_resilience.py`` leans
on. Probabilistic specs (``kind~p``) draw from a seeded generator
instead, for soak-style drills.

Schedule grammar (comma-separated specs)::

    kind@AT[xTIMES][:ARG]     fire at site occurrences [AT, AT+TIMES)
    kind~PROB[:ARG]           fire with probability PROB per consult

Sites and their consultation points:

==================  =====================================================
``nan_step``        per train batch yielded to the feed (Trainer); fires
                    by NaN-poisoning the batch so the checkify tripwire
                    raises inside the compiled step. Aliases: ``nan``,
                    ``nan_grad``.
``data_io``         per upstream pull in the prefetch producer
                    (``data/prefetch.py``) and per record read in
                    ``data/tfrecord.read_records``; fires by raising
                    :class:`InjectedIOError`. Alias: ``io``.
``ckpt_corrupt``    per committed checkpoint save
                    (``train/checkpoint.py``); fires by garbling the
                    largest file of the just-saved epoch on disk.
                    Alias: ``ckpt``.
``stall``           per train batch yielded to the feed; fires by
                    sleeping ``ARG`` seconds (default 1.0) — trips the
                    stall watchdog.
``dispatch_crash``  per dispatched serve batch (``serve/engine.py``);
                    fires by raising :class:`InjectedCrash` in the
                    dispatcher loop body. Alias: ``crash``.
``replica_kill``    per routed request attempt (``serve/router.py``);
                    fires by hard-killing the chosen replica (SIGKILL
                    for process replicas) BEFORE the attempt is sent,
                    so the router's dead-replica failover path runs.
                    Alias: ``rkill``.
``replica_slow``    per routed request attempt; fires by injecting
                    ``ARG`` seconds of extra attempt latency (default
                    0.5) — exercises hedged retries. Alias: ``rslow``.
``host_preempt``    per observed cluster step in the multi-host
                    supervisor (``resilience/cluster.py``); fires by
                    delivering the preemption notice (SIGTERM) to one
                    live host — the coordinated save barrier + elastic
                    resume path runs. Alias: ``preempt``.
``host_stall``      per observed cluster step in the supervisor; fires
                    by SIGSTOPping one live host for ``ARG`` seconds
                    (default 2.0) — trips the straggler detector.
                    Alias: ``hstall``.
``worker_kill``     per merged batch in the multi-process host loader
                    (``data/loader.py``); fires by SIGKILLing the
                    decode worker whose turn it is — the bounded
                    respawn-at-shard-position path runs.
                    Alias: ``wkill``.
``sdc_grad``        silent data corruption of the update: at RUN step
                    AT (epoch-anchored ``epoch*steps_per_epoch+step``,
                    NOT a consult counter — so a resumed or replayed
                    window re-fires at the same point bit-identically)
                    the Trainer scales one parameter leaf of THIS
                    host's replica by ``:ARG`` (default the silent
                    ``sentinel.SDC_GRAD_SCALE``); ``:hostH`` instead
                    targets original cluster host H only. Detected by
                    the sentinel z-score (loud scales) or the
                    cross-host agreement audit (silent scales).
                    Alias: ``sdc``.
``sdc_param``       silent single-bit corruption: at RUN step AT, XOR
                    the low mantissa bit of one element of one
                    parameter leaf on the targeted host — the one-ulp
                    SDC only the fingerprint audit can see.
                    Alias: ``sdcp``.
``session_kill``    per committed session-state update in the
                    ``serve/sessions.py`` SessionStore; fires by
                    dropping that session's device-resident state
                    (snapshots on disk are kept), so the next frame
                    exercises the snapshot-restore path in-process.
                    Alias: ``sesskill``.
``snapshot_corrupt``  per committed session snapshot; fires by garbling
                    the just-written snapshot file on disk, so restore
                    must fall back to the previous snapshot or declare
                    an honest ``state_reset``. Alias: ``snapcorrupt``.
==================  =====================================================

The sdc sites accept ``:hostH`` (e.g. ``sdc_grad@20:host1``) in the
ARG slot: the spec then fires only in the process whose ORIGINAL
cluster host id (``FaultInjector(host=...)``, exported by the
supervisor as ``DVTPU_CLUSTER_ORIG_HOST``) matches — host ids are
stable across elastic relaunches, so a quarantined host's fault can
never follow the job onto a survivor. ``FaultInjector(sdc_quiesce=
True)`` (supervisor replay generations) disarms the sdc sites: the
replay models re-running the window on hardware that is not
misbehaving, which is what makes the replayed fingerprint the ground
truth the bisection attributes against.

Example: ``"nan@14,ckpt@1,io@8x2"`` — NaN-poison the 15th train batch,
corrupt the 2nd checkpoint save, and fail the 9th and 10th data pulls
with transient read errors.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = [
    "FaultSpec",
    "FaultInjector",
    "InjectedIOError",
    "InjectedCrash",
    "parse_schedule",
    "format_spec",
    "split_schedule",
    "poison_batch",
]

# canonical site names + accepted aliases
SITES = ("nan_step", "data_io", "ckpt_corrupt", "stall", "dispatch_crash",
         "replica_kill", "replica_slow", "host_preempt", "host_stall",
         "worker_kill", "sdc_grad", "sdc_param", "session_kill",
         "snapshot_corrupt")
# the sites the CLUSTER SUPERVISOR consults (resilience/cluster.py);
# train_dist.py splits a mixed schedule on this set so supervisor-level
# specs never reach the in-job injector (and vice versa)
CLUSTER_SITES = ("host_preempt", "host_stall")
# RUN-step-keyed sites (fired by step VALUE, not consult occurrence):
# deterministic under resume/replay from any point, the property the
# supervisor's replay bisection leans on
SDC_SITES = ("sdc_grad", "sdc_param")
_ALIASES = {
    "nan": "nan_step", "nan_grad": "nan_step",
    "io": "data_io",
    "ckpt": "ckpt_corrupt",
    "crash": "dispatch_crash",
    "rkill": "replica_kill",
    "rslow": "replica_slow",
    "preempt": "host_preempt",
    "hstall": "host_stall",
    "wkill": "worker_kill",
    "sdc": "sdc_grad",
    "sdcp": "sdc_param",
    "sesskill": "session_kill",
    "snapcorrupt": "snapshot_corrupt",
}
_HOST_ARG = re.compile(r"^host(\d+)$")


class InjectedIOError(IOError):
    """A scheduled transient data-read failure (retryable)."""


class InjectedCrash(RuntimeError):
    """A scheduled unexpected dispatcher/loop crash."""


@dataclass
class FaultSpec:
    """One scheduled fault: fires at site occurrences
    ``[at, at + times)`` — or, when ``prob`` is set, with probability
    ``prob`` on every consult. ``arg`` carries a per-kind parameter
    (stall duration in seconds)."""

    kind: str
    at: int | None = None
    times: int = 1
    prob: float | None = None
    arg: float | None = None
    host: int | None = None
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        self.kind = _ALIASES.get(self.kind, self.kind)
        if self.kind not in SITES:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{SITES} (aliases {sorted(_ALIASES)})")
        if (self.at is None) == (self.prob is None):
            raise ValueError(
                f"{self.kind}: exactly one of at= / prob= required")
        if self.prob is not None and not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"{self.kind}: prob must be in [0,1], "
                             f"got {self.prob}")
        if self.times < 1:
            raise ValueError(f"{self.kind}: times must be >= 1, "
                             f"got {self.times}")
        if self.host is not None and self.kind not in SDC_SITES:
            raise ValueError(
                f"{self.kind}: ':hostH' targeting only applies to the "
                f"sdc sites {SDC_SITES}")
        if self.kind in SDC_SITES and self.prob is not None:
            # step-keyed sites are replay-deterministic BY DEFINITION;
            # a probabilistic draw per observed step would break the
            # bisection's ground-truth contract
            raise ValueError(
                f"{self.kind}: sdc sites are run-step-keyed "
                "(kind@STEP only; kind~PROB is not replayable)")

    def should_fire(self, occurrence: int, rng) -> bool:
        if self.prob is not None:
            return bool(rng.random() < self.prob)
        return self.at <= occurrence < self.at + self.times


def parse_schedule(spec: str) -> list[FaultSpec]:
    """Parse the schedule grammar (module docstring) into specs."""
    out: list[FaultSpec] = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        arg = host = None
        if ":" in raw:
            raw, _, argtok = raw.partition(":")
            m = _HOST_ARG.match(argtok.strip())
            if m:  # sdc host targeting: sdc_grad@20:host1
                host = int(m.group(1))
            else:
                try:
                    arg = float(argtok)
                except ValueError:
                    raise ValueError(
                        f"fault spec {raw!r}: bad :ARG value {argtok!r}"
                        " (want a float, or hostH for the sdc sites)")
        if "@" in raw:
            kind, _, attok = raw.partition("@")
            times = 1
            if "x" in attok:
                attok, _, timestok = attok.partition("x")
                times = _parse_int(timestok, raw, "xTIMES")
            out.append(FaultSpec(kind=kind.strip(),
                                 at=_parse_int(attok, raw, "@AT"),
                                 times=times, arg=arg, host=host))
        elif "~" in raw:
            kind, _, ptok = raw.partition("~")
            try:
                prob = float(ptok)
            except ValueError:
                raise ValueError(f"fault spec {raw!r}: bad ~PROB "
                                 f"value {ptok!r}") from None
            out.append(FaultSpec(kind=kind.strip(), prob=prob, arg=arg,
                                 host=host))
        else:
            raise ValueError(
                f"fault spec {raw!r}: expected kind@AT[xN][:ARG] "
                "or kind~PROB[:ARG]")
    return out


def format_spec(spec: FaultSpec) -> str:
    """Inverse of :func:`parse_schedule` for one spec (canonical kind
    names; round-trips through the grammar)."""
    if spec.prob is not None:
        s = f"{spec.kind}~{spec.prob:g}"
    else:
        s = f"{spec.kind}@{spec.at}"
        if spec.times > 1:
            s += f"x{spec.times}"
    if spec.host is not None:
        s += f":host{spec.host}"
    elif spec.arg is not None:
        s += f":{spec.arg:g}"
    return s


def split_schedule(schedule: str, kinds) -> tuple[str, str]:
    """Partition a schedule string into (specs whose kind is in
    ``kinds``, the rest), both re-serialized through the grammar —
    how ``train_dist.py`` routes cluster-level sites to the supervisor
    and everything else to the in-job injectors."""
    kinds = set(kinds)
    mine, rest = [], []
    for spec in parse_schedule(schedule):
        (mine if spec.kind in kinds else rest).append(format_spec(spec))
    return ",".join(mine), ",".join(rest)


def _parse_int(tok: str, raw: str, what: str) -> int:
    try:
        return int(tok)
    except ValueError:
        raise ValueError(
            f"fault spec {raw!r}: bad {what} value {tok!r}") from None


class _PoisonedPacked(dict):
    """A packed batch (one the device feed decodes with its ``decode``,
    such as ``data/jpeg.PackedJpegBatch``) whose decoded images are NaN:
    its arrays and attributes are the batch's own."""

    def __init__(self, batch):
        super().__init__(batch)
        self._inner = batch

    def __getattr__(self, name):  # n_images, image_bytes, wire_dtype, ...
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def decode(self, device) -> dict:
        import torch

        out = dict(self._inner.decode(device))
        out["image"] = torch.full(out["image"].shape, float("nan"),
                                  device=out["image"].device)
        return out


def poison_batch(batch: dict) -> dict:
    """NaN-fill the first float array of ``batch`` (a shallow COPY —
    synthetic datasets yield views of one resident array, and an
    in-place write would poison every later epoch too). A packed batch,
    decoded on the device, is poisoned after its decode: its images come
    out NaN."""
    if callable(getattr(batch, "decode", None)):
        return _PoisonedPacked(batch)
    out = dict(batch)
    for k, v in out.items():
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.floating):
            out[k] = np.full_like(arr, np.nan)
            return out
    # integer-only batch (uint8 wire formats): poison via float cast so
    # the step's normalization still produces NaN activations
    k = next(iter(out))
    out[k] = np.full(np.asarray(out[k]).shape, np.nan, np.float32)
    return out


class FaultInjector:
    """Thread-safe, occurrence-counted fault oracle.

    ``schedule`` is a grammar string or an iterable of
    :class:`FaultSpec`. Each site hook below increments that site's
    counter once per consultation and fires any spec whose window the
    counter entered; fired faults are recorded (``fired`` /
    :meth:`summary`) so tests and logs can assert exactly what was
    injected. Counters are monotonic across rollbacks/retries — a
    consumed occurrence never re-fires, which is what makes "inject one
    NaN step, recover, converge" a well-posed test.
    """

    def __init__(self, schedule: str | list[FaultSpec] | None,
                 *, seed: int = 0, host: int | None = None,
                 sdc_quiesce: bool = False):
        if isinstance(schedule, str):
            schedule = parse_schedule(schedule)
        self.specs: list[FaultSpec] = list(schedule or [])
        self._rng = np.random.default_rng(seed)
        self._counts: dict[str, int] = {s: 0 for s in SITES}
        self._lock = threading.Lock()
        self.fired: list[tuple[str, int]] = []  # (site, occurrence/step)
        # this process's ORIGINAL cluster host id (stable across
        # elastic relaunches) for ':hostH'-targeted sdc specs; None =
        # single-host / untargeted
        self.host = host
        # replay generations run with the sdc sites disarmed: the
        # replayed window is the bisection's ground truth
        self.sdc_quiesce = bool(sdc_quiesce)
        self._sdc_fired: set[tuple[str, int]] = set()

    def _consult(self, site: str) -> FaultSpec | None:
        """Advance ``site``'s counter; return the spec to fire, if any."""
        with self._lock:
            occ = self._counts[site]
            self._counts[site] = occ + 1
            for spec in self.specs:
                if spec.kind == site and spec.should_fire(occ, self._rng):
                    spec.fired += 1
                    self.fired.append((site, occ))
                    return spec
        return None

    # -- site hooks ------------------------------------------------------
    def poison_nan(self, batch: dict) -> tuple[dict, bool]:
        """Trainer hook, per yielded train batch: -> (batch, fired)."""
        spec = self._consult("nan_step")
        if spec is None:
            return batch, False
        return poison_batch(batch), True

    def check_io(self, what: str = "data read") -> None:
        """Data-layer hook: raise a transient read error when scheduled."""
        spec = self._consult("data_io")
        if spec is not None:
            raise InjectedIOError(
                f"injected transient {what} failure "
                f"(occurrence {self._counts['data_io'] - 1})")

    def maybe_stall(self, *, sleep=time.sleep) -> bool:
        """Trainer hook: sleep through a scheduled stall (watchdog food)."""
        spec = self._consult("stall")
        if spec is None:
            return False
        sleep(spec.arg if spec.arg is not None else 1.0)
        return True

    def check_dispatch(self) -> None:
        """Serve hook, per dispatched batch: crash the loop body when
        scheduled."""
        spec = self._consult("dispatch_crash")
        if spec is not None:
            raise InjectedCrash(
                "injected dispatcher crash "
                f"(occurrence {self._counts['dispatch_crash'] - 1})")

    def check_replica_kill(self) -> bool:
        """Router hook, per routed request attempt: True when the chosen
        replica should be hard-killed before the attempt is sent (the
        router then exercises its real dead-replica failover path)."""
        return self._consult("replica_kill") is not None

    def check_replica_slow(self) -> float | None:
        """Router hook, per routed request attempt: extra attempt
        latency in seconds (``:ARG``, default 0.5) when scheduled, else
        None — slow enough attempts trip the router's hedged retry."""
        spec = self._consult("replica_slow")
        if spec is None:
            return None
        return spec.arg if spec.arg is not None else 0.5

    def check_host_preempt(self) -> bool:
        """Cluster-supervisor hook, per observed cluster step: True when
        the preemption notice (SIGTERM) should be delivered to one live
        host — the coordinated save barrier then runs in-job."""
        return self._consult("host_preempt") is not None

    def check_host_stall(self) -> float | None:
        """Cluster-supervisor hook, per observed cluster step: seconds
        to SIGSTOP one live host (``:ARG``, default 2.0) when scheduled,
        else None — straggler-detector food."""
        spec = self._consult("host_stall")
        if spec is None:
            return None
        return spec.arg if spec.arg is not None else 2.0

    def check_worker_kill(self) -> bool:
        """Loader hook, per merged batch: True when the decode worker
        whose turn it is should be SIGKILLed before the pull (the
        bounded respawn path then runs)."""
        return self._consult("worker_kill") is not None

    def check_sdc(self, run_step: int) -> FaultSpec | None:
        """Trainer hook, once per optimizer step: the sdc spec to
        apply at this RUN step, if any. Unlike the occurrence-counted
        sites, sdc specs fire by step VALUE — a resumed or replayed
        window covering the step re-fires identically, which is what
        lets the supervisor's bisection treat replays as ground truth
        (with ``sdc_quiesce`` disarming the injection there). A
        ``:hostH`` target fires only when it names this injector's
        original host; each (site, step) fires at most once per
        process."""
        if self.sdc_quiesce:
            return None
        with self._lock:
            for spec in self.specs:
                if spec.kind not in SDC_SITES:
                    continue
                if not spec.at <= run_step < spec.at + spec.times:
                    continue
                if spec.host is not None and spec.host != self.host:
                    continue
                key = (spec.kind, int(run_step))
                if key in self._sdc_fired:
                    continue
                self._sdc_fired.add(key)
                spec.fired += 1
                self.fired.append(key)
                return spec
        return None

    def check_session_kill(self) -> bool:
        """SessionStore hook, per committed session-state update: True
        when that session's device-resident state should be dropped
        (snapshots kept) so the next frame runs the restore path."""
        return self._consult("session_kill") is not None

    def corrupt_snapshot(self, path: str | Path) -> bool:
        """SessionStore hook, per committed session snapshot: garble the
        just-written snapshot file so restore must fall back to the
        previous snapshot or declare an honest ``state_reset``."""
        spec = self._consult("snapshot_corrupt")
        if spec is None:
            return False
        Path(path).write_bytes(b"\x00injected-snapshot-corruption\x00")
        print(f"[fault] corrupted session snapshot {path}", flush=True)
        return True

    def corrupt_checkpoint(self, step_dir: str | Path) -> bool:
        """Checkpoint hook, per committed save: garble the largest file
        under ``step_dir`` (the array payload — guarantees both a
        checksum mismatch and, without verification, a restore crash)."""
        spec = self._consult("ckpt_corrupt")
        if spec is None:
            return False
        step_dir = Path(step_dir)
        files = sorted((p for p in step_dir.rglob("*") if p.is_file()),
                       key=lambda p: (p.stat().st_size, str(p)))
        if not files:
            return False
        victim = files[-1]
        victim.write_bytes(b"\x00injected-corruption\x00")
        print(f"[fault] corrupted checkpoint file {victim}", flush=True)
        return True

    # -- reporting -------------------------------------------------------
    def summary(self) -> str:
        with self._lock:
            if not self.fired:
                return "no faults fired"
            return " ".join(f"{site}@{occ}" for site, occ in self.fired)
