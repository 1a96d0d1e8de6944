"""Serving CLI of the port: the single-engine twin of ``serve.py``, over
stdin JSONL (the default) or HTTP (``--http PORT``, ``serve/http.py``).

    python -m deepvision_tpu_torch.serve -m alexnet1 --buckets 1,4,16,64
    {"id": 1, "model": "alexnet1", "input": [[[...224x224x3 floats...]]]}
    -> {"id": 1, "result": {"classes": [...], "probs": [...]}, "ms": 4.2}
    python -m deepvision_tpu_torch.serve -m yolov3=runs/yolov3 --score 0.5
    {"id": 1, "input": [[[...416x416x3 floats in [-1, 1]...]]]}
    -> {"id": 1, "result": {"boxes": [[x1, y1, x2, y2], ...],
        "scores": [...], "classes": [...]}, "ms": 9.1}
    python -m deepvision_tpu_torch.serve -m dcgan=runs/dcgan
    {"id": 1, "input": [...100 noise floats...]}
    -> {"id": 1, "result": {"image": [[[...28x28x1 in [-1, 1]...]]]}}

One JSON request per line on stdin, one response per line on stdout in
submission order; start-up chatter goes to stderr. ``-m`` is repeatable.
Weights are fresh, drawn from ``--seed``, unless ``-m name=workdir``
names a directory whose ``ckpt/`` holds the port trainer's checkpoints
(``runs/alexnet1`` after ``python -m deepvision_tpu_torch.train -m
alexnet1``, ``-m inception1=runs/inception1`` after training
``inception1``, ``-m resnet50=runs/resnet50`` after training
``resnet50``, ``-m yolov3=runs/yolov3`` after training ``yolov3``): then
the newest verified epoch. ``yolov3`` serves the detect task: ``--score``
and ``--iou`` are its NMS thresholds, and its boxes are normalized
corners. ``dcgan`` (or ``dcgan_generator``) serves the DCGAN generator
of a ``train -m dcgan`` checkpoint: the input is the noise, the answer
the image.

    python -m deepvision_tpu_torch.serve -m alexnet1 -m yolov3 --http 8080
    POST /v1/predict {"model": "alexnet1", "input": [[[...]]]}
         -> {"result": {"classes": [...], "probs": [...]}}
    GET /stats, GET /metrics, GET /healthz

``--http 0`` binds an ephemeral port and ``--port-file F`` writes it to
F once the engine is warm. ``--faults crash@2`` (the
``resilience/faults.py`` grammar) crashes the dispatcher before its
third batch: that batch answers 500, ``/healthz`` answers 503 with
``Retry-After`` for the supervisor's backoff (``--restart-backoff-s``),
then 200. On the card every (model, bucket) is a CUDA graph captured at
start-up; the runner cache is frozen after it, so that no request pays a
capture. SIGINT stops the server with exit code 0; SIGTERM with 143,
after the engine has closed and the last line has been printed.

    python -m deepvision_tpu_torch.serve --fleet 2 -m alexnet1 -m yolov3 \
        --http 8080 --store aot/ --hedge-after 0.5 --slo alexnet1=0.2

``--fleet N`` runs a router (``serve/router.py``) over N child processes
(``serve/replica.py``), each this CLI with ``--http 0 --port-file`` on
``--device`` (the card by default); the router process itself touches no
device. Requests go to the least-loaded ready replica; a replica that
dies (``--faults replica_kill@N`` SIGKILLs the one chosen for the N-th
attempt) is failed over from and respawned, warming from the shared
``--store`` when one is given; ``--hedge-after S`` sends a second attempt
to another replica when the first has not answered in S seconds, the
first answer winning (``replica_slow@N:S`` delays the N-th attempt);
``--slo NAME=SECONDS`` is a model's p95 budget, its deadline ceiling and
its admission bound; ``--fleet-max M`` lets the autoscaler add replicas
up to M under pressure and drain them back when calm. ``/metrics``
federates the replicas' counters, labelled ``replica="rN"``. The last
stderr line is ``[router] failovers=... deaths=... restarts=...``.

    python -m deepvision_tpu_torch.predict export -m alexnet1 -o a.pt2
    python -m deepvision_tpu_torch.serve --artifact alexnet1=a.pt2
    python -m deepvision_tpu_torch.serve -m yolov3 --store aot/

    python -m deepvision_tpu_torch.serve -m yolov3 -m hourglass104 \
        --pipelines detpose.json
    {"id": 1, "pipeline": "detpose", "input": [[[...416x416x3...]]]}
    -> {"id": 1, "result": {"det": {...}, "pose": [{"joints": ...}, ...]}}

``--pipelines FILE`` (repeatable; one spec, a list, or ``{"pipelines":
[...]}``, ``serve/pipeline.py``) serves each DAG beside the models: it is
checked (acyclic, every edge's shapes) at start-up, warmed end to end
with the models (on the card one CUDA graph an entry bucket), and
answered for ``{"pipeline": NAME}`` on stdin or ``POST
/v1/pipeline/NAME``. The last stderr lines then include ``[pipeline]
served NAME=N frozen=True misses=M hits=H``. A fleet routes pipeline
names like models and gives every replica the same files.

    python -m deepvision_tpu_torch.serve -m yolov3 --track yolov3:4 \
        --session-dir sessions/ --snapshot-every 8
    {"id": 1, "model": "track", "session": "cam0", "seq": 0, "input": [...]}
    -> {"id": 1, "result": {"boxes": [...], "scores": [...],
        "tracked": [...], "session": "cam0", "seq": 0, "detected": true,
        "state_reset": false}}

``--track MODEL[:K]`` serves a stateful tracking stream named ``track``
over the detect model MODEL (``-m MODEL``, or ``synth``: a weight-free
synthetic detector of 16x16x1 frames, ``serve/sessions.py``): the
detector runs every K-th frame of a stream (default 4) and the frames
between propagate the stream's slate, which stays on the device. A frame
carries ``session`` and ``seq`` (stdin, or ``POST /v1/predict``); every
answer says ``state_reset``. ``--session-capacity`` bounds the live
streams (a new one is shed when full), ``--session-ttl-s`` evicts idle
ones, ``--snapshot-every`` is the frame cadence of the crash-safe
snapshots under ``--session-dir`` (default a fresh temporary directory).
With ``--fleet N`` every replica gets these flags and one shared session
directory, a stream sticks to one replica, and when that replica dies
the router re-pins the stream to a survivor, which restores the newest
snapshot, and replays the stream's last ``--session-replay-window``
frames: the stream goes on without a reset (the exit line counts
``sessions_migrated`` and ``resets``).

``--artifact [NAME=]PATH`` (repeatable) serves a ``torch.export``
artifact of a classifier (``predict export``) without the model's code,
on its exported batch alone (``serve/models.from_exported``); NAME
defaults to the file's stem. ``--store DIR`` keeps every traced (model,
bucket) request program in an artifact store (``serve/artifact_store.py``)
and warms from it at the next start; the warm line counts the runners
that came from it.

    python -m deepvision_tpu_torch.serve -m alexnet1 -m inception1_ref \
        -m yolov3 --residency-mb 474 --tenant-quota yolov3=8 \
        --slo-class inception1_ref=batch
    {"control": "swap", "model": "alexnet1", "perturb": 0.01}

Tenancy (``serve/tenancy.py``): ``--residency-mb MB`` caps the weight
bytes resident on the card; the least recently served models beyond it
are evicted to host (their CUDA graphs dropped first) and restored, their
graphs recaptured, when a request needs them. ``--tenant-quota NAME=N``
caps a model's queued requests, ``--slo-class NAME=CLASS`` (gold,
standard, batch) its share of the queue while others are queued; both
are repeatable, and a fleet forwards all three flags to every replica
and gives the router the quota and class maps. A stdin line
``{"control": "swap", "model": NAME, "perturb": F | "workdir": DIR}``
swaps the model's weights on a background thread while data lines keep
flowing (stderr chatter only; a swap started near the end of the stream
finishes before the close); over HTTP ``POST /v1/swap`` with the same
body answers when the swap is done (404 on a fleet, whose router owns no
weights). The stderr line before the last is ``[tenancy] swaps=N
evictions=E rematerializations=R resident=a/b recaptures=C
recapture_s=S``.

    python -m deepvision_tpu_torch.serve --fleet 2 -m alexnet1 --http 8080 \
        --trace-spool obs/
    python -m deepvision_tpu_torch.obs.trace_merge obs/ --assert-flow

Observability: ``--trace-spool DIR`` appends every completed span of this
process to a crash-safe spool under DIR (``obs/distributed.SpanSpool``;
without the flag, the ``DVTPU_TRACE_SPOOL`` environment variable names
the directory) and installs the flight recorder there, which dumps
``flightrec-<role>-signal-15-*.json`` on SIGTERM (before the exit) and
``flightrec-<role>-dispatcher_crash-*.json`` when the dispatcher
crashes. ``--obs-role NAME`` labels the process's spans, spool and dumps
(default ``replica``, or ``router`` for a fleet's router); a fleet
forwards ``--trace-spool`` to every replica and labels each with its
slot id (``r1``, ``r2``, ...). The engine's spans carry each request's
trace id (``X-DVTPU-Trace``, or a ``"trace"`` field on stdin or in the
body); ``python -m deepvision_tpu_torch.obs.trace_merge DIR`` merges the
fleet's spools and dumps into one Perfetto trace. ``--profile-dir DIR``
runs ``torch.profiler`` over the serving session, from the end of the
warm-up to the shutdown (``DIR/session.pt.trace.json``; one engine, not
a fleet's router).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import sys
import threading
import time

import numpy as np

from deepvision_tpu_torch.obs.distributed import (
    ENV_SPOOL,
    SpanSpool,
    enable_spool_from_env,
    flight_dump,
    install_flight_recorder,
)
from deepvision_tpu_torch.obs.profiler import profile_session
from deepvision_tpu_torch.obs.trace import get_tracer
from deepvision_tpu_torch.serve.admission import ShedError
from deepvision_tpu_torch.serve.engine import InferenceEngine
from deepvision_tpu_torch.serve.http import run_http
from deepvision_tpu_torch.serve.models import from_exported, load_served
from deepvision_tpu_torch.serve.pipeline import Pipeline, load_pipeline_specs


def _parse_spec(spec: str) -> tuple[str, str | None]:
    """``NAME[=PATH]`` -> (NAME, PATH or None), as ``serve.py`` parses
    it."""
    name, _, path = spec.partition("=")
    return name, path or None


def _parse_tenant_map(specs, *, flag: str, cast):
    """Repeatable ``NAME=VALUE`` flags -> a dict, or None when none was
    given (``--tenant-quota yolov3=8``, ``--slo-class alexnet1=gold``), as
    ``serve.py`` parses them; a bad spec exits with its flag's name."""
    out = {}
    for spec in specs or []:
        name, sep, val = spec.partition("=")
        if not sep or not name:
            sys.exit(f"bad {flag} spec {spec!r}; want NAME=VALUE")
        try:
            out[name] = cast(val)
        except ValueError as e:
            sys.exit(f"bad {flag} spec {spec!r}: {e}")
    return out or None


def _track(args, models: list, injector):
    """``--track MODEL[:K]``: the ``TrackingPipeline`` named ``track``
    over the served detect model MODEL, or over the synthetic detector
    (appended to ``models``) for ``synth``, with a session store under
    ``--session-dir``."""
    import tempfile

    from deepvision_tpu_torch.serve.sessions import (
        SessionStore,
        TrackingPipeline,
        synthetic_detector,
    )

    det_name, _, k = args.track.partition(":")
    by_name = {m.name: m for m in models}
    if det_name in by_name:
        det = by_name[det_name]
    elif det_name == "synth":
        det = synthetic_detector(device=args.device)
        models.append(det)
    else:
        sys.exit(f"--track {args.track!r}: no model named {det_name!r} "
                 "(pass -m, or use 'synth')")
    sdir = args.session_dir or tempfile.mkdtemp(prefix="dvt-sessions-")
    print(f"session snapshots -> {sdir} (cadence {args.snapshot_every} "
          "frames)", file=sys.stderr)
    store = SessionStore(
        capacity=args.session_capacity, ttl_s=args.session_ttl_s,
        snapshot_dir=sdir, snapshot_every=args.snapshot_every,
        injector=injector)
    return TrackingPipeline("track", det, store,
                            detect_every=int(k) if k else 4)


def build_engine(args) -> InferenceEngine:
    models = []
    for spec in args.model or []:
        name, workdir = _parse_spec(spec)
        models.append(load_served(
            name, workdir, seed=args.seed, device=args.device,
            input_size=args.input_size, num_classes=args.num_classes,
            top_k=args.top, score_thresh=args.score,
            iou_thresh=args.iou))
    for spec in args.artifact or []:
        name, path = _parse_spec(spec)
        if path is None:
            name, path = None, name
        models.append(from_exported(path, name=name, top_k=args.top,
                                    device=args.device))
    if not (models or args.track):
        sys.exit("no models: pass -m NAME[=WORKDIR], --artifact "
                 "[NAME=]PATH or --track synth")
    buckets = tuple(int(b) for b in args.buckets.split(","))
    by_name = {m.name: m for m in models}
    # each DAG's structure and every edge's shapes are checked here, before
    # anything warms: a bad spec stops the start-up, not a request
    pipelines = [Pipeline(spec, by_name) for path in args.pipelines or []
                 for spec in load_pipeline_specs(path)]
    injector = None
    if args.faults:
        from deepvision_tpu_torch.resilience.faults import FaultInjector

        injector = FaultInjector(args.faults, seed=args.fault_seed)
        print(f"fault injection armed: {args.faults!r}", file=sys.stderr)
    if args.track:
        models.append(_track(args, models, injector))
    print(f"serving {[m.name for m in models]}"
          + (f" pipelines {[p.name for p in pipelines]}" if pipelines
             else "") + f" buckets={buckets} on {args.device}; warming...",
          file=sys.stderr)
    engine = InferenceEngine(
        models, buckets=buckets, max_queue=args.max_queue,
        per_model_limit=args.per_model_limit,
        batch_window_s=args.batch_window_ms / 1e3, freeze_cache=True,
        fault_injector=injector,
        restart_backoff_s=args.restart_backoff_s, store=args.store,
        pipelines=pipelines,
        residency_bytes=(int(args.residency_mb * 1024 * 1024)
                         if args.residency_mb else None),
        tenant_quota=_parse_tenant_map(args.tenant_quota,
                                       flag="--tenant-quota", cast=int),
        slo_class=_parse_tenant_map(args.slo_class, flag="--slo-class",
                                    cast=str))
    stats = engine.stats()
    from_store = stats["warmed_from_store"]
    print(f"warmup done in {engine.warmup_s}s ({stats['cache']['entries']} "
          f"runners" + (f", {len(from_store)} from store" if from_store
                        else "") + f"); precision {engine.precision}",
          file=sys.stderr)
    # by model: runner kind, graph pool bytes, each bucket's launches a call
    print(f"[serve] runners {json.dumps(stats['runners'])}", file=sys.stderr)
    return engine


def build_fleet(args):
    """A router over ``args.fleet`` child-process replicas, each this CLI
    in HTTP mode on an ephemeral port with the model flags forwarded.
    The router process loads no model and touches no device."""
    from deepvision_tpu_torch.serve.replica import (
        ProcessReplica,
        replica_argv,
    )
    from deepvision_tpu_torch.serve.router import AutoscaleConfig, FleetRouter

    if not (args.model or args.artifact or args.track):
        sys.exit("no models: pass -m NAME[=WORKDIR], --artifact "
                 "[NAME=]PATH or --track synth")
    session_flags = []
    if args.track:
        import tempfile

        # one snapshot directory for every replica: when a replica dies,
        # the survivor that a stream is re-pinned to restores the stream
        # from the newest snapshot that the dead one wrote here
        session_dir = args.session_dir or tempfile.mkdtemp(
            prefix="dvt-sessions-")
        print(f"session snapshots (shared across replicas) -> "
              f"{session_dir}", file=sys.stderr)
        session_flags = ["--track", args.track, "--session-dir",
                         str(session_dir), "--session-capacity",
                         str(args.session_capacity), "--session-ttl-s",
                         str(args.session_ttl_s), "--snapshot-every",
                         str(args.snapshot_every)]
    forward = [("--seed", args.seed), ("--input-size", args.input_size),
               ("--num-classes", args.num_classes), ("--top", args.top),
               ("--score", args.score), ("--iou", args.iou),
               ("--max-queue", args.max_queue),
               ("--batch-window-ms", args.batch_window_ms),
               ("--timeout-s", args.timeout_s),
               ("--residency-mb", args.residency_mb)]
    tenant_flags = [a for flag, specs in (("--tenant-quota",
                                           args.tenant_quota),
                                          ("--slo-class", args.slo_class))
                    for spec in specs or [] for a in (flag, spec)]
    # the spool is optional on a namespace built by hand
    spool_dir = getattr(args, "trace_spool", None)
    obs_flags = ["--trace-spool", str(spool_dir)] if spool_dir else []
    child_argv = replica_argv(
        args.model or [], artifact_specs=args.artifact or [],
        buckets=args.buckets,
        # the shared store: the first generation traces and fills it,
        # every respawn warms from it
        store=args.store, device=args.device, pipelines=args.pipelines,
        extra=[str(a) for flag, value in forward if value is not None
               for a in (flag, value)] + tenant_flags + session_flags
        + obs_flags)

    def factory(sid: str):
        # each replica spools and dumps under its slot id, so that the
        # merged fleet trace names its pid rows r1, r2, ...
        return ProcessReplica(sid, child_argv + ["--obs-role", sid])

    injector = None
    if args.faults:
        from deepvision_tpu_torch.resilience.faults import FaultInjector

        injector = FaultInjector(args.faults, seed=args.fault_seed)
        print(f"fault injection armed (router sites): {args.faults!r}",
              file=sys.stderr)
    slo = {}
    for spec in args.slo or []:
        name, _, sec = spec.partition("=")
        try:
            slo[name] = float(sec)
        except ValueError:
            sys.exit(f"bad --slo spec {spec!r}; want NAME=SECONDS")
    fleet_max = args.fleet_max or args.fleet
    autoscale = None
    if fleet_max > args.fleet:
        autoscale = AutoscaleConfig(min_replicas=args.fleet,
                                    max_replicas=fleet_max)
    models = [_parse_spec(s)[0] for s in args.model or []]
    # pipeline names are routable like models: the specs are read as
    # plain JSON here, and each replica builds, checks and warms its DAGs
    models += [spec.name for path in args.pipelines or []
               for spec in load_pipeline_specs(path)]
    if args.track:
        # the tracker (and for "synth" its detector) are routable names
        # that each replica builds itself
        models.append("track")
        det_name = args.track.partition(":")[0]
        if det_name not in models:
            models.append(det_name)
    print(f"starting fleet of {args.fleet} replica(s) "
          f"({models or args.artifact}) on {args.device}; replicas warm "
          "in parallel...", file=sys.stderr)
    router = FleetRouter(
        factory, replicas=args.fleet, models=models, slo=slo or None,
        default_deadline_s=args.timeout_s, max_queue=args.max_queue,
        per_model_limit=args.per_model_limit, autoscale=autoscale,
        hedge_after_s=args.hedge_after, fault_injector=injector,
        session_replay_window=args.session_replay_window,
        # tenant isolation at the fleet's front door too: a noisy tenant
        # sheds here before it crowds any replica's queue
        tenant_quota=_parse_tenant_map(args.tenant_quota,
                                       flag="--tenant-quota", cast=int),
        slo_class=_parse_tenant_map(args.slo_class, flag="--slo-class",
                                    cast=str))
    print(f"fleet up: {router.health()}", file=sys.stderr, flush=True)
    return router


def run_stdin(engine: InferenceEngine, args, stdin=None, stdout=None):
    """One JSON request per line; responses, in submission order, to
    ``stdout``. Requests keep flowing while earlier ones run, so the
    dispatcher sees real micro-batches even from a pipe.

    A control line ``{"control": "swap", "model": NAME, "perturb": F |
    "workdir": DIR}`` hot-swaps the model's weights on a background
    thread while data lines keep flowing; it answers nothing on stdout
    (its chatter goes to stderr), and a swap started near the end of the
    stream is joined before this returns."""
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    pending: list[tuple[object, object, float]] = []  # (id, future, t0)
    controls: list[threading.Thread] = []

    def start_control(req: dict) -> None:
        if req.get("control") != "swap":
            print(f"[tenancy] unknown control {req.get('control')!r}",
                  file=sys.stderr, flush=True)
            return
        hot_swap = getattr(engine, "hot_swap", None)
        if hot_swap is None:
            print("[tenancy] swap control needs a single-engine host (a "
                  "fleet's router owns no weights)", file=sys.stderr,
                  flush=True)
            return

        def swap():
            kw = {k: req[k] for k in ("workdir", "perturb") if k in req}
            try:
                # a checkpoint restore's chatter must not reach the data
                # stream on stdout
                with contextlib.redirect_stdout(sys.stderr):
                    hot_swap(req["model"], **kw)
            except Exception as e:
                print(f"[tenancy] swap {req.get('model')!r} failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)

        t = threading.Thread(target=swap, daemon=True, name="tenancy-swap")
        t.start()
        controls.append(t)

    def emit(rid, fut, t0):
        try:
            result = fut.result(timeout=args.timeout_s + 1.0)
            line = {"id": rid, "result": result,
                    "ms": round((time.perf_counter() - t0) * 1e3, 2)}
        except ShedError as e:
            line = {"id": rid, "error": str(e),
                    "retry_after": e.retry_after_s}
        except Exception as e:
            line = {"id": rid, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(line), file=stdout, flush=True)

    for raw in stdin:
        raw = raw.strip()
        if not raw:
            continue
        try:
            req = json.loads(raw)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
            if "control" in req:
                start_control(req)
                continue
            x = np.asarray(req["input"], np.float32)
            # a stream frame: the session's id and the frame's number
            seq = req.get("seq")
            seq = int(seq) if seq is not None else None
        except (ValueError, KeyError, TypeError) as e:
            print(json.dumps({"error": f"bad request: {e}"}), file=stdout,
                  flush=True)
            continue
        rid = req.get("id")
        t0 = time.perf_counter()
        try:
            # {"pipeline": NAME} addresses a served DAG as {"model":
            # NAME} does a model: the same queue, the same engine
            fut = engine.submit(x, model=(req.get("model")
                                          or req.get("pipeline")),
                                timeout_s=args.timeout_s,
                                trace=req.get("trace"),
                                session=req.get("session"), seq=seq)
        except ShedError as e:
            print(json.dumps({"id": rid, "error": str(e),
                              "retry_after": e.retry_after_s}),
                  file=stdout, flush=True)
            continue
        except (ValueError, RuntimeError) as e:
            print(json.dumps({"id": rid, "error": str(e)}), file=stdout,
                  flush=True)
            continue
        pending.append((rid, fut, t0))
        # bounded in-flight window: about two ladders' worth queued, so
        # batching happens without unbounded memory on long streams
        while len(pending) > 2 * max(engine.buckets):
            emit(*pending.pop(0))
    for item in pending:
        emit(*item)
    for t in controls:
        # a swap started near the end of the stream completes (and counts
        # in the [tenancy] exit line) before the engine closes
        t.join(timeout=args.timeout_s)


def _exit_on_sigterm():
    """SIGTERM -> the flight recorder's dump (``signal-15``, when one is
    installed), then ``SystemExit(143)``, so that the ``finally`` blocks
    run: the engine or the router closes (a router stops its children),
    the spool closes and the exit line is printed. Returns the handler it
    replaced, or None off the main thread, where no handler can be
    set."""
    if threading.current_thread() is not threading.main_thread():
        return None

    def on_sigterm(sig, frame):
        # the black box first: its ring holds the spans up to the signal
        flight_dump(f"signal-{sig}")
        raise SystemExit(143)

    return signal.signal(signal.SIGTERM, on_sigterm)


def _setup_obs(args, role: str):
    """This process's distributed observability: the tracer labelled
    ``role``, a span spool under ``--trace-spool`` (or the directory that
    ``DVTPU_TRACE_SPOOL`` names) and the flight recorder there, which the
    SIGTERM handler and a dispatcher crash dump. Without a directory it
    does nothing: the labels name spools and dumps alone. -> (the spool
    or None, whether a recorder was installed)."""
    obs_dir = args.trace_spool or os.environ.get(ENV_SPOOL)
    if not obs_dir:
        return None, False
    get_tracer().set_labels(role=role)
    if args.trace_spool:
        spool = SpanSpool(args.trace_spool, role=role)
    else:
        spool = enable_spool_from_env(role=role)
    install_flight_recorder(obs_dir, meta={"role": role})
    return spool, True


def _teardown_obs(spool, recorder: bool) -> None:
    """Detach what :func:`_setup_obs` attached (an in-process run leaves
    no sink on the process's tracer)."""
    if spool is not None:
        spool.close()
    if recorder:
        install_flight_recorder(None)


def _serve(front, args, stdin, stdout) -> None:
    if args.http is not None:
        run_http(front, args)
    else:
        run_stdin(front, args, stdin, stdout)


def main(argv=None, stdin=None, stdout=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deepvision_tpu_torch.serve",
        description=__doc__.split("\n\n")[0])
    p.add_argument("-m", "--model", action="append", metavar="NAME",
                   help="NAME[=WORKDIR], a registry model to serve "
                   "(repeatable)")
    p.add_argument("--artifact", action="append", metavar="[NAME=]PATH",
                   help="a torch.export artifact of a classifier "
                   "(predict export) to serve at its exported batch "
                   "(repeatable)")
    p.add_argument("--pipelines", action="append", metavar="FILE",
                   help="a JSON pipeline spec file (one spec, a list, or "
                   "{'pipelines': [...]}; repeatable): each DAG is checked "
                   "and warmed end to end at start-up, then served for "
                   "{'pipeline': NAME} on stdin or POST /v1/pipeline/NAME")
    p.add_argument("--track", default=None, metavar="MODEL[:K]",
                   help="serve a stateful tracking stream named 'track' "
                   "over the detect model MODEL ('synth': a weight-free "
                   "synthetic detector); the detector runs every K-th "
                   "frame (default 4), the frames between propagate the "
                   "stream's slate on the device. A frame is {'model': "
                   "'track', 'session': ID, 'seq': N, 'input': ...}")
    p.add_argument("--session-dir", default=None, metavar="DIR",
                   help="crash-safe session snapshot directory (default: "
                   "a fresh temporary one; a fleet shares one among its "
                   "replicas, so that a migrated stream restores on the "
                   "survivor)")
    p.add_argument("--session-capacity", type=int, default=64,
                   help="the live sessions an engine keeps; a NEW session "
                   "is shed when full, existing state is never dropped "
                   "for a newcomer")
    p.add_argument("--session-ttl-s", type=float, default=300.0,
                   help="idle seconds before a session is evicted (its "
                   "dirty state snapshotted first)")
    p.add_argument("--snapshot-every", type=int, default=8,
                   help="the session snapshots' cadence in frames (it "
                   "bounds the replay after a crash)")
    p.add_argument("--session-replay-window", type=int, default=32,
                   help="fleet mode: the frames the router keeps a stream "
                   "to replay from the snapshot to the present after a "
                   "failover; a wider gap is a DECLARED state_reset")
    p.add_argument("--residency-mb", type=float, default=None,
                   help="the card's budget for resident model weights in "
                   "MiB: the least recently served models beyond it are "
                   "evicted to host (their CUDA graphs dropped) and "
                   "restored, recaptured, on demand (default: all stay "
                   "resident)")
    p.add_argument("--tenant-quota", action="append", metavar="NAME=N",
                   help="a model's admission quota, its most queued "
                   "requests (repeatable): a noisy tenant sheds alone at "
                   "its own cap")
    p.add_argument("--slo-class", action="append", metavar="NAME=CLASS",
                   help="a model's SLO class, gold, standard or batch "
                   "(repeatable): while others are queued it may hold only "
                   "its class's share of the queue (1.0, 0.8, 0.5); alone "
                   "it has all of it")
    p.add_argument("--store", default=None, metavar="DIR",
                   help="artifact store: warm the runners from this "
                   "directory's verified request programs instead of "
                   "tracing (misses are traced and exported into it)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, which is never chosen "
                   "for you")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the fresh weights")
    p.add_argument("--buckets", default="1,4,16,64",
                   help="batch-size ladder, comma-separated")
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--per-model-limit", type=int, default=None)
    p.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="how long a partial batch waits to fill")
    p.add_argument("--timeout-s", type=float, default=30.0,
                   help="per-request deadline")
    p.add_argument("--input-size", type=int, default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--top", type=int, default=5)
    p.add_argument("--score", type=float, default=0.5,
                   help="detect: the NMS score threshold")
    p.add_argument("--iou", type=float, default=0.5,
                   help="detect: the NMS IoU threshold")
    p.add_argument("--fleet", type=int, default=None,
                   help="run a router over this many child-process "
                   "replicas instead of one in-process engine")
    p.add_argument("--fleet-max", type=int, default=None,
                   help="the autoscaler's ceiling (default: --fleet, "
                   "autoscaling off); it adds and drains replicas between "
                   "--fleet and this")
    p.add_argument("--slo", action="append", metavar="NAME=SECONDS",
                   help="a model's p95 deadline budget (repeatable; fleet "
                   "mode): its admission bound and deadline ceiling")
    p.add_argument("--hedge-after", type=float, default=None,
                   help="fleet mode: send a second attempt to another "
                   "replica when the first has not answered within this "
                   "many seconds (the first answer wins, exactly once); "
                   "off by default")
    p.add_argument("--http", type=int, default=None,
                   help="serve HTTP on this port instead of stdin JSONL; "
                   "0 binds an ephemeral one (see --port-file)")
    p.add_argument("--port-file", default=None,
                   help="write the bound HTTP port here (atomically) once "
                   "the engine is warm")
    p.add_argument("--faults", default=None,
                   help="fault schedule for chaos drills "
                   "(resilience/faults.py grammar): 'crash@2' crashes "
                   "the dispatcher before its third batch, and the "
                   "supervisor must recover")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="seed of the probabilistic (~) fault specs")
    p.add_argument("--restart-backoff-s", type=float, default=0.05,
                   help="the supervisor's first wait before it restarts a "
                   "crashed dispatcher (doubling, at most 5 s); not a flag "
                   "of serve.py, whose wait is this default: a drill sets "
                   "it to see /healthz answer 503 while recovering")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the whole "
                   "serving session into this directory (started after "
                   "the warm-up, stopped at shutdown)")
    p.add_argument("--trace-spool", default=None, metavar="DIR",
                   help="distributed tracing: append every completed span "
                   "to a crash-safe per-process spool file under DIR (fleet "
                   "mode forwards it to every replica); merge the fleet's "
                   "spools into ONE Perfetto trace with python -m "
                   "deepvision_tpu_torch.obs.trace_merge DIR. "
                   "Flight-recorder dumps land in the same DIR")
    p.add_argument("--obs-role", default=None,
                   help="process label on spans, spools and dumps (fleet "
                   "mode sets each replica's slot id automatically; "
                   "default: router or replica by mode)")
    args = p.parse_args(argv)
    previous = _exit_on_sigterm()
    obs = (None, False)
    try:
        if args.fleet is not None:
            obs = _setup_obs(args, args.obs_role or "router")
            router = build_fleet(args)
            try:
                _serve(router, args, stdin, stdout)
            finally:
                router.close()
                # the grep-stable exit line of a fleet
                print(router.summary_line(), file=sys.stderr, flush=True)
            return 0
        obs = _setup_obs(args, args.obs_role or "replica")
        engine = build_engine(args)
        try:
            # the profiler's session starts after the warm-up, so that the
            # captures do not drown the steady state in its trace
            with profile_session(args.profile_dir):
                _serve(engine, args, stdin, stdout)
        finally:
            runners = engine.runner_stats()  # close() drops the runners
            engine.close()
            _print_pipeline_lines(engine, runners)
            _print_session_line(engine, runners)
            # the grep-stable tenancy line, which the swap drills read;
            # the [serve] line stays the last
            print(engine.tenancy.summary_line(), file=sys.stderr,
                  flush=True)
            _print_exit_line(engine)
        return 0
    finally:
        _teardown_obs(*obs)
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)


def _print_pipeline_lines(engine: InferenceEngine, runners: dict) -> None:
    """The grep-stable line of a server with pipelines: the requests each
    served, and the frozen runner cache's counters (misses that stayed
    at the warm-up's: no request paid a build); then the pipelines'
    runners (``runner_stats``, each bucket's calls among them), from
    which a process's kernel launches split between the DAGs and the
    models."""
    stats = engine.stats()
    if not stats["pipelines"]:
        return
    served = ",".join(f"{k}={v}" for k, v in stats["pipelines"].items())
    cache = stats["cache"]
    print(f"[pipeline] served {served} frozen={cache['frozen']} "
          f"misses={cache['misses']} hits={cache['hits']}",
          file=sys.stderr, flush=True)
    print(f"[pipeline] runners "
          f"{json.dumps({k: runners[k] for k in stats['pipelines']})}",
          file=sys.stderr, flush=True)


def _print_session_line(engine: InferenceEngine, runners: dict) -> None:
    """The grep-stable line of a server with streams: each store's
    counters (after close's flush) and its runners, the detect and the
    advance programs' launches a call and calls by bucket."""
    sessions = engine.stats().get("sessions")
    if not sessions:
        return
    for name, st in sessions.items():
        counters = " ".join(f"{k}={v}" for k, v in st["counters"].items())
        print(f"[sessions] {name} live={st['live']} {counters}; runners "
              f"{json.dumps(runners.get(name, {}).get('buckets', {}))}",
              file=sys.stderr, flush=True)


def _print_exit_line(engine: InferenceEngine) -> None:
    from deepvision_tpu_torch.ops import kernel_launches

    t = engine.telemetry
    launches = {k: v for k, v in kernel_launches().items()
                if k.startswith("lrn_forward") or k == "nms_sweep"}
    print(f"[serve] completed={t.completed} batches={t.batches} "
          f"failed={t.failed} shed={t.shed} timed_out={t.timed_out} "
          f"dispatcher_crashes={t.dispatcher_crashes} "
          f"dispatcher_restarts={t.dispatcher_restarts}; "
          f"kernel launches {launches}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    sys.exit(main())
