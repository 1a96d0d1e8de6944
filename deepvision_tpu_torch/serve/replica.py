"""Serving replicas: the units the fleet router supervises.

The port of ``deepvision_tpu/serve/replica.py``. A replica is one
engine's worth of serving capacity behind a surface the
:class:`~deepvision_tpu_torch.serve.router.FleetRouter` can route to,
probe, drain and kill:

- :class:`EngineReplica` wraps an in-process
  :class:`~deepvision_tpu_torch.serve.engine.InferenceEngine` with a
  registry of its own, for the router's lifecycle tests;
- :class:`ProcessReplica` spawns the port's serving CLI as a child
  process, ``python -m deepvision_tpu_torch.serve --http 0 --port-file
  F`` (:func:`replica_argv`), and talks HTTP to it: the production
  topology, in which a crash, a SIGKILL or an out-of-memory takes out
  one replica's capacity and never the fleet's.

The contract every backend keeps:

- ``request()`` returns the result dict or raises: a
  :class:`ReplicaDeadError` (the replica is gone: the router fails
  over), a :class:`~deepvision_tpu_torch.serve.admission.ShedError`
  (replica-side backpressure, with ``retry_after_s``), a
  ``TimeoutError`` (slow, not dead), ``ValueError`` (a client error, not
  retried elsewhere) or ``RuntimeError`` (a request that failed on a
  live replica, retried elsewhere);
- ``probe()`` returns the health dict (``status`` ``"ok"`` or
  ``"recovering"``) or raises :class:`ReplicaDeadError`;
- ``kill()`` is abrupt (SIGKILL, or an engine closed under its
  requests), ``stop()`` graceful (SIGTERM); both are idempotent. A
  killed replica is not restarted: the router builds a fresh one. A
  kill loses the stateful sessions' state past their newest snapshots;
  a stop flushes it.

A stream frame carries ``session`` and ``seq`` to ``request()``; the
replica's session store threads the stream's state by them. ``trace``,
the request's distributed trace id, reaches the replica's engine, whose
``replica_queue``, ``device`` and ``postprocess`` spans carry it: in
process as ``submit(trace=)``, to a child as the ``X-DVTPU-Trace``
header.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np

from deepvision_tpu_torch.serve.admission import ShedError

__all__ = ["ReplicaDeadError", "EngineReplica", "ProcessReplica",
           "replica_argv", "replica_env"]

REPO = Path(__file__).resolve().parents[2]
# how long a child may take from its spawn to /healthz 200 (its warm-up
# traces, captures and exports every runner)
STARTUP_TIMEOUT_S = 240.0


class ReplicaDeadError(RuntimeError):
    """The replica is gone (process exited, engine closed, connection
    refused by a dead process): the router marks it dead and fails the
    attempt over to another replica."""


class EngineReplica:
    """In-process replica: one :class:`InferenceEngine` over the models
    that ``models_factory()`` returns, built at :meth:`start`, with a
    ``ServeTelemetry`` over a registry of its own (N engines in one
    process must not share the ``serve_*`` names). ``kill()`` closes the
    engine under its in-flight requests, which fail."""

    def __init__(self, replica_id: str,
                 models_factory: Callable[[], list],
                 **engine_kw):
        self.replica_id = replica_id
        self._models_factory = models_factory
        self._engine_kw = dict(engine_kw)
        self._engine = None
        self._dead = False

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        from deepvision_tpu_torch.obs.metrics import Registry
        from deepvision_tpu_torch.serve.engine import InferenceEngine
        from deepvision_tpu_torch.serve.telemetry import ServeTelemetry

        kw = dict(self._engine_kw)
        kw.setdefault("telemetry", ServeTelemetry(registry=Registry()))
        self._engine = InferenceEngine(self._models_factory(), **kw)

    def stop(self) -> None:
        if self._engine is not None:
            self._engine.close()

    def kill(self) -> None:
        """Abrupt death: in-flight futures fail with 'engine closed',
        later requests and probes raise :class:`ReplicaDeadError`.
        Session state is ABANDONED, not flushed: an in-process kill must
        recover from the cadence snapshots as a SIGKILL does."""
        self._dead = True
        if self._engine is not None:
            self._engine.close(abandon_sessions=True)

    # -- serving surface -------------------------------------------------
    def _live_engine(self):
        if self._dead or self._engine is None:
            raise ReplicaDeadError(f"{self.replica_id}: replica is dead")
        return self._engine

    def request(self, model: str | None, x, *,
                timeout_s: float | None = None,
                trace: str | None = None,
                session: str | None = None,
                seq: int | None = None) -> dict:
        engine = self._live_engine()
        try:
            fut = engine.submit(x, model=model, timeout_s=timeout_s,
                                trace=trace, session=session, seq=seq)
            return fut.result(
                timeout=timeout_s + 1.0 if timeout_s is not None else None)
        except (ShedError, TimeoutError, ValueError):
            raise
        except RuntimeError as e:
            # "closed": the engine is gone for good, a death verdict. A
            # dispatcher crash is not: the supervisor is restarting it
            # (the probe reports "recovering" and the router drains)
            if "closed" in str(e):
                raise ReplicaDeadError(f"{self.replica_id}: {e}") from e
            raise

    def probe(self) -> dict:
        return self._live_engine().health()

    def stats(self) -> dict:
        return self._live_engine().stats()

    def metrics_dump(self) -> dict:
        """This replica's typed registry dump (histogram reservoirs
        included), off the engine's own registry: the federation's
        scrape."""
        return self._live_engine().telemetry.registry.dump()


class ProcessReplica:
    """Child-process replica: runs ``argv`` plus ``--port-file F`` and
    talks HTTP to it (``POST /v1/predict``, ``GET /healthz``, ``GET
    /stats``, ``GET /metrics.json``). The child's output goes to
    ``replica.log`` beside its port file, in a fresh directory
    ``dvt-replica-<id>-*`` under the temporary directory; its environment
    is :func:`replica_env`'s."""

    def __init__(self, replica_id: str, argv: list[str]):
        self.replica_id = replica_id
        self._argv = list(argv)
        self._proc: subprocess.Popen | None = None
        self._port: int | None = None
        self._dead = False
        self._log_path: Path | None = None
        # one keep-alive connection a thread (the server speaks
        # HTTP/1.1): a router attempt thread pays TCP set-up once
        self._conns = threading.local()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        tmp = Path(tempfile.mkdtemp(prefix=f"dvt-replica-{self.replica_id}-"))
        port_file = tmp / "port"
        self._log_path = tmp / "replica.log"
        argv = self._argv + ["--port-file", str(port_file)]
        with open(self._log_path, "wb") as log:
            self._proc = subprocess.Popen(
                argv, stdout=log, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL, env=replica_env())
        deadline = time.monotonic() + STARTUP_TIMEOUT_S
        # the port file appears once the server is bound, which the CLI
        # does after its warm-up; /healthz 200 then says it serves
        while True:
            if self._proc.poll() is not None:
                raise ReplicaDeadError(
                    f"{self.replica_id}: exited rc={self._proc.returncode} "
                    f"during startup (log: {self._log_path})")
            if self._port is None and port_file.exists():
                try:
                    self._port = int(port_file.read_text().strip())
                except ValueError:
                    self._port = None  # partially written: retry
            if self._port is not None:
                try:
                    if self.probe().get("status") == "ok":
                        return
                except (ReplicaDeadError, OSError, RuntimeError):
                    pass
            if time.monotonic() > deadline:
                self.kill()
                raise ReplicaDeadError(
                    f"{self.replica_id}: not ready within "
                    f"{STARTUP_TIMEOUT_S:.0f}s (log: {self._log_path})")
            time.sleep(0.1)

    def stop(self, grace_s: float = 30.0) -> None:
        """SIGTERM, then SIGKILL after ``grace_s``: the port's CLI turns
        SIGTERM into exit code 143 after closing its engine and printing
        its ``[serve]`` line. The exit code is written to stderr."""
        if self._proc is None:
            return
        self._dead = True
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(grace_s)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(grace_s)
            print(f"[router] replica {self.replica_id} (pid "
                  f"{self._proc.pid}) stopped: exit {self._proc.returncode}",
                  file=sys.stderr, flush=True)

    def kill(self) -> None:
        """SIGKILL, and reap the process (its card memory comes back
        only then)."""
        self._dead = True
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            try:
                self._proc.wait(5.0)
            except subprocess.TimeoutExpired:
                pass

    @property
    def pid(self) -> int | None:
        return self._proc.pid if self._proc is not None else None

    # -- HTTP plumbing ---------------------------------------------------
    def _http(self, method: str, path: str, body: str | None = None,
              timeout_s: float = 10.0, headers: dict | None = None):
        import http.client

        if self._dead or self._port is None:
            raise ReplicaDeadError(f"{self.replica_id}: replica is dead")
        if self._proc is not None and self._proc.poll() is not None:
            raise ReplicaDeadError(
                f"{self.replica_id}: process exited "
                f"rc={self._proc.returncode}")
        conn = getattr(self._conns, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection("127.0.0.1", self._port,
                                              timeout=timeout_s)
            self._conns.conn = conn
        else:
            conn.timeout = timeout_s
            if conn.sock is not None:
                conn.sock.settimeout(timeout_s)
        try:
            conn.request(method, path, body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        except TimeoutError as e:
            # a read timeout means slow, not dead: a latency failure the
            # router may retry, never a respawn. The half-read keep-alive
            # socket is unusable either way
            self._drop_conn(conn)
            raise TimeoutError(
                f"{self.replica_id}: no response within {timeout_s}s"
            ) from e
        except (ConnectionError, OSError,
                http.client.HTTPException) as e:
            self._drop_conn(conn)
            if self._proc is not None and self._proc.poll() is None:
                # the process is alive: a dropped connection is a request
                # failure (retryable, breaker food), not a death verdict
                # that would SIGKILL a live replica and pay a respawn
                raise RuntimeError(
                    f"{self.replica_id}: request failed "
                    f"({type(e).__name__}: {e}); process alive") from e
            raise ReplicaDeadError(
                f"{self.replica_id}: {type(e).__name__}: {e}") from e

    def _drop_conn(self, conn) -> None:
        self._conns.conn = None
        try:
            conn.close()
        except Exception:
            pass

    # -- serving surface -------------------------------------------------
    def request(self, model: str | None, x, *,
                timeout_s: float | None = None,
                trace: str | None = None,
                session: str | None = None,
                seq: int | None = None) -> dict:
        import base64

        # the binary wire format (``input_b64``): base64 of the raw bytes
        # is about 20 times cheaper to encode and decode than JSON lists
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        payload: dict = {
            "input_b64": base64.b64encode(x.tobytes()).decode("ascii"),
            "shape": list(x.shape),
            "dtype": "float32",
        }
        if model is not None:
            payload["model"] = model
        if session is not None:
            # a stream frame: the child's session store threads the
            # stream's state by (session, seq)
            payload["session"] = session
            payload["seq"] = seq
        if timeout_s is not None:
            # the router's remaining deadline rides to the child, so that
            # it stops working a request the router has already timed out
            # or hedged away
            payload["timeout_s"] = round(timeout_s, 3)
        req_headers = None
        if trace is not None:
            from deepvision_tpu_torch.obs.distributed import TRACE_HEADER

            req_headers = {TRACE_HEADER: trace}
        status, headers, body = self._http(
            "POST", "/v1/predict", json.dumps(payload),
            timeout_s=(timeout_s or 30.0) + 1.0, headers=req_headers)
        try:
            data = json.loads(body)
        except ValueError:
            data = {"error": body.decode(errors="replace")}
        if status == 200:
            return data["result"]
        if status == 429:
            raise ShedError(data.get("error", "shed"),
                            float(data.get("retry_after", 0.05)))
        if status == 504:
            raise TimeoutError(data.get("error", "deadline expired"))
        if status == 400:
            raise ValueError(data.get("error", "bad request"))
        # 5xx or another code: the replica answered, so it is alive; a
        # request-level failure the router may retry elsewhere
        raise RuntimeError(
            f"{self.replica_id}: HTTP {status}: {data.get('error')}")

    def probe(self) -> dict:
        status, headers, body = self._http("GET", "/healthz",
                                           timeout_s=5.0)
        try:
            health = json.loads(body)
        except ValueError:
            health = {}
        if status == 200:
            health.setdefault("status", "ok")
        else:
            health.setdefault("status", "recovering")
        return health

    def stats(self) -> dict:
        status, _h, body = self._http("GET", "/stats", timeout_s=5.0)
        if status != 200:
            raise ReplicaDeadError(
                f"{self.replica_id}: /stats HTTP {status}")
        return json.loads(body)

    def metrics_dump(self) -> dict:
        """The child's typed registry dump (``GET /metrics.json``), which
        the router federates into its ``/metrics``."""
        status, _h, body = self._http("GET", "/metrics.json",
                                      timeout_s=5.0)
        if status != 200:
            raise RuntimeError(
                f"{self.replica_id}: /metrics.json HTTP {status}")
        return json.loads(body)


def replica_env(environ=None) -> dict:
    """``environ`` (default: this process's) with the repository first on
    ``PYTHONPATH``, so that a child's ``-m deepvision_tpu_torch.serve``
    imports this checkout."""
    env = dict(os.environ if environ is None else environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    return env


def replica_argv(model_specs: list[str], *, buckets: str | None = None,
                 artifact_specs: list[str] | None = None,
                 store: str | None = None, device: str = "cuda",
                 pipelines: list[str] | None = None,
                 extra: list[str] | None = None) -> list[str]:
    """argv of a :class:`ProcessReplica` child: this interpreter running
    the port's serving CLI, ``-m deepvision_tpu_torch.serve``, in HTTP
    mode on an ephemeral port, on ``device``.

    ``store``: an artifact-store directory (``--store``) that every child
    of the fleet shares, so that a respawned replica warms its runners
    from the programs the first generation traced. ``pipelines``: the
    ``--pipelines`` spec files, each of which every child builds, checks
    and warms itself."""
    argv = [sys.executable, "-m", "deepvision_tpu_torch.serve",
            "--http", "0"]
    for spec in model_specs:
        argv += ["-m", spec]
    for spec in artifact_specs or []:
        argv += ["--artifact", spec]
    if buckets:
        argv += ["--buckets", buckets]
    if store:
        argv += ["--store", str(store)]
    for path in pipelines or []:
        argv += ["--pipelines", str(path)]
    argv += ["--device", device]
    argv += list(extra or [])
    return argv
