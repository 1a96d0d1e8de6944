"""The HTTP front of the serving CLI (``--http PORT``), on the standard
library's ``http.server``: the surface of ``serve.py``, over one engine
or over a fleet router (``serve/router.FleetRouter``).

    POST /v1/predict  {"model": NAME, "input": [...]}           -> result
                      {"model": NAME, "input_b64": B64, "shape": [...]}
    POST /v1/pipeline/NAME  {"input": [...]}  a served DAG (``--pipelines``)
                      by its URL; past the path the request is a
                      /v1/predict one with ``"model": NAME``
                      a stream frame of a stateful model (``--track``)
                      adds ``"session": ID, "seq": N``
    POST /v1/swap     {"model": NAME, "perturb": F | "workdir": DIR}: a
                      zero-drop weight swap (``InferenceEngine.hot_swap``),
                      synchronous: the 200 comes once the new ladder is
                      captured, installed and flipped, with the swap's
                      result; the other handler threads serve throughout.
                      404 on a fleet (its router owns no weights)
    GET  /stats       engine, runner cache, queue, telemetry and the
                      process's kernel launches (JSON); a router's
                      replicas, breakers and telemetry
    GET  /metrics     Prometheus text of the process's metric registry
                      (``serve_*`` counters and latency quantiles, and
                      the ``mem_*`` device gauges sampled per scrape);
                      a router's federated surface (its ``router_*``
                      families and every replica's, labelled)
    GET  /metrics.json  the registry's typed dump
    GET  /healthz     200 {"status": "ok"}; 503 with ``Retry-After``
                      while the dispatcher's supervisor recovers (a
                      router: while no replica is ready)

A request may carry the fleet's trace id in ``X-DVTPU-Trace``
(``obs/distributed.TRACE_HEADER``) or in a ``"trace"`` field of its body
(the header wins); it goes to ``submit(trace=)``, so that the engine's
``replica_queue``, ``device`` and ``postprocess`` spans (or the router's
``router_attempt``, in front of a fleet) carry it.

The status codes are the JAX surface's: 400 for a request that cannot
be decoded or does not fit the model, 404 for another path, 429 with
``Retry-After`` when admission sheds, 500 when the dispatcher crashed
or the engine is closed (a server fault a client may retry), 504 when
the request's deadline expired. A ``seq`` that is not an integer is a
400.
"""

from __future__ import annotations

import base64
import contextlib
import http.server
import json
import math
import os
import sys
import tempfile
from concurrent.futures import TimeoutError as _FutureTimeout
from pathlib import Path

import numpy as np

from deepvision_tpu_torch.obs.distributed import TRACE_HEADER
from deepvision_tpu_torch.serve.admission import ShedError

__all__ = ["make_handler", "run_http", "decode_input", "render_metrics",
           "make_server", "jsonable"]


def jsonable(obj):
    """``obj`` with numpy arrays and scalars turned into lists and Python
    numbers, for ``json.dumps``."""
    if isinstance(obj, dict):
        return {k: jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def decode_input(req: dict) -> np.ndarray:
    """A request's input as float32. Two wire formats: ``"input"``, nested
    JSON lists of numbers; ``"input_b64"`` and ``"shape"`` (and
    ``"dtype"``, default float32), base64 of the array's raw
    little-endian bytes, about 20 times cheaper to encode and decode."""
    if "input_b64" in req:
        dtype = np.dtype(req.get("dtype", "float32"))
        raw = base64.b64decode(req["input_b64"], validate=True)
        x = np.frombuffer(raw, dtype=dtype).reshape(req["shape"])
        return np.ascontiguousarray(x, np.float32)
    return np.asarray(req["input"], np.float32)


def render_metrics() -> str:
    """Prometheus text for ``GET /metrics``: the process's registry, with
    the ``mem_*`` device gauges sampled first (none on the CPU)."""
    from deepvision_tpu_torch.obs.metrics import default_registry
    from deepvision_tpu_torch.obs.profiler import sample_memory_gauges

    sample_memory_gauges()
    return default_registry().render_prometheus()


def make_handler(engine, args):
    """A ``BaseHTTPRequestHandler`` subclass bound to ``engine``; ``args``
    needs ``timeout_s``, the blanket deadline of a request (a request's
    own ``timeout_s`` may only lower it)."""
    models = engine.stats()["models"]  # static: /healthz stays cheap

    class Handler(http.server.BaseHTTPRequestHandler):
        # keep-alive: every response below sets Content-Length
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # telemetry is the record
            pass

        def _send(self, code: int, payload: dict,
                  headers: dict | None = None):
            self._send_text(code, json.dumps(payload), "application/json",
                            headers)

        def _send_text(self, code: int, body: str, content_type: str,
                       headers: dict | None = None) -> None:
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                h = engine.health()
                h["models"] = models
                if h["status"] == "ok":
                    self._send(200, h)
                else:
                    ra = max(1, math.ceil(h.get("retry_after_s", 1.0)))
                    self._send(503, h, {"Retry-After": str(ra)})
            elif self.path == "/stats":
                self._send(200, engine.stats())
            elif self.path == "/metrics":
                # a fleet router renders the federated surface, and never
                # samples device memory: its process holds no CUDA
                # context
                render = getattr(engine, "render_metrics", None)
                self._send_text(200,
                                render() if render is not None
                                else render_metrics(),
                                "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/metrics.json":
                from deepvision_tpu_torch.obs.metrics import default_registry

                self._send(200, default_registry().dump())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            pipeline = None
            if self.path == "/v1/swap":
                self._do_swap()
                return
            if self.path.startswith("/v1/pipeline/"):
                pipeline = self.path[len("/v1/pipeline/"):]
                if not pipeline:
                    self._send(404, {"error": "not found"})
                    return
            elif self.path not in ("/v1/predict", "/predict"):
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                if not isinstance(req, dict):
                    raise ValueError("request must be a JSON object")
                x = decode_input(req)
                # a stream frame (the router forwards these on its
                # replica hop): the session's id and the frame's number
                session = req.get("session")
                seq = req.get("seq")
                seq = int(seq) if seq is not None else None
                timeout_s = args.timeout_s
                if "timeout_s" in req:
                    timeout_s = min(float(req["timeout_s"]), args.timeout_s)
                    if timeout_s <= 0:
                        raise ValueError(
                            f"timeout_s must be > 0, got {timeout_s}")
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            # the distributed trace id: the router's hop carries it as a
            # header, a client may send it in the body
            trace = self.headers.get(TRACE_HEADER) or req.get("trace")
            try:
                fut = engine.submit(x, model=pipeline or req.get("model"),
                                    timeout_s=timeout_s, trace=trace,
                                    session=session, seq=seq)
                result = fut.result(timeout=timeout_s + 1.0)
            except ShedError as e:
                self._send(429, {"error": str(e),
                                 "retry_after": e.retry_after_s},
                           {"Retry-After": str(e.retry_after_s)})
                return
            except (TimeoutError, _FutureTimeout) as e:
                self._send(504, {"error": f"deadline expired: {e}"})
                return
            except ValueError as e:
                self._send(400, {"error": str(e)})
                return
            except RuntimeError as e:
                # a server fault (dispatcher crash, engine closed): 500,
                # which a client may retry, never a 400
                self._send(500, {"error": str(e)})
                return
            self._send(200, {"result": jsonable(result)})

        def _do_swap(self):
            hot_swap = getattr(engine, "hot_swap", None)
            if hot_swap is None:
                self._send(404, {"error": "swap needs a single-engine "
                                 "replica (a fleet's router owns no "
                                 "weights)"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                if not isinstance(req, dict) or "model" not in req:
                    raise ValueError("need a JSON object with 'model'")
                kw = {k: req[k] for k in ("workdir", "perturb") if k in req}
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                # a checkpoint restore's chatter stays off stdout
                with contextlib.redirect_stdout(sys.stderr):
                    result = hot_swap(req["model"], **kw)
            except ValueError as e:
                self._send(400, {"error": str(e)})
                return
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, {"result": jsonable(result)})

    return Handler


def make_server(addr, handler):
    """A ``ThreadingHTTPServer`` with a deep accept backlog (the default
    5 drops connections under a burst) and daemon handler threads, so
    that shutdown never waits on an idle keep-alive connection."""
    srv = http.server.ThreadingHTTPServer(addr, handler,
                                          bind_and_activate=False)
    srv.request_queue_size = 128
    srv.daemon_threads = True
    srv.server_bind()
    srv.server_activate()
    return srv


def run_http(engine, args) -> None:
    """Serve ``engine`` on ``args.http`` (0: an ephemeral port, written
    to ``args.port_file`` at once, atomically) until interrupted
    (SIGINT)."""
    server = make_server(("", args.http), make_handler(engine, args))
    port = server.server_address[1]
    if getattr(args, "port_file", None):
        fd, tmp = tempfile.mkstemp(
            dir=str(Path(args.port_file).parent) or ".")
        with os.fdopen(fd, "w") as f:
            f.write(str(port))
        os.replace(tmp, args.port_file)
    print(f"listening on :{port} (POST /v1/predict, POST /v1/pipeline/NAME, "
          f"POST /v1/swap, GET /stats, GET /metrics, GET /healthz)",
          file=sys.stderr, flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
