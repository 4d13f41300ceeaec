"""HTTP front end of the port (stdlib ``http.server``).

Endpoints, in the JAX server's JSON dialect
(``raftstereo_tpu/serve/server.py``):

* ``POST /predict`` — body ``{"left": A, "right": A, "iters": n?}`` where
  ``A`` is ``{"shape", "dtype", "data_b64"}`` (raw bytes, base64) or a
  nested list.  Replies 200 ``{"disparity": A, "meta": {...}}``, 400
  ``{"error": ...}`` on a malformed body.
* ``GET /healthz`` — liveness, device, buckets and per-bucket stats.

The micro-batcher, scheduler, sessions, tiers, binary wire frames and
metrics of the JAX server are later slices; each request here runs as
its own batch.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Union

import numpy as np

from ..config import ServeConfig
from .engine import BatchEngine

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 160 * 2 ** 20


def encode_array(a: np.ndarray) -> Dict:
    """Compact JSON-safe array encoding (raw bytes, base64)."""
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "data_b64": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(obj: Union[Dict, list]) -> np.ndarray:
    """Inverse of ``encode_array``; nested lists are also accepted.
    Returns float32."""
    if isinstance(obj, list):
        return np.asarray(obj, np.float32)
    if not isinstance(obj, dict):
        raise ValueError("array must be a nested list or "
                         "{shape, dtype, data_b64}")
    a = np.frombuffer(base64.b64decode(obj["data_b64"], validate=True),
                      dtype=np.dtype(obj["dtype"]))
    return a.reshape(obj["shape"]).astype(np.float32)


def parse_predict(body: bytes, serve_iters: int):
    """(left, right, iters) from a /predict body; ``ValueError`` on
    anything malformed."""
    try:
        obj = json.loads(body)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"body is not JSON: {e}")
    if not isinstance(obj, dict) or "left" not in obj or "right" not in obj:
        raise ValueError("body must be an object with 'left' and 'right'")
    try:
        left, right = decode_array(obj["left"]), decode_array(obj["right"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"bad array: {e}")
    if left.ndim != 3 or left.shape[-1] != 3 or left.shape != right.shape:
        raise ValueError(f"left {left.shape} and right {right.shape} must "
                         f"both be (H, W, 3)")
    if not (np.isfinite(left).all() and np.isfinite(right).all()):
        raise ValueError("images must be finite")
    iters = obj.get("iters", serve_iters)
    if iters != serve_iters:
        raise ValueError(f"iters {iters!r} not served; this server runs "
                         f"{serve_iters}")
    return left, right, iters


class _Handler(BaseHTTPRequestHandler):
    server: "StereoServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: one line per request is noise
        pass

    def _json(self, code: int, obj: Dict) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path.split("?")[0] != "/healthz":
            self._json(404, {"error": f"no such path {self.path!r}"})
            return
        eng = self.server.engine
        self._json(200, {"live": True, "ready": True,
                         "device": str(eng.device),
                         "buckets": [list(eng.bucket_of(b))
                                     for b in eng.cfg.buckets],
                         "serve_iters": eng.cfg.serve_iters,
                         "stats": eng.stats()})

    def do_POST(self):
        if self.path.split("?")[0] != "/predict":
            self._json(404, {"error": f"no such path {self.path!r}"})
            return
        try:
            n = int(self.headers.get("Content-Length", ""))
        except ValueError:
            self._json(400, {"error": "bad Content-Length"})
            return
        if n < 0 or n > MAX_BODY_BYTES:
            self._json(413 if n > 0 else 400,
                       {"error": f"body of {n} bytes not accepted"})
            return
        body = self.rfile.read(n)
        eng = self.server.engine
        try:
            left, right, iters = parse_predict(body, eng.cfg.serve_iters)
        except ValueError as e:
            self._json(400, {"error": f"bad request: {e}"})
            return
        t0 = time.perf_counter()
        try:
            (disp,) = eng.infer_batch([(left, right)], iters)
        except Exception as e:  # boundary: the server keeps serving
            logger.exception("inference failed")
            self._json(500, {"error": f"inference failed: {e}"})
            return
        self._json(200, {
            "disparity": encode_array(disp),
            "meta": {"iters": iters,
                     "bucket": list(eng.bucket_of(left.shape)),
                     "device": str(eng.device),
                     "latency_ms": (time.perf_counter() - t0) * 1e3}})


class StereoServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` bound to ``config.host:config.port`` that
    serves ``engine``; ``port`` is the bound port (0 binds a free one)."""

    daemon_threads = True

    def __init__(self, engine: BatchEngine, config: ServeConfig):
        super().__init__((config.host, config.port), _Handler)
        self.engine = engine

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self) -> threading.Thread:
        """Serve from a daemon thread; stop with ``shutdown()`` and
        ``server_close()``."""
        t = threading.Thread(target=self.serve_forever, name="serve-http",
                             daemon=True)
        t.start()
        return t


def build_server(model, config: ServeConfig = ServeConfig(),
                 device="cuda", warmup: bool = True) -> StereoServer:
    """Engine + server for ``model`` (already on ``device``); warms the
    configured buckets first unless ``warmup`` is False."""
    engine = BatchEngine(model, config, device=device)
    if warmup:
        engine.warmup()
    return StereoServer(engine, config)
