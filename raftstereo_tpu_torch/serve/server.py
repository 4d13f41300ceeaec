"""HTTP front end of the port (stdlib ``http.server``).

Endpoints, in the JAX server's JSON dialect
(``raftstereo_tpu/serve/server.py``):

* ``POST /predict`` — body ``{"left": A, "right": A, "iters": n?,
  "accuracy": tier?}`` where ``A`` is ``{"shape", "dtype", "data_b64"}``
  (raw bytes, base64) or a nested list.  Replies 200 ``{"disparity": A,
  "meta": {...}}`` (``meta["accuracy"]`` echoes a tier), 400 ``{"error":
  ...}`` on a malformed body, an unknown tier or one the server does not
  advertise (with the reason recorded at startup).
* ``GET /healthz`` — liveness, device, buckets, per-bucket stats and,
  with ``ServeConfig.tiers``, the advertised and refused tiers.

Accuracy tiers (``ops.quant``): ``build_server`` resolves
``ServeConfig.tiers`` against the certification manifest
(``eval.certify.resolve_tiers``), builds each advertised tier's model
(a tier whose numerics the port does not run on this architecture is
refused with the ``NotImplementedError``'s text) and warms the base
mode, then each advertised mode.  A tier whose mode is the base model's
own runs the base model; a request without ``accuracy`` always does.

The micro-batcher, scheduler, sessions, cascades, binary wire frames and
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
from typing import Dict, Optional, Union

import numpy as np

from ..config import ServeConfig
from ..ops.quant import mode_for_accuracy
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
    """(left, right, iters, accuracy) from a /predict body (``accuracy``
    None when absent); ``ValueError`` on anything malformed."""
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
    accuracy = obj.get("accuracy")
    if accuracy is not None:
        accuracy = str(accuracy)
        mode_for_accuracy(accuracy)  # an unknown tier is a ValueError
    return left, right, iters, accuracy


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
        srv = self.server
        eng = srv.engine
        health = {"live": True, "ready": True, "device": str(eng.device),
                  "buckets": [list(eng.bucket_of(b))
                              for b in eng.cfg.buckets],
                  "serve_iters": eng.cfg.serve_iters, "stats": eng.stats()}
        if eng.cfg.tiers:
            health["tiers"] = {"advertised": dict(sorted(srv.tiers.items())),
                               "refused": dict(srv.tier_reasons)}
        self._json(200, health)

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
        srv = self.server
        eng = srv.engine
        try:
            left, right, iters, accuracy = parse_predict(
                body, eng.cfg.serve_iters)
            mode = srv.mode_of(accuracy)
        except ValueError as e:
            self._json(400, {"error": f"bad request: {e}"})
            return
        t0 = time.perf_counter()
        try:
            (disp,) = eng.infer_batch([(left, right)], iters, mode=mode)
        except Exception as e:  # boundary: the server keeps serving
            logger.exception("inference failed")
            self._json(500, {"error": f"inference failed: {e}"})
            return
        meta = {"iters": iters, "bucket": list(eng.bucket_of(left.shape)),
                "device": str(eng.device),
                "latency_ms": (time.perf_counter() - t0) * 1e3}
        if accuracy is not None:
            meta["accuracy"] = accuracy
        self._json(200, {"disparity": encode_array(disp), "meta": meta})


class StereoServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` bound to ``config.host:config.port`` that
    serves ``engine``; ``port`` is the bound port (0 binds a free one).
    ``tiers`` maps each advertised tier to its precision mode,
    ``tier_reasons`` each refused one to its reason."""

    daemon_threads = True

    def __init__(self, engine: BatchEngine, config: ServeConfig,
                 tiers: Optional[Dict[str, str]] = None,
                 tier_reasons: Optional[Dict[str, str]] = None):
        super().__init__((config.host, config.port), _Handler)
        self.engine = engine
        self.tiers = dict(tiers or {})
        self.tier_reasons = dict(tier_reasons or {})

    def mode_of(self, accuracy: Optional[str]) -> Optional[str]:
        """The engine mode of a request's ``accuracy`` tier: None (the base
        model) without one or where the tier's mode is the base model's
        own; ``ValueError`` for a tier this server does not advertise."""
        if accuracy is None:
            return None
        if accuracy not in self.tiers:
            reason = self.tier_reasons.get(
                accuracy, "tier not offered by this server (--tiers)")
            raise ValueError(f"accuracy tier {accuracy!r} not advertised: "
                             f"{reason}")
        mode = self.tiers[accuracy]
        return None if mode == self.engine.default_mode else mode

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
    """Engine + server for ``model`` (already on ``device``).  Resolves
    the accuracy tiers (a tier the manifest does not certify, or whose
    model the port cannot build, is refused with its reason), then warms
    the configured buckets in the base mode and each advertised mode
    unless ``warmup`` is False."""
    from ..eval.certify import resolve_tiers

    engine = BatchEngine(model, config, device=device)
    tiers, reasons = resolve_tiers(config, model.config, engine.device)
    for tier, mode in list(tiers.items()):
        try:
            engine.model_for(mode)
        except NotImplementedError as e:
            logger.warning("accuracy tier %r NOT advertised: %s", tier, e)
            reasons[tier] = str(e)
            del tiers[tier]
    if warmup:
        base = engine.default_mode
        engine.warmup([None] + sorted(set(tiers.values()) - {base}))
    return StereoServer(engine, config, tiers, reasons)
