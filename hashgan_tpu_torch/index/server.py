"""HTTP retrieval service over a packed gallery (port of ``hashgan_tpu/index/server.py``).

Endpoints (all JSON):
  GET  /healthz            {"status": "ok", "n": ..., "bits": ..., "has_encoder": ...}
  GET  /stats              request counts + latency percentiles (ms)
  POST /query              {"codes": [[f32 x bits] x Q]} or
                           {"images": [[[[u8]]] x Q]}  (needs an encoder)
                           + optional "k", "mode", "with_labels"
                           -> {"distances": ..., "indices": ..., "n": ..., "labels"?}
                           Sentinel entries (index >= n) mark padding when
                           k exceeds the gallery.
  POST /extend             {"codes": [[f32 x bits] x M], "labels": [[...]]}
                           -> {"n": new_count}. Ids n..n+M-1, existing ids
                           stable (rebuilt on the device).
  POST /remove             {"ids": [...]} -> {"n": ..., "id_map": [...]}
                           (ids re-pack contiguously; id_map[new] = old.)

Every k and both modes are answered by ``PackedGallery.topk``'s engines.
Malformed requests answer HTTP 400 with the message. Requests run under one
lock: they serialize on the device anyway, and the lock keeps gallery swaps
atomic.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from hashgan_tpu_torch.index.engine import QueryEngine


class ServingStats:
    def __init__(self, window: int = 1024):
        self.lock = threading.Lock()
        self.requests = collections.Counter()
        self.errors = collections.Counter()
        self.latency_ms = collections.deque(maxlen=window)

    def record(self, endpoint: str, dt_ms: float, error: bool = False) -> None:
        with self.lock:
            self.requests[endpoint] += 1
            if error:
                self.errors[endpoint] += 1
            else:
                self.latency_ms.append(dt_ms)

    def snapshot(self) -> dict:
        with self.lock:
            lat = sorted(self.latency_ms)
            pct = lambda p: (  # noqa: E731
                lat[min(len(lat) - 1, int(p * len(lat)))] if lat else None
            )
            return {
                "requests": dict(self.requests),
                "errors": dict(self.errors),
                "latency_ms": {
                    "p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99),
                    "window": len(lat),
                },
            }


class GalleryService:
    """Thread-safe facade: query + extend/remove with atomic gallery swap."""

    def __init__(self, engine: QueryEngine, default_k: int = 100):
        self.engine = engine
        self.default_k = default_k
        self.lock = threading.Lock()
        self.stats = ServingStats()

    def query(self, payload: dict) -> dict:
        k = int(payload.get("k", self.default_k))
        mode = payload.get("mode", "exact")
        if mode not in ("exact", "approx"):
            raise ValueError(f"unknown mode {mode!r}")
        with_labels = bool(payload.get("with_labels", False))
        with self.lock:
            if "codes" in payload:
                codes = np.asarray(payload["codes"], dtype=np.float32)
                if codes.ndim != 2 or codes.shape[1] != self.engine.gallery.bits:
                    raise ValueError(
                        f"codes must be (Q, {self.engine.gallery.bits})"
                    )
                res = self.engine.query_codes(
                    codes, k=k, mode=mode, with_labels=with_labels
                )
            elif "images" in payload:
                images = np.asarray(payload["images"], dtype=np.uint8)
                res = self.engine.query_images(
                    images, k=k, mode=mode, with_labels=with_labels
                )
            else:
                raise ValueError("payload needs 'codes' or 'images'")
            # n under the lock: a concurrent extend/remove must not make the
            # reported gallery size disagree with the ranking's.
            n = self.engine.gallery.n
        out = {
            "distances": res.distances.tolist(),
            "indices": res.indices.tolist(),
            "n": n,
        }
        if res.labels is not None:
            out["labels"] = res.labels.tolist()
        return out

    def extend(self, payload: dict) -> dict:
        codes = np.asarray(payload["codes"], dtype=np.float32)
        labels = np.asarray(payload["labels"], dtype=np.float32)
        if codes.ndim != 2 or codes.shape[1] != self.engine.gallery.bits:
            raise ValueError(f"codes must be (M, {self.engine.gallery.bits})")
        if labels.shape[0] != codes.shape[0]:
            raise ValueError("labels/codes row mismatch")
        with self.lock:
            self.engine.gallery = self.engine.gallery.extend(codes, labels)
            return {"n": self.engine.gallery.n}

    def remove(self, payload: dict) -> dict:
        ids = np.asarray(payload["ids"], dtype=np.int64)
        with self.lock:
            n = self.engine.gallery.n
            # Out-of-range ids: numpy would raise an opaque IndexError for
            # id >= n and silently WRAP negative ids onto real items.
            if ids.size and (ids.min() < 0 or ids.max() >= n):
                raise ValueError(
                    f"ids must be in [0, {n}); got range "
                    f"[{ids.min()}, {ids.max()}]"
                )
            gal, id_map = self.engine.gallery.remove(ids)
            self.engine.gallery = gal
            return {"n": gal.n, "id_map": id_map.tolist()}


def _make_handler(service: GalleryService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet: /stats replaces it
            pass

        def _send(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                g = service.engine.gallery
                self._send(200, {
                    "status": "ok", "n": g.n, "bits": g.bits,
                    "has_encoder": service.engine.encoder is not None,
                })
            elif self.path == "/stats":
                self._send(200, service.stats.snapshot())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            t0 = time.perf_counter()
            route = {
                "/query": service.query,
                "/extend": service.extend,
                "/remove": service.remove,
            }.get(self.path)
            if route is None:
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError(
                        f"body must be a JSON object, got {type(payload).__name__}"
                    )
                out = route(payload)
            except (ValueError, KeyError, TypeError, NotImplementedError) as e:
                service.stats.record(
                    self.path, (time.perf_counter() - t0) * 1e3, error=True
                )
                self._send(400, {"error": str(e)})
                return
            service.stats.record(self.path, (time.perf_counter() - t0) * 1e3)
            self._send(200, out)

    return Handler


def make_server(engine: QueryEngine, host: str = "127.0.0.1", port: int = 0,
                default_k: int = 100) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; ``server.server_address`` carries
    the bound port (port=0 picks a free one)."""
    service = GalleryService(engine, default_k=default_k)
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    server.service = service
    return server


def serve_forever(engine: QueryEngine, host: str = "127.0.0.1",
                  port: int = 8080, default_k: int = 100) -> None:
    server = make_server(engine, host=host, port=port, default_k=default_k)
    g = engine.gallery
    print(f"hashgan_tpu_torch serving on http://{host}:{server.server_address[1]} "
          f"(gallery n={g.n}, {g.bits}-bit, {g.device})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
