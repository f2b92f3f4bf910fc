"""Serving controller: worker registry, heartbeats, dispatch, stream proxy
(counterpart of `radvlm_tpu/serve/controller.py`).

Rebuild of the reference controller (`finetuning/llava/serve/controller.py`):
same worker protocol (register/heartbeat/status), same dispatch policies —
"lottery" (speed-weighted random, `controller.py:117-143`) and "shortest_queue"
(queue-length normalized by speed, `:145-167`) — and the same streaming proxy
endpoint. Implemented on stdlib ThreadingHTTPServer; the registry logic is a
plain class so it unit-tests without sockets.

Differences from the JAX module, all in how it speaks HTTP to the workers:
`urllib.request` in place of `requests` (`open_post`, `pieces`). A proxied
stream forwards each piece of the worker's body as it arrives (`read1`, a
flush after each write), so the first token reaches the client before the
last is made. A worker's error status and body pass through as `requests`
passes them (urllib raises them as `HTTPError`, whose body is read instead).
`shutdown()` also closes the listening socket.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterator, List, Optional

import numpy as np

log = logging.getLogger(__name__)

HEARTBEAT_EXPIRATION = 90  # seconds (reference constants.py:2: 90)


def open_post(url: str, obj: dict, timeout: float):
    """POST `obj` as JSON. Returns the response, also for an error status
    (urllib raises those as `HTTPError`, which reads as the response)."""
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(), headers={"Content-Type": "application/json"}
    )
    try:
        return urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        return e


def pieces(resp, size: int = 65536) -> Iterator[bytes]:
    """The response's body, each piece as soon as it arrives: `read()`
    would buffer to EOF and turn time to first token into completion time."""
    with resp:
        while True:
            piece = resp.read1(size)
            if not piece:
                return
            yield piece


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    last_heartbeat: float


class Registry:
    """Worker bookkeeping + dispatch (no I/O)."""

    def __init__(self, dispatch: str = "shortest_queue"):
        if dispatch not in ("lottery", "shortest_queue"):
            raise ValueError(dispatch)
        self.dispatch = dispatch
        self.workers: Dict[str, WorkerInfo] = {}
        self.lock = threading.Lock()

    def register(self, address: str, model_names: List[str], speed: float = 1.0,
                 queue_length: int = 0) -> None:
        with self.lock:
            self.workers[address] = WorkerInfo(
                model_names=list(model_names),
                speed=float(speed),
                queue_length=int(queue_length),
                last_heartbeat=time.time(),
            )
        log.info("registered worker %s (%s)", address, model_names)

    def heartbeat(self, address: str, queue_length: int) -> bool:
        with self.lock:
            w = self.workers.get(address)
            if w is None:
                return False
            w.queue_length = int(queue_length)
            w.last_heartbeat = time.time()
            return True

    def expire_stale(self, *, now: Optional[float] = None) -> List[str]:
        now = now or time.time()
        with self.lock:
            stale = [
                a for a, w in self.workers.items()
                if now - w.last_heartbeat > HEARTBEAT_EXPIRATION
            ]
            for a in stale:
                del self.workers[a]
        return stale

    def list_models(self) -> List[str]:
        with self.lock:
            names = {m for w in self.workers.values() for m in w.model_names}
        return sorted(names)

    def get_worker_address(self, model_name: str, *, rng=None) -> str:
        rng = rng or np.random.default_rng()
        with self.lock:
            cands = [
                (a, w) for a, w in self.workers.items()
                if model_name in w.model_names
            ]
            if not cands:
                return ""
            if self.dispatch == "lottery":
                speeds = np.asarray([w.speed for _, w in cands], float)
                total = speeds.sum()
                if total <= 0:
                    return ""
                return cands[rng.choice(len(cands), p=speeds / total)][0]
            # shortest_queue: queue length normalized by speed
            norm = [w.queue_length / max(w.speed, 1e-6) for _, w in cands]
            i = int(np.argmin(norm))
            cands[i][1].queue_length += 1
            return cands[i][0]


class Controller:
    """HTTP front: registry endpoints + generate-stream proxy."""

    def __init__(self, host: str = "0.0.0.0", port: int = 21001,
                 dispatch: str = "shortest_queue"):
        self.registry = Registry(dispatch)
        self.host, self.port = host, port
        self._server: Optional[ThreadingHTTPServer] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _expire_loop(self):
        while not self._stop.wait(HEARTBEAT_EXPIRATION / 3):
            stale = self.registry.expire_stale()
            for a in stale:
                log.info("expired stale worker %s", a)

    def make_handler(controller):
        registry = controller.registry

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _read(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_POST(self):
                try:
                    data = self._read()
                except (ValueError, UnicodeDecodeError):
                    self._json({"error": "malformed JSON body"}, code=400)
                    return
                if self.path == "/register_worker":
                    registry.register(
                        data["worker_name"],
                        data.get("model_names", []),
                        data.get("speed", 1.0),
                        data.get("queue_length", 0),
                    )
                    self._json({"ok": True})
                elif self.path == "/receive_heart_beat":
                    ok = registry.heartbeat(
                        data["worker_name"], data.get("queue_length", 0)
                    )
                    self._json({"exist": ok})
                elif self.path == "/refresh_all_workers":
                    # Reference controller.py's pre-list refresh: drop workers
                    # that stopped heartbeating so /list_models is current.
                    stale = registry.expire_stale()
                    self._json({"ok": True, "expired": stale})
                elif self.path == "/list_models":
                    self._json({"models": registry.list_models()})
                elif self.path == "/get_worker_address":
                    self._json({"address": registry.get_worker_address(data["model"])})
                elif self.path == "/worker_generate_stream":
                    addr = registry.get_worker_address(data.get("model", ""))
                    if not addr:
                        self._json({"text": "no available worker", "error_code": 2},
                                   code=503)
                        return
                    self._proxy_stream(
                        addr + "/worker_generate_stream", data,
                        "application/octet-stream",
                    )
                elif self.path == "/v1/chat/completions":
                    # OpenAI gateway: one cluster endpoint, dispatched to a
                    # batch worker's /v1 surface (serve/openai_api.py).
                    model = data.get("model") or next(
                        iter(registry.list_models()), ""
                    )
                    addr = registry.get_worker_address(model)
                    if not addr:
                        self._json({"error": {
                            "message": f"no worker serves {model!r}",
                            "type": "server_error",
                        }}, code=503)
                        return
                    if data.get("stream"):
                        self._proxy_stream(
                            addr + "/v1/chat/completions", data,
                            "text/event-stream",
                        )
                        return
                    with open_post(addr + "/v1/chat/completions", data, 600) as r:
                        self._json(json.loads(r.read()), code=r.status)
                else:
                    self._json({"error": "unknown endpoint"}, code=404)

            def _proxy_stream(self, url, data, content_type):
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.end_headers()
                for piece in pieces(open_post(url, data, 600)):
                    self.wfile.write(piece)
                    self.wfile.flush()

            def do_GET(self):
                if self.path == "/v1/models":
                    registry.expire_stale()
                    self._json({
                        "object": "list",
                        "data": [
                            {"id": n, "object": "model",
                             "created": int(time.time()),
                             "owned_by": "radvlm_tpu"}
                            for n in registry.list_models()
                        ],
                    })
                else:
                    self._json({"error": "unknown endpoint"}, code=404)

        return Handler

    def serve_forever(self, *, background: bool = False):
        self._server = ThreadingHTTPServer((self.host, self.port), self.make_handler())
        self.port = self._server.server_address[1]
        self._hb_thread = threading.Thread(target=self._expire_loop, daemon=True)
        self._hb_thread.start()
        if background:
            t = threading.Thread(target=self._server.serve_forever, daemon=True)
            t.start()
            return t
        self._server.serve_forever()

    def shutdown(self):
        self._stop.set()
        if self._server:
            self._server.shutdown()
            self._server.server_close()


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=21001)
    parser.add_argument(
        "--dispatch-method", default="shortest_queue",
        choices=["lottery", "shortest_queue"],
    )
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    Controller(args.host, args.port, args.dispatch_method).serve_forever()


if __name__ == "__main__":
    main()
