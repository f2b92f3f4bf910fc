"""Serving model worker: streams generations over HTTP (counterpart of
`radvlm_tpu/serve/worker.py`).

Same protocol as the JAX package's worker: register with the controller and
heartbeat with the queue length, `/worker_get_status`, and
`/worker_generate_stream` taking base64 images + a prompt and answering with
\\0-delimited JSON chunks of cumulative text, behind a concurrency semaphore.
The controller protocol speaks `urllib.request` (no `requests` needed).
"""

from __future__ import annotations

import base64
import io
import json
import logging
import threading
import time
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from radvlm_tpu_torch.eval.harness import batch_to_device
from radvlm_tpu_torch.generation.engine import (
    GenerationConfig,
    make_stream_fns,
    stream_generate,
    trim_at_stop_strings,
)
from radvlm_tpu_torch.models import multimodal

log = logging.getLogger(__name__)

HEARTBEAT_INTERVAL = 15  # seconds


def load_image_from_base64(data: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(data))).convert("RGB"))


def post_json(url: str, obj: Dict[str, Any], timeout: float) -> Dict[str, Any]:
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


class ModelWorker:
    def __init__(
        self,
        runner,  # eval.harness.VLMRunner (model + cfg + tokenizer)
        *,
        model_names: List[str],
        worker_address: str = "",
        controller_address: Optional[str] = None,
        limit_concurrency: int = 2,
    ):
        self.runner = runner
        self.model_names = model_names
        self.worker_id = str(uuid.uuid4())[:8]
        self.worker_address = worker_address
        self.controller_address = controller_address
        self.semaphore = threading.Semaphore(limit_concurrency)
        self.active = 0
        self._lock = threading.Lock()
        self._stream_fns = None
        self._stop = threading.Event()
        self._req_counter = 0
        self._server: Optional[ThreadingHTTPServer] = None

    # --- controller protocol ---

    def register(self):
        if not self.controller_address:
            return
        post_json(
            self.controller_address + "/register_worker",
            {
                "worker_name": self.worker_address,
                "model_names": self.model_names,
                "speed": 1.0,
                "queue_length": self.queue_length(),
            },
            timeout=30,
        )

    def queue_length(self) -> int:
        with self._lock:
            return self.active

    def heartbeat_loop(self):
        while not self._stop.wait(HEARTBEAT_INTERVAL):
            try:
                r = post_json(
                    self.controller_address + "/receive_heart_beat",
                    {"worker_name": self.worker_address, "queue_length": self.queue_length()},
                    timeout=10,
                )
                if not r.get("exist"):
                    self.register()
            except Exception as e:  # the controller may be restarting
                log.warning("heartbeat failed: %s", e)

    # --- generation ---

    def generate_stream(self, params_req: Dict[str, Any]):
        """Yield dicts with cumulative text (reference chunk contract)."""
        prompt = params_req["prompt"]
        images = [load_image_from_base64(b) for b in params_req.get("images", [])]
        gen = GenerationConfig(
            max_new_tokens=int(params_req.get("max_new_tokens", 256)),
            temperature=float(params_req.get("temperature", 0.0)),
            top_p=float(params_req.get("top_p", 1.0)),
            eos_token_ids=tuple(self.runner.tokenizer.eos_token_ids),
            pad_token_id=self.runner.tokenizer.pad_token_id,
        )
        stops = list(self.runner.template.stop_strings) + list(
            filter(None, [params_req.get("stop")])
        )
        tok = self.runner.tokenizer
        ids = multimodal.tokenize_with_images(tok.encode, prompt)
        sample = multimodal.build_sample(ids, images, self.runner.cfg)
        batch = multimodal.collate(
            [sample], pad_to_multiple=self.runner.pad_to_multiple, left_pad=True
        )
        batch = batch_to_device(batch, self.runner.device)

        with self._lock:
            if self._stream_fns is None:
                self._stream_fns = make_stream_fns(
                    self.runner.cfg, attn_impl=self.runner.attn_impl
                )
            self.active += 1
            # Per-request generator: concurrent requests at temperature > 0
            # must not share draws.
            self._req_counter += 1
            generator = torch.Generator(device=self.runner.device).manual_seed(
                self._req_counter
            )
        t0 = time.perf_counter()
        n_tok = 0
        try:
            out_ids: List[int] = []
            for tok_np in stream_generate(
                self.runner.model, self.runner.cfg, batch, gen,
                stream_fns=self._stream_fns,
                generator=generator,
            ):
                t = int(tok_np[0])
                n_tok += 1
                if t in gen.eos_token_ids:
                    break
                out_ids.append(t)
                raw = tok.decode(out_ids)
                text = trim_at_stop_strings(raw, stops)
                yield {"text": text, "error_code": 0}
                if text != raw:  # a stop string fired
                    break
            dt = time.perf_counter() - t0
            log.info("generated %d tokens in %.2fs (%.1f tok/s)",
                     n_tok, dt, n_tok / max(dt, 1e-9))
        finally:
            with self._lock:
                self.active -= 1

    # --- HTTP ---

    def make_handler(worker):
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
                if self.path == "/worker_get_status":
                    self._json({
                        "model_names": worker.model_names,
                        "speed": 1.0,
                        "queue_length": worker.queue_length(),
                    })
                elif self.path == "/worker_generate_stream":
                    try:
                        data = self._read()
                    except (ValueError, UnicodeDecodeError):
                        self._json({"text": "malformed JSON body", "error_code": 1}, code=400)
                        return
                    if not worker.semaphore.acquire(timeout=120):
                        self._json({"text": "server overloaded", "error_code": 3}, code=503)
                        return
                    try:
                        self.send_response(200)
                        self.send_header("Content-Type", "application/octet-stream")
                        self.end_headers()
                        for chunk in worker.generate_stream(data):
                            self.wfile.write(json.dumps(chunk).encode() + b"\0")
                            self.wfile.flush()
                    except Exception as e:  # report the failure in-stream
                        log.exception("generation failed")
                        try:
                            self.wfile.write(
                                json.dumps({"text": f"error: {e}", "error_code": 1}).encode()
                                + b"\0"
                            )
                        except OSError:
                            pass
                    finally:
                        worker.semaphore.release()
                else:
                    self._json({"error": "unknown endpoint"}, code=404)

        return Handler

    def serve_forever(self, host: str = "0.0.0.0", port: int = 21002, *, background: bool = False):
        server = ThreadingHTTPServer((host, port), self.make_handler())
        self._server = server
        port = server.server_address[1]
        if not self.worker_address:
            self.worker_address = f"http://localhost:{port}"
        if self.controller_address:
            self.register()
            threading.Thread(target=self.heartbeat_loop, daemon=True).start()
        if background:
            threading.Thread(target=server.serve_forever, daemon=True).start()
            return port
        server.serve_forever()

    def shutdown(self):
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
