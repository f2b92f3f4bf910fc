"""Batch worker: concurrent HTTP requests share one continuous batcher
(counterpart of `radvlm_tpu/serve/batch_worker.py`).

Requests enqueue into one `ContinuousBatcher` driven by a single engine
thread. Same controller protocol as `serve/worker.py` (register, heartbeat,
`/worker_get_status`); `/worker_generate` returns one JSON result,
`/worker_generate_stream` streams \\0-framed cumulative-text chunks as the
engine emits tokens (bursts of <= steps_per_sync per chunk readback).

Not ported: fleets of engines and tensor-parallel engines (ROADMAP M12),
the OpenAI-compatible endpoints, and multi-turn KV reuse (ROADMAP M7) - a
request that names a `session_id` is served by a full prefill, as the JAX
worker's session-miss path serves it.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from radvlm_tpu_torch.generation.continuous import ContinuousBatcher, Request
from radvlm_tpu_torch.generation.engine import GenerationConfig, trim_at_stop_strings
from radvlm_tpu_torch.models import multimodal
from radvlm_tpu_torch.serve.worker import HEARTBEAT_INTERVAL, load_image_from_base64, post_json

log = logging.getLogger(__name__)

TIMEOUT_S = 600


class BatchWorker:
    def __init__(
        self,
        runner,  # eval.harness.VLMRunner (model + cfg + tokenizer)
        *,
        model_names,
        num_slots: int = 8,
        max_len: int = 8192,
        prompt_bucket: int = 4096,
        controller_address: Optional[str] = None,
        worker_address: str = "",
        kv_quant: bool = False,
        fleet: Optional[int] = None,
        **engine_kw,  # ContinuousBatcher options: prompt_buckets, steps_per_sync, ...
    ):
        if fleet:
            raise NotImplementedError("fleets of engines are not ported (ROADMAP M12)")
        self.runner = runner
        self.model_names = list(model_names)
        self.controller_address = controller_address
        self.worker_address = worker_address
        gen = GenerationConfig(
            max_new_tokens=runner.max_new_tokens,
            eos_token_ids=tuple(runner.tokenizer.eos_token_ids),
            pad_token_id=runner.tokenizer.pad_token_id,
        )
        self._events: Dict[int, threading.Event] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._server: Optional[ThreadingHTTPServer] = None
        engine_kw.setdefault("prompt_buckets", (prompt_bucket,))
        self.batcher = ContinuousBatcher(
            runner.model, runner.cfg, gen, num_slots=num_slots, max_len=max_len,
            attn_impl=runner.attn_impl, kv_quant=kv_quant, **engine_kw,
        )
        # Every fill and decode variant runs once before the first request.
        t0 = time.perf_counter()
        self.batcher.warmup()
        self.warmup_seconds = time.perf_counter() - t0
        self._engine_thread = threading.Thread(target=self._engine_loop, daemon=True)
        self._engine_thread.start()

    def _signal_done(self, req: Request) -> None:
        with self._lock:
            ev = self._events.get(req.uid)
        if ev:
            ev.set()

    def _engine_loop(self):
        """Drive the batcher until shutdown; signal request completion.

        The loop survives any exception: a crash here would kill the daemon
        thread and leave every later request hanging until its timeout. The
        requests in flight fail explicitly instead."""
        while not self._stop.is_set():
            progressed = False
            try:
                for req in self.batcher.run():
                    progressed = True
                    self._signal_done(req)
            except Exception as e:
                log.exception("batcher engine error; continuing")
                self.batcher.fail_all(f"engine error: {e}", on_each=self._signal_done)
            if not progressed:
                time.sleep(0.005)

    def queue_length(self) -> int:
        return self.batcher.queue.qsize() + len(self.batcher._active())

    def _submit(self, params_req: Dict[str, Any], *, stream: bool = False) -> Request:
        """Build the multimodal sample and enqueue it (raises ValueError for
        protocol errors, e.g. an over-long prompt)."""
        images = [load_image_from_base64(b) for b in params_req.get("images", [])]
        ids = multimodal.tokenize_with_images(self.runner.tokenizer.encode, params_req["prompt"])
        return self.batcher.submit(
            multimodal.build_sample(ids, images, self.runner.cfg),
            int(params_req.get("max_new_tokens", 256)),
            temperature=(float(params_req["temperature"])
                         if "temperature" in params_req else None),
            top_p=float(params_req["top_p"]) if "top_p" in params_req else None,
            stream=stream,
        )

    def _stops(self, params_req: Dict[str, Any]):
        return list(self.runner.template.stop_strings) + list(
            filter(None, [params_req.get("stop")])
        )

    def generate_stream(self, params_req: Dict[str, Any]):
        """Yield cumulative-text chunks as the engine emits tokens; each
        drained burst costs one decode of the text so far."""
        try:
            req = self._submit(params_req, stream=True)
        except (ValueError, KeyError, OSError) as e:  # bad prompt, image or field
            yield {"text": f"error: {e}", "error_code": 1}
            return
        tok = self.runner.tokenizer
        stops = self._stops(params_req)
        out_ids = []
        deadline = time.time() + TIMEOUT_S
        try:
            done = False
            while not done:
                try:
                    t = req.stream_q.get(timeout=1.0)
                except queue.Empty:
                    if time.time() >= deadline:
                        yield {"text": "timeout", "error_code": 4}
                        return
                    continue
                if t is None:
                    break
                burst = [t]
                while True:  # drain the rest of this readback burst
                    try:
                        t = req.stream_q.get_nowait()
                    except queue.Empty:
                        break
                    if t is None:
                        done = True
                        break
                    burst.append(t)
                out_ids.extend(burst)
                raw = tok.decode(out_ids)
                text = trim_at_stop_strings(raw, stops)
                yield {"text": text, "error_code": 0}
                if text != raw:  # a stop string fired mid-stream
                    return
            if req.error:
                yield {"text": f"error: {req.error}", "error_code": 1}
        finally:
            # Stop string, timeout or a client that hung up: the engine frees
            # the slot instead of decoding for nobody.
            if not req.done:
                req.cancelled = True

    def generate(self, params_req: Dict[str, Any]) -> Dict[str, Any]:
        ev = threading.Event()
        try:
            req = self._submit(params_req)
        except (ValueError, KeyError, OSError) as e:  # bad prompt, image or field
            return {"text": f"error: {e}", "error_code": 1}
        with self._lock:
            self._events[req.uid] = ev
        # The engine may finish the request before the event is registered:
        # wait in short intervals and trust req.done as well.
        deadline = time.time() + TIMEOUT_S
        ok = False
        while time.time() < deadline:
            if ev.wait(timeout=1.0) or req.done:
                ok = True
                break
        with self._lock:
            self._events.pop(req.uid, None)
        if req.error:
            return {"text": f"error: {req.error}", "error_code": 1}
        if not ok:
            return {"text": "timeout", "error_code": 4}
        text = trim_at_stop_strings(
            self.runner.tokenizer.decode(req.emitted), self._stops(params_req)
        )
        return {"text": text, "error_code": 0}

    # --- HTTP (same registry protocol as serve/worker.py) ---

    def make_handler(worker):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

            def _read(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path == "/worker_get_status":
                    self._json({
                        "model_names": worker.model_names,
                        "speed": 2.0,
                        "queue_length": worker.queue_length(),
                    })
                    return
                if self.path not in ("/worker_generate", "/worker_generate_stream"):
                    self._json({"error": "unknown endpoint"}, code=404)
                    return
                try:
                    data = self._read()
                except (ValueError, UnicodeDecodeError):
                    self._json({"text": "malformed JSON body", "error_code": 1}, code=400)
                    return
                if self.path == "/worker_generate":
                    self._json(worker.generate(data))
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                # A client disconnect closes the generator, whose finally
                # cancels the request and frees its decode slot.
                chunks = worker.generate_stream(data)
                try:
                    for chunk in chunks:
                        self.wfile.write(json.dumps(chunk).encode() + b"\0")
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    log.info("stream client disconnected")
                finally:
                    chunks.close()

        return Handler

    def serve_forever(self, host: str = "0.0.0.0", port: int = 21003, *, background: bool = False):
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

    def register(self):
        post_json(self.controller_address + "/register_worker", {
            "worker_name": self.worker_address,
            "model_names": self.model_names,
            "speed": 2.0,  # the batch worker advertises a higher speed
            "queue_length": self.queue_length(),
        }, timeout=30)

    def heartbeat_loop(self):
        while not self._stop.wait(HEARTBEAT_INTERVAL):
            try:
                r = post_json(self.controller_address + "/receive_heart_beat", {
                    "worker_name": self.worker_address,
                    "queue_length": self.queue_length(),
                }, timeout=10)
                if not r.get("exist"):
                    self.register()
            except Exception as e:  # the controller may be restarting
                log.warning("heartbeat failed: %s", e)

    def shutdown(self):
        """Stop serving and the engine thread (it finishes its current run)."""
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        self._engine_thread.join(timeout=TIMEOUT_S)
