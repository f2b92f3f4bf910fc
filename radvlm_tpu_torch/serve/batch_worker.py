"""Batch worker: concurrent HTTP requests share one continuous batcher
(counterpart of `radvlm_tpu/serve/batch_worker.py`).

Requests enqueue into one `ContinuousBatcher` driven by a single engine
thread. Same controller protocol as `serve/worker.py` (register, heartbeat,
`/worker_get_status`); `/worker_generate` returns one JSON result,
`/worker_generate_stream` streams \\0-framed cumulative-text chunks as the
engine emits tokens (bursts of <= steps_per_sync per chunk readback);
`/v1/models` and `/v1/chat/completions` (plain and SSE) speak the OpenAI
chat protocol (`serve/openai_api.py`).

A request that names a `session_id` takes part in multi-turn KV reuse
(`serve/sessions.py`): its finished KV stays on the device, and a later turn
whose prompt extends the stored conversation prefills only the new tokens.
The engine decodes speculatively when `spec_k` (or RADVLM_SPEC_K) is set.

Not ported: fleets of engines and tensor-parallel engines (ROADMAP M12).
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
from radvlm_tpu_torch.serve import openai_api as oai
from radvlm_tpu_torch.serve.sessions import Session, SessionStore, image_hash, split_delta
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
        kv_quant: Optional[bool] = None,  # None -> RADVLM_KV_INT8 (the batcher reads it)
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
        # Multi-turn KV reuse: RADVLM_SESSION_CAP=0 turns it off.
        store = SessionStore()
        self._sessions: Optional[SessionStore] = store if store.cap > 0 else None
        self._session_ctx: Dict[int, Any] = {}  # uid -> (sid, ids, image hashes, stops)
        engine_kw.setdefault("prompt_buckets", (prompt_bucket,))
        self.batcher = ContinuousBatcher(
            runner.model, runner.cfg, gen, num_slots=num_slots, max_len=max_len,
            attn_impl=runner.attn_impl, kv_quant=kv_quant, **engine_kw,
        )
        # Every fill and decode variant runs once before the first request.
        t0 = time.perf_counter()
        self.batcher.warmup()
        if self._sessions is not None:
            self._warmup_sessions()
        self.warmup_seconds = time.perf_counter() - t0
        self._engine_thread = threading.Thread(target=self._engine_loop, daemon=True)
        self._engine_thread.start()

    def _warmup_sessions(self) -> None:
        """A two-turn dummy conversation through the engine before its loop
        starts, so the first resumed turn of a live chat pays no first-call
        cost (snapshot copies, the delta fill's allocations)."""
        b = self.batcher
        r1 = b.submit(multimodal.build_sample(list(range(2, 8)), [], self.runner.cfg),
                      max_new_tokens=1, keep_kv=True)
        for _ in b.run():
            pass
        snap = r1.kv_snapshot
        if snap is not None and snap.widx + 128 <= b.max_len:
            b.submit(multimodal.build_sample(list(range(2, 6)), [], self.runner.cfg),
                     max_new_tokens=1, resume=snap)
            for _ in b.run():
                pass
        b.resume_fills = 0  # counts live resumes, not the warmup's

    def _finalize_session(self, req: Request) -> None:
        """Store the finished request's KVSnapshot under its session id (on
        the engine's completion path: the snapshot was cut at emission).

        The stored ids must be exactly what the CLIENT's next prompt will
        extend: only the emitted tokens the snapshot covers
        (`KVSnapshot.n_reply`), and only up to the stop-string trim applied
        to the returned text - the client never saw tokens past the stop,
        and storing them would make every later prefix match miss."""
        with self._lock:
            ctx = self._session_ctx.pop(req.uid, None)
        if ctx is None or req.error or req.kv_snapshot is None:
            return
        sid, ids, img_hashes, stops = ctx
        snap = req.kv_snapshot
        covered = snap.n_reply
        tok = self.runner.tokenizer
        raw = tok.decode(req.emitted)
        trimmed = trim_at_stop_strings(raw, stops)
        if trimmed != raw:
            t = None
            for i in range(len(req.emitted), -1, -1):
                d = tok.decode(req.emitted[:i])
                if d == trimmed:
                    t = i
                    break
                if len(d) < len(trimmed):
                    break  # decodes only shrink from here
            if t is None:
                return  # the stop cut inside a token: no clean boundary to store
            covered = min(covered, t)
        self._sessions.put(sid, Session(
            ids=list(ids) + list(req.emitted[:covered]),
            img_hashes=img_hashes,
            snapshot=snap.truncated(snap.n_reply - covered),
        ))

    def _signal_done(self, req: Request) -> None:
        self._finalize_session(req)
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
        protocol errors, e.g. an over-long prompt).

        With a "session_id": if the prompt exactly extends the stored
        conversation, only the delta tokens are prefilled (`resume=`), and
        the finished turn's KV is kept for the next one. Every miss is the
        plain full prefill."""
        images = [load_image_from_base64(b) for b in params_req.get("images", [])]
        ids = multimodal.tokenize_with_images(self.runner.tokenizer.encode, params_req["prompt"])
        cfg = self.runner.cfg
        kw = dict(
            max_new_tokens=int(params_req.get("max_new_tokens", 256)),
            temperature=(float(params_req["temperature"])
                         if "temperature" in params_req else None),
            top_p=float(params_req["top_p"]) if "top_p" in params_req else None,
            stream=stream,
        )
        sid = params_req.get("session_id")
        keep = bool(sid) and self._sessions is not None
        req = None
        if keep:
            img_hashes = [image_hash(im) for im in images]
            ent = self._sessions.get(sid)
            delta = split_delta(ent, ids, img_hashes) if ent else None
            if delta is not None:
                d_ids, k = delta
                try:
                    req = self.batcher.submit(multimodal.build_sample(d_ids, images[k:], cfg),
                                              keep_kv=True, resume=ent.snapshot, **kw)
                except ValueError as e:  # e.g. the delta does not fit the cache
                    log.warning("session %s: resume refused (%s); full prefill", sid, e)
                    req = None
        if req is None:
            req = self.batcher.submit(multimodal.build_sample(ids, images, cfg),
                                      keep_kv=keep, **kw)
        if keep:
            with self._lock:
                self._session_ctx[req.uid] = (sid, ids, img_hashes, self._stops(params_req))
            if req.done:
                # Completion raced the registration: finalize here (the pop
                # makes this idempotent with _signal_done).
                self._finalize_session(req)
        return req

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

            def do_GET(self):
                if self.path == "/v1/models":
                    self._json(oai.models_json(worker.model_names, oai.now()))
                else:
                    self._json({"error": "unknown endpoint"}, code=404)

            def _chat_completions(self):
                try:
                    data = self._read()
                    params_req = oai.messages_to_request(data, worker.runner.template)
                except (ValueError, UnicodeDecodeError, TypeError, AttributeError) as e:
                    self._json({"error": {"message": str(e),
                                          "type": "invalid_request_error"}}, code=400)
                    return
                model = data.get("model") or worker.model_names[0]
                if model not in worker.model_names:
                    self._json({"error": {"message": f"model {model!r} not found",
                                          "type": "invalid_request_error",
                                          "code": "model_not_found"}}, code=404)
                    return
                req_id, created = oai.new_request_id(), oai.now()
                if data.get("stream"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    chunks = worker.generate_stream(params_req)
                    try:
                        for frame in oai.sse_stream(model, chunks, req_id, created):
                            self.wfile.write(frame)
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        log.info("SSE client disconnected")
                    finally:
                        chunks.close()
                    return
                result = worker.generate(params_req)
                if result.get("error_code", 0) != 0:
                    self._json({"error": {"message": result.get("text", "generation failed"),
                                          "type": "server_error"}}, code=500)
                    return
                self._json(oai.completion_json(model, result, req_id, created))

            def do_POST(self):
                if self.path == "/v1/models":
                    self._json(oai.models_json(worker.model_names, oai.now()))
                    return
                if self.path == "/v1/chat/completions":
                    self._chat_completions()
                    return
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
