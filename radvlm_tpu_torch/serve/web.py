"""Browser chat UI (counterpart of `radvlm_tpu/serve/web.py`; rebuild of
`finetuning/llava/serve/gradio_web_server.py` and `gradio_multi_image.py`).

This image ships no gradio; the UI is a single static page served by the same
stdlib HTTP stack. Feature parity with the two gradio apps, restructured as a
thin page over server-side session state (which is what gradio's `state`
object is):

- server-side conversation state per session (`SessionStore`), rendered with
  the shared `data/chat.py` templates — the UI and the eval harness build
  byte-identical prompts;
- model selector backed by the controller's `/refresh_all_workers` +
  `/list_models` (`gradio_web_server.py:36-44`);
- multi-image turns (up to `MAX_IMAGES_PER_TURN`, the multi-image app's
  two-slot upload generalized; each image contributes one `<image>` sentinel);
- vote logging (upvote/downvote/flag) and per-chat records appended to a
  date-named JSONL — same record shape as `vote_last_response`
  (`gradio_web_server.py:77-87`) and the post-stream chat log (`:284-296`):
  `{tstamp, type, model, start, finish, state, images, ip}` with images
  logged as sha256 hashes, never raw bytes;
- regenerate (drop the last assistant turn and re-run, `:107-114`) and clear
  (`:117-120`);
- temperature / top_p / max-token controls passed through to the worker.

    python -m radvlm_tpu_torch.serve.web --controller http://localhost:21001 --port 7860

Differences from the JAX module: HTTP to the controller speaks
`urllib.request` (`serve/controller.py`'s `open_post` and `pieces`) in place
of `requests`; `list_models` answers [] on `URLError` / `OSError` /
`ValueError` where the JAX module catches `requests.RequestException`, and
a failed read of the controller's stream counts as a stream error as
there (a failed write to the browser is not caught, as there).
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import http.client
import json
import os
import threading
import time
import urllib.error
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from radvlm_tpu_torch.data.chat import TEMPLATES, render_generation_prompt
from radvlm_tpu_torch.serve.controller import open_post, pieces
from radvlm_tpu_torch.serve.worker import post_json

MAX_IMAGES_PER_TURN = 4
MAX_SESSIONS = 512


class Session:
    def __init__(self, template: str):
        self.turns: List[Tuple[str, str]] = []  # [(role, content)]
        self.images: List[str] = []  # b64 strings, conversation order
        self.template = template
        self.model: str = ""
        self.last_start: float = 0.0
        self.last_finish: float = 0.0
        self.lock = threading.Lock()

    def state_dict(self) -> dict:
        # The logged analog of gradio's Conversation.dict(): template + turns
        # (roles/messages), image placeholders already inline as <image>.
        return {
            "template_name": self.template,
            "messages": [[r, c] for r, c in self.turns],
            "offset": 0,
        }


class SessionStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._sessions: "Dict[str, Session]" = {}

    def new(self, template: str) -> str:
        sid = uuid.uuid4().hex
        with self._lock:
            if len(self._sessions) >= MAX_SESSIONS:
                # Drop oldest (insertion-ordered dict) — browser demo scale.
                self._sessions.pop(next(iter(self._sessions)))
            self._sessions[sid] = Session(template)
        return sid

    def get(self, sid: str) -> Optional[Session]:
        with self._lock:
            return self._sessions.get(sid)

    def drop(self, sid: str) -> None:
        with self._lock:
            self._sessions.pop(sid, None)


class ConvLogger:
    """Date-named JSONL conversation/vote log (`get_conv_log_filename`,
    `gradio_web_server.py:30-33`)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._lock = threading.Lock()

    def filename(self) -> str:
        t = datetime.datetime.now()
        return os.path.join(
            self.log_dir, f"{t.year}-{t.month:02d}-{t.day:02d}-conv.json"
        )

    def append(self, record: dict) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        with self._lock:
            with open(self.filename(), "a") as f:
                f.write(json.dumps(record) + "\n")


def _image_hashes(images: List[str]) -> List[str]:
    return [hashlib.sha256(b.encode()).hexdigest() for b in images]


PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>radvlm-tpu chat</title>
<style>
body { font-family: system-ui, sans-serif; max-width: 880px; margin: 2rem auto; }
#log { border: 1px solid #ccc; border-radius: 8px; padding: 1rem; min-height: 320px; }
.msg { margin: .5rem 0; white-space: pre-wrap; }
.user { color: #14532d; } .assistant { color: #1e3a8a; }
#controls, #row2 { display: flex; gap: .5rem; margin-top: .6rem; align-items: center; }
#q { flex: 1; padding: .5rem; }
img.preview { max-height: 140px; margin: .25rem; }
button.vote { font-size: .85rem; }
</style></head>
<body>
<h2>radvlm-tpu &mdash; chest X-ray assistant</h2>
<div id="row2">
  <label>model <select id="model"></select></label>
  <input type="file" id="img" accept="image/*" multiple>
  <span id="previews"></span>
</div>
<div id="log"></div>
<div id="controls">
  <input id="q" placeholder="Ask about the X-ray...">
  <button id="send">Send</button>
  <label>max tokens <input id="maxtok" type="number" value="512" style="width:5em"></label>
  <label>temp <input id="temp" type="number" step="0.1" value="0" style="width:4em"></label>
  <label>top_p <input id="topp" type="number" step="0.05" value="1" style="width:4em"></label>
</div>
<div id="row2">
  <button class="vote" id="up">&#128077; Upvote</button>
  <button class="vote" id="down">&#128078; Downvote</button>
  <button class="vote" id="flag">&#9888; Flag</button>
  <button id="regen">&#128260; Regenerate</button>
  <button id="clear">&#128465; Clear</button>
</div>
<script>
let sid = null, pendingImages = [];
async function init() {
  const r = await fetch('/api/new', {method: 'POST', body: '{}'});
  const d = await r.json();
  sid = d.session_id;
  const sel = document.getElementById('model');
  for (const m of d.models) {
    const o = document.createElement('option'); o.value = o.textContent = m;
    sel.appendChild(o);
  }
}
init();
document.getElementById('img').onchange = ev => {
  pendingImages = []; document.getElementById('previews').innerHTML = '';
  for (const f of ev.target.files) {
    const r = new FileReader();
    r.onload = () => {
      pendingImages.push(r.result.split(',')[1]);
      const im = document.createElement('img');
      im.className = 'preview'; im.src = r.result;
      document.getElementById('previews').appendChild(im);
    };
    r.readAsDataURL(f);
  }
};
function addMsg(cls, text) {
  const d = document.createElement('div');
  d.className = 'msg ' + cls;
  d.textContent = (cls === 'user' ? 'you: ' : 'radvlm: ') + text;
  document.getElementById('log').appendChild(d);
  return d;
}
function genParams() {
  return {
    session_id: sid,
    model: document.getElementById('model').value,
    max_new_tokens: +document.getElementById('maxtok').value,
    temperature: +document.getElementById('temp').value,
    top_p: +document.getElementById('topp').value,
  };
}
async function streamInto(resp, out) {
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let buf = '', text = '';
  for (;;) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream: true});
    let i;
    while ((i = buf.indexOf('\\0')) >= 0) {
      const chunk = buf.slice(0, i); buf = buf.slice(i + 1);
      if (!chunk) continue;
      const msg = JSON.parse(chunk);
      if (msg.error_code) { out.textContent += ` [error: ${msg.text}]`; return text; }
      text = msg.text;
      out.textContent = 'radvlm: ' + text;
    }
  }
  return text;
}
async function send() {
  const q = document.getElementById('q').value.trim();
  if (!q) return;
  document.getElementById('q').value = '';
  addMsg('user', q);
  const out = addMsg('assistant', '');
  const body = genParams();
  body.text = q; body.images = pendingImages;
  pendingImages = []; document.getElementById('previews').innerHTML = '';
  document.getElementById('img').value = '';
  const resp = await fetch('/api/chat', {method: 'POST',
    headers: {'Content-Type': 'application/json'}, body: JSON.stringify(body)});
  if (!resp.ok) { out.textContent += ' [error: ' + resp.status + ']'; return; }
  await streamInto(resp, out);
}
async function regen() {
  const msgs = document.querySelectorAll('.msg.assistant');
  if (!msgs.length) return;
  const out = msgs[msgs.length - 1];
  out.textContent = 'radvlm: ';
  const resp = await fetch('/api/regenerate', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(genParams())});
  if (!resp.ok) { out.textContent += ' [error: ' + resp.status + ']'; return; }
  await streamInto(resp, out);
}
async function vote(type) {
  await fetch('/api/vote', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({session_id: sid, type,
                          model: document.getElementById('model').value})});
}
async function clearChat() {
  await fetch('/api/clear', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({session_id: sid})});
  document.getElementById('log').innerHTML = '';
  const r = await fetch('/api/new', {method: 'POST', body: '{}'});
  sid = (await r.json()).session_id;
}
document.getElementById('send').onclick = send;
document.getElementById('regen').onclick = regen;
document.getElementById('up').onclick = () => vote('upvote');
document.getElementById('down').onclick = () => vote('downvote');
document.getElementById('flag').onclick = () => vote('flag');
document.getElementById('clear').onclick = clearChat;
document.getElementById('q').addEventListener('keydown', e => {
  if (e.key === 'Enter') send();
});
</script>
</body></html>
"""


class WebApp:
    """Session + logging + proxy logic, HTTP-free (unit-testable)."""

    def __init__(self, controller_address: str, *, log_dir: str = "logs/serve",
                 template: str = "qwen_1_5"):
        if template not in TEMPLATES:
            raise ValueError(f"unknown template {template!r}")
        self.controller = controller_address
        self.sessions = SessionStore()
        self.logger = ConvLogger(log_dir)
        self.template = template

    # -- controller-facing ---------------------------------------------------
    def list_models(self) -> List[str]:
        try:
            post_json(self.controller + "/refresh_all_workers", {}, timeout=10)
            r = post_json(self.controller + "/list_models", {}, timeout=10)
            return r.get("models", [])
        except (urllib.error.URLError, OSError, ValueError):
            return []

    # -- session ops ---------------------------------------------------------
    def new_session(self) -> dict:
        return {"session_id": self.sessions.new(self.template),
                "models": self.list_models()}

    def add_user_turn(self, sess: Session, text: str,
                      images: List[str]) -> Optional[str]:
        """Append a user turn; returns an error string or None."""
        if len(images) > MAX_IMAGES_PER_TURN:
            return f"at most {MAX_IMAGES_PER_TURN} images per turn"
        content = "".join("<image>\n" for _ in images) + text
        with sess.lock:
            sess.images.extend(images)
            sess.turns.append(("user", content))
        return None

    def build_request(self, sess: Session, data: dict) -> dict:
        with sess.lock:
            prompt = render_generation_prompt(
                sess.turns, template=TEMPLATES[sess.template]
            )
            images = list(sess.images)
        return {
            "model": data.get("model", ""),
            "prompt": prompt,
            "images": images,
            "max_new_tokens": int(data.get("max_new_tokens", 512)),
            "temperature": float(data.get("temperature", 0.0)),
            "top_p": float(data.get("top_p", 1.0)),
            # batch workers reuse the conversation's KV across turns when the
            # controller routes consecutive turns to the same worker
            # (serve/sessions.py); other workers ignore the field
            "session_id": data.get("session_id"),
        }

    def finish_turn(self, sess: Session, model: str, text: str, ip: str) -> None:
        with sess.lock:
            sess.turns.append(("assistant", text))
            sess.model = model
            sess.last_finish = time.time()
            record = {
                "tstamp": round(sess.last_finish, 4),
                "type": "chat",
                "model": model,
                "start": round(sess.last_start, 4),
                "finish": round(sess.last_finish, 4),
                "state": sess.state_dict(),
                "images": _image_hashes(sess.images),
                "ip": ip,
            }
        self.logger.append(record)

    def pop_assistant_turn(self, sess: Session) -> Optional[Tuple[str, str]]:
        """Regenerate prep: drop and return the trailing assistant turn
        (None if the session doesn't end in one)."""
        with sess.lock:
            if not sess.turns or sess.turns[-1][0] != "assistant":
                return None
            return sess.turns.pop()

    def rollback_turn(self, sess: Session, turn=None, n_images: int = 0):
        """Undo a failed generation so session state matches what the UI shows
        (an error bubble, no assistant reply): for /api/chat drop the dangling
        user turn + its images (a re-send then rebuilds a well-formed prompt
        instead of two consecutive user turns with duplicated <image>
        sentinels); for /api/regenerate restore the popped assistant turn so
        regenerate remains clickable."""
        with sess.lock:
            if turn is not None:
                sess.turns.append(turn)
            elif sess.turns and sess.turns[-1][0] == "user":
                sess.turns.pop()
                if n_images:
                    del sess.images[-n_images:]

    def vote(self, sess: Session, vote_type: str, model: str, ip: str) -> bool:
        if vote_type not in ("upvote", "downvote", "flag"):
            return False
        with sess.lock:
            record = {
                "tstamp": round(time.time(), 4),
                "type": vote_type,
                "model": model,
                "state": sess.state_dict(),
                "ip": ip,
            }
        self.logger.append(record)
        return True


def make_handler(app: WebApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream_generate(self, sess: Session, data: dict, on_error=None):
            """Proxy the worker stream, then record the finished turn; on a
            stream error call `on_error` to restore consistent session state."""
            req = app.build_request(sess, data)
            sess.last_start = time.time()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.end_headers()
            final_text, errored = "", False
            buf = b""
            stream = None
            while True:
                try:  # only the controller's side counts as a stream error
                    if stream is None:
                        stream = pieces(open_post(
                            app.controller + "/worker_generate_stream", req, 600))
                    chunk = next(stream)
                except StopIteration:
                    break
                except (OSError, http.client.HTTPException):
                    errored = True
                    break
                self.wfile.write(chunk)
                self.wfile.flush()
                buf += chunk
                while b"\0" in buf:
                    msg, buf = buf.split(b"\0", 1)
                    if not msg:
                        continue
                    try:
                        parsed = json.loads(msg)
                    except ValueError:
                        continue
                    if parsed.get("error_code"):
                        errored = True
                    else:
                        final_text = parsed.get("text", final_text)
            if not errored:
                app.finish_turn(sess, req["model"], final_text,
                                self.client_address[0])
            elif on_error is not None:
                on_error()

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                data = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, UnicodeDecodeError):
                self._json({"error": "malformed JSON body"}, code=400)
                return

            if self.path == "/api/new":
                self._json(app.new_session())
                return
            if self.path == "/api/models":
                self._json({"models": app.list_models()})
                return

            sess = app.sessions.get(data.get("session_id", ""))
            if sess is None:
                self._json({"error": "unknown session"}, code=400)
                return

            if self.path == "/api/chat":
                images = data.get("images", [])
                err = app.add_user_turn(sess, data.get("text", ""), images)
                if err:
                    self._json({"error": err}, code=400)
                    return
                self._stream_generate(
                    sess, data,
                    on_error=lambda: app.rollback_turn(
                        sess, n_images=len(images)
                    ),
                )
            elif self.path == "/api/regenerate":
                popped = app.pop_assistant_turn(sess)
                if popped is None:
                    self._json({"error": "nothing to regenerate"}, code=400)
                    return
                self._stream_generate(
                    sess, data,
                    on_error=lambda: app.rollback_turn(sess, turn=popped),
                )
            elif self.path == "/api/vote":
                ok = app.vote(sess, data.get("type", ""),
                              data.get("model", ""), self.client_address[0])
                self._json({"ok": ok}, code=200 if ok else 400)
            elif self.path == "/api/clear":
                app.sessions.drop(data.get("session_id", ""))
                self._json({"ok": True})
            else:
                self._json({"error": "unknown endpoint"}, code=404)

    return Handler


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller", default="http://localhost:21001")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--log-dir", default="logs/serve")
    parser.add_argument("--template", default="qwen_1_5",
                        choices=sorted(TEMPLATES))
    args = parser.parse_args()
    app = WebApp(args.controller, log_dir=args.log_dir, template=args.template)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(app))
    print(f"web ui on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
