"""The port's web UI and controller against the JAX package's (mirrors the
five stack tests of tests/test_web.py): every scenario runs over real HTTP
through three stacks in front of the same canned worker - the port's
`Controller` + `WebApp`, the JAX package's, and the JAX `WebApp` over the
port's `Controller` (the protocol is the same) - and the three must give
the same bytes to the browser, the same requests to the worker (prompt,
images, session_id, sampling fields) and the same log records but for
their timestamps. Session ids (uuid4) are read as their order of creation.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from radvlm_tpu.serve import controller as jctl
from radvlm_tpu.serve import web as jweb
from radvlm_tpu_torch.serve import controller as tctl
from radvlm_tpu_torch.serve import web as tweb

TIMEOUT = 30
STACKS = {
    "port": (tctl.Controller, tweb),
    "jax": (jctl.Controller, jweb),
    "jax_web_port_controller": (tctl.Controller, jweb),
}


class CannedWorker:
    """Streams two cumulative chunks ("Hel", "Hello") for any prompt and
    records the requests it saw."""

    def __init__(self):
        self.seen = []
        self.error_mode = False  # stream an error chunk instead of text

        worker = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                data = json.loads(self.rfile.read(n) or b"{}")
                worker.seen.append(data)
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                if worker.error_mode:
                    self.wfile.write(
                        json.dumps({"text": "error: boom",
                                    "error_code": 1}).encode() + b"\0"
                    )
                    self.wfile.flush()
                    return
                for text in ("Hel", "Hello"):
                    self.wfile.write(
                        json.dumps({"text": text, "error_code": 0}).encode()
                        + b"\0"
                    )
                    self.wfile.flush()

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever, daemon=True).start()


class Stack:
    """Canned worker -> controller -> web app of one package mix, with a
    transcript of every HTTP exchange a scenario makes."""

    def __init__(self, kind, tmp_path):
        controller_cls, web = STACKS[kind]
        self.worker = CannedWorker()
        self.controller = controller_cls(host="127.0.0.1", port=0)
        self.controller.serve_forever(background=True)
        self.caddr = f"http://127.0.0.1:{self.controller.port}"
        self.logdir = tmp_path / kind
        self.app = web.WebApp(self.caddr, log_dir=str(self.logdir))
        self.web = ThreadingHTTPServer(("127.0.0.1", 0), web.make_handler(self.app))
        threading.Thread(target=self.web.serve_forever, daemon=True).start()
        self.waddr = f"http://127.0.0.1:{self.web.server_address[1]}"
        self.sids = []
        self.transcript = []
        self.post(self.caddr + "/register_worker", {
            "worker_name": f"http://127.0.0.1:{self.worker.port}",
            "model_names": ["radvlm"],
        })
        self.transcript.clear()  # the worker's port differs between stacks

    def closers(self):
        """Shutdown calls, each of which waits for its server's poll."""
        def close(server):
            server.shutdown()
            server.server_close()

        return [lambda: close(self.web), lambda: close(self.worker.server),
                self.controller.shutdown]

    def post(self, url, body):
        """POST body -> (status, raw bytes); the exchange joins the transcript."""
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                status, raw = r.status, r.read()
        except urllib.error.HTTPError as e:
            status, raw = e.code, e.read()
        if url.endswith("/api/new"):
            self.sids.append(json.loads(raw)["session_id"])
        self.transcript.append((url.rsplit("/", 1)[1], self._norm(json.dumps(body)), status,
                                self._norm(raw.decode())))
        return status, raw

    def api(self, path, body):
        return self.post(self.waddr + path, body)

    def new(self):
        return json.loads(self.api("/api/new", {})[1])["session_id"]

    def chat(self, sid, text, images=(), **kw):
        body = {"session_id": sid, "model": "radvlm", "text": text,
                "images": list(images), "max_new_tokens": 8, **kw}
        status, raw = self.api("/api/chat", body)
        assert status == 200
        return [json.loads(m) for m in raw.split(b"\0") if m]

    def _norm(self, text):
        for i, sid in enumerate(self.sids):
            text = text.replace(sid, f"<sid{i}>")
        return text

    def records(self):
        logs = list(self.logdir.glob("*-conv.json"))
        assert len(logs) <= 1
        records = [json.loads(line) for log in logs for line in log.read_text().splitlines()]
        return [{k: v for k, v in r.items() if k not in ("tstamp", "start", "finish")}
                for r in records]

    def outcome(self):
        seen = [json.loads(self._norm(json.dumps(d))) for d in self.worker.seen]
        return {"transcript": self.transcript, "seen": seen, "records": self.records()}


def _run_all(tmp_path, scenario):
    """Run `scenario(stack)` on every stack; the outcomes must be equal.
    Returns the port stack's scenario result and its stack."""
    outcomes, stacks = {}, []
    try:
        for kind in STACKS:
            stacks.append(Stack(kind, tmp_path))
            result = scenario(stacks[-1])
            outcomes[kind] = stacks[-1].outcome()
            if kind == "port":
                port = (result, stacks[-1])
    finally:
        threads = [threading.Thread(target=f) for s in stacks for f in s.closers()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert outcomes["port"] == outcomes["jax"] == outcomes["jax_web_port_controller"]
    return port


def test_chat_session_state_and_log(tmp_path):
    def scenario(s):
        d = json.loads(s.api("/api/new", {})[1])
        sid = d["session_id"]
        assert d["models"] == ["radvlm"]
        chunks = s.chat(sid, "Describe the X-ray.", images=["aW1n"])
        assert chunks[-1]["text"] == "Hello"
        sess = s.app.sessions.get(sid)
        assert [r for r, _ in sess.turns] == ["user", "assistant"]
        assert sess.turns[-1][1] == "Hello"
        s.chat(sid, "Any pleural effusion?")

    _, s = _run_all(tmp_path, scenario)
    req, req2 = s.worker.seen
    assert req["prompt"].count("<image>") == 1
    assert req["prompt"].rstrip().endswith("<|im_start|>assistant")
    assert req["images"] == ["aW1n"]
    assert req["session_id"] == s.sids[0] and req["max_new_tokens"] == 8
    assert (req["temperature"], req["top_p"]) == (0.0, 1.0)
    assert "Describe the X-ray." in req2["prompt"] and "Hello" in req2["prompt"]
    records = s.records()
    assert [r["type"] for r in records] == ["chat", "chat"]
    rec = records[-1]
    assert rec["model"] == "radvlm"
    assert rec["state"]["messages"][-1] == ["assistant", "Hello"]
    assert len(rec["images"]) == 1 and len(rec["images"][0]) == 64  # sha256


def test_vote_and_regenerate(tmp_path):
    def scenario(s):
        sid = s.new()
        s.chat(sid, "hi")
        for vtype in ("upvote", "downvote", "flag"):
            assert s.api("/api/vote", {"session_id": sid, "type": vtype,
                                       "model": "radvlm"})[0] == 200
        assert s.api("/api/vote", {"session_id": sid, "type": "nope",
                                   "model": "radvlm"})[0] == 400
        n_seen = len(s.worker.seen)
        status, _ = s.api("/api/regenerate", {"session_id": sid, "model": "radvlm",
                                              "max_new_tokens": 8, "temperature": 0.7})
        assert status == 200 and len(s.worker.seen) == n_seen + 1
        assert [r for r, _ in s.app.sessions.get(sid).turns] == ["user", "assistant"]
        s.api("/api/clear", {"session_id": sid})
        assert s.api("/api/regenerate", {"session_id": sid})[0] == 400

    _, s = _run_all(tmp_path, scenario)
    assert s.worker.seen[-1]["temperature"] == 0.7
    types = [r["type"] for r in s.records()]
    assert types.count("upvote") == types.count("downvote") == 1
    assert types.count("flag") == 1 and types.count("chat") == 2


def test_multi_image_turn_and_limits(tmp_path):
    def scenario(s):
        sid = s.new()
        s.chat(sid, "Compare the two views.", images=["QQ==", "Qg=="])
        body = {"session_id": sid, "model": "radvlm", "text": "x", "images": ["QQ=="] * 9}
        assert s.api("/api/chat", body)[0] == 400
        assert len(s.app.sessions.get(sid).turns) == 2
        assert s.api("/api/chat", {"session_id": "nope", "text": "x"})[0] == 400
        assert s.api("/api/unknown", {"session_id": sid})[0] == 404

    _, s = _run_all(tmp_path, scenario)
    req = s.worker.seen[-1]
    assert req["prompt"].count("<image>") == 2
    assert req["images"] == ["QQ==", "Qg=="]


def test_refresh_all_workers_endpoint(tmp_path):
    def scenario(s):
        status, raw = s.post(s.caddr + "/refresh_all_workers", {})
        assert status == 200 and json.loads(raw)["ok"]
        assert s.app.list_models() == ["radvlm"]
        assert json.loads(s.api("/api/models", {})[1]) == {"models": ["radvlm"]}

    _run_all(tmp_path, scenario)
    # A controller that is not there: no models, no exception.
    assert tweb.WebApp("http://127.0.0.1:9").list_models() == []


def test_stream_error_rolls_back_session_state(tmp_path):
    """A worker stream error must not leave a dangling user turn (re-send
    would duplicate <image> sentinels) and must keep regenerate clickable."""

    def scenario(s):
        sid = s.new()
        s.chat(sid, "first", images=["QQ=="])
        sess = s.app.sessions.get(sid)
        assert [r for r, _ in sess.turns] == ["user", "assistant"]
        s.worker.error_mode = True
        chunks = s.chat(sid, "second", images=["Qg=="])
        assert chunks[-1]["error_code"] == 1
        assert [r for r, _ in sess.turns] == ["user", "assistant"]
        assert sess.images == ["QQ=="]
        s.worker.error_mode = False
        s.chat(sid, "second again", images=["Qg=="])
        assert [r for r, _ in sess.turns] == ["user", "assistant"] * 2
        req = s.worker.seen[-1]
        assert req["prompt"].count("<image>") == 2
        assert req["images"] == ["QQ==", "Qg=="]
        s.worker.error_mode = True
        s.api("/api/regenerate", {"session_id": sid, "model": "radvlm"})
        assert [r for r, _ in sess.turns] == ["user", "assistant"] * 2
        assert sess.turns[-1][1] == "Hello"

    _run_all(tmp_path, scenario)


def test_page_is_the_jax_page():
    assert tweb.PAGE == jweb.PAGE
    assert set(tweb.TEMPLATES) == set(jweb.TEMPLATES)
    with pytest.raises(ValueError):
        tweb.WebApp("http://127.0.0.1:9", template="nope")


@pytest.mark.parametrize("web", [tweb, jweb], ids=["port", "jax"])
def test_unreachable_controller_rolls_back(tmp_path, web):
    """A controller that refuses the connection is a stream error: the
    browser gets the 200 header and no chunk, and the user turn goes."""
    app = web.WebApp("http://127.0.0.1:9", log_dir=str(tmp_path))
    server = ThreadingHTTPServer(("127.0.0.1", 0), web.make_handler(app))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    addr = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        sid = app.new_session()["session_id"]
        req = urllib.request.Request(addr + "/api/chat", data=json.dumps(
            {"session_id": sid, "text": "hi", "images": ["QQ=="]}).encode())
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert (r.status, r.read()) == (200, b"")
        sess = app.sessions.get(sid)
        assert sess.turns == [] and sess.images == []
        assert not list(tmp_path.glob("*-conv.json"))
    finally:
        server.shutdown()
        server.server_close()
