"""The port's serving controller against the JAX package's (mirrors
tests/test_serving.py): the registry's dispatch picks and heartbeat expiry
equal the JAX `Registry`'s under the same calls and rng seed; over real
HTTP on the CPU, the port's `Controller` proxies a `ModelWorker` and a
`BatchWorker` (each registered through `controller_address`) with streamed
chunks whose text grows to the worker's own direct answer; the
`/v1/chat/completions` gateway, streamed and not, answers what the worker
answers, passes a worker's error status and body through byte for byte as
the JAX controller does, and `GET /v1/models` lists the model.
"""

import base64
import io
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from radvlm_tpu.serve import controller as jctl
from radvlm_tpu_torch.config import tiny_test_config
from radvlm_tpu_torch.eval.harness import VLMRunner
from radvlm_tpu_torch.models.convert import init_params, random_quantized_params
from radvlm_tpu_torch.serve import controller as tctl
from radvlm_tpu_torch.serve.batch_worker import BatchWorker
from radvlm_tpu_torch.serve.worker import ModelWorker

TIMEOUT = 60
PROMPT = "<|im_start|>user\n<image>\nDescribe.<|im_end|>\n<|im_start|>assistant\n"


class ByteTokenizer:
    eos_token_ids = (1,)
    pad_token_id = 0

    def encode(self, text):
        return [2 + b for b in text.encode()]

    def decode(self, ids):
        return bytes(min(255, i - 2) for i in ids if i >= 2).decode(errors="ignore")


def _dispatch(Registry):
    """Picks of both policies under one scripted sequence of calls."""
    picks = []
    r = Registry("shortest_queue")
    r.register("http://w1", ["m"], speed=1.0, queue_length=5)
    r.register("http://w2", ["m"], speed=1.0, queue_length=0)
    r.register("http://w3", ["m", "n"], speed=2.0, queue_length=4)
    picks += [r.get_worker_address("m") for _ in range(9)]
    r.heartbeat("http://w1", 0)
    picks += [r.get_worker_address("m") for _ in range(3)]
    picks += [r.get_worker_address("n"), r.get_worker_address("other"), r.list_models()]
    lot = Registry("lottery")
    lot.register("http://a", ["m"], speed=0.0)
    lot.register("http://b", ["m"], speed=3.0)
    lot.register("http://c", ["m"], speed=1.0)
    rng = np.random.default_rng(0)
    picks += [lot.get_worker_address("m", rng=rng) for _ in range(24)]
    zero = Registry("lottery")
    zero.register("http://z", ["m"], speed=0.0)
    picks.append(zero.get_worker_address("m", rng=rng))
    return picks


def test_registry_dispatch():
    picks = _dispatch(tctl.Registry)
    assert picks == _dispatch(jctl.Registry)
    assert picks[0] == "http://w2" and picks[14] == ["m", "n"] and picks[13] == ""
    assert "http://a" not in picks[15:39] and {"http://b", "http://c"} <= set(picks[15:39])
    assert picks[-1] == ""
    with pytest.raises(ValueError):
        tctl.Registry("round_robin")


def _expiry(Registry):
    r = Registry()
    r.register("http://w1", ["m"])
    r.register("http://w2", ["m", "n"])
    r.register("http://w3", ["n"])
    out = [r.heartbeat("http://w1", 3), r.heartbeat("http://nope", 0)]
    r.workers["http://w1"].last_heartbeat = 1000.0
    r.workers["http://w2"].last_heartbeat = 1080.0
    r.workers["http://w3"].last_heartbeat = 1005.0
    out += [r.expire_stale(now=1100.0), r.list_models(), r.workers["http://w2"].queue_length]
    out += [r.expire_stale(now=time.time() + 1000), r.list_models()]
    return out


def test_registry_heartbeat_expiry():
    out = _expiry(tctl.Registry)
    assert out == _expiry(jctl.Registry)
    assert out[:3] == [True, False, ["http://w1", "http://w3"]]
    assert out[-2:] == [["http://w2"], []]


def _http(url, body=None, raw=None):
    """POST (GET without a body) -> (status, raw bytes), error statuses included."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _chunks(raw):
    return [json.loads(m) for m in raw.split(b"\0") if m]


def _sse_text(raw):
    text = ""
    for line in raw.decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            text += json.loads(line[6:])["choices"][0]["delta"].get("content") or ""
    return text


@pytest.fixture(scope="module")
def stack():
    """The port's controller with a ModelWorker ("tiny") and a BatchWorker
    ("tiny-batch", int8 weights and cache) registered through
    `controller_address`, and a JAX controller with the BatchWorker too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = tiny_test_config(vocab_size=300)
    tok = ByteTokenizer()
    ctl = tctl.Controller(host="127.0.0.1", port=0)
    ctl.serve_forever(background=True)
    caddr = f"http://127.0.0.1:{ctl.port}"
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    mrunner = VLMRunner(model=model, cfg=cfg, tokenizer=tok, max_new_tokens=6, batch_size=1,
                        pad_to_multiple=64)
    mworker = ModelWorker(mrunner, model_names=["tiny"], controller_address=caddr)
    qmodel = random_quantized_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                                     dtype=torch.float32)
    brunner = VLMRunner(model=qmodel, cfg=cfg, tokenizer=tok, max_new_tokens=6,
                        pad_to_multiple=128)
    bworker = BatchWorker(brunner, model_names=["tiny-batch"], num_slots=2, max_len=256,
                          prompt_bucket=128, kv_quant=True, pad_tiles=2, steps_per_sync=2,
                          controller_address=caddr)
    mport = mworker.serve_forever(host="127.0.0.1", port=0, background=True)
    bport = bworker.serve_forever(host="127.0.0.1", port=0, background=True)
    jc = jctl.Controller(host="127.0.0.1", port=0)
    jc.serve_forever(background=True)
    jaddr = f"http://127.0.0.1:{jc.port}"
    _http(jaddr + "/register_worker", {"worker_name": bworker.worker_address,
                                       "model_names": ["tiny-batch"]})
    img = np.random.default_rng(3).integers(0, 255, (90, 70, 3), dtype=np.uint8)
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    try:
        yield dict(caddr=caddr, jaddr=jaddr, mworker=mworker, bworker=bworker,
                   maddr=f"http://127.0.0.1:{mport}", baddr=f"http://127.0.0.1:{bport}",
                   image=base64.b64encode(buf.getvalue()).decode())
    finally:
        for s in (mworker, bworker, ctl, jc):
            s.shutdown()
        torch.set_num_threads(threads)


def test_registration_and_models(stack):
    status, raw = _http(stack["caddr"] + "/list_models", {})
    assert status == 200 and json.loads(raw) == {"models": ["tiny", "tiny-batch"]}
    status, raw = _http(stack["caddr"] + "/get_worker_address", {"model": "tiny-batch"})
    assert json.loads(raw) == {"address": stack["bworker"].worker_address}
    status, raw = _http(stack["caddr"] + "/v1/models")
    models = json.loads(raw)
    assert status == 200 and models["object"] == "list"
    assert [(m["id"], m["object"], m["owned_by"]) for m in models["data"]] == [
        ("tiny", "model", "radvlm_tpu"), ("tiny-batch", "model", "radvlm_tpu")]
    assert _http(stack["caddr"] + "/nope", {})[0] == 404
    assert _http(stack["caddr"] + "/list_models", raw=b"{nope")[0] == 400
    status, raw = _http(stack["caddr"] + "/worker_generate_stream", {"model": "absent"})
    assert status == 503 and json.loads(raw)["error_code"] == 2


@pytest.mark.parametrize("model", ["tiny", "tiny-batch"])
def test_stream_round_trip(stack, model):
    payload = {"model": model, "prompt": PROMPT, "images": [stack["image"]],
               "max_new_tokens": 6}
    status, raw = _http(stack["caddr"] + "/worker_generate_stream", payload)
    assert status == 200
    chunks = _chunks(raw)
    assert chunks and all(c["error_code"] == 0 for c in chunks)
    for a, b in zip(chunks, chunks[1:]):  # cumulative text grows monotonically
        assert b["text"].startswith(a["text"])
    if model == "tiny":
        direct = list(stack["mworker"].generate_stream(payload))[-1]
    else:
        direct = stack["bworker"].generate(payload)
    assert direct["error_code"] == 0 and chunks[-1]["text"] == direct["text"]


def test_chat_completions_gateway(stack):
    body = {"model": "tiny-batch", "max_tokens": 6, "messages": [
        {"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": "data:image/png;base64," + stack["image"]}},
            {"type": "text", "text": "Describe."}]}]}
    status, raw = _http(stack["baddr"] + "/v1/chat/completions", body)
    assert status == 200
    want = json.loads(raw)["choices"][0]["message"]["content"]
    status, raw = _http(stack["caddr"] + "/v1/chat/completions", body)
    assert status == 200 and json.loads(raw)["choices"][0]["message"]["content"] == want
    # No model named: the first listed one, "tiny", whose ModelWorker has no
    # /v1 surface; its 404 passes through.
    status, raw = _http(stack["caddr"] + "/v1/chat/completions", {**body, "model": ""})
    assert (status, json.loads(raw)) == (404, {"error": "unknown endpoint"})
    status, raw = _http(stack["caddr"] + "/v1/chat/completions", {**body, "stream": True})
    assert status == 200 and _sse_text(raw) == want
    assert raw.rstrip().endswith(b"data: [DONE]")
    # A body the worker refuses: its status and body pass through, and a
    # proxied stream carries the same bytes as the JAX controller's.
    bad = {"model": "tiny-batch", "messages": [{"role": "robot", "content": "x"}]}
    direct = _http(stack["baddr"] + "/v1/chat/completions", bad)
    assert direct[0] == 400 and json.loads(direct[1])["error"]["type"] == "invalid_request_error"
    for addr in (stack["caddr"], stack["jaddr"]):
        assert _http(addr + "/v1/chat/completions", bad) == direct
    streamed = _http(stack["caddr"] + "/v1/chat/completions", {**bad, "stream": True})
    assert streamed == _http(stack["jaddr"] + "/v1/chat/completions", {**bad, "stream": True})
    assert streamed == (200, direct[1])
    malformed = _http(stack["caddr"] + "/worker_generate_stream",
                      {"model": "tiny-batch", "prompt": "x" * 400, "max_new_tokens": 2})
    assert malformed[0] == 200 and _chunks(malformed[1])[-1]["error_code"] == 1
    status, raw = _http(stack["caddr"] + "/v1/chat/completions", {**body, "model": "absent"})
    assert status == 503 and json.loads(raw)["error"]["type"] == "server_error"


def test_proxy_forwards_each_piece_as_it_arrives():
    """The proxy hands on the worker's first chunk while the worker still
    holds back its second: a proxy that read the body to its end would
    block here until the timeout."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    release = threading.Event()

    class Held(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.end_headers()
            for text in ("Hel", "Hello"):
                self.wfile.write(json.dumps({"text": text, "error_code": 0}).encode() + b"\0")
                self.wfile.flush()
                release.wait(TIMEOUT)

    worker = ThreadingHTTPServer(("127.0.0.1", 0), Held)
    threading.Thread(target=worker.serve_forever, daemon=True).start()
    ctl = tctl.Controller(host="127.0.0.1", port=0)
    ctl.serve_forever(background=True)
    caddr = f"http://127.0.0.1:{ctl.port}"
    try:
        _http(caddr + "/register_worker", {"worker_name": f"http://127.0.0.1:{worker.server_address[1]}",
                                           "model_names": ["m"]})
        resp = tctl.open_post(caddr + "/worker_generate_stream", {"model": "m"}, timeout=5)
        first = resp.read1(65536)
        assert _chunks(first) == [{"text": "Hel", "error_code": 0}]
        release.set()
        rest = b"".join(tctl.pieces(resp))
        assert _chunks(first + rest)[-1]["text"] == "Hello"
    finally:
        release.set()
        ctl.shutdown()
        worker.shutdown()
        worker.server_close()
