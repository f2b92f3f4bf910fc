"""OpenAI-compatible chat API over the continuous batch worker (counterpart
of `radvlm_tpu/serve/openai_api.py`).

`POST /v1/chat/completions` (and `GET` / `POST /v1/models`) on `BatchWorker`'s
HTTP server. Messages map onto the model's chat template; image parts
(`image_url` with data: URIs) become `<image>` sentinels in conversation
order; `stream=true` emits SSE deltas computed from the engine's
cumulative-text chunks. A body may name a `session_id` (or OpenAI's `user`,
from which one is derived) to reuse the conversation's KV across turns.

The converters here are pure (testable without a model); the HTTP glue is in
`serve/batch_worker.py`.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Iterator, List, Tuple

from radvlm_tpu_torch.data.chat import QWEN_CHATML, ChatTemplate


def _content_to_text_and_images(content: Any) -> Tuple[str, List[str]]:
    """An OpenAI message `content` (str or list of typed parts) ->
    (text with <image> markers in part order, [base64 payloads])."""
    if isinstance(content, str):
        return content, []
    texts: List[str] = []
    images: List[str] = []
    for part in content or []:
        kind = part.get("type")
        if kind == "text":
            texts.append(part.get("text", ""))
        elif kind == "image_url":
            url = (part.get("image_url") or {}).get("url", "")
            if not url.startswith("data:"):
                raise ValueError(
                    "only data: image URLs are supported (no egress); got "
                    f"{url[:32]!r}"
                )
            try:
                b64 = url.split(",", 1)[1]
            except IndexError:
                raise ValueError("malformed data: URL (missing comma)")
            images.append(b64)
            texts.append("<image>")
        else:
            raise ValueError(f"unsupported content part type {kind!r}")
    return "\n".join(texts), images


def messages_to_request(
    body: Dict[str, Any], template: ChatTemplate = QWEN_CHATML
) -> Dict[str, Any]:
    """OpenAI chat body -> the worker's generate() params_req dict."""
    turns: List[Tuple[str, str]] = []
    system = None
    images: List[str] = []
    for m in body.get("messages", []):
        role = m.get("role")
        text, imgs = _content_to_text_and_images(m.get("content"))
        images.extend(imgs)
        if role == "system":
            system = text
        elif role in ("user", "assistant"):
            turns.append((role, text))
        else:
            raise ValueError(f"unsupported role {role!r}")
    if not turns or turns[-1][0] != "user":
        raise ValueError("last message must be from the user")
    prompt = template.render(turns, system=system, add_generation_prompt=True)
    req: Dict[str, Any] = {
        "prompt": prompt,
        "images": images,
        "max_new_tokens": int(
            body.get("max_tokens") or body.get("max_completion_tokens") or 256
        ),
    }
    if "temperature" in body:
        req["temperature"] = float(body["temperature"])
    if "top_p" in body:
        req["top_p"] = float(body["top_p"])
    stop = body.get("stop")
    if isinstance(stop, str):
        req["stop"] = stop
    elif isinstance(stop, list) and stop:
        req["stop"] = stop[0]  # worker protocol carries one extra stop string
    # Multi-turn KV reuse key (serve/sessions.py): OpenAI's `user` is a
    # per-end-user id, not a per-conversation one, so key on
    # (user, first user message) — a growing message list keeps its first
    # message stable while two interleaved chats under one user get distinct
    # keys instead of evicting each other. Reuse is a best-effort cache: like
    # any shared-prefix KV cache, a hit is observable as lower first-token
    # latency, and the prefix match requires knowing the exact conversation
    # (ids + image hashes); set RADVLM_SESSION_CAP=0 to disable entirely.
    if body.get("session_id"):  # the worker protocol's own field, passed through
        req["session_id"] = str(body["session_id"])
    elif body.get("user"):
        import hashlib

        first_user = next(
            (t for r, t in turns if r == "user"), ""
        )
        h = hashlib.sha256(
            str(body["user"]).encode() + b"\x00" + first_user.encode()
        ).hexdigest()[:32]
        req["session_id"] = f"oai-{h}"
    return req


def completion_json(model: str, result: Dict[str, Any], req_id: str,
                    created: int) -> Dict[str, Any]:
    ok = result.get("error_code", 0) == 0
    return {
        "id": req_id,
        "object": "chat.completion",
        "created": created,
        "model": model,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant",
                        "content": result.get("text", "")},
            "finish_reason": "stop" if ok else "error",
        }],
    }


def sse_stream(model: str, chunks: Iterator[Dict[str, Any]], req_id: str,
               created: int) -> Iterator[bytes]:
    """Cumulative-text worker chunks -> OpenAI SSE delta frames."""

    def frame(delta: Dict[str, Any], finish=None) -> bytes:
        return ("data: " + json.dumps({
            "id": req_id,
            "object": "chat.completion.chunk",
            "created": created,
            "model": model,
            "choices": [{
                "index": 0, "delta": delta, "finish_reason": finish,
            }],
        }) + "\n\n").encode()

    yield frame({"role": "assistant"})
    prev = ""
    error = False
    for chunk in chunks:
        text = chunk.get("text", "")
        if chunk.get("error_code", 0) != 0:
            error = True
            yield frame({"content": f"\n[error: {text}]"})
            break
        if text.startswith(prev):
            delta = text[len(prev):]
        else:  # stop-string trim shortened the text: emit nothing further
            delta = ""
        prev = text
        if delta:
            yield frame({"content": delta})
    yield frame({}, finish="error" if error else "stop")
    yield b"data: [DONE]\n\n"


def models_json(model_names: List[str], created: int) -> Dict[str, Any]:
    return {
        "object": "list",
        "data": [
            {"id": n, "object": "model", "created": created,
             "owned_by": "radvlm_tpu"}
            for n in model_names
        ],
    }


def new_request_id() -> str:
    import uuid

    return "chatcmpl-" + uuid.uuid4().hex[:24]


def now() -> int:
    return int(time.time())
