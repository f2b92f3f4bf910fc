"""Terminal chat client (counterpart of `radvlm_tpu/serve/cli.py`; rebuild of
`finetuning/llava/serve/cli.py`).

Streams tokens from a worker (directly or via the controller proxy) and keeps
multi-turn chat history with the qwen chatml template. `stream_request`
speaks `urllib.request` (`serve/controller.py`'s `open_post` and `pieces`)
in place of `requests`.

    python -m radvlm_tpu_torch.serve.cli --worker-address http://localhost:21001 --image cxr.png
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
from typing import List, Tuple

from radvlm_tpu_torch.data.chat import QWEN_CHATML, render_generation_prompt
from radvlm_tpu_torch.serve.controller import open_post, pieces


def encode_image(path: str) -> str:
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


def stream_request(addr: str, payload: dict):
    buf = b""
    for chunk in pieces(open_post(addr + "/worker_generate_stream", payload, 600)):
        buf += chunk
        while b"\0" in buf:
            msg, buf = buf.split(b"\0", 1)
            if msg:
                yield json.loads(msg)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker-address", default="http://localhost:21002")
    parser.add_argument("--model", default="radvlm")
    parser.add_argument("--image", default=None, help="path to a CXR image")
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--temperature", type=float, default=0.0)
    args = parser.parse_args()

    history: List[Tuple[str, str]] = []
    images = [encode_image(args.image)] if args.image else []
    first = True
    print("radvlm chat — empty line to exit")
    while True:
        try:
            user = input("user: ").strip()
        except EOFError:
            break
        if not user:
            break
        content = ("<image>\n" + user) if (first and images) else user
        first = False
        history.append(("user", content))
        prompt = render_generation_prompt(history, template=QWEN_CHATML)
        payload = {
            "model": args.model,
            "prompt": prompt,
            "images": images,
            "max_new_tokens": args.max_new_tokens,
            "temperature": args.temperature,
        }
        text = ""
        print("assistant: ", end="", flush=True)
        for chunk in stream_request(args.worker_address, payload):
            if chunk.get("error_code"):
                print(f"[error: {chunk.get('text')}]")
                break
            new = chunk["text"]
            sys.stdout.write(new[len(text):])
            sys.stdout.flush()
            text = new
        print()
        history.append(("assistant", text))


if __name__ == "__main__":
    main()
