"""LLM clients for the synthetic-data and judge pipelines (counterpart of
`radvlm_tpu/data/llm_clients.py`).

The reference's Azure GPT-4o plumbing (`radvlm/data/utils.py:13-34` setup,
`:75-108` retry with exponential backoff) behind a minimal `LLMClient`
protocol, so every pipeline (report filtering, conversation synthesis, the
conversation judge, GREEN) takes any completer: the Azure client, a local
LM on the port's engine (`LocalTorchClient`), or a recorded fake in tests.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence

log = logging.getLogger(__name__)


class LLMClient:
    """Protocol: complete(prompt) -> text (or None on unrecoverable failure)."""

    def complete(self, prompt: str) -> Optional[str]:
        raise NotImplementedError


class AzureOpenAIClient(LLMClient):
    """Azure GPT-4o with retry/backoff (env: AZURE_OPENAI_API_KEY,
    AZURE_OPENAI_ENDPOINT, AZURE_OPENAI_API_VERSION)."""

    def __init__(self, model: str = "gpt-4o", *, max_retries: int = 20,
                 max_tokens: int = 2048, system: str = "You are a helpful assistant."):
        from openai import AzureOpenAI

        self.client = AzureOpenAI(
            api_key=os.environ["AZURE_OPENAI_API_KEY"],
            azure_endpoint=os.environ["AZURE_OPENAI_ENDPOINT"],
            api_version=os.environ.get("AZURE_OPENAI_API_VERSION", "2024-02-01"),
        )
        self.model = model
        self.max_retries = max_retries
        self.max_tokens = max_tokens
        self.system = system

    def complete(self, prompt: str) -> Optional[str]:
        for attempt in range(self.max_retries):
            try:
                r = self.client.chat.completions.create(
                    model=self.model,
                    messages=[
                        {"role": "system", "content": self.system},
                        {"role": "user", "content": prompt},
                    ],
                    max_tokens=self.max_tokens,
                )
                text = r.choices[0].message.content
                if text is None:
                    log.warning("null completion; not retrying")
                    return None
                return text.strip()
            except Exception as e:
                log.warning("attempt %d/%d failed: %s", attempt + 1,
                            self.max_retries, e)
                if attempt < self.max_retries - 1:
                    time.sleep(min(2 ** attempt, 60))
        return None


class LocalTorchClient(LLMClient):
    """A local instruct LM on the port's continuous engine
    (`generation/text_lm.py`) as the pipeline LLM: any HF decoder checkpoint
    of the qwen2 / llama / mistral / gemma family, int8-quantizable, with
    `complete_batch` keeping every decode slot busy. `device` (None: the
    card) and `tokenizer` (None: the checkpoint's HF tokenizer) go through
    to the engine."""

    def __init__(self, model_path: str, *, template: str = "qwen_1_5",
                 max_tokens: int = 2048, num_slots: int = 8,
                 int8: bool = False, temperature: float = 0.0,
                 device=None, tokenizer=None):
        from radvlm_tpu_torch.data.chat import TEMPLATES
        from radvlm_tpu_torch.generation.text_lm import TextLMEngine

        self.temperature = temperature
        self.engine = TextLMEngine(
            model_path, max_new_tokens=max_tokens, num_slots=num_slots,
            int8=int8, template=TEMPLATES[template], device=device,
            tokenizer=tokenizer,
        )

    def complete(self, prompt: str) -> Optional[str]:
        return self.engine.generate(
            prompt, temperature=self.temperature or None
        )

    def complete_batch(self, prompts: Sequence[str]) -> List[str]:
        return self.engine.generate_batch(
            prompts, temperature=self.temperature or None
        )

    def shutdown(self) -> None:
        self.engine.shutdown()


class FakeLLMClient(LLMClient):
    """Deterministic test double: canned responses by substring match, a fixed
    default, and a call log. Optionally fails the first `fail_first` calls to
    exercise retry/skip paths."""

    def __init__(self, responses: Optional[Dict[str, str]] = None,
                 default: str = "", fail_first: int = 0):
        self.responses = dict(responses or {})
        self.default = default
        self.fail_first = fail_first
        self.calls: List[str] = []

    def complete(self, prompt: str) -> Optional[str]:
        self.calls.append(prompt)
        if self.fail_first > 0:
            self.fail_first -= 1
            return None
        for key, resp in self.responses.items():
            if key in prompt:
                return resp
        return self.default


def extract_json_array(text: Optional[str]):
    """First [...] JSON array in `text`, or None
    (reference `llm_generate_conversations.py:61-68`)."""
    if not text:
        return None
    try:
        start = text.index("[")
        end = text.rindex("]") + 1
        return json.loads(text[start:end])
    except (ValueError, json.JSONDecodeError):
        return None
