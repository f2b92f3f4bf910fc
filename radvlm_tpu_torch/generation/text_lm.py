"""Text-only LM serving on the port's continuous engine (counterpart of
`radvlm_tpu/generation/text_lm.py`).

Loads an HF decoder checkpoint of the family `hf_import.config_from_hf_dir`
reads (qwen2 / llama / mistral / gemma) and batches prompts through the
slot-refilled `ContinuousBatcher`. This powers the GREEN judge
(`eval/green_cli.py --judge torch`) and the local synthesis and judge client
(`data/llm_clients.LocalTorchClient`).

The engine is VLM-shaped, so a tiny random vision tower and projector
(`tiny_test_config`'s) ride along. Text-only prompts carry no `<image>`
sentinel: a fill pads one tile, nothing of the tower is spliced, and the
generations are the LM's alone (the tokens do not depend on the tower's
weights; greedy parity with HF `generate` and with the JAX engine is
tested).

One dispatch thread owns `batcher.run()`; callers on any thread only submit
(their request is collated and sent to the device on the caller's thread,
as `serve/batch_worker.py` does) and wait on `req.done`. An engine error
fails every request in flight and the loop carries on; `generate_batch`
then raises.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Sequence

import torch

from radvlm_tpu_torch import config as cfglib
from radvlm_tpu_torch.data.chat import ChatTemplate, render_generation_prompt
from radvlm_tpu_torch.device import resolve
from radvlm_tpu_torch.generation.continuous import ContinuousBatcher
from radvlm_tpu_torch.generation.engine import GenerationConfig, trim_at_stop_strings
from radvlm_tpu_torch.models import convert, multimodal, radvlm
from radvlm_tpu_torch.models.hf_import import (
    config_from_hf_dir,
    import_qwen2,
    load_safetensors_dir,
    normalize_keys,
)
from radvlm_tpu_torch.ops.quant import quantize_model

log = logging.getLogger(__name__)

TIMEOUT_S = 600


class TextLMEngine:
    def __init__(
        self,
        model_path: str,
        *,
        max_new_tokens: int = 512,
        num_slots: int = 8,
        int8: bool = False,
        dtype: Optional[torch.dtype] = None,
        max_prompt_tokens: int = 3000,
        prompt_buckets: Sequence[int] = (1024, 2048, 3072),
        template: Optional[ChatTemplate] = None,  # wrap each prompt as one user turn
        device=None,  # None: the card
        tokenizer=None,  # None: AutoTokenizer from model_path
    ):
        """`tokenizer` is any object with the HF methods used here:
        `__call__(text, add_special_tokens=True).input_ids`, `decode(ids,
        skip_special_tokens=True)`, `eos_token_id`, `pad_token_id`,
        `unk_token_id` and `convert_tokens_to_ids`."""
        device = resolve(device)
        dtype = dtype or torch.bfloat16
        text_cfg = config_from_hf_dir(model_path).text
        tiny = cfglib.tiny_test_config()
        self.cfg = cfglib.RadVLMConfig(vision=tiny.vision, text=text_cfg, anyres=tiny.anyres)
        gen = torch.Generator(device=device).manual_seed(0)
        self.model = convert.init_params(self.cfg, gen, device=device, dtype=dtype)
        import_qwen2(normalize_keys(load_safetensors_dir(model_path)), self.model.text)
        if int8:
            quantize_model(self.model)
        radvlm.fuse_for_inference(self.model, self.cfg)

        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model_path)
        self.tokenizer = tokenizer
        self.template = template
        self.max_prompt_tokens = max_prompt_tokens
        eos = [tokenizer.eos_token_id]
        if template is not None:
            for s in template.stop_strings:
                tid = tokenizer.convert_tokens_to_ids(s)
                if tid is not None and tid != tokenizer.unk_token_id:
                    eos.append(tid)
        self.eos = tuple(i for i in dict.fromkeys(eos) if i is not None)
        gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens, eos_token_ids=self.eos,
            pad_token_id=tokenizer.pad_token_id or 0,
        )
        self.batcher = ContinuousBatcher(
            self.model, self.cfg, gen_cfg, num_slots=num_slots,
            max_len=max(prompt_buckets) + (-(-max_new_tokens // 128) * 128),
            prompt_buckets=tuple(prompt_buckets), pad_tiles=1,
        )
        self._start_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _ensure_loop(self) -> None:
        with self._start_lock:
            if self._thread is not None:
                return

            def loop():
                while not self._stop.is_set():
                    progressed = False
                    try:
                        for _req in self.batcher.run():
                            progressed = True
                    except Exception as e:
                        log.exception("text-lm engine error; failing in-flight requests")
                        self.batcher.fail_all(f"engine error: {e}")
                        time.sleep(0.25)
                    if not progressed:
                        time.sleep(0.002)

            self._thread = threading.Thread(target=loop, daemon=True, name="text-lm-engine")
            self._thread.start()

    def shutdown(self) -> None:
        """Stop the dispatch thread (requests still queued are not served)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)

    def _render(self, prompt: str) -> str:
        if self.template is None:
            return prompt
        return render_generation_prompt([("user", prompt)], template=self.template)

    def generate_batch(
        self, prompts: Sequence[str], *, temperature: Optional[float] = None,
        top_p: Optional[float] = None,
    ) -> List[str]:
        """All prompts in flight at once through the continuous batcher
        (thread-safe: any number of callers share the slots). Raises
        RuntimeError if the engine failed a request, TimeoutError after
        600 s."""
        self._ensure_loop()
        reqs = []
        for p in prompts:
            ids = self.tokenizer(
                self._render(p), add_special_tokens=True
            ).input_ids[: self.max_prompt_tokens]
            sample = multimodal.build_sample(ids, [], self.cfg)
            reqs.append(self.batcher.submit(sample, temperature=temperature, top_p=top_p))
        deadline = time.time() + TIMEOUT_S
        while not all(r.done for r in reqs):
            if time.time() >= deadline:
                raise TimeoutError("text-lm generation timed out")
            time.sleep(0.005)
        out = []
        for r in reqs:
            if r.error:
                raise RuntimeError(f"text-lm engine failed: {r.error}")
            text = self.tokenizer.decode(
                [t for t in r.emitted if t not in self.eos], skip_special_tokens=True,
            )
            if self.template is not None:
                text = trim_at_stop_strings(text, self.template.stop_strings)
            out.append(text)
        return out

    def generate(self, prompt: str, **kw) -> str:
        return self.generate_batch([prompt], **kw)[0]
