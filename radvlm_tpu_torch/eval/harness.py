"""Batched VLM inference (counterpart of the `Tokenizer` and `VLMRunner` of
`radvlm_tpu/eval/harness.py`). The model may hold int8 weights (`QLinear`,
from the weight bridge or `convert.random_quantized_params`); serving wraps
the runner in `serve.worker.ModelWorker` or `serve.batch_worker.BatchWorker`.
The task registry, metrics and the continuous-engine evaluation path are not
ported yet (ROADMAP M8).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.data.chat import QWEN_CHATML, ChatTemplate, render_generation_prompt
from radvlm_tpu_torch.generation.engine import (
    GenerationConfig,
    make_generate_fn,
    trim_at_stop_strings,
)
from radvlm_tpu_torch.models import multimodal, radvlm


class Tokenizer:
    """Protocol: encode/decode + special ids (tests and the smoke run use a
    byte-level one; production wraps an HF tokenizer)."""

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    eos_token_ids: Tuple[int, ...] = ()
    pad_token_id: int = 0


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """collate() output -> tensors on `device` (tiles stay uint8)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@dataclasses.dataclass
class VLMRunner:
    """Bundles a RadVLM module + config + tokenizer and runs batched greedy
    (or sampled) generation over left-padded prompt buckets."""

    model: radvlm.RadVLM
    cfg: RadVLMConfig
    tokenizer: Tokenizer
    template: ChatTemplate = QWEN_CHATML
    max_new_tokens: int = 512
    batch_size: int = 8
    pad_to_multiple: int = 512
    attn_impl: str = "auto"
    fuse: bool = True  # fuse qkv/gateup projections (radvlm.fuse_for_inference)

    def __post_init__(self):
        if self.fuse:
            radvlm.fuse_for_inference(self.model, self.cfg)
        self._gen_fns: Dict[Tuple[int, ...], Callable] = {}
        self.generator = torch.Generator(device=self.model.device).manual_seed(0)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _gen_fn(self, gen: GenerationConfig):
        if gen not in self._gen_fns:
            self._gen_fns[gen] = make_generate_fn(self.cfg, gen, attn_impl=self.attn_impl)
        return self._gen_fns[gen]

    def build_prompt(self, question: str, history: Sequence[Tuple[str, str]] = ()) -> str:
        turns = list(history) + [("user", question)]
        return render_generation_prompt(turns, template=self.template)

    def generate_batch(
        self,
        prompts: Sequence[str],
        images_per_prompt: Sequence[Sequence[np.ndarray]],
        *,
        max_new_tokens: Optional[int] = None,
        temperature: float = 0.0,
        top_p: float = 1.0,
    ) -> List[str]:
        """prompts contain <image> markers; returns decoded, stop-trimmed text."""
        gen = GenerationConfig(
            max_new_tokens=max_new_tokens or self.max_new_tokens,
            eos_token_ids=tuple(self.tokenizer.eos_token_ids),
            pad_token_id=self.tokenizer.pad_token_id,
            temperature=temperature,
            top_p=top_p,
        )
        samples = [
            multimodal.build_sample(
                multimodal.tokenize_with_images(self.tokenizer.encode, p), imgs, self.cfg
            )
            for p, imgs in zip(prompts, images_per_prompt)
        ]
        # Pad the batch up to batch_size with copies of the last sample, so
        # every call has the same shape.
        n_real = len(samples)
        while len(samples) < self.batch_size:
            samples.append(samples[-1])
        batch = multimodal.collate(samples, pad_to_multiple=self.pad_to_multiple, left_pad=True)
        out = self._gen_fn(gen)(self.model, batch_to_device(batch, self.device), self.generator)
        toks = out["tokens"].cpu().numpy()
        nums = out["num_tokens"].cpu().numpy()
        texts = []
        for i in range(n_real):
            ids = [int(t) for t in toks[i, : nums[i]] if t not in gen.eos_token_ids]
            text = self.tokenizer.decode(ids)
            texts.append(trim_at_stop_strings(text, self.template.stop_strings))
        return texts
