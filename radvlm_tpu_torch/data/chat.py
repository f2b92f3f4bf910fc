"""Chat templating and supervised-masking tokenization, the counterpart of
`radvlm_tpu/data/chat.py` for the Qwen chatml template RadVLM uses (the
other templates of the JAX package are not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from radvlm_tpu_torch.config import IGNORE_INDEX

TokenizeFn = Callable[[str], List[int]]


@dataclasses.dataclass(frozen=True)
class ChatTemplate:
    """Declarative chat template: how a (system, turns) conversation renders."""

    name: str
    system_fmt: str  # format with {system}
    user_fmt: str  # format with {content}
    assistant_fmt: str  # format with {content}
    assistant_prefix: str  # generation prompt (open assistant turn)
    stop_strings: Tuple[str, ...]
    default_system: str = ""

    def render(
        self,
        turns: Sequence[Tuple[str, str]],
        *,
        system: Optional[str] = None,
        add_generation_prompt: bool = False,
    ) -> str:
        """turns: [(role, content)] with role in {"user", "assistant"}."""
        out = []
        sys_txt = self.default_system if system is None else system
        if sys_txt:
            out.append(self.system_fmt.format(system=sys_txt))
        for role, content in turns:
            if role == "user":
                out.append(self.user_fmt.format(content=content))
            elif role == "assistant":
                out.append(self.assistant_fmt.format(content=content))
            else:
                raise ValueError(f"unknown role {role!r}")
        if add_generation_prompt:
            out.append(self.assistant_prefix)
        return "".join(out)


QWEN_CHATML = ChatTemplate(
    name="qwen_1_5",
    system_fmt="<|im_start|>system\n{system}<|im_end|>\n",
    user_fmt="<|im_start|>user\n{content}<|im_end|>\n",
    assistant_fmt="<|im_start|>assistant\n{content}<|im_end|>\n",
    assistant_prefix="<|im_start|>assistant\n",
    stop_strings=("<|im_end|>",),
    default_system="You are a helpful assistant.",
)


def render_generation_prompt(
    turns: Sequence[Tuple[str, str]],
    *,
    template: ChatTemplate = QWEN_CHATML,
    system: Optional[str] = None,
) -> str:
    """Inference-side prompt: history + open assistant turn."""
    return template.render(turns, system=system, add_generation_prompt=True)


def tokenize_chat_supervised(
    tokenize_fn: TokenizeFn,
    turns: Sequence[Tuple[str, str]],
    *,
    template: ChatTemplate = QWEN_CHATML,
    system: Optional[str] = None,
) -> Tuple[List[int], List[int]]:
    """Render and tokenize a training conversation with supervised masking.

    Returns (token_ids, labels): token_ids hold IMAGE_TOKEN_INDEX sentinels
    at <image> positions; labels equal token_ids on the assistant turns'
    content and terminator and IGNORE_INDEX elsewhere (system and user
    turns, the assistant role prefix, image sentinels). Each turn is
    rendered and tokenized on its own, which is exact for chatml: turn
    boundaries are literal token sequences."""
    from radvlm_tpu_torch.models.multimodal import tokenize_with_images

    ids: List[int] = []
    labels: List[int] = []

    def add(text: str, supervised: bool):
        chunk = tokenize_with_images(tokenize_fn, text)
        ids.extend(chunk)
        labels.extend(t if supervised and t >= 0 else IGNORE_INDEX for t in chunk)

    sys_txt = template.default_system if system is None else system
    if sys_txt:
        add(template.system_fmt.format(system=sys_txt), False)
    for role, content in turns:
        if role == "user":
            add(template.user_fmt.format(content=content), False)
        elif role == "assistant":
            fmt = template.assistant_fmt.format(content=content)
            if fmt.startswith(template.assistant_prefix):
                add(template.assistant_prefix, False)
                add(fmt[len(template.assistant_prefix):], True)
            else:
                add(fmt, True)
        else:
            raise ValueError(f"unknown role {role!r}")
    return ids, labels


def llava_turns(conversations: Sequence[Dict[str, str]]) -> List[Tuple[str, str]]:
    """LLaVA-json `conversations` cells ({"from": "human"|"gpt", "value": ...})
    -> (role, content) turns."""
    role_map = {"human": "user", "gpt": "assistant"}
    return [(role_map[c["from"]], c["value"]) for c in conversations]
