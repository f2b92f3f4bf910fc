"""Chat templating for generation prompts, the counterpart of the rendering
half of `radvlm_tpu/data/chat.py` (the supervised-masking half is training
work and not ported yet). RadVLM prompts use the Qwen chatml template.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


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
