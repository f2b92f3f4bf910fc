"""Chat templating and supervised-masking tokenization, the counterpart of
`radvlm_tpu/data/chat.py`: one declarative `ChatTemplate` for each
separator style of the reference's conversation templates (chatml / qwen,
plain, llama_3, vicuna v1, llama_2 and mistral_instruct with the system
prompt folded into the first user turn, gemma, mpt), and `TEMPLATES` with
the reference's aliases.
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
    # llama_2-style system handling (`conversation.py:142-162`): the system
    # prompt is not a separate turn but is wrapped and prepended to the FIRST
    # user message ("<<SYS>>\n{system}\n<</SYS>>\n\n"). When set, system_fmt
    # is never emitted.
    first_user_system_wrap: str = ""

    def _fold_system(
        self, turns: Sequence[Tuple[str, str]], system: Optional[str]
    ) -> Tuple[str, List[Tuple[str, str]]]:
        """Returns (system_prefix_text, turns) with llama_2-style folding."""
        sys_txt = self.default_system if system is None else system
        turns = list(turns)
        if self.first_user_system_wrap:
            if sys_txt:
                for i, (role, content) in enumerate(turns):
                    if role == "user":
                        turns[i] = (
                            role,
                            self.first_user_system_wrap.format(system=sys_txt)
                            + content,
                        )
                        break
            return "", turns
        if sys_txt:
            return self.system_fmt.format(system=sys_txt), turns
        return "", turns

    def render(
        self,
        turns: Sequence[Tuple[str, str]],
        *,
        system: Optional[str] = None,
        add_generation_prompt: bool = False,
    ) -> str:
        """turns: [(role, content)] with role in {"user", "assistant"}."""
        out = []
        sys_prefix, turns = self._fold_system(turns, system)
        if sys_prefix:
            out.append(sys_prefix)
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

PLAIN = ChatTemplate(
    name="plain",
    system_fmt="",
    user_fmt="{content}",
    assistant_fmt="{content}\n",
    assistant_prefix="",
    stop_strings=("\n",),
    default_system="",
)

LLAMA3 = ChatTemplate(
    name="llama_3",
    system_fmt="<|start_header_id|>system<|end_header_id|>\n\n{system}<|eot_id|>",
    user_fmt="<|start_header_id|>user<|end_header_id|>\n\n{content}<|eot_id|>",
    assistant_fmt=(
        "<|start_header_id|>assistant<|end_header_id|>\n\n{content}<|eot_id|>"
    ),
    assistant_prefix="<|start_header_id|>assistant<|end_header_id|>\n\n",
    stop_strings=("<|eot_id|>",),
    default_system="You are a helpful assistant.",
)

VICUNA_V1 = ChatTemplate(
    # SeparatorStyle.TWO (`conversation.py:74-83,345-354`): "{system} " then
    # "USER: {msg} " / "ASSISTANT: {msg}</s>"; the open assistant turn renders
    # as "ASSISTANT:" (role + ":" with no trailing space).
    name="v1",
    system_fmt="{system} ",
    user_fmt="USER: {content} ",
    assistant_fmt="ASSISTANT: {content}</s>",
    assistant_prefix="ASSISTANT:",
    stop_strings=("</s>",),
    default_system=(
        "A chat between a curious user and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite answers "
        "to the user's questions."
    ),
)

LLAMA2 = ChatTemplate(
    # SeparatorStyle.LLAMA_2 (`conversation.py:142-162,356-367`):
    # "<s>[INST] <<SYS>>\n{system}\n<</SYS>>\n\n{u0} [/INST] {a0} </s>"
    # "<s>[INST] {u1} [/INST] ..." — the generation prompt ends at "[/INST]".
    name="llama_2",
    system_fmt="",
    user_fmt="<s>[INST] {content} [/INST]",
    assistant_fmt=" {content} </s>",
    assistant_prefix="",
    stop_strings=("</s>",),
    default_system=(
        "You are a helpful, respectful and honest assistant. Always answer "
        "as helpfully as possible, while being safe.  Your answers should "
        "not include any harmful, unethical, racist, sexist, toxic, "
        "dangerous, or illegal content. Please ensure that your responses "
        "are socially unbiased and positive in nature.\n\nIf a question does "
        "not make any sense, or is not factually coherent, explain why "
        "instead of answering something not correct. If you don't know the "
        "answer to a question, please don't share false information."
    ),
    first_user_system_wrap="<<SYS>>\n{system}\n<</SYS>>\n\n",
)

MISTRAL_INSTRUCT = dataclasses.replace(
    # `conversation.py:399-408`: LLAMA_2 style with sep="" (no "<s>" before
    # [INST]) and an empty system.
    LLAMA2,
    name="mistral_instruct",
    user_fmt="[INST] {content} [/INST]",
    default_system="",
)

GEMMA = ChatTemplate(
    # SeparatorStyle.GEMMA (`conversation.py:131-140,454`): no system;
    # "<start_of_turn>user\n{msg}<end_of_turn>\n" / model turns alike.
    name="gemma",
    system_fmt="",
    user_fmt="<start_of_turn>user\n{content}<end_of_turn>\n",
    assistant_fmt="<start_of_turn>model\n{content}<end_of_turn>\n",
    assistant_prefix="<start_of_turn>model\n",
    stop_strings=("<end_of_turn>",),
    default_system="",
)

MPT = ChatTemplate(
    # SeparatorStyle.MPT (`conversation.py:121-129,432-441`): chatml turns
    # with no newline after <|im_end|>.
    name="mpt",
    system_fmt="<|im_start|>system\n{system}<|im_end|>",
    user_fmt="<|im_start|>user\n{content}<|im_end|>",
    assistant_fmt="<|im_start|>assistant\n{content}<|im_end|>",
    assistant_prefix="<|im_start|>assistant\n",
    stop_strings=("<|im_end|>",),
    default_system=(
        "A conversation between a user and an LLM-based AI assistant. The "
        "assistant gives helpful and honest answers."
    ),
)

TEMPLATES: Dict[str, ChatTemplate] = {
    t.name: t
    for t in (QWEN_CHATML, PLAIN, LLAMA3, VICUNA_V1, LLAMA2,
              MISTRAL_INSTRUCT, GEMMA, MPT)
}
# Reference registry aliases (`conversation.py:555-581`).
TEMPLATES["qwen_2"] = TEMPLATES["qwen_1_5"]
TEMPLATES["vicuna_v1"] = TEMPLATES["v1"]
TEMPLATES["v0_plain"] = TEMPLATES["plain"]


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
    ref_masking: bool = False,
) -> Tuple[List[int], List[int]]:
    """Render and tokenize a training conversation with supervised masking.

    Returns (token_ids, labels): token_ids hold IMAGE_TOKEN_INDEX sentinels
    at <image> positions; labels equal token_ids on the assistant turns'
    content and terminator and IGNORE_INDEX elsewhere (system and user
    turns, the assistant role prefix, image sentinels). Each turn is
    rendered and tokenized on its own, which is exact for chatml: turn
    boundaries are literal token sequences.

    `ref_masking=True` gives the reference's `preprocess_qwen` semantics:
    the whole assistant render is supervised (prefix included), and the
    tokens of "\\n", <|im_start|> and <|im_end|> are unmasked in every turn,
    each only where the tokenizer encodes it as a single token."""
    from radvlm_tpu_torch.models.multimodal import tokenize_with_images

    ids: List[int] = []
    labels: List[int] = []

    def add(text: str, supervised: bool):
        chunk = tokenize_with_images(tokenize_fn, text)
        ids.extend(chunk)
        labels.extend(t if supervised and t >= 0 else IGNORE_INDEX for t in chunk)

    sys_prefix, turns = template._fold_system(turns, system)
    if sys_prefix:
        add(sys_prefix, False)
    for role, content in turns:
        if role == "user":
            add(template.user_fmt.format(content=content), False)
        elif role == "assistant":
            fmt = template.assistant_fmt.format(content=content)
            if ref_masking or not fmt.startswith(template.assistant_prefix):
                add(fmt, True)
            else:
                add(template.assistant_prefix, False)
                add(fmt[len(template.assistant_prefix):], True)
        else:
            raise ValueError(f"unknown role {role!r}")
    if ref_masking:
        unmask = set()
        for text in ("\n", "<|im_start|>", "<|im_end|>"):
            enc = tokenize_fn(text)
            if len(enc) == 1:
                unmask.add(enc[0])
        labels = [t if (t >= 0 and t in unmask) else l for t, l in zip(ids, labels)]
    return ids, labels


def llava_turns(conversations: Sequence[Dict[str, str]]) -> List[Tuple[str, str]]:
    """LLaVA-json `conversations` cells ({"from": "human"|"gpt", "value": ...})
    -> (role, content) turns."""
    role_map = {"human": "user", "gpt": "assistant"}
    return [(role_map[c["from"]], c["value"]) for c in conversations]
