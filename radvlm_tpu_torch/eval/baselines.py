"""Baseline VLM zoo: unified loading + inference for the comparison models
(counterpart of `radvlm_tpu/eval/baselines.py`).

Rebuild of `radvlm/evaluation/models_loading_inference.py` (1,298 LoC): the eval
harness compares RadVLM against RaDialog, LLaVA-Med, CheXagent, MAIRA-2,
Qwen2-VL, and stock LLaVA-OneVision. Those models are PyTorch/HF — they stay a
torch-CPU/GPU *sidecar* here (SURVEY.md §7 hard part 5): each adapter loads via
transformers when its weights are available locally and exposes the same
`infer(image_path, prompt, chat_history) -> text` interface the harness's
result cells expect. The box-format conversions (CheXagent's `<|box|>` token
decode, MAIRA-2's original-image coordinate adjustment) are pure functions,
tested without weights.

RadVLM itself runs through the port's runner (`eval/harness.VLMRunner`);
this module is only for the baselines column of the capability matrix.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Pure conversions (tested)
# ---------------------------------------------------------------------------

_CHEXAGENT_BOX_RE = re.compile(
    r"<\|box\|> \((\d+),(\d+)\),\((\d+),(\d+)\) <\|/box\|>"
)

VICUNA_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions."
)


def vicuna_v1_prompt(prompt: str,
                     chat_history: Optional[List[Tuple[str, str]]] = None) -> str:
    """RaDialog's vicuna-v1 conversation string (SeparatorStyle.TWO: turns
    alternate ' ' and '</s>' separators, ends with 'ASSISTANT:'); the first
    user turn carries '<image>. ' (`models_loading_inference.py:216-235`)."""
    parts = [VICUNA_SYSTEM, " "]
    turns: List[Tuple[str, Optional[str]]] = list(chat_history or [])
    first = not turns
    user_prompt = ("<image>. " + prompt) if first else prompt
    turns.append((user_prompt, None))
    for user, assistant in turns:
        parts.append(f"USER: {user} ")
        if assistant is None:
            parts.append("ASSISTANT:")
        else:
            parts.append(f"ASSISTANT: {assistant}</s>")
    return "".join(parts)


def mistral_instruct_prompt(
    prompt: str, chat_history: Optional[List[Tuple[str, str]]] = None
) -> str:
    """LLaVA-Med's mistral chat template: `[INST] ... [/INST]` turns, the
    first user message prefixed with '<image>\\n'
    (`models_loading_inference.py:309-334`)."""
    turns = list(chat_history or [])
    first = not turns
    out = []
    for i, (user, assistant) in enumerate(turns):
        u = f"<image>\n{user}" if i == 0 else user
        out.append(f"[INST] {u} [/INST]{assistant}</s>")
    u = f"<image>\n{prompt}" if first else prompt
    out.append(f"[INST] {u} [/INST]")
    return "".join(out)


def splice_image_sentinel(text: str, tokenize: Callable[[str], List[int]],
                          image_token_index: int = -200) -> List[int]:
    """Tokenize `text` with each '<image>' replaced by the sentinel id (the
    reference's `tokenizer_image_token`, `finetuning/llava/mm_utils.py:341-360`,
    reused by both sidecar baselines)."""
    chunks = text.split("<image>")
    ids: List[int] = []
    for i, chunk in enumerate(chunks):
        if i:
            ids.append(image_token_index)
        ids.extend(tokenize(chunk))
    return ids


def remap_to_uint8(array, percentiles: Optional[Tuple[float, float]] = None):
    """BioViL image-range normalization (RaDialog preprocessing,
    `models_loading_inference.py:213`): optional percentile clip, then linear
    min-max to [0, 255] uint8."""
    import numpy as np

    a = np.asarray(array, dtype=np.float64)
    if percentiles is not None:
        lo, hi = np.percentile(a, percentiles)
        a = np.clip(a, lo, hi)
    a -= a.min()
    mx = a.max()
    if mx > 0:
        a /= mx
    return (a * 255).astype(np.uint8)


def biovil_chest_xray_transform(img, *, resize: int = 512,
                                center_crop: int = 448):
    """RaDialog's BioViL inference transform (`models_loading_inference.py:
    238-240, 273-282`): grayscale -> resize shortest side -> center crop ->
    [0,1] float -> channel-expand to 3. Returns numpy [1, 3, crop, crop]."""
    import numpy as np
    from PIL import Image

    pil = Image.fromarray(remap_to_uint8(np.asarray(img))).convert("L")
    w, h = pil.size
    if w < h:
        nw, nh = resize, max(1, round(h * resize / w))
    else:
        nh, nw = resize, max(1, round(w * resize / h))
    pil = pil.resize((nw, nh), Image.BILINEAR)
    left = (nw - center_crop) // 2
    top = (nh - center_crop) // 2
    pil = pil.crop((left, top, left + center_crop, top + center_crop))
    a = np.asarray(pil, dtype=np.float32) / 255.0
    return np.repeat(a[None, None], 3, axis=1)


def chexagent_boxes_to_text(generated: str) -> str:
    """CheXagent emits `<|box|> (x1,y1),(x2,y2) <|/box|>` with 0-100 integer
    coords; convert to the harness's `[0.xx, 0.yy, ...]` bbox text
    (`models_loading_inference.py:498-510`)."""
    matches = _CHEXAGENT_BOX_RE.findall(generated)
    if not matches:
        return ""
    return ", ".join(
        f"[{int(x1) / 100:.2f}, {int(y1) / 100:.2f}, "
        f"{int(x2) / 100:.2f}, {int(y2) / 100:.2f}]"
        for x1, y1, x2, y2 in matches
    )


def maira2_boxes_to_text(
    boxes: Optional[Sequence[Optional[Sequence[float]]]],
    adjust: Callable[..., Sequence[float]],
    *,
    width: int,
    height: int,
) -> str:
    """MAIRA-2 grounded-sequence boxes -> harness bbox text, adjusting each box
    from the processor's crop space back to the original image
    (`models_loading_inference.py:146-178`). `adjust` is the processor's
    `adjust_box_for_original_image_size`."""
    if not boxes:
        return ""
    out = []
    for coord in boxes:
        if coord is None:
            continue
        adj = list(adjust(coord, width=width, height=height))
        out.append(str([round(float(v), 2) for v in adj]))
    return ", ".join(out)


# ---------------------------------------------------------------------------
# Torch-sidecar adapters (need local weights; gated imports)
# ---------------------------------------------------------------------------


class BaselineModel:
    """Protocol: infer(image_path, prompt, chat_history=None) -> text."""

    name: str = "baseline"

    def infer(
        self,
        image_path: str,
        prompt: str,
        chat_history: Optional[List[Tuple[str, str]]] = None,
        *,
        max_new_tokens: int = 500,
    ) -> str:
        raise NotImplementedError


class Qwen2VLBaseline(BaselineModel):
    """Qwen2-VL / Qwen2.5-VL via transformers (`models_loading_inference.py:90-94,
    427-483`)."""

    name = "qwen2vl"

    def __init__(self, model_path: str, device: str = "cpu"):
        from transformers import AutoProcessor, Qwen2VLForConditionalGeneration

        self.processor = AutoProcessor.from_pretrained(model_path)
        self.model = Qwen2VLForConditionalGeneration.from_pretrained(model_path)
        self.model.to(device).eval()
        self.device = device

    def infer(self, image_path, prompt, chat_history=None, *, max_new_tokens=500):
        import torch
        from PIL import Image

        messages = []
        for user, assistant in chat_history or []:
            messages.append({"role": "user", "content": [{"type": "text", "text": user}]})
            messages.append({"role": "assistant", "content": [{"type": "text", "text": assistant}]})
        messages.append({
            "role": "user",
            "content": [{"type": "image"}, {"type": "text", "text": prompt}],
        })
        text = self.processor.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True
        )
        image = Image.open(image_path).convert("RGB")
        inputs = self.processor(
            text=[text], images=[image], return_tensors="pt"
        ).to(self.device)
        with torch.no_grad():
            out = self.model.generate(**inputs, max_new_tokens=max_new_tokens)
        trimmed = out[0][inputs["input_ids"].shape[1]:]
        return self.processor.decode(trimmed, skip_special_tokens=True).strip()


class CheXagentBaseline(BaselineModel):
    """CheXagent-2-3b (`models_loading_inference.py:55-61,485-513`)."""

    name = "chexagent"

    def __init__(self, model_path: str = "StanfordAIMI/CheXagent-2-3b",
                 device: str = "cpu"):
        import torch
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(
            model_path, trust_remote_code=True
        )
        self.model = AutoModelForCausalLM.from_pretrained(
            model_path, torch_dtype=torch.float32, trust_remote_code=True
        )
        self.model.to(device).eval()
        self.device = device

    def infer(self, image_path, prompt, chat_history=None, *,
              max_new_tokens=500, grounding: bool = False):
        import torch

        query = self.tokenizer.from_list_format(
            [{"image": image_path}, {"text": prompt}]
        )
        conv = [
            {"from": "system", "value": "You are a helpful assistant."},
            {"from": "human", "value": query},
        ]
        input_ids = self.tokenizer.apply_chat_template(
            conv, add_generation_prompt=True, return_tensors="pt"
        )
        with torch.no_grad():
            out = self.model.generate(
                input_ids.to(self.device), do_sample=False, num_beams=1,
                max_new_tokens=max_new_tokens, use_cache=True,
            )[0]
        text = self.tokenizer.decode(out[input_ids.size(1):-1])
        if grounding:
            return chexagent_boxes_to_text(text)
        return text


class MAIRA2Baseline(BaselineModel):
    """microsoft/maira-2 report-gen + phrase grounding
    (`models_loading_inference.py:79-89,118-178`)."""

    name = "maira2"

    def __init__(self, model_path: str = "microsoft/maira-2", device: str = "cpu"):
        from transformers import AutoModelForCausalLM, AutoProcessor

        self.processor = AutoProcessor.from_pretrained(
            model_path, trust_remote_code=True
        )
        self.model = AutoModelForCausalLM.from_pretrained(
            model_path, trust_remote_code=True
        )
        self.model.to(device).eval()
        self.device = device

    def infer(self, image_path, prompt, chat_history=None, *, max_new_tokens=500):
        import torch
        from PIL import Image

        image = Image.open(image_path).convert("RGB")
        inputs = self.processor.format_and_preprocess_reporting_input(
            current_frontal=image, current_lateral=None, prior_frontal=None,
            indication=None, technique=None, comparison=None,
            prior_report=None, return_tensors="pt", get_grounding=False,
        ).to(self.device)
        with torch.no_grad():
            out = self.model.generate(
                **inputs, max_new_tokens=max_new_tokens, use_cache=True
            )
        decoded = self.processor.decode(
            out[0][inputs["input_ids"].shape[-1]:], skip_special_tokens=True
        )
        return self.processor.convert_output_to_plaintext_or_grounded_sequence(
            decoded
        )

    def ground(self, image_path: str, phrase: str, *, max_new_tokens=500) -> str:
        import torch
        from PIL import Image

        image = Image.open(image_path).convert("RGB")
        inputs = self.processor.format_and_preprocess_phrase_grounding_input(
            frontal_image=image, phrase=phrase, return_tensors="pt"
        ).to(self.device)
        with torch.no_grad():
            out = self.model.generate(
                **inputs, max_new_tokens=max_new_tokens, use_cache=True
            )
        decoded = self.processor.decode(
            out[0][inputs["input_ids"].shape[-1]:], skip_special_tokens=True
        )
        try:
            pred = self.processor.convert_output_to_plaintext_or_grounded_sequence(
                decoded
            )
            w, h = image.size
            return maira2_boxes_to_text(
                pred[0][1], self.processor.adjust_box_for_original_image_size,
                width=w, height=h,
            )
        # ONLY the expected grounded-sequence parse failures: a bare except
        # silently recorded real errors (API drift, OOM) as "no boxes",
        # zeroing the benchmark column with no signal.
        except (ValueError, IndexError, TypeError, KeyError):
            return ""


class LlavaOneVisionBaseline(BaselineModel):
    """Stock llava-onevision via transformers (`:97-112,382-425`)."""

    name = "llava-ov"

    def __init__(self, model_path: str, device: str = "cpu"):
        import torch
        from transformers import AutoProcessor, LlavaOnevisionForConditionalGeneration

        self.processor = AutoProcessor.from_pretrained(model_path)
        self.model = LlavaOnevisionForConditionalGeneration.from_pretrained(
            model_path, torch_dtype=torch.float32
        )
        self.model.to(device).eval()
        self.device = device

    def infer(self, image_path, prompt, chat_history=None, *, max_new_tokens=500):
        import torch
        from PIL import Image

        conversation = []
        for user, assistant in chat_history or []:
            conversation.append(
                {"role": "user", "content": [{"type": "text", "text": user}]}
            )
            conversation.append(
                {"role": "assistant", "content": [{"type": "text", "text": assistant}]}
            )
        conversation.append({
            "role": "user",
            "content": [{"type": "image"}, {"type": "text", "text": prompt}],
        })
        text = self.processor.apply_chat_template(
            conversation, add_generation_prompt=True
        )
        image = Image.open(image_path).convert("RGB")
        inputs = self.processor(
            images=image, text=text, return_tensors="pt"
        ).to(self.device)
        with torch.no_grad():
            out = self.model.generate(**inputs, max_new_tokens=max_new_tokens)
        return self.processor.decode(
            out[0][inputs["input_ids"].shape[1]:], skip_special_tokens=True
        ).strip()


class LlavaMedBaseline(BaselineModel):
    """microsoft/llava-med-v1.5-mistral-7b via the compact in-repo rebuild
    (`eval/llavamed.py`; reference: `llava_med_loading.py:39` + `models_loading_
    inference.py:287-380`). `model_path` must be a local checkpoint dir."""

    name = "llavamed"

    def __init__(self, model_path: str, device: str = "cpu",
                 tokenizer_path: Optional[str] = None):
        from transformers import AutoTokenizer

        from radvlm_tpu_torch.eval.llavamed import LlavaMedModel

        self.model = LlavaMedModel.from_pretrained_dir(model_path, device)
        self.model.eval()
        self.tokenizer = AutoTokenizer.from_pretrained(
            tokenizer_path or model_path
        )
        self.device = device

    def infer(self, image_path, prompt, chat_history=None, *, max_new_tokens=500):
        import torch
        from PIL import Image

        text = mistral_instruct_prompt(prompt, chat_history)
        ids = splice_image_sentinel(
            text, lambda s: self.tokenizer(s, add_special_tokens=False).input_ids
        )
        ids = [self.tokenizer.bos_token_id] + ids
        input_ids = torch.tensor([ids], device=self.device)
        image = Image.open(image_path).convert("RGB")
        pixel_values = self.model.image_processor(
            image, return_tensors="pt"
        )["pixel_values"].to(self.device)
        out = self.model.generate(
            input_ids, pixel_values, max_new_tokens=max_new_tokens,
            pad_token_id=self.tokenizer.eos_token_id,
        )
        # generate(inputs_embeds=...) returns only new tokens.
        return self.tokenizer.decode(out[0], skip_special_tokens=True).strip()


class RaDialogBaseline(BaselineModel):
    """RaDialog (LLaVA-1.5-vicuna + LoRA + BioViL-T tower). The model is only
    loadable through its upstream `LLAVA_Biovil` package (the reference imports
    it the same way, `models_loading_inference.py:23-48`); the prompt build,
    BioViL image transform, and output trim are in-repo pure functions so the
    adapter's contract is tested without the package or weights."""

    name = "radialog"

    STOP_STR = "</s>"

    def __init__(self, model_path: str, device: str = "cpu",
                 model_base: str = "liuhaotian/llava-v1.5-7b"):
        try:
            from LLAVA_Biovil.llava.model.builder import load_pretrained_model
        except ImportError as e:  # pragma: no cover - package not in image
            raise ImportError(
                "RaDialog needs the upstream LLAVA_Biovil package (LoRA merge "
                "+ BioViL-T tower); install it and point model_path at the "
                "snapshot of ChantalPellegrini/RaDialog-interactive-radiology-"
                "report-generation"
            ) from e
        self.tokenizer, self.model, _, _ = load_pretrained_model(
            model_path, model_base=model_base,
            model_name="llava-v1.5-7b-task-lora_radialog_instruct_llava_biovil"
            "_unfrozen_2e-5_5epochs_v5_checkpoint-21000",
            load_8bit=False, load_4bit=False, device_map=device,
        )
        self.device = device

    @staticmethod
    def trim_output(decoded: str) -> str:
        return decoded.strip().replace(RaDialogBaseline.STOP_STR, "")

    def infer(self, image_path, prompt, chat_history=None, *, max_new_tokens=500):
        import numpy as np
        import torch
        from PIL import Image

        text = vicuna_v1_prompt(prompt, chat_history)
        ids = splice_image_sentinel(
            text, lambda s: self.tokenizer(s, add_special_tokens=False).input_ids
        )
        ids = [self.tokenizer.bos_token_id] + ids
        input_ids = torch.tensor([ids], device=self.device)
        img = np.asarray(Image.open(image_path).convert("RGB"))
        image_tensor = torch.from_numpy(
            biovil_chest_xray_transform(img)
        ).to(self.device, torch.bfloat16)
        with torch.inference_mode():
            out = self.model.generate(
                input_ids, images=image_tensor, do_sample=False, use_cache=True,
                max_new_tokens=max_new_tokens,
                pad_token_id=self.tokenizer.pad_token_id,
            )
        return self.trim_output(
            self.tokenizer.decode(out[0, input_ids.shape[1]:])
        )


REGISTRY: Dict[str, type] = {
    "qwen2vl": Qwen2VLBaseline,
    "chexagent": CheXagentBaseline,
    "maira2": MAIRA2Baseline,
    "llava-ov": LlavaOneVisionBaseline,
    "llavamed": LlavaMedBaseline,
    "radialog": RaDialogBaseline,
}


def load_baseline(name: str, model_path: Optional[str] = None, **kw) -> BaselineModel:
    """Unified entry (the reference's `load_model_and_processor`,
    `models_loading_inference.py:30-112`): all 6 comparison baselines."""
    if name not in REGISTRY:
        raise ValueError(
            f"unknown baseline {name!r}; available: {sorted(REGISTRY)}"
        )
    cls = REGISTRY[name]
    return cls(model_path, **kw) if model_path else cls(**kw)
