"""Generic (multi-image, multi-turn) VQA entry point (counterpart of
`radvlm_tpu/eval/vqa_cli.py`, the reference's
`finetuning/llava/eval/model_vqa.py`).

Reads a questions JSON (list of {sample_id, metadata: {dataset,
question_type}, image: [files], conversations: llava-json turns}),
generates an answer per assistant turn, and appends records to an answers
JSONL —

    {dataset, sample_id, prompt, pred_response, gt_response, shortuuid,
     model_id, question_type}

— the result contract `eval/interleave.py` scores. Generation is batched
through `VLMRunner.generate_batch`; round r batches every sample that still
has a user turn at r, re-rendering the whole chatml prompt. Chunk sharding
(`--num-chunks/--chunk-idx`) keeps the reference's ceil split, and an
out-of-range chunk is an empty shard. Runs on the card unless `--device cpu`
is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import uuid
from typing import Dict, List, Sequence


def split_list(lst: Sequence, n: int) -> List[Sequence]:
    """ceil-sized chunks (`model_vqa.py:23-26`)."""
    chunk_size = math.ceil(len(lst) / n)
    return [lst[i:i + chunk_size] for i in range(0, len(lst), chunk_size)]


def get_chunk(lst: Sequence, n: int, k: int) -> Sequence:
    chunks = split_list(lst, n)
    return chunks[k] if k < len(chunks) else []


def run_vqa(
    runner,
    questions: Sequence[Dict],
    *,
    image_folder: str = "",
    answers_file: str,
    model_id: str = "radvlm",
    extra_prompt: str = "",
    temperature: float = 0.0,
    top_p: float = 1.0,
    max_new_tokens: int = 1024,
) -> int:
    """Drive every conversation round; returns the number of records written."""
    from radvlm_tpu_torch.data.chat import QWEN_CHATML, render_generation_prompt
    from radvlm_tpu_torch.data.loader import load_image

    states = []
    for q in questions:
        image_files = q.get("image", [])
        if isinstance(image_files, str):
            image_files = [image_files]
        states.append({
            "q": q,
            "images": [load_image(os.path.join(image_folder, f)) for f in image_files],
            "turns": [],  # rendered (role, content) history
        })

    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    written = 0
    with open(answers_file, "w") as ans:
        round_idx = 0
        while True:
            # samples with a user turn at conversation index 2*round_idx
            live = [s for s in states if 2 * round_idx + 1 < len(s["q"]["conversations"])]
            if not live:
                break
            prompts, images = [], []
            for s in live:
                user_turn = s["q"]["conversations"][2 * round_idx]["value"]
                s["turns"].append(("user", extra_prompt + user_turn))
                prompts.append(render_generation_prompt(s["turns"], template=QWEN_CHATML))
                # all of the sample's images ride every round: the <image>
                # sentinels live in the first user turn, which stays in the
                # rendered history
                images.append(s["images"])
            bs = runner.batch_size
            outputs: List[str] = []
            for i in range(0, len(prompts), bs):
                outputs.extend(runner.generate_batch(
                    prompts[i:i + bs], images[i:i + bs],
                    max_new_tokens=max_new_tokens,
                    temperature=temperature, top_p=top_p,
                ))
            for s, out in zip(live, outputs):
                out = out.strip()
                q = s["q"]
                ans.write(json.dumps({
                    "dataset": q.get("metadata", {}).get("dataset"),
                    "sample_id": q.get("sample_id"),
                    "prompt": extra_prompt + q["conversations"][2 * round_idx]["value"],
                    "pred_response": out,
                    "gt_response": q["conversations"][2 * round_idx + 1]["value"],
                    "shortuuid": uuid.uuid4().hex[:22],
                    "model_id": model_id,
                    "question_type": q.get("metadata", {}).get("question_type"),
                }) + "\n")
                ans.flush()
                written += 1
                s["turns"].append(("assistant", out))
            round_idx += 1
    return written


def main(argv=None, tokenizer=None):
    """`tokenizer` replaces the HF tokenizer of `--tokenizer` /
    `--checkpoint` (tests pass their own)."""
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True,
                   help="pre-quantized dir (quantize_cli) or HF safetensors dir")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--model-id", default="radvlm")
    p.add_argument("--question-file", required=True)
    p.add_argument("--image-folder", default="")
    p.add_argument("--answers-file", required=True)
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--extra-prompt", default="")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="where the model lives (default: the CUDA card)")
    args = p.parse_args(argv)

    from radvlm_tpu_torch.eval.harness import HFTokenizer, VLMRunner
    from radvlm_tpu_torch.models.quant_io import load_checkpoint

    with open(os.path.expanduser(args.question_file)) as f:
        questions = json.load(f)
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)

    model, cfg = load_checkpoint(args.checkpoint, device=args.device)
    tok = tokenizer if tokenizer is not None else HFTokenizer(args.tokenizer or args.checkpoint)
    runner = VLMRunner(model=model, cfg=cfg, tokenizer=tok,
                       max_new_tokens=args.max_new_tokens, batch_size=args.batch_size)
    n = run_vqa(
        runner, questions,
        image_folder=args.image_folder,
        answers_file=args.answers_file,
        model_id=args.model_id,
        extra_prompt=args.extra_prompt,
        temperature=args.temperature,
        top_p=args.top_p,
        max_new_tokens=args.max_new_tokens,
    )
    print(json.dumps({"written": n, "answers_file": args.answers_file}))


if __name__ == "__main__":
    main()
