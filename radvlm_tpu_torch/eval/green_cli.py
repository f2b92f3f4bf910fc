"""GREEN evaluation CLI (counterpart of `radvlm_tpu/eval/green_cli.py`; the
reference's `radvlm/evaluation/eval_green.py`).

Scores saved report-generation outputs with the GREEN LLM judge
(StanfordAIMI/GREEN-radllama2-7b). The judge backend is pluggable:

- --judge torch (default): the radllama2 judge on the port's own engine
  (`generation/text_lm.py`), every sample batched through the continuous
  batcher;
- --judge hf: transformers' `generate` from a local path, one sample at a
  time (the reference's path);
- --judge azure: any chat LLM through the AzureOpenAI client;
- --judge echo: parse-only smoke mode (expects precomputed responses).

    python -m radvlm_tpu_torch.eval.green_cli \\
        --outputs results/radvlm_report_generation_output.json \\
        --judge-model /models/GREEN-radllama2-7b --int8

Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import logging


def make_torch_judge(model_path: str, *, max_new_tokens: int = 512, num_slots: int = 8,
                     int8: bool = False, dtype=None, device=None, tokenizer=None):
    """GREEN judging on the port's continuous engine: the judge (a Llama-2
    LM) loads through `hf_import` and scores all report pairs batched.
    Returns a batch judge (`[prompts] -> [responses]`, `.batched = True`)
    whose `.engine` is the `TextLMEngine`."""
    from radvlm_tpu_torch.generation.text_lm import TextLMEngine

    engine = TextLMEngine(
        model_path, max_new_tokens=max_new_tokens, num_slots=num_slots,
        int8=int8, dtype=dtype, device=device, tokenizer=tokenizer,
    )

    def batch_judge(prompts):
        return engine.generate_batch(prompts)

    batch_judge.batched = True
    batch_judge.engine = engine
    return batch_judge


def make_hf_judge(model_path: str, *, max_new_tokens: int = 512):
    import torch
    from transformers import AutoModelForCausalLM, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_path)
    model = AutoModelForCausalLM.from_pretrained(
        model_path, torch_dtype=torch.float32
    )
    model.eval()

    def judge(prompt: str) -> str:
        ids = tok(prompt, return_tensors="pt", truncation=True, max_length=3000)
        with torch.no_grad():
            out = model.generate(**ids, max_new_tokens=max_new_tokens)
        return tok.decode(out[0][ids["input_ids"].shape[1]:],
                          skip_special_tokens=True)

    return judge


def main(argv=None, tokenizer=None):
    """`tokenizer` replaces the judge's HF tokenizer for `--judge torch`
    (tests and the smoke run pass their own)."""
    p = argparse.ArgumentParser()
    p.add_argument("--outputs", required=True,
                   help="eval-harness *_output.json for report_generation")
    p.add_argument("--judge", default="torch",
                   choices=["torch", "hf", "azure", "echo"])
    p.add_argument("--judge-model", default="StanfordAIMI/GREEN-radllama2-7b")
    p.add_argument("--judge-slots", type=int, default=8,
                   help="concurrent decode slots for --judge torch")
    p.add_argument("--int8", action="store_true",
                   help="int8-quantize the torch judge's weights at load")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--save", default=None)
    p.add_argument("--device", default=None,
                   help="where the torch judge lives (default: the CUDA card)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from radvlm_tpu_torch.eval.metrics.clinical import green, green_batched

    with open(args.outputs) as f:
        results = json.load(f)
    if args.max_samples:
        results = results[: args.max_samples]
    refs = [r["txt"] for r in results]
    hyps = [r["output"] for r in results]

    engine = None
    if args.judge == "torch":
        judge = make_torch_judge(
            args.judge_model, num_slots=args.judge_slots, int8=args.int8,
            device=args.device, tokenizer=tokenizer,
        )
        engine = judge.engine
    elif args.judge == "hf":
        judge = make_hf_judge(args.judge_model)
    elif args.judge == "azure":
        from radvlm_tpu_torch.data.llm_clients import AzureOpenAIClient

        client = AzureOpenAIClient(model=args.judge_model)
        judge = lambda prompt: client.complete(prompt) or ""
    else:
        judge = lambda prompt: prompt  # echo: for piping/debugging only

    try:
        if getattr(judge, "batched", False):
            mean, scores = green_batched(refs, hyps, judge)
        else:
            mean, scores = green(refs, hyps, judge)
    finally:
        if engine is not None:
            engine.shutdown()
    print(f"GREEN mean: {mean:.4f} over {len([s for s in scores if s is not None])} scored samples")
    if args.save:
        with open(args.save, "w") as f:
            json.dump({"green_mean": mean, "scores": scores}, f, indent=2)
    return mean, scores


if __name__ == "__main__":
    main()
