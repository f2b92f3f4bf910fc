"""Conversation-eval CLI (counterpart of `radvlm_tpu/eval/conversations_cli.py`;
the reference's `radvlm/evaluation/evaluate_conversations.py`).

    python -m radvlm_tpu_torch.eval.conversations_cli \\
        --checkpoint /ckpts/radvlm-7b-int8 --data-dir $DATA_DIR \\
        --grounded --judge azure --output results/conv_eval.json

`--checkpoint` is a pre-quantized directory (`models/quantize_cli.py`) or an
HF safetensors directory (loaded in bf16). Runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import logging
import os


def main(argv=None, tokenizer=None, judge=None):
    """`tokenizer` replaces the HF tokenizer of `--tokenizer` /
    `--checkpoint` and `judge` the Azure client (tests pass their own).
    Returns the metrics dict."""
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--data-dir", default=os.environ.get("DATA_DIR"))
    p.add_argument("--grounded", action="store_true",
                   help="grounded conversations (bbox-aware, MS-CXR subset)")
    p.add_argument("--judge", default="azure", choices=["azure"])
    p.add_argument("--judge-model", default="gpt-4o")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--output", default="results/conversations_eval.json")
    p.add_argument("--device", default=None,
                   help="where the model lives (default: the CUDA card)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from radvlm_tpu_torch.data import datasets as ds
    from radvlm_tpu_torch.data.llm_clients import AzureOpenAIClient
    from radvlm_tpu_torch.eval.conversations import evaluate_conversations
    from radvlm_tpu_torch.eval.harness import HFTokenizer, VLMRunner
    from radvlm_tpu_torch.models.quant_io import load_checkpoint

    model, cfg = load_checkpoint(args.checkpoint, device=args.device)
    tok = tokenizer if tokenizer is not None else HFTokenizer(args.tokenizer or args.checkpoint)
    # The runner fuses the projections of this one copy in place.
    runner = VLMRunner(
        model=model, cfg=cfg, tokenizer=tok,
        max_new_tokens=args.max_new_tokens, batch_size=1,
    )

    kind = "grounded" if args.grounded else "standard"
    dataset = ds.MIMICCXRDataset(
        os.path.join(args.data_dir, "MIMIC-CXR-JPG"),
        split="test", only_frontal=True, flag_lab=False,
        conversation_dir=os.path.join(
            args.data_dir, "MIMIC-CXR-JPG", "conversations", "test", kind
        ),
        sentences_bbox_dir=(
            os.path.join(args.data_dir, "MS-CXR", "sentences_BBox_mscxr")
            if args.grounded else None
        ),
    )
    if judge is None:
        judge = AzureOpenAIClient(model=args.judge_model)
    metrics = evaluate_conversations(
        runner, dataset, judge,
        max_samples=args.max_samples, output_path=args.output,
    )
    print(f"mean judge score: {metrics['mean_score']:.2f}/10 "
          f"over {int(metrics['n'])} conversations")
    return metrics


if __name__ == "__main__":
    main()
