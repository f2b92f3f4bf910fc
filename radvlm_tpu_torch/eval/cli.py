"""Evaluation CLI (counterpart of `radvlm_tpu/eval/cli.py`; the reference's
`accelerate launch radvlm.evaluation.evaluate_instructions --task X
--model_name Y`).

    python -m radvlm_tpu_torch.eval.cli --task report_generation \\
        --checkpoint /ckpts/radvlm-7b-int8 --data-dir $DATA_DIR --output-dir results/

`--checkpoint` is a pre-quantized directory (`models/quantize_cli.py`) or an
HF safetensors directory (loaded in bf16). Runs on the card unless
`--device cpu` is given. One process on one card: `--multihost`, `--fleet`
and `--fleet-tp` are not ported (ROADMAP M12).
"""

from __future__ import annotations

import argparse
import logging
import os

TASKS = [
    "report_generation", "abnormality_classification",
    "abnormality_grounding", "abnormality_detection",
    "anatomical_grounding", "phrase_grounding",
]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--task", required=True, choices=TASKS)
    p.add_argument("--checkpoint", required=True,
                   help="pre-quantized dir (quantize_cli) or HF safetensors dir")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--model-name", default="radvlm")
    p.add_argument("--data-dir", default=os.environ.get("DATA_DIR"))
    p.add_argument("--output-dir", default="results")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--no-clinical", action="store_true",
                   help="skip RadGraph/CheXbert/BERTScore sidecar metrics")
    p.add_argument("--engine", default="continuous",
                   choices=["continuous", "static"],
                   help="continuous: slot-refilled batching (default); "
                        "static: fixed padded batches")
    p.add_argument("--multihost", action="store_true", help="not ported")
    p.add_argument("--fleet", type=int, default=None,
                   help="data-parallel engine fleet (not ported)")
    p.add_argument("--fleet-tp", type=int, default=1,
                   help="chips per fleet engine (not ported)")
    p.add_argument("--device", default=None,
                   help="where the model lives (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None, tokenizer=None):
    """`tokenizer` replaces the HF tokenizer of `--tokenizer` /
    `--checkpoint` (tests pass their own). Returns the metrics dict."""
    args = parse_args(argv)
    if args.multihost:
        raise NotImplementedError("--multihost: multi-host evaluation is not ported (ROADMAP M12)")
    if args.fleet or args.fleet_tp != 1:
        raise NotImplementedError(
            "--fleet / --fleet-tp: fleets of engines are not ported (ROADMAP M12)")
    logging.basicConfig(level=logging.INFO)

    from radvlm_tpu_torch.eval.harness import (
        HFTokenizer,
        VLMRunner,
        build_task_dataset,
        run_task,
    )
    from radvlm_tpu_torch.models.quant_io import load_checkpoint

    model, cfg = load_checkpoint(args.checkpoint, device=args.device)
    tok = tokenizer if tokenizer is not None else HFTokenizer(args.tokenizer or args.checkpoint)
    # The runner fuses the projections of this one copy in place.
    runner = VLMRunner(
        model=model, cfg=cfg, tokenizer=tok,
        max_new_tokens=args.max_new_tokens, batch_size=args.batch_size,
    )
    dataset = build_task_dataset(args.task, args.data_dir)
    _, metrics = run_task(
        runner, dataset, args.task,
        max_samples=args.max_samples,
        output_dir=args.output_dir,
        model_name=args.model_name,
        with_clinical=not args.no_clinical,
        engine=args.engine,
        progress=lambda done, total: print(f"{done}/{total}", flush=True),
    )
    for k, v in metrics.items():
        print(f"{k}: {round(float(v) * 100, 1)}")
    return metrics


if __name__ == "__main__":
    main()
