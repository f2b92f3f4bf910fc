"""Evaluation CLI (counterpart of `radvlm_tpu/eval/cli.py`; the reference's
`accelerate launch radvlm.evaluation.evaluate_instructions --task X
--model_name Y`).

    python -m radvlm_tpu_torch.eval.cli --task report_generation \\
        --checkpoint /ckpts/radvlm-7b-int8 --data-dir $DATA_DIR --output-dir results/

`--checkpoint` is a pre-quantized directory (`models/quantize_cli.py`) or an
HF safetensors directory (loaded in bf16). Runs on the card unless
`--device cpu` is given.

`--multihost` runs one process per rank under torchrun (the world from its
environment; each rank on cuda:LOCAL_RANK): the samples split over the
ranks and the results are gathered:

    torchrun --nproc-per-node 4 -m radvlm_tpu_torch.eval.cli --multihost ...

`--fleet N` drives N continuous engines in this process, one per device of
`--fleet-devices` (default every card). `--multihost --fleet N --fleet-tp T`
runs N TP engines of T ranks each under torchrun (a world of N x T): rank 0
submits every sample through the fleet's routing and writes the files, the
other ranks follow its ticks. Outside torchrun's environment `--fleet-tp`
above 1 raises the ValueError that names torchrun.
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
    p.add_argument("--multihost", action="store_true",
                   help="one process per rank (torchrun): split the samples, gather the results")
    p.add_argument("--fleet", type=int, default=None,
                   help="data-parallel engine fleet: N continuous engines in this process")
    p.add_argument("--fleet-devices", default=None,
                   help="comma-separated devices of the fleet's engines (a device may repeat; "
                        "default every card)")
    p.add_argument("--fleet-tp", type=int, default=1,
                   help="ranks per fleet engine: a TP group, one process a rank "
                        "(--multihost under torchrun)")
    p.add_argument("--device", default=None,
                   help="where the model lives (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None, tokenizer=None):
    """`tokenizer` replaces the HF tokenizer of `--tokenizer` /
    `--checkpoint` (tests pass their own). Returns the metrics dict."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.multihost:
        import torch

        from radvlm_tpu_torch.parallel.mesh import init_distributed

        if args.device is None:
            args.device = (f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
                           if torch.cuda.is_available() else "cpu")
        device = torch.device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        init_distributed(device=device)

    if args.fleet_tp > 1:
        from radvlm_tpu_torch.serve.fleet import check_tp_fleet_world

        check_tp_fleet_world(args.fleet, args.fleet_tp)

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
        fleet=args.fleet, fleet_tp=args.fleet_tp,
        fleet_devices=args.fleet_devices.split(",") if args.fleet_devices else None,
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
