"""CLI for the synthetic-data pipelines: LLM report filtering + conversation
generation (the port's copy of `radvlm_tpu/data/synth_cli.py`).

Mirrors the reference's two entry points
(`radvlm/data/llm_filter_reports.py:95-130`,
`radvlm/data/llm_generate_conversations.py:86-140`):

    python -m radvlm_tpu_torch.data.synth_cli filter-reports --split train
    python -m radvlm_tpu_torch.data.synth_cli filter-reports --chexpertplus --split train
    python -m radvlm_tpu_torch.data.synth_cli generate-conversations --split train --grounding

Differences by design: the LLM backend is pluggable (`--client azure` needs
Azure env credentials like the reference; `--client local --model <hf-dir>`
runs the judge/generator on the port's continuous engine via
`llm_clients.LocalTorchClient` (on the card, or `--device cpu`) — no API
dependency, where the JAX package builds `LocalJAXClient`; `--client fake` for dry
runs), and parallelism is one thread pool (`--num-workers`) instead of the
reference's N forked dataset chunks — outputs are per-sample idempotent files
either way, so resume/sharding across machines still works by just rerunning.
"""

from __future__ import annotations

import argparse
import logging
import os


def _build_client(args):
    if args.client == "azure":
        from radvlm_tpu_torch.data.llm_clients import AzureOpenAIClient

        return AzureOpenAIClient(model=args.model or "gpt-4o")
    if args.client == "local":
        if not args.model:
            raise SystemExit("--client local requires --model <hf checkpoint dir>")
        from radvlm_tpu_torch.data.llm_clients import LocalTorchClient

        return LocalTorchClient(args.model, template=args.template, device=args.device)
    from radvlm_tpu_torch.data.llm_clients import FakeLLMClient

    # Dry-run client: a fixed response that satisfies BOTH pipelines (plain
    # text for filter-reports, a parseable array for generate-conversations).
    return FakeLLMClient(
        default='[{"from": "human", "value": "Q"}, {"from": "gpt", "value": "A"}]'
    )


def _mimic(args, **kw):
    from radvlm_tpu_torch.data.datasets import MIMICCXRDataset

    return MIMICCXRDataset(
        root=os.path.join(args.data_dir, "MIMIC-CXR-JPG"),
        split=args.split, **kw,
    )


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--data-dir", default=os.environ.get("DATA_DIR"),
                        help="corpus root (default: $DATA_DIR)")
    common.add_argument("--split", choices=["train", "test"], default="train")
    common.add_argument("--client", choices=["azure", "local", "fake"],
                        default="azure")
    common.add_argument("--model", default=None,
                        help="azure: deployment name (default gpt-4o); "
                             "local: HF checkpoint dir for the port's engine")
    common.add_argument("--template", default="qwen_1_5",
                        help="chat template for --client local")
    common.add_argument("--device", default=None,
                        help="--client local: where the model lives (default: the CUDA card)")
    common.add_argument("--num-workers", type=int, default=8)
    common.add_argument("--max-samples", type=int, default=None)
    common.add_argument("--output-dir", default=None,
                        help="override the default per-corpus output dir")

    f = sub.add_parser("filter-reports", parents=[common],
                       help="rewrite reports to current-image-only findings "
                            "(reference llm_filter_reports)")
    f.add_argument("--chexpertplus", action="store_true",
                   help="filter CheXpert-Plus instead of MIMIC-CXR")

    g = sub.add_parser("generate-conversations", parents=[common],
                       help="synthesize multi-turn conversations "
                            "(reference llm_generate_conversations)")
    g.add_argument("--grounding", action="store_true",
                   help="grounded variant: conversations cite sentence bboxes")
    g.add_argument("--padchest", action="store_true",
                   help="generate over PadChest-GR instead of MIMIC-CXR")
    g.add_argument("--max-files", type=int, default=100_000,
                   help="reference's output-dir file cap")

    args = p.parse_args(argv)
    if not args.data_dir:
        raise SystemExit("--data-dir (or $DATA_DIR) is required")
    client = _build_client(args)

    from radvlm_tpu_torch.data import synth

    if args.cmd == "filter-reports":
        if args.chexpertplus:
            from radvlm_tpu_torch.data.datasets import CheXpertPlusDataset

            ds = CheXpertPlusDataset(
                root=os.path.join(args.data_dir, "CheXpert-Plus"),
                split=args.split,
            )
            out = args.output_dir or os.path.join(
                args.data_dir, "CheXpert-Plus", "filtered_reports"
            )
        else:
            ds = _mimic(args)
            out = args.output_dir or os.path.join(
                args.data_dir, "MIMIC-CXR-JPG", "filtered_reports"
            )
        n = synth.filter_reports(
            ds, client, out,
            num_workers=args.num_workers, max_samples=args.max_samples,
        )
        print(f"wrote {n} filtered reports to {out}")
        return 0

    # generate-conversations
    if args.padchest:
        from radvlm_tpu_torch.data.datasets import PadChestGroundingDataset

        ds = PadChestGroundingDataset(
            root=os.path.join(args.data_dir, "PadChest-GR"), split=args.split,
        )
        corpus_root = os.path.join(args.data_dir, "PadChest-GR")
    else:
        kw = {}
        if args.grounding:
            sbb = os.path.join(
                args.data_dir, "MS-CXR", "sentences_and_BBox_mscxr"
            )
            if os.path.isdir(sbb):
                kw["sentences_bbox_dir"] = sbb
        ds = _mimic(args, **kw)
        corpus_root = os.path.join(args.data_dir, "MIMIC-CXR-JPG")
    suffix = "conversations_grounded" if args.grounding else "conversations"
    out = args.output_dir or os.path.join(corpus_root, suffix, args.split)
    n = synth.generate_conversations(
        ds, client, out,
        grounded=args.grounding, num_workers=args.num_workers,
        max_files=args.max_files, max_samples=args.max_samples,
    )
    print(f"wrote {n} conversations to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
