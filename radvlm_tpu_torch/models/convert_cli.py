"""Checkpoint converter CLI: a training checkpoint of the port -> an HF-layout
checkpoint directory (counterpart of `radvlm_tpu/models/convert_cli.py`).

    python -m radvlm_tpu_torch.models.convert_cli \\
        --checkpoint-dir checkpoints/radvlm --model-size 7b --output radvlm-7b-hf [--verify]

Reads the parameters of step `--step` (default: the latest) that
`training/checkpoint.py`'s `CheckpointManager` saved under
`--checkpoint-dir` (the JAX package's tree layout), builds the model on
`--device` (default: the CUDA card) and writes `model.safetensors` and
`config.json` through `hf_export.save_radvlm_hf`. `--verify` loads the
written directory back with `hf_import.load_radvlm_checkpoint` and requires
every parameter to equal the checkpoint's. The JAX CLI first turns
pipeline-parallel layer stacks back into [L, ...] stacks
(`parallel.pp.canonicalize_layer_stacks`); the port has no pipeline
parallelism yet (ROADMAP M12), so its checkpoints are never stacked that
way and there is nothing to undo. A LoRA run's checkpoint (adapters only)
is refused.
"""

from __future__ import annotations

import argparse
import logging

log = logging.getLogger(__name__)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint-dir", required=True, help="the training run's output dir")
    p.add_argument("--step", type=int, default=None, help="default: latest")
    p.add_argument("--model-size", default="7b", choices=["0.5b", "7b", "tiny"])
    p.add_argument("--output", required=True, help="HF output dir")
    p.add_argument("--verify", action="store_true",
                   help="reload the export and compare every parameter")
    p.add_argument("--device", default=None, help="where to build the model (default: the card)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from radvlm_tpu_torch import config as cfglib
    from radvlm_tpu_torch.models import convert
    from radvlm_tpu_torch.models.hf_export import save_radvlm_hf
    from radvlm_tpu_torch.training import checkpoint as ckpt_lib

    cfg = {
        "7b": cfglib.radvlm_7b,
        "0.5b": cfglib.radvlm_0_5b,
        "tiny": cfglib.tiny_test_config,
    }[args.model_size]()
    manager = ckpt_lib.CheckpointManager(args.checkpoint_dir)
    step = args.step if args.step is not None else manager.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoints under {args.checkpoint_dir}")
    log.info("restoring step %d", step)
    tree = ckpt_lib.read_params(manager, step)
    model = convert.radvlm_from_jax(tree, cfg, device=args.device,
                                    dtype=tree["image_newline"].dtype)
    save_radvlm_hf(model, cfg, args.output)
    log.info("wrote %s", args.output)

    if args.verify:
        from radvlm_tpu_torch.models.hf_import import load_radvlm_checkpoint

        back = load_radvlm_checkpoint(args.output, cfg, device=args.device,
                                      dtype=torch.float32)
        mine = dict(back.named_parameters())
        for name, param in model.named_parameters():
            if not torch.equal(param.float(), mine[name]):
                raise SystemExit(f"round trip changed {name}")
        log.info("round trip verified: %d parameters equal", len(mine))
    return model


if __name__ == "__main__":
    main()
