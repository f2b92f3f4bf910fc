"""Training CLI (counterpart of `radvlm_tpu/training/cli.py`, the same flags).

    python -m radvlm_tpu_torch.training.cli --data-path all_train.json \\
        --image-folder <dir> --hf-checkpoint <hf dir> --model-size 0.5b ...

Runs on the card; `--device cpu` runs on the CPU. One device: `--mesh-*`
other than 1 / -1, `--mesh-stage` and `--multihost` raise (ROADMAP M12).
"""

from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-size", default="7b", choices=["0.5b", "7b", "tiny"])
    p.add_argument("--vision-tower", default=None,
                   help="tower override: not ported (only the SigLIP tower is)")
    p.add_argument("--mm-vision-select-layer", type=int, default=-2)
    p.add_argument("--hf-checkpoint", default=None,
                   help="safetensors dir to init from (HF layouts accepted)")
    p.add_argument("--tokenizer", default=None, help="HF tokenizer path")
    p.add_argument("--data-path", required=True,
                   help="llava json / brace glob / yaml mixture")
    p.add_argument("--image-folder", default=os.environ.get("DATA_DIR", ""))
    p.add_argument("--output-dir", default="checkpoints/radvlm")
    # hyperparameters (defaults = finetune_radio_7b.sh)
    p.add_argument("--learning-rate", type=float, default=1e-5)
    p.add_argument("--mm-vision-tower-lr", type=float, default=2e-6)
    p.add_argument("--mm-projector-lr", type=float, default=None)
    p.add_argument("--mm-tunable-parts",
                   default="mm_vision_tower,mm_mlp_adapter,mm_language_model")
    p.add_argument("--warmup-ratio", type=float, default=0.03)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--micro-batch-size", type=int, default=8)
    p.add_argument("--grad-accum-steps", type=int, default=2)
    p.add_argument("--num-epochs", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--total-steps", type=int, default=4000,
                   help="LR schedule horizon")
    p.add_argument("--save-steps", type=int, default=200)
    p.add_argument("--log-every", type=int, default=10)
    # mesh
    p.add_argument("--mesh-data", type=int, default=1)
    p.add_argument("--mesh-fsdp", type=int, default=-1)
    p.add_argument("--mesh-seq", type=int, default=1,
                   help=">1 enables ring-attention sequence parallelism")
    p.add_argument("--mesh-tensor", type=int, default=1)
    p.add_argument("--mesh-stage", type=int, default=1,
                   help="pipeline stages (GPipe over the `stage` axis)")
    p.add_argument("--pp-microbatches", type=int, default=4)
    p.add_argument("--pp-interleave", type=int, default=1,
                   help="virtual stages per device (Megatron interleaved "
                        "schedule, bubble/V); needs layers %% (stage*V) == 0 "
                        "and microbatches %% stage == 0")
    p.add_argument("--buckets", default=None,
                   help="length buckets as 'max_len:max_tiles,...' (e.g. "
                        "'2048:5,4096:6'); default = loader.DEFAULT_BUCKETS")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    # LoRA (reference config-5 style adapter finetune)
    p.add_argument("--lora-rank", type=int, default=0)
    p.add_argument("--lora-alpha", type=float, default=256.0)
    p.add_argument("--use-pos-skipping", action="store_true",
                   help="positional-skipping augmentation for long-context "
                        "rope generalization (reference train.py:107-108, "
                        "llava_arch.py:546-552)")
    p.add_argument("--pos-skipping-range", type=int, default=4096)
    p.add_argument("--quantize-base", action="store_true",
                   help="QLoRA: int8-quantize the frozen base before LoRA")
    p.add_argument("--pack-factor", type=int, default=1,
                   help="samples packed into one row (segment ids keep them apart)")
    p.add_argument("--device", default=None,
                   help="cuda:0 by default; cpu runs on the CPU")
    return p.parse_args(argv)


def main(argv=None, tokenizer=None):
    """`tokenizer` (an object with `encode`) replaces the HF tokenizer that
    `--tokenizer` / `--hf-checkpoint` name: tests pass their own."""
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if args.multihost:
        raise NotImplementedError("--multihost: multi-host training is not ported (ROADMAP M12)")

    from radvlm_tpu_torch import config as cfglib
    from radvlm_tpu_torch.eval.harness import HFTokenizer
    from radvlm_tpu_torch.training.loop import RunConfig, train
    from radvlm_tpu_torch.training.optimizer import TrainConfig

    model_cfg = {
        "7b": cfglib.radvlm_7b,
        "0.5b": cfglib.radvlm_0_5b,
        "tiny": cfglib.tiny_test_config,
    }[args.model_size]()
    if args.vision_tower:
        from radvlm_tpu_torch.models import towers

        model_cfg = towers.with_tower(model_cfg, args.vision_tower,
                                      select_layer=args.mm_vision_select_layer)
    tok = None if tokenizer is not None else HFTokenizer(args.tokenizer or args.hf_checkpoint)
    extra = {}
    if args.buckets:
        from radvlm_tpu_torch.data.loader import Bucket

        extra["buckets"] = tuple(
            Bucket(int(ln), int(tiles))
            for ln, tiles in (b.split(":") for b in args.buckets.split(","))
        )
    run = RunConfig(
        model=model_cfg,
        train=TrainConfig(
            learning_rate=args.learning_rate,
            vision_tower_lr=args.mm_vision_tower_lr,
            projector_lr=args.mm_projector_lr,
            mm_tunable_parts=args.mm_tunable_parts,
            warmup_ratio=args.warmup_ratio,
            weight_decay=args.weight_decay,
            max_grad_norm=args.max_grad_norm,
            total_steps=args.total_steps,
            grad_accum_steps=args.grad_accum_steps,
        ),
        data_path=args.data_path,
        image_root=args.image_folder,
        mesh_shape={
            "data": args.mesh_data,
            "fsdp": args.mesh_fsdp,
            "seq": args.mesh_seq,
            "tensor": args.mesh_tensor,
            "stage": args.mesh_stage,
        },
        micro_batch_size=args.micro_batch_size,
        num_epochs=args.num_epochs,
        max_steps=args.max_steps,
        log_every=args.log_every,
        checkpoint_dir=args.output_dir,
        save_steps=args.save_steps,
        seed=args.seed,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        quantize_base=args.quantize_base,
        pos_skip_range=(
            args.pos_skipping_range if args.use_pos_skipping else 0
        ),
        pack_factor=args.pack_factor,
        device=args.device,
        **extra,
    )
    state = train(run, tokenizer.encode if tokenizer is not None else tok.encode,
                  hf_checkpoint=args.hf_checkpoint)
    print(f"training finished at step {int(state.step)}")


if __name__ == "__main__":
    main()
