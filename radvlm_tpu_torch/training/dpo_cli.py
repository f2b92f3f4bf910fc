"""DPO training CLI (counterpart of `radvlm_tpu/training/dpo_cli.py`, the
same flags plus `--device`).

    python -m radvlm_tpu_torch.training.dpo_cli --data-path prefs.json \\
        --hf-checkpoint <SFT hf dir> --model-size 0.5b ...

`--data-path` is a preference json: [{"prompt", "chosen", "rejected",
"image"?}, ...]. Runs on the card; `--device cpu` runs on the CPU. One
device: `--mesh-*` other than 1 / -1 and `--multihost` raise (ROADMAP M12).
"""

from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-size", default="7b", choices=["0.5b", "7b", "tiny"])
    p.add_argument("--hf-checkpoint", default=None,
                   help="SFT checkpoint to start from (policy AND reference)")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--data-path", required=True, help="preference json")
    p.add_argument("--image-folder", default=os.environ.get("DATA_DIR", ""))
    p.add_argument("--output-dir", default="checkpoints/radvlm_dpo")
    p.add_argument("--beta", type=float, default=0.1)
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--learning-rate", type=float, default=5e-7)
    p.add_argument("--mm-tunable-parts", default="mm_language_model")
    p.add_argument("--warmup-ratio", type=float, default=0.03)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--micro-batch-size", type=int, default=8)
    p.add_argument("--grad-accum-steps", type=int, default=1)
    p.add_argument("--num-epochs", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--total-steps", type=int, default=1000)
    p.add_argument("--save-steps", type=int, default=200)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--mesh-data", type=int, default=1)
    p.add_argument("--mesh-fsdp", type=int, default=-1)
    p.add_argument("--mesh-tensor", type=int, default=1)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda:0 by default; cpu runs on the CPU")
    return p.parse_args(argv)


def main(argv=None, tokenizer=None):
    """`tokenizer` (an object with `encode`) replaces the HF tokenizer that
    `--tokenizer` / `--hf-checkpoint` name: tests pass their own. Returns
    the final TrainState."""
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if args.multihost:
        raise NotImplementedError("--multihost: multi-host training is not ported (ROADMAP M12)")

    from radvlm_tpu_torch import config as cfglib
    from radvlm_tpu_torch.eval.harness import HFTokenizer
    from radvlm_tpu_torch.training.dpo import DPOConfig, train_dpo
    from radvlm_tpu_torch.training.loop import RunConfig
    from radvlm_tpu_torch.training.optimizer import TrainConfig

    model_cfg = {
        "7b": cfglib.radvlm_7b,
        "0.5b": cfglib.radvlm_0_5b,
        "tiny": cfglib.tiny_test_config,
    }[args.model_size]()
    tok = tokenizer or HFTokenizer(args.tokenizer or args.hf_checkpoint)
    run = RunConfig(
        model=model_cfg,
        train=TrainConfig(
            learning_rate=args.learning_rate,
            mm_tunable_parts=args.mm_tunable_parts,
            warmup_ratio=args.warmup_ratio,
            max_grad_norm=args.max_grad_norm,
            total_steps=args.total_steps,
            grad_accum_steps=args.grad_accum_steps,
        ),
        data_path=args.data_path,
        image_root=args.image_folder,
        mesh_shape={
            "data": args.mesh_data,
            "fsdp": args.mesh_fsdp,
            "tensor": args.mesh_tensor,
        },
        micro_batch_size=args.micro_batch_size,
        num_epochs=args.num_epochs,
        max_steps=args.max_steps,
        log_every=args.log_every,
        checkpoint_dir=args.output_dir,
        save_steps=args.save_steps,
        seed=args.seed,
        device=args.device,
    )
    state = train_dpo(
        run, tok.encode,
        dpo_cfg=DPOConfig(beta=args.beta, label_smoothing=args.label_smoothing),
        hf_checkpoint=args.hf_checkpoint,
    )
    print(f"dpo finished at step {int(state.step)}")
    return state


if __name__ == "__main__":
    main()
