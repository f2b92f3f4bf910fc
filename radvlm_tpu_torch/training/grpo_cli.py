"""GRPO training CLI (counterpart of `radvlm_tpu/training/grpo_cli.py`, the
same flags plus `--device`).

    python -m radvlm_tpu_torch.training.grpo_cli --data-path train_rec_grpo.jsonl \\
        --hf-checkpoint <SFT hf dir> --model-size 0.5b ...

`--data-path` is a GRPO-REC jsonl (`data/export.grpo_rec_cell`'s cells).
Rollouts run through the continuous serving engine; rewards are rule-based
(bbox IoU / accuracy@0.5 / format against the cell's JSON solution). Runs on
the card; `--device cpu` runs on the CPU. One device: `--mesh-*` other than
1 / -1 and `--multihost` raise (ROADMAP M12).
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
    p.add_argument("--data-path", required=True, help="GRPO-REC jsonl")
    p.add_argument("--image-folder", default=os.environ.get("DATA_DIR", ""))
    p.add_argument("--output-dir", default="checkpoints/radvlm_grpo")
    p.add_argument("--chat-template", default="qwen_1_5")
    # GRPO hyperparameters (VLM-R1-style defaults)
    p.add_argument("--group-size", type=int, default=8)
    p.add_argument("--prompts-per-wave", type=int, default=4)
    p.add_argument("--clip-eps", type=float, default=0.2)
    p.add_argument("--kl-beta", type=float, default=0.04)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--mu", type=int, default=1,
                   help="inner optimization epochs per rollout wave")
    p.add_argument("--reward", default="rec")
    # rollout engine
    p.add_argument("--num-slots", type=int, default=16)
    p.add_argument("--rollout-max-len", type=int, default=4608)
    p.add_argument("--prompt-bucket", type=int, default=4096)
    p.add_argument("--pad-tiles", type=int, default=6)
    # optimizer / schedule
    p.add_argument("--learning-rate", type=float, default=1e-6)
    p.add_argument("--mm-tunable-parts", default="mm_language_model")
    p.add_argument("--warmup-ratio", type=float, default=0.03)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--total-steps", type=int, default=1000)
    p.add_argument("--save-steps", type=int, default=200)
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--mesh-data", type=int, default=1)
    p.add_argument("--mesh-fsdp", type=int, default=-1)
    p.add_argument("--mesh-tensor", type=int, default=1)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda:0 by default; cpu runs on the CPU")
    return p.parse_args(argv)


def main(argv=None, tokenizer=None):
    """`tokenizer` (an object with `encode`, `decode` and `eos_token_ids`)
    replaces the HF tokenizer that `--tokenizer` / `--hf-checkpoint` name:
    tests pass their own. Returns the final TrainState."""
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if args.multihost:
        raise NotImplementedError("--multihost: multi-host training is not ported (ROADMAP M12)")

    from radvlm_tpu_torch import config as cfglib
    from radvlm_tpu_torch.data.chat import TEMPLATES
    from radvlm_tpu_torch.eval.harness import HFTokenizer
    from radvlm_tpu_torch.training.grpo import GRPOConfig, train_grpo
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
            grad_accum_steps=1,  # each GRPO step is one full-wave update
        ),
        data_path=args.data_path,
        image_root=args.image_folder,
        mesh_shape={
            "data": args.mesh_data,
            "fsdp": args.mesh_fsdp,
            "tensor": args.mesh_tensor,
        },
        max_steps=args.max_steps,
        log_every=args.log_every,
        checkpoint_dir=args.output_dir,
        save_steps=args.save_steps,
        seed=args.seed,
        device=args.device,
    )
    state = train_grpo(
        run, tok.encode, tok.decode, TEMPLATES[args.chat_template],
        grpo_cfg=GRPOConfig(
            group_size=args.group_size,
            prompts_per_wave=args.prompts_per_wave,
            clip_eps=args.clip_eps,
            kl_beta=args.kl_beta,
            temperature=args.temperature,
            top_p=args.top_p,
            max_new_tokens=args.max_new_tokens,
            mu=args.mu,
            reward=args.reward,
        ),
        hf_checkpoint=args.hf_checkpoint,
        num_slots=args.num_slots,
        rollout_max_len=args.rollout_max_len,
        prompt_buckets=(args.prompt_bucket,),
        pad_tiles=args.pad_tiles,
        eos_token_ids=tuple(getattr(tok, "eos_token_ids", ()) or ()),
    )
    print(f"grpo finished at step {int(state.step)}")
    return state


if __name__ == "__main__":
    main()
