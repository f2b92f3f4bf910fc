"""Model-worker launcher (counterpart of `radvlm_tpu/serve/worker_cli.py`).

Loads a checkpoint, builds a `VLMRunner` and serves the worker HTTP
protocol. `--checkpoint` is a pre-quantized directory
(`models/quantize_cli.py`, detected by its `radvlm_quant.json`: no bf16 load
and no quantization at start) or an HF safetensors directory (`--int8`
quantizes it at load). The default engine is the continuous-batching worker
(`serve/batch_worker.py`); `--engine static` is the per-request streaming
worker (`serve/worker.py`). Runs on the card unless `--device cpu` is given.

    python -m radvlm_tpu_torch.serve.worker_cli --checkpoint /ckpts/radvlm-7b-int4 \\
        --controller-address http://localhost:21001 --port 21002

`build_worker(args, tokenizer=None)` is `main` without the serving loop, for
a caller that brings its own tokenizer. Engine fleets (`--fleet`,
`--fleet-tp`) are not ported (ROADMAP M12); the JAX package's compile cache
has no counterpart (nothing is compiled but the kernels, once).
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True,
                   help="pre-quantized dir (quantize_cli) or HF safetensors dir")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--model-names", default="radvlm",
                   help="comma-separated model names to register")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=21002)
    p.add_argument("--controller-address", default=None)
    p.add_argument("--worker-address", default="",
                   help="address advertised to the controller "
                        "(default http://localhost:<port>)")
    p.add_argument("--engine", default="continuous",
                   choices=["continuous", "static"],
                   help="continuous: slot-refilled batching worker (default); "
                        "static: per-request streaming worker")
    p.add_argument("--num-slots", type=int, default=8,
                   help="concurrent decode slots (continuous engine)")
    p.add_argument("--max-len", type=int, default=8192,
                   help="per-slot KV cache length (continuous engine)")
    p.add_argument("--prompt-bucket", type=int, default=4096)
    p.add_argument("--limit-concurrency", type=int, default=2,
                   help="max concurrent requests (static engine)")
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--int8", action="store_true",
                   help="quantize an HF checkpoint's weights to int8 at load")
    p.add_argument("--fleet", type=int, default=None,
                   help="data-parallel engine fleet (not ported)")
    p.add_argument("--fleet-tp", type=int, default=1,
                   help="chips per fleet engine (not ported)")
    p.add_argument("--device", default=None,
                   help="where the model lives (default: the CUDA card)")
    return p.parse_args(argv)


def build_worker(args: argparse.Namespace, tokenizer=None, **engine_kw):
    """Load the checkpoint `args` names and build its worker (not yet
    serving). `tokenizer` replaces the HF tokenizer of `--tokenizer` /
    `--checkpoint`. `engine_kw` reaches the continuous engine (`kv_quant`,
    `prompt_buckets`, `fill_batch`, `spec_k`, ...); the int8 KV cache is
    also switched on by RADVLM_KV_INT8=1, as in the JAX package."""
    if args.fleet or args.fleet_tp != 1:
        raise NotImplementedError(
            "--fleet / --fleet-tp: fleets of engines are not ported (ROADMAP M12)")

    from radvlm_tpu_torch.eval.harness import HFTokenizer, VLMRunner
    from radvlm_tpu_torch.models.quant_io import is_quantized_dir, load_checkpoint

    model, cfg = load_checkpoint(args.checkpoint, device=args.device)
    if args.int8 and not is_quantized_dir(args.checkpoint):
        from radvlm_tpu_torch.ops.quant import quantize_model

        quantize_model(model)
    tok = tokenizer if tokenizer is not None else HFTokenizer(args.tokenizer or args.checkpoint)
    # The runner fuses the projections of this one copy in place.
    runner = VLMRunner(model=model, cfg=cfg, tokenizer=tok, max_new_tokens=args.max_new_tokens)
    model_names = [n.strip() for n in args.model_names.split(",") if n.strip()]

    if args.engine == "continuous":
        from radvlm_tpu_torch.serve.batch_worker import BatchWorker

        return BatchWorker(
            runner,
            model_names=model_names,
            num_slots=args.num_slots,
            max_len=args.max_len,
            prompt_bucket=args.prompt_bucket,
            controller_address=args.controller_address,
            worker_address=args.worker_address,
            **engine_kw,
        )
    if engine_kw:
        raise ValueError(f"the static engine takes no engine options, got {sorted(engine_kw)}")
    from radvlm_tpu_torch.serve.worker import ModelWorker

    return ModelWorker(
        runner,
        model_names=model_names,
        worker_address=args.worker_address,
        controller_address=args.controller_address,
        limit_concurrency=args.limit_concurrency,
    )


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    build_worker(args).serve_forever(args.host, args.port)


if __name__ == "__main__":
    main()
