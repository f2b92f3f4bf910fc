"""Offline weight quantization: HF checkpoint -> pre-quantized native dir
(counterpart of `radvlm_tpu/models/quantize_cli.py`; the artifact is the
same, see `models/quant_io.py`).

    python -m radvlm_tpu_torch.models.quantize_cli \\
        --hf-checkpoint /ckpts/radvlm-7b-hf --out /ckpts/radvlm-7b-int4 --bits 4

Pays the bf16 load and the quantization once; serving workers start from the
artifact (`serve/worker_cli.py --checkpoint` detects it by
`radvlm_quant.json`). Tokenizer files are copied alongside so the directory
is self-contained. Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil

TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "vocab.json", "merges.txt",
    "special_tokens_map.json", "added_tokens.json", "tokenizer.model",
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--hf-checkpoint", required=True, help="HF safetensors dir")
    p.add_argument("--out", required=True, help="output quantized dir")
    p.add_argument("--bits", type=int, default=8, choices=[8, 4],
                   help="8: int8 weight-only (W8A8-capable); 4: nibble-packed "
                        "int4 layer kernels with group-128 scales (W4A16)")
    p.add_argument("--device", default=None,
                   help="where to load and quantize (default: the CUDA card)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from radvlm_tpu_torch.models.hf_import import config_from_hf_dir, load_radvlm_checkpoint
    from radvlm_tpu_torch.models.quant_io import save_quantized
    from radvlm_tpu_torch.ops.quant import quantize_model

    cfg = config_from_hf_dir(args.hf_checkpoint)
    model = load_radvlm_checkpoint(args.hf_checkpoint, cfg, device=args.device,
                                   dtype=torch.bfloat16)
    quantize_model(model, bits=args.bits)
    payload = save_quantized(model, cfg, args.out)
    for name in TOKENIZER_FILES:
        src = os.path.join(args.hf_checkpoint, name)
        if os.path.isfile(src):
            shutil.copy(src, os.path.join(args.out, name))
    print(f"wrote {args.out}: int{args.bits}, {payload / 1e9:.2f} GB quantized payload")


if __name__ == "__main__":
    main()
