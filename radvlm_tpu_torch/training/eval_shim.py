"""External-evaluator shim: run lmms-eval after / alongside training (the
port's own copy of `radvlm_tpu/training/eval_shim.py`).

Shell out to the `lmms_eval` CLI, locate its results.json, and flatten
`{task}_{metric}` entries into a dict. The shim is a plain function and the
launch is a list-argv subprocess against an HF-format checkpoint directory
(lmms-eval consumes HF-format models).

lmms-eval is an optional external tool (not in this image); the shim degrades
with a clear error, and `parse_lmms_results` is pure so the result-flattening
contract is testable without the tool.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class LmmsEvalArgs:
    """Mirrors the reference's evaluate_args surface."""

    model: str = "llava_onevision"
    model_args: str = ""  # e.g. "pretrained=/path/to/hf_export"
    task_names: str = ""  # comma-separated lmms-eval task names
    batch_size: int = 1
    output_path: str = "lmms_eval_results"
    limit: Optional[int] = None
    num_fewshot: Optional[int] = None
    gen_kwargs: str = ""
    eval_num_processes: int = 1


def build_command(args: LmmsEvalArgs) -> List[str]:
    """argv for the lmms-eval launch (list form: no shell injection).
    Multi-process runs launch through accelerate."""
    if args.eval_num_processes > 1:
        launcher = [
            "accelerate", "launch",
            "--num_processes", str(args.eval_num_processes),
            "-m", "lmms_eval",
        ]
    else:
        launcher = ["python", "-m", "lmms_eval"]
    cmd = launcher + [
        "--model", args.model,
        "--model_args", args.model_args,
        "--tasks", args.task_names,
        "--batch_size", str(args.batch_size),
        "--output_path", args.output_path,
        "--log_samples",  # required: results.json is parsed afterwards
    ]
    # `is not None`, not truthiness: limit=0 / num_fewshot=0 are meaningful
    # (0-shot is a different protocol than the task default).
    if args.limit is not None:
        cmd += ["--limit", str(args.limit)]
    if args.num_fewshot is not None:
        cmd += ["--num_fewshot", str(args.num_fewshot)]
    if args.gen_kwargs:
        cmd += ["--gen_kwargs", args.gen_kwargs]
    return cmd


def parse_lmms_results(results: Dict, task_names: Sequence[str]) -> Dict[str, float]:
    """Flatten lmms-eval results.json into {task_metric: value}, dropping
    aliases and stderr entries."""
    out: Dict[str, float] = {}
    for task in task_names:
        for k, v in results["results"][task].items():
            if k == "alias" or "stderr" in k:
                continue
            metric = k.split(",")[0]
            out[f"{task}_{metric}"] = v
    return out


def find_results_file(output_path: str) -> str:
    """Locate the newest results.json below the lmms-eval output dir."""
    candidates = []
    for root, _dirs, files in os.walk(output_path):
        for f in files:
            if f == "results.json":
                p = os.path.join(root, f)
                candidates.append((os.path.getmtime(p), p))
    if not candidates:
        raise FileNotFoundError(f"no results.json under {output_path}")
    return max(candidates)[1]


def evaluate(args: LmmsEvalArgs, *, runner=subprocess.run) -> Dict[str, float]:
    """Launch lmms-eval and return the flattened metric dict.

    `runner` is injectable for tests (and for harnesses that wrap launches).
    """
    try:
        import lmms_eval  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "lmms-eval is not installed; install the external evaluator or "
            "use radvlm_tpu_torch.eval (the in-repo harness) instead"
        ) from e
    proc = runner(build_command(args), capture_output=True, text=True)
    if getattr(proc, "returncode", 0) != 0:
        raise RuntimeError(
            f"lmms-eval failed ({proc.returncode}):\n{proc.stderr[-2000:]}"
        )
    with open(find_results_file(args.output_path)) as f:
        results = json.load(f)
    return parse_lmms_results(results, args.task_names.split(","))
