"""Optional W&B metrics callback (the port's own copy of
`radvlm_tpu/training/wandb_logging.py`). `wandb` is imported inside
`make_wandb_callback`: where it is absent the callback is a no-op, with a
warning, so a training driver's `metrics_callback` can always be wired to it.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

log = logging.getLogger(__name__)


def make_wandb_callback(
    project: str = "radvlm-tpu",
    run_name: Optional[str] = None,
    config: Optional[Dict] = None,
):
    """Returns metrics_callback(step, metrics) for `training.loop.train`,
    `dpo.train_dpo` and `grpo.train_grpo`."""
    try:
        import wandb
    except ImportError:
        log.warning("wandb not installed; metrics logging is a no-op")
        return lambda step, metrics: None

    run = wandb.init(project=project, name=run_name, config=config or {})

    def callback(step: int, metrics: Dict[str, float]):
        run.log(metrics, step=step)

    return callback
