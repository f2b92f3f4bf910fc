"""Multimodal projector (vision feature -> LLM embedding space), the
counterpart of `radvlm_tpu/models/projector.py`: "mlp{N}x_gelu" (RadVLM:
mlp2x_gelu), "linear" and "identity". The GELU is the exact (erf) one, as
torch `nn.GELU()` in the reference - not the tower's tanh form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from radvlm_tpu_torch.config import ProjectorConfig
from radvlm_tpu_torch.models.layers import Linear


class Projector(nn.Module):
    def __init__(self, cfg: ProjectorConfig, vision_dim: int, text_dim: int, *,
                 device=None, dtype=None):
        super().__init__()
        if cfg.kind not in ("identity", "linear") and cfg.mlp_depth == 0:
            raise NotImplementedError(f"projector {cfg.kind!r} is not ported (ROADMAP M10)")
        dims = [vision_dim] + [text_dim] * cfg.mlp_depth
        self.fcs = nn.ModuleList(
            Linear.empty(dims[i], dims[i + 1], True, device=device, dtype=dtype)
            for i in range(cfg.mlp_depth)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., vision_dim] -> [..., text_dim]."""
        for i, fc in enumerate(self.fcs):
            x = fc(x)
            if i < len(self.fcs) - 1:
                x = F.gelu(x)
        return x
