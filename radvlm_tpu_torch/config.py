"""Model configs for the port: the JAX package's config dataclasses, which
import no jax, shared by import.

Two properties of `radvlm_tpu.config.RadVLMConfig`, `tokens_per_tile` and
`feature_grid_side`, import the jax resampler; the port never calls them.
`tokens_per_tile(cfg)` and `feature_grid_side(cfg)` here take their place
(identity resampler only, the RadVLM configuration).
"""

from __future__ import annotations

import math

from radvlm_tpu.config import (  # noqa: F401
    DEFAULT_IMAGE_TOKEN,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    AnyResConfig,
    ProjectorConfig,
    Qwen2Config,
    RadVLMConfig,
    ResamplerConfig,
    SigLIPConfig,
    qwen2_0_5b,
    qwen2_7b,
    radvlm_0_5b,
    radvlm_7b,
    tiny_test_config,
)


def tokens_per_tile(cfg) -> int:
    """Image tokens per tile that the LLM sees (729 for SigLIP-384/14)."""
    if cfg.resampler.kind != "identity":
        raise NotImplementedError(
            f"resampler {cfg.resampler.kind!r} is not ported (ROADMAP M10)"
        )
    return cfg.vision.tokens_per_tile


def feature_grid_side(cfg) -> int:
    """Side of the per-tile feature grid (27 for SigLIP-384/14)."""
    return math.isqrt(tokens_per_tile(cfg))
