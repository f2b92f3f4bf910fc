"""Model configs for the port: its own copy of the JAX package's config
dataclasses (`radvlm_tpu/config.py`), same names, fields and defaults, so
that one config object built by either package drives both (the parity tests
do that). Port code reads fields and never tests a config's class.

The JAX `RadVLMConfig` has two properties, `tokens_per_tile` and
`feature_grid_side`, that reach its resampler module; here they are the
functions `tokens_per_tile(cfg)` and `feature_grid_side(cfg)`. The CLIP,
EVA and ImageBind tower configs live beside their towers
(`models/clip.py`, `models/eva.py`, `models/imagebind.py`), as in the JAX
package. Every decoder preset is kept
(Qwen2, Llama-3, Mistral, Mixtral, Gemma, MPT); the RadVLM presets are
the two SigLIP + Qwen2 ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    """SigLIP vision tower config (SO400M defaults).

    `num_layers` is the number of encoder layers actually run.  The reference drops the
    last (27th) pretrained layer and the pooling head and returns the resulting hidden
    states (`siglip_encoder.py:570-571,582`), so the flagship config uses 26.
    """

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 26
    num_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    # gelu_pytorch_tanh in the reference: F.gelu(approximate="tanh").
    hidden_act: str = "gelu_tanh"

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size  # 27

    @property
    def tokens_per_tile(self) -> int:
        return self.patches_per_side ** 2  # 729

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    """GQA decoder config. Defaults = Qwen2-7B-Instruct (flagship LLM).

    Architecture contract: RMSNorm(eps), rotary embeddings with `rope_theta`, grouped
    query attention with QKV bias (o-proj without bias), SwiGLU MLP without bias,
    optional tied input/output embeddings (true for 0.5B).

    The same dataclass parameterizes the Llama family (reference wraps one
    model class per family, `language_model/llava_llama.py` etc.; here one
    functional decoder covers both): `attention_bias=False` + llama3-style
    frequency-dependent rope scaling via `rope_scaling_type="llama3"`.
    """

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    # Rope scaling for context extension (reference flags
    # `rope_scaling_factor/type`, train.py:101-102,1322-1332):
    # "linear": positions divided by `rope_scaling`;
    # "llama3": frequency-dependent NTK remap (factor=rope_scaling,
    #   low/high_freq_factor, original_max_position_embeddings below).
    rope_scaling: float = 1.0
    rope_scaling_type: str = "linear"
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    rms_norm_eps: float = 1e-6
    attention_bias: bool = True  # Qwen2 yes; Llama no
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 32768
    # Family knobs beyond Qwen2/Llama (the reference wraps a model class per
    # family — `language_model/llava_mistral.py`, `llava_gemma.py`; here the
    # one functional decoder covers them):
    # "silu" (Qwen2/Llama/Mistral) or "gelu_tanh" (Gemma's GeGLU).
    hidden_act: str = "silu"
    # Gemma: RMSNorm weights are zero-centered, applied as (1 + w).
    rms_norm_offset: bool = False
    # Gemma: hidden states scaled by sqrt(hidden_size) after embedding.
    embed_normalizer: bool = False
    # Mistral: sliding-window attention — each token attends to at most the
    # previous `sliding_window` positions. 0 = full causal.
    sliding_window: int = 0
    # MPT family (the reference's llava_mpt, `language_model/llava_mpt.py`):
    # ALiBi position bias instead of rope, weight-only LayerNorm instead of
    # RMSNorm, non-gated GELU MLP.
    pos_embedding: str = "rope"  # "rope" | "alibi"
    norm_kind: str = "rmsnorm"  # "rmsnorm" | "layernorm" (weight-only)
    mlp_gated: bool = True  # False: up -> act -> down (MPT ffn)
    alibi_bias_max: int = 8
    # Mixture-of-experts (Qwen2-MoE family — the reference's LlavaQwenMoe,
    # `language_model/llava_qwen_moe.py`; supports-but-never-trains). 0 = dense.
    # Every layer is sparse when enabled (the flagship MoE configs use
    # decoder_sparse_step=1 and empty mlp_only_layers).
    num_experts: int = 0
    num_experts_per_tok: int = 4
    moe_intermediate_size: int = 0
    shared_expert_intermediate_size: int = 0
    norm_topk_prob: bool = False
    # 0 -> exact dense-combine (eval/parity); >0 -> GShard-style capacity
    # dispatch (training/EP: tokens over capacity are dropped, the standard
    # sparse-training recipe).
    moe_capacity_factor: float = 0.0
    router_aux_coef: float = 0.001

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


def qwen2_7b() -> Qwen2Config:
    return Qwen2Config()


def llama3_8b() -> Qwen2Config:
    """Llama-3.1-8B-Instruct widths (the reference's llava_llama family)."""
    return Qwen2Config(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=500_000.0,
        rope_scaling=8.0,
        rope_scaling_type="llama3",
        rope_low_freq_factor=1.0,
        rope_high_freq_factor=4.0,
        rope_original_max_position=8192,
        rms_norm_eps=1e-5,
        attention_bias=False,
        max_position_embeddings=131072,
    )


def mistral_7b() -> Qwen2Config:
    """Mistral-7B-Instruct widths (the reference's llava_mistral family)."""
    return Qwen2Config(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=10000.0,
        rms_norm_eps=1e-5,
        attention_bias=False,
        sliding_window=4096,
        max_position_embeddings=32768,
    )


def mixtral_8x7b() -> Qwen2Config:
    """Mixtral-8x7B widths (the reference's llava_mixtral family,
    `language_model/llava_mixtral.py`): Mistral attention + every-layer
    8-expert top-2 sparse MoE with renormalized top-k weights and no shared
    expert (HF `MixtralSparseMoeBlock`)."""
    return Qwen2Config(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1e6,
        rms_norm_eps=1e-5,
        attention_bias=False,
        max_position_embeddings=32768,
        num_experts=8,
        num_experts_per_tok=2,
        moe_intermediate_size=14336,
        shared_expert_intermediate_size=0,
        norm_topk_prob=True,
    )


def gemma_2b() -> Qwen2Config:
    """Gemma-2B widths (the reference's llava_gemma family): MQA with
    head_dim 256, GeGLU MLP, (1+w) RMSNorm, sqrt(d)-scaled embeddings,
    tied lm_head."""
    return Qwen2Config(
        vocab_size=256000,
        hidden_size=2048,
        intermediate_size=16384,
        num_layers=18,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        rope_theta=10000.0,
        rms_norm_eps=1e-6,
        attention_bias=False,
        tie_word_embeddings=True,
        hidden_act="gelu_tanh",
        rms_norm_offset=True,
        embed_normalizer=True,
        max_position_embeddings=8192,
    )


def mpt_7b() -> Qwen2Config:
    """MPT-7B widths (the reference's llava_mpt family): MHA with ALiBi,
    weight-only LayerNorm, non-gated exact-GELU MLP (expansion 4x), tied
    lm_head, no biases anywhere."""
    return Qwen2Config(
        vocab_size=50432,
        hidden_size=4096,
        intermediate_size=16384,
        num_layers=32,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        rms_norm_eps=1e-5,
        attention_bias=False,
        tie_word_embeddings=True,
        hidden_act="gelu",
        pos_embedding="alibi",
        norm_kind="layernorm",
        mlp_gated=False,
        max_position_embeddings=2048,
    )


def qwen2_0_5b() -> Qwen2Config:
    return Qwen2Config(
        vocab_size=151936,
        hidden_size=896,
        intermediate_size=4864,
        num_layers=24,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        tie_word_embeddings=True,
    )


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    """Multimodal projector config.

    `kind` mirrors the vocabulary of the reference's projector factory
    (its `multimodal_projector` package): "linear", "mlp{N}x_gelu", "identity",
    "pooler". RadVLM uses mlp2x_gelu (`finetune_radio_7b.sh:54`).
    """

    kind: str = "mlp2x_gelu"
    # Pooler settings (only used when kind == "pooler").
    pooler_stride: int = 2

    @property
    def mlp_depth(self) -> int:
        if self.kind.startswith("mlp") and self.kind.endswith("x_gelu"):
            return int(self.kind[3:].split("x")[0])
        if self.kind == "linear":
            return 1
        return 0


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    """Vision-token resampler config (the reference's `multimodal_resampler` factory).

    kinds: "identity" (RadVLM flagship), "spatial_pool" (stride-pooled grid),
    "perceiver" (Flamingo-style learned-latent cross-attention,
    `multimodal_resampler/perceiver.py`), "masked_drop" (training-time random
    token dropping, `multimodal_resampler/masked_drop.py`).
    """

    kind: str = "identity"
    # spatial_pool settings (reference mm_spatial_pool_stride/mode)
    stride: int = 2
    mode: str = "average"  # "average" | "max"
    # perceiver settings (reference mm_perceiver_depth/latents/ff_mult)
    depth: int = 3
    num_latents: int = 32
    num_heads: int = 8
    head_dim: int = 64
    ff_mult: int = 4
    # masked_drop settings (reference mm_mask_drop_ratio)
    drop_ratio: float = 0.25
    # qformer settings (BLIP-2 query transformer, `multimodal_resampler/
    # qformer.py:1102-1133`): bert-base trunk, num_latents query tokens,
    # cross-attention every `depth` layers (the reference's mm_qformer_depth
    # IS the cross_attention_freq — build_Qformer call at qformer.py:1110).
    qformer_layers: int = 12
    qformer_hidden: int = 768
    qformer_heads: int = 12
    qformer_intermediate: int = 3072
    qformer_eps: float = 1e-12

    @property
    def spatial(self) -> bool:
        """Whether the output preserves a square spatial grid (required for
        anyres unpad/newline merging)."""
        return self.kind in ("identity", "spatial_pool", "masked_drop")


@dataclasses.dataclass(frozen=True)
class AnyResConfig:
    """AnyRes tiling policy (reference `mm_utils.py:119-293`, `llava_arch.py:350-406`).

    `grid_pinpoints` are (cols, rows) tile-grid candidates, multiplied by the tile
    size.  `max_tiles` caps how many grid tiles a single image may produce (base tile
    excluded); `anyres_max_tokens` is the reference's `anyres_max_N` post-merge token
    budget applied via bilinear downscaling (`llava_arch.py:381-392`).
    """

    tile_size: int = 384
    grid_range: Tuple[int, int] = (1, 6)  # expands to (1x1)..(6x6)
    anyres_max: int = 9  # anyres_max_9
    newline: bool = True  # spatial_unpad with image_newline rows

    @property
    def pinpoints(self) -> Tuple[Tuple[int, int], ...]:
        lo, hi = self.grid_range
        return tuple(
            (i * self.tile_size, j * self.tile_size)
            for i in range(lo, hi + 1)
            for j in range(lo, hi + 1)
        )

    @property
    def max_grid_tiles(self) -> int:
        # Largest usable grid subject to the anyres_max budget. With anyres_max_9 the
        # training data never exceeds ~10 tiles incl. base, but pinpoints themselves
        # go to 36; the selected resolution can still be e.g. 6x6. Token capping then
        # downscales post-merge. So the raw tile budget is hi*hi.
        hi = self.grid_range[1]
        return hi * hi


@dataclasses.dataclass(frozen=True)
class RadVLMConfig:
    """Full VLM config: vision tower + projector + LLM + anyres policy."""

    vision: SigLIPConfig = dataclasses.field(default_factory=SigLIPConfig)
    text: Qwen2Config = dataclasses.field(default_factory=qwen2_7b)
    projector: ProjectorConfig = dataclasses.field(default_factory=ProjectorConfig)
    anyres: AnyResConfig = dataclasses.field(default_factory=AnyResConfig)
    resampler: ResamplerConfig = dataclasses.field(default_factory=ResamplerConfig)
    # "anyres_max_9" | "anyres" | "pad" | "square"
    image_aspect_ratio: str = "anyres_max_9"

    def __post_init__(self):
        if self.image_aspect_ratio.startswith("anyres") and not self.resampler.spatial:
            raise ValueError(
                f"resampler {self.resampler.kind!r} destroys the spatial grid; "
                "anyres unpad/newline merging requires a spatial resampler — "
                "use image_aspect_ratio='pad' or 'square'"
            )


def radvlm_7b() -> RadVLMConfig:
    return RadVLMConfig()


def radvlm_0_5b() -> RadVLMConfig:
    return RadVLMConfig(text=qwen2_0_5b())


def tiny_test_config(vocab_size: int = 512) -> RadVLMConfig:
    """A miniature config for unit tests (fast CPU forward, real code paths)."""
    return RadVLMConfig(
        vision=SigLIPConfig(
            hidden_size=32,
            intermediate_size=64,
            num_layers=2,
            num_heads=2,
            image_size=56,
            patch_size=14,
        ),
        text=Qwen2Config(
            vocab_size=vocab_size,
            hidden_size=48,
            intermediate_size=96,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=12,
            tie_word_embeddings=False,
            max_position_embeddings=2048,
        ),
        anyres=AnyResConfig(tile_size=56, grid_range=(1, 6), anyres_max=9),
    )


def tokens_per_tile(cfg) -> int:
    """Image tokens per tile that the LLM sees, after the resampler (729 for
    SigLIP-384/14 with the identity resampler)."""
    from radvlm_tpu_torch.models.resampler import output_tokens

    return output_tokens(cfg.resampler, cfg.vision.tokens_per_tile)


def feature_grid_side(cfg) -> int:
    """Side of the per-tile feature grid after resampling (spatial kinds)."""
    return math.isqrt(tokens_per_tile(cfg))
