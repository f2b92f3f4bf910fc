"""HF checkpoint import: a safetensors directory -> a `RadVLM` module
(counterpart of `radvlm_tpu/models/hf_import.py`, the dense rope decoder
family with a SigLIP tower).

Accepts either naming scheme:

- the original LLaVA-OneVision training layout: `model.layers.*`,
  `model.vision_tower.vision_tower.vision_model.*`, `model.mm_projector.{0,2}.*`,
  `model.image_newline`, `lm_head.weight`;
- the converted HF `LlavaOnevisionForConditionalGeneration` layout:
  `language_model.model.layers.*` (or `model.language_model.layers.*` in
  newer transformers), `vision_tower.vision_model.*`,
  `multi_modal_projector.linear_{1,2}.*`, `image_newline`;
- a plain Qwen2 / Llama checkpoint (`model.*`, `lm_head.*`).

HF linear weights are [out, in], torch's own layout, so a parameter is one
copy into the module on its device (the JAX package transposes and stacks);
the conv patch embedding [D, 3, p, p] becomes the patchify-matmul weight
[D, p*p*3] in (ph, pw, C) order. The files are memory-mapped
(`models/safetensors_io.py`): no `safetensors` package is needed. Not ported
(they raise NotImplementedError naming ROADMAP M10): MoE and MPT decoders,
CLIP / EVA / ImageBind towers; a Q-Former resampler is refused by
`RadVLM` itself.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping

import torch

from radvlm_tpu_torch.config import AnyResConfig, Qwen2Config, RadVLMConfig, SigLIPConfig
from radvlm_tpu_torch.device import resolve
from radvlm_tpu_torch.models import qwen2, radvlm, siglip
from radvlm_tpu_torch.models.projector import Projector
from radvlm_tpu_torch.models.safetensors_io import read_dir

State = Mapping[str, torch.Tensor]


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every `*.safetensors` file under `path` as one flat dict of
    memory-mapped CPU tensors."""
    return read_dir(path)


def normalize_keys(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Map either checkpoint layout onto canonical prefixes.

    Canonical: `text.layers.N.*`, `text.embed_tokens.weight`, `text.norm.weight`,
    `text.lm_head.weight`, `vision.*` (HF SigLIP names below vision_model),
    `projector.fc{0,1}.*`, `image_newline`.
    """
    out: Dict[str, Any] = {}
    for k, v in state.items():
        nk = k
        # --- original LLaVA-OV training layout ---
        nk = nk.replace("model.vision_tower.vision_tower.vision_model.", "vision.")
        nk = nk.replace("model.vision_tower.vision_tower.", "")
        nk = nk.replace("model.vision_resampler.", "vision_resampler.")
        nk = nk.replace("model.mm_projector.0.", "projector.fc0.")
        nk = nk.replace("model.mm_projector.2.", "projector.fc1.")
        nk = nk.replace("model.image_newline", "image_newline")
        # --- converted HF layout (two transformers generations) ---
        nk = nk.replace("model.language_model.layers.", "text.layers.")
        nk = nk.replace("model.language_model.embed_tokens.", "text.embed_tokens.")
        nk = nk.replace("model.language_model.norm.", "text.norm.")
        nk = nk.replace("language_model.model.", "text.")
        nk = nk.replace("language_model.lm_head.", "text.lm_head.")
        nk = nk.replace("model.vision_tower.vision_model.", "vision.")
        nk = nk.replace("vision_tower.vision_model.", "vision.")
        nk = nk.replace("model.multi_modal_projector.linear_1.", "projector.fc0.")
        nk = nk.replace("model.multi_modal_projector.linear_2.", "projector.fc1.")
        nk = nk.replace("multi_modal_projector.linear_1.", "projector.fc0.")
        nk = nk.replace("multi_modal_projector.linear_2.", "projector.fc1.")
        # --- plain Qwen2 / plain HF model ---
        nk = re.sub(r"^model\.", "text.", nk)
        nk = re.sub(r"^lm_head\.", "text.lm_head.", nk)
        # strip leading vision_model. when importing a bare SigLIP tower
        nk = re.sub(r"^vision_model\.", "vision.", nk)
        out[nk] = v
    return out


def _put(param: torch.Tensor, value: torch.Tensor) -> None:
    """One checkpoint tensor -> a parameter (cast to its dtype on its device,
    round to nearest even as the JAX importer's cast)."""
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape mismatch: {tuple(value.shape)} -> {tuple(param.shape)}")
    param.data.copy_(value.to(param.device))


def _put_linear(lin, state: State, prefix: str) -> None:
    _put(lin.weight, state[prefix + ".weight"])
    if lin.bias is not None:
        _put(lin.bias, state[prefix + ".bias"])


@torch.no_grad()
def import_qwen2(state: State, model: qwen2.Qwen2Decoder) -> None:
    """Canonical-key state dict -> the (unfused) decoder's parameters."""
    _put(model.embed, state["text.embed_tokens.weight"])
    _put(model.norm, state["text.norm.weight"])
    if model.lm_head is not None:
        # A checkpoint without an lm_head under an untied config cannot be
        # served: the JAX importer leaves the key out and fails later.
        _put(model.lm_head.weight, state["text.lm_head.weight"])
    for i, blk in enumerate(model.layers):
        p = f"text.layers.{i}."
        _put(blk.ln1, state[p + "input_layernorm.weight"])
        _put(blk.ln2, state[p + "post_attention_layernorm.weight"])
        for name in ("q", "k", "v", "o"):
            _put_linear(getattr(blk, name), state, p + f"self_attn.{name}_proj")
        for name in ("gate", "up", "down"):
            _put_linear(getattr(blk, name), state, p + f"mlp.{name}_proj")


@torch.no_grad()
def import_siglip(state: State, tower: siglip.SigLIPTower) -> None:
    """Canonical-key state dict -> the (unfused) tower's parameters.

    Imports only the encoder layers the tower has, the first
    `cfg.num_layers` (the drop-last-layer policy). The patch conv kernel [D, 3, p, p] becomes the matmul
    weight [D, p*p*3] matching `siglip.patchify`'s (ph, pw, C) order."""
    conv_w = state["vision.embeddings.patch_embedding.weight"]  # [D, C, p, p]
    d = conv_w.shape[0]
    _put(tower.patch_embed.weight, conv_w.permute(0, 2, 3, 1).reshape(d, -1))
    _put(tower.patch_embed.bias, state["vision.embeddings.patch_embedding.bias"])
    _put(tower.pos_embed, state["vision.embeddings.position_embedding.weight"])
    if "vision.post_layernorm.weight" in state:
        _put(tower.post_ln_scale, state["vision.post_layernorm.weight"])
    else:
        tower.post_ln_scale.fill_(1.0)
    if "vision.post_layernorm.bias" in state:
        _put(tower.post_ln_bias, state["vision.post_layernorm.bias"])
    else:
        tower.post_ln_bias.zero_()
    for i, layer in enumerate(tower.layers):
        p = f"vision.encoder.layers.{i}."
        _put(layer.ln1_scale, state[p + "layer_norm1.weight"])
        _put(layer.ln1_bias, state[p + "layer_norm1.bias"])
        _put(layer.ln2_scale, state[p + "layer_norm2.weight"])
        _put(layer.ln2_bias, state[p + "layer_norm2.bias"])
        for name, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            _put_linear(getattr(layer, name), state, p + f"self_attn.{hf}")
        _put_linear(layer.fc1, state, p + "mlp.fc1")
        _put_linear(layer.fc2, state, p + "mlp.fc2")


@torch.no_grad()
def import_projector(state: State, projector: Projector) -> None:
    for i, fc in enumerate(projector.fcs):
        _put_linear(fc, state, f"projector.fc{i}")


@torch.no_grad()
def import_radvlm(raw_state: Mapping[str, Any], model: radvlm.RadVLM) -> None:
    """Full VLM import from either checkpoint layout into `model`."""
    state = normalize_keys(raw_state)
    import_siglip(state, model.vision_tower)
    import_projector(state, model.projector)
    import_qwen2(state, model.text)
    if "image_newline" in state:
        _put(model.image_newline, state["image_newline"])
    else:
        model.image_newline.zero_()


def load_radvlm_checkpoint(path: str, cfg: RadVLMConfig, device=None,
                           dtype=torch.bfloat16) -> radvlm.RadVLM:
    """Load a safetensors checkpoint directory into an unfused `RadVLM` on
    `device` (None: the card) in `dtype`."""
    model = radvlm.RadVLM(cfg, device=resolve(device), dtype=dtype)
    import_radvlm(load_safetensors_dir(path), model)
    return model


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported (ROADMAP M10)")


def config_from_hf_dir(path: str) -> RadVLMConfig:
    """Build a RadVLMConfig from an HF config.json (both layouts), for the
    Qwen2 / Llama / Mistral / Gemma decoder family with a SigLIP tower."""
    with open(os.path.join(path, "config.json")) as f:
        data = json.load(f)
    text_cfg = data.get("text_config", data)
    vis_cfg = data.get("vision_config", {})
    model_type = text_cfg.get("model_type", "qwen2")
    if text_cfg.get("num_experts") or text_cfg.get("num_local_experts"):
        raise _not_ported("a MoE decoder (qwen2_moe / mixtral)")
    if model_type == "mpt":
        raise _not_ported("the MPT decoder family")
    if vis_cfg.get("model_type") == "clip_vision_model":
        raise _not_ported("the CLIP vision tower")
    rope_kwargs = {}
    rope = text_cfg.get("rope_scaling")
    if isinstance(rope, dict):
        rtype = rope.get("rope_type", rope.get("type", "linear"))
        if rtype == "llama3":
            rope_kwargs = dict(
                rope_scaling=rope.get("factor", 8.0),
                rope_scaling_type="llama3",
                rope_low_freq_factor=rope.get("low_freq_factor", 1.0),
                rope_high_freq_factor=rope.get("high_freq_factor", 4.0),
                rope_original_max_position=rope.get("original_max_position_embeddings", 8192),
            )
        elif rtype == "linear":
            rope_kwargs = dict(rope_scaling=rope.get("factor", 1.0))
    family_kwargs = {}
    if model_type == "mistral":
        family_kwargs = dict(sliding_window=text_cfg.get("sliding_window") or 0)
    elif model_type == "gemma":
        family_kwargs = dict(hidden_act="gelu_tanh", rms_norm_offset=True, embed_normalizer=True)
    text = Qwen2Config(
        attention_bias=text_cfg.get(
            "attention_bias", model_type not in ("llama", "mistral", "mixtral", "gemma")),
        **rope_kwargs,
        **family_kwargs,
        vocab_size=text_cfg.get("vocab_size", 152064),
        hidden_size=text_cfg.get("hidden_size", 3584),
        intermediate_size=text_cfg.get("intermediate_size", 18944),
        num_layers=text_cfg.get("num_hidden_layers", 28),
        num_heads=text_cfg.get("num_attention_heads", 28),
        num_kv_heads=text_cfg.get("num_key_value_heads", 4),
        head_dim=text_cfg.get(
            "head_dim",
            text_cfg.get("hidden_size", 3584) // text_cfg.get("num_attention_heads", 28)),
        rope_theta=text_cfg.get("rope_theta", 1e6),
        rms_norm_eps=text_cfg.get("rms_norm_eps", 1e-6),
        tie_word_embeddings=text_cfg.get("tie_word_embeddings", False),
        max_position_embeddings=text_cfg.get("max_position_embeddings", 32768),
    )
    vision = SigLIPConfig(
        hidden_size=vis_cfg.get("hidden_size", 1152),
        intermediate_size=vis_cfg.get("intermediate_size", 4304),
        num_layers=vis_cfg.get("num_hidden_layers", 26),
        num_heads=vis_cfg.get("num_attention_heads", 16),
        image_size=vis_cfg.get("image_size", 384),
        patch_size=vis_cfg.get("patch_size", 14),
    )
    # Anyres policy from the HF fields (`image_grid_pinpoints` lists (height,
    # width) pixel candidates = grid cells x tile size; `vision_aspect_ratio`
    # carries the anyres_max_N token cap).
    tile = vision.image_size
    kwargs = {}
    grid = (1, 6)
    anyres_max = 9
    pinpoints = data.get("image_grid_pinpoints")
    if pinpoints:
        grid = (1, max(max(max(p) for p in pinpoints) // tile, 1))
    aspect = data.get("vision_aspect_ratio", data.get("image_aspect_ratio"))
    if isinstance(aspect, str):
        m = re.match(r"anyres_max_(\d+)", aspect)
        if m:
            anyres_max = int(m.group(1))
        kwargs["image_aspect_ratio"] = (
            aspect if aspect.startswith("anyres") or aspect in ("pad", "square")
            else "anyres_max_9"
        )
    anyres = AnyResConfig(tile_size=tile, grid_range=grid, anyres_max=anyres_max)
    return RadVLMConfig(vision=vision, text=text, anyres=anyres, **kwargs)
