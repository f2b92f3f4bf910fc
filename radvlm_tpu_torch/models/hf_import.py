"""HF checkpoint import: a safetensors directory -> a `RadVLM` module
(counterpart of `radvlm_tpu/models/hf_import.py`, every decoder family of
`models/qwen2.py` with each tower kind, and the Q-Former resampler).

Accepts either naming scheme:

- the original LLaVA-OneVision training layout: `model.layers.*`,
  `model.vision_tower.vision_tower.vision_model.*`, `model.mm_projector.{0,2}.*`,
  `model.image_newline`, `lm_head.weight`;
- the converted HF `LlavaOnevisionForConditionalGeneration` layout:
  `language_model.model.layers.*` (or `model.language_model.layers.*` in
  newer transformers), `vision_tower.vision_model.*`,
  `multi_modal_projector.linear_{1,2}.*`, `image_newline`;
- a plain Qwen2 / Llama checkpoint (`model.*`, `lm_head.*`);
- a plain MPT checkpoint (`transformer.wte` / `blocks` / `norm_f`);
- in either LLaVA layout, a Qwen2-MoE decoder (`mlp.gate` router,
  `mlp.experts.{e}.*_proj`, the shared expert and its gate) or a Mixtral
  one (`block_sparse_moe.gate`, `block_sparse_moe.experts.{e}.w1|w3|w2`).

HF linear weights are [out, in], torch's own layout, so a parameter is one
copy into the module on its device (the JAX package transposes and stacks);
the conv patch embedding [D, 3, p, p] becomes the patchify-matmul weight
[D, p*p*3] in (ph, pw, C) order; MPT's fused `Wqkv` [3d, d] splits by
rows into q, k and v; an expert's [out, in] weight is transposed into its
[E, in, out] table. The towers: HF CLIP (`vision.*` after
`normalize_keys`), open_clip (`visual.*`, fused in_proj split by rows),
ImageBind (`modality_*.vision.*`, the Conv3d stem's taps summed) and EVA
(`visual.*` or bare); the Q-Former from `vision_resampler.*`. The module
built from the config says which importer reads the checkpoint. The files
are memory-mapped (`models/safetensors_io.py`): no `safetensors` package is
needed.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping

import torch

from radvlm_tpu_torch.config import AnyResConfig, Qwen2Config, RadVLMConfig, SigLIPConfig
from radvlm_tpu_torch.device import resolve
from torch import nn

from radvlm_tpu_torch.models import clip, eva, imagebind, qwen2, radvlm, resampler, siglip
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
        # --- MPT (HF MptForCausalLM: transformer.wte/blocks/norm_f) ---
        nk = nk.replace("transformer.wte.weight", "text.embed_tokens.weight")
        nk = nk.replace("transformer.norm_f.weight", "text.norm.weight")
        nk = nk.replace("transformer.blocks.", "text.layers.")
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
    """Canonical-key state dict -> the (unfused) decoder's parameters. The
    module says the layout: an MoE block has `moe`, MPT's has no `gate`."""
    _put(model.embed, state["text.embed_tokens.weight"])
    _put(model.norm, state["text.norm.weight"])
    if model.lm_head is not None:
        # A checkpoint without an lm_head under an untied config cannot be
        # served: the JAX importer leaves the key out and fails later.
        _put(model.lm_head.weight, state["text.lm_head.weight"])
    blk0 = model.layers[0]
    if not hasattr(blk0, "gate") and not hasattr(blk0, "moe"):
        _import_mpt(state, model)
        return
    for i, blk in enumerate(model.layers):
        p = f"text.layers.{i}."
        _put(blk.ln1, state[p + "input_layernorm.weight"])
        _put(blk.ln2, state[p + "post_attention_layernorm.weight"])
        for name in ("q", "k", "v", "o"):
            _put_linear(getattr(blk, name), state, p + f"self_attn.{name}_proj")
        if hasattr(blk, "moe"):
            _import_moe_mlp(state, blk.moe, p)
            continue
        for name in ("gate", "up", "down"):
            _put_linear(getattr(blk, name), state, p + f"mlp.{name}_proj")


def _import_mpt(state: State, model: qwen2.Qwen2Decoder) -> None:
    """MPT (HF MptForCausalLM): the fused Wqkv [3d, d] split by rows into
    q / k / v, no biases, weight-only LayerNorms, the non-gated ffn; the
    lm_head is tied to the embedding."""
    for i, blk in enumerate(model.layers):
        p = f"text.layers.{i}."
        _put(blk.ln1, state[p + "norm_1.weight"])
        _put(blk.ln2, state[p + "norm_2.weight"])
        q, k, v = state[p + "attn.Wqkv.weight"].chunk(3, dim=0)
        for lin, w in ((blk.q, q), (blk.k, k), (blk.v, v)):
            _put(lin.weight, w)
        _put(blk.o.weight, state[p + "attn.out_proj.weight"])
        _put(blk.up.weight, state[p + "ffn.up_proj.weight"])
        _put(blk.down.weight, state[p + "ffn.down_proj.weight"])


def _import_moe_mlp(state: State, moe: qwen2.MoE, p: str) -> None:
    """One layer's sparse MoE block. The two HF layouts, told apart by the
    router's key: Qwen2MoeForCausalLM (`mlp.gate`, `mlp.experts.{e}.
    {gate,up,down}_proj`, `mlp.shared_expert.*` and `mlp.shared_expert_gate`)
    and MixtralForCausalLM (`block_sparse_moe.gate`, `block_sparse_moe.
    experts.{e}.{w1,w3,w2}`: gate, up, down; no shared expert)."""
    mixtral = p + "block_sparse_moe.gate.weight" in state
    moe_p = p + ("block_sparse_moe." if mixtral else "mlp.")
    names = ("w1", "w3", "w2") if mixtral else ("gate_proj", "up_proj", "down_proj")
    _put(moe.router.weight, state[moe_p + "gate.weight"])
    for table, name in zip((moe.gate, moe.up, moe.down), names):
        for e in range(table.shape[0]):
            _put(table[e], state[f"{moe_p}experts.{e}.{name}.weight"].t())
    if moe.shared is not None:
        for name in ("gate", "up", "down"):
            _put_linear(getattr(moe.shared, name), state, p + f"mlp.shared_expert.{name}_proj")
        _put(moe.shared_gate.weight, state[p + "mlp.shared_expert_gate.weight"])


def _put_named(mod, state: State, names: Mapping[str, str], prefix: str = "") -> None:
    """Module attribute -> checkpoint name under `prefix`: a linear takes
    `<name>.weight` (and `<name>.bias` where it has one), a parameter the
    tensor `<name>` itself; attributes the module holds as None are skipped."""
    for attr, key in names.items():
        target = getattr(mod, attr, None)
        if target is None:
            continue
        if isinstance(target, nn.Module):
            _put_linear(target, state, prefix + key)
        else:
            _put(target, state[prefix + key])


def _patch_weight(conv_w: torch.Tensor) -> torch.Tensor:
    """Patch conv kernel [D, C, p, p] -> the patchify-matmul weight
    [D, p*p*C] in (ph, pw, C) order."""
    return conv_w.permute(0, 2, 3, 1).reshape(conv_w.shape[0], -1)


def _put_fused_qkv(layer, w: torch.Tensor, b=None) -> None:
    """A fused [3D, D] projection (and [3D] bias), q / k / v by rows."""
    d = w.shape[0] // 3
    for i, lin in enumerate((layer.q, layer.k, layer.v)):
        _put(lin.weight, w[i * d:(i + 1) * d])
        if b is not None:
            _put(lin.bias, b[i * d:(i + 1) * d])


_HF_VIT_LAYER = {"ln1_scale": "layer_norm1.weight", "ln1_bias": "layer_norm1.bias",
                 "ln2_scale": "layer_norm2.weight", "ln2_bias": "layer_norm2.bias",
                 "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                 "o": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


@torch.no_grad()
def import_siglip(state: State, tower: siglip.SigLIPTower) -> None:
    """Canonical-key state dict -> the (unfused) tower's parameters.

    Imports only the encoder layers the tower has, the first
    `cfg.num_layers` (the drop-last-layer policy). The patch conv kernel
    [D, 3, p, p] becomes the matmul weight [D, p*p*3] matching
    `siglip.patchify`'s (ph, pw, C) order."""
    conv_w = state["vision.embeddings.patch_embedding.weight"]
    _put(tower.patch_embed.weight, _patch_weight(conv_w))
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
        _put_named(layer, state, _HF_VIT_LAYER, f"vision.encoder.layers.{i}.")


@torch.no_grad()
def import_clip(state: State, tower: clip.CLIPTower) -> None:
    """Canonical-key HF CLIPVisionModel state dict -> the tower: the patch
    conv without bias, class_embedding, positions over cls + patches,
    pre_layrnorm, and the first `num_layers` encoder layers (select_layer=-2
    runs 23 of ViT-L's 24)."""
    conv_w = state["vision.embeddings.patch_embedding.weight"]
    _put(tower.patch_embed.weight, _patch_weight(conv_w))
    _put_named(tower, state, {"class_embed": "embeddings.class_embedding",
                              "pos_embed": "embeddings.position_embedding.weight",
                              "pre_ln_scale": "pre_layrnorm.weight",
                              "pre_ln_bias": "pre_layrnorm.bias"}, "vision.")
    for i, layer in enumerate(tower.layers):
        _put_named(layer, state, _HF_VIT_LAYER, f"vision.encoder.layers.{i}.")


@torch.no_grad()
def import_open_clip(state: State, tower: clip.CLIPTower) -> None:
    """open_clip `visual.*` state dict -> the CLIP tower: `conv1` (no bias),
    raw `class_embedding` / `positional_embedding`, `ln_pre`, resblocks with
    torch MultiheadAttention's fused `in_proj_weight` / `in_proj_bias` (q, k,
    v by rows) and `out_proj`, the MLP as `c_fc` / `c_proj`."""
    _put(tower.patch_embed.weight, _patch_weight(state["visual.conv1.weight"]))
    _put_named(tower, state, {"class_embed": "class_embedding",
                              "pos_embed": "positional_embedding",
                              "pre_ln_scale": "ln_pre.weight", "pre_ln_bias": "ln_pre.bias"},
               "visual.")
    for i, layer in enumerate(tower.layers):
        p = f"visual.transformer.resblocks.{i}."
        _put_fused_qkv(layer, state[p + "attn.in_proj_weight"], state[p + "attn.in_proj_bias"])
        _put_named(layer, state, {"ln1_scale": "ln_1.weight", "ln1_bias": "ln_1.bias",
                                  "ln2_scale": "ln_2.weight", "ln2_bias": "ln_2.bias",
                                  "o": "attn.out_proj", "fc1": "mlp.c_fc", "fc2": "mlp.c_proj"}, p)


@torch.no_grad()
def import_imagebind(state: State, tower: imagebind.ImageBindTower) -> None:
    """The public ImageBind checkpoint's vision branch -> the tower:
    `modality_preprocessors.vision` (cls_token, the Conv3d stem collapsed to
    the still-image patch matmul, pos_embed), `modality_trunks.vision`
    (pre_transformer_layer.0, blocks with fused in_proj), and
    `modality_heads.vision` (0: LayerNorm, 2: Linear without bias)."""
    pre, trunk, head = ("modality_preprocessors.vision.", "modality_trunks.vision.",
                        "modality_heads.vision.")
    d = tower.class_embed.shape[0]
    stem = state[pre + "rgbt_stem.proj.1.weight"]  # [D, C, T, p, p]: the taps sum
    _put(tower.patch_embed.weight, _patch_weight(stem.sum(dim=2)))
    _put(tower.class_embed, state[pre + "cls_token"].reshape(-1))
    _put(tower.pos_embed, state[pre + "pos_embedding_helper.pos_embed"].reshape(-1, d))
    _put_named(tower, state, {"pre_ln_scale": trunk + "pre_transformer_layer.0.weight",
                              "pre_ln_bias": trunk + "pre_transformer_layer.0.bias",
                              "head_ln_scale": head + "0.weight", "head_ln_bias": head + "0.bias",
                              "head_proj": head + "2"})
    for i, layer in enumerate(tower.layers):
        p = f"{trunk}blocks.{i}."
        _put_fused_qkv(layer, state[p + "attn.in_proj_weight"], state[p + "attn.in_proj_bias"])
        _put_named(layer, state, {"ln1_scale": "norm_1.weight", "ln1_bias": "norm_1.bias",
                                  "ln2_scale": "norm_2.weight", "ln2_bias": "norm_2.bias",
                                  "o": "attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}, p)


@torch.no_grad()
def import_eva(state: State, tower: eva.EVATower) -> None:
    """An `EVAVisionTransformer` state dict (with or without the CLIP
    `visual.` prefix) -> the tower. subln towers store q / k / v apart
    (bias-free weights; `q_bias` / `v_bias` alone), the others one fused
    `qkv.weight` [3D, D]; `inner_attn_ln` / `ffn_ln` (subln), SwiGLU
    w1 / w2 / w3 or fc1 / fc2, weight-only RMS norms and layerscale gammas
    are read where the tower has them."""
    state = {(k[len("visual."):] if k.startswith("visual.") else k): v for k, v in state.items()}
    d = tower.class_embed.shape[0]
    _put(tower.patch_embed.weight, _patch_weight(state["patch_embed.proj.weight"]))
    _put(tower.patch_embed.bias, state["patch_embed.proj.bias"])
    _put(tower.class_embed, state["cls_token"].reshape(-1))
    _put(tower.pos_embed, state["pos_embed"].reshape(-1, d))
    names = {"ln1_scale": "norm1.weight", "ln1_bias": "norm1.bias",
             "ln2_scale": "norm2.weight", "ln2_bias": "norm2.bias", "o": "attn.proj",
             "inner_ln_scale": "attn.inner_attn_ln.weight",
             "inner_ln_bias": "attn.inner_attn_ln.bias",
             "w1": "mlp.w1", "w2": "mlp.w2", "w3": "mlp.w3", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
             "ffn_ln_scale": "mlp.ffn_ln.weight", "ffn_ln_bias": "mlp.ffn_ln.bias",
             "gamma_1": "gamma_1", "gamma_2": "gamma_2"}
    for i, layer in enumerate(tower.layers):
        p = f"blocks.{i}."
        if p + "attn.qkv.weight" in state:
            _put_fused_qkv(layer, state[p + "attn.qkv.weight"])
        else:
            for name in ("q", "k", "v"):
                _put(getattr(layer, name).weight, state[p + f"attn.{name}_proj.weight"])
        if layer.q.bias is not None:
            _put(layer.q.bias, state[p + "attn.q_bias"])
            _put(layer.v.bias, state[p + "attn.v_bias"])
        _put_named(layer, state, names, p)


@torch.no_grad()
def import_qformer(state: State, module: resampler.QFormer) -> None:
    """A BLIP-2 Q-Former wrapper's state dict (`ln_vision.*`, `query_tokens`,
    `Qformer.bert.*`; the text path is absent) -> the `QFormer` module."""
    h = module.query_tokens.shape[-1]
    _put(module.query_tokens, state["query_tokens"].reshape(-1, h))
    _put_named(module, state, {"ln_vision_scale": "ln_vision.weight",
                               "ln_vision_bias": "ln_vision.bias",
                               "emb_ln_scale": "Qformer.bert.embeddings.LayerNorm.weight",
                               "emb_ln_bias": "Qformer.bert.embeddings.LayerNorm.bias"})
    names = {}
    for blk, hf in (("self", "attention"), ("cross", "crossattention")):
        names.update({f"{blk}_q": f"{hf}.self.query", f"{blk}_k": f"{hf}.self.key",
                      f"{blk}_v": f"{hf}.self.value", f"{blk}_out": f"{hf}.output.dense",
                      f"{blk}_ln_scale": f"{hf}.output.LayerNorm.weight",
                      f"{blk}_ln_bias": f"{hf}.output.LayerNorm.bias"})
    names.update(ffn_up="intermediate_query.dense", ffn_down="output_query.dense",
                 ffn_ln_scale="output_query.LayerNorm.weight",
                 ffn_ln_bias="output_query.LayerNorm.bias")
    for i, layer in enumerate(module.layers):
        _put_named(layer, state, names, f"Qformer.bert.encoder.layer.{i}.")


@torch.no_grad()
def import_projector(state: State, projector: Projector) -> None:
    for i, fc in enumerate(projector.fcs):
        _put_linear(fc, state, f"projector.fc{i}")


@torch.no_grad()
def import_radvlm(raw_state: Mapping[str, Any], model: radvlm.RadVLM) -> None:
    """Full VLM import from either checkpoint layout into `model`."""
    state = normalize_keys(raw_state)
    tower = model.vision_tower
    import_tower = {siglip.SigLIPTower: import_siglip, clip.CLIPTower: import_clip,
                    eva.EVATower: import_eva,
                    imagebind.ImageBindTower: import_imagebind}[type(tower)]
    import_tower(state, tower)
    if isinstance(model.resampler, resampler.QFormer):
        # The wrapper's weights sit under model.vision_resampler.* in the
        # reference's layout; a bare Q-Former checkpoint has them at the top.
        sub = {k[len("vision_resampler."):]: v for k, v in state.items()
               if k.startswith("vision_resampler.")}
        if not sub and "query_tokens" in state:
            sub = dict(state)
        if not sub:
            raise ValueError("config requests the qformer resampler but the checkpoint "
                             "has no vision_resampler.* weights")
        import_qformer(sub, model.resampler)
    elif model.resampler is not None:  # the perceiver
        raise ValueError("perceiver resampler checkpoints have no HF import layout (the "
                         "reference never ships one); load a training checkpoint instead")
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


def config_from_hf_dir(path: str) -> RadVLMConfig:
    """Build a RadVLMConfig from an HF config.json (both layouts): the
    Qwen2 / Llama / Mistral / Gemma / Qwen2-MoE / Mixtral / MPT decoders
    with a SigLIP tower."""
    with open(os.path.join(path, "config.json")) as f:
        data = json.load(f)
    text_cfg = data.get("text_config", data)
    vis_cfg = data.get("vision_config", {})
    model_type = text_cfg.get("model_type", "qwen2")
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
    moe_kwargs = {}
    if text_cfg.get("num_experts"):  # qwen2_moe
        moe_kwargs = dict(
            num_experts=text_cfg["num_experts"],
            num_experts_per_tok=text_cfg.get("num_experts_per_tok", 4),
            moe_intermediate_size=text_cfg.get("moe_intermediate_size", 0),
            shared_expert_intermediate_size=text_cfg.get("shared_expert_intermediate_size", 0),
            norm_topk_prob=text_cfg.get("norm_topk_prob", False),
        )
    elif text_cfg.get("num_local_experts"):  # mixtral
        # Every layer sparse, no shared expert, top-k weights always
        # renormalised (HF `MixtralSparseMoeBlock`), experts of
        # intermediate_size.
        moe_kwargs = dict(
            num_experts=text_cfg["num_local_experts"],
            num_experts_per_tok=text_cfg.get("num_experts_per_tok", 2),
            moe_intermediate_size=text_cfg.get("intermediate_size", 14336),
            shared_expert_intermediate_size=0,
            norm_topk_prob=True,
        )
    family_kwargs = {}
    if model_type in ("mistral", "mixtral"):
        family_kwargs = dict(sliding_window=text_cfg.get("sliding_window") or 0)
    elif model_type == "gemma":
        family_kwargs = dict(hidden_act="gelu_tanh", rms_norm_offset=True, embed_normalizer=True)
    if model_type == "mpt":
        # MPT's own vocabulary (d_model / n_heads / n_layers /
        # expansion_ratio / max_seq_len): MHA, ALiBi, weight-only LayerNorm,
        # a non-gated exact-GELU ffn, a tied lm_head.
        d = text_cfg.get("d_model", 4096)
        n_heads = text_cfg.get("n_heads", 32)
        attn_cfg = text_cfg.get("attn_config") or {}
        return _finish_config(data, Qwen2Config(
            vocab_size=text_cfg.get("vocab_size", 50432),
            hidden_size=d,
            intermediate_size=int(text_cfg.get("expansion_ratio", 4) * d),
            num_layers=text_cfg.get("n_layers", 32),
            num_heads=n_heads,
            num_kv_heads=n_heads,
            head_dim=d // n_heads,
            rms_norm_eps=text_cfg.get("layer_norm_epsilon", 1e-5),
            attention_bias=False,
            tie_word_embeddings=True,
            hidden_act="gelu",
            pos_embedding="alibi",
            norm_kind="layernorm",
            mlp_gated=False,
            alibi_bias_max=int(attn_cfg.get("alibi_bias_max", 8)),
            max_position_embeddings=text_cfg.get("max_seq_len", 2048),
        ), vis_cfg)
    text = Qwen2Config(
        attention_bias=text_cfg.get(
            "attention_bias", model_type not in ("llama", "mistral", "mixtral", "gemma")),
        **rope_kwargs,
        **moe_kwargs,
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
    return _finish_config(data, text, vis_cfg)


def _finish_config(data, text: Qwen2Config, vis_cfg) -> RadVLMConfig:
    """The shared tail of `config_from_hf_dir`: the tower (CLIP runs one
    layer fewer than it was trained with: select_layer=-2) and the anyres
    policy."""
    if vis_cfg.get("model_type") == "clip_vision_model":
        return _with_anyres(data, text, clip.CLIPVisionConfig(
            hidden_size=vis_cfg.get("hidden_size", 1024),
            intermediate_size=vis_cfg.get("intermediate_size", 4096),
            num_layers=vis_cfg.get("num_hidden_layers", 24) - 1,
            num_heads=vis_cfg.get("num_attention_heads", 16),
            image_size=vis_cfg.get("image_size", 336),
            patch_size=vis_cfg.get("patch_size", 14),
        ))
    return _with_anyres(data, text, SigLIPConfig(
        hidden_size=vis_cfg.get("hidden_size", 1152),
        intermediate_size=vis_cfg.get("intermediate_size", 4304),
        num_layers=vis_cfg.get("num_hidden_layers", 26),
        num_heads=vis_cfg.get("num_attention_heads", 16),
        image_size=vis_cfg.get("image_size", 384),
        patch_size=vis_cfg.get("patch_size", 14),
    ))


def _with_anyres(data, text: Qwen2Config, vision) -> RadVLMConfig:
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
