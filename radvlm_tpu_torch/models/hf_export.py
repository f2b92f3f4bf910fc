"""HF checkpoint export: an unfused dense `RadVLM` -> HF-layout safetensors
(counterpart of `radvlm_tpu/models/hf_export.py`: the same keys, values
and config.json).

The reverse of `models/hf_import.py`: a model trained here is written in the
converted HF `LlavaOnevisionForConditionalGeneration` layout
(`language_model.model.*`, `vision_tower.vision_model.*`,
`multi_modal_projector.linear_{1,2}.*`, `image_newline`), the decoder's MoE
layers in the Qwen2-MoE layout (`mlp.gate`, `mlp.experts.{e}.*_proj`, the
shared expert) or, without a shared expert, the Mixtral one
(`block_sparse_moe.gate`, `block_sparse_moe.experts.{e}.w1|w3|w2`), and an
MPT decoder on its own by `export_mpt` (HF MptForCausalLM).

A module's Linear weight [out, in] is HF's layout already: the values are
the parameters themselves, moved to the host; MPT's q / k / v re-fuse into
`Wqkv` by rows, an expert's [in, out] table row is transposed. Quantized
or fused models raise: an HF checkpoint holds the dense, unfused weights.

As in the JAX package: `export_radvlm` writes the decoder through
`export_qwen2` whatever the family (an MPT decoder raises there);
`save_radvlm_hf` names the text config `qwen2_moe` for any MoE decoder,
Mixtral included (its weights keep the Mixtral keys, which the importer
recognises); `save_safetensors` stores bf16 tensors as f32, which the JAX
package's numpy reader loads. The file is written by the port's own
`models/safetensors_io.py`: no `safetensors` package is needed.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.models import qwen2, radvlm, safetensors_io, siglip
from radvlm_tpu_torch.models.layers import Linear

State = Dict[str, torch.Tensor]


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


def _weight(lin) -> torch.Tensor:
    """A dense projection's weight [out, in], HF's layout."""
    if not isinstance(lin, Linear):
        raise ValueError(f"export takes dense weights, got {type(lin).__name__}: export the "
                         "model before quantizing it")
    return _host(lin.weight)


def _unfused(blocks, kind: str) -> None:
    if len(blocks) and hasattr(blocks[0], "qkv"):
        raise ValueError(f"export takes an unfused {kind}: load or build it with fuse=False")


def export_mpt(model: qwen2.Qwen2Decoder, prefix: str = "transformer.") -> State:
    """An MPT decoder in HF MptForCausalLM's layout: q / k / v re-fused into
    Wqkv, weight-only LayerNorms, the non-gated ffn; the lm_head is tied to
    wte. Round-trips bit for bit with `hf_import`'s MPT import."""
    _unfused(model.layers, "decoder")
    out: State = {prefix + "wte.weight": _host(model.embed)}
    for i, blk in enumerate(model.layers):
        p = f"{prefix}blocks.{i}."
        out[p + "norm_1.weight"] = _host(blk.ln1)
        out[p + "norm_2.weight"] = _host(blk.ln2)
        out[p + "attn.Wqkv.weight"] = torch.cat([_weight(blk.q), _weight(blk.k), _weight(blk.v)])
        out[p + "attn.out_proj.weight"] = _weight(blk.o)
        out[p + "ffn.up_proj.weight"] = _weight(blk.up)
        out[p + "ffn.down_proj.weight"] = _weight(blk.down)
    out[prefix + "norm_f.weight"] = _host(model.norm)
    return out


def export_qwen2(model: qwen2.Qwen2Decoder, prefix: str = "language_model.model.") -> State:
    """A rope-family decoder (dense, Qwen2-MoE or Mixtral) in the HF layout;
    an untied lm_head goes under the prefix without its `model.`."""
    _unfused(model.layers, "decoder")
    out: State = {prefix + "embed_tokens.weight": _host(model.embed)}
    for i, blk in enumerate(model.layers):
        p = f"{prefix}layers.{i}."
        out[p + "input_layernorm.weight"] = _host(blk.ln1)
        out[p + "post_attention_layernorm.weight"] = _host(blk.ln2)
        for name in ("q", "k", "v"):
            lin = getattr(blk, name)
            out[p + f"self_attn.{name}_proj.weight"] = _weight(lin)
            if lin.bias is not None:  # absent for the Llama family
                out[p + f"self_attn.{name}_proj.bias"] = _host(lin.bias)
        out[p + "self_attn.o_proj.weight"] = _weight(blk.o)
        if hasattr(blk, "moe"):
            out.update(_export_moe(blk.moe, p))
        elif hasattr(blk, "gate"):
            for name in ("gate", "up", "down"):
                out[p + f"mlp.{name}_proj.weight"] = _weight(getattr(blk, name))
        else:
            raise ValueError("export_qwen2 takes a rope-family decoder: export_mpt writes MPT")
    out[prefix + "norm.weight"] = _host(model.norm)
    if model.lm_head is not None:
        out[prefix.replace(".model.", ".") + "lm_head.weight"] = _weight(model.lm_head)
    return out


def _export_moe(moe: qwen2.MoE, p: str) -> State:
    """One MoE layer. A shared expert picks the Qwen2-MoE layout, none the
    Mixtral one."""
    mixtral = moe.shared is None
    moe_p = p + ("block_sparse_moe." if mixtral else "mlp.")
    names = ("w1", "w3", "w2") if mixtral else ("gate_proj", "up_proj", "down_proj")
    out: State = {moe_p + "gate.weight": _weight(moe.router)}
    for table, name in zip((moe.gate, moe.up, moe.down), names):
        for e in range(table.shape[0]):
            out[f"{moe_p}experts.{e}.{name}.weight"] = _host(table[e].t())
    if not mixtral:
        for name in ("gate", "up", "down"):
            out[p + f"mlp.shared_expert.{name}_proj.weight"] = _weight(getattr(moe.shared, name))
        out[p + "mlp.shared_expert_gate.weight"] = _weight(moe.shared_gate)
    return out


def export_siglip(tower: siglip.SigLIPTower, cfg: RadVLMConfig,
                  prefix: str = "vision_tower.vision_model.") -> State:
    """The SigLIP tower; the patchify-matmul weight [D, p*p*3] in (ph, pw, C)
    order goes back to the conv kernel [D, C, p, p]."""
    _unfused(tower.layers, "tower")
    p_sz = cfg.vision.patch_size
    w = _weight(tower.patch_embed)
    d = w.shape[0]
    out: State = {
        prefix + "embeddings.patch_embedding.weight":
            w.reshape(d, p_sz, p_sz, 3).permute(0, 3, 1, 2).contiguous(),
        prefix + "embeddings.patch_embedding.bias": _host(tower.patch_embed.bias),
        prefix + "embeddings.position_embedding.weight": _host(tower.pos_embed),
    }
    for i, layer in enumerate(tower.layers):
        p = f"{prefix}encoder.layers.{i}."
        out[p + "layer_norm1.weight"] = _host(layer.ln1_scale)
        out[p + "layer_norm1.bias"] = _host(layer.ln1_bias)
        out[p + "layer_norm2.weight"] = _host(layer.ln2_scale)
        out[p + "layer_norm2.bias"] = _host(layer.ln2_bias)
        for name, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            lin = getattr(layer, name)
            out[p + f"self_attn.{hf}.weight"] = _weight(lin)
            out[p + f"self_attn.{hf}.bias"] = _host(lin.bias)
        for name in ("fc1", "fc2"):
            lin = getattr(layer, name)
            out[p + f"mlp.{name}.weight"] = _weight(lin)
            out[p + f"mlp.{name}.bias"] = _host(lin.bias)
    out[prefix + "post_layernorm.weight"] = _host(tower.post_ln_scale)
    out[prefix + "post_layernorm.bias"] = _host(tower.post_ln_bias)
    return out


def export_radvlm(model: radvlm.RadVLM, cfg: RadVLMConfig) -> State:
    state: State = {}
    state.update(export_qwen2(model.text))
    state.update(export_siglip(model.vision_tower, cfg))
    for i, fc in enumerate(model.projector.fcs):
        state[f"multi_modal_projector.linear_{i + 1}.weight"] = _weight(fc)
        state[f"multi_modal_projector.linear_{i + 1}.bias"] = _host(fc.bias)
    state["image_newline"] = _host(model.image_newline)
    return state


def resize_vocab_for_hf(state: State, *, extra_tokens: int = 2, pad_to_multiple: int = 64,
                        seed: int = 0) -> int:
    """Grow the embedding (and an untied lm_head) for HF processors, in
    place; returns the new vocab size.

    The reference converter adds `<image>` and `<video>` rows and pads the
    vocab to a multiple of 64, the new rows drawn from a normal fit (mean,
    covariance x 1e-5) of the existing ones. The draws and the Cholesky
    factor are numpy's, in f32, as the JAX package computes them, so both
    packages grow a checkpoint by the same bits."""
    rng = np.random.default_rng(seed)

    def grow(key: str, n_new: int):
        dtype = state[key].dtype
        w = state[key].float().numpy()
        mu = w.mean(axis=0)
        centered = w - mu
        sigma = (centered.T @ centered) / max(w.shape[0] - 1, 1)
        d = w.shape[1]
        chol = np.linalg.cholesky(sigma * 1e-5 + np.eye(d, dtype=np.float32) * 1e-12)
        new_rows = mu + rng.standard_normal((n_new, d)).astype(np.float32) @ chol.T
        grown = np.concatenate([w, new_rows], axis=0).astype(np.float32)
        state[key] = torch.from_numpy(grown).to(dtype)

    embed_key = "language_model.model.embed_tokens.weight"
    vocab = state[embed_key].shape[0]
    target = -(-(vocab + extra_tokens) // pad_to_multiple) * pad_to_multiple
    n_new = target - vocab
    if n_new > 0:
        grow(embed_key, n_new)
        head_key = "language_model.lm_head.weight"
        if head_key in state:
            grow(head_key, n_new)
    return target


def save_safetensors(state: State, path: str) -> None:
    """Write `state` as `path`/model.safetensors, bf16 tensors as f32."""
    os.makedirs(path, exist_ok=True)
    clean = {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in state.items()}
    safetensors_io.write_file(clean, os.path.join(path, "model.safetensors"))


def save_radvlm_hf(model: radvlm.RadVLM, cfg: RadVLMConfig, path: str, *,
                   resize_vocab: bool = False) -> None:
    """Write an HF-loadable LLaVA-OneVision checkpoint directory:
    model.safetensors and config.json. `resize_vocab` applies the reference
    converter's growth (+2 tokens, padded to 64) so stock HF processors can
    drive the checkpoint; the image and video token ids are then the first
    two new rows."""
    state = export_radvlm(model, cfg)
    t = cfg.text
    vocab = t.vocab_size
    image_token_index = video_token_index = None
    if resize_vocab:
        resize_vocab_for_hf(state)
        image_token_index, video_token_index = vocab, vocab + 1
        vocab = state["language_model.model.embed_tokens.weight"].shape[0]
    save_safetensors(state, path)
    config = {
        "architectures": ["LlavaOnevisionForConditionalGeneration"],
        "model_type": "llava_onevision",
        "projector_hidden_act": "gelu",
        "vision_feature_select_strategy": "full",
        "vision_feature_layer": -1,
        "vision_aspect_ratio": cfg.image_aspect_ratio,
        "image_token_index": image_token_index,
        "video_token_index": video_token_index,
        "tie_word_embeddings": t.tie_word_embeddings,
        "text_config": {
            "model_type": "qwen2_moe" if t.num_experts else "qwen2",
            "vocab_size": vocab,
            "hidden_size": t.hidden_size,
            "intermediate_size": t.intermediate_size,
            "num_hidden_layers": t.num_layers,
            "num_attention_heads": t.num_heads,
            "num_key_value_heads": t.num_kv_heads,
            "head_dim": t.head_dim,
            "rope_theta": t.rope_theta,
            "rms_norm_eps": t.rms_norm_eps,
            "tie_word_embeddings": t.tie_word_embeddings,
            "max_position_embeddings": t.max_position_embeddings,
            # The MoE fields: without them HF builds a dense decoder.
            **({
                "num_experts": t.num_experts,
                "num_experts_per_tok": t.num_experts_per_tok,
                "moe_intermediate_size": t.moe_intermediate_size,
                "shared_expert_intermediate_size": t.shared_expert_intermediate_size,
                "norm_topk_prob": t.norm_topk_prob,
                "decoder_sparse_step": 1,
                "mlp_only_layers": [],
            } if t.num_experts else {}),
        },
        "vision_config": {
            "model_type": "siglip_vision_model",
            "hidden_size": cfg.vision.hidden_size,
            "intermediate_size": cfg.vision.intermediate_size,
            "num_hidden_layers": cfg.vision.num_layers,
            "num_attention_heads": cfg.vision.num_heads,
            "image_size": cfg.vision.image_size,
            "patch_size": cfg.vision.patch_size,
            "vision_use_head": False,
        },
        "image_grid_pinpoints": [list(p) for p in cfg.anyres.pinpoints],
    }
    config = {k: v for k, v in config.items() if v is not None}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
