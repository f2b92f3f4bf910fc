"""Checkpoint layouts of the vision towers and the Q-Former, built with
numpy and torch alone: an HF `CLIPVisionModel` state dict rearranged into
the open_clip and ImageBind layouts (as tests/test_towers.py builds them),
and EVA and Q-Former layouts made from seeded random tensors under the
checkpoints' key names. tests/test_torch_tower_import.py feeds them to both
packages' importers; the jax-blocked run of tests/test_torch_slice.py feeds
them to the port's alone.
"""

import re

import numpy as np
import torch

_HF_VIT = (("layer_norm1.weight", "d"), ("layer_norm1.bias", "d"),
           ("layer_norm2.weight", "d"), ("layer_norm2.bias", "d"),
           ("self_attn.q_proj.weight", "dd"), ("self_attn.q_proj.bias", "d"),
           ("self_attn.k_proj.weight", "dd"), ("self_attn.k_proj.bias", "d"),
           ("self_attn.v_proj.weight", "dd"), ("self_attn.v_proj.bias", "d"),
           ("self_attn.out_proj.weight", "dd"), ("self_attn.out_proj.bias", "d"),
           ("mlp.fc1.weight", "fd"), ("mlp.fc1.bias", "f"),
           ("mlp.fc2.weight", "df"), ("mlp.fc2.bias", "d"))


def hf_clip_state(vis, n_layers: int, g: torch.Generator):
    """Random tensors under an HF `CLIPVisionModel`'s key names, for a tower
    of `vis`'s widths with `n_layers` encoder layers."""
    d, f, p = vis.hidden_size, vis.intermediate_size, vis.patch_size
    sizes = {"d": (d,), "f": (f,), "dd": (d, d), "fd": (f, d), "df": (d, f)}
    shapes = {"embeddings.patch_embedding.weight": (d, 3, p, p),
              "embeddings.class_embedding": (d,),
              "embeddings.position_embedding.weight": (vis.tokens_per_tile + 1, d),
              "pre_layrnorm.weight": (d,), "pre_layrnorm.bias": (d,)}
    shapes.update({f"encoder.layers.{i}.{n}": sizes[s] for i in range(n_layers)
                   for n, s in _HF_VIT})
    return {"vision_model." + k: 0.1 * torch.randn(s, generator=g) for k, s in shapes.items()}


def _n_layers(sd) -> int:
    return 1 + max(int(m.group(1)) for k in sd
                   for m in [re.search(r"encoder\.layers\.(\d+)\.", k)] if m)


def open_clip_state(sd):
    """An HF CLIPVisionModel's tensors in the open_clip `visual.*` layout."""
    pre = "vision_model."
    out = {"visual.conv1.weight": sd[pre + "embeddings.patch_embedding.weight"],
           "visual.class_embedding": sd[pre + "embeddings.class_embedding"],
           "visual.positional_embedding": sd[pre + "embeddings.position_embedding.weight"],
           "visual.ln_pre.weight": sd[pre + "pre_layrnorm.weight"],
           "visual.ln_pre.bias": sd[pre + "pre_layrnorm.bias"]}
    for i in range(_n_layers(sd)):
        src, dst = f"{pre}encoder.layers.{i}.", f"visual.transformer.resblocks.{i}."
        for a, b in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                     ("attn.out_proj", "self_attn.out_proj"), ("mlp.c_fc", "mlp.fc1"),
                     ("mlp.c_proj", "mlp.fc2")):
            for t in ("weight", "bias"):
                out[f"{dst}{a}.{t}"] = sd[f"{src}{b}.{t}"]
        for t in ("weight", "bias"):
            out[f"{dst}attn.in_proj_{t}"] = torch.cat(
                [sd[f"{src}self_attn.{n}_proj.{t}"] for n in ("q", "k", "v")])
    return out


def imagebind_state(sd, rng, vis):
    """An HF CLIPVisionModel's tensors in ImageBind's layout for a trunk of
    `vis` (an ImageBind vision config of the same widths), with a seeded
    random video stem and head."""
    pre, d, p = "vision_model.", vis.hidden_size, vis.patch_size
    state = {
        "modality_preprocessors.vision.cls_token":
            sd[pre + "embeddings.class_embedding"].reshape(1, 1, d),
        "modality_preprocessors.vision.rgbt_stem.proj.1.weight":
            torch.from_numpy(rng.normal(size=(d, 3, 2, p, p)).astype(np.float32)),
        "modality_preprocessors.vision.pos_embedding_helper.pos_embed":
            sd[pre + "embeddings.position_embedding.weight"][None],
        "modality_trunks.vision.pre_transformer_layer.0.weight": sd[pre + "pre_layrnorm.weight"],
        "modality_trunks.vision.pre_transformer_layer.0.bias": sd[pre + "pre_layrnorm.bias"],
        "modality_heads.vision.0.weight": torch.from_numpy(
            rng.normal(1, 0.05, size=(d,)).astype(np.float32)),
        "modality_heads.vision.0.bias": torch.from_numpy(
            rng.normal(0, 0.05, size=(d,)).astype(np.float32)),
        "modality_heads.vision.2.weight": torch.from_numpy(
            rng.normal(size=(vis.embed_dim, d)).astype(np.float32)),
    }
    for i in range(vis.num_layers):
        src, dst = f"{pre}encoder.layers.{i}.", f"modality_trunks.vision.blocks.{i}."
        for a, b in (("norm_1", "layer_norm1"), ("norm_2", "layer_norm2"),
                     ("attn.out_proj", "self_attn.out_proj"), ("mlp.fc1", "mlp.fc1"),
                     ("mlp.fc2", "mlp.fc2")):
            for t in ("weight", "bias"):
                state[f"{dst}{a}.{t}"] = sd[f"{src}{b}.{t}"]
        for t in ("weight", "bias"):
            state[f"{dst}attn.in_proj_{t}"] = torch.cat(
                [sd[f"{src}self_attn.{n}_proj.{t}"] for n in ("q", "k", "v")])
    return state


def eva_state(vis, rng, prefix="visual."):
    """Seeded random tensors (numpy) under `EVAVisionTransformer`'s key names."""
    d, f, p = vis.hidden_size, vis.intermediate_size, vis.patch_size

    def t(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.1

    s = {"patch_embed.proj.weight": t(d, 3, p, p), "patch_embed.proj.bias": t(d),
         "cls_token": t(1, 1, d), "pos_embed": t(1, vis.tokens_per_tile + 1, d),
         "norm.weight": t(d), "head.weight": t(8, d)}  # unused by the tower
    for i in range(vis.num_layers):
        b = f"blocks.{i}."
        norms = ["norm1", "norm2"] + (["attn.inner_attn_ln"] if vis.subln else [])
        widths = [d, d, d] + ([f] if vis.subln else [])
        if vis.subln:
            norms.append("mlp.ffn_ln")
        for n, w in zip(norms, widths):
            s[f"{b}{n}.weight"] = 1 + t(w)
            if vis.norm != "rms":
                s[f"{b}{n}.bias"] = t(w)
        if vis.subln:
            for n in ("q", "k", "v"):
                s[f"{b}attn.{n}_proj.weight"] = t(d, d)
        else:
            s[f"{b}attn.qkv.weight"] = t(3 * d, d)
        if vis.qkv_bias:
            s[f"{b}attn.q_bias"], s[f"{b}attn.v_bias"] = t(d), t(d)
        s[f"{b}attn.proj.weight"], s[f"{b}attn.proj.bias"] = t(d, d), t(d)
        mlp = (("w1", f, d), ("w2", f, d), ("w3", d, f)) if vis.swiglu else (
            ("fc1", f, d), ("fc2", d, f))
        for n, o, i_ in mlp:
            s[f"{b}mlp.{n}.weight"], s[f"{b}mlp.{n}.bias"] = t(o, i_), t(o)
        if vis.ls_init_value is not None:
            s[f"{b}gamma_1"], s[f"{b}gamma_2"] = t(d), t(d)
    return {prefix + k: v for k, v in s.items()}


def qformer_state(rcfg, dim, rng):
    """Seeded random tensors (numpy) under the BLIP-2 Q-Former wrapper's key
    names (the text path absent, as build_Qformer leaves it)."""
    h, inter = rcfg.qformer_hidden, rcfg.qformer_intermediate

    def t(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.1

    s = {"ln_vision.weight": 1 + t(dim), "ln_vision.bias": t(dim),
         "query_tokens": t(1, rcfg.num_latents, h),
         "Qformer.bert.embeddings.LayerNorm.weight": 1 + t(h),
         "Qformer.bert.embeddings.LayerNorm.bias": t(h)}
    for i in range(rcfg.qformer_layers):
        p = f"Qformer.bert.encoder.layer.{i}."
        blocks = [("attention", h)] + ([("crossattention", dim)] if i % rcfg.depth == 0 else [])
        for blk, kv_in in blocks:
            for n, i_ in (("self.query", h), ("self.key", kv_in), ("self.value", kv_in),
                          ("output.dense", h)):
                s[f"{p}{blk}.{n}.weight"], s[f"{p}{blk}.{n}.bias"] = t(h, i_), t(h)
            s[f"{p}{blk}.output.LayerNorm.weight"] = 1 + t(h)
            s[f"{p}{blk}.output.LayerNorm.bias"] = t(h)
        s[p + "intermediate_query.dense.weight"], s[p + "intermediate_query.dense.bias"] = (
            t(inter, h), t(inter))
        s[p + "output_query.dense.weight"], s[p + "output_query.dense.bias"] = t(h, inter), t(h)
        s[p + "output_query.LayerNorm.weight"] = 1 + t(h)
        s[p + "output_query.LayerNorm.bias"] = t(h)
    return s
