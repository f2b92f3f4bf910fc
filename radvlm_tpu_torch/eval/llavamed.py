"""LLaVA-Med v1.5 (Mistral-7B) torch-sidecar: compact rebuild of the baseline
(counterpart of `radvlm_tpu/eval/llavamed.py`).

The reference evaluates `microsoft/llava-med-v1.5-mistral-7b` by registering a
785-LoC inline rebuild of the LLaVA-Mistral architecture with transformers'
dynamic module system (`radvlm/evaluation/llava_med_loading.py:39`,
`models_loading_inference.py:62-77`). Here the same model is assembled from
stock transformers pieces — MistralForCausalLM + CLIPVisionModel (ViT-L/14-336)
+ a 2-layer GELU projector — with an explicit state-dict remap and an explicit
batch-1 embedding splice at the -200 image sentinel. ~6x smaller, no dynamic
registration, and every pure part (remap, splice, feature select) is testable
without weights.

This is an eval-only sidecar: the baselines are transformers models, off the
port's own model and kernels. Safetensors shards are read by the port's
`models/safetensors_io.py`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

IMAGE_TOKEN_INDEX = -200

# openai/clip-vit-large-patch14-336 hyperparameters (the tower LLaVA-Med uses;
# its weights ship inside the llava-med checkpoint so no hub access is needed).
CLIP_VIT_L_336 = dict(
    hidden_size=1024,
    intermediate_size=4096,
    num_hidden_layers=24,
    num_attention_heads=16,
    image_size=336,
    patch_size=14,
    projection_dim=768,
)


def remap_state_dict(sd: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """Split a llava-med checkpoint into (language, vision, projector) dicts.

    Checkpoint layout (same convention the reference's inline rebuild consumes):
      model.embed_tokens/... , model.layers.N..., model.norm, lm_head  -> Mistral
      model.vision_tower.vision_tower.vision_model...                 -> CLIP
      model.mm_projector.{0,2}.{weight,bias}                          -> projector
    """
    lang: Dict[str, Any] = {}
    vision: Dict[str, Any] = {}
    proj: Dict[str, Any] = {}
    for k, v in sd.items():
        if k.startswith("model.vision_tower.vision_tower."):
            vision[k[len("model.vision_tower.vision_tower."):]] = v
        elif k.startswith("model.mm_projector."):
            proj[k[len("model.mm_projector."):]] = v
        elif k.startswith("model.") or k == "lm_head.weight":
            lang[k] = v
    return lang, vision, proj


def select_patch_features(hidden_states: List[Any], select_layer: int = -2):
    """CLIP feature selection: the select_layer's hidden states minus the CLS
    token (the reference's `feature_select` with mm_vision_select_feature=
    'patch', `llava_med_loading.py:136-147`)."""
    return hidden_states[select_layer][:, 1:]


def splice_image_embeds(input_ids, text_embed_fn, image_features):
    """Batch-1 multimodal splice: replace each -200 sentinel in `input_ids`
    [1, L] with the corresponding image's feature rows.

    The reference's `prepare_inputs_labels_for_multimodal`
    (`llava_med_loading.py:308-570`) handles padded batches; eval inference is
    batch-1 greedy so a direct concat is exact and far simpler.
    Returns (inputs_embeds [1, L'], attention_mask [1, L']).
    """
    import torch

    ids = input_ids[0]
    sentinel = (ids == IMAGE_TOKEN_INDEX).nonzero(as_tuple=True)[0].tolist()
    chunks = []
    prev = 0
    for n_img, pos in enumerate(sentinel):
        if pos > prev:
            chunks.append(text_embed_fn(ids[prev:pos][None])[0])
        chunks.append(image_features[n_img])
        prev = pos + 1
    if prev < ids.shape[0]:
        chunks.append(text_embed_fn(ids[prev:][None])[0])
    embeds = torch.cat(chunks, dim=0)[None]
    mask = torch.ones(embeds.shape[:2], dtype=torch.long, device=embeds.device)
    return embeds, mask


class LlavaMedModel:
    """Mistral LLM + CLIP tower + mlp2x_gelu projector, assembled explicitly."""

    def __init__(self, language_model, vision_tower, projector,
                 image_processor, select_layer: int = -2):
        self.language_model = language_model
        self.vision_tower = vision_tower
        self.projector = projector
        self.image_processor = image_processor
        self.select_layer = select_layer

    @classmethod
    def from_components(cls, language_model, vision_tower, projector,
                        image_processor=None):
        return cls(language_model, vision_tower, projector, image_processor)

    @classmethod
    def from_pretrained_dir(cls, model_path: str, device: str = "cpu",
                            dtype=None):
        """Load from a local llava-med checkpoint directory (config.json +
        safetensors/bin shards). No hub access: the CLIP tower config is fixed
        (ViT-L/14-336) and its weights ship in the checkpoint."""
        import torch
        from transformers import (
            CLIPImageProcessor,
            CLIPVisionConfig,
            CLIPVisionModel,
            MistralConfig,
            MistralForCausalLM,
        )

        with open(os.path.join(model_path, "config.json")) as f:
            cfg = json.load(f)
        sd = _load_checkpoint_dir(model_path)
        lang_sd, vis_sd, proj_sd = remap_state_dict(sd)

        # The tower is ViT-L/14-336 for the released llava-med checkpoint; a
        # checkpoint may carry explicit tower hyperparameters (tiny CI
        # checkpoints, retrained towers) under "mm_vision_tower_cfg".
        tower_cfg = dict(CLIP_VIT_L_336)
        tower_cfg.update(cfg.get("mm_vision_tower_cfg") or {})

        lm_cfg = MistralConfig(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", 8),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            rope_theta=cfg.get("rope_theta", 1e6),
            max_position_embeddings=cfg.get("max_position_embeddings", 32768),
        )
        lm = MistralForCausalLM(lm_cfg)
        lm.load_state_dict(lang_sd, strict=False)

        tower = CLIPVisionModel(CLIPVisionConfig(**tower_cfg))
        tower.load_state_dict(vis_sd, strict=True)

        d_vis, d_lm = tower_cfg["hidden_size"], cfg["hidden_size"]
        projector = torch.nn.Sequential(
            torch.nn.Linear(d_vis, d_lm), torch.nn.GELU(),
            torch.nn.Linear(d_lm, d_lm),
        )
        projector.load_state_dict(proj_sd)

        res = tower_cfg["image_size"]
        ip = CLIPImageProcessor(
            size={"shortest_edge": res}, crop_size={"height": res, "width": res},
            do_resize=True, do_center_crop=True, do_rescale=True,
            do_normalize=True,
            image_mean=[0.48145466, 0.4578275, 0.40821073],
            image_std=[0.26862954, 0.26130258, 0.27577711],
        )
        model = cls(lm, tower, projector, ip,
                    select_layer=cfg.get("mm_vision_select_layer", -2))
        if dtype is not None:
            model.to(device, dtype)
        return model

    def to(self, device, dtype=None):
        for m in (self.language_model, self.vision_tower, self.projector):
            m.to(device) if dtype is None else m.to(device, dtype)
        return self

    def eval(self):
        for m in (self.language_model, self.vision_tower, self.projector):
            m.eval()
        return self

    def encode_image(self, pixel_values):
        out = self.vision_tower(pixel_values, output_hidden_states=True)
        feats = select_patch_features(out.hidden_states, self.select_layer)
        return self.projector(feats.to(next(self.projector.parameters()).dtype))

    def generate(self, input_ids, pixel_values=None, max_new_tokens: int = 500,
                 **kw):
        import torch

        with torch.no_grad():
            if pixel_values is not None:
                feats = self.encode_image(pixel_values)
                embeds, mask = splice_image_embeds(
                    input_ids, self.language_model.get_input_embeddings(), feats
                )
            else:
                embeds = self.language_model.get_input_embeddings()(input_ids)
                mask = torch.ones(embeds.shape[:2], dtype=torch.long,
                                  device=embeds.device)
            return self.language_model.generate(
                inputs_embeds=embeds, attention_mask=mask,
                max_new_tokens=max_new_tokens, do_sample=False, **kw,
            )


def _load_checkpoint_dir(model_path: str) -> Dict[str, Any]:
    """All tensors from every *.safetensors (preferred) or pytorch_model*.bin."""
    import glob

    sd: Dict[str, Any] = {}
    st_files = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    if st_files:
        from radvlm_tpu_torch.models.safetensors_io import read_file

        for f in st_files:
            sd.update(read_file(f))
        return sd
    import torch

    for f in sorted(glob.glob(os.path.join(model_path, "pytorch_model*.bin"))):
        sd.update(torch.load(f, map_location="cpu", weights_only=True))
    if not sd:
        raise FileNotFoundError(f"no checkpoint shards in {model_path}")
    return sd
