"""SigLIP ViT vision tower in PyTorch (counterpart of `radvlm_tpu/models/siglip.py`).

SO400M patch14/384 run to its 26th layer with no post-LN and no pooling head:
the output is the 729-token hidden-state grid per 384x384 tile. Patch
embedding is patchify + one matmul; attention goes through `ops.attention.mha`
and so to the K1 tower kernel (no mask: every tile is exactly 729 tokens).
The JAX layer scan becomes a Python loop over `layers`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from radvlm_tpu_torch.config import SigLIPConfig
from radvlm_tpu_torch.models.layers import Linear, empty_param, fuse_linears
from radvlm_tpu_torch.ops.attention import layer_norm, mha
from radvlm_tpu_torch.parallel import sharding


# Module attribute -> path in the JAX package's parameter tree, for a tower
# layer and a tower (the weight bridge, `models/convert.py`, walks these;
# an attribute a module does not have, or holds as None, is left out).
VIT_LAYER_TREE = {
    "ln1_scale": ("ln1", "scale"), "ln1_bias": ("ln1", "bias"),
    "ln2_scale": ("ln2", "scale"), "ln2_bias": ("ln2", "bias"),
    "q": ("attn", "q"), "k": ("attn", "k"), "v": ("attn", "v"), "o": ("attn", "o"),
    "qkv": ("attn", "qkv"), "fc1": ("mlp", "fc1"), "fc2": ("mlp", "fc2"),
}


class SigLIPLayer(nn.Module):
    TREE = VIT_LAYER_TREE

    def __init__(self, cfg: SigLIPConfig, *, device=None, dtype=None):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.ln1_scale, self.ln1_bias = empty_param(d, **kw), empty_param(d, **kw)
        self.ln2_scale, self.ln2_bias = empty_param(d, **kw), empty_param(d, **kw)
        # Unfused q/k/v; `fuse_projections` replaces them with one `qkv`.
        self.q = Linear.empty(d, d, True, **kw)
        self.k = Linear.empty(d, d, True, **kw)
        self.v = Linear.empty(d, d, True, **kw)
        self.o = Linear.empty(d, d, True, **kw)
        self.fc1 = Linear.empty(d, f, True, **kw)
        self.fc2 = Linear.empty(f, d, True, **kw)

    def forward(self, x: torch.Tensor, cfg: SigLIPConfig, attn_impl: str = "auto"):
        # A layer sharded over fsdp (parallel/sharding.py) gathers its
        # parameters for the call.
        with sharding.unit_scope(self):
            return self._forward(x, cfg, attn_impl)

    def _forward(self, x: torch.Tensor, cfg: SigLIPConfig, attn_impl: str):
        eps = cfg.layer_norm_eps
        b, s, d = x.shape
        h, hd = cfg.num_heads, cfg.head_dim
        y = layer_norm(x, self.ln1_scale, self.ln1_bias, eps)
        if hasattr(self, "qkv"):
            q, k, v = (t.reshape(b, s, h, hd) for t in self.qkv(y).chunk(3, dim=-1))
        else:
            q, k, v = (p(y).reshape(b, s, h, hd) for p in (self.q, self.k, self.v))
        attn = mha(q, k, v, causal=False, impl=attn_impl).reshape(b, s, d)
        x = x + self.o(attn)
        y = layer_norm(x, self.ln2_scale, self.ln2_bias, eps)
        y = F.gelu(self.fc1(y), approximate="tanh")  # gelu_pytorch_tanh
        return x + self.fc2(y)


class SigLIPTower(nn.Module):
    TREE = {"patch_embed": ("patch_embed",), "pos_embed": ("pos_embed",),
            "post_ln_scale": ("post_ln", "scale"), "post_ln_bias": ("post_ln", "bias")}

    def __init__(self, cfg: SigLIPConfig, *, device=None, dtype=None):
        super().__init__()
        p, d = cfg.patch_size, cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        # Flattened-patch matmul form: input features in (ph, pw, C) order.
        self.patch_embed = Linear.empty(p * p * 3, d, True, **kw)
        self.pos_embed = empty_param(cfg.tokens_per_tile, d, **kw)
        self.layers = nn.ModuleList(SigLIPLayer(cfg, **kw) for _ in range(cfg.num_layers))
        # The checkpoint's post-LN: `forward` does not apply it (the tower is
        # read before it), but the parameter tree carries it, so that a model
        # saved from here holds what the JAX package's tree holds.
        self.post_ln_scale, self.post_ln_bias = empty_param(d, **kw), empty_param(d, **kw)


def fuse_projections(tower: SigLIPTower) -> SigLIPTower:
    """Fuse each layer's q/k/v into one `qkv` projection, in place (one wide
    matmul instead of three per layer). Inference-time transform."""
    for layer in tower.layers:
        if hasattr(layer, "qkv"):
            continue
        layer.qkv = fuse_linears([layer.q, layer.k, layer.v])
        del layer.q, layer.k, layer.v
    return tower


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, (H/p)*(W/p), p*p*3], row-major patches flattened
    as (ph, pw, C); trailing pixels that fill no whole patch are dropped."""
    b, h, w, c = pixels.shape
    gh, gw = h // patch, w // patch
    x = pixels[:, : gh * patch, : gw * patch, :]
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def forward(
    tower: SigLIPTower, cfg: SigLIPConfig, pixels: torch.Tensor, *, attn_impl: str = "auto",
    remat: bool = False,
) -> torch.Tensor:
    """pixels [B, H, W, 3] normalized -> [B, 729, D] (no post-LN, no head).
    `remat` rematerialises each layer in the backward (training)."""
    if attn_impl == "ring":
        attn_impl = "auto"  # ring is for the seq-sharded LLM only
    x = tower.patch_embed(patchify(pixels, cfg.patch_size))
    x = x + tower.pos_embed[None]
    remat = remat and torch.is_grad_enabled()
    for layer in tower.layers:
        if remat:
            x = checkpoint(layer, x, cfg, attn_impl, use_reentrant=False)
        else:
            x = layer(x, cfg, attn_impl)
    return x
