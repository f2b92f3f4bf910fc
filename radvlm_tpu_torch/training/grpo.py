"""GRPO: group-relative policy optimization over serving-engine rollouts
(counterpart of `radvlm_tpu/training/grpo.py`, on one card).

- **Rollouts** run through the continuous serving engine
  (`generation/continuous.ContinuousBatcher`): all `group_size` samples of a
  prompt wave decode as one continuously batched stream. The engine serves
  a model of its own, never the policy module: on the card a bf16 copy of
  the f32 masters (the attention kernels take bf16 q / k / v), on the CPU
  an f32 copy, fused for inference (`fuse_for_inference`). Between waves
  `sync_rollout_model` writes the policy's new weights into that copy on
  the device, the fused q/k/v and gate/up weights re-derived from their
  parts. The engine runs under `torch.inference_mode()`; nothing it makes
  reaches the update, whose batch is rebuilt from token ids
  (`rollouts_to_batch`).
- **Rewards** are rule-based (numpy), scored with the evaluation metrics'
  own parsers (`eval/metrics`).
- **The update** is a group-relative policy-gradient step on the SFT
  optimizer: advantage = the group-standardized reward, a per-sequence
  token-mean PPO-clip surrogate with a k3 KL penalty to the frozen
  reference (a real copy of the starting policy, scored under
  `torch.no_grad()`).

The mesh has no counterpart on one card: a mesh axis other than 1 / -1
raises (ROADMAP M12).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from radvlm_tpu_torch.config import IGNORE_INDEX, RadVLMConfig
from radvlm_tpu_torch.data.datasets import CHEXPERT_PATHOLOGIES
from radvlm_tpu_torch.data.loader import load_image
from radvlm_tpu_torch.device import resolve
from radvlm_tpu_torch.eval.harness import batch_to_device
from radvlm_tpu_torch.eval.metrics.boxes import box_iou, extract_boxes
from radvlm_tpu_torch.eval.metrics.classification import predicted_labels_from_text
from radvlm_tpu_torch.eval.metrics.nlg import bleu4, cider_d_rl, corpus_doc_freq, rouge
from radvlm_tpu_torch.generation.continuous import ContinuousBatcher
from radvlm_tpu_torch.generation.engine import GenerationConfig
from radvlm_tpu_torch.models import multimodal, radvlm
from radvlm_tpu_torch.training import checkpoint as ckpt_lib
from radvlm_tpu_torch.training import loop
from radvlm_tpu_torch.training.dpo import frozen_copy
from radvlm_tpu_torch.training.optimizer import Optimizer, make_optimizer
from radvlm_tpu_torch.training.train_step import TrainState, _autocast

log = logging.getLogger(__name__)

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GRPOConfig:
    group_size: int = 8  # completions sampled per prompt (G)
    clip_eps: float = 0.2  # PPO ratio clip
    kl_beta: float = 0.04  # weight of KL(policy || ref), k3 estimator
    temperature: float = 1.0  # rollout sampling temperature
    top_p: float = 1.0
    max_new_tokens: int = 64
    mu: int = 1  # inner optimization epochs per rollout wave
    adv_eps: float = 1e-4  # std floor in advantage standardization
    prompts_per_wave: int = 4  # prompts rolled out per wave (P); batch = P*G
    reward: str = "rec"  # registry key (see REWARD_FNS)
    iou_weight: float = 1.0  # continuous-IoU term
    acc_weight: float = 1.0  # IoU>=0.5 accuracy term (VLM-R1's reward)
    format_weight: float = 0.1  # "a parseable box is present" term
    # ciderdrl reward: a report corpus (one per line) for document frequencies
    cider_corpus: str = ""


# ---------------------------------------------------------------------------
# Rewards (rule-based, numpy)
# ---------------------------------------------------------------------------


def parse_solution_boxes(solution: str) -> List[List[float]]:
    """Ground-truth boxes from a GRPO-REC cell solution: a JSON object with a
    box list under "bbox" / "bbox_2d", a flat JSON box, or raw `[x, y, x, y]`
    text."""
    try:
        obj = json.loads(solution)
    except (TypeError, ValueError):
        return extract_boxes(str(solution))
    if isinstance(obj, dict):
        boxes = obj.get("bbox") or obj.get("bbox_2d") or []
        if boxes and not isinstance(boxes[0], (list, tuple)):
            boxes = [boxes]  # single flat box
        return [[float(c) for c in b] for b in boxes]
    if isinstance(obj, list) and obj and isinstance(obj[0], (int, float)):
        return [[float(c) for c in obj]]
    return []


def rec_reward(text: str, gt_boxes: Sequence[Sequence[float]], gc: GRPOConfig) -> float:
    """REC reward: best IoU + accuracy@0.5 + a small format term for a
    parseable box, parsed with the evaluation's box regex."""
    preds = extract_boxes(text)
    if not preds:
        return 0.0
    r = gc.format_weight
    if gt_boxes:
        best = max(box_iou(p, g) for p in preds for g in gt_boxes)
        r += gc.iou_weight * best + gc.acc_weight * (1.0 if best >= 0.5 else 0.0)
    return r


def report_reward(text: str, solution: str, gc: GRPOConfig) -> float:
    """Report-generation reward: 0.5 ROUGE-L F + 0.5 BLEU-4 against the
    ground-truth report (the evaluation's scorers; ROUGE needs
    `rouge_score`)."""
    if not text.strip() or not solution.strip():
        return 0.0
    rl, _ = rouge([solution], [text], kind="rougeL")
    bl, _ = bleu4([solution], [text])
    return 0.5 * rl + 0.5 * bl


def classification_reward(text: str, solution: str, gc: GRPOConfig) -> float:
    """F1 between the pathology sets named in the completion and in the
    solution, matched with the evaluation's substring rule."""
    pred = set(predicted_labels_from_text(text, CHEXPERT_PATHOLOGIES))
    gt = set(predicted_labels_from_text(solution, CHEXPERT_PATHOLOGIES))
    if not gt:
        # "no finding"-style solution: reward silence, penalize hallucination
        return 1.0 if not pred else 0.0
    if not pred:
        return 0.0
    tp = len(pred & gt)
    prec, rec = tp / len(pred), tp / len(gt)
    return 2 * prec * rec / (prec + rec) if tp else 0.0


_CIDER_DF_CACHE: Dict[str, Tuple[dict, float]] = {}


def cider_rl_reward(text: str, solution: str, gc: GRPOConfig) -> float:
    """RL CIDEr-D reward against the solution report, the idf from the
    `gc.cider_corpus` file (one report per line) with the log-normalizer
    pinned to log(corpus size)."""
    if not gc.cider_corpus:
        raise ValueError("reward='ciderdrl' needs GRPOConfig.cider_corpus")
    if gc.cider_corpus not in _CIDER_DF_CACHE:
        with open(gc.cider_corpus) as f:
            corpus = [line.strip() for line in f if line.strip()]
        _CIDER_DF_CACHE[gc.cider_corpus] = (
            corpus_doc_freq(corpus), math.log(float(max(2, len(corpus)))))
    df, log_norm = _CIDER_DF_CACHE[gc.cider_corpus]
    if not text.strip() or not solution.strip():
        return 0.0
    return cider_d_rl([solution], [text], df, log_norm=log_norm)[0]


# Registry contract: fn(completion_text, cell, grpo_config) -> float.
REWARD_FNS: Dict[str, Callable[..., float]] = {
    "rec": lambda text, cell, gc: rec_reward(text, cell.gt_boxes, gc),
    "report": lambda text, cell, gc: report_reward(text, cell.solution, gc),
    "classification": lambda text, cell, gc: classification_reward(text, cell.solution, gc),
    "ciderdrl": lambda text, cell, gc: cider_rl_reward(text, cell.solution, gc),
}


def group_advantages(rewards: np.ndarray, group_size: int, eps: float) -> np.ndarray:
    """[P*G] rewards -> advantages standardized within each G-sized group:
    A_i = (r_i - mean_G) / (std_G + eps)."""
    r = np.asarray(rewards, np.float32).reshape(-1, group_size)
    adv = (r - r.mean(axis=1, keepdims=True)) / (r.std(axis=1, keepdims=True) + eps)
    return adv.reshape(-1)


# ---------------------------------------------------------------------------
# Loss and step
# ---------------------------------------------------------------------------


def grpo_loss(model: radvlm.RadVLM, ref_model: radvlm.RadVLM, cfg: RadVLMConfig, gc: GRPOConfig,
              batch: Batch, advantages: torch.Tensor, old_logp: Optional[torch.Tensor] = None, *,
              remat: bool = True, attn_impl: str = "auto"):
    """Per-sequence token-mean clipped surrogate with a k3 KL to the frozen
    reference. On-policy (`old_logp` None) the old log-probabilities are the
    policy's own, detached: the ratio is 1 and the gradient is exactly
    advantage x grad logp. Returns (loss, {loss, kl, clip_frac,
    completion_tokens})."""
    kw = dict(remat=remat, attn_impl=attn_impl)
    tok_logp, mask = radvlm.token_logprobs(model, cfg, batch, **kw)
    with torch.no_grad():
        ref_logp, _ = radvlm.token_logprobs(ref_model, cfg, batch, **kw)
    old = tok_logp.detach() if old_logp is None else old_logp
    ratio = torch.exp(tok_logp - old)
    adv = advantages[:, None]
    clipped = torch.clamp(ratio, 1.0 - gc.clip_eps, 1.0 + gc.clip_eps)
    pg = -torch.minimum(ratio * adv, clipped * adv)
    # k3 KL estimator: unbiased, non-negative (DeepSeekMath eq. 4).
    d = ref_logp - tok_logp
    kl = torch.exp(d) - d - 1.0
    per_tok = pg + gc.kl_beta * kl
    # GRPO normalizes per sequence length, then means over the group batch.
    seq_loss = (per_tok * mask).sum(dim=-1) / mask.sum(dim=-1).clamp_min(1.0)
    loss = seq_loss.mean()
    n = mask.sum().clamp_min(1.0)
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "kl": (kl * mask).sum() / n,
            "clip_frac": (((ratio - 1.0).abs() > gc.clip_eps).float() * mask).sum() / n,
            "completion_tokens": mask.sum() / mask.shape[0],
        }
    return loss, metrics


def make_grpo_step(cfg: RadVLMConfig, gc: GRPOConfig, opt: Optimizer, *, remat: bool = True,
                   attn_impl: str = "auto"):
    """step_fn(state, ref_model, batch, advantages, old_logp) -> (state,
    metrics): the GRPO loss and its gradients under the train step's
    autocast, then one optimizer micro-step (in place). Metrics as
    `grpo_loss`, plus grad_norm (tensors)."""

    def step_fn(state: TrainState, ref_model: radvlm.RadVLM, batch: Batch,
                advantages: torch.Tensor, old_logp: Optional[torch.Tensor]):
        model = state.params
        with _autocast(model.device):
            loss, metrics = grpo_loss(model, ref_model, cfg, gc, batch, advantages, old_logp,
                                      remat=remat, attn_impl=attn_impl)
        loss.backward()
        metrics["grad_norm"] = opt.step()
        state.step += 1
        return state, metrics

    return step_fn


def make_score_fn(cfg: RadVLMConfig, *, remat: bool = True, attn_impl: str = "auto"):
    """score(model, batch) -> [B, L-1] token log-probabilities without a
    gradient, under the train step's autocast: `old_logp` of the mu > 1
    inner epochs, taken once a wave before its first update."""

    @torch.no_grad()
    def score(model: radvlm.RadVLM, batch: Batch) -> torch.Tensor:
        with _autocast(model.device):
            tok, _ = radvlm.token_logprobs(model, cfg, batch, remat=remat, attn_impl=attn_impl)
        return tok

    return score


# ---------------------------------------------------------------------------
# The rollout engine's model
# ---------------------------------------------------------------------------

# Fused inference projections and their parts, in `fuse_linears`' order.
_FUSED = {"qkv": ("q", "k", "v"), "gateup": ("gate", "up")}


def rollout_model(policy: radvlm.RadVLM, cfg: RadVLMConfig) -> radvlm.RadVLM:
    """The rollout engine's own copy of `policy`, fused for inference: bf16
    on the card (the attention kernels take bf16 q / k / v), f32 elsewhere."""
    dtype = torch.bfloat16 if policy.device.type == "cuda" else torch.float32
    model = radvlm.RadVLM(cfg, device=policy.device, dtype=dtype)
    model.load_state_dict(policy.state_dict())
    model.requires_grad_(False)
    return radvlm.fuse_for_inference(model, cfg)


@torch.no_grad()
def sync_rollout_model(engine_model: radvlm.RadVLM, policy: radvlm.RadVLM) -> None:
    """Write the policy's parameters into the engine's copy, on the device,
    cast to its dtype; a fused weight gets each part at its rows."""
    src = dict(policy.named_parameters())
    for name, dst in engine_model.named_parameters():
        if name in src:
            dst.copy_(src[name])
            continue
        prefix, fused, leaf = name.rsplit(".", 2)
        row = 0
        for part in _FUSED[fused]:
            t = src[f"{prefix}.{part}.{leaf}"]
            dst[row:row + t.shape[0]].copy_(t)
            row += t.shape[0]


# ---------------------------------------------------------------------------
# Rollouts via the continuous serving engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GRPOCell:
    """One prompt of the GRPO-REC jsonl (`data/export.grpo_rec_cell`)."""

    prompt_ids: List[int]  # tokenized user turn incl. IMAGE_TOKEN_INDEX
    images: List[np.ndarray]
    gt_boxes: List[List[float]]
    solution: str = ""  # raw solution text (report / label rewards)


def rollout_wave(batcher, cells: Sequence[GRPOCell], cfg: RadVLMConfig, gc: GRPOConfig,
                 tokenizer_decode: Callable[[Sequence[int]], str],
                 seconds: Optional[Dict[str, float]] = None
                 ) -> Tuple[List[Dict[str, Any]], np.ndarray]:
    """Sample group_size completions per cell through the engine and score
    them: (rollouts, rewards [P*G] f32), one rollout dict per (cell, g) in
    submission order, {"cell", "ids" (prompt token ids), "emitted", "text"}.
    A `seconds` dict given gets the sampling's and the scoring's wall time
    as "rollout_s" and "reward_s"."""
    t0 = time.perf_counter()
    reqs = []
    for cell in cells:
        sample = multimodal.build_sample(cell.prompt_ids, cell.images, cfg)
        for _ in range(gc.group_size):
            reqs.append((cell, batcher.submit(sample, max_new_tokens=gc.max_new_tokens,
                                              temperature=gc.temperature, top_p=gc.top_p)))
    for _ in batcher.run():
        pass
    rollouts = []
    for cell, req in reqs:
        if req.error:
            raise RuntimeError(f"rollout failed: {req.error}")
        rollouts.append({"cell": cell, "ids": cell.prompt_ids, "emitted": list(req.emitted),
                         "text": tokenizer_decode(req.emitted)})
    t1 = time.perf_counter()
    reward_fn = REWARD_FNS[gc.reward]
    rewards = np.asarray([reward_fn(r["text"], r["cell"], gc) for r in rollouts], np.float32)
    if seconds is not None:
        seconds.update(rollout_s=t1 - t0, reward_s=time.perf_counter() - t1)
    return rollouts, rewards


def rollouts_to_batch(rollouts: Sequence[Dict[str, Any]], cfg: RadVLMConfig, *, pad_len: int,
                      pad_tiles: int) -> Dict[str, np.ndarray]:
    """Collate rollouts into one supervised batch: tokens = prompt + emitted,
    labels IGNORE over the prompt and the emitted ids over the completion
    (token_logprobs supervises exactly the sampled tokens)."""
    samples = []
    for r in rollouts:
        ids = list(r["ids"]) + list(r["emitted"])
        labels = [IGNORE_INDEX] * len(r["ids"]) + list(r["emitted"])
        samples.append(multimodal.build_sample(ids, r["cell"].images, cfg, labels=labels))
    return multimodal.collate(samples, pad_len=pad_len, pad_tiles=pad_tiles, pad_to_multiple=128)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def load_grpo_cells(path: str, image_root: str, tokenize_fn: Callable[[str], List[int]],
                    cfg: RadVLMConfig, template) -> List[GRPOCell]:
    """GRPO-REC jsonl -> GRPOCells: the user turn rendered with the serving
    chat template (a rollout prompt is a chat prompt), tokenized with the
    <image> sentinel, its image loaded and its solution boxes parsed."""
    cells = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            question = obj.get("problem") or obj["conversations"][0]["value"]
            img_path = obj.get("image")
            if img_path and "<image>" not in question:
                question = "<image>" + question
            elif not img_path:
                question = question.replace("<image>", "")
            prompt = template.render([("user", question)], add_generation_prompt=True)
            ids = multimodal.tokenize_with_images(tokenize_fn, prompt)
            sol = obj.get("solution")
            if sol is None:
                sol = obj["conversations"][1]["value"]
            images = [load_image(os.path.join(image_root, img_path))] if img_path else []
            cells.append(GRPOCell(prompt_ids=ids, images=images,
                                  gt_boxes=parse_solution_boxes(sol), solution=str(sol)))
    return cells


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_grpo(
    run: loop.RunConfig,
    tokenize_fn: Callable[[str], List[int]],
    tokenizer_decode: Callable[[Sequence[int]], str],
    template,
    *,
    grpo_cfg: Optional[GRPOConfig] = None,
    init_params: Optional[radvlm.RadVLM] = None,
    hf_checkpoint: Optional[str] = None,
    metrics_callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
    num_slots: int = 8,
    rollout_max_len: int = 1024,
    prompt_buckets: Sequence[int] = (256,),
    pad_tiles: int = 2,
    eos_token_ids: Sequence[int] = (),
) -> TrainState:
    """GRPO driver: policy + frozen reference -> (a rollout wave through the
    continuous engine -> rule rewards -> group advantages -> mu updates ->
    the engine's weights synced) x waves -> checkpoints.

    `run.data_path` is a GRPO-REC jsonl. `init_params` is an unfused f32
    `RadVLM` on the run's device, trained in place; else the model comes
    from `hf_checkpoint` or a random init seeded with `run.seed`. The
    engine is a `ContinuousBatcher` over `rollout_model(policy)` built from
    num_slots, rollout_max_len, prompt_buckets and pad_tiles (its KV cache
    format from `RADVLM_KV_INT8`). Waves are drawn by
    `np.random.default_rng(run.seed)` as in the JAX package. A wave's
    metrics are its last update's, plus the first update's kl and clip_frac
    (`first_kl`, `first_clip_frac`), the rewards' mean and std, and the
    wave's seconds: rollout_s, reward_s, update_s, sync_s, sec_per_wave,
    and rollout_tokens_per_sec (emitted tokens over rollout_s)."""
    loop.check_mesh(run.mesh_shape)
    device = resolve(run.device)
    gc = grpo_cfg or GRPOConfig()
    model = loop.load_model(run, device, init_params, hf_checkpoint)
    opt = make_optimizer(model, run.train)
    state = TrainState(step=0, params=model, opt_state=opt)
    ref_model = frozen_copy(model)
    step_fn = make_grpo_step(run.model, gc, opt, remat=run.remat, attn_impl=run.attn_impl)
    score_fn = make_score_fn(run.model, remat=run.remat, attn_impl=run.attn_impl) \
        if gc.mu > 1 else None
    manager, state, _, _ = loop.open_checkpoints(run, state)

    cells = load_grpo_cells(run.data_path, run.image_root, tokenize_fn, run.model, template)
    if not cells:
        raise ValueError(f"no GRPO cells in {run.data_path}")
    engine = ContinuousBatcher(
        rollout_model(model, run.model), run.model,
        GenerationConfig(max_new_tokens=gc.max_new_tokens, eos_token_ids=tuple(eos_token_ids)),
        num_slots=num_slots, max_len=rollout_max_len, prompt_buckets=tuple(prompt_buckets),
        pad_tiles=pad_tiles, attn_impl=run.attn_impl, seed=run.seed,
    )
    # The training bucket must hold prompt + completion.
    train_pad_len = max(prompt_buckets) + gc.max_new_tokens

    step = int(state.step)
    rng = np.random.default_rng(run.seed)
    t_last = time.perf_counter()
    while run.max_steps is None or step < run.max_steps:
        wave = [cells[i] for i in rng.choice(
            len(cells), size=min(gc.prompts_per_wave, len(cells)), replace=False)]
        seconds, tokens0 = {}, engine.host_stats["tokens"]
        rollouts, rewards = rollout_wave(engine, wave, run.model, gc, tokenizer_decode, seconds)
        t2 = time.perf_counter()
        adv = torch.as_tensor(group_advantages(rewards, gc.group_size, gc.adv_eps), device=device)
        batch = batch_to_device(rollouts_to_batch(rollouts, run.model, pad_len=train_pad_len,
                                                  pad_tiles=pad_tiles), device)
        old_logp = score_fn(model, batch) if score_fn else None
        first = None
        for _ in range(max(1, gc.mu)):
            state, metrics = step_fn(state, ref_model, batch, adv, old_logp)
            first = first or metrics
            step += 1
            if run.max_steps is not None and step >= run.max_steps:
                break
        m = {k: float(v) for k, v in metrics.items()}  # waits for the card
        m["first_kl"], m["first_clip_frac"] = float(first["kl"]), float(first["clip_frac"])
        t3 = time.perf_counter()
        sync_rollout_model(engine.model, model)
        _wait(device)
        t4 = time.perf_counter()
        m["reward_mean"] = float(rewards.mean())
        m["reward_std"] = float(rewards.std())
        m.update(seconds, update_s=t3 - t2, sync_s=t4 - t3, sec_per_wave=t4 - t_last,
                 rollout_tokens_per_sec=(engine.host_stats["tokens"] - tokens0)
                 / seconds["rollout_s"])
        t_last = t4
        log.info("grpo step %d: %s", step, m)
        if metrics_callback:
            metrics_callback(step, m)
        if manager:
            ckpt_lib.save_state(manager, step, state)

    if manager:
        ckpt_lib.save_state(manager, step, state, force=True)
    return state
