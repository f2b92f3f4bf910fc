"""Speculative decoding: prompt-lookup drafts and greedy acceptance
(counterpart of `radvlm_tpu/generation/spec.py`).

Each engine step verifies `spec_k` drafted tokens plus the current token in
ONE cached forward of width spec_k + 1 and accepts the longest prefix that
matches the model's own greedy predictions. An accepted draft token equals
the argmax the plain loop would have produced, so the emitted stream is the
plain greedy stream whatever the drafts are; a wrong draft costs only the
verify width.

Drafts come from prompt lookup: the last bigram of the accepted stream is
matched against a per-slot token history on the device (prompt text ids and
accepted output, -1 at padding and image positions), and the spec_k tokens
after the most recent earlier match are proposed. No second model, no
memory beyond an int32 [slots, max_len] history.

Plain functions on tensors; none of them waits on the device, so the whole
propose / verify / accept loop stays inside the engine's decode chunk. The
windowed cache write and the window attention (K10 / K11) are in
`models/qwen2._block_cached`.
"""

from __future__ import annotations

from typing import Tuple

import torch


def write_history(hist: torch.Tensor, widx: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Write a per-row token window into the history at [widx, widx + s), IN
    PLACE; returns `hist`.

    hist [B, S] int32, widx [B], window [B, s]. Entries past the accepted
    prefix stay stale until the next window overwrites them: they sit at
    indices >= the next step's widx, and a stale draft that equals the
    model's argmax is by definition right, so staleness never reaches the
    output (the KV cache's invariant)."""
    b, s = window.shape
    rows = torch.arange(b, device=hist.device)[:, None]
    idxw = widx.long()[:, None] + torch.arange(s, device=hist.device)[None]
    hist[rows, idxw] = window.to(hist.dtype)
    return hist


def propose_ngram(hist: torch.Tensor, widx: torch.Tensor, spec_k: int) -> torch.Tensor:
    """Draft spec_k tokens per row by matching the stream's last bigram.

    hist [B, S] int32 by CACHE position; widx [B] is the position of the
    current token (already written to hist). Returns [B, spec_k] int32: the
    tokens after the most recent earlier occurrence of
    (hist[widx - 1], hist[widx]); zeros where there is none."""
    b, smax = hist.shape
    widx = widx.long()
    p0 = hist.gather(1, (widx - 1).clamp_min(0)[:, None])[:, 0]
    p1 = hist.gather(1, widx[:, None])[:, 0]
    pos = torch.arange(smax - 1, device=hist.device)
    m = (hist[:, :-1] == p0[:, None]) & (hist[:, 1:] == p1[:, None])
    m = m & (pos[None] < (widx - 1)[:, None])  # strictly before the query bigram
    score = torch.where(m, pos[None] + 1, torch.zeros_like(pos)[None])  # last match wins
    best, j = score.max(dim=1)
    found = best > 0
    # Where nothing matched every score is 0 and the index is unused.
    idx = (j[:, None] + 2 + torch.arange(spec_k, device=hist.device)[None]).clamp(0, smax - 1)
    draft = hist.gather(1, idx)
    return torch.where(found[:, None], draft, torch.zeros_like(draft)).to(torch.int32)


def greedy_accept(
    logits: torch.Tensor, draft: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Longest-prefix greedy acceptance over a verify window.

    logits [B, k+1, V]: position j predicts the token AFTER window token j
    (window = [current, draft[0], ..., draft[k-1]]); draft [B, k]. Returns
    (pred [B, k+1] int32, the greedy predictions, of which pred[:, :n_emit]
    is emitted; n_emit [B] int32 = accepted + 1; next_tok [B] int32 =
    pred[accepted], the new current token)."""
    pred = torch.argmax(logits, dim=-1).to(torch.int32)
    match = (pred[:, :-1] == draft).to(torch.int32)
    acc = torch.cumprod(match, dim=1).sum(dim=1).long()
    next_tok = pred.gather(1, acc[:, None])[:, 0]
    return pred, (acc + 1).to(torch.int32), next_tok


def history_from_prompt(
    tokens: torch.Tensor, segment_ids: torch.Tensor, img_src: torch.Tensor, max_len: int
) -> torch.Tensor:
    """Collated prompt ids [B, L] -> history rows [B, max_len] int32.

    Padding (segment id 0; its token id 0 is a real vocabulary id) and image
    positions (img_src >= 0) become -1, so the bigram matcher never anchors
    on them; generated ids are >= 0."""
    b, l = tokens.shape
    text = (segment_ids != 0) & (img_src < 0)
    out = torch.full((b, max_len), -1, dtype=torch.int32, device=tokens.device)
    out[:, :l] = torch.where(text, tokens.to(torch.int32), torch.full_like(out[:, :l], -1))
    return out
