"""Worker-side conversation KV sessions: multi-turn prefix reuse (the port's
own copy of `radvlm_tpu/serve/sessions.py`, which is plain Python + numpy).

The batch worker keeps an LRU of `KVSnapshot`s keyed by the client's
`session_id`: a turn's request tokenizes the full prompt, matches it against
the stored (prompt + reply) token prefix and, on an exact prefix match,
submits ONLY the delta tokens with `resume=` (a windowed cached prefill at
the recorded cache offset, `generation/continuous.py`). Any mismatch
(retokenization drift, edited history, another worker) falls back to the
full prefill, so reuse is an optimization and never changes the output: the
resumed stream is token for token the full-prefill stream
(tests/test_torch_resume.py).

Memory: a snapshot holds one slot's cache rows on the device (for Qwen2-7B
28 layers x max_len x 512 values for K and for V: 0.12 GB at int8, 0.24 GB
at bf16 for a 4224-token cache), so the store is capped
(RADVLM_SESSION_CAP, default 4) and evicts the least recently used; an
evicted conversation pays a full prefill again.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np

from radvlm_tpu_torch.config import IMAGE_TOKEN_INDEX


def image_hash(img: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(getattr(img, "shape", None)).encode())
    h.update(np.ascontiguousarray(img).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class Session:
    ids: List[int]  # unexpanded prompt ids + emitted reply ids
    img_hashes: List[str]
    snapshot: object  # generation.continuous.KVSnapshot


class SessionStore:
    """Thread-safe LRU of conversation snapshots."""

    def __init__(self, cap: Optional[int] = None):
        if cap is None:
            cap = int(os.environ.get("RADVLM_SESSION_CAP", "4"))
        self.cap = cap
        self._d: "OrderedDict[str, Session]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, sid: str) -> Optional[Session]:
        with self._lock:
            ent = self._d.get(sid)
            if ent is not None:
                self._d.move_to_end(sid)
            return ent

    def put(self, sid: str, ent: Session) -> None:
        with self._lock:
            self._d[sid] = ent
            self._d.move_to_end(sid)
            while len(self._d) > self.cap:
                self._d.popitem(last=False)  # LRU eviction frees the device rows

    def drop(self, sid: str) -> None:
        with self._lock:
            self._d.pop(sid, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


def split_delta(
    ent: Session, ids: Sequence[int], img_hashes: Sequence[str]
) -> Optional[Tuple[List[int], int]]:
    """(delta ids, first-new-image index) when the new request extends the
    stored conversation exactly; None -> caller must full-prefill.

    Match is at the unexpanded-token level (image sentinels count as one id)
    plus image-content hashes: retokenization drift across the reply
    boundary, edited history, or swapped images all miss and fall back."""
    n = len(ent.ids)
    k = len(ent.img_hashes)
    if len(ids) <= n or list(ids[:n]) != list(ent.ids):
        return None
    if list(img_hashes[:k]) != list(ent.img_hashes):
        return None
    delta = list(ids[n:])
    # every image in the delta must be a NEW image (prefix images are in KV)
    if sum(1 for t in delta if t == IMAGE_TOKEN_INDEX) != len(img_hashes) - k:
        return None
    return delta, k
