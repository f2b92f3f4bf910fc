"""Profiling / tracing utilities (counterpart of `radvlm_tpu/utils/profiling.py`).

- `trace(logdir)`: a `torch.profiler` trace of the CPU, and of CUDA when a
  card is present, written into `logdir` as a Chrome trace on exit
  (chrome://tracing, Perfetto, TensorBoard's profile plugin);
- `StepTimer`: host-side per-step wall timing with EMA + tokens/sec;
- `annotate`: a named `record_function` span that shows up in the trace.

torch is imported inside the functions, so the module stays light.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    from torch.profiler import record_function

    with record_function(name):
        yield


class StepTimer:
    """EMA step timing + throughput accounting for train/serve loops."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.step_time: Optional[float] = None
        self._last: Optional[float] = None
        self.total_steps = 0
        self.total_tokens = 0
        self._window_tokens = 0
        self._window_start = time.perf_counter()

    def tick(self, tokens: int = 0) -> Dict[str, float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.step_time = (
                dt if self.step_time is None
                else self.ema * self.step_time + (1 - self.ema) * dt
            )
        self._last = now
        self.total_steps += 1
        self.total_tokens += tokens
        self._window_tokens += tokens
        out = {
            "step_time_ema_s": self.step_time or 0.0,
            "steps": float(self.total_steps),
        }
        window = now - self._window_start
        if window > 0:
            out["tokens_per_sec"] = self._window_tokens / window
        return out

    def reset_window(self):
        self._window_tokens = 0
        self._window_start = time.perf_counter()
