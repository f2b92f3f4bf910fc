"""The port's default device.

Entry points run on the card unless the caller asks for the CPU: a `device`
argument of None means `cuda:0`, and where there is no card that is an error,
not a quiet retreat to the CPU. "cpu" is honoured only when the caller wrote
it (the CPU tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device` as a `torch.device`; None means the card and raises a
    RuntimeError where `torch.cuda.is_available()` is false."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device=None means the CUDA card (cuda:0) and there is none here: "
            "pass device=\"cpu\" to run on the CPU"
        )
    return torch.device("cuda:0")
