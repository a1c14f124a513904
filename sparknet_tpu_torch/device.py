"""Device resolution for the port's entry points.

Entry points run on the CUDA card by default. Without a card they raise
rather than carry on on the CPU: a silent CPU run would report CPU numbers
under the card's name. Callers that mean the CPU (the tests) say so with
`device="cpu"`.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` (default "cuda") as a torch.device; raises RuntimeError for
    a CUDA device when no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
