"""Resolve the device a caller asked for, refusing to drop to the CPU."""
from __future__ import annotations

from typing import Union

import torch


def resolve(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``; raises when a CUDA device is asked for on
    a machine where ``torch.cuda.is_available()`` is false, so that work
    meant for the card never runs on the host unnoticed."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the host")
    return dev
