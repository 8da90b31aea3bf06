"""Device choice for the PyTorch port.

The port runs on an NVIDIA GPU (``cuda``) unless the caller asks for the CPU.
Asking for the default on a host without a usable GPU raises: the engine
never falls back to the CPU on its own, so a run that names no device is
always a GPU run. The CPU exists for tests, where every kernel wrapper takes
its plain PyTorch version because its tensors lie on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises without a
    GPU); ``"cpu"`` -> the CPU; any other torch device string passes
    through."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "engine on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

