"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for the CPU.  A
request for ``cuda`` on a machine without a GPU raises instead of quietly
running on the CPU."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    return dev

