"""The device rule shared by every entry point.

The default device is `cuda`. When CUDA is absent and the caller did not ask
for the CPU, the entry point raises: nothing drops silently to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means `cuda`. Raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU explicitly"
        )
    return dev


def check_on(device: torch.device, *tensors: Optional[torch.Tensor]) -> None:
    """Raise unless every given tensor lies on `device`."""
    for t in tensors:
        if t is not None and t.device.type != device.type:
            raise ValueError(f"tensor on {t.device}, expected {device}")


def float32_on(x, device: torch.device) -> torch.Tensor:
    """`x` as a float32 tensor on `device`: numbers and numpy arrays are
    copied there; a tensor must already lie there."""
    if isinstance(x, torch.Tensor):
        check_on(device, x)
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)
