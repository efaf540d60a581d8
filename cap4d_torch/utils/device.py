"""Device selection for the port's entry points.

Entry points run on the card. Without CUDA they raise unless the caller asks
for the CPU explicitly (``device="cpu"``), as the tests do: there is no quiet
fallback from the card to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card; raise when it is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: cap4d_torch runs on an NVIDIA GPU; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
