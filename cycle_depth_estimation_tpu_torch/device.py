"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. There is no
silent fallback: asking for ``cuda`` on a machine without a GPU raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; raise if a CUDA device is asked for but absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
