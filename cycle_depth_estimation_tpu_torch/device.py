"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. There is no
silent fallback: asking for ``cuda`` on a machine without a GPU raises.
``set_precision`` is the CLIs' ``--tpu_precision``.
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


def set_precision(precision: str) -> None:
    """``highest``: fp32 convs and matmuls without TF32 (cuDNN's and
    cuBLAS's), as the JAX CLIs set matmul precision "highest"; ``default``
    leaves torch's settings as they are."""
    if precision not in ("default", "highest"):
        raise ValueError(f"unknown precision [{precision}]; expected "
                         "'default' | 'highest'")
    if precision == "highest":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
