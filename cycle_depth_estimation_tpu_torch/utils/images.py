"""Tensor → image conversion (the JAX package's ``utils/images.py``,
reference util/util.py), for NCHW/CHW tensors."""

from __future__ import annotations

import os

import numpy as np
import torch


def tensor2im(x: torch.Tensor, imtype=np.uint8) -> np.ndarray:
    """First image of an NCHW (or CHW) tensor in [-1, 1] → HWC uint8;
    one channel is tiled to three."""
    arr = x.detach().float().cpu().numpy()
    if arr.ndim == 4:
        arr = arr[0]
    arr = arr.transpose(1, 2, 0)
    if arr.shape[-1] == 1:
        arr = np.tile(arr, (1, 1, 3))
    arr = (arr + 1.0) / 2.0 * 255.0
    return np.clip(arr, 0, 255).astype(imtype)


def save_image(image: np.ndarray, path: str):
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(image).save(path)
