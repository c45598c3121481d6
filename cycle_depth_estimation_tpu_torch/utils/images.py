"""Tensor → image conversion and label colorization (the JAX package's
``utils/images.py``, reference util/util.py), for NCHW/CHW tensors and
(N)HW label maps, and ``depth2im`` for depth maps. ``label2im`` uses the JAX package's palette (a
Pascal-VOC-style bit shuffle of the class id), packaged here instead of the
reference's colour tables read from absolute paths."""

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


def _make_palette(n: int = 256) -> np.ndarray:
    palette = np.zeros((n, 3), np.uint8)
    for i in range(n):
        c, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        palette[i] = (r, g, b)
    return palette


_PALETTE = _make_palette()


def label2im(labels, ignore_index: int = 255) -> np.ndarray:
    """The first map of an integer label tensor or array, (N)HW or
    (N)1HW, → colorized HWC uint8; ``ignore_index`` is black."""
    arr = (labels.detach().cpu().numpy() if isinstance(labels, torch.Tensor)
           else np.asarray(labels))
    while arr.ndim > 2:
        arr = arr[0]
    arr = np.clip(arr.astype(np.int64), 0, 255)
    out = _PALETTE[arr]
    out[arr == ignore_index] = 0
    return out


def depth2im(depth) -> np.ndarray:
    """The first map of a depth tensor or array, (N)(1)HW, min-max stretched
    to gray HWC uint8 (a span under 1e-6 counts as 1e-6)."""
    arr = (depth.detach().float().cpu().numpy()
           if isinstance(depth, torch.Tensor)
           else np.asarray(depth, np.float32))
    while arr.ndim > 2:
        arr = arr[0]
    arr = arr.astype(np.float32)
    lo, hi = float(arr.min()), float(arr.max())
    if hi - lo < 1e-6:
        hi = lo + 1e-6
    arr = (arr - lo) / (hi - lo) * 255.0
    return np.tile(arr[..., None], (1, 1, 3)).astype(np.uint8)


def scale_pyramid(img: torch.Tensor, num_scales: int):
    """``img`` (NCHW) and its 2×2 average pools, ``num_scales`` in all, each
    half the size of the one before (reference util/util.py)."""
    from ..ops.layers import avg_pool

    out = [img]
    for _ in range(num_scales - 1):
        out.append(avg_pool(out[-1], 2, 2))
    return out


def save_image(image: np.ndarray, path: str):
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(image).save(path)
