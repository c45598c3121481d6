"""Image metrics helpers (the JAX package's ``utils/metrics.py``, the part
the port reads so far): ``_resize_linear``, the linear resize of the ``try``
dataset's edge maps."""

from __future__ import annotations

import numpy as np


def _resize_linear(img: np.ndarray, size_wh) -> np.ndarray:
    """``cv2.resize``'s default INTER_LINEAR of an HW float array to
    ``size_wh`` (W, H): the 2×2 neighbourhood at half-pixel centres, edges
    clamped, no antialiasing on a downscale (PIL's BILINEAR antialiases).
    The dtype is kept."""
    ow, oh = size_wh
    h, w = img.shape[:2]

    def coords(out_len, in_len):
        pos = (np.arange(out_len, dtype=np.float64) + 0.5) * (
            in_len / out_len) - 0.5
        i0 = np.clip(np.floor(pos).astype(np.int64), 0, in_len - 1)
        i1 = np.clip(i0 + 1, 0, in_len - 1)
        f = np.clip(pos - np.floor(pos), 0.0, 1.0)
        f[pos < 0] = 0.0
        return i0, i1, f

    y0, y1, fy = coords(oh, h)
    x0, x1, fx = coords(ow, w)
    a = img.astype(np.float64)
    fy = fy[:, None]
    top = a[y0][:, x0] * (1 - fx) + a[y0][:, x1] * fx
    bot = a[y1][:, x0] * (1 - fx) + a[y1][:, x1] * fx
    return (top * (1 - fy) + bot * fy).astype(img.dtype)
