"""Label and depth preprocessing of the SYNTHIA↔Cityscapes pair (the part
of the JAX package's ``data/preprocess.py`` that the ``synthia`` dataset
reads; reference datasets/dataset_synthia.py:93-147, dataset_kitti.py:90-92).

The reference remaps label ids by iterating a dict and mutating the array
as it goes, so a later rule sees the earlier rules' results; the tables
here are ordered (key, value) rules applied the same way, collapsed into
one lookup array (``compose_lut``) for labels in [0, 256).
"""

from __future__ import annotations

import numpy as np

IGNORE_LABEL_SYNTHIA = 255

# SYNTHIA 23 classes → 22 train ids, 0 → ignore
SYN_ID_TO_TRAINID = ([(0, IGNORE_LABEL_SYNTHIA)]
                     + [(k, k - 1) for k in range(1, 23)])

# Cityscapes 34 classes → 28 train ids, ids ≤ 5 → ignore
REAL_ID_TO_TRAINID_255 = ([(k, IGNORE_LABEL_SYNTHIA) for k in range(-1, 6)]
                          + [(k, k - 6) for k in range(6, 34)])


def compose_lut(table, size: int = 256) -> np.ndarray:
    """The ordered (key → value) rules as one lookup array over [0, size):
    each rule rewrites the values the earlier rules left, as the
    reference's in-place iteration does."""
    lut = np.arange(size, dtype=np.int64)
    for k, v in table:
        lut[lut == k] = v
    return lut


def remap_sequential(labels: np.ndarray, table) -> np.ndarray:
    """Apply the rules in order: one gather through ``compose_lut`` for
    labels in [0, 256), else the rules one by one. Keeps the dtype."""
    if labels.size and labels.min() >= 0 and labels.max() < 256:
        return compose_lut(table)[labels.astype(np.int64)].astype(labels.dtype)
    out = labels.copy()
    for k, v in table:
        out[out == k] = v
    return out


def clip_depth_8000(depth: np.ndarray) -> np.ndarray:
    """A 16-bit depth map clipped to [0, 8000] and scaled to [0, 1], HW1
    float32."""
    d = np.clip(depth.astype(np.float32), 0, 8000)
    return (d / 8000.0)[..., None]
