"""Label and depth preprocessing of the domain-pair datasets (the part of
the JAX package's ``data/preprocess.py`` that the ``synthia`` and ``try``
datasets read; reference datasets/dataset_synthia.py:93-147,
dataset_kitti.py:90-92, new_multi/try_data.py:43-68, 125-155, 240-272).

The reference remaps label ids by iterating a dict and mutating the array
as it goes, so a later rule sees the earlier rules' results; the tables
here are ordered (key, value) rules applied the same way, collapsed into
one lookup array (``compose_lut``) for labels in [0, 256).

``label_edges`` keeps the reference's suppression of class 21 (sky);
``depth_bands`` keeps its train/eval formula split and, in train mode, its
band-5 offset by the normalized band 4's minimum. Where the reference
divides by a span of 0 (a constant map) the span is clamped to 1e-6
(``_safe_span``), as in the JAX package.
"""

from __future__ import annotations

import numpy as np

IGNORE_LABEL_SYNTHIA = 255
IGNORE_LABEL_TRY = 0

# SYNTHIA 23 classes → 22 train ids, 0 → ignore
SYN_ID_TO_TRAINID = ([(0, IGNORE_LABEL_SYNTHIA)]
                     + [(k, k - 1) for k in range(1, 23)])

# Cityscapes 34 classes → 28 train ids, ids ≤ 5 → ignore
REAL_ID_TO_TRAINID_255 = ([(k, IGNORE_LABEL_SYNTHIA) for k in range(-1, 6)]
                          + [(k, k - 6) for k in range(6, 34)])

# the same for ``try``, whose ignore label is 0
REAL_ID_TO_TRAINID_0 = ([(k, IGNORE_LABEL_TRY) for k in range(-1, 6)]
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


def label_edges(labels: np.ndarray, suppress_class: int = 21) -> np.ndarray:
    """4-neighbour label-difference edge map of an HW label map, float64
    {0, 1}. A pixel of ``suppress_class`` makes each shifted comparison
    equal (that class draws no edge); the zero padding at the borders makes
    a nonzero border label an edge."""
    lab = labels.astype(np.uint8)
    sky = lab == suppress_class
    edge = np.zeros(lab.shape, np.float64)
    h, w = lab.shape
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        s = np.zeros_like(lab)
        s[max(0, dy):h - max(0, -dy), max(0, dx):w - max(0, -dx)] = \
            lab[max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)]
        s[sky] = suppress_class
        edge[lab != s] = 1.0
    return edge


def _safe_span(lo: float, hi: float) -> float:
    return max(hi - lo, 1e-6)


def depth_bands(depth: np.ndarray, train: bool = True):
    """``(full, bands)`` of a 16-bit depth map: ``full`` HW1 in [-1, 1] and
    ``bands`` HW4, the clipped and renormalized ranges 5000–8000,
    3000–6000, 1000–4000 and 0–2000, float32. Train mode normalizes each
    by its own (min, max); eval mode by its max alone."""
    d0 = depth.astype(np.float32)
    d = np.minimum(d0, 8000)
    d2 = np.where(d0 < 5000, np.float32(5000), np.minimum(d0, 8000))
    d2 = 2 * (d2 - d2.min()) / _safe_span(d2.min(), d2.max()) - 1
    d3 = np.clip(d0, 3000, 6000)
    d3 = 2 * (d3 - d3.min()) / _safe_span(d3.min(), d3.max()) - 1
    d4 = np.clip(d0, 1000, 4000)
    d4n = 2 * (d4 - d4.min()) / _safe_span(d4.min(), d4.max()) - 1
    d5 = np.minimum(d0, 2000)
    if train:
        # the reference offsets band 5 by band 4's minimum after band 4 was
        # normalized, that is by -1 (try_data.py:268)
        d5n = 2 * (d5 - d4n.min()) / _safe_span(d5.min(), d5.max()) - 1
        full = 2 * (d - d.min()) / _safe_span(d.min(), d.max()) - 1
    else:
        d5n = 2 * d5 / max(d5.max(), 1e-6) - 1
        full = 2 * d / max(d.max(), 1e-6) - 1
    bands = np.stack([d2, d3, d4n, d5n], axis=-1).astype(np.float32)
    return full[..., None].astype(np.float32), bands
