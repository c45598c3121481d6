"""Evaluation metrics (the JAX package's ``utils/metrics.py``): the KITTI
depth suite of the reference harness (new_multi/my_eval.py:7-108) and the
segmentation pixel accuracy and confusion-matrix mIoU, in numpy.

Depth: each prediction is scaled /255·80 and clipped to [1, 50], the ground
truth masked to (1, 50); the prediction is then min-max renormalized to
[1, 50] and scored by AbsRel, SqRel, RMSE, RMSElog and δ < 1.25^{1,2,3}.
Images are read as ``cv2.imread(path, 0)`` reads them (``imread_gray8``)
and predictions resized to the ground truth's size by cv2's INTER_LINEAR
(``_resize_linear``), both as the JAX package computes them without cv2:
exact on gray maps at the ground truth's size, within 1 of cv2 on a
resized or colour 8-bit pixel.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


def compute_errors(ground_truth: np.ndarray, prediction: np.ndarray
                   ) -> Tuple[float, float, float, float, float, float, float]:
    """(abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3) over masked 1-D
    arrays, ``prediction`` min-max renormalized to [1, 50] first (a span of
    0 counts as 1e-6)."""
    span = prediction.max() - prediction.min()
    if span <= 0:
        span = 1e-6
    prediction = (prediction - prediction.min()) / span * 49 + 1
    threshold = np.maximum(ground_truth / prediction, prediction / ground_truth)
    a1 = float((threshold < 1.25).mean())
    a2 = float((threshold < 1.25 ** 2).mean())
    a3 = float((threshold < 1.25 ** 3).mean())
    rmse = float(np.sqrt(((ground_truth - prediction) ** 2).mean()))
    rmse_log = float(np.sqrt(((np.log(ground_truth)
                               - np.log(prediction)) ** 2).mean()))
    abs_rel = float(np.mean(np.abs(ground_truth - prediction) / ground_truth))
    sq_rel = float(np.mean(((ground_truth - prediction) ** 2) / ground_truth))
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


DEPTH_METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def eval_depth_pair(gt: np.ndarray, pred: np.ndarray
                    ) -> Optional[Dict[str, float]]:
    """One ground-truth/prediction pair of 8-bit maps under the KITTI
    val_selection protocol; None when no ground-truth pixel is in (1, 50)."""
    pred = np.clip(pred.astype(np.float64) / 255.0 * 80.0, 1.0, 50.0)
    gt = gt.astype(np.float64)
    mask = np.logical_and(gt > 1, gt < 50)
    if not mask.any():
        return None
    return dict(zip(DEPTH_METRIC_NAMES, compute_errors(gt[mask], pred[mask])))


def imread_gray8(path: str) -> np.ndarray:
    """An 8-bit gray image as ``cv2.imread(path, 0)`` reads the KITTI maps:
    16-bit samples keep their high byte (``>> 8``; PIL's ``convert('L')``
    would saturate the meters×256 ground truth at 255). This is the JAX
    package's cv2-free reader: colour goes to gray by rounding
    0.299 R + 0.587 G + 0.114 B, where cv2's fixed point may land 1 lower."""
    from PIL import Image

    arr = np.array(Image.open(path))
    if arr.ndim == 3:
        arr = (0.114 * arr[..., 2] + 0.587 * arr[..., 1]
               + 0.299 * arr[..., 0]).round()
    if arr.dtype == np.uint16 or arr.dtype == np.int32:
        arr = arr >> 8
    return arr.astype(np.uint8)


def _resize_linear(img: np.ndarray, size_wh) -> np.ndarray:
    """``cv2.resize``'s default INTER_LINEAR of an HW array to ``size_wh``
    (W, H): the 2×2 neighbourhood at half-pixel centres, edges clamped, no
    antialiasing on a downscale (PIL's BILINEAR antialiases). The dtype is
    kept; an integer result is rounded (cv2's fixed-point 8-bit path may
    round a pixel 1 the other way). At the input's size it is the input."""
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
    out = top * (1 - fy) + bot * fy
    if np.issubdtype(img.dtype, np.integer):
        out = np.round(out)
    return out.astype(img.dtype)


def eval_depth_dirs(gt_dir: str, pred_dir: str) -> Dict[str, float]:
    """The directory harness (my_eval.py:35-108): each ground-truth file with
    a prediction of the same name, both read by ``imread_gray8``, the
    prediction resized to the ground truth's size; the metrics averaged over
    the pairs with valid pixels. Raises ``ValueError`` when there are none."""
    pred_files = set(os.listdir(pred_dir))
    acc = {k: 0.0 for k in DEPTH_METRIC_NAMES}
    n = 0
    for f in sorted(os.listdir(gt_dir)):
        if f not in pred_files:
            continue
        gt = imread_gray8(os.path.join(gt_dir, f))
        pred = _resize_linear(imread_gray8(os.path.join(pred_dir, f)),
                              (gt.shape[1], gt.shape[0]))
        m = eval_depth_pair(gt, pred)
        if m is None:
            continue
        for k in acc:
            acc[k] += m[k]
        n += 1
    if n == 0:
        raise ValueError(
            f"no overlapping gt/pred files in {gt_dir} vs {pred_dir}")
    return {k: v / n for k, v in acc.items()}


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------


def pixel_accuracy(pred: np.ndarray, label: np.ndarray,
                   ignore_index: int = 255) -> float:
    """The share of labelled pixels (not ``ignore_index``) predicted right;
    0 when none is labelled."""
    mask = label != ignore_index
    if not mask.any():
        return 0.0
    return float((pred[mask] == label[mask]).mean())


def confusion_matrix(pred: np.ndarray, label: np.ndarray, num_classes: int,
                     ignore_index: int = 255) -> np.ndarray:
    """(label, prediction) counts over the pixels whose label and
    prediction are both in [0, num_classes) and whose label is not
    ``ignore_index``."""
    mask = ((label != ignore_index) & (label >= 0) & (label < num_classes)
            & (pred >= 0) & (pred < num_classes))
    idx = (label[mask].astype(np.int64) * num_classes
           + pred[mask].astype(np.int64))
    cm = np.bincount(idx, minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes)


def miou_from_confusion(cm: np.ndarray) -> float:
    """Mean IoU over the classes that occur in the labels or predictions."""
    inter = np.diag(cm).astype(np.float64)
    union = cm.sum(0) + cm.sum(1) - np.diag(cm)
    valid = union > 0
    if not valid.any():
        return 0.0
    return float((inter[valid] / union[valid]).mean())


def miou(pred: np.ndarray, label: np.ndarray, num_classes: int,
         ignore_index: int = 255) -> float:
    return miou_from_confusion(
        confusion_matrix(pred, label, num_classes, ignore_index))
