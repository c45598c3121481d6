"""The domain-pair datasets (the JAX package's ``data/domain_datasets.py``):
``synthia`` (SYNTHIA↔Cityscapes, reference datasets/dataset_synthia.py:60-258)
and ``try`` (vKITTI→KITTI for S2D, reference new_multi/try_data.py:70-376).

A sample holds a source (SYNTHIA) image, its labels and its depth, and a
target (Cityscapes) image and its labels, all at 640×192 (w×h) at the
default ``fine_size`` 256, else ``fine_size`` high at the same aspect.
Images are resized bilinear, labels nearest; labels are remapped to 22
(source) and 28 (target) train ids with 255 ignored; in the train phase
each image and its labels get one joint h-flip (p .5) and ±5° rotation
(p .5). The depth is clipped to 8000 and scaled to [0, 1] (the JAX
package's documented substitution for the reference's unscaled depth; no
model reads it). The target index and every draw come from the numpy
``Generator`` of (seed, epoch, index), so the samples are the JAX
package's exactly.

Samples: ``img_source``/``img_target`` CHW float32 in [-1, 1],
``lab_source``/``lab_target`` HW int64, ``depth_source`` 1HW float32, and
the two image paths. Each ``*_file_{train,test}`` option names a folder or
a ``.txt`` list of paths.

``try`` works at 576×192 at the default ``fine_size`` 192 (3:1); its
samples are described in ``TryDataset``. ``kitti`` (vKITTI images and depth
against KITTI images) is described in ``KittiDataset``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from PIL import Image

from . import register_dataset
from .datasets import _Base, _chw
from .image_folder import make_dataset, make_dataset_txt
from ..utils.metrics import _resize_linear
from .preprocess import (REAL_ID_TO_TRAINID_0, REAL_ID_TO_TRAINID_255,
                         SYN_ID_TO_TRAINID, clip_depth_8000, depth_bands,
                         label_edges, remap_sequential)
from .transforms import normalize, to_array


def _paths(path: str):
    return make_dataset_txt(path) if path.endswith(".txt") else make_dataset(path)


def paired_augment(rng: np.random.Generator, images, resamples):
    """One h-flip (p .5) and one ±5° rotation (p .5) for all of ``images``,
    each rotated with its own resampling filter."""
    out = list(images)
    if rng.random() > 0.5:
        out = [im.transpose(Image.FLIP_LEFT_RIGHT) for im in out]
    if rng.random() > 0.5:
        degree = int(rng.integers(-500, 500)) / 100.0
        out = [im.rotate(degree, resample=rs) for im, rs in zip(out, resamples)]
    return out


@register_dataset("synthia")
class SynthiaDataset(_Base):
    ASPECT = 640 / 192

    def __init__(self, cfg, phase: str):
        super().__init__(cfg)
        self.phase = phase
        suffix = "train" if phase == "train" else "test"
        for attr in ("img_source", "img_target", "lab_source", "lab_target",
                     "depth_source"):
            setattr(self, f"{attr}_paths",
                    _paths(getattr(cfg, f"{attr}_file_{suffix}")))

    @property
    def size(self):
        """(w, h)."""
        h = self.cfg.fine_size if self.cfg.fine_size != 256 else 192
        return int(round(h * self.ASPECT)), h

    def __len__(self):
        return max(len(self.img_source_paths), len(self.img_target_paths))

    def __getitem__(self, item: int) -> Dict[str, object]:
        rng = self._rng(item)
        size = self.size
        n_src = len(self.img_source_paths)
        index = int(rng.integers(0, len(self.img_target_paths)))
        img_source, img_target = (
            Image.open(p).convert("RGB").resize(size, Image.BILINEAR)
            for p in (self.img_source_paths[item % n_src],
                      self.img_target_paths[index]))
        depth = Image.open(self.depth_source_paths[
            item % len(self.depth_source_paths)]).resize(size, Image.BILINEAR)
        lab_source = Image.open(self.lab_source_paths[
            item % len(self.lab_source_paths)]).resize(size, Image.NEAREST)
        lab_target = Image.open(self.lab_target_paths[index]).resize(
            size, Image.NEAREST)
        lab_source = Image.fromarray(remap_sequential(
            np.array(lab_source), SYN_ID_TO_TRAINID).astype(np.uint8))
        lab_target = Image.fromarray(remap_sequential(
            np.array(lab_target), REAL_ID_TO_TRAINID_255).astype(np.uint8))
        if self.phase == "train":
            img_source, lab_source = paired_augment(
                rng, [img_source, lab_source], [Image.BILINEAR, Image.NEAREST])
            img_target, lab_target = paired_augment(
                rng, [img_target, lab_target], [Image.BILINEAR, Image.NEAREST])

        def img(im):
            return _chw(normalize(to_array(im)).astype(np.float32))

        return {
            "img_source": img(img_source),
            "img_target": img(img_target),
            "lab_source": torch.from_numpy(np.array(lab_source, np.int64)),
            "lab_target": torch.from_numpy(np.array(lab_target, np.int64)),
            "depth_source": _chw(clip_depth_8000(np.array(depth))),
            "img_source_paths": self.img_source_paths[item % n_src],
            "img_target_paths": self.img_target_paths[index],
        }


@register_dataset("kitti")
class KittiDataset(_Base):
    """vKITTI (image, 16-bit depth) → KITTI (image), unpaired (reference
    datasets/dataset_kitti.py). At 640×192 (w×h) at the default
    ``fine_size`` 256, else ``fine_size`` high at 640:192. Images are
    resized bicubic, the depth bilinear; no augmentation. Samples:
    ``img_source``/``img_target`` 3HW in [-1, 1] and the two paths; in the
    train phase of a train config also ``lab_source`` (the depth through
    ``clip_depth_8000``, 1HW in [0, 1]) and its path. The target index comes
    from the numpy ``Generator`` of (seed, epoch, index)."""

    ASPECT = 640 / 192

    @property
    def size(self):
        """(w, h)."""
        h = self.cfg.fine_size if self.cfg.fine_size != 256 else 192
        return int(round(h * self.ASPECT)), h

    def __init__(self, cfg, phase: str):
        super().__init__(cfg)
        self.phase = phase
        suffix = "train" if phase == "train" else "test"
        for attr, opt in (("img_source", "img_source"),
                          ("img_target", "img_target"),
                          ("lab_source", "depth_source")):
            setattr(self, f"{attr}_paths",
                    _paths(getattr(cfg, f"{opt}_file_{suffix}")))

    def __len__(self):
        return max(len(self.img_source_paths), len(self.img_target_paths))

    def __getitem__(self, item: int) -> Dict[str, object]:
        rng = self._rng(item)
        size = self.size
        index = int(rng.integers(0, len(self.img_target_paths)))
        src_path = self.img_source_paths[item % len(self.img_source_paths)]
        tgt_path = self.img_target_paths[index]
        img_source, img_target = (
            _chw(normalize(to_array(Image.open(p).convert("RGB").resize(
                size, Image.BICUBIC))).astype(np.float32))
            for p in (src_path, tgt_path))
        out = {"img_source": img_source, "img_target": img_target,
               "img_source_paths": src_path, "img_target_paths": tgt_path}
        if self.cfg.is_train and self.phase == "train":
            dep_path = self.lab_source_paths[item % len(self.lab_source_paths)]
            depth = Image.open(dep_path).resize(size, Image.BILINEAR)
            out["lab_source"] = _chw(clip_depth_8000(np.array(depth)))
            out["lab_source_paths"] = dep_path
        return out


@register_dataset("try")
class TryDataset(_Base):
    """vKITTI (image, labels, 16-bit depth) → KITTI (image, labels), the
    S2D loader. Images are resized bilinear to ``size``; labels keep their
    size until the edge maps are drawn from them.

    Train phase: one joint flip/rotation (``paired_augment``) of the
    synthetic image, labels and depth, another of the real image and
    labels; vKITTI ids 0 → 7, then the 34-class remap with ignore 0; real
    ids − 6, negatives → 0; ``label_edges`` of both at their own size,
    linear-resized (``_resize_linear``) to ``size``; the labels
    nearest-resized; ``depth_bands`` in train mode. Keys: ``img_syn``,
    ``img_real`` (3HW), ``dep_l_syn`` (1HW), ``depth_l_s`` (4HW),
    ``seg_l_syn``, ``seg_l_real`` (HW int64), ``seg_e_syn``, ``seg_e_real``
    (1HW), the two image paths and ``name``.

    Test phase: no augmentation; the synthetic labels nearest-resized
    first, their edges from the ids before the remap, ``depth_bands`` in
    eval mode; no real labels; ``f_name``/``l_name``, the KITTI
    ``depth_selection`` file-name slices of the real path."""

    @property
    def size(self):
        """(w, h)."""
        h = self.cfg.fine_size if self.cfg.fine_size != 256 else 192
        return h * 3, h

    def __init__(self, cfg, phase: str):
        super().__init__(cfg)
        self.phase = phase
        suffix = "train" if phase == "train" else "test"
        attrs = [("img_syn", "img_source"), ("img_real", "img_target"),
                 ("lab_syn", "lab_source"), ("depth", "depth_source")]
        if phase == "train":
            attrs.append(("lab_real", "lab_target"))
        for attr, opt in attrs:
            setattr(self, f"{attr}_paths",
                    _paths(getattr(cfg, f"{opt}_file_{suffix}")))

    def __len__(self):
        return max(len(self.img_syn_paths), len(self.img_real_paths))

    def __getitem__(self, item: int) -> Dict[str, object]:
        rng = self._rng(item)
        w, h = self.size
        index = int(rng.integers(0, len(self.img_real_paths)))
        img_syn_path = self.img_syn_paths[item % len(self.img_syn_paths)]
        img_real_path = self.img_real_paths[index]
        img_syn, img_real = (
            Image.open(p).convert("RGB").resize((w, h), Image.BILINEAR)
            for p in (img_syn_path, img_real_path))
        depth = Image.open(self.depth_paths[
            item % len(self.depth_paths)]).resize((w, h), Image.BILINEAR)
        lab_syn = Image.open(self.lab_syn_paths[
            item % len(self.lab_syn_paths)])

        def img(im):
            return _chw(normalize(to_array(im)).astype(np.float32))

        def labels(a):
            return torch.from_numpy(a.astype(np.int64))

        def edges(e):
            return torch.from_numpy(e.astype(np.float32)[None])

        if self.phase != "train":
            lab_raw = np.array(lab_syn.resize((w, h), Image.NEAREST))
            lab = lab_raw.astype(np.float32)
            lab[lab == 0] = 7
            full, bands = depth_bands(np.array(depth), train=False)
            return {
                "img_syn": img(img_syn), "img_real": img(img_real),
                "dep_l_syn": _chw(full), "depth_l_s": _chw(bands),
                "seg_l_syn": labels(remap_sequential(lab,
                                                     REAL_ID_TO_TRAINID_0)),
                "seg_e_syn": edges(label_edges(lab_raw)),
                "img_source_paths": img_syn_path,
                "img_target_paths": img_real_path,
                "f_name": img_real_path[-56:-29],
                "l_name": img_real_path[-24:],
            }

        lab_real = Image.open(self.lab_real_paths[index])
        img_syn, lab_syn, depth = paired_augment(
            rng, [img_syn, lab_syn, depth],
            [Image.BILINEAR, Image.NEAREST, Image.NEAREST])
        img_real, lab_real = paired_augment(
            rng, [img_real, lab_real], [Image.BILINEAR, Image.NEAREST])
        lab_s = np.array(lab_syn).astype(np.float32)
        lab_s[lab_s == 0] = 7
        lab_s = remap_sequential(lab_s, REAL_ID_TO_TRAINID_0)
        lab_r = np.array(lab_real).astype(np.float32) - 6
        lab_r[lab_r < 0] = 0
        full, bands = depth_bands(np.array(depth), train=True)
        return {
            "img_syn": img(img_syn), "img_real": img(img_real),
            "dep_l_syn": _chw(full), "depth_l_s": _chw(bands),
            "seg_l_syn": labels(_resize_labels(lab_s.astype(np.uint8),
                                               (w, h))),
            "seg_l_real": labels(_resize_labels(lab_r.astype(np.uint8),
                                                (w, h))),
            "seg_e_syn": edges(_resize_map(label_edges(lab_s), (w, h))),
            "seg_e_real": edges(_resize_map(label_edges(lab_r), (w, h))),
            "img_source_paths": img_syn_path,
            "img_target_paths": img_real_path,
            "name": img_real_path[-14:],
        }


def _resize_labels(lab: np.ndarray, size) -> np.ndarray:
    """Nearest-neighbour resize of a uint8 label map to ``size`` (w, h).
    The reference passes ``cv2.INTER_NEAREST`` as cv2.resize's ``dst`` and
    so interpolates labels bilinearly (try_data.py:224-225); that is not
    reproduced, as in the JAX package."""
    return np.array(Image.fromarray(lab).resize(size, Image.NEAREST))


def _resize_map(m: np.ndarray, size) -> np.ndarray:
    """cv2's INTER_LINEAR resize of an edge map to ``size`` (w, h), float32
    (reference try_data.py:219-220)."""
    return _resize_linear(m.astype(np.float32), size).astype(np.float32)
