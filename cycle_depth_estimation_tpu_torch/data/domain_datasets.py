"""The SYNTHIA↔Cityscapes domain-pair dataset (``synthia``; the JAX
package's ``data/domain_datasets.py``, reference
datasets/dataset_synthia.py:60-258).

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
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from PIL import Image

from . import register_dataset
from .datasets import _Base, _chw
from .image_folder import make_dataset, make_dataset_txt
from .preprocess import (REAL_ID_TO_TRAINID_255, SYN_ID_TO_TRAINID,
                         clip_depth_8000, remap_sequential)
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
