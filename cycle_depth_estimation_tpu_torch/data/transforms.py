"""Host-side image transforms (the JAX package's ``data/transforms.py``,
reference data/base_dataset.py:24-102).

Modes ``resize_and_crop | crop | scale_width | scale_width_and_crop |
none``, a random crop (train) or center crop (eval) where the mode crops, a
random horizontal flip in training unless ``no_flip``, then Normalize(0.5)
to [-1, 1]. Randomness comes from an explicit numpy ``Generator`` per
sample, drawn in the JAX package's order, so one rng gives bit-identical
arrays on both sides. PIL decodes and resizes (bicubic, as the reference);
crops and flips are numpy slices. Output is HWC float32; the dataset makes
it a CHW tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image


def load_rgb(path: str) -> Image.Image:
    return Image.open(path).convert("RGB")


def resize(img: Image.Image, size: Tuple[int, int]) -> Image.Image:
    """size = (w, h), bicubic."""
    return img.resize(size, Image.BICUBIC)


def scale_width(img: Image.Image, target_width: int) -> Image.Image:
    """Width → target, height → multiple of 4 (reference __scale_width)."""
    ow, oh = img.size
    mult = 4
    if ow == target_width and oh % mult == 0:
        return img
    target_height = int(target_width * oh / ow)
    h = ((target_height - 1) // mult + 1) * mult
    return img.resize((target_width, h), Image.BICUBIC)


def adjust_to_multiple(img: Image.Image, mult: int = 4) -> Image.Image:
    """Round sizes up to a multiple of ``mult`` (reference __adjust)."""
    ow, oh = img.size
    if ow % mult == 0 and oh % mult == 0:
        return img
    w = ((ow - 1) // mult + 1) * mult
    h = ((oh - 1) // mult + 1) * mult
    return img.resize((w, h), Image.BICUBIC)


def to_array(img: Image.Image) -> np.ndarray:
    """ToTensor's scaling → HWC float32 in [0, 1]."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def normalize(arr: np.ndarray, mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    return (arr - mean) / std


def random_crop(arr: np.ndarray, size: int, rng: np.random.Generator
                ) -> np.ndarray:
    h, w = arr.shape[:2]
    top = int(rng.integers(0, h - size + 1)) if h > size else 0
    left = int(rng.integers(0, w - size + 1)) if w > size else 0
    return arr[top:top + size, left:left + size]


def maybe_hflip(arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    if rng.random() < 0.5:
        return arr[:, ::-1]
    return arr


def rgb_to_gray(arr: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma, HWC → HW1."""
    return (arr[..., 0:1] * 0.299 + arr[..., 1:2] * 0.587 + arr[..., 2:3] * 0.114)


def apply_resize_only(img: Image.Image, cfg) -> np.ndarray:
    """The host half of ``device_aug``: decode and resize only, uint8 HWC at
    ``load_size``; crop, flip, normalize and grayscale run on the device
    (``device_transforms.py``). Only ``resize_and_crop`` gives one shape
    per batch."""
    if cfg.resize_or_crop != "resize_and_crop":
        raise ValueError(f"--device_aug supports resize_or_crop="
                         f"resize_and_crop only (got {cfg.resize_or_crop})")
    arr = np.asarray(resize(img, (cfg.load_size, cfg.load_size)), np.uint8)
    return arr[:, :, None] if arr.ndim == 2 else arr


def apply_transform(img: Image.Image, cfg, rng: Optional[np.random.Generator],
                    grayscale: bool = False) -> np.ndarray:
    """The reference get_transform pipeline for one image. ``rng=None`` is
    the eval path: center crop, no flip."""
    mode = cfg.resize_or_crop
    if mode == "resize_and_crop":
        img = resize(img, (cfg.load_size, cfg.load_size))
    elif mode == "scale_width":
        img = scale_width(img, cfg.fine_size)
    elif mode == "scale_width_and_crop":
        img = scale_width(img, cfg.load_size)
    elif mode == "none":
        img = adjust_to_multiple(img)
    elif mode != "crop":
        raise ValueError(f"--resize_or_crop {mode} is not a valid option.")

    arr = to_array(img)
    if mode in ("resize_and_crop", "crop", "scale_width_and_crop"):
        if rng is not None:
            arr = random_crop(arr, cfg.fine_size, rng)
        else:
            h, w = arr.shape[:2]
            top = max(0, (h - cfg.fine_size) // 2)
            left = max(0, (w - cfg.fine_size) // 2)
            arr = arr[top:top + cfg.fine_size, left:left + cfg.fine_size]
    if cfg.is_train and not cfg.no_flip and rng is not None:
        arr = maybe_hflip(arr, rng)
    arr = normalize(arr)
    if grayscale:
        arr = rgb_to_gray(arr)
    return np.ascontiguousarray(arr, dtype=np.float32)
