"""Recursive image-directory walker (reference data/image_folder.py:14-68)
and the file-list reader of the domain datasets."""

from __future__ import annotations

import os
from typing import List

IMG_EXTENSIONS = (
    ".jpg", ".JPG", ".jpeg", ".JPEG",
    ".png", ".PNG", ".ppm", ".PPM", ".bmp", ".BMP",
)


def is_image_file(filename: str) -> bool:
    return filename.endswith(IMG_EXTENSIONS)


def make_dataset(directory: str) -> List[str]:
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"{directory} is not a valid directory")
    images = []
    for root, _, fnames in sorted(os.walk(directory)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
    return images


def make_dataset_txt(list_path: str, check_exists: bool = True) -> List[str]:
    """One path per non-empty line of ``list_path``; with ``check_exists``
    only those that exist."""
    with open(list_path) as fh:
        paths = [ln.strip() for ln in fh if ln.strip()]
    if check_exists:
        paths = [p for p in paths if os.path.exists(p)]
    return paths
