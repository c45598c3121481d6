"""``save_images`` for the test CLI (the JAX package's
``utils/visualizer.py``, reference util/visualizer.py:17-39)."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .html import HTML
from .images import save_image, tensor2im


def save_images(webpage: HTML, visuals: Dict[str, torch.Tensor],
                image_path: str, aspect_ratio: float = 1.0, width: int = 256):
    """Write one sample's visuals (CHW tensors in [-1, 1]) into a gallery."""
    image_dir = webpage.get_image_dir()
    name = os.path.splitext(os.path.basename(image_path))[0]
    webpage.add_header(name)
    ims, txts, links = [], [], []
    for label, im_data in visuals.items():
        im = tensor2im(im_data)
        # the reference stretches saved images by aspect_ratio, bicubic
        h, w = im.shape[:2]
        if aspect_ratio != 1.0:
            from PIL import Image

            tw = int(w * aspect_ratio) if aspect_ratio > 1.0 else w
            th = h if aspect_ratio > 1.0 else int(h / aspect_ratio)
            im = np.asarray(Image.fromarray(im).resize((tw, th), Image.BICUBIC))
        image_name = f"{name}_{label}.png"
        save_image(im, os.path.join(image_dir, image_name))
        ims.append(image_name)
        txts.append(label)
        links.append(image_name)
    webpage.add_images(ims, txts, links, width=width)
