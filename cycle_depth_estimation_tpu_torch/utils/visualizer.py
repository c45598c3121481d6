"""Galleries and loss logs (the JAX package's ``utils/visualizer.py``,
reference util/visualizer.py:17-169): ``save_images`` for the test CLI, and
``Visualizer`` for the train CLI — the console and ``loss_log.txt`` loss
printer, a ``scalars.jsonl`` time series, per-epoch images of the current
visuals and their HTML page. The reference's visdom display is off in its
own constructor and is absent here, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np
import torch

from .html import HTML
from .images import depth2im, label2im, save_image, tensor2im


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


class Visualizer:
    def __init__(self, cfg):
        self.name = cfg.name
        expr_dir = cfg.expr_dir()
        self.web_dir = os.path.join(expr_dir, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.log_name = os.path.join(expr_dir, "loss_log.txt")
        self.scalar_log = os.path.join(expr_dir, "scalars.jsonl")
        with open(self.log_name, "a") as fh:
            now = time.strftime("%c")
            fh.write(f"================ Training Loss ({now}) ================\n")

    def display_current_results(self, visuals: Dict[str, torch.Tensor],
                                epoch: int):
        """Save the first image of each visual (NCHW in [-1, 1]; a label map
        where the name holds ``lab`` or ``seg``, colorized; a depth map where
        it holds ``dep``, stretched to gray) as
        ``images/epoch{NNN}_{label}.png``."""
        for label, image in visuals.items():
            if "lab" in label or "seg" in label:
                im = label2im(image)
            elif "dep" in label:
                im = depth2im(image)
            else:
                im = tensor2im(image)
            save_image(im, os.path.join(self.img_dir,
                                        f"epoch{epoch:03d}_{label}.png"))

    def log_scalars(self, epoch: int, iters: int, losses: Dict[str, float]):
        rec = {"epoch": epoch, "iters": iters, "t": time.time()}
        rec.update({k: float(v) for k, v in losses.items()})
        with open(self.scalar_log, "a") as fh:
            fh.write(json.dumps(rec) + "\n")

    def print_current_losses(self, epoch: int, iters: int,
                             losses: Dict[str, float], t: float, t_data: float):
        message = (f"(epoch: {epoch}, iters: {iters}, time: {t:.3f}, "
                   f"data: {t_data:.3f}) ")
        message += " ".join(f"{k}: {float(v):.3f}" for k, v in losses.items())
        print(message)
        with open(self.log_name, "a") as fh:
            fh.write(message + "\n")

    def save_html(self, epoch: int):
        """``web/index.html``: the saved visuals of every epoch, newest
        first."""
        webpage = HTML(self.web_dir, f"Experiment name = {self.name}")
        names = sorted(os.listdir(self.img_dir))
        for n in range(epoch, 0, -1):
            prefix = f"epoch{n:03d}_"
            ims = [f for f in names if f.startswith(prefix)]
            webpage.add_header(f"epoch [{n}]")
            if ims:
                webpage.add_images(ims, [f[len(prefix):-4] for f in ims], ims)
        webpage.save()
