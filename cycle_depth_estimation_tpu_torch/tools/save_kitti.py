"""Write refined depth maps for the KITTI depth_selection split (the JAX
repository's ``tools/save_kitti.py``, reference new_multi/save_kitti.py:
32-75): run an S2D or RefineNet-LW (``rf_lw``, ``rf_lw7``) model over the
``try`` loader's test split and write each real image's refined depth
(``real_dep_ref``, or ``real_dep_pre`` where the model has no refiner) as an
8-bit PNG named by the KITTI crop name the loader slices from the path
(``f_name``), ready for ``eval_kitti``::

    python -m cycle_depth_estimation_tpu_torch.tools.save_kitti \\
        --model S2D --epoch latest --name <run> --checkpoints_dir <dir> \\
        --img_source_file_test … --img_target_file_test … \\
        --lab_source_file_test … --depth_source_file_test … \\
        --out_dir preds/ [--num_test N] [--device cpu]

The nets come from the run's ``--epoch`` checkpoint (``load_networks``);
without one the seeded random init is used, with a warning.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def save_depth_maps(cfg, out_dir: str, max_items: int = 10 ** 9,
                    model=None, state=None) -> int:
    """Write at most ``max_items`` maps into ``out_dir``; returns how many.
    ``model``/``state`` default to ``cfg``'s model at its ``--epoch``
    checkpoint. A map is ``(d + 1) / 2 · 255`` of the depth d in [-1, 1],
    clipped and truncated to uint8."""
    from PIL import Image

    from ..data import create_dataloader
    from ..models import create_model

    loader = create_dataloader(cfg.replace(is_train=False), phase="test",
                               shuffle=False)
    try:
        if model is None:
            model = create_model(cfg)
        if state is None:
            state = model.init_state()
            if model.has_checkpoint(cfg.epoch):
                state = model.load_networks(state, cfg.epoch)
            else:
                print("warning: no checkpoint found — random init")
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for batch in loader:
            if n >= max_items:
                break
            _, visuals = model.eval_step(state, batch)
            key = "real_dep_ref" if "real_dep_ref" in visuals else "real_dep_pre"
            dep = visuals[key].detach().float().cpu().numpy()  # N1HW
            names = batch.get("f_name") or [""] * dep.shape[0]
            for b in range(dep.shape[0]):
                if n >= max_items:
                    break
                name = names[b] or f"{n:06d}.png"
                if not name.endswith(".png"):
                    name = name + ".png"
                img = ((dep[b, 0] + 1.0) / 2.0 * 255.0).clip(0, 255)
                Image.fromarray(img.astype(np.uint8)).save(
                    os.path.join(out_dir, os.path.basename(name)))
                n += 1
        return n
    finally:
        loader.close()


def main(argv=None):
    from ..config import parse_args

    args = list(sys.argv[1:] if argv is None else argv)
    out_dir = "./save_kitti"
    if "--out_dir" in args:
        i = args.index("--out_dir")
        out_dir = args[i + 1]
        del args[i:i + 2]
    cfg = parse_args(args, is_train=False)
    n = save_depth_maps(cfg, out_dir, max_items=cfg.num_test)
    print(f"wrote {n} depth maps to {out_dir}")
    return n


if __name__ == "__main__":
    main()
