"""Inference CLI of the port (the root ``test.py`` of the JAX package,
reference test.py:9-40).

Builds the generator (random init from ``--seed``, or a reference ``.pth``
through ``--pth_path``), runs it over a folder of images and writes an HTML
gallery of input/output pairs under ``<results_dir>/<name>/<phase>_<epoch>/``::

    python -m cycle_depth_estimation_tpu_torch.test --dataroot <dir> \\
        --netG resnet_9blocks [--pth_path <file>] [--dtype bfloat16] \\
        [--num_test N] [--device cuda|cpu]
"""

from __future__ import annotations

import os


def main(argv=None) -> str:
    from .config import parse_args, print_options
    from .data import create_dataloader
    from .models import create_model
    from .utils.html import HTML
    from .utils.visualizer import save_images

    cfg = parse_args(argv, is_train=False)
    # reference TestOptions: batch 1, loadSize=fineSize, no flip, serial
    # order
    cfg = cfg.replace(load_size=cfg.fine_size, batch_size=1, no_flip=True,
                      serial_batches=True)
    print(print_options(cfg))

    model = create_model(cfg)
    if cfg.pth_path:
        model.load_reference_generator(cfg.pth_path)
    else:
        print("warning: no --pth_path given — running with random init")
    loader = create_dataloader(cfg, phase=cfg.phase, shuffle=False)

    web_dir = os.path.join(cfg.results_dir, cfg.name, f"{cfg.phase}_{cfg.epoch}")
    webpage = HTML(web_dir, f"Experiment = {cfg.name}, Phase = {cfg.phase}, "
                            f"Epoch = {cfg.epoch}")
    n_done = 0
    for batch in loader:
        if n_done >= cfg.num_test:
            break
        _, visuals = model.eval_step(batch)
        for b, path in enumerate(batch["A_paths"]):
            if n_done >= cfg.num_test:
                break
            print(f"processing ({n_done:04d})-th image... {path}")
            save_images(webpage, {k: v[b] for k, v in visuals.items()}, path,
                        aspect_ratio=cfg.aspect_ratio,
                        width=cfg.display_winsize)
            n_done += 1
    webpage.save()
    return web_dir


if __name__ == "__main__":
    main()
