"""Inference CLI of the port (the root ``test.py`` of the JAX package,
reference test.py:9-40).

Builds the model ``--model`` (default ``test``: the generator alone, from
``--seed`` or a reference ``.pth`` through ``--pth_path``; a trained model
such as ``pix2pix`` loads ``<checkpoints_dir>/<name>/<epoch>_net_*.pth``
where they exist, else keeps its seeded init), runs it over a folder of
images and writes an HTML gallery of its visuals under
``<results_dir>/<name>/<phase>_<epoch>/``::

    python -m cycle_depth_estimation_tpu_torch.test --dataroot <dir> \\
        --netG resnet_9blocks [--pth_path <file>] [--dtype bfloat16] \\
        [--num_test N] [--device cuda|cpu]
    python -m cycle_depth_estimation_tpu_torch.test --model pix2pix \\
        --dataroot <dir with test/> --name <run> [--device_aug]
"""

from __future__ import annotations

import os


def main(argv=None) -> str:
    import torch

    from .config import parse_args, print_options
    from .data import create_dataloader
    from .data.device_transforms import wrap_for_config
    from .data.loader import prefetch_to_device
    from .models import create_model
    from .utils.html import HTML
    from .utils.visualizer import save_images

    cfg = parse_args(argv, is_train=False)
    # reference TestOptions: batch 1, loadSize=fineSize, no flip, serial
    # order
    cfg = cfg.replace(load_size=cfg.fine_size, batch_size=1, no_flip=True,
                      serial_batches=True, num_threads=1)
    print(print_options(cfg))

    model = create_model(cfg)
    state = model.init_state() if hasattr(model, "init_state") else None
    if cfg.pth_path:
        if not hasattr(model, "load_reference_generator"):
            raise SystemExit(f"--pth_path: model {cfg.model} loads its "
                             "checkpoints from --checkpoints_dir/--name")
        model.load_reference_generator(cfg.pth_path)
    elif state is not None and model.has_checkpoint(cfg.epoch):
        model.load_nets(state, cfg.epoch)
    else:
        print("warning: no checkpoint given — running with random init")
    loader = create_dataloader(cfg, phase=cfg.phase, shuffle=False)
    batches = prefetch_to_device(loader, model.device)
    if cfg.device_aug:
        batches = wrap_for_config(batches, cfg, torch.Generator(
            model.device).manual_seed(cfg.seed))

    web_dir = os.path.join(cfg.results_dir, cfg.name, f"{cfg.phase}_{cfg.epoch}")
    webpage = HTML(web_dir, f"Experiment = {cfg.name}, Phase = {cfg.phase}, "
                            f"Epoch = {cfg.epoch}")
    n_done = 0
    for batch in batches:
        if n_done >= cfg.num_test:
            break
        _, visuals = (model.eval_step(batch) if state is None
                      else model.eval_step(state, batch))
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
