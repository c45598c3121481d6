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
    python -m cycle_depth_estimation_tpu_torch.test --dataroot <dir> \\
        --name <cycle_gan run> --model_suffix _A [--int8] \\
        [--tpu_precision highest]

``--model test`` serves ``<checkpoints_dir>/<name>/<epoch>_net_G<suffix>.pth``
where it exists (``--model_suffix``). ``--int8`` serves the generator
(``net_G``; pix2pix's ``G``) through generic PTQ (``models/ptq.py``):
calibrated on the first batch, then int8 for the whole gallery.
``--tpu_precision highest`` turns off TF32 in cuDNN and cuBLAS.
"""

from __future__ import annotations

import itertools
import os


def _served_net(model, state):
    """The generator that ``--int8`` serves: ``model.net_G``, or the ``G``
    of a trained model's nets."""
    net = getattr(model, "net_G", None)
    if net is None and state is not None:
        net = state.nets.get("G")
    if net is None:
        raise SystemExit(f"--int8: model {model.cfg.model} has no generator "
                         "net_G to serve")
    return net


def main(argv=None) -> str:
    import torch

    from .config import parse_args, print_options
    from .data import create_dataloader
    from .data.device_transforms import wrap_for_config
    from .data.loader import prefetch_to_device
    from .device import set_precision
    from .models import create_model
    from .models.ptq import calibrate_model, int8_apply
    from .utils.html import HTML
    from .utils.visualizer import save_images

    cfg = parse_args(argv, is_train=False)
    # reference TestOptions: batch 1, loadSize=fineSize, no flip, serial
    # order
    cfg = cfg.replace(load_size=cfg.fine_size, batch_size=1, no_flip=True,
                      serial_batches=True, num_threads=1)
    print(print_options(cfg))
    set_precision(cfg.tpu_precision)

    model = create_model(cfg)
    state = model.init_state() if hasattr(model, "init_state") else None
    if cfg.pth_path:
        if not hasattr(model, "load_reference_generator"):
            raise SystemExit(f"--pth_path: model {cfg.model} loads its "
                             "checkpoints from --checkpoints_dir/--name")
        model.load_reference_generator(cfg.pth_path)
    elif model.has_checkpoint(cfg.epoch):
        model.load_nets(state, cfg.epoch)
    else:
        print("warning: no checkpoint given — running with random init")
    loader = create_dataloader(cfg, phase=cfg.phase, shuffle=False)
    batches = prefetch_to_device(loader, model.device)
    if cfg.device_aug:
        batches = wrap_for_config(batches, cfg, torch.Generator(
            model.device).manual_seed(cfg.seed))

    serve_int8 = None
    if cfg.int8:
        net = _served_net(model, state)
        dtype = next(net.parameters()).dtype
        first = next(batches)
        batches = itertools.chain([first], batches)
        sites = calibrate_model(net, first["A"].to(model.device, dtype))
        print(f"int8 serving: {len(sites)} conv sites quantized")

        def serve_int8(a):
            return int8_apply(net, sites, a.to(model.device, dtype))

    web_dir = os.path.join(cfg.results_dir, cfg.name, f"{cfg.phase}_{cfg.epoch}")
    webpage = HTML(web_dir, f"Experiment = {cfg.name}, Phase = {cfg.phase}, "
                            f"Epoch = {cfg.epoch}")
    n_done = 0
    for batch in batches:
        if n_done >= cfg.num_test:
            break
        if serve_int8 is not None:
            visuals = {"real_A": batch["A"], "fake_B": serve_int8(batch["A"])}
        else:
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
