"""Rank work of ``test_torch_port_spatial.py`` and
``test_torch_port_pipeline.py``, in a module of its own: spawned ranks
import it by name, and it imports neither JAX nor pytest."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
    instance_norm)
from cycle_depth_estimation_tpu_torch.parallel import collectives, dryrun
from cycle_depth_estimation_tpu_torch.parallel.mesh import (row_range,
                                                            rows_of,
                                                            shard_batch)
from cycle_depth_estimation_tpu_torch.parallel.spatial import (
    conv2d_rows, conv_transpose2d_rows)


def op_modules():
    """The CycleGAN nets' conv kinds, each with the padding it takes and
    the height of the plane it is held on (uneven splits among them: the
    PatchGAN's 32 → 31 → 30 rows)."""
    g = torch.Generator().manual_seed(7)

    def init(m):
        for p in m.parameters():
            p.data = torch.randn(p.shape, generator=g) * 0.2
        return m

    return {
        "reflect 7x7": (init(nn.Conv2d(3, 4, 7)), 3, "reflect", 32),
        "reflect 3x3": (init(nn.Conv2d(4, 4, 3)), 1, "reflect", 16),
        "down 3x3 s2": (init(nn.Conv2d(4, 4, 3, 2, 1)), 1, "zeros", 32),
        "up k3 s2 op1": (init(nn.ConvTranspose2d(4, 3, 3, 2, 1, 1)), 0,
                         "transpose", 16),
        "patch k4 s2": (init(nn.Conv2d(3, 4, 4, 2, 1)), 1, "zeros", 32),
        "patch k4 s1 (32 to 31)": (init(nn.Conv2d(4, 4, 4, 1, 1)), 1,
                                   "zeros", 32),
        "patch k4 s1 (31 to 30)": (init(nn.Conv2d(4, 1, 4, 1, 1)), 1,
                                   "zeros", 31),
        "instance norm (31 rows)": (None, 0, "norm", 31),
    }


def op_inputs(n: int = 4, w: int = 12):
    """A seeded input and output weight for each of ``op_modules``."""
    g = torch.Generator().manual_seed(8)
    out = {}
    for name, (mod, pad, mode, h) in op_modules().items():
        cin = 4 if mod is None else mod.in_channels
        x = torch.randn(n, cin, h, w, generator=g)
        out[name] = (x, torch.randn(op_apply(name, x)[0].shape, generator=g))
    return out


def op_apply(name, x, group=None):
    """Op ``name`` on ``x`` (this rank's rows of its plane where ``group``
    splits them, else the whole plane): the output and the module."""
    mod, pad, mode, h = op_modules()[name]
    if group is None:
        if mode == "norm":
            return instance_norm(x), mod
        if mode == "transpose":
            return mod(x), mod
        if mode == "reflect":
            return mod(F.pad(x, (pad,) * 4, mode="reflect")), mod
        return mod(x), mod
    if mode == "norm":
        return instance_norm(x, 1e-5, group, h * x.shape[3]), mod
    if mode == "transpose":
        return conv_transpose2d_rows(x, mod, h, group)[0], mod
    return conv2d_rows(x, mod, h, group, pad, mode)[0], mod


def op_case(name, x, w, layout):
    """Op ``name`` on this rank's block of ``x`` (rows of the batch over
    ``data``, of the height over ``model``), loss Σ y·w: the output, the
    input's gradient (gathered whole) and the parameters' gradients
    (summed over the ranks)."""
    groups = dryrun.layout_groups({**layout, "parallel": "sp"})
    prev = collectives.activate(groups)
    try:
        xs = shard_batch({"x": x})["x"].clone().requires_grad_(True)
        y, mod = op_apply(name, xs, groups.model)
        ws = shard_batch({"w": w})["w"]
        assert ws.shape == y.shape, (name, ws.shape, y.shape)
        (y * ws).sum().backward()
        grads = {}
        if mod is not None:
            params = list(mod.parameters())
            collectives.sync_replicas(params)   # Σ over 'model'
            for p in params:
                if groups.data is not None:
                    collectives.all_reduce_(p.grad, groups.data)
            grads = {k: p.grad.clone() for k, p in mod.named_parameters()}
        gather = (lambda t: collectives.gather_rows(
            collectives.gather_spatial(t.detach())))
        return {"y": gather(y), "dx": gather(xs.grad), "grads": grads}
    finally:
        collectives.activate(prev)


def op_reference(name, x, w):
    """``op_case`` in one process, on the whole plane."""
    xs = x.clone().requires_grad_(True)
    y, mod = op_apply(name, xs)
    (y * w).sum().backward()
    return {"y": y.detach(), "dx": xs.grad,
            "grads": {} if mod is None else
            {k: p.grad.clone() for k, p in mod.named_parameters()}}




# ---- the CycleGAN lineage's other layers and nets -----------------------
def net_op_modules():
    """The row splits the U-Nets, the PixelGAN, the resize_conv generator
    and the T2Net/SegCycle nets add, each on the plane height it is held
    on (uneven splits, windows that straddle two ranks, and at M = 4 ranks
    that hold no row: the U-Net's 2-row innermost level, the 3 → 2-row
    conv), in train mode: (module, input channels, height, whole net; a
    net's input height divides by the ranks)."""
    from cycle_depth_estimation_tpu_torch.models import networks as pn
    from cycle_depth_estimation_tpu_torch.models import seg_network as psn
    from cycle_depth_estimation_tpu_torch.ops.layers import BatchNorm, PReLU

    g = torch.Generator().manual_seed(9)

    def init(m):
        for p in m.parameters():
            p.data = torch.randn(p.shape, generator=g) * 0.3
        return m.train()

    unet_level = pn.UnetSkipConnectionBlock(
        4, 8, submodule=pn.UnetSkipConnectionBlock(8, 8, innermost=True,
                                                   norm="batch"),
        norm="batch", use_dropout=True)
    return {
        "upsample x2 (15 rows)": (nn.Upsample(scale_factor=2), 4, 15, False),
        "avg pool 2x2 (31 rows)": (nn.AvgPool2d(2, 2), 4, 31, False),
        "max pool 2x2 (30 rows)": (nn.MaxPool2d(2, 2), 4, 30, False),
        "up k4 s2 p1 (7 rows)": (init(nn.ConvTranspose2d(4, 3, 4, 2, 1)), 4,
                                 7, False),
        "down 3x3 s2 (3 to 2 rows)": (init(nn.Conv2d(4, 4, 3, 2, 1)), 4, 3,
                                      False),
        "batch norm (31 rows)": (init(BatchNorm(4)), 4, 31, False),
        "inception width 3 (12 rows)": (init(psn.InceptionBlock(
            4, 4, "batch", PReLU(), 3)), 4, 12, False),
        "u-net innermost (2 rows)": (init(pn.UnetSkipConnectionBlock(
            4, 8, innermost=True, norm="batch")), 4, 2, False),
        "u-net level, skips and dropout (8 rows)": (init(unet_level), 4, 8,
                                                    False),
        "pixel D, batch norm (32 rows)": (init(pn.PixelDiscriminator(
            4, 4, "batch")), 4, 32, True),
        "resize_conv generator (32 rows)": (init(pn.ResnetGenerator(
            4, 3, 4, 1, up_mode="resize_conv")), 4, 32, True),
    }


def net_op_inputs(n: int = 2, w: int = 8):
    """A seeded input and output weight for each of ``net_op_modules``."""
    g = torch.Generator().manual_seed(10)
    out = {}
    for name, (_, cin, h, _) in net_op_modules().items():
        x = torch.randn(n, cin, h, w, generator=g)
        y = net_op_apply(name, x)[0]
        out[name] = (x, torch.randn(y.shape, generator=g))
    return out


def net_op_apply(name, x, group=None):
    """Op ``name`` on ``x`` (a non-leaf: the U-Net levels' LeakyReLU works
    in place), on this rank's rows where ``group`` splits them; torch's
    generator seeded alike on every rank for the dropout masks."""
    from cycle_depth_estimation_tpu_torch.parallel.spatial import (_layer,
                                                                   spatial)

    mod, _, h, whole = net_op_modules()[name]
    torch.manual_seed(11)
    x = x * 1.0
    if group is None:
        return mod(x), mod
    if whole:
        return spatial(mod, group)(x), mod
    return _layer(mod, x, h, group)[0], mod


def _net_op(name, xs, ws, group, gather):
    y, mod = net_op_apply(name, xs, group)
    assert ws.shape == y.shape, (name, ws.shape, y.shape)
    (y * ws).sum().backward()
    params = list(mod.parameters())
    if group is not None:
        collectives.sync_replicas(params)   # Σ over 'model'
        g = collectives.active()
        for p in params:
            if g.data is not None:
                collectives.all_reduce_(p.grad, g.data)
    return {"y": gather(y.detach()), "dx": gather(xs.grad),
            "grads": {k: p.grad.clone() for k, p in mod.named_parameters()},
            "buffers": {k: b.clone() for k, b in mod.named_buffers()}}


def net_op_case(name, x, w, layout):
    """Op ``name`` on this rank's block of ``x``, loss Σ y·w: as
    ``op_case``, and the module's buffers (BatchNorm's statistics)."""
    groups = dryrun.layout_groups({**layout, "parallel": "sp"})
    prev = collectives.activate(groups)
    try:
        xs = shard_batch({"x": x})["x"].clone().requires_grad_(True)
        return _net_op(name, xs, shard_batch({"w": w})["w"], groups.model,
                       lambda t: collectives.gather_rows(
                           collectives.gather_spatial(t)))
    finally:
        collectives.activate(prev)


def net_op_reference(name, x, w):
    """``net_op_case`` in one process, on the whole plane."""
    return _net_op(name, x.clone().requires_grad_(True), w, None,
                   lambda t: t)


def means_case(logits, labels, a, b, layout):
    """The masked means and elementwise losses of the task models on this
    rank's block: ``cross_entropy_loss`` and ``seg_accuracy`` of
    ``logits`` against ``labels`` (NHW, some 255), ``gan_loss`` of ``a``
    and ``l1_loss(a, b)``; their values and the gradient of their sum at
    ``logits`` and ``a``, gathered whole. With ``layout`` None: one
    process."""
    from cycle_depth_estimation_tpu_torch.models.networks import (gan_loss,
                                                                  l1_loss)
    from cycle_depth_estimation_tpu_torch.models.seg_network import (
        cross_entropy_loss, seg_accuracy)

    groups = (collectives.Groups() if layout is None else
              dryrun.layout_groups({**layout, "parallel": "sp"}))
    prev = collectives.activate(groups)
    try:
        part = shard_batch({"z": logits, "y": labels, "a": a, "b": b})
        z = part["z"].clone().requires_grad_(True)
        u = part["a"].clone().requires_grad_(True)
        vals = {"ce": cross_entropy_loss(z, part["y"], 255),
                "acc": seg_accuracy(z, part["y"], 255),
                "gan": gan_loss(u, True), "l1": l1_loss(u, part["b"])}
        (vals["ce"] + vals["gan"] + vals["l1"]).backward()
        vals = collectives.mean_over_data(vals)  # as the step's metrics
        # a rank's gradient at its rows is 'data' times the global loss's:
        # the step averages the ranks' parameter gradients over 'data'
        gz, gu = (t / groups.data_size for t in (z.grad, u.grad))
        gather = (lambda t: collectives.gather_rows(
            collectives.gather_spatial(t)))
        return {"values": {k: float(v.detach()) for k, v in vals.items()},
                "dz": gather(gz), "da": gather(gu)}
    finally:
        collectives.activate(prev)


def build_net(kind: str):
    """A U-Net generator (unet_128, ngf 4, BatchNorm) or a T2Net task net
    (ngf 4, InstanceNorm, PReLU), from seed 12, in train mode."""
    from cycle_depth_estimation_tpu_torch.models.networks import define_G
    from cycle_depth_estimation_tpu_torch.models.seg_network import (
        define_task_G)

    gen = torch.Generator().manual_seed(12)
    if kind == "unet":
        net = define_G(3, 3, 4, "unet_128", norm="batch", generator=gen)
    else:
        net = define_task_G(3, 4, 4, "instance", "PReLU", "UNet",
                            generator=gen)
    return net.train()


def net_forward_case(kind, x, layout, *args):
    """``build_net(kind)`` on this rank's block of ``x`` (``layout`` None:
    one process), its output (the task net's head output) gathered whole."""
    from cycle_depth_estimation_tpu_torch.parallel.spatial import spatial

    groups = (collectives.Groups() if layout is None else
              dryrun.layout_groups({**layout, "parallel": "sp"}))
    prev = collectives.activate(groups)
    try:
        net = build_net(kind)
        if groups.model is not None:
            spatial(net, groups.model)
        with torch.no_grad():
            y = net(shard_batch({"x": x})["x"], *args)
        y = y[-1] if isinstance(y, list) else y
        return collectives.gather_rows(collectives.gather_spatial(y))
    finally:
        collectives.activate(prev)


def eval_step_case(cfg_kw, batch, layout):
    """The model of ``cfg_kw`` from its seed, laid out by ``layout`` as the
    train CLI does, and its ``eval_step`` on this rank's block of
    ``batch``: the metrics and the visuals (gathered whole by the step)."""
    from cycle_depth_estimation_tpu_torch.config import (
        Config, apply_model_defaults)
    from cycle_depth_estimation_tpu_torch.models import create_model
    from cycle_depth_estimation_tpu_torch.train import place_state

    kw = {"device": "cpu", **cfg_kw, **layout}
    cfg = apply_model_defaults(Config(**kw), set(kw))
    groups = dryrun.layout_groups(layout)
    prev = collectives.activate(groups)
    try:
        model = create_model(cfg)
        state = place_state(cfg, model.init_state(), groups)
        metrics, visuals = model.eval_step(state, shard_batch(batch))
        return {"metrics": {k: float(v) for k, v in metrics.items()},
                "visuals": visuals, "data_rank": groups.data_rank,
                "data_size": groups.data_size}
    finally:
        collectives.activate(prev)


def pinned_seg_step(cfg_kw, batch, layout, img_s2t):
    """``dryrun.model_step`` of T2Net (``--model seg``, the first step's
    gradients kept) with the frozen translator's output taken from
    ``img_s2t`` (this rank's block of it): the one process's step moves
    its gradients by ~3e-4 of the largest when its translator's output
    moves by the sp forward's rounding (5e-7), so the task net's step is
    held on one input."""
    from cycle_depth_estimation_tpu_torch.models.seg_model import SegModel

    class Pinned(nn.Module):
        def forward(self, x):
            return shard_batch({"y": img_s2t})["y"]

    losses = SegModel._losses

    def pinned(self, nets, b):
        return losses(self, {**nets, "s2t": Pinned()}, b)

    SegModel._losses = pinned
    try:
        return dryrun.model_step(cfg_kw, batch, layout, None, 1e-2, 1,
                                 False, True)
    finally:
        SegModel._losses = losses


@contextlib.contextmanager
def fixed_masks(masks=None):
    """Every ``nn.ReLU`` and ``nn.LeakyReLU`` forward takes its sign mask
    from ``masks`` (one whole (N, C, H, W) mask a call, in call order; this
    rank's rows of the batch over ``data`` and of the height over
    ``model``), or, with ``masks`` None, records its own masks into the
    list it yields. Rounding then cannot flip a mask between two runs."""
    record = masks is None
    masks = [] if record else masks
    calls = [0]
    saved = nn.ReLU.forward, nn.LeakyReLU.forward

    def mask_of(x):
        if record:
            m = x.detach() > 0
            masks.append(m)
            return m
        m = masks[calls[0]]
        calls[0] += 1
        g = collectives.active()
        m = m[rows_of(m.shape[0], g.data_size, g.data_rank)]
        if g.spatial and g.model_size > 1:
            a, b = row_range(m.shape[2], g.model_size, g.model_rank)
            m = m[:, :, a:b]
        assert m.shape == x.shape, (m.shape, x.shape)
        return m

    nn.ReLU.forward = lambda self, x: x * mask_of(x)
    nn.LeakyReLU.forward = lambda self, x: torch.where(
        mask_of(x), x, x * self.negative_slope)
    try:
        yield masks
    finally:
        nn.ReLU.forward, nn.LeakyReLU.forward = saved
    assert record or calls[0] == len(masks), (calls[0], len(masks))


def masked_step(cfg, batch, layout, init_sd, adam_eps, masks=None):
    """``dryrun.model_step`` (one step, the generator gradients kept) under
    ``fixed_masks(masks)``; recording, it also returns the masks."""
    with fixed_masks(masks) as used:
        out = dryrun.model_step(cfg, batch, layout, init_sd, adam_eps, 1,
                                True)
    if masks is None:
        out["masks"] = used
    return out


if __name__ == "__main__":
    # PYTHONPATH=. python tests/torch_port_spatial_ranks.py: the CycleGAN
    # sp step at
    # ngf 8 (32², batch 8, (2, 2) mesh, four CPU ranks) against one
    # process at three seeds, with the masks free and fixed: the generator
    # gradients' largest difference over the largest gradient
    import torch_port_spatial_ranks as me  # by name, as the ranks import it

    cfg = dict(model="cycle_gan", fine_size=32, ngf=8, ndf=8,
               net_g="resnet_3blocks", batch_size=8, pool_size=16,
               d_steps_per_g=2)
    sp = {"mesh_shape": [2, 2], "parallel": "sp"}
    for seed in range(3):
        g = torch.Generator().manual_seed(seed)
        batch = {k: torch.rand(8, 3, 32, 32, generator=g) * 2 - 1
                 for k in ("img_source", "img_target")}
        one = me.masked_step(cfg, batch, {}, None, 1e-2)
        masks = one.pop("masks")
        got = dryrun.spawn(dryrun.run_cases, 4, ({
            "free": (dryrun.model_step, (cfg, batch, sp, None, 1e-2, 1,
                                         True)),
            "fixed": (me.masked_step, (cfg, batch, sp, None, 1e-2, masks)),
        },))
        apart = {c: max(dryrun.grads_apart(r[c]["grads"], one["grads"])
                        for r in got) for c in ("free", "fixed")}
        print(f"seed {seed}: " + ", ".join(f"masks {c} {d:.3e} ({k})" for c, (
            d, k) in apart.items()), flush=True)
