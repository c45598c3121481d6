"""Rank work of ``test_torch_port_spatial_s2d.py``, in a module of its own:
spawned ranks import it by name, and it imports neither JAX nor pytest."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cycle_depth_estimation_tpu_torch.parallel import collectives, dryrun
from cycle_depth_estimation_tpu_torch.parallel.mesh import shard_batch


def _init(m, g):
    """Seeded weights (and BatchNorm affines away from 1, 0), train mode."""
    for p in m.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.3
    return m.train()


def op_modules():
    """The S2D nets' row splits, each on the planes it is held on: (module,
    [(channels, height) of each input], the one-process function, the
    row function). Uneven splits at M = 2 and 4 (7, 15 and 6 rows), a
    halo past the neighbouring rank (the 3×3 conv at dilation 2 over
    1-row shards), ranks that hold none of a plane (3 rows at M = 4, the
    depth gates' 2-row planes) and output rows whose inputs lie on
    another rank (bilinear ×2 of 3 and 1 rows)."""
    from cycle_depth_estimation_tpu_torch.models import s2d_networks as sn
    from cycle_depth_estimation_tpu_torch.ops.layers import (
        avg_pool, resize_bilinear, resize_nearest)
    from cycle_depth_estimation_tpu_torch.parallel import spatial as sp
    from cycle_depth_estimation_tpu_torch.parallel import spatial_s2d as ss

    g = torch.Generator().manual_seed(16)

    def conv(*a, **kw):
        return _init(nn.Conv2d(*a, **kw), g)

    def whole(m, x):
        return m(x)

    def rows(m, xs, hs, grp):
        return sp._layer(m, xs[0], hs[0], grp)[0]

    def bilinear(m, x):
        return resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]),
                               align_corners=True)

    def gate(m, x):
        return x * torch.sigmoid(nn.AdaptiveAvgPool2d(1)(x))

    def nearest(m, x):
        return resize_nearest(x, (x.shape[2] // 2, x.shape[3] // 2))

    def depth(m, x):
        bands, dep = m(x)
        return torch.cat([*bands, dep], 1)

    cases = {}
    for h in (7, 3):
        cases[f"dilated k2 p1 d2 ({h} rows)"] = (
            conv(4, 3, 2, padding=1, dilation=2), [(4, h)], whole, rows)
        cases[f"dilated k3 p2 d2 ({h} rows)"] = (
            conv(4, 3, 3, padding=2, dilation=2), [(4, h)], whole, rows)
    for h in (7, 3, 1):
        cases[f"bilinear x2 corners ({h} rows)"] = (
            None, [(3, h)], bilinear,
            lambda m, xs, hs, grp: sp.bilinear2_rows(xs[0], hs[0], grp)[0])
    for h in (7, 3):
        cases[f"global mean gate ({h} rows)"] = (
            None, [(3, h)], gate, lambda m, xs, hs, grp: xs[0] * torch.sigmoid(
                sp.global_mean_rows(xs[0], hs[0], grp)))
    for h in (15, 6):
        cases[f"nearest half ({h} rows)"] = (
            None, [(2, h)], nearest, lambda m, xs, hs, grp: sp.nearest_rows(
                xs[0], hs[0], (hs[0] // 2, xs[0].shape[3] // 2), grp)[0])
    cases.update({
        "conv transpose k2 s2 (7 rows)": (
            _init(nn.ConvTranspose2d(4, 3, 2, 2), g), [(4, 7)], whole, rows),
        "stem 7x7 s2 p3 (14 rows)": (
            conv(3, 4, 7, 2, 3, bias=False), [(3, 14)], whole, rows),
        "avg_pool 2 (7 rows)": (
            None, [(3, 7)], lambda m, x: avg_pool(x, 2),
            lambda m, xs, hs, grp: sp.pool2d_rows(xs[0], hs[0], grp)[0]),
        "transition (6 rows)": (_init(sn.Transition(4, 3), g), [(4, 6)],
                                whole, rows),
        "dense layer (7 rows)": (_init(sn.DenseLayer(4, 2), g), [(4, 7)],
                                 whole, rows),
        "dual resnet block (7 rows)": (_init(sn.DualResnetBlock(4), g),
                                       [(4, 7)], whole, rows),
        "psp trans (7 rows)": (_init(sn.PspTrans(8), g), [(8, 7)], whole,
                               rows),
        "psp head (7 rows)": (_init(sn.PspHead(4, 8), g), [(4, 7)], whole,
                              rows),
        "deconv block, batch norm (3 rows)": (
            _init(sn.DeconvBlock(4, 3, batch_norm=True), g), [(4, 3)],
            whole, rows),
        "g_side (6 rows to 12)": (
            _init(sn.GSide(8, 4), g), [(4, 6), (8, 6)],
            lambda m, s, d: m(s, d),
            lambda m, xs, hs, grp: ss._gside(m, (xs[0], hs[0]),
                                             (xs[1], hs[1]), grp)[0]),
        "seg block (7 rows)": (
            _init(sn.SegBlock(4, 3), g), [(4, 7)], whole,
            lambda m, xs, hs, grp: ss._seg_block(m, xs[0], hs[0], grp)),
        "depth block (6 rows)": (
            _init(sn.DepthBlock(4), g), [(4, 6)], depth,
            lambda m, xs, hs, grp: torch.cat(
                (lambda b, d: [*b, d])(*ss._depth_block(m, xs[0], hs[0],
                                                        grp)), 1)),
    })
    return cases


DROP_CASE = "drop discriminator, label map and keep-masks (8 rows)"


def op_inputs(n: int = 2, w: int = 6):
    """A seeded input list and output weight for each of ``op_modules``,
    and the dropout discriminator's: its features (4 channels, 8 rows),
    its label map (16 rows) and its two keep-masks."""
    g = torch.Generator().manual_seed(17)
    out = {}
    for name, (_, shapes, _, _) in op_modules().items():
        xs = [torch.randn(n, c, h, w, generator=g) for c, h in shapes]
        y = op_apply(name, xs)[0]
        out[name] = (xs, torch.randn(y.shape, generator=g))
    xs = [torch.randn(n, 4, 8, 2 * w, generator=g),
          torch.randint(0, 5, (n, 1, 16, 4 * w), generator=g).float()]
    masks = drop_net().draw_masks(n, g)
    y = drop_apply(xs, masks)[0]
    out[DROP_CASE] = (xs, torch.randn(y.shape, generator=g), masks)
    return out


def op_apply(name, xs, group=None):
    """Op ``name`` on ``xs`` (this rank's rows where ``group`` splits
    them, else whole planes); the output and the module."""
    mod, shapes, whole, rows = op_modules()[name]
    if group is None:
        return whole(mod, *xs), mod
    return rows(mod, xs, [h for _, h in shapes], group), mod


def drop_net():
    """A ``DropDiscriminator`` over 4 channels with the label map in front
    (``--dis_seg``), two dropout layers, from seed 18, in train mode."""
    from cycle_depth_estimation_tpu_torch.models.s2d_networks import (
        DropDiscriminator)

    return _init(DropDiscriminator(4, 4, 3, dis_seg=True),
                 torch.Generator().manual_seed(18))


def drop_apply(xs, masks, group=None):
    from cycle_depth_estimation_tpu_torch.parallel.spatial import spatial

    net = drop_net()
    if group is not None:
        spatial(net, group)
        masks = [collectives.local_rows(m) for m in masks]
    return net(xs[0], xs[1], masks=masks), net


def _op(y, mod, xs, w, gather, split):
    assert w.shape == y.shape, (w.shape, y.shape)
    (y * w).sum().backward()
    grads, buffers = {}, {}
    if mod is not None:
        params = list(mod.parameters())
        if split:
            collectives.sync_replicas(params)   # Σ over 'model'
            g = collectives.active()
            for p in params:
                if g.data is not None:
                    collectives.all_reduce_(p.grad, g.data)
        grads = {k: p.grad.clone() for k, p in mod.named_parameters()}
        buffers = {k: b.clone() for k, b in mod.named_buffers()}
    return {"y": gather(y.detach()), "dx": [gather(x.grad) for x in xs],
            "grads": grads, "buffers": buffers}


def op_case(name, xs, w, layout, masks=None):
    """Op ``name`` on this rank's block of ``xs`` (rows of the batch over
    ``data``, of each height over ``model``), loss Σ y·w: the output and
    the inputs' gradients gathered whole, the parameters' gradients summed
    over the ranks, the buffers (BatchNorm's statistics)."""
    groups = dryrun.layout_groups({**layout, "parallel": "sp"})
    prev = collectives.activate(groups)
    try:
        part = shard_batch({f"x{i}": x for i, x in enumerate(xs)})
        ps = [part[f"x{i}"].clone().requires_grad_(True)
              for i in range(len(xs))]
        y, mod = (drop_apply(ps, masks, groups.model) if masks is not None
                  else op_apply(name, ps, groups.model))
        return _op(y, mod, ps, shard_batch({"w": w})["w"],
                   lambda t: collectives.gather_rows(
                       collectives.gather_spatial(t)), True)
    finally:
        collectives.activate(prev)


def op_reference(name, xs, w, masks=None):
    """``op_case`` in one process, on the whole planes."""
    ps = [x.clone().requires_grad_(True) for x in xs]
    y, mod = (drop_apply(ps, masks) if masks is not None
              else op_apply(name, ps))
    return _op(y, mod, ps, w, lambda t: t, False)


# ---- the sp G_2 → R_D forward ----------------------------------------------
SMALL_NETS = dict(mid_nc=64, growth_rate=8, block_config=(2, 2, 2, 2))


def build_trunk_and_refiner():
    """``GeneralNet`` at the JAX sp check's small config and ``RDep`` over
    its outputs, from seed 19, in eval mode: xavier convs, random biases,
    BatchNorm affines and statistics (as ``test_torch_port_s2d_nets.py``
    draws them), so that every layer carries signal."""
    from cycle_depth_estimation_tpu_torch.models import s2d_networks as sn
    from cycle_depth_estimation_tpu_torch.ops.init import init_weights

    g = torch.Generator().manual_seed(19)
    g2 = sn.GeneralNet(**SMALL_NETS)
    rd = sn.RDep(SMALL_NETS["mid_nc"], g2.feature_channels)
    for net in (g2, rd):
        init_weights(net, "xavier", 1.0, g)
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and \
                        m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g) * .1)
                if isinstance(m, nn.BatchNorm2d):
                    for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -.3, .3),
                                      (m.running_mean, -.5, .5),
                                      (m.running_var, 0.5, 2.0)):
                        t.copy_(torch.rand(t.shape, generator=g)
                                * (hi - lo) + lo)
    return g2.eval(), rd.eval()


def trunk_refiner_case(x, layout):
    """G_2 in mode 'R' on this rank's block of ``x``, then R_D on its
    outputs, in eval mode (``layout`` None: one process): R_D's three
    features, its seg logits, its four bands and its refined depth, each
    gathered whole."""
    from cycle_depth_estimation_tpu_torch.parallel.spatial import spatial

    groups = (collectives.Groups() if layout is None else
              dryrun.layout_groups({**layout, "parallel": "sp"}))
    prev = collectives.activate(groups)
    try:
        g2, rd = build_trunk_and_refiner()
        if groups.model is not None:
            spatial(g2, groups.model)
            spatial(rd, groups.model)
        with torch.no_grad():
            psp, feats = g2(shard_batch({"x": x})["x"], "R")
            outs, seg, (bands, dep) = rd(feats, psp)
        return [collectives.gather_rows(collectives.gather_spatial(t))
                for t in (*outs, seg, *bands, dep)]
    finally:
        collectives.activate(prev)


def weighted_means_inputs():
    """28-class logits and labels on a 31-row plane (uneven at M = 2 and
    4; rank 0's rows at M = 2 mostly ignored, 255)."""
    g = torch.Generator().manual_seed(20)
    labels = torch.randint(0, 28, (2, 31, 7), generator=g)
    labels[0, :12] = 255
    return torch.randn(2, 28, 31, 7, generator=g), labels


def weighted_means_case(logits, labels, layout):
    """S2D_base's class-weighted cross-entropy (``CLASS_WEIGHTS_28``) and
    the accuracy on this rank's block (``layout`` None: one process):
    their values (averaged over ``data`` as the step's metrics) and the
    cross-entropy's gradient at the logits, gathered whole."""
    from cycle_depth_estimation_tpu_torch.models.s2d_networks import (
        CLASS_WEIGHTS_28)
    from cycle_depth_estimation_tpu_torch.models.seg_network import (
        cross_entropy_loss, seg_accuracy)

    groups = (collectives.Groups() if layout is None else
              dryrun.layout_groups({**layout, "parallel": "sp"}))
    prev = collectives.activate(groups)
    try:
        part = shard_batch({"z": logits, "y": labels})
        z = part["z"].clone().requires_grad_(True)
        w = torch.tensor(CLASS_WEIGHTS_28)
        vals = {"ce": cross_entropy_loss(z, part["y"], 255, w),
                "acc": seg_accuracy(z, part["y"], 255)}
        vals["ce"].backward()
        vals = collectives.mean_over_data(vals)
        return {"values": {k: float(v.detach()) for k, v in vals.items()},
                "dz": collectives.gather_rows(collectives.gather_spatial(
                    z.grad / groups.data_size))}
    finally:
        collectives.activate(prev)
