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
