"""Tensor (channel) parallelism of the CycleGAN generators' residual trunk
(the JAX package's ``parallel/tensor.py``), Megatron's pairing on the
reference's names:

- the first conv of each ``ResnetBlock.conv_block`` (JAX ``block{i}.conv1``)
  is a column shard: weight split on out-channels, bias with it, *f*
  before it. The InstanceNorm and ReLU after it stay local, so the
  InstanceNorm kernels run on the rank's channel planes;
- the second conv (``block{i}.conv2``) is a row shard: weight split on
  in-channels; it computes the partial sum, *g* all-reduces it over
  ``model``, and the replicated bias is added once, before its
  InstanceNorm;
- the stem, the downs, the ups and the exit conv stay replicated.

The Adam moments of a sharded weight take its layout (the optimizer steps
the sharded parameters themselves). ``gathered_state_dict`` and
``gathered_optimizer_state`` put whole tensors back for a checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.layers import Conv2d
from .collectives import all_gather_cat, copy_to_model, reduce_from_model


def tp_spec(site: str, param: str) -> Optional[int]:
    """The dimension of parameter ``param`` ('weight' | 'bias', OIHW) of
    the generator's conv ``site`` (its JAX name, ``site_convs``) that is
    split over ``model``, or None for a replicated one."""
    if not site.startswith("block"):
        return None
    if site.endswith(".conv1"):
        return 0
    if site.endswith(".conv2") and param == "weight":
        return 1
    return None


def tp_shardings(net) -> Dict[str, Optional[int]]:
    """``tp_spec`` of every entry of ``net.state_dict()`` (a
    ``ResnetGenerator``), by its reference name."""
    by_module = {id(m): site for site, m in net.site_convs().items()}
    out = {}
    for mname, m in net.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            site = by_module.get(id(m), "")
            out[f"{mname}.{pname}"] = tp_spec(site, pname)
        for bname, _ in m.named_buffers(recurse=False):
            out[f"{mname}.{bname}"] = None
    return out


class ColumnParallelConv2d(Conv2d):
    """A conv whose weight and bias hold this rank's out-channels; *f*
    before it."""
    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(copy_to_model(x, self.tp_group))


class RowParallelConv2d(Conv2d):
    """A conv whose weight holds this rank's in-channels: the partial sum,
    all-reduced over ``model`` (*g*), plus the whole bias."""
    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.weight if dt is None else self.weight.to(dt)
        x = x if dt is None else x.to(dt)
        y = F.conv2d(x, w, None, self.stride, self.padding, self.dilation,
                     self.groups)
        y = reduce_from_model(y, self.tp_group)
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype).view(1, -1, 1, 1)


def _narrow(t: torch.Tensor, d: int, n: int, rank: int) -> torch.Tensor:
    k = t.shape[d] // n
    return t.narrow(d, rank * k, k).clone()


def shard_params_tp(net, group, size: int, rank: int) -> None:
    """Split ``net``'s trunk convs over ``model`` in place (``size`` ranks,
    this one ``rank``); each split parameter records its dimension in
    ``tp_dim`` and its group in ``tp_group``."""
    for site, conv in net.site_convs().items():
        d_w = tp_spec(site, "weight")
        if d_w is None:
            continue
        conv.__class__ = (ColumnParallelConv2d if d_w == 0
                          else RowParallelConv2d)
        conv.tp_group = group
        for pname in ("weight", "bias"):
            p = getattr(conv, pname)
            d = tp_spec(site, pname)
            if p is None or d is None:
                continue
            p.data = _narrow(p.data, d, size, rank)
            p.tp_dim, p.tp_group = d, group


def shard_state_tp(state, group, size: int, rank: int,
                   g_names=("G_A", "G_B"), opt_names=("G",)):
    """Lay ``state`` out for ``--parallel tp``: the named generators'
    trunks split over ``model``, and the moments of their split weights
    with them (a resumed optimizer's state is sliced alike)."""
    for n in g_names:
        if n in state.nets:
            shard_params_tp(state.nets[n], group, size, rank)
    for n in opt_names:
        opt = state.optimizers.get(n)
        if opt is None:
            continue
        for p in (p for g in opt.param_groups for p in g["params"]):
            st = opt.state.get(p, {})
            d = getattr(p, "tp_dim", None)
            for k, v in st.items():
                if d is not None and torch.is_tensor(v) and v.dim() > 0 \
                        and v.shape != p.shape:
                    st[k] = _narrow(v, d, size, rank)
    return state


def gathered(t: torch.Tensor, p) -> torch.Tensor:
    """``t`` (``p`` itself, its gradient or a moment) whole where ``p`` is
    split over ``model``."""
    d = getattr(p, "tp_dim", None)
    return t if d is None else all_gather_cat(t, p.tp_group, d)


def gathered_state_dict(net) -> Dict[str, torch.Tensor]:
    """``net.state_dict()`` with every split parameter whole (a
    collective over ``model`` where the net is split)."""
    sd = net.state_dict()
    for name, p in net.named_parameters():
        if getattr(p, "tp_dim", None) is not None:
            sd[name] = gathered(p.detach(), p)
    return sd


def gathered_optimizer_state(opt) -> Dict[str, Any]:
    """``opt.state_dict()`` with the moments of split parameters whole."""
    sd = opt.state_dict()
    params = [p for g in opt.param_groups for p in g["params"]]
    if not any(getattr(p, "tp_dim", None) is not None for p in params):
        return sd
    state = {}
    for i, st in sd["state"].items():
        p = params[i]
        state[i] = {k: (gathered(v, p) if torch.is_tensor(v) and v.dim() > 0
                        else v) for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}
