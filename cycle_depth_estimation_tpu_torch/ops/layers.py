"""Layers of the port's networks (NCHW), counterparts of the JAX package's
``ops/layers.py``.

Convolutions are ``nn.Conv2d`` / ``nn.ConvTranspose2d``: the JAX package
leaves them to XLA outside any Pallas kernel, and cuDNN takes their place
here. ``conv3x3_reflect`` of the JAX module has no counterpart.
``conv_transpose_s2_phases`` is the JAX ``_conv_transpose_s2_phases``: a
stride-2 transposed conv as four dense convs and an interleave, here on int8
through ``conv2d_int8`` (the ``int8_dilated`` and ``int8_phases`` up modes
of the int8 serving path).

``Conv2d`` and ``ConvTranspose2d`` take the JAX ``Conv(dtype=…)``: with a
``compute_dtype`` set (``set_compute_dtype``; ``--dtype bfloat16``
training) each casts its input, weight and bias to it and returns it, while
the parameters, and so the optimizer, stay fp32. cuDNN adds the bias in its
fp32 accumulator before the one rounding, where the JAX layer rounds the
conv, adds the fp32 bias and rounds again: one bf16 rounding apart.
``BatchNorm`` returns its input's dtype (the JAX ``Norm(dtype=…)``) with
fp32 statistics; ``PReLU`` casts its α to the input's dtype.

``avg_pool``, ``max_pool``, ``resize_bilinear``, ``resize_nearest``,
``pixel_shuffle`` and ``replicate_pad`` are the JAX functions of those
names, on NCHW.
The JAX ``resize_bilinear_mm`` (chosen by ``prefer_mm`` or the
``CDE_RESIZE_MM`` variable) computes the same two-tap interpolation as
dense matmuls, a layout for the TPU's matrix unit; ``F.interpolate`` is
both forms here, and takes neither switch.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import collectives
from .int8_conv import conv2d_int8
from .kernels.instance_norm import instance_norm


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and state-dict keys) with an optional
    compute dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with an optional compute dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def set_compute_dtype(net: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Run every conv of ``net`` in ``dtype`` (None or fp32: as its input
    comes); the parameters keep their dtype."""
    dt = None if dtype == torch.float32 else dtype
    for m in net.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.compute_dtype = dt
    return net


class PReLU(nn.PReLU):
    """``nn.PReLU()`` (one α, 0.25, key ``weight``) as the JAX
    ``prelu_apply``: ``where(x >= 0, x, α·x)``, α in x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """NCHW reflection padding (= ``nn.ReflectionPad2d``)."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def avg_pool(x: torch.Tensor, window: int,
             stride: Optional[int] = None) -> torch.Tensor:
    """``nn.AvgPool2d`` without padding (the JAX ``avg_pool`` as its
    callers use it)."""
    return F.avg_pool2d(x, window, stride or window)


def max_pool(x: torch.Tensor, window: int, stride: Optional[int] = None,
             padding: int = 0) -> torch.Tensor:
    """``nn.MaxPool2d``: padded positions never win (−inf padding)."""
    return F.max_pool2d(x, window, stride or window, padding)


def replicate_pad(x: torch.Tensor, pad) -> torch.Tensor:
    """NCHW edge padding (= ``nn.ReplicationPad2d``); ``pad`` is an int,
    (ph, pw) or ((top, bottom), (left, right)), as the JAX function takes."""
    if isinstance(pad, int):
        pad = (pad, pad)
    a, b = pad
    (pt, pb), (pl, pr) = ((a, b) if isinstance(a, (tuple, list))
                          else ((a, a), (b, b)))
    return F.pad(x, (pl, pr, pt, pb), mode="replicate")


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``nn.PixelShuffle``: (N, C·r², H, W) → (N, C, H·r, W·r)."""
    return F.pixel_shuffle(x, factor)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NCHW ``x`` to ``size`` (H, W), source index
    floor(i·in/out): ``F.interpolate(mode='nearest')``."""
    return F.interpolate(x, size=tuple(size), mode="nearest")


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size`` (H, W), as torch's
    ``F.interpolate`` computes it: endpoint-aligned with ``align_corners``,
    else half-pixel centres, and no antialiasing on a downscale."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=False, track_running_stats=False), eps 1e-5: the
    InstanceNorm kernel. (The JAX module's affine option has no caller.)"""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.eps)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d(affine, eps 1e-5, momentum 0.1): the JAX package's
    ``Norm('batch')`` (flax ``nn.BatchNorm``, momentum 0.9). Train mode
    normalizes with the batch statistics and updates the running ones; eval
    mode normalizes with the running ones. State-dict keys are torch's
    (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``); a reference ``.pth`` from before torch 0.4.1
    lacks the last and loads all the same (``nn.BatchNorm2d``'s rule).

    flax moves the running variance toward the *biased* batch variance,
    torch toward the unbiased one (× n/(n−1), n = N·H·W). The train-mode
    forward lets torch update the buffers in its one pass, then takes the
    excess back out: with ``new = (1−m)·old + m·v·n/(n−1)``, the flax value
    ``(1−m)·old + m·v`` is ``new − (new − (1−m)·old)/n``.

    Under data parallelism (a ``data`` group of more than one rank) train
    mode uses the global batch's statistics, as the JAX step over a mesh
    does: the mean, then the biased variance about it, each from
    per-channel sums all-reduced over ``data`` (differentiably), with n the
    global count, and the flax rule on the running statistics. Under
    ``--parallel sp`` the sums are all-reduced over ``model`` as well, and
    n counts the whole plane: the caller passes its height
    (``plane_rows``; ``parallel/spatial.py`` does), since a rank's rows of
    a plane need not be an equal share.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def _global_forward(self, x: torch.Tensor, groups, n: int
                        ) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        xf = x.float()

        def total(t):
            for group in groups:
                t = collectives.all_reduce(t, group)
            return t

        mean = total(xf.sum((0, 2, 3))) / n
        xc = xf - mean.view(shape)
        var = total((xc * xc).sum((0, 2, 3))) / n
        y = (xc * torch.rsqrt(var + self.eps).view(shape)
             * self.weight.view(shape) + self.bias.view(shape))
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor,
                plane_rows: Optional[int] = None) -> torch.Tensor:
        """``plane_rows``: under ``--parallel sp``, the height of the plane
        whose rows ``x`` holds."""
        if not self.training:
            return super().forward(x)
        g = collectives.active()
        groups, rows = [], x.shape[2]
        if g.data_size > 1:
            groups.append(g.data)
        if g.spatial and g.model_size > 1:
            if plane_rows is None:
                raise ValueError("BatchNorm under --parallel sp needs the "
                                 "height of the plane its rows belong to")
            groups.append(g.model)
            rows = plane_rows
        if groups:
            n = x.shape[0] * g.data_size * rows * x.shape[3]
            return self._global_forward(x, groups, n)
        old = self.running_var.clone()
        y = super().forward(x)
        n = x.numel() // x.shape[1]
        # through .data: the op saved the buffer for its backward, which
        # reads it in eval mode only, and an in-place change of the buffer
        # itself would fail autograd's version check
        rv = self.running_var.data
        rv.sub_((rv - (1 - self.momentum) * old) / n)
        return y


@contextmanager
def running_stats_kept(net: nn.Module):
    """Restore the running statistics and batch counts of ``net``'s
    BatchNorms on exit: a forward run again inside leaves them as it found
    them (the recompute of ``torch.utils.checkpoint``)."""
    saved = [(b, b.clone()) for m in net.modules()
             if isinstance(m, nn.BatchNorm2d) for b in m.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


def Norm(kind: str, num_features: Optional[int] = None) -> nn.Module:
    """Norm-layer factory: 'instance' | 'batch' | 'none' (the reference's
    strings). 'batch' needs ``num_features``."""
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        if num_features is None:
            raise ValueError("Norm('batch') needs num_features")
        return BatchNorm(num_features)
    if kind == "none":
        return nn.Identity()
    raise NotImplementedError(f"normalization layer [{kind}] is not found")


def norm_uses_bias(kind: str) -> bool:
    """The reference's conv-bias rule: a conv before a norm has a bias
    unless the norm is BatchNorm (reference models/networks.py:152-155)."""
    return kind != "batch"


def _phase_taps(k: int, pad_lo: int, d: int):
    """Kernel tap indices and conv padding for output phase ``d`` of a
    stride-2 transposed conv expressed as a dense conv over the input.

    out[2i+d] = Σ_{h ∈ taps} K[h] · x[i + (d − pad_lo + h)//2]; taps are the
    h with (d − pad_lo + h) even. Returns (h_start, n_taps, (pad_l, pad_r)).
    """
    taps = [h for h in range(k) if (d - pad_lo + h) % 2 == 0]
    offsets = [(d - pad_lo + h) // 2 for h in taps]
    return taps[0], len(taps), (max(0, -offsets[0]), max(0, offsets[-1]))


def _phases_are_uniform(k: int, p: int) -> bool:
    """True when every stride-2 output phase maps to a dense conv whose
    offset range straddles 0 (k3/p1 and k4/p1 do)."""
    pad_lo = k - 1 - p
    for d in range(2):
        taps = [h for h in range(k) if (d - pad_lo + h) % 2 == 0]
        if not taps:
            return False
        offs = [(d - pad_lo + h) // 2 for h in taps]
        if offs[0] > 0 or offs[-1] < 0:
            return False
    return True


def conv_transpose_s2_phases(x: torch.Tensor, kernel: torch.Tensor,
                             k: Tuple[int, int] = (3, 3),
                             p: Tuple[int, int] = (1, 1),
                             op: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Exact stride-2 ConvTranspose2d(k, s2, p, op) on int8: four per-phase
    dense int8 convs (int32 accumulation) and an interleave.

    ``x`` is int8 NHWC, ``kernel`` the equivalent regular conv's int8 HWIO
    kernel (the JAX ``ConvTranspose`` layout: torch's weight flipped
    spatially, in and out swapped). Returns int32 NHWC.
    """
    kh, kw = k
    if not (_phases_are_uniform(kh, p[0]) and _phases_are_uniform(kw, p[1])
            and kh + op[0] - 2 * p[0] <= 2 and kw + op[1] - 2 * p[1] <= 2):
        raise ValueError(f"no uniform phase split for k={k}, p={p}, op={op}")
    n, h, w, _ = x.shape
    out_h = (h - 1) * 2 - 2 * p[0] + kh + op[0]
    out_w = (w - 1) * 2 - 2 * p[1] + kw + op[1]
    phases = []
    for dh in range(2):
        h0, nth, pad_h = _phase_taps(kh, kh - 1 - p[0], dh)
        row = []
        for dw in range(2):
            w0, ntw, pad_w = _phase_taps(kw, kw - 1 - p[1], dw)
            sub = kernel[h0::2][:nth, w0::2][:, :ntw].contiguous()
            row.append(conv2d_int8(x, sub, 1, (pad_h, pad_w)))
        phases.append(row)
    # out[2i + dh, 2j + dw] = phases[dh][dw][i, j]: (N, H, 2, W, 2, C)
    ph = torch.stack([torch.stack(r, dim=3) for r in phases], dim=2)
    out = ph.reshape(n, 2 * ph.shape[1], 2 * ph.shape[3], ph.shape[-1])
    return out[:, :out_h, :out_w]
