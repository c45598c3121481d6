"""InstanceNorm2d(affine=False) and its gradient as Triton kernels for Hopper.

Forward: replaces the TPU kernel ``cycle_depth_estimation_tpu/ops/pallas/
instance_norm.py`` (``_pallas_instance_norm``, body ``_kernel``). Per
(n, c) plane: fp32 sum and sum of squares over H×W, ``var = E[x²] − E[x]²``
(the one-pass form, so numbers match the JAX ``_xla_instance_norm``),
``y = (x − mean)·rsqrt(var + eps)`` cast to the input dtype.

Backward: replaces the XLA backward of the same file's custom VJP (``bwd``;
the JAX package has no Pallas kernel for it), ``dx = rσ·(dy − mean(dy) −
x̂·mean(dy·x̂))`` with ``x̂ = (x − μ)·rσ``. When the input needs a gradient,
the forward kernel also writes each plane's μ and rσ (fp32, N·C each), as
the JAX ``fwd`` keeps ``(x, mean, rsigma)``; the backward reads x, dy and
those. It saves x, never y: the generators apply an in-place ReLU to y.

Bound on the H100: bytes for both. Each does a handful of flops per element,
far below the ~295 flop/byte ridge, so the forward's floor is one read of x
and one write of y, the backward's one read of x and dy and one write of dx,
at 3.35 TB/s. Design: one program per NCHW-contiguous plane and two loops
over the plane in power-of-two chunks — statistics (or the two gradient
sums), tree-reduced once, then the elementwise pass — so each reads its
inputs twice. The second read of a plane mostly hits L2 (a 256² fp32 plane
is 256 KB); a single-read design is later work. The backward sizes its
chunk to the plane (961-element planes of the discriminator take 1024, not
2048); the forward keeps its chunk of 2048.

A CPU tensor takes ``plain_instance_norm`` / ``plain_instance_norm_backward``;
a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

_DTYPES = (torch.float32, torch.bfloat16)
_BLOCK = 2048
_NUM_WARPS = 8


def plain_instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The forward kernel's arithmetic in plain torch (NCHW)."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    mean2 = (xf * xf).mean(dim=(2, 3), keepdim=True)
    var = mean2 - mean * mean
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def plain_instance_norm_stats(x: torch.Tensor, eps: float = 1e-5
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-plane (mean, rsqrt(var + eps)), fp32, shape (N, C)."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3))
    var = (xf * xf).mean(dim=(2, 3)) - mean * mean
    return mean, torch.rsqrt(var + eps)


def plain_instance_norm_backward(x: torch.Tensor, dy: torch.Tensor,
                                 eps: float = 1e-5,
                                 stats: Optional[Tuple[torch.Tensor,
                                                       torch.Tensor]] = None
                                 ) -> torch.Tensor:
    """The backward kernel's arithmetic in plain torch: dx in dy's dtype.
    ``stats`` is the forward's (mean, rstd); computed from x when absent."""
    mean, rstd = plain_instance_norm_stats(x, eps) if stats is None else stats
    mean, rstd = mean[:, :, None, None], rstd[:, :, None, None]
    dyf = dy.float()
    xhat = (x.float() - mean) * rstd
    m_dy = dyf.mean(dim=(2, 3), keepdim=True)
    m_dyx = (dyf * xhat).mean(dim=(2, 3), keepdim=True)
    return (rstd * (dyf - m_dy - xhat * m_dyx)).to(dy.dtype)


@functools.lru_cache(maxsize=None)
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def in_fwd(x_ptr, y_ptr, mean_ptr, rstd_ptr, hw, eps,
               BLOCK: tl.constexpr, STATS: tl.constexpr):
        pid = tl.program_id(0)
        base = pid.to(tl.int64) * hw
        offs = tl.arange(0, BLOCK)
        acc1 = tl.zeros([BLOCK], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, hw, BLOCK):
            idx = start + offs
            m = idx < hw
            v = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            acc1 += v
            acc2 += v * v
        mean = tl.sum(acc1, axis=0) / hw
        var = tl.sum(acc2, axis=0) / hw - mean * mean
        rstd = 1.0 / tl.sqrt(var + eps)
        if STATS:
            tl.store(mean_ptr + pid, mean)
            tl.store(rstd_ptr + pid, rstd)
        for start in range(0, hw, BLOCK):
            idx = start + offs
            m = idx < hw
            v = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            y = (v - mean) * rstd
            tl.store(y_ptr + base + idx, y.to(y_ptr.dtype.element_ty), mask=m)

    @triton.jit
    def in_bwd(x_ptr, dy_ptr, mean_ptr, rstd_ptr, dx_ptr, hw,
               BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        base = pid.to(tl.int64) * hw
        mean = tl.load(mean_ptr + pid)
        rstd = tl.load(rstd_ptr + pid)
        offs = tl.arange(0, BLOCK)
        acc_dy = tl.zeros([BLOCK], dtype=tl.float32)
        acc_dyx = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, hw, BLOCK):
            idx = start + offs
            m = idx < hw
            v = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            g = tl.load(dy_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            acc_dy += g
            acc_dyx += g * ((v - mean) * rstd)   # masked lanes: g = 0
        m_dy = tl.sum(acc_dy, axis=0) / hw
        m_dyx = tl.sum(acc_dyx, axis=0) / hw
        for start in range(0, hw, BLOCK):
            idx = start + offs
            m = idx < hw
            v = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            g = tl.load(dy_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            dx = rstd * (g - m_dy - ((v - mean) * rstd) * m_dyx)
            tl.store(dx_ptr + base + idx, dx.to(dx_ptr.dtype.element_ty),
                     mask=m)

    return in_fwd, in_bwd


def _launch(x: torch.Tensor, eps: float, stats: bool):
    if not x.is_contiguous():
        raise ValueError("instance_norm kernel needs an NCHW-contiguous tensor")
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    if stats:
        mean = torch.empty((n, c), device=x.device, dtype=torch.float32)
        rstd = torch.empty_like(mean)
    else:
        mean = rstd = y  # never written: STATS is a compile-time False
    _kernels()[0][(n * c,)](x, y, mean, rstd, h * w, float(eps), BLOCK=_BLOCK,
                            STATS=stats, num_warps=_NUM_WARPS)
    instance_norm.launches += 1
    return (y, (mean, rstd)) if stats else (y, None)


def _launch_backward(x: torch.Tensor, dy: torch.Tensor,
                     stats: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    mean, rstd = stats
    if not x.is_contiguous():
        raise ValueError("instance_norm backward needs an NCHW-contiguous x")
    if dy.shape != x.shape or dy.device != x.device or dy.dtype not in _DTYPES:
        raise ValueError(f"instance_norm backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device} does not match x")
    n, c, h, w = x.shape
    for s in (mean, rstd):
        if s.dtype != torch.float32 or s.numel() != n * c or \
                not s.is_contiguous() or s.device != x.device:
            raise ValueError("instance_norm backward needs contiguous fp32 "
                             "(N, C) statistics on x's device")
    dy = dy.contiguous()
    dx = torch.empty_like(dy)
    hw = h * w
    block = min(_BLOCK, 1 << (hw - 1).bit_length())
    _kernels()[1][(n * c,)](x, dy, mean, rstd, dx, hw, BLOCK=block,
                            num_warps=8 if block >= 2048 else 4)
    instance_norm_backward.launches += 1
    return dx


def _device_kind(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type


class _InstanceNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps, grad):
        ctx.eps = eps
        if _device_kind(x, "instance_norm") == "cpu":
            ctx.save_for_backward(x)
            return plain_instance_norm(x, eps)
        y, stats = _launch(x, eps, stats=grad)
        ctx.save_for_backward(x, *(stats or ()))
        return y

    @staticmethod
    def backward(ctx, dy):
        x, *stats = ctx.saved_tensors
        dx = instance_norm_backward(x, dy, ctx.eps,
                                    tuple(stats) if stats else None)
        return dx, None, None


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over an NCHW fp32 or bf16 tensor."""
    if x.dim() != 4:
        raise ValueError(f"instance_norm expects NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"instance_norm supports fp32 and bf16, not {x.dtype}")
    # (ctx.needs_input_grad ignores no_grad: ask autograd's mode here)
    grad = torch.is_grad_enabled() and x.requires_grad
    return _InstanceNormFn.apply(x, float(eps), grad)


def instance_norm_backward(x: torch.Tensor, dy: torch.Tensor,
                           eps: float = 1e-5,
                           stats: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None
                           ) -> torch.Tensor:
    """dx of ``instance_norm`` at x for the output gradient dy. ``stats``:
    the forward kernel's per-plane (mean, rstd), which a CUDA tensor needs;
    the plain version computes them from x when absent."""
    if _device_kind(x, "instance_norm_backward") == "cpu":
        return plain_instance_norm_backward(x, dy, eps, stats)
    if stats is None:
        raise ValueError("instance_norm_backward on CUDA needs the forward's "
                         "(mean, rstd)")
    return _launch_backward(x, dy, stats)


#: kernel launches since the caller last set these to 0
instance_norm.launches = 0
instance_norm_backward.launches = 0
