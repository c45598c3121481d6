"""InstanceNorm2d(affine=False) as a Triton kernel for Hopper.

Replaces the TPU kernel ``cycle_depth_estimation_tpu/ops/pallas/
instance_norm.py`` (``_pallas_instance_norm``, body ``_kernel``). Per
(n, c) plane: fp32 sum and sum of squares over H×W, ``var = E[x²] − E[x]²``
(the one-pass form, so numbers match the JAX ``_xla_instance_norm``),
``y = (x − mean)·rsqrt(var + eps)`` cast to the input dtype.

Bound on the H100: bytes. The kernel does a handful of flops per element,
far below the ~295 flop/byte ridge, so its floor is one read of x and one
write of y at 3.35 TB/s. Design: one program per NCHW-contiguous plane, two
loops over the plane in power-of-two chunks (statistics, then normalise), so
it reads x twice and writes y once. The second read of a plane mostly hits
L2 (a 256² bf16 plane is 128 KB); a single-read design is later work.

The gradient is a ``torch.autograd.Function`` whose backward is the plain
torch form of the JAX custom VJP (``dx = rσ·(dy − mean(dy) − x̂·mean(dy·x̂))``);
the JAX backward is XLA, not Pallas, too.

A CPU tensor takes ``plain_instance_norm``; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import functools

import torch

_DTYPES = (torch.float32, torch.bfloat16)
_BLOCK = 2048
_NUM_WARPS = 8


def plain_instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in plain torch (NCHW)."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    mean2 = (xf * xf).mean(dim=(2, 3), keepdim=True)
    var = mean2 - mean * mean
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def in_fwd(x_ptr, y_ptr, hw, eps, BLOCK: tl.constexpr):
        base = tl.program_id(0).to(tl.int64) * hw
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
        for start in range(0, hw, BLOCK):
            idx = start + offs
            m = idx < hw
            v = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            y = (v - mean) * rstd
            tl.store(y_ptr + base + idx, y.to(y_ptr.dtype.element_ty), mask=m)

    return in_fwd


def _launch(x: torch.Tensor, eps: float) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("instance_norm kernel needs an NCHW-contiguous tensor")
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    _kernel()[(n * c,)](x, y, h * w, float(eps), BLOCK=_BLOCK,
                        num_warps=_NUM_WARPS)
    instance_norm.launches += 1
    return y


def _forward(x: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain_instance_norm(x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm: unsupported device {x.device}")
    return _launch(x, eps)


class _InstanceNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps):
        ctx.save_for_backward(x)
        ctx.eps = eps
        return _forward(x, eps)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean
        rsigma = torch.rsqrt(var + ctx.eps)
        dyf = dy.float()
        xhat = (xf - mean) * rsigma
        m_dy = dyf.mean(dim=(2, 3), keepdim=True)
        m_dyx = (dyf * xhat).mean(dim=(2, 3), keepdim=True)
        dx = rsigma * (dyf - m_dy - xhat * m_dyx)
        return dx.to(dy.dtype), None


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over an NCHW fp32 or bf16 tensor."""
    if x.dim() != 4:
        raise ValueError(f"instance_norm expects NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"instance_norm supports fp32 and bf16, not {x.dtype}")
    return _InstanceNormFn.apply(x, float(eps))


#: kernel launches since the caller last set this to 0
instance_norm.launches = 0
