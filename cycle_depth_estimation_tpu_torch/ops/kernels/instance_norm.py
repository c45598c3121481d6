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

Split across shards (``--parallel sp``, the image height split over a
``model`` group): a rank holds some rows of each plane, so the statistics
are the group's. Four more kernels, each one program a plane:
``in_stats`` writes the fp32 (Σx, Σx²) of this rank's rows; the caller
all-reduces the (N, C, 2) sums over the group; ``in_apply`` takes the
global sums and the global count H·W, forms ``mean = Σx / count`` and
``var = Σx² / count − mean²`` (the one-pass form, as above), writes y and
keeps (μ, rσ) for the backward. ``in_bwd_stats`` writes (Σdy, Σdy·x̂);
after their all-reduce ``in_bwd_apply`` writes ``dx = rσ·(dy − Σdy/count −
x̂·Σdy·x̂/count)``. Each is bound by bytes, like the fused pair; each split
entry reads its inputs once (the sums sit between two launches).
``instance_norm(x, eps, group, count)`` takes this route when ``group``
has more than one rank, and the fused one otherwise.

A CPU tensor takes ``plain_instance_norm`` / ``plain_instance_norm_backward``
(and ``plain_in_stats``, ``plain_in_apply``, ``plain_in_bwd_stats``,
``plain_in_bwd_apply`` for the split entries); a CUDA tensor launches the
kernels or raises.
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


def plain_in_stats(x: torch.Tensor) -> torch.Tensor:
    """``in_stats`` in plain torch: per plane fp32 (Σx, Σx²), (N, C, 2)."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))], -1)


def _global_stats(sums: torch.Tensor, count: int, eps: float):
    mean = sums[..., 0] / count
    var = sums[..., 1] / count - mean * mean
    return mean, torch.rsqrt(var + eps)


def plain_in_apply(x: torch.Tensor, sums: torch.Tensor, count: int,
                   eps: float = 1e-5):
    """``in_apply`` in plain torch: y from the group's sums over ``count``
    elements a plane, and the (mean, rstd) it used."""
    mean, rstd = _global_stats(sums, count, eps)
    y = (x.float() - mean[:, :, None, None]) * rstd[:, :, None, None]
    return y.to(x.dtype), (mean, rstd)


def plain_in_bwd_stats(x: torch.Tensor, dy: torch.Tensor,
                       stats: Tuple[torch.Tensor, torch.Tensor]
                       ) -> torch.Tensor:
    """``in_bwd_stats`` in plain torch: per plane fp32 (Σdy, Σdy·x̂)."""
    mean, rstd = (s[:, :, None, None] for s in stats)
    dyf = dy.float()
    xhat = (x.float() - mean) * rstd
    return torch.stack([dyf.sum(dim=(2, 3)), (dyf * xhat).sum(dim=(2, 3))],
                       -1)


def plain_in_bwd_apply(x: torch.Tensor, dy: torch.Tensor,
                       stats: Tuple[torch.Tensor, torch.Tensor],
                       sums: torch.Tensor, count: int) -> torch.Tensor:
    """``in_bwd_apply`` in plain torch: dx in dy's dtype from the group's
    (Σdy, Σdy·x̂) over ``count`` elements a plane."""
    mean, rstd = (s[:, :, None, None] for s in stats)
    m_dy = (sums[..., 0] / count)[:, :, None, None]
    m_dyx = (sums[..., 1] / count)[:, :, None, None]
    xhat = (x.float() - mean) * rstd
    return (rstd * (dy.float() - m_dy - xhat * m_dyx)).to(dy.dtype)


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


@functools.lru_cache(maxsize=None)
def _split_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def in_stats_k(x_ptr, sums_ptr, hw, BLOCK: tl.constexpr):
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
        tl.store(sums_ptr + 2 * pid, tl.sum(acc1, axis=0))
        tl.store(sums_ptr + 2 * pid + 1, tl.sum(acc2, axis=0))

    @triton.jit
    def in_apply_k(x_ptr, y_ptr, sums_ptr, mean_ptr, rstd_ptr, hw, count,
                   eps, BLOCK: tl.constexpr, STATS: tl.constexpr):
        pid = tl.program_id(0)
        base = pid.to(tl.int64) * hw
        mean = tl.load(sums_ptr + 2 * pid) / count
        var = tl.load(sums_ptr + 2 * pid + 1) / count - mean * mean
        rstd = 1.0 / tl.sqrt(var + eps)
        if STATS:
            tl.store(mean_ptr + pid, mean)
            tl.store(rstd_ptr + pid, rstd)
        offs = tl.arange(0, BLOCK)
        for start in range(0, hw, BLOCK):
            idx = start + offs
            m = idx < hw
            v = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            y = (v - mean) * rstd
            tl.store(y_ptr + base + idx, y.to(y_ptr.dtype.element_ty), mask=m)

    @triton.jit
    def in_bwd_stats_k(x_ptr, dy_ptr, mean_ptr, rstd_ptr, sums_ptr, hw,
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
        tl.store(sums_ptr + 2 * pid, tl.sum(acc_dy, axis=0))
        tl.store(sums_ptr + 2 * pid + 1, tl.sum(acc_dyx, axis=0))

    @triton.jit
    def in_bwd_apply_k(x_ptr, dy_ptr, mean_ptr, rstd_ptr, sums_ptr, dx_ptr,
                       hw, count, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        base = pid.to(tl.int64) * hw
        mean = tl.load(mean_ptr + pid)
        rstd = tl.load(rstd_ptr + pid)
        m_dy = tl.load(sums_ptr + 2 * pid) / count
        m_dyx = tl.load(sums_ptr + 2 * pid + 1) / count
        offs = tl.arange(0, BLOCK)
        for start in range(0, hw, BLOCK):
            idx = start + offs
            m = idx < hw
            v = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            g = tl.load(dy_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            dx = rstd * (g - m_dy - ((v - mean) * rstd) * m_dyx)
            tl.store(dx_ptr + base + idx, dx.to(dx_ptr.dtype.element_ty),
                     mask=m)

    return in_stats_k, in_apply_k, in_bwd_stats_k, in_bwd_apply_k


def _plan(hw: int):
    """(BLOCK, num_warps) of the backward and the split entries: a chunk
    sized to the plane up to 2048."""
    block = min(_BLOCK, 1 << (hw - 1).bit_length())
    return block, 8 if block >= 2048 else 4


def _check_split(x: torch.Tensor, what: str, *others: torch.Tensor) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"{what} needs an NCHW-contiguous fp32 or bf16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    n, c = x.shape[:2]
    for t in others:
        if t.device != x.device or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.numel() not in (n * c, 2 * n * c):
            raise ValueError(f"{what}: per-plane fp32 statistics of "
                             f"{tuple(x.shape)} on {x.device} expected, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def in_stats(x: torch.Tensor) -> torch.Tensor:
    """Per plane fp32 (Σx, Σx²) over this rank's rows, (N, C, 2)."""
    if _device_kind(x, "in_stats") == "cpu":
        return plain_in_stats(x)
    _check_split(x, "in_stats")
    n, c, h, w = x.shape
    sums = torch.empty((n, c, 2), device=x.device, dtype=torch.float32)
    block, warps = _plan(h * w)
    _split_kernels()[0][(n * c,)](x, sums, h * w, BLOCK=block,
                                  num_warps=warps)
    in_stats.launches += 1
    return sums


def in_apply(x: torch.Tensor, sums: torch.Tensor, count: int,
             eps: float = 1e-5, stats: bool = True):
    """y = (x − μ)·rσ with μ and rσ from the group's (Σx, Σx²) over
    ``count`` elements a plane; returns (y, (μ, rσ)), the statistics
    (fp32, (N, C)) written where ``stats``, else None."""
    if _device_kind(x, "in_apply") == "cpu":
        y, st = plain_in_apply(x, sums, count, eps)
        return y, (st if stats else None)
    _check_split(x, "in_apply", sums)
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    if stats:
        mean = torch.empty((n, c), device=x.device, dtype=torch.float32)
        rstd = torch.empty_like(mean)
    else:
        mean = rstd = sums  # never written: STATS is a compile-time False
    block, warps = _plan(h * w)
    _split_kernels()[1][(n * c,)](x, y, sums, mean, rstd, h * w,
                                  float(count), float(eps), BLOCK=block,
                                  STATS=stats, num_warps=warps)
    in_apply.launches += 1
    return y, ((mean, rstd) if stats else None)


def in_bwd_stats(x: torch.Tensor, dy: torch.Tensor,
                 stats: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Per plane fp32 (Σdy, Σdy·x̂) over this rank's rows, (N, C, 2)."""
    if _device_kind(x, "in_bwd_stats") == "cpu":
        return plain_in_bwd_stats(x, dy, stats)
    dy = dy.contiguous()
    _check_split(x, "in_bwd_stats", *stats)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"in_bwd_stats: dy {tuple(dy.shape)} on "
                         f"{dy.device} does not match x")
    n, c, h, w = x.shape
    sums = torch.empty((n, c, 2), device=x.device, dtype=torch.float32)
    block, warps = _plan(h * w)
    _split_kernels()[2][(n * c,)](x, dy, *stats, sums, h * w, BLOCK=block,
                                  num_warps=warps)
    in_bwd_stats.launches += 1
    return sums


def in_bwd_apply(x: torch.Tensor, dy: torch.Tensor,
                 stats: Tuple[torch.Tensor, torch.Tensor],
                 sums: torch.Tensor, count: int) -> torch.Tensor:
    """dx in dy's dtype from the group's (Σdy, Σdy·x̂) over ``count``
    elements a plane."""
    if _device_kind(x, "in_bwd_apply") == "cpu":
        return plain_in_bwd_apply(x, dy, stats, sums, count)
    dy = dy.contiguous()
    _check_split(x, "in_bwd_apply", *stats, sums)
    if dy.shape != x.shape or dy.device != x.device or \
            dy.dtype not in _DTYPES:
        raise ValueError(f"in_bwd_apply: dy {tuple(dy.shape)} {dy.dtype} "
                         f"on {dy.device} does not match x")
    n, c, h, w = x.shape
    dx = torch.empty_like(dy)
    block, warps = _plan(h * w)
    _split_kernels()[3][(n * c,)](x, dy, *stats, sums, dx, h * w,
                                  float(count), BLOCK=block, num_warps=warps)
    in_bwd_apply.launches += 1
    return dx


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
    block, warps = _plan(h * w)
    _kernels()[1][(n * c,)](x, dy, mean, rstd, dx, h * w, BLOCK=block,
                            num_warps=warps)
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


class _SplitInstanceNormFn(torch.autograd.Function):
    """The statistics of planes whose rows lie on the ranks of ``group``:
    stats → all-reduce → apply, and in backward the same for the gradient
    sums."""

    @staticmethod
    def forward(ctx, x, eps, group, count, grad):
        from ...parallel.collectives import all_reduce_

        ctx.group, ctx.count = group, count
        sums = all_reduce_(in_stats(x), group)
        y, stats = in_apply(x, sums, count, eps, stats=grad)
        ctx.save_for_backward(x, *(stats or ()))
        return y

    @staticmethod
    def backward(ctx, dy):
        from ...parallel.collectives import all_reduce_

        x, mean, rstd = ctx.saved_tensors
        sums = all_reduce_(in_bwd_stats(x, dy, (mean, rstd)), ctx.group)
        dx = in_bwd_apply(x, dy, (mean, rstd), sums, ctx.count)
        return dx, None, None, None, None


def instance_norm(x: torch.Tensor, eps: float = 1e-5, group=None,
                  count: Optional[int] = None) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over an NCHW fp32 or bf16 tensor.

    ``group``: the process group whose ranks hold the other rows of each
    plane (the ``model`` group under ``--parallel sp``), and ``count`` the
    whole plane's H·W. With no group, or a group of one rank, the fused
    kernels run; otherwise the split entries with an all-reduce of the
    per-plane sums between them."""
    if x.dim() != 4:
        raise ValueError(f"instance_norm expects NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"instance_norm supports fp32 and bf16, not {x.dtype}")
    # (ctx.needs_input_grad ignores no_grad: ask autograd's mode here)
    grad = torch.is_grad_enabled() and x.requires_grad
    if group is not None:
        import torch.distributed as dist

        if dist.get_world_size(group) > 1:
            if count is None:
                raise ValueError("instance_norm over a group needs the "
                                 "whole plane's count H·W")
            return _SplitInstanceNormFn.apply(x.contiguous(), float(eps),
                                              group, int(count), grad)
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
in_stats.launches = 0
in_apply.launches = 0
in_bwd_stats.launches = 0
in_bwd_apply.launches = 0
