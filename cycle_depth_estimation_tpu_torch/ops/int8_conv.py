"""int8 × int8 → int32 convolution, NHWC activations and HWIO weights.

The counterpart of ``_conv_q`` in the JAX package's
``models/quantization.py`` (an XLA conv with int32 accumulation, outside any
Pallas kernel). PyTorch has no CUDA int8 conv, so on the GPU this is an
im2col built by slicing the int8 tensor, followed by one cuBLAS int8 GEMM
(``torch._int_mm``). ``_int_mm`` wants K and N to be multiples of 8, so the
patch matrix gets zero columns and the weight zero rows/columns as needed
(K = 7·7·3 = 147 → 152 for conv_in, N = 3 → 8 for conv_out).

On the CPU it is an fp64 ``F.conv2d`` on the integer values, rounded back to
int32: exact, since |sum| ≤ 127²·7·7·256 < 2⁵³.

``padding`` is an int or ``((top, bottom), (left, right))``: zeros either
way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _round8(v: int) -> int:
    return (v + 7) // 8 * 8


def _zero_pad(x: torch.Tensor, padding) -> torch.Tensor:
    """Zero-pad NHWC ``x`` by an int or ((top, bottom), (left, right))."""
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    (t, b), (l, r) = padding
    return F.pad(x, (0, 0, l, r, t, b)) if t or b or l or r else x


def plain_conv2d_int8(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                      padding=0) -> torch.Tensor:
    """Exact reference: fp64 conv on the integer values."""
    y = F.conv2d(_zero_pad(x, padding).permute(0, 3, 1, 2).double(),
                 kernel.permute(3, 2, 0, 1).double(), stride=stride)
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def im2col_conv2d_int8(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                       padding=0) -> torch.Tensor:
    """im2col + ``torch._int_mm``; patch columns ordered (kh, kw, cin) to
    match the HWIO weight flattened to (KH·KW·Cin, Cout)."""
    x = _zero_pad(x, padding)
    n, h, w, cin = x.shape
    kh, kw, _, cout = kernel.shape
    ho = (h - kh) // stride + 1
    wo = (w - kw) // stride + 1
    k = kh * kw * cin
    cols = [x[:, i:i + stride * (ho - 1) + 1:stride,
              j:j + stride * (wo - 1) + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    kp, np_ = _round8(k), _round8(cout)
    if kp > k:
        cols.append(x.new_zeros((n, ho, wo, kp - k)))
    a = torch.cat(cols, dim=3).reshape(n * ho * wo, kp)
    # (Cout_p, K_p) row-major, passed transposed: the column-major B operand
    b = kernel.new_zeros((np_, kp))
    b[:cout, :k] = kernel.reshape(k, cout).t()
    y = torch._int_mm(a, b.t())
    return y[:, :cout].reshape(n, ho, wo, cout)


def conv2d_int8(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                padding=0) -> torch.Tensor:
    """int8 NHWC ``x`` ⊛ int8 HWIO ``kernel`` → int32 NHWC, zero ``padding``."""
    if x.dtype != torch.int8 or kernel.dtype != torch.int8:
        raise TypeError("conv2d_int8 takes int8 activations and weights")
    if x.device != kernel.device:
        raise ValueError("activations and weights are on different devices")
    if x.device.type == "cpu":
        return plain_conv2d_int8(x, kernel, stride, padding)
    return im2col_conv2d_int8(x, kernel, stride, padding).contiguous()

