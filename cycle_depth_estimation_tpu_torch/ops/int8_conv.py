"""int8 × int8 → int32 convolution, NHWC activations and HWIO weights.

The counterpart of ``_conv_q`` in the JAX package's
``models/quantization.py`` and of the XLA conv that ``models/ptq.py``
passes ``preferred_element_type=int32`` (both outside any Pallas kernel).
PyTorch has no CUDA int8 conv, so on the GPU this is an im2col built by
slicing the int8 tensor, followed by one cuBLAS int8 GEMM per group
(``torch._int_mm``). ``_int_mm`` wants K and N to be multiples of 8, so the
patch matrix gets zero columns and the weight zero rows/columns as needed
(K = 7·7·3 = 147 → 152 for conv_in, N = 3 → 8 for conv_out); on CUDA it
also wants more than 16 rows, so a smaller M (a pooled PSP plane) gets zero
rows.

On the CPU it is an fp64 ``F.conv2d`` on the integer values, rounded back to
int32: exact, since |sum| ≤ 127²·7·7·2048 < 2⁵³.

``stride`` and ``dilation`` are an int or a pair; ``padding`` is an int,
a pair ``(ph, pw)`` or ``((top, bottom), (left, right))``: zeros always.
``groups`` splits Cin and Cout as ``nn.Conv2d`` does (the HWIO kernel holds
Cin/groups input channels). ``conv_transpose2d_int8`` is the lhs-dilated
form of a transposed conv, as the JAX ``ptq._int8_conv_transpose`` runs it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_INT_MM_MIN_ROWS = 17  # cuBLAS int8 GEMM through torch._int_mm: M > 16


def _round8(v: int) -> int:
    return (v + 7) // 8 * 8


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pad2(padding):
    """int | (ph, pw) | ((top, bottom), (left, right)) → the last form."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    ph, pw = padding
    return tuple(_pair(ph)), tuple(_pair(pw))


def _zero_pad(x: torch.Tensor, padding) -> torch.Tensor:
    """Zero-pad NHWC ``x`` (``padding`` in any of the forms above)."""
    (t, b), (l, r) = _pad2(padding)
    return F.pad(x, (0, 0, l, r, t, b)) if t or b or l or r else x


def plain_conv2d_int8(x: torch.Tensor, kernel: torch.Tensor, stride=1,
                      padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """Exact reference: fp64 conv on the integer values."""
    y = F.conv2d(_zero_pad(x, padding).permute(0, 3, 1, 2).double(),
                 kernel.permute(3, 2, 0, 1).double(), stride=_pair(stride),
                 dilation=_pair(dilation), groups=groups)
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def im2col_conv2d_int8(x: torch.Tensor, kernel: torch.Tensor, stride=1,
                       padding=0, dilation=1, groups: int = 1
                       ) -> torch.Tensor:
    """im2col + ``torch._int_mm``, one GEMM per group; patch columns ordered
    (kh, kw, cin) to match the HWIO weight flattened to (KH·KW·Cin, Cout)."""
    x = _zero_pad(x, padding)
    n, h, w, cin = x.shape
    kh, kw, cin_g, cout = kernel.shape
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    if cin != cin_g * groups or cout % groups:
        raise ValueError(f"{cin} input and {cout} output channels do not "
                         f"split into {groups} groups of {cin_g} inputs")
    ho = (h - dh * (kh - 1) - 1) // sh + 1
    wo = (w - dw * (kw - 1) - 1) // sw + 1
    m, k, cout_g = n * ho * wo, kh * kw * cin_g, cout // groups
    kp, np_ = _round8(k), _round8(cout_g)
    mp = max(m, _INT_MM_MIN_ROWS) if x.is_cuda else m
    outs = []
    for g in range(groups):
        xg = x[..., g * cin_g:(g + 1) * cin_g]
        cols = [xg[:, i * dh:i * dh + sh * (ho - 1) + 1:sh,
                   j * dw:j * dw + sw * (wo - 1) + 1:sw, :]
                for i in range(kh) for j in range(kw)]
        if kp > k:
            cols.append(x.new_zeros((n, ho, wo, kp - k)))
        a = torch.cat(cols, dim=3).reshape(m, kp)
        if mp > m:
            a = F.pad(a, (0, 0, 0, mp - m))
        # (Cout_p, K_p) row-major, passed transposed: the column-major B
        # operand
        b = kernel.new_zeros((np_, kp))
        b[:cout_g, :k] = kernel[..., g * cout_g:(g + 1) * cout_g].reshape(
            k, cout_g).t()
        outs.append(torch._int_mm(a, b.t())[:m, :cout_g])
    y = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return y.reshape(n, ho, wo, cout)


def conv2d_int8(x: torch.Tensor, kernel: torch.Tensor, stride=1, padding=0,
                dilation=1, groups: int = 1) -> torch.Tensor:
    """int8 NHWC ``x`` ⊛ int8 HWIO ``kernel`` → int32 NHWC, zero ``padding``."""
    if x.dtype != torch.int8 or kernel.dtype != torch.int8:
        raise TypeError("conv2d_int8 takes int8 activations and weights")
    if x.device != kernel.device:
        raise ValueError("activations and weights are on different devices")
    if x.device.type == "cpu":
        return plain_conv2d_int8(x, kernel, stride, padding, dilation, groups)
    return im2col_conv2d_int8(x, kernel, stride, padding, dilation,
                              groups).contiguous()


def conv_transpose2d_int8(x: torch.Tensor, kernel: torch.Tensor, stride=1,
                          padding=0, output_padding=0) -> torch.Tensor:
    """``ConvTranspose2d(k, stride, padding, output_padding)`` on int8 NHWC
    ``x`` → int32 NHWC, as the lhs-dilated conv: zeros inserted, padded by
    (k − 1 − p, k − 1 − p + op), then ``conv2d_int8``. ``kernel`` is the
    equivalent regular conv's int8 HWIO kernel (torch's weight flipped
    spatially, in and out swapped: ``hwio_from_conv_transpose_weight``)."""
    kh, kw = kernel.shape[:2]
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    oph, opw = _pair(output_padding)
    n, h, w, c = x.shape
    dilated = x.new_zeros((n, (h - 1) * sh + 1, (w - 1) * sw + 1, c))
    dilated[:, ::sh, ::sw] = x
    pad = ((kh - 1 - ph, kh - 1 - ph + oph), (kw - 1 - pw, kw - 1 - pw + opw))
    return conv2d_int8(dilated, kernel, 1, pad)
