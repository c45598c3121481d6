"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each kernel wrapper takes its plain torch version, so these
tests hold that arithmetic (and the shapes, padding and layouts around it)
against the JAX functions the kernels replace, run as the JAX package's own
tests run them: Pallas in interpret mode, or the XLA reference. The CUDA
kernels themselves are checked against the same plain versions on the card
by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cycle_depth_estimation_tpu.models.quantization import _conv_q
from cycle_depth_estimation_tpu.ops.pallas.instance_norm import (
    _xla_instance_norm,
    instance_norm as jax_instance_norm,
)
from cycle_depth_estimation_tpu.ops.pallas.int8_epilogue import (
    fused_in_epilogue as jax_fused_in_epilogue,
)
from cycle_depth_estimation_tpu_torch.ops.int8_conv import (
    conv2d_int8,
    im2col_conv2d_int8,
)
from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
    instance_norm,
)
from cycle_depth_estimation_tpu_torch.ops.kernels.int8_epilogue import (
    fused_in_epilogue,
    pad_nhwc,
)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


# ---------------------------------------------------------------------------
# kernel 1: InstanceNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_instance_norm_plain_matches_jax(reference):
    # offset + scale make the one-pass variance formula do real work
    x = np.random.RandomState(0).randn(3, 16, 12, 8).astype(np.float32) * 3 + 1
    if reference == "xla":
        want = np.asarray(_xla_instance_norm(jnp.asarray(x), 1e-5))
    else:
        want = np.asarray(jax_instance_norm(jnp.asarray(x), use_pallas=True,
                                            interpret=True))
    got = _nhwc(instance_norm(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_instance_norm_backward_matches_jax_custom_vjp():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 4).astype(np.float32) * 2 + 0.5
    w = rng.randn(2, 8, 8, 4).astype(np.float32)

    g_jax = jax.grad(lambda a: jnp.sum(jnp.sin(jax_instance_norm(a)) * w))(
        jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    (torch.sin(instance_norm(xt)) * _nchw(w)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(g_jax), atol=1e-5,
                               rtol=1e-5)


def test_instance_norm_bf16_matches_jax_within_one_ulp():
    x = np.random.RandomState(2).randn(2, 16, 16, 8).astype(np.float32)
    want = np.asarray(_xla_instance_norm(jnp.asarray(x, jnp.bfloat16), 1e-5),
                      np.float32)
    got = instance_norm(_nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    diff = np.abs(_nhwc(got) - want)
    assert np.all(diff <= _bf16_ulp(want)), diff.max()


def test_instance_norm_checks_inputs_and_counts_no_cpu_launch():
    instance_norm.launches = 0
    with pytest.raises(ValueError):
        instance_norm(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError):
        instance_norm(torch.zeros(1, 2, 4, 4, dtype=torch.float16))
    instance_norm(torch.randn(1, 2, 4, 4))
    assert instance_norm.launches == 0
    # only a CPU tensor takes the plain version; any other device launches
    # the kernel (CUDA) or raises
    with pytest.raises(ValueError):
        instance_norm(torch.empty(1, 2, 4, 4, device="meta"))


# ---------------------------------------------------------------------------
# kernel 2: the int8 epilogue
# ---------------------------------------------------------------------------

_EPILOGUE_CASES = {
    "relu_pad1": (dict(relu=True, pad=1), "int32", True),
    "relu_keep_float": (dict(relu=True, keep_float=True), "int32", True),
    "residual_pad1": (dict(residual=True, pad=1), "int32", True),
    "residual": (dict(residual=True), "int32", True),
    "relu_edge_pad2": (dict(relu=True, pad=2, pad_mode="edge"), "int32", True),
    "bf16_in_relu_pad3": (dict(relu=True, pad=3), "bf16", True),
    "float_only_relu_bf16_in": (dict(relu=True), "bf16", False),
    "float_only_residual": (dict(residual=True), "int32", False),
}


@pytest.mark.parametrize("case", sorted(_EPILOGUE_CASES))
def test_epilogue_plain_matches_jax(case):
    kw, in_dtype, quantize = _EPILOGUE_CASES[case]
    rng = np.random.RandomState(3)
    if in_dtype == "int32":
        y = rng.randint(-30000, 30000, (2, 16, 16, 8)).astype(np.int32)
        y_j, y_t = jnp.asarray(y), torch.from_numpy(y)
    else:
        y = (rng.randn(2, 16, 16, 8) * 3).astype(np.float32)
        y_j = jnp.asarray(y, jnp.bfloat16)
        y_t = torch.from_numpy(y).to(torch.bfloat16)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("residual"):
        h = rng.randn(2, 16, 16, 8).astype(np.float32)
        jkw["residual"] = jnp.asarray(h, jnp.bfloat16)
        tkw["residual"] = torch.from_numpy(h).to(torch.bfloat16)
    inv_s = np.float32(25.0) if quantize else None

    if quantize:
        qj, zj = jax_fused_in_epilogue(y_j, jnp.float32(inv_s), use_pallas=True,
                                       interpret=True, **jkw)
    else:
        qj, zj = jax_fused_in_epilogue(y_j, None, **jkw)
    qt, zt = fused_in_epilogue(y_t, None if inv_s is None else float(inv_s),
                               **tkw)

    assert (qt is None) == (qj is None) and (zt is None) == (zj is None)
    if qj is not None:
        qj = np.asarray(qj).astype(np.int32)
        qt = qt.numpy().astype(np.int32)
        assert qt.shape == qj.shape and qt.dtype == np.int32
        d = np.abs(qt - qj)
        assert d.max() <= 1 and np.mean(d > 0) <= 1e-3, (d.max(), np.mean(d > 0))
    if zj is not None:
        zj = np.asarray(zj, np.float32)
        zt = zt.float().numpy()
        assert zt.shape == zj.shape
        assert np.all(np.abs(zt - zj) <= _bf16_ulp(zj))


def test_epilogue_checks_inputs():
    y = torch.zeros(1, 4, 4, 8, dtype=torch.int32)
    h = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fused_in_epilogue(y.float(), 1.0)
    with pytest.raises(ValueError):
        fused_in_epilogue(y, 1.0, h, relu=True)
    with pytest.raises(ValueError):
        fused_in_epilogue(y, 1.0, h.float())
    with pytest.raises(ValueError):
        fused_in_epilogue(y, 1.0, pad=4)
    with pytest.raises(ValueError):
        fused_in_epilogue(y, 1.0, pad=1, pad_mode="wrap")
    fused_in_epilogue.launches = 0
    fused_in_epilogue(y, 1.0, relu=True)
    assert fused_in_epilogue.launches == 0
    with pytest.raises(ValueError):
        fused_in_epilogue(y.to("meta"), 1.0, relu=True)


@pytest.mark.parametrize("mode", ["reflect", "edge"])
def test_pad_nhwc_matches_jnp_pad(mode):
    x = np.random.RandomState(4).randint(-127, 128, (2, 6, 5, 3)).astype(np.int8)
    want = np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)), mode=mode)
    np.testing.assert_array_equal(pad_nhwc(torch.from_numpy(x), 3, mode).numpy(),
                                  want)


# ---------------------------------------------------------------------------
# the int8 conv (not a kernel: im2col + cuBLAS int8 GEMM on the card)
# ---------------------------------------------------------------------------

_CONV_CASES = {
    "conv_in_7x7": (7, 3, 8, 1, 0),      # K = 147, padded to 152
    "down_3x3_s2_p1": (3, 8, 16, 2, 1),
    "block_3x3": (3, 16, 16, 1, 0),
    "conv_out_7x7": (7, 8, 3, 1, 0),     # N = 3, padded to 8
}


@pytest.mark.parametrize("case", sorted(_CONV_CASES))
@pytest.mark.parametrize("route", ["plain", "im2col_int_mm"])
def test_int8_conv_matches_jax_conv_q(case, route):
    k, cin, cout, stride, pad = _CONV_CASES[case]
    rng = np.random.RandomState(5)
    x = rng.randint(-127, 128, (2, 18, 18, cin)).astype(np.int8)
    w = rng.randint(-127, 128, (k, k, cin, cout)).astype(np.int8)
    want = np.asarray(_conv_q(jnp.asarray(x), jnp.asarray(w), stride,
                              ((pad, pad), (pad, pad))))
    fn = conv2d_int8 if route == "plain" else im2col_conv2d_int8
    got = fn(torch.from_numpy(x), torch.from_numpy(w), stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
