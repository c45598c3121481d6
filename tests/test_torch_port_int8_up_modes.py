"""The port's all-int8 serving up modes against the JAX package, on the CPU.

``fused_int8_apply(up_mode=...)`` with 'int8_dilated', 'int8_phases' and
'resize_conv_int8': the int8 transposed conv as a phase split, equal to the
JAX package's phase split and lhs-dilated conv (exact on integers),
the quantized up kernels (equal to the JAX ones), every epilogue site on the
JAX path's own inputs (≤ 1 LSB on ≤ 0.1 % of values), the up convs on the
JAX path's own int8 inputs (exact), and the output against the JAX output
and against fp32. The ``resize_conv`` generator's fp32 forward is held to
1e-5.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from cycle_depth_estimation_tpu.models import quantization as jq
from cycle_depth_estimation_tpu.models.networks import (
    ResnetGenerator as JaxResnetGenerator,
)
from cycle_depth_estimation_tpu.ops import layers as jlayers
from cycle_depth_estimation_tpu.ops.pallas import int8_epilogue as jep
from cycle_depth_estimation_tpu_torch.models import quantization as pq
from cycle_depth_estimation_tpu_torch.models.networks import ResnetGenerator
from cycle_depth_estimation_tpu_torch.ops import layers as player
from cycle_depth_estimation_tpu_torch.ops.init import init_weights
from cycle_depth_estimation_tpu_torch.ops.int8_conv import im2col_conv2d_int8
from cycle_depth_estimation_tpu_torch.ops.kernels.int8_epilogue import (
    SM_COUNT,
    plain_epilogue,
    plan_epilogue,
)
from cycle_depth_estimation_tpu_torch.ops.layers import conv_transpose_s2_phases
from cycle_depth_estimation_tpu_torch.utils.weights import (
    resnet_generator_state_dict_from_jax,
)

N_BLOCKS = 2
DN = ("NHWC", "HWIO", "NHWC")
INT8_MODES = ("int8_dilated", "int8_phases", "resize_conv_int8")


def _cos(a, b):
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _ints(rng, shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


# ---------------------------------------------------------------------------
# the int8 transposed conv: phase-decomposed, exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,p,op", [(3, 1, 1), (4, 1, 0)])
def test_phase_decomposition_is_exact_on_integers(k, p, op):
    rng = np.random.RandomState(0)
    x, w = _ints(rng, (2, 7, 6, 8)), _ints(rng, (k, k, 8, 5))
    want = np.asarray(jlayers._conv_transpose_s2_phases(
        jnp.asarray(x), jnp.asarray(w), (k, k), (p, p), (op, op),
        preferred_element_type=jnp.int32))
    dilated = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1),
        ((k - 1 - p, k - 1 - p + op),) * 2, lhs_dilation=(2, 2),
        dimension_numbers=DN, preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(want, dilated)
    got = conv_transpose_s2_phases(torch.from_numpy(x), torch.from_numpy(w),
                                   (k, k), (p, p), (op, op))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("route", ["plain", "im2col_int_mm"])
def test_lhs_dilated_int8_conv_is_exact(route):
    """The 'int8_dilated' up stage (the phase split) against the JAX
    package's lhs-dilated int8 conv, through the CPU's exact conv and
    through the card's im2col + int8 GEMM."""
    rng = np.random.RandomState(1)
    x, w = _ints(rng, (2, 6, 5, 16)), _ints(rng, (3, 3, 16, 8))
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), ((1, 2), (1, 2)),
        lhs_dilation=(2, 2), dimension_numbers=DN,
        preferred_element_type=jnp.int32))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if route == "plain":
        got = pq._up_int8(xt, wt, "int8_dilated")
    else:
        with mock.patch.object(player, "conv2d_int8", im2col_conv2d_int8):
            got = pq._up_int8(xt, wt, "int8_dilated")
    assert got.shape == (2, 12, 10, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_phase_decomposition_rejects_uneven_split():
    x = torch.zeros(1, 4, 4, 8, dtype=torch.int8)
    with pytest.raises(ValueError):
        conv_transpose_s2_phases(x, torch.zeros(4, 4, 8, 8, dtype=torch.int8),
                                 (4, 4), (1, 1), (1, 1))


# ---------------------------------------------------------------------------
# the resize_conv generator in fp32
# ---------------------------------------------------------------------------


def _image(seed, n=2, size=32):
    return (np.random.RandomState(seed).rand(n, size, size, 3) * 2 - 1
            ).astype(np.float32)


def test_resize_conv_generator_matches_jax():
    x = _image(3)
    jg = JaxResnetGenerator(output_nc=3, ngf=8, n_blocks=N_BLOCKS,
                            up_mode="resize_conv")
    params = jg.init(jax.random.key(4), jnp.asarray(x))["params"]
    want = np.asarray(jg.apply({"params": params}, jnp.asarray(x)))
    g = ResnetGenerator(3, 3, ngf=8, n_blocks=N_BLOCKS,
                        up_mode="resize_conv").eval()
    sd = resnet_generator_state_dict_from_jax(
        jax.tree.map(np.asarray, params), N_BLOCKS, False, "resize_conv")
    g.load_state_dict(sd)
    assert g.state_dict()["model.13.weight"].shape == (16, 32, 3, 3)
    assert list(g.site_convs())[-3:] == ["up0_conv", "up1_conv", "conv_out"]
    with torch.no_grad():
        got = _nhwc(g(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        ResnetGenerator(up_mode="bilinear")


# ---------------------------------------------------------------------------
# calibrate → fused_int8_variables → fused_int8_apply, against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["convtranspose", "resize_conv"])
def pair(request):
    """A JAX generator of ``up_mode``, its port twin, both calibrated on
    the same batch and fused."""
    arch = request.param
    calib = jq.synthetic_calibration_batch(1, 2, 32)
    jg = JaxResnetGenerator(output_nc=3, ngf=8, n_blocks=N_BLOCKS, up_mode=arch)
    variables = jg.init(jax.random.key(0), jnp.asarray(calib))
    params = jax.tree.map(np.asarray, variables["params"])
    g = ResnetGenerator(3, 3, ngf=8, n_blocks=N_BLOCKS, up_mode=arch).eval()
    g.load_state_dict(resnet_generator_state_dict_from_jax(
        params, N_BLOCKS, False, arch))
    jax_static = jq.calibrate(
        jq.Int8ResnetGenerator(output_nc=3, ngf=8, n_blocks=N_BLOCKS,
                               up_mode=arch),
        jq.int8_generator_variables(variables["params"]), jnp.asarray(calib))
    port_static = pq.calibrate(
        pq.Int8ResnetGenerator(N_BLOCKS, up_mode=arch),
        pq.int8_generator_variables(g, device="cpu"), _nchw(calib),
        device="cpu")
    return dict(arch=arch, calib=calib, g=g, jax_static=jax_static,
                port_static=port_static,
                jax_fused=jq.fused_int8_variables(jax_static),
                port_fused=pq.fused_int8_variables(port_static))


def test_quantized_up_kernels_match_jax(pair):
    for i in range(2):
        want = pair["jax_fused"]["qparams"][f"up{i}_conv"]
        got = pair["port_fused"]["qparams"][f"up{i}_conv"]
        np.testing.assert_array_equal(got["kernel_q"].numpy(),
                                      np.asarray(want["kernel_q"]))
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      np.asarray(want["scale"]))
        a = float(want["act_scale"])
        assert abs(got["act_scale"] - a) <= 1e-5 * a
        assert got["kernel_q"].shape[:2] == (3, 3)


def test_v1_int8_generator_tracks_fp32(pair):
    x = _nchw(pair["calib"])
    with torch.no_grad():
        y_fp = pair["g"](x)
    got = pq.Int8ResnetGenerator(N_BLOCKS, up_mode=pair["arch"])(
        pair["port_static"], x)
    want = jq.Int8ResnetGenerator(output_nc=3, ngf=8, n_blocks=N_BLOCKS,
                                  up_mode=pair["arch"]).apply(
        pair["jax_static"], jnp.asarray(pair["calib"]))
    assert _cos(_nhwc(got), want) > 0.9999
    # as close to fp32 as the JAX v1 path is
    assert _cos(got.float(), y_fp) > min(0.999, _cos(want, _nhwc(y_fp)) - 1e-4)


def _modes(arch):
    return ("resize_conv_int8",) if arch == "resize_conv" else \
        ("int8_dilated", "int8_phases")


def _record_jax(fused, x, mode):
    """Run the JAX path, recording every epilogue call's inputs and
    outputs (as numpy)."""
    calls = []
    real = jep.fused_in_epilogue

    def rec(y, inv, residual=None, **kw):
        out = real(y, inv, residual, **kw)
        calls.append(dict(
            y=np.asarray(y), inv=None if inv is None else float(inv),
            residual=None if residual is None else np.asarray(residual, np.float32),
            kw={k: v for k, v in kw.items() if k in ("relu", "keep_float", "pad")},
            out=[None if o is None else np.asarray(o, np.float32) for o in out]))
        return out

    with mock.patch.object(jep, "fused_in_epilogue", rec):
        y = jq.fused_int8_apply(fused, jnp.asarray(x), n_blocks=N_BLOCKS,
                                up_mode=mode)
    return np.asarray(y, np.float32), calls


def test_every_epilogue_site_matches_jax_on_its_inputs(pair):
    for mode in _modes(pair["arch"]):
        _, calls = _record_jax(pair["jax_fused"], pair["calib"], mode)
        assert len(calls) == 3 + 2 * N_BLOCKS + 2
        # the last block, up0 and up1 all requantize in the int8 modes
        assert all(c["inv"] is not None for c in calls[-3:])
        assert [c["kw"].get("pad", 0) for c in calls[-3:]] == [0, 0, 3]
        for i, c in enumerate(calls):
            res = None if c["residual"] is None else \
                torch.tensor(c["residual"]).to(torch.bfloat16)
            q, z = plain_epilogue(torch.tensor(c["y"]), c["inv"], res,
                                  **c["kw"])
            if c["out"][0] is not None:
                d = np.abs(q.numpy().astype(np.int32)
                           - c["out"][0].astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (mode, i)
            if c["out"][1] is not None:
                np.testing.assert_allclose(z.float().numpy(), c["out"][1],
                                           atol=2e-2, rtol=1e-2)


def test_up_convs_match_jax_on_its_int8_inputs(pair):
    for mode in _modes(pair["arch"]):
        _, calls = _record_jax(pair["jax_fused"], pair["calib"], mode)
        last, up0, up1 = calls[-3:]
        q = pair["port_fused"]["qparams"]
        for a, site, conv in ((last["out"][0], up0, "up0_conv"),
                              (up0["out"][0], up1, "up1_conv")):
            got = pq._up_int8(torch.from_numpy(a.astype(np.int8)),
                              q[conv]["kernel_q"], mode)
            np.testing.assert_array_equal(got.numpy(), site["y"])


def test_fused_output_matches_jax_and_tracks_fp32(pair):
    x = pair["calib"]
    xt = _nchw(x)
    with torch.no_grad():
        y_fp = pair["g"](xt)
    outs = {}
    for mode in _modes(pair["arch"]):
        want, _ = _record_jax(pair["jax_fused"], x, mode)
        pq.fused_in_epilogue.launches = 0
        got = pq.fused_int8_apply(pair["port_fused"], xt, n_blocks=N_BLOCKS,
                                  up_mode=mode, device="cpu")
        assert pq.fused_in_epilogue.launches == 0  # CPU: the plain version
        assert got.dtype == torch.bfloat16 and got.shape == xt.shape
        assert _cos(_nhwc(got), want) >= 0.9999, mode
        assert _cos(got.float(), y_fp) > (0.995 if mode == "resize_conv_int8"
                                          else 0.999), mode
        outs[mode] = got
    if pair["arch"] == "convtranspose":
        # the same integers two ways: bit-identical outputs
        assert torch.equal(outs["int8_dilated"], outs["int8_phases"])


def test_unknown_up_mode_is_refused(pair):
    with pytest.raises(ValueError, match="unknown up_mode"):
        pq.fused_int8_apply(pair["port_fused"], _nchw(pair["calib"]),
                            n_blocks=N_BLOCKS, up_mode="int8", device="cpu")
    with pytest.raises(ValueError):
        pq.Int8ResnetGenerator(N_BLOCKS, up_mode="bf16")


# ---------------------------------------------------------------------------
# resize_conv_int8 against its fp32 generator: JAX and the port on the same
# seeded weights, calibration and input
# ---------------------------------------------------------------------------


def _jax_params_of(g):
    """A ``resize_conv`` port generator's weights as JAX params (every conv
    a regular one: HWIO kernel and bias)."""
    params = {}
    for name, conv in g.site_convs().items():
        node = params
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = {"kernel": conv.weight.detach().permute(2, 3, 1, 0).numpy(),
                      "bias": conv.bias.detach().numpy()}
    return params


def resize_conv_int8_cosines(ngf, n_blocks, size, n_x):
    """Cosine of the 'resize_conv_int8' output with its fp32 generator,
    through the JAX package and through the port on the CPU, for the
    generator, calibration batch and input that ``chip_smoke.py`` phase 6b
    uses at full width (``init_weights`` seeded with 0; calibration
    ``synthetic_calibration_batch(2, 4, size)``; the first ``n_x`` images
    of ``synthetic_calibration_batch(3, 8, size)``)."""
    g = init_weights(ResnetGenerator(3, 3, ngf, n_blocks, up_mode="resize_conv"),
                     generator=torch.Generator().manual_seed(0)).eval()
    calib = jq.synthetic_calibration_batch(2, 4, size)
    x = jq.synthetic_calibration_batch(3, max(8, n_x), size)[:n_x]
    params = _jax_params_of(g)
    y_fp = np.asarray(JaxResnetGenerator(
        output_nc=3, ngf=ngf, n_blocks=n_blocks, up_mode="resize_conv").apply(
        {"params": params}, jnp.asarray(x)))
    static = jq.calibrate(
        jq.Int8ResnetGenerator(output_nc=3, ngf=ngf, n_blocks=n_blocks,
                               up_mode="resize_conv"),
        jq.int8_generator_variables(params), jnp.asarray(calib))
    y_jax = np.asarray(jq.fused_int8_apply(
        jq.fused_int8_variables(static), jnp.asarray(x), n_blocks=n_blocks,
        up_mode="resize_conv_int8"), np.float32)
    port_static = pq.calibrate(
        pq.Int8ResnetGenerator(n_blocks, up_mode="resize_conv"),
        pq.int8_generator_variables(g, device="cpu"), _nchw(calib),
        device="cpu")
    y_port = _nhwc(pq.fused_int8_apply(
        pq.fused_int8_variables(port_static), _nchw(x), n_blocks=n_blocks,
        up_mode="resize_conv_int8", device="cpu"))
    with torch.no_grad():
        y_port_fp = _nhwc(g(_nchw(x)))
    return {"jax_vs_fp32": _cos(y_jax, y_fp),
            "port_vs_fp32": _cos(y_port, y_port_fp),
            "port_vs_jax": _cos(y_port, y_jax),
            "fp32_port_vs_jax": _cos(y_port_fp, y_fp)}


def test_resize_conv_int8_fidelity_matches_jax():
    """The port's 'resize_conv_int8' loses what the JAX function loses
    against fp32 (to 1e-4) on the same weights; the outputs may drift
    apart a little end to end, where 1-LSB flips amplify. ``python
    tests/test_torch_port_int8_up_modes.py`` runs this at full width."""
    c = resize_conv_int8_cosines(ngf=8, n_blocks=N_BLOCKS, size=64, n_x=2)
    assert c["fp32_port_vs_jax"] > 1 - 1e-6
    assert c["port_vs_jax"] >= 0.999
    assert abs(c["port_vs_fp32"] - c["jax_vs_fp32"]) <= 1e-4, c


# ---------------------------------------------------------------------------
# the three new epilogue site variants at full width get a cluster plan
# ---------------------------------------------------------------------------


_B, _S, _C = 8, 256, 64
_NEW_SITES = {
    "last_block_q": ((_B, _S // 4, _S // 4, 4 * _C), dict(residual=True)),
    "up0_q": ((_B, _S // 2, _S // 2, 2 * _C), dict()),
    "up1_q_pad3": ((_B, _S, _S, _C), dict(pad=3)),
}


@pytest.mark.parametrize("site", sorted(_NEW_SITES))
def test_new_epilogue_sites_get_a_cluster_plan(site):
    shape, kw = _NEW_SITES[site]
    plan = plan_epilogue(shape, 4, **kw)
    assert plan.variant != "generic"
    assert plan.blocks(shape[0], shape[3]) >= SM_COUNT
    assert plan.rows >= kw.get("pad", 0) + 1
    if shape[1] == _S // 4:
        assert plan.variant == "staged"


if __name__ == "__main__":
    # The full-width figure: the 9-block generator at ngf 64 and 256², one
    # image (about 2 GB of host memory and a few minutes on the CPU).
    import json

    print(json.dumps(resize_conv_int8_cosines(ngf=64, n_blocks=9, size=256,
                                              n_x=1)))
