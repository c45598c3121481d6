"""The port's generic PTQ on RefineNet-LW and the S2D inference chain
against the JAX package's (the cases of ``tests/test_ptq.py:88-150``), and
the int8 conv at the geometries those nets give it, on the CPU.

RefineNet-LW (layers (1, 1, 1, 1), 64×96) is calibrated on 'real' and
served in both domains ('syn' runs its own adapters in float: they did not
run in calibration, on either side). The S2D chain is G_1 (one block) →
G_2 (DenseNet blocks (2, 2, 2, 2)) → R_D at 48×96, each net calibrated on
its own input and served on the int8 output of the one before. The JAX
variables are the port nets', through ``jax_variables_from_net``.

Held, as in ``test_torch_port_ptq.py``: site keys equal;
``kernel_q``/``scale`` exactly and the first ``act_scale`` exactly where
that site reads the net's input (G_2's reads it through a BatchNorm); every
site's int8 conv, fed JAX's input and site, bit-equal to JAX's; the
outputs at JAX's thresholds against fp32 (RefineNet pred cosine > 0.99 in
both domains; S2D depth and seg > 0.98, argmax agreement > 0.9) and at
cosine ≥ 0.999 with JAX's int8 outputs.

``conv2d_int8``: the im2col + ``torch._int_mm`` route (the card's) and the
fp64 route (the CPU's) against XLA's int32 conv, at dilations 1–7, pair
strides and paddings, groups, and the lhs-dilated transposed form against
an fp64 ``F.conv_transpose2d`` of the torch weight.
"""

from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import jax
import jax.numpy as jnp
from jax import lax

from cycle_depth_estimation_tpu.models import ptq as jptq
from cycle_depth_estimation_tpu.models import refinenet as jrf
from cycle_depth_estimation_tpu.models import s2d_networks as jsn
from cycle_depth_estimation_tpu_torch.models import ptq
from cycle_depth_estimation_tpu_torch.models import refinenet as prf
from cycle_depth_estimation_tpu_torch.models import s2d_networks as psn
from cycle_depth_estimation_tpu_torch.ops.init import init_weights
from cycle_depth_estimation_tpu_torch.ops.int8_conv import (
    conv2d_int8, conv_transpose2d_int8, im2col_conv2d_int8,
    plain_conv2d_int8)
from cycle_depth_estimation_tpu_torch.utils.weights import (
    hwio_from_conv_transpose_weight, jax_variables_from_net)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads while a test of this file runs (six test
    processes share the machine's cores in the Tier-1 run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _img(seed, n, h, w, c=3):
    return (np.random.RandomState(seed).rand(n, h, w, c) * 2 - 1).astype(
        np.float32)


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _jax_vars(net):
    params, stats = jax_variables_from_net(net)
    return jax.tree.map(jnp.asarray, {"params": params,
                                      "batch_stats": stats})


def _forced_sites_equal(net, apply_fn, jsites, *args):
    """Every site of JAX's int8 forward, given to the port's int8 conv with
    the same float input and site: bit-equal outputs. Returns JAX's int8
    output."""
    seen, real = [], jptq._int8_conv

    def recording(m, a, q):
        y = real(m, a, q)
        seen.append(("/".join(m.path), np.asarray(a), np.asarray(y)))
        return y

    with mock.patch.object(jptq, "_int8_conv", recording):
        out = jptq.int8_apply(apply_fn, jsites, *args)
    modules = {k: m for m, k in ptq.conv_sites(net).items()}
    assert seen and {k for k, _, _ in seen} <= set(jsites)
    for key, a, y in seen:
        q = {k: torch.from_numpy(np.array(v)) for k, v in jsites[key].items()}
        got = ptq._int8_conv(modules[key], _nchw(a), q)
        np.testing.assert_array_equal(_nhwc(got), y, err_msg=key)
    return out


def _sites_match(got, want, exact_first=True):
    """The same keys (the call order may differ: the port's Bottleneck runs
    its downsample conv first) and the same first site; kernels and scales
    exactly; the first ``act_scale`` exactly where that site reads the
    net's input (``exact_first``), the others within 1e-5 relative."""
    assert set(got) == set(want) and next(iter(got)) == next(iter(want))
    first = next(iter(want)) if exact_first else None
    for key, w in want.items():
        np.testing.assert_array_equal(got[key]["kernel_q"].numpy(),
                                      np.asarray(w["kernel_q"]), err_msg=key)
        np.testing.assert_array_equal(got[key]["scale"].numpy(),
                                      np.asarray(w["scale"]), err_msg=key)
        ga, wa = float(got[key]["act_scale"]), float(w["act_scale"])
        assert ga == wa if key == first else abs(ga - wa) <= 1e-5 * wa, \
            (key, ga, wa)


# ---------------------------------------------------------------------------
# RefineNet-LW (test_ptq.py:88-106)
# ---------------------------------------------------------------------------


def test_refinenet_int8_matches_jax_and_tracks_fp32():
    net = init_weights(prf.ResNetLW((1, 1, 1, 1)), "normal", 0.02,
                       torch.Generator().manual_seed(3)).eval()
    jnet = jrf.ResNetLW(layers=(1, 1, 1, 1))
    vs = _jax_vars(net)
    x = _img(3, 1, 64, 96)
    jsites, jserve = jptq.quantize_for_serving(jnet, vs,
                                               (jnp.asarray(x), "real"))
    sites, serve = ptq.quantize_for_serving(net, (_nchw(x), "real"))
    assert len(sites) > 10
    assert not any(k.startswith("ins_layer") and k.split("/")[0].endswith(
        "_s") for k in sites)
    _sites_match(sites, jsites)
    for domain in ("real", "syn"):
        _, jpred_q, _ = _forced_sites_equal(
            net, lambda a: jnet.apply(vs, a, domain), jsites,
            jnp.asarray(x))
        _, pred_q, _ = serve(sites, _nchw(x), domain)
        with torch.no_grad():
            _, pred_fp, _ = net(_nchw(x), domain)
        assert pred_q.shape == pred_fp.shape
        assert _cos(_nhwc(pred_q), jpred_q) >= 0.999, domain
        assert _cos(pred_q, pred_fp) > 0.99, domain


# ---------------------------------------------------------------------------
# The S2D inference chain (test_ptq.py:113-150)
# ---------------------------------------------------------------------------


def test_s2d_chain_int8_matches_jax_and_tracks_fp32():
    gen = torch.Generator().manual_seed(4)
    g1 = init_weights(psn.G1(n_blocks=1), "kaiming", 0.0, gen).eval()
    g2 = init_weights(psn.GeneralNet(1024, 32, (2, 2, 2, 2)), "kaiming",
                      0.0, gen).eval()
    rd = init_weights(psn.RDep(1024, g2.feature_channels), "normal", 0.02,
                      gen).eval()
    jg1, jg2, jrd = (jsn.G1(n_blocks=1),
                     jsn.GeneralNet(block_config=(2, 2, 2, 2)), jsn.RDep())
    v1, v2, v3 = _jax_vars(g1), _jax_vars(g2), _jax_vars(rd)
    x = _nchw(_img(4, 1, 48, 96))
    with torch.no_grad():
        y = g1(x)
        psp, feats = g2(y, "S")
        _, seg_fp, (_, dep_fp) = rd(feats, psp)

    s1 = ptq.calibrate_model(g1, x)
    s2 = ptq.calibrate_model(g2, y, "S")
    s3 = ptq.calibrate_model(rd, feats, psp)
    y_q = ptq.int8_apply(g1, s1, x)
    psp_q, feats_q = ptq.int8_apply(g2, s2, y_q, "S")
    _, seg_q, (_, dep_q) = ptq.int8_apply(rd, s3, feats_q, psp_q)
    assert _cos(dep_q, dep_fp) > 0.98
    assert _cos(seg_q, seg_fp) > 0.98
    agree = (seg_q.argmax(1) == seg_fp.argmax(1)).double().mean()
    assert float(agree) > 0.9

    ja = lambda t: jnp.asarray(_nhwc(t))  # noqa: E731
    j1 = jptq.calibrate_model(lambda a: jg1.apply(v1, a), ja(x))
    j2 = jptq.calibrate_model(lambda a: jg2.apply(v2, a, "S"), ja(y))
    j3 = jptq.calibrate_model(lambda f, p: jrd.apply(v3, f, p),
                              [ja(f) for f in feats], ja(psp))
    # G_2's first site reads its input through a BatchNorm: not exact
    for got, want, exact in ((s1, j1, True), (s2, j2, False),
                             (s3, j3, True)):
        _sites_match(got, want, exact)
    # each net's sites, on the port's own int8 inputs of that net
    jy_q = _forced_sites_equal(g1, lambda a: jg1.apply(v1, a), j1, ja(x))
    jpsp_q, jfeats_q = _forced_sites_equal(
        g2, lambda a: jg2.apply(v2, a, "S"), j2, ja(y_q))
    _, jseg_q, (_, jdep_q) = _forced_sites_equal(
        rd, lambda f, p: jrd.apply(v3, f, p), j3,
        [ja(f) for f in feats_q], ja(psp_q))
    assert _cos(_nhwc(y_q), jy_q) >= 0.999
    assert _cos(_nhwc(dep_q), jdep_q) >= 0.999
    assert _cos(_nhwc(seg_q), jseg_q) >= 0.999


# ---------------------------------------------------------------------------
# conv2d_int8 at the nets' geometries
# ---------------------------------------------------------------------------


# (k, cin, cout, stride, padding, dilation, groups): RefineNet's PSP
# (3×3, d = 1, 3, 5, 7, p = d), S2D's psp_b2 (2×2, d 2, p 1) and psp_b3
# (3×3, d 2, p 2), a 1×1 at d 2, pair strides and paddings, groups
_GEOMETRIES = {
    "psp_d1": (3, 16, 8, 1, 1, 1, 1),
    "psp_d3": (3, 16, 8, 1, 3, 3, 1),
    "psp_d5": (3, 16, 8, 1, 5, 5, 1),
    "psp_d7": (3, 16, 8, 1, 7, 7, 1),
    "psp_b2_2x2_d2_p1": (2, 8, 8, 1, 1, 2, 1),
    "psp_b3_3x3_d2_p2": (3, 8, 8, 1, 2, 2, 1),
    "1x1_d2": (1, 16, 24, 1, 0, 2, 1),
    "pair_stride_padding": (3, 8, 16, (2, 1), (1, 2), 1, 1),
    "pair_dilation": (3, 8, 16, 1, (2, 1), (2, 1), 1),
    "groups_2": (3, 8, 16, 1, 1, 1, 2),
    "groups_4_stride_2": (3, 16, 8, 2, 1, 1, 4),
}


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@pytest.mark.parametrize("name", sorted(_GEOMETRIES))
def test_int8_conv_geometries_match_xla(name):
    k, cin, cout, stride, pad, dil, groups = _GEOMETRIES[name]
    rng = np.random.RandomState(len(name))
    x = rng.randint(-127, 128, (2, 20, 17, cin)).astype(np.int8)
    w = rng.randint(-127, 128, (k, k, cin // groups, cout)).astype(np.int8)
    ph, pw = _pair(pad)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), _pair(stride), ((ph, ph), (pw, pw)),
        rhs_dilation=_pair(dil), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for fn in (conv2d_int8, plain_conv2d_int8, im2col_conv2d_int8):
        got = fn(xt, wt, stride, pad, dil, groups)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn.__name__)


@pytest.mark.parametrize("k,stride,pad,out_pad", [
    (3, 2, 1, 1),   # the DecoderUpBlock and ResnetGenerator ups
    (4, 2, 1, 0),   # the U-Net ups
    (3, 1, 1, 0),
    (2, (2, 1), 0, 0)])
def test_int8_conv_transpose_matches_fp64(k, stride, pad, out_pad):
    rng = np.random.RandomState(k)
    x = torch.from_numpy(rng.randint(-127, 128, (2, 9, 7, 8)).astype(np.int8))
    weight = torch.from_numpy(
        rng.randint(-127, 128, (8, 12, k, k)).astype(np.float32))
    kernel = torch.from_numpy(hwio_from_conv_transpose_weight(weight)).to(
        torch.int8)
    want = F.conv_transpose2d(x.permute(0, 3, 1, 2).double(), weight.double(),
                              stride=stride, padding=pad,
                              output_padding=out_pad)
    got = conv_transpose2d_int8(x, kernel, stride, pad, out_pad)
    np.testing.assert_array_equal(got.permute(0, 3, 1, 2).numpy(),
                                  want.round().to(torch.int32).numpy())


def test_int8_transposed_site_matches_jax():
    """A ConvTranspose2d site (the opt-in) on JAX's input: bit-equal to
    JAX's ``_int8_conv_transpose`` with the same site."""
    from cycle_depth_estimation_tpu.ops import ConvTranspose as JConvT

    m = init_weights(nn.ConvTranspose2d(8, 6, 3, 2, 1, 1), "normal", 0.1,
                     torch.Generator().manual_seed(9))
    with torch.no_grad():
        m.bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(10))
    x = _img(9, 1, 5, 7, 8)
    jm = JConvT(6, 3, stride=2, padding=1, output_padding=1)
    vs = {"params": {"kernel": jnp.asarray(hwio_from_conv_transpose_weight(
        m.weight)), "bias": jnp.asarray(m.bias.detach().numpy())}}
    pred = lambda key, mod: True  # noqa: E731
    jsites = jptq.calibrate_model(lambda a: jm.apply(vs, a), jnp.asarray(x),
                                  predicate=pred)
    sites = ptq.calibrate_model(nn.Sequential(m), _nchw(x),
                                predicate=lambda k, mod: True)
    (jq,), (q,) = jsites.values(), sites.values()
    np.testing.assert_array_equal(q["kernel_q"].numpy(), jq["kernel_q"])
    assert float(q["act_scale"]) == float(jq["act_scale"])
    want = jptq.int8_apply(lambda a: jm.apply(vs, a), jsites, jnp.asarray(x))
    got = ptq.int8_apply(nn.Sequential(m), {"0": q}, _nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
