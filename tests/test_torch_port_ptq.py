"""The port's generic PTQ (``models/ptq.py``) against the JAX package's, on
the CPU: the UNet, ResnetGenerator and mechanism cases of
``tests/test_ptq.py``. The JAX variables are the port net's, through
``jax_variables_from_net``; both sides calibrate on the same numpy inputs.

Held: the site keys (the JAX module paths) equal as sets and in order;
``kernel_q`` and ``scale`` exactly equal; the first site's ``act_scale``
and int32 accumulator exactly equal (the same input, the same arithmetic
order); every other ``act_scale`` within 1e-5 relative (fp32 rounding
upstream); every site's int8 conv, fed JAX's input and site, bit-equal to
JAX's (quantize, int8 conv, dequantize, bias); the int8 output at JAX's
thresholds against fp32 and at cosine ≥ 0.999 with JAX's int8 output; the
transposed-conv opt-in, the widened scale of a shared module, the predicate
filter, and a perturbed ``kernel_q`` passed in as an argument moving the
output.

End to end the two int8 outputs drift apart: one value that fp32 rounding
upstream (an InstanceNorm, a BatchNorm) puts on the other side of a
rounding boundary flips one int8 LSB, and every later site re-rounds the
difference. On the 2-block ResnetGenerator at ``init_weights``' seed 0 one
such flip at ``down0_conv`` takes the output to cosine 0.99980 with JAX's
(the same with the port's sites given to JAX); at seeds 1–5 it is ≥
0.9999998. Hence the per-site check is the strict one and the end-to-end
bar is 0.999.
"""

from unittest import mock

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from flax import linen as fnn

from cycle_depth_estimation_tpu.models import networks as jnet
from cycle_depth_estimation_tpu.models import ptq as jptq
from cycle_depth_estimation_tpu.ops import Conv as JConv
from cycle_depth_estimation_tpu.ops import ConvTranspose as JConvTranspose
from cycle_depth_estimation_tpu_torch.models import ptq
from cycle_depth_estimation_tpu_torch.models.networks import (
    ResnetGenerator, UnetGenerator)
from cycle_depth_estimation_tpu_torch.ops.init import init_weights
from cycle_depth_estimation_tpu_torch.utils.weights import (
    jax_variables_from_net)


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _img(seed, n, h, w, c=3):
    """NHWC float32 in [-1, 1], the JAX tests' ``_img``."""
    return (np.random.RandomState(seed).rand(n, h, w, c) * 2 - 1).astype(
        np.float32)


def _nchw(a):
    return torch.from_numpy(np.array(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _seeded(net, seed):
    """Conv weights N(0, 0.02²)·gain from ``seed``, nonzero biases and
    BatchNorm statistics, so every site carries signal."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(net, "xavier", 1.0, gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and \
                    m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
            if isinstance(m, nn.BatchNorm2d):
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -.3, .3),
                                  (m.running_mean, -.3, .3),
                                  (m.running_var, 0.5, 2.0)):
                    t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo)
                            + lo)
    return net.eval()


def _jax_vars(net):
    params, stats = jax_variables_from_net(net)
    vs = {"params": params}
    if stats:
        vs["batch_stats"] = stats
    return jax.tree.map(jnp.asarray, vs)


def _jax_int8(jmodel, vs, x, **kw):
    """JAX sites and the eager int8 output, with the int32 accumulator of
    every conv site recorded in call order."""
    sites, serve = jptq.quantize_for_serving(jmodel, vs, (jnp.asarray(x),),
                                             **kw)
    accs, real = [], jptq.lax.conv_general_dilated

    def recording(*a, **k):
        y = real(*a, **k)
        if k.get("preferred_element_type") == jnp.int32:
            accs.append(np.asarray(y))
        return y

    with mock.patch.object(jptq.lax, "conv_general_dilated", recording):
        y = serve(vs, sites, jnp.asarray(x))
    return sites, np.asarray(y), accs


def _port_int8(net, x, **kw):
    """The port's sites and int8 output, with every site's int32
    accumulator recorded in call order."""
    sites, serve = ptq.quantize_for_serving(net, (_nchw(x),), **kw)
    accs, real = [], ptq.conv2d_int8

    def recording(*a, **k):
        y = real(*a, **k)
        accs.append(y.numpy())
        return y

    with mock.patch.object(ptq, "conv2d_int8", recording):
        y = serve(sites, _nchw(x))
    return sites, _nhwc(y), accs


def _assert_forced_sites_equal(net, jmodel, vs, jsites, x):
    """Every site of the JAX int8 forward, given to the port's int8 conv
    with the same float input and site: outputs bit-equal."""
    seen, real = [], {"c": jptq._int8_conv, "t": jptq._int8_conv_transpose}

    def recording(kind):
        def run(m, a, q):
            y = real[kind](m, a, q)
            seen.append(("/".join(m.path), np.asarray(a), np.asarray(y)))
            return y
        return run

    with mock.patch.object(jptq, "_int8_conv", recording("c")), \
            mock.patch.object(jptq, "_int8_conv_transpose", recording("t")):
        jptq.int8_apply(lambda a: jmodel.apply(vs, a), jsites,
                        jnp.asarray(x))
    modules = {k: m for m, k in ptq.conv_sites(net).items()}
    assert [k for k, _, _ in seen] == list(jsites)
    for key, a, y in seen:
        q = {k: torch.from_numpy(np.array(v)) for k, v in jsites[key].items()}
        m = modules[key]
        conv = (ptq._int8_conv_transpose
                if isinstance(m, nn.ConvTranspose2d) else ptq._int8_conv)
        np.testing.assert_array_equal(_nhwc(conv(m, _nchw(a), q)), y,
                                      err_msg=key)


def _assert_sites_match(got, want):
    assert list(got) == list(want)
    first = next(iter(want))
    for key, w in want.items():
        g = got[key]
        assert set(g) == set(w), key
        np.testing.assert_array_equal(g["kernel_q"].numpy(),
                                      np.asarray(w["kernel_q"]), err_msg=key)
        np.testing.assert_array_equal(g["scale"].numpy(),
                                      np.asarray(w["scale"]), err_msg=key)
        if "bias" in w:
            np.testing.assert_array_equal(g["bias"].numpy(),
                                          np.asarray(w["bias"]), err_msg=key)
        ga, wa = float(g["act_scale"]), float(w["act_scale"])
        if key == first:
            assert ga == wa, (key, ga, wa)
        else:
            assert abs(ga - wa) <= 1e-5 * wa, (key, ga, wa)


def _unet(num_downs, ngf, seed=0):
    """The port's U-Net and the JAX one (the port, as the reference, has
    at least five levels: ``num_downs`` ≥ 5)."""
    net = _seeded(UnetGenerator(3, 3, num_downs, ngf, norm="batch"), seed)
    jg = jnet.UnetGenerator(output_nc=3, num_downs=num_downs, ngf=ngf,
                            norm="batch")
    return net, jg


# ---------------------------------------------------------------------------
# U-Net and ResnetGenerator (test_ptq.py:40-83)
# ---------------------------------------------------------------------------


def test_unet_int8_matches_jax_and_tracks_fp32():
    net, jg = _unet(5, 8)
    x = _img(0, 2, 32, 32)
    vs = _jax_vars(net)
    want_sites, want_y, want_acc = _jax_int8(jg, vs, x)
    sites, y, acc = _port_int8(net, x)
    assert len(sites) == 5 and all("down" in k for k in sites)
    _assert_sites_match(sites, want_sites)
    np.testing.assert_array_equal(acc[0], want_acc[0])
    _assert_forced_sites_equal(net, jg, vs, want_sites, x)
    with torch.no_grad():
        y_fp = _nhwc(net(_nchw(x)))
    np.testing.assert_allclose(y_fp, np.asarray(jg.apply(vs, jnp.asarray(x))),
                               atol=1e-5)
    assert _cos(y, want_y) >= 0.999
    assert _cos(y, y_fp) > 0.99


def test_unet_int8_transpose_opt_in():
    net, jg = _unet(5, 8)
    x = _img(1, 1, 32, 32)
    vs = _jax_vars(net)
    jpred = lambda key, m: isinstance(m, (JConv, JConvTranspose))  # noqa: E731
    pred = lambda key, m: isinstance(m, ptq.CONVS)  # noqa: E731
    want_sites, want_y, _ = _jax_int8(jg, vs, x, predicate=jpred)
    sites, serve = ptq.quantize_for_serving(net, (_nchw(x),), predicate=pred)
    assert len(sites) == 10  # 5 downs + 5 ups
    _assert_sites_match(sites, want_sites)
    _assert_forced_sites_equal(net, jg, vs, want_sites, x)
    y = _nhwc(serve(sites, _nchw(x)))
    with torch.no_grad():
        y_fp = _nhwc(net(_nchw(x)))
    assert _cos(y, want_y) >= 0.999
    assert _cos(y, y_fp) > 0.99


def test_resnet_generator_generic_int8_matches_jax_and_tracks_fp32():
    """At ``init_weights``' default seed. The cosine against fp32 is a
    property of the weights on both sides alike: JAX's own int8 output
    reaches 0.99933 here and 0.99862 at seed 2 (the bar is the JAX test's,
    for its flax draw); the port's agreement with JAX's is the parity
    check."""
    net = init_weights(ResnetGenerator(3, 3, 8, 2)).eval()
    jg = jnet.ResnetGenerator(output_nc=3, ngf=8, n_blocks=2)
    x = _img(2, 1, 32, 32)
    vs = _jax_vars(net)
    want_sites, want_y, want_acc = _jax_int8(jg, vs, x)
    sites, y, acc = _port_int8(net, x)
    # conv_in + 2 downs + 2 blocks×2 + conv_out; the ups are ConvTranspose
    assert len(sites) == 8
    assert list(sites)[:4] == ["conv_in", "down0_conv", "down1_conv",
                               "block0/conv1"]
    _assert_sites_match(sites, want_sites)
    np.testing.assert_array_equal(acc[0], want_acc[0])
    _assert_forced_sites_equal(net, jg, vs, want_sites, x)
    with torch.no_grad():
        y_fp = _nhwc(net(_nchw(x)))
    assert _cos(y, want_y) >= 0.999
    assert _cos(y, y_fp) > 0.999


# ---------------------------------------------------------------------------
# Mechanism contracts (test_ptq.py:153-200)
# ---------------------------------------------------------------------------


class _Body(nn.Module):
    """One conv applied twice, at two input magnitudes."""

    def __init__(self):
        super().__init__()
        self.c = nn.Conv2d(3, 4, 3, padding=1)

    def forward(self, x):
        return self.c(x) + self.c(10.0 * x)


class _JBody(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        c = JConv(4, 3, padding=1, name="c")
        return c(x) + c(10.0 * x)


def test_shared_module_widens_scale():
    net = _seeded(_Body(), 5)
    x = _img(5, 1, 8, 8, 3)
    sites = ptq.calibrate_model(net, _nchw(x))
    assert list(sites) == ["c"]
    amax_one = float(np.abs(x).max())
    assert float(sites["c"]["act_scale"]) >= 10.0 * amax_one / 127.0 * 0.999
    vs = {"params": {"c": {
        "kernel": jnp.asarray(net.c.weight.detach().numpy().transpose(
            2, 3, 1, 0)),
        "bias": jnp.asarray(net.c.bias.detach().numpy())}}}
    want = jptq.calibrate_model(lambda a: _JBody().apply(vs, a),
                                jnp.asarray(x))
    _assert_sites_match(sites, want)


def test_predicate_filters_sites():
    net, jg = _unet(5, 4, seed=6)
    x = _img(6, 1, 32, 32)
    pred = lambda key, m: ptq.default_predicate(key, m) and \
        "down0" not in key  # noqa: E731
    jpred = lambda key, m: jptq.default_predicate(key, m) and \
        "down0" not in key  # noqa: E731
    sites, serve = ptq.quantize_for_serving(net, (_nchw(x),), predicate=pred)
    want = jptq.calibrate_model(lambda a: jg.apply(_jax_vars(net), a),
                                jnp.asarray(x), predicate=jpred)
    assert list(sites) == list(want) == [f"down{i}_conv" for i in
                                         range(1, 5)]
    assert serve(sites, _nchw(x)).shape == (1, 3, 32, 32)


def test_sites_are_arguments_and_the_net_is_left_as_it_was():
    """Serving reads the sites it is given: a perturbed ``kernel_q`` moves
    the output. Calibrating and serving leave the net's forwards, its
    training mode and its BatchNorm statistics as they were."""
    net, _ = _unet(5, 4, seed=7)
    net.train()
    stats = {k: v.clone() for k, v in net.state_dict().items()}
    x = _nchw(_img(7, 1, 32, 32))
    sites, serve = ptq.quantize_for_serving(net, (x,))
    y1 = serve(sites, x)
    k = next(iter(sites))
    sites2 = dict(sites)
    sites2[k] = dict(sites[k], kernel_q=torch.clamp(
        sites[k]["kernel_q"].int() + 3, -127, 127).to(torch.int8))
    y2 = serve(sites2, x)
    assert not torch.allclose(y1, y2)
    assert net.training
    assert all("forward" not in m.__dict__ for m in net.modules())
    for name, v in net.state_dict().items():
        assert torch.equal(v, stats[name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_output_dtype_is_the_conv_compute_dtype_else_the_input(dtype):
    """JAX ``m.dtype or x.dtype``: a conv with ``compute_dtype`` returns
    it; a plain conv returns its input's dtype."""
    from cycle_depth_estimation_tpu_torch.ops.layers import (
        Conv2d, set_compute_dtype)

    plain = _seeded(nn.Sequential(nn.Conv2d(3, 8, 3, padding=1)), 8)
    x = _nchw(_img(8, 1, 8, 8)).to(dtype)
    sites = ptq.calibrate_model(plain.to(dtype), x)
    assert ptq.int8_apply(plain, sites, x).dtype == dtype
    typed = set_compute_dtype(_seeded(nn.Sequential(Conv2d(3, 8, 3)), 8),
                              torch.bfloat16)
    x32 = _nchw(_img(8, 1, 8, 8))
    sites = ptq.calibrate_model(typed, x32)
    assert ptq.int8_apply(typed, sites, x32).dtype == torch.bfloat16
