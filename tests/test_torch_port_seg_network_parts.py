"""The port's T2Net/SegCycle parts that no registered model builds, against
the JAX package's ``models/seg_network.py`` on the CPU: ``ResGenerator``
(instance norm with ReLU, BatchNorm with PReLU; eval and train),
``PreUNet16`` (ngf 64: the VGG16 widths are fixed; its JAX variables from
``jax_variables_from_net`` and from the JAX ``import_preunet16`` of the
port's state dict), ``DownBlock``, ``ShuffleUpBlock``, ``Discriminator``,
``MultiscaleDiscriminator`` (num_d 2, one PReLU α per scale) and
``FeatureDiscriminator`` (NCHW flatten order), with the shape contracts of
``tests/test_seg_models.py:78-104``, and the factories.

Weights are the port's (seeded convs, random biases, BatchNorm parameters
and statistics, PReLU αs); every output is within 1e-5 of the JAX
module's largest output magnitude (at least 1), and ``_state_dict_from_jax``
gives the port's state dict back exactly. A net with InstanceNorm is held
to 1e-4, the bar of the port's other InstanceNorm nets: both sides compute
the one-pass variance E[x²] − E[x]² in fp32 with their own summation
order, which puts the 4-block ResGenerator's output 1.4–1.9e-5 apart at
three seeds (its BatchNorm twin 2.5–3.4e-7).
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from flax import linen as fnn

from cycle_depth_estimation_tpu.models import seg_network as jsn
from cycle_depth_estimation_tpu.utils.torch_import import import_preunet16
from cycle_depth_estimation_tpu_torch.models import seg_network as psn
from cycle_depth_estimation_tpu_torch.ops.layers import PReLU
from cycle_depth_estimation_tpu_torch.utils.weights import (
    _state_dict_from_jax, jax_variables_from_net)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(seed, *shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _nchw(a):
    return torch.from_numpy(np.array(a.transpose(0, 3, 1, 2)))


def _signal(net, seed):
    """Xavier convs at gain 1, random biases, BatchNorm parameters and
    statistics, PReLU αs. (The factories' gain 0.02 leaves each conv's
    output about its bias: near-constant planes, where the one-pass
    InstanceNorm variance of both sides cancels to rounding.)"""
    gen = torch.Generator().manual_seed(seed)
    psn.init_weights(net, "xavier", 1.0, gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) \
                    and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
            if isinstance(m, nn.BatchNorm2d):
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -.3, .3),
                                  (m.running_mean, -.3, .3),
                                  (m.running_var, 0.5, 2.0)):
                    t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo)
                            + lo)
            if isinstance(m, PReLU):
                m.weight.copy_(torch.rand(1, generator=gen) * 0.5)
    return net


def _variables(net):
    params, stats = jax_variables_from_net(net)
    vs = {"params": params}
    if stats:
        vs["batch_stats"] = stats
    return jax.tree.map(jnp.asarray, vs)


def _close(got, want, what, rel=1e-5):
    """``got`` (NCHW tensor or (N, F)) against JAX's NHWC (or (N, F))."""
    want = np.asarray(want, np.float64)
    if want.ndim == 4:
        want = want.transpose(0, 3, 1, 2)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), (what, err)


def _round_trip(net, vs):
    sd = _state_dict_from_jax(net, jax.tree.map(np.asarray, vs["params"]),
                              jax.tree.map(np.asarray,
                                           vs.get("batch_stats", {})))
    want = {k: v for k, v in net.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)


def _run(jmodule, vs, x, train, *args):
    if not train:
        return jmodule.apply(vs, jnp.asarray(x), *args)
    out, _ = jmodule.apply(vs, jnp.asarray(x), *args, train=True,
                           mutable=["batch_stats"])
    return out


# ---------------------------------------------------------------------------
# ResGenerator (test_seg_models.py:78-85)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm,act,train", [("instance", "ReLU", False),
                                            ("batch", "PReLU", False),
                                            ("batch", "PReLU", True)])
def test_res_generator_matches_jax(norm, act, train):
    net = _signal(psn.define_task_G(3, 8, 4, norm, act, "ResNet",
                                    generator=torch.Generator().manual_seed(1)),
                  2)
    vs = _variables(net)
    x = _x(3, 1, 32, 32, 3)
    net.train(train)
    with torch.no_grad():
        feat, out = net(_nchw(x))
    jfeat, jout = _run(jsn.ResGenerator(output_nc=3, ngf=8, n_blocks=4,
                                        norm=norm, activation=act), vs, x,
                       train)
    assert tuple(feat.shape) == (1, 16, 8, 8)   # JAX (1, 8, 8, 16)
    assert tuple(out.shape) == (1, 3, 32, 32)
    rel = 1e-4 if norm == "instance" else 1e-5
    _close(feat, jfeat, "feature", rel)
    _close(out, jout, "output", rel)
    if not train:
        _round_trip(net, vs)


# ---------------------------------------------------------------------------
# PreUNet16 (tests/test_preunet.py)
# ---------------------------------------------------------------------------


def test_preunet16_matches_jax_through_both_weight_paths():
    net = _signal(psn.define_task_G(
        ngf=64, model_type="PreUNet16",
        generator=torch.Generator().manual_seed(4)), 5).eval()
    x = _x(6, 1, 96, 128, 3)
    with torch.no_grad():
        got = net(_nchw(x))
    assert [tuple(t.shape) for t in got] == [
        (1, 512, 6, 8), (1, 3, 12, 16), (1, 3, 24, 32), (1, 3, 48, 64),
        (1, 3, 96, 128)]
    jnet = jsn.PreUNet16(output_nc=3)
    vs = _variables(net)
    imported = jax.tree.map(jnp.asarray, import_preunet16(
        {k: v.numpy() for k, v in net.state_dict().items()}))
    for variables in (vs, imported):
        for g, w in zip(got, jnet.apply(variables, jnp.asarray(x))):
            _close(g, w, "PreUNet16")
    _round_trip(net, vs)


def test_preunet16_is_built_at_layers_4_only():
    with pytest.raises(NotImplementedError, match="layers=4"):
        psn.define_task_G(ngf=64, layers=5, model_type="PreUNet16")
    with pytest.raises(NotImplementedError, match="model type"):
        psn.define_task_G(model_type="VGG")


# ---------------------------------------------------------------------------
# DownBlock and ShuffleUpBlock
# ---------------------------------------------------------------------------


class _JBlock(fnn.Module):
    """A JAX block with the network-scope PReLU α its parent would own."""

    kind: str

    @fnn.compact
    def __call__(self, h):
        a = self.param("prelu_alpha", fnn.initializers.constant(0.25), (1,),
                       jnp.float32)
        block = (jsn.DownBlock(12, name="block") if self.kind == "down"
                 else jsn.ShuffleUpBlock(12, 2, name="block"))
        return block(h, act=lambda t: jsn.prelu_apply(a, t))


@pytest.mark.parametrize("kind", ["down", "shuffle_up"])
def test_down_and_shuffle_up_blocks_match_jax(kind):
    act = psn.make_activation("PReLU")
    if kind == "down":
        net, shape = psn.DownBlock(8, 12, "batch", act), (1, 12, 8, 10)
    else:
        net, shape = psn.ShuffleUpBlock(8, 2, 12, "batch", act), \
            (1, 12, 32, 40)
    _signal(net, 8).eval()
    params, stats = jax_variables_from_net(net)
    alpha = params.pop("prelu_alpha")
    vs = {"params": {"prelu_alpha": alpha, "block": params},
          "batch_stats": {"block": stats}}
    x = _x(9, 1, 16, 20, 8)
    with torch.no_grad():
        got = net(_nchw(x))
    want = _JBlock(kind).apply(jax.tree.map(jnp.asarray, vs), jnp.asarray(x))
    assert tuple(got.shape) == shape
    _close(got, want, kind)


# ---------------------------------------------------------------------------
# The discriminators (test_seg_models.py:88-104)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_discriminator_matches_jax(norm):
    net = _signal(psn.Discriminator(3, 8, 3, norm, "PReLU"), 10).eval()
    vs = _variables(net)
    x = _x(12, 1, 64, 64, 3)
    with torch.no_grad():
        got = net(_nchw(x))
    _close(got, jsn.Discriminator(ndf=8, norm=norm).apply(vs, jnp.asarray(x)),
           "Discriminator", 1e-4 if norm == "instance" else 1e-5)
    assert tuple(got.shape) == (1, 1, 6, 6)
    _round_trip(net, vs)


def test_multiscale_discriminator_matches_jax():
    net = psn.define_task_D(3, 8, 3, num_d=2, norm="instance",
                            generator=torch.Generator().manual_seed(13))
    _signal(net, 14).eval()
    vs = _variables(net)
    assert set(vs["params"]["scale0"]) >= {"prelu_alpha", "conv0"}
    assert float(vs["params"]["scale0"]["prelu_alpha"][0]) != float(
        vs["params"]["scale1"]["prelu_alpha"][0])
    x = _x(15, 1, 64, 64, 3)
    with torch.no_grad():
        got = net(_nchw(x))
    want = jsn.MultiscaleDiscriminator(ndf=8, num_d=2, norm="instance").apply(
        vs, jnp.asarray(x))
    assert len(got) == 2 and got[0].shape[2] > got[1].shape[2]
    for g, w in zip(got, want):
        _close(g, w, "MultiscaleDiscriminator", 1e-4)  # instance norm
    _round_trip(net, vs)


def test_feature_discriminator_flattens_in_nchw_order():
    net = _signal(psn.define_feature_D(
        16, feature_hw=(4, 4), generator=torch.Generator().manual_seed(16)),
        17)
    vs = _variables(net)
    assert vs["params"]["fc0"]["kernel"].shape == (16 * 4 * 4, 16)
    x = _x(18, 2, 4, 4, 16)
    (got,) = net(_nchw(x))
    (want,) = jsn.FeatureDiscriminator(input_nc=16, feature_hw=(4, 4)).apply(
        vs, jnp.asarray(x))
    assert tuple(got.shape) == (2, 1)
    _close(got, want, "FeatureDiscriminator")
    # the flatten order matters: NHWC-flattened features give another logit
    (other,) = net(torch.from_numpy(x).reshape(2, 16, 4, 4))
    assert not torch.allclose(other, got)
    _round_trip(net, vs)
