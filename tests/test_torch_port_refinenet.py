"""The port's RefineNet-LW nets and layer primitives against the JAX package,
on the CPU: ``max_pool``, ``resize_nearest``, ``pixel_shuffle`` and
``replicate_pad``; every block of ``models/refinenet.py`` (``ConvBnRelu6``,
``Bottleneck``, ``InsAdapter``, ``PSPBlock``, ``ATBlock``, ``CRPBlock``,
``DepthBlockR6``, ``Segd``, ``DCGANDiscriminator``) at narrow widths with
flax-initialised weights (BatchNorm parameters and statistics randomised)
carried into the port by the weight converter, in train mode (outputs and
updated statistics) and eval mode; ``DeconvBlock``,
``bce_dep_loss_truncated`` and ``seg_gan_loss``; and ResNetLW (1, 1, 1, 1)
at 64×96 in both domains, train and eval, with the port's weights carried
to JAX by ``import_resnetlw`` (the heads by ``import_segd``) and back by
``rf_lw_state_dicts_from_jax``, exactly.

The InstanceNorm of the adapters takes its plain version here (CPU
tensors). Limits (fp32): outputs within 1e-4 of their largest magnitude;
running statistics within 1e-5 relative plus 1e-5 absolute (a running mean
behind an adapter is ~1e-7, rounding alone); losses within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cycle_depth_estimation_tpu.models import refinenet as jrf
from cycle_depth_estimation_tpu.models import s2d_networks as jsn
from cycle_depth_estimation_tpu.ops import layers as jl
from cycle_depth_estimation_tpu.utils import torch_import as ti
from cycle_depth_estimation_tpu_torch.config import Config
from cycle_depth_estimation_tpu_torch.models import refinenet as prf
from cycle_depth_estimation_tpu_torch.models import s2d_networks as psn
from cycle_depth_estimation_tpu_torch.ops import layers as pl
from cycle_depth_estimation_tpu_torch.ops.init import init_weights
from cycle_depth_estimation_tpu_torch.utils.weights import (
    _state_dict_from_jax, rf_lw_state_dicts_from_jax)

LAYERS = (1, 1, 1, 1)
H, W = 64, 96
RNG = np.random.RandomState(31)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this file runs (six test
    processes share the machine's cores in the Tier-1 run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _close(got, want, what, rel=1e-4):
    """``got`` (NCHW tensor) against ``want`` (NHWC array)."""
    want = np.asarray(want, np.float64).transpose(0, 3, 1, 2)
    err = np.abs(got.detach().double().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _randomise_norms(tree, rng):
    """BatchNorm scale/bias and mean/var leaves of a flax tree, randomised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise_norms(v, rng)
            continue
        v = np.asarray(v)
        if k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k in ("bias", "mean") and v.ndim == 1:
            v = rng.normal(0, 0.2, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _flax_pair(jmod, port, *inputs, rng_seed=0, **apply_kw):
    """Flax-initialise ``jmod`` on ``inputs`` (NHWC), randomise its norms,
    load the variables into ``port`` by the converter; returns the
    variables as numpy trees."""
    v = jmod.init(jax.random.key(rng_seed), *inputs, **apply_kw)
    rng = np.random.RandomState(rng_seed + 1)
    params = _randomise_norms(jax.tree.map(np.asarray, v["params"]), rng)
    stats = _randomise_norms(jax.tree.map(np.asarray,
                                          v.get("batch_stats", {})), rng)
    sd = _state_dict_from_jax(port, params, stats)
    missing, unexpected = port.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return params, stats


def _apply(jmod, params, stats, *inputs, train):
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    if train and stats:
        y, mut = jmod.apply(variables, *inputs, train=True,
                            mutable=["batch_stats"])
        return y, jax.tree.map(np.asarray, mut["batch_stats"])
    return jmod.apply(variables, *inputs, train=train), stats


def _assert_stats(port, params, stats, what):
    want = _state_dict_from_jax(port, params, stats)
    for k, t in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{what} {k}")


def _x(*shape, scale=1.0):
    return (RNG.randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# layer primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,stride,pad", [(3, 2, 1), (3, 1, 1), (2, 2, 0)])
def test_max_pool_matches_jax(window, stride, pad):
    x = _x(2, 7, 9, 3) - 2.0  # negative everywhere near the border too
    want = jl.max_pool(jnp.asarray(x), window, stride, padding=pad)
    got = pl.max_pool(_nchw(x), window, stride, padding=pad)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))


@pytest.mark.parametrize("src,dst", [((6, 18), (12, 36)), ((5, 7), (12, 9)),
                                     ((10, 13), (4, 5)), ((3, 4), (3, 4))])
def test_resize_nearest_matches_jax(src, dst):
    x = _x(2, *src, 3)
    want = jl.resize_nearest(jnp.asarray(x), dst)
    got = pl.resize_nearest(_nchw(x), dst)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))


def test_pixel_shuffle_matches_jax():
    x = _x(2, 5, 6, 12)
    want = jl.pixel_shuffle(jnp.asarray(x), 2)
    got = pl.pixel_shuffle(_nchw(x), 2)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))


@pytest.mark.parametrize("pad", [2, (1, 3), ((0, 2), (3, 1))])
def test_replicate_pad_matches_jax(pad):
    x = _x(2, 5, 6, 3)
    want = jl.replicate_pad(jnp.asarray(x), pad)
    got = pl.replicate_pad(_nchw(x), pad)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _blocks():
    """(name, JAX module, port module, NHWC inputs, has BatchNorm)."""
    x32 = _x(2, 8, 12, 32)
    return [
        ("ConvBnRelu6", jrf.ConvBnRelu6(24, 3), prf.ConvBnRelu6(32, 24, 3),
         (x32,), True),
        ("Bottleneck", jrf.Bottleneck(8, 2, True), prf.Bottleneck(32, 8, 2, True),
         (x32,), True),
        ("PSPBlock", jrf.PSPBlock(32), prf.PSPBlock(32, 32), (x32,), True),
        ("ATBlock", jrf.ATBlock(24), prf.ATBlock(32, 24),
         (x32, _x(2, 8, 12, 32)), True),
        ("DepthBlockR6", jrf.DepthBlockR6(32), prf.DepthBlockR6(32),
         (x32,), True),
        ("Segd", jrf.Segd(28, 2), prf.Segd(32, 28, 2), (x32,), False),
        ("DeconvBlock_bn", jsn.DeconvBlock(16, batch_norm=True),
         psn.DeconvBlock(32, 16, batch_norm=True), (x32,), True),
    ]


@pytest.mark.parametrize("index", range(7))
def test_block_matches_jax_in_train_and_eval(index):
    name, jmod, port, inputs, has_bn = _blocks()[index]
    jin = [jnp.asarray(a) for a in inputs]
    params, stats = _flax_pair(jmod, port, *jin, train=False)
    pin = [_nchw(a) for a in inputs]
    for train in (False, True):
        port.train(train)
        with torch.no_grad():
            got = port(*pin)
        want, new_stats = _apply(jmod, params, stats, *jin, train=train)
        if name == "DepthBlockR6":
            for i, (g, w) in enumerate(zip(got[0], want[0])):
                _close(g, w, f"{name} band {i} train={train}")
            _close(got[1], want[1], f"{name} fused train={train}")
        else:
            _close(got, want, f"{name} train={train}")
        if train and has_bn:
            _assert_stats(port, params, new_stats, name)


def test_ins_adapter_and_crp_match_jax():
    x = _x(2, 6, 9, 32, scale=3.0) + 1.0
    for jmod, port, args in (
            (jrf.InsAdapter(32), prf.InsAdapter(32), ()),
            (jrf.CRPBlock(32, n_stages=3), prf.CRPBlock(32, 32, 3), ())):
        params, _ = _flax_pair(jmod, port, jnp.asarray(x), *args)
        with torch.no_grad():
            got = port(_nchw(x))
        _close(got, jmod.apply({"params": params}, jnp.asarray(x)),
               type(port).__name__)


def test_dcgan_discriminator_matches_jax():
    x = _x(2, 32, 32, 2)
    jmod = jrf.DCGANDiscriminator(d_h_size=8, n_middle=2)
    port = prf.DCGANDiscriminator(2, d_h_size=8, n_middle=2)
    params, _ = _flax_pair(jmod, port, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("real", [True, False])
def test_seg_gan_loss_matches_jax(real):
    logits = _x(2, 6, 8, 29, scale=2.0)
    labels = RNG.randint(0, 28, (2, 6, 8))
    labels[0, :2] = 255
    want = float(jrf.seg_gan_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  real, 28))
    got = float(prf.seg_gan_loss(_nchw(logits), torch.from_numpy(labels),
                                 real, 28))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # 'fake' is class 28 of the 29 logits: the port's CE masks labels
    # outside [0, C), so a class past the logits would give 0 here
    if not real:
        one_hot = torch.zeros(1, 29, 3, 3)
        one_hot[:, 28] = 50.0
        assert float(prf.seg_gan_loss(one_hot, torch.zeros(1, 3, 3, dtype=torch.long),
                                      False)) < 1e-3
        assert got > 0.5


def test_bce_dep_loss_truncated_matches_jax():
    pred = np.tanh(_x(2, 5, 6, 1, scale=2.0))
    pred[0, 0, 0] = 1.0  # a saturated site
    target = np.sign(_x(2, 5, 6, 4))
    om = (target == 1).astype(np.float32)
    zm = (target == -1).astype(np.float32)

    def jax_fn(p):
        return jsn.bce_dep_loss_truncated(p, jnp.asarray(target),
                                          jnp.asarray(om), jnp.asarray(zm))

    want, want_g = jax.value_and_grad(jax_fn)(jnp.asarray(pred))
    p = _nchw(pred).requires_grad_(True)
    got = psn.bce_dep_loss_truncated(p, _nchw(target), _nchw(om), _nchw(zm))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want_g), rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# ResNetLW (1, 1, 1, 1) and the heads through the importers
# ---------------------------------------------------------------------------


def _cfg(**kw):
    return Config(model="rf_lw", device="cpu", resnet_layers=list(LAYERS), **kw)


@pytest.fixture(scope="module")
def lw():
    """The port's nets (rf_lw, ResNetLW (1, 1, 1, 1)) from a seeded init
    with random BatchNorm parameters and statistics, and the JAX variables
    the importers make of their state dicts."""
    nets = prf.define_rf_lw_nets(_cfg(), torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    for m in nets["G"].modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            with torch.no_grad():
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0, 0.2, generator=gen)
                m.running_mean.normal_(0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    sds = {k: {n: v.detach().numpy().copy()
               for n, v in net.state_dict().items()}
           for k, net in nets.items()}
    variables = {"G": ti.import_resnetlw(sds["G"], layers=LAYERS)}
    for name, (_, _, up) in prf.HEADS.items():
        variables[name] = ti.import_segd(sds[name], up)
    return nets, sds, variables


def test_rf_lw_state_dicts_round_trip_exactly(lw):
    """Port state dict → JAX importers → ``rf_lw_state_dicts_from_jax`` →
    the same state dict, every key (BatchNorm batch counts aside: flax
    keeps none)."""
    nets, sds, variables = lw
    back = rf_lw_state_dicts_from_jax(variables, _cfg())
    for k, sd in sds.items():
        want = {n: v for n, v in sd.items()
                if not n.endswith("num_batches_tracked")}
        assert set(back[k]) == set(want), k
        for n, v in want.items():
            np.testing.assert_array_equal(back[k][n].numpy(), v, err_msg=n)
    assert any(n.startswith("ins_layer4_s.0") for n in back["G"])


@pytest.mark.parametrize("domain", ["real", "syn"])
@pytest.mark.parametrize("train", [False, True])
def test_resnetlw_matches_jax(lw, domain, train):
    nets, _, variables = lw
    net = prf.ResNetLW(LAYERS)
    net.load_state_dict(nets["G"].state_dict())
    net.train(train)
    x = _x(1, H, W, 3)
    with torch.no_grad():
        outs, pred, feats = net(_nchw(x), domain)
    v = jax.tree.map(jnp.asarray, variables["G"])
    (jouts, jpred, jfeats), new_stats = _apply(
        jrf.ResNetLW(layers=LAYERS), v["params"], v["batch_stats"],
        jnp.asarray(x), domain, train=train)
    assert pred.shape == (1, 1, H // 2, W // 2)
    assert [tuple(f.shape) for f in feats] == [
        (1, 512, H // 16, W // 16), (1, 256, H // 8, W // 8),
        (1, 256, H // 4, W // 4), (1, 256, H // 4, W // 4)]
    _close(pred, jpred, f"pred {domain} train={train}")
    for i, (g, w) in enumerate(zip(outs, jouts)):
        _close(g, w, f"band {i} {domain} train={train}")
    for i, (g, w) in enumerate(zip(feats, jfeats)):
        _close(g, w, f"feature {i} {domain} train={train}")
    if train:
        _assert_stats(net, jax.tree.map(np.asarray, v["params"]), new_stats,
                      f"ResNetLW {domain}")
        assert all(int(m.num_batches_tracked) == 1 for m in net.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))


def test_segd_heads_match_jax(lw):
    nets, _, variables = lw
    for name, (_, c, up) in prf.HEADS.items():
        x = _x(1, 3, 4, c)
        with torch.no_grad():
            got = nets[name](_nchw(x))
        want = jrf.Segd(n_cls=28, up_scale=up).apply(
            jax.tree.map(jnp.asarray, variables[name]), jnp.asarray(x))
        assert got.shape == (1, 29, 3 * 2 ** up, 4 * 2 ** up), name
        _close(got, want, name)


def test_segd_loads_a_reference_state_dict_with_unused_bn():
    """A reference segd ``.pth`` holds ``Up.{i}.bn`` entries its forward
    never uses (the reference DeconvBlock always builds its BatchNorm)."""
    head = prf.Segd(16, 28, 1)
    init_weights(head, "normal", 0.02, torch.Generator().manual_seed(1))
    sd = {"module." + k: v for k, v in head.state_dict().items()}
    sd.update({f"module.Up.0.bn.{k}": v
               for k, v in torch.nn.BatchNorm2d(8).state_dict().items()})
    other = prf.Segd(16, 28, 1)
    other.load_state_dict(sd)
    for k, v in head.state_dict().items():
        assert torch.equal(other.state_dict()[k], v)
