"""The port's S2D nets and their pieces against the JAX package, on the CPU:
``G1``, ``GeneralNet`` in both modes, ``RDep`` and ``SDiscriminator`` in train
mode (outputs and the updated BatchNorm statistics) and eval mode, at the
smallest widths (DenseNet growth 8, blocks (2, 2, 2, 2), ``mid_nc`` 64,
``g1_blocks`` 1) on 64×64 planes (the discriminator alone at 32×32);
``bce_dep_loss`` and its gradient against JAX's ``_bce`` custom VJP, at
predictions of exactly 0 and 1 too; ``get_masks``; ``avg_pool`` and
``resize_bilinear`` against both JAX forms of the resize; the weight
converter's round trip through the JAX importers; a reference ``.pth``.

Weights go from the port to JAX through the JAX importers (``import_g1``,
``import_general_net``, ``import_rdep``, ``import_sdiscriminator``). The
JAX nets run through ``jax.jit``. Limits (fp32): outputs within 1e-4 of
their largest magnitude plus 1e-5; statistics within 1e-4 relative plus
1e-5.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from cycle_depth_estimation_tpu.models import s2d_networks as jsn
from cycle_depth_estimation_tpu.ops import layers as jl
from cycle_depth_estimation_tpu.utils import torch_import as ti
from cycle_depth_estimation_tpu_torch.config import Config
from cycle_depth_estimation_tpu_torch.models import s2d_networks as psn
from cycle_depth_estimation_tpu_torch.ops import layers as pl
from cycle_depth_estimation_tpu_torch.ops.init import init_weights
from cycle_depth_estimation_tpu_torch.ops.layers import PReLU
from cycle_depth_estimation_tpu_torch.utils.weights import (
    s2d_state_dicts_from_jax,
)

CFG = Config(model="S2D", device="cpu", g1_blocks=1,
             dense_block_config=[2, 2, 2, 2], dense_growth_rate=8,
             s2d_mid_nc=64)
MID = 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this file runs (six test
    processes share the machine's cores in the Tier-1 run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """The six nets with random weights, BatchNorm parameters and
    statistics, and PReLU αs, so that every path carries signal."""
    out = psn.s2d_nets(CFG)
    gen = torch.Generator().manual_seed(3)
    for net in out.values():
        init_weights(net, "xavier", 1.0, gen)
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, nn.Conv2d | nn.ConvTranspose2d) and \
                        m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * .1)
                if isinstance(m, nn.BatchNorm2d):
                    for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -.3, .3),
                                      (m.running_mean, -.5, .5),
                                      (m.running_var, 0.5, 2.0)):
                        t.copy_(torch.rand(t.shape, generator=gen)
                                * (hi - lo) + lo)
                if isinstance(m, PReLU):
                    m.weight.copy_(torch.rand(1, generator=gen) * 0.5)
    return out


def _sd(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def _import(name, sd):
    if name == "G_1":
        return ti.import_g1(sd, n_blocks=CFG.g1_blocks)
    if name == "G_2":
        return ti.import_general_net(
            sd, block_config=tuple(CFG.dense_block_config))
    if name == "R_D":
        return ti.import_rdep(sd)
    return ti.import_sdiscriminator(sd)


JAX_NETS = {
    "G_1": lambda: jsn.G1(n_blocks=CFG.g1_blocks),
    "G_2": lambda: jsn.GeneralNet(mid_nc=MID,
                                  growth_rate=CFG.dense_growth_rate,
                                  block_config=tuple(CFG.dense_block_config)),
    "R_D": lambda: jsn.RDep(base_c=MID),
    "FD1": lambda: jsn.SDiscriminator(),
}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in _flat(o)]
    return [out]


def _inputs(name, nets):
    """Seeded NHWC inputs of each net at 64×64 (the discriminator 32×32)
    and the positional non-tensor arguments."""
    rng = np.random.RandomState(5)
    if name == "G_1":
        return [rng.randn(2, 64, 64, 3)], ()
    if name in ("G_2 S", "G_2 R"):
        x = rng.randn(2, 32, 32, 64) if name == "G_2 S" else \
            rng.randn(2, 64, 64, 3)
        return [x], (name[-1],)
    if name == "R_D":
        fc = nets["G_2"].feature_channels
        feats = [rng.randn(2, 32 >> i, 32 >> i, c) for i, c in enumerate(fc)]
        return [feats, rng.randn(2, 4, 4, MID)], ()
    return [rng.randn(2, 32, 32, MID // 2)], ()


def _assert_out_close(got, want, what):
    want = np.asarray(want)
    err = np.abs(_nhwc(got) - want).max()
    assert err <= 1e-4 * np.abs(want).max() + 1e-5, (what, err)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["G_1", "G_2 S", "G_2 R", "R_D", "FD1"])
def test_net_matches_jax(nets, name, train):
    key = name.split()[0]
    net = nets[key]
    sd0 = _sd(net)
    variables = _import(key, sd0)
    arrays, static = _inputs(name, nets)
    arrays = [[a.astype(np.float32) for a in x] if isinstance(x, list)
              else x.astype(np.float32) for x in arrays]
    module = JAX_NETS[key]()

    def apply(v, *xs):
        return module.apply(v, *xs, *static, train=train,
                            **({"mutable": ["batch_stats"]} if train else {}))

    want = jax.jit(apply)(variables, *jax.tree.map(jnp.asarray, arrays))
    want, stats = want if train else (want, None)
    net.train(train)
    got = net(*[[_nchw(a) for a in x] if isinstance(x, list) else _nchw(x)
                for x in arrays], *static)
    got_l, want_l = _flat(got), _flat(want)
    assert len(got_l) == len(want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        _assert_out_close(g, w, f"{name} output {i}")
    if train:
        moved = _import(key, _sd(net))["batch_stats"]
        for a, b in zip(jax.tree.leaves(moved),
                        jax.tree.leaves(stats["batch_stats"])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd0.items()})


def test_g2_skip_features_carry_no_gradient(nets):
    net = nets["G_2"].train()
    sd0 = _sd(net)
    psp, feats = net(torch.randn(1, 3, 64, 64), "R")
    assert psp.requires_grad
    assert all(not f.requires_grad and f.grad_fn is None for f in feats)
    assert [f.shape[1] for f in feats] == list(net.feature_channels)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd0.items()})


def _depth_case(seed=9, ties=False):
    """A 1-channel tanh prediction with exact −1, 0 and 1 entries, and a
    4-band target with ±1 sites (masked) and values between. The saturated
    predictions sit on sites of the opposite sign (BCE inputs 0 and 1
    against targets 1 and 0); without ``ties`` no target equals its
    prediction, with ``ties`` every +1 prediction meets a +1 target."""
    rng = np.random.RandomState(seed)
    pred = np.tanh(rng.randn(2, 24, 32, 1) * 2).astype(np.float32)
    target = rng.uniform(-1, 1, (2, 24, 32, 4)).astype(np.float32)
    target[rng.rand(*target.shape) < 0.3] = 1.0
    target[rng.rand(*target.shape) < 0.3] = -1.0
    pred[:, :3], target[:, :3] = 1.0, -1.0
    pred[:, 3:6], target[:, 3:6, :, :2] = -1.0, 1.0
    pred[:, 6:8] = 0.0
    target[target == pred] = 0.25
    if ties:
        target[:, :3, :, 1:] = 1.0
    return pred, target


def _bce_dep_both(pred, target):
    jo, jz = jsn.get_masks(jnp.asarray(target))
    want, want_g = jax.value_and_grad(jsn.bce_dep_loss)(
        jnp.asarray(pred), jnp.asarray(target), jo, jz)
    p = _nchw(pred).requires_grad_(True)
    t = _nchw(target)
    got = psn.bce_dep_loss(p, t, *psn.get_masks(t))
    got.backward()
    return (float(got), _nhwc(p.grad)), (float(want), np.asarray(want_g))


def test_get_masks_matches_jax():
    _, target = _depth_case()
    o, z = psn.get_masks(_nchw(target))
    jo, jz = jsn.get_masks(jnp.asarray(target))
    np.testing.assert_array_equal(_nhwc(o), np.asarray(jo))
    np.testing.assert_array_equal(_nhwc(z), np.asarray(jz))
    assert o.dtype == torch.float32


def test_bce_dep_loss_matches_jax_with_saturated_predictions():
    """Value and gradient of ``bce_dep_loss`` against the JAX loss (its
    ``_bce`` copies ATen's clamped backward): predictions of exactly ±1
    map to BCE inputs 0 and 1, and the gradient stays finite there (up to
    the clamp's 1e12/n)."""
    pred, target = _depth_case()
    (got, g), (want, want_g) = _bce_dep_both(pred, target)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.isfinite(g).all() and np.isfinite(want_g).all()
    assert np.abs(g).max() > 1e6  # the clamped 1/(p(1-p)) was reached
    np.testing.assert_allclose(g, want_g, rtol=1e-4, atol=1e-8)


def test_bce_dep_loss_l1_tie_takes_torchs_zero_subgradient():
    """Where a prediction equals its target exactly, d|x|/dx at 0 is 0 in
    torch (the reference's ``L1Loss``) and 1 in JAX: the port's gradient
    there is JAX's less 50/n for each tied band, and equal elsewhere."""
    pred, target = _depth_case(ties=True)
    (got, g), (want, want_g) = _bce_dep_both(pred, target)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    tied = (target == pred).sum(-1, keepdims=True)
    assert tied.max() == 3
    np.testing.assert_allclose(g, want_g - 50.0 / target.size * tied,
                               rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("window,stride", [(2, None), (3, 2)])
def test_avg_pool_matches_jax(window, stride):
    x = np.random.RandomState(2).randn(2, 13, 17, 3).astype(np.float32)
    got = pl.avg_pool(_nchw(x), window, stride)
    want = jl.avg_pool(jnp.asarray(x), window, stride)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("size", [(24, 34), (5, 7)], ids=["up", "down"])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("form", ["gather", "matmul"])
def test_resize_bilinear_matches_both_jax_forms(monkeypatch, form,
                                                align_corners, size):
    """The port's one resize against the JAX gather form and its dense
    matmul form (``CDE_RESIZE_MM`` forces one or the other)."""
    monkeypatch.setenv("CDE_RESIZE_MM", "1" if form == "matmul" else "0")
    x = np.random.RandomState(4).randn(2, 12, 17, 3).astype(np.float32)
    got = pl.resize_bilinear(_nchw(x), size, align_corners=align_corners)
    want = jl.resize_bilinear(jnp.asarray(x), size,
                              align_corners=align_corners)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)


def test_s2d_state_dicts_round_trip(nets):
    """Port → JAX importers → ``s2d_state_dicts_from_jax`` → port: every
    tensor equal (the JAX tree keeps no BatchNorm batch count)."""
    sds = {k: _sd(n) for k, n in nets.items()}
    back = s2d_state_dicts_from_jax({k: _import(k, sd) for k, sd in
                                     sds.items()}, CFG)
    assert set(back) == set(nets)
    for k, sd in sds.items():
        want = {n: v for n, v in sd.items()
                if not n.endswith("num_batches_tracked")}
        assert set(back[k]) == set(want), k
        for n, v in want.items():
            np.testing.assert_array_equal(back[k][n].numpy(), v, err_msg=n)


def test_reference_state_dicts_load(nets):
    """SDiscriminator's shared PReLU: one parameter under two keys. A
    reference R_D ``.pth`` (DataParallel ``module.`` keys, and the
    ``up0``/``dep_out``/``norm`` entries its forward never uses) loads."""
    fd = psn.SDiscriminator(MID // 2)
    keys = [k for k in fd.state_dict() if k.endswith("weight")
            and fd.state_dict()[k].numel() == 1]
    assert keys == ["model.1.weight", "model.4.weight", "model.7.weight",
                    "model.10.weight"]
    assert fd.model[1] is fd.model[10]
    tensors = [k for k in fd.state_dict() if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    assert len(tensors) == len(list(fd.parameters())) + 1
    ref = {f"module.{k}": v.clone() + 1
           for k, v in nets["R_D"].state_dict().items()}
    ref.update({"module.up0.0.weight": torch.zeros(3),
                "module.dep_out.0.bias": torch.zeros(1),
                "module.norm.running_mean": torch.zeros(2)})
    rd = psn.RDep(MID, nets["G_2"].feature_channels)
    rd.load_state_dict(ref)
    for k, v in rd.state_dict().items():
        torch.testing.assert_close(v, ref[f"module.{k}"], rtol=0, atol=0)
