"""The semantic_trans generation's nets of the port against the JAX package,
on the CPU: ``StarDiscriminator`` (DIS, Dis_80, Dis_160, Dis_320),
``Discriminator2Seg``, ``GSideST``, ``DepthBlockST``, ``SegBlockST``,
``RDepST``, ``FeatureDiscriminatorS``, ``gram_matrix``/``style_loss`` and
the optax-rule gradient clip.

Each net (random weights, biases, BatchNorm parameters and statistics,
batch 2) in train mode (outputs and the moved running statistics) and
eval mode. ``RDepST`` at its real widths on tiny planes: G_2's four skip
features at full width (256, 512, 1280, 1664 channels) and a 1024-channel
PSP output of 2×3, a 32×48 image. The critics at their input sizes of a
64×96 image. Weights go from the port to JAX through the JAX importers
(``import_star_discriminator``, ``import_discriminator2_seg``,
``import_rdep_st``), which read each port net's ``state_dict()`` to the tree
``jax_variables_from_net`` builds; the ST blocks through
``jax_variables_from_net``; ``FeatureDiscriminatorS``, which no importer
reads, by hand. ``semantic_trans_state_dicts_from_jax`` and
``semantic_trans_full_state_dicts_from_jax`` go back, and a reference
``.pth`` (``module.`` keys, RDepST's dead ``up0``/``dep_out``/``norm``)
loads.

Limits (fp32), as in ``tests/test_torch_port_s2d_base.py``, whose helpers
this file uses: outputs within 1e-4 of their largest magnitude plus 1e-5,
statistics within 1e-4 relative plus 1e-5; the clip within 1e-6 relative
of optax's.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cycle_depth_estimation_tpu.models import s2d_networks as jsn
from cycle_depth_estimation_tpu.utils import torch_import as ti
from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.models import s2d_networks as psn
from cycle_depth_estimation_tpu_torch.models.base_model import (
    clip_grad_global_norm_,
)
from cycle_depth_estimation_tpu_torch.utils.weights import (
    jax_variables_from_net,
    semantic_trans_full_state_dicts_from_jax,
    semantic_trans_state_dicts_from_jax,
)
from tests.test_torch_port_s2d_base import (
    assert_out_close, flat, jax_apply, nchw, numpy_sd, randomize,
)

SKIPS = (256, 512, 1280, 1664)  # G_2's skip widths at full width
PSP_HW = (2, 3)                 # 1/16 of a 32×48 image
REPEATS = {"DIS": 5, "Dis_80": 3, "Dis_160": 4, "Dis_320": 4}
# the critics' inputs (N, H, W, C) at a 64×96 image: the (depth, label)
# pair, the full-size depth and band 1 at 1/4 and 1/2
CRITIC_IN = {"DIS": (2, 64, 96, 2), "Dis_80": (2, 64, 96, 1),
             "Dis_160": (2, 16, 24, 1), "Dis_320": (2, 32, 48, 1)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this file runs (six test
    processes share the machine's cores in the Tier-1 run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(model):
    return apply_model_defaults(Config(model=model, device="cpu",
                                       dense_block_config=[1, 1, 1, 1]))


@pytest.fixture(scope="module")
def nets():
    out = {k: psn.StarDiscriminator(CRITIC_IN[k][-1], repeat_num=r)
           for k, r in REPEATS.items()}
    out["Dis0_en"] = psn.Discriminator2Seg(1024)
    out["R_D"] = psn.RDepST(1024, SKIPS)
    out["GSideST"] = psn.GSideST(16, 12, 24)
    out["DepthBlockST"] = psn.DepthBlockST(16)
    out["SegBlockST"] = psn.SegBlockST(24, 8)
    return {k: randomize(v, i) for i, (k, v) in enumerate(out.items())}


IMPORT = {**{k: (lambda sd, r=r: ti.import_star_discriminator(sd, r))
             for k, r in REPEATS.items()},
          "Dis0_en": ti.import_discriminator2_seg,
          "R_D": ti.import_rdep_st}
JAX_NETS = {**{k: (lambda r=r: jsn.StarDiscriminator(repeat_num=r))
               for k, r in REPEATS.items()},
            "Dis0_en": jsn.Discriminator2Seg,
            "R_D": jsn.RDepST,
            "GSideST": lambda: jsn.GSideST(16),
            "DepthBlockST": lambda: jsn.DepthBlockST(16),
            "SegBlockST": lambda: jsn.SegBlockST(8)}


def _inputs(name):
    """The NHWC inputs of net ``name`` (numpy), seeded."""
    rng = np.random.RandomState(sorted(JAX_NETS).index(name))
    x = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    if name == "R_D":
        h, w = PSP_HW
        return ([x(2, h * 2 ** (3 - k), w * 2 ** (3 - k), c)
                 for k, c in enumerate(SKIPS)], x(2, h, w, 1024))
    if name == "Dis0_en":
        return (x(2, 4, 6, 1024),)
    if name == "GSideST":
        return x(2, 6, 8, 12), x(2, 6, 8, 24)
    if name in ("DepthBlockST", "SegBlockST"):
        return (x(2, 6, 8, 16 if name == "DepthBlockST" else 24),)
    return (x(*CRITIC_IN[name]),)


def _torch_args(args):
    return [[nchw(a) for a in x] if isinstance(x, list) else nchw(x)
            for x in args]


def _jax_variables(name, net):
    if name in IMPORT:
        return IMPORT[name](numpy_sd(net))
    params, stats = jax_variables_from_net(net)
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(JAX_NETS))
def test_net_matches_jax(nets, name, train):
    net = nets[name]
    sd0 = numpy_sd(net)
    args = _inputs(name)
    want, stats, _ = jax_apply(JAX_NETS[name](), _jax_variables(name, net),
                               *args, train=train)
    net.train(train)
    with torch.no_grad():
        got = net(*_torch_args(args))
    got_l, want_l = flat(got), flat(want)
    assert len(got_l) == len(want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert_out_close(g, w, f"{name} output {i}")
    if train and stats:
        moved = _jax_variables(name, net)["batch_stats"]
        assert jax.tree.structure(moved) == jax.tree.structure(stats)
        for a, b in zip(jax.tree.leaves(moved), jax.tree.leaves(stats)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd0.items()})


def test_rdep_st_outputs_at_the_image_size(nets):
    """Three (edge, depth) pairs, three 28-class logits and three 4-band
    stacks, each at the 32×48 image's size; the edges in (0, 1)."""
    net = nets["R_D"].eval()
    with torch.no_grad():
        seds, segs, deps = net(*_torch_args(_inputs("R_D")))
    size = (PSP_HW[0] * 16, PSP_HW[1] * 16)
    for outs, c in ((seds, 2), (segs, 28), (deps, 4)):
        assert [tuple(o.shape) for o in outs] == [(2, c, *size)] * 3
    assert all(((s[:, 0] > 0) & (s[:, 0] < 1)).all() for s in seds)


def test_widths_follow_the_nets_before():
    """flax infers each layer's input width; the port takes RDepST's from
    G_2's skip widths and PSP width (level 0) and from its own blocks'
    ``out_c`` (the seg levels: 1024, 1024, 512, 256), and
    Discriminator2Seg's from its input."""
    full = psn.semantic_trans_full_nets(_cfg("semantic_trans_full"))
    g2, rd = full["G_2"], full["R_D"]
    assert g2.feature_channels == (96, 80, 72, 68) and g2.mid_nc == 1024
    assert [a.side_conv[0].in_channels for a in rd.AT] == [68, 72, 80, 96]
    assert [a.conv[0].in_channels for a in rd.AT] == [2048, 1024, 512, 256]
    assert [s.deconv.in_channels for s in rd.Seg] == [1024, 1024, 512, 256]
    assert [d.upconv[0][0].in_channels for d in rd.Dep] == [1024, 512, 256,
                                                           128]
    assert full["Dis0_en"].main[0].in_channels == 1024
    assert full["Seg_de"].Up[0].deconv.in_channels == 1024


def test_feature_discriminator_matches_jax():
    """The MLP critic over the NCHW-flattened input, its PReLU αs each its
    own; converted to flax's names by hand (no importer reads it)."""
    net = psn.FeatureDiscriminatorS(8, n_layers=3, size=(4, 3))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    params = {}
    for i in range(3):
        fc = getattr(net, f"fc{i}")
        params[f"fc{i}"] = {"kernel": fc.weight.detach().numpy().T,
                            "bias": fc.bias.detach().numpy()}
        params[f"prelu{i}"] = getattr(net, f"prelu{i}").weight.detach().numpy()
    params["fc_out"] = {"kernel": net.fc_out.weight.detach().numpy().T,
                        "bias": net.fc_out.bias.detach().numpy()}
    x = np.random.RandomState(9).randn(2, 4, 3, 8).astype(np.float32)
    want = jsn.FeatureDiscriminatorS(8, n_layers=3, size=(4, 3)).apply(
        {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = net(nchw(x))
    assert_out_close(got, want, "FeatureDiscriminatorS")


def test_gram_and_style_loss_match_jax():
    rng = np.random.RandomState(4)
    x, t = (rng.randn(2, 5, 6, 3).astype(np.float32) for _ in "ab")
    np.testing.assert_allclose(psn.gram_matrix(nchw(x)).numpy(),
                               np.asarray(jsn.gram_matrix(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        float(psn.style_loss(nchw(x), nchw(t))),
        float(jsn.style_loss(jnp.asarray(x), jnp.asarray(t))), rtol=1e-5)


@pytest.mark.parametrize("scale", [3.0, 0.05], ids=["clipped", "kept"])
def test_clip_matches_optax(scale):
    """optax's ``clip_by_global_norm(1.0)`` on a gradient whose global norm
    is above 1 (divided by it) and below 1 (left as it is)."""
    rng = np.random.RandomState(2)
    grads = [rng.randn(*s).astype(np.float32) * scale
             for s in ((4, 3, 3, 3), (4,), (7, 2))]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads)))
    assert (norm > 1) == (scale > 1)
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    got = clip_grad_global_norm_(params, 1.0)
    np.testing.assert_allclose(float(got), norm, rtol=1e-6)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("name", list(IMPORT))
def test_importer_reads_the_port_state_dict(nets, name):
    net = nets[name]
    params, stats = jax_variables_from_net(net)
    imported = IMPORT[name](numpy_sd(net))
    assert jax.tree.structure(imported["params"]) == \
        jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(imported["params"]),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(imported.get("batch_stats", {})) == \
        jax.tree.structure(stats)


@pytest.mark.parametrize("model", ["semantic_trans", "semantic_trans_full"])
def test_state_dicts_round_trip(model):
    """Port → JAX importers → ``*_state_dicts_from_jax`` → port: every
    tensor of the critics (and, for semantic_trans_full, of R_D and
    Dis0_en at the small trunk's widths) equal."""
    cfg = _cfg(model)
    built = (psn.star_critics() if model == "semantic_trans"
             else psn.semantic_trans_full_nets(cfg))
    names = list(REPEATS) + ([] if model == "semantic_trans"
                             else ["R_D", "Dis0_en"])
    sds = {k: numpy_sd(randomize(built[k], i)) for i, k in enumerate(names)}
    convert = (semantic_trans_state_dicts_from_jax
               if model == "semantic_trans"
               else semantic_trans_full_state_dicts_from_jax)
    back = convert({k: IMPORT[k](sd) for k, sd in sds.items()}, cfg)
    assert set(back) == set(sds)
    for k, sd in sds.items():
        want = {n: v for n, v in sd.items()
                if not n.endswith("num_batches_tracked")}
        assert set(back[k]) == set(want), k
        for n, v in want.items():
            np.testing.assert_array_equal(back[k][n].numpy(), v, err_msg=n)


@pytest.mark.parametrize("name", ["R_D", "DIS", "Dis0_en"])
def test_reference_state_dict_loads(nets, name):
    """A reference ``.pth`` with DataParallel ``module.`` keys; RDepST's
    also with the ``up0``/``dep_out``/``norm`` entries its forward never
    uses (the importer skips them too)."""
    ref = {f"module.{k}": v.clone() - 1
           for k, v in nets[name].state_dict().items()}
    if name == "R_D":
        ref.update({"module.up0.weight": torch.ones(3),
                    "module.dep_out.0.bias": torch.ones(1),
                    "module.norm.running_mean": torch.zeros(2)})
        net = psn.RDepST(1024, SKIPS)
    elif name == "DIS":
        net = psn.StarDiscriminator(2, repeat_num=5)
    else:
        net = psn.Discriminator2Seg(1024)
    net.load_state_dict(ref)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, ref[f"module.{k}"], rtol=0, atol=0)
