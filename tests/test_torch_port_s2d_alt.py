"""S2D_alt of the port against the JAX package, on the CPU: its nets and
one train step.

Nets at their fixed widths (64×96 images, random weights and BatchNorm
statistics): ``GBase`` (3 blocks), ``DropDiscriminator`` on its 128
channels, ``FeatureNet``, ``SEGAlt``, ``DEPAlt`` and ``PSPModule`` (its
pools' non-uniform bins at 7×11), each in train mode (outputs and
the moved running statistics; the discriminator with the JAX module's
dropout masks) and eval mode. Weights go to JAX through ``import_gbase``,
``import_drop_discriminator``, ``import_feature_net`` and
``import_skip_decoder_alt`` (``PSPModule`` through
``jax_variables_from_net``: it has no importer), and back through
``s2d_alt_state_dicts_from_jax``; torch's adaptive average pool against
the JAX ``adaptive_avg_pool``.

The step: the port's init through the importers into the JAX model, the
JAX step run once (key 1), the masks of its four Dis_en forwards recovered
at the step's dropout keys and passed to the port's step. Adam at eps 1e-8,
Dis_en at ``lr_d``.

Limits as in ``tests/test_torch_port_s2d_base.py``, whose helpers this file
uses; oneDNN is off in the step tests.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from cycle_depth_estimation_tpu.config import Config as JaxConfig
from cycle_depth_estimation_tpu.config import (
    apply_model_defaults as jax_apply_model_defaults,
)
from cycle_depth_estimation_tpu.models import create_model as jax_create_model
from cycle_depth_estimation_tpu.models import s2d_networks as jsn
from cycle_depth_estimation_tpu.models.base_model import (
    ModelState as JaxModelState,
)
from cycle_depth_estimation_tpu.utils import torch_import as ti
from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.models import s2d_networks as psn
from cycle_depth_estimation_tpu_torch.utils.weights import (
    jax_variables_from_net,
    s2d_alt_state_dicts_from_jax,
)
from tests.test_torch_port_s2d_base import (
    H, W, LR, assert_metrics_close, assert_out_close, assert_stats_close,
    flat, injected, jax_apply, nchw, np_tree, numpy_sd, randomize, try_batch,
)
from tests.test_torch_port_s2d_step import _assert_params_close, _params

SMALL = dict(model="S2D_alt", batch_size=1)
LR_D = 8e-5
NET_LR = {"G_1": LR, "G_2": LR, "Dis_en": LR_D, "Feature": LR, "Seg_de": LR,
          "Dep_de": LR}


def _cfg(**kw):
    return apply_model_defaults(Config(device="cpu", **SMALL, **kw))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this file runs (six test
    processes share the machine's cores in the Tier-1 run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def test_defaults():
    cfg = _cfg()
    assert (cfg.net_g, cfg.dataset_mode, cfg.batch_size, cfg.fine_size,
            cfg.lr_d) == ("3blocks", "try", 1, 192, 8e-5)
    nets = psn.s2d_alt_nets(cfg.replace(net_g="6blocks"))
    assert nets["G_1"].n_blocks == 6 and nets["Dis_en"].widths == (
        256, 512, 1024)


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nets():
    out = psn.s2d_alt_nets(_cfg())
    del out["G_2"]  # G_1's twin
    out["PSP"] = psn.PSPModule(6, 8)
    return {k: randomize(v, i) for i, (k, v) in enumerate(out.items())}


def _import(name, net):
    sd = numpy_sd(net)
    if name == "G_1":
        return ti.import_gbase(sd, n_blocks=3)
    if name == "Dis_en":
        return ti.import_drop_discriminator(sd, 4)
    if name == "Feature":
        return ti.import_feature_net(sd)
    if name in ("Seg_de", "Dep_de"):
        return ti.import_skip_decoder_alt(sd)
    return {"params": jax_variables_from_net(net)[0]}


JAX_NETS = {
    "G_1": lambda: jsn.GBase(),
    "Dis_en": lambda: jsn.DropDiscriminator(conv_dim=128),
    "Feature": lambda: jsn.FeatureNet(),
    "Seg_de": lambda: jsn.SEGAlt(n_cls=28),
    "Dep_de": lambda: jsn.DEPAlt(),
    "PSP": lambda: jsn.PSPModule(out_features=8),
}


def _inputs(name, nets):
    rng = np.random.RandomState(6)
    if name == "G_1":
        return [rng.randn(1, H, W, 3)]
    if name == "Dis_en":
        return [rng.randn(2, H // 4, W // 4, 128)]
    if name == "Feature":
        return [rng.randn(1, H // 4, W // 4, 128)]
    if name in ("Seg_de", "Dep_de"):
        fc = nets["Feature"].feature_channels
        return [[rng.randn(1, H // s, W // s, c)
                 for s, c in zip((4, 8, 16), fc)],
                rng.randn(1, H // 16, W // 16, 1024)]
    return [rng.randn(2, 7, 11, 6)]  # bins of 7 and 11 over 2, 3 and 6


def _f32(x):
    return [_f32(a) for a in x] if isinstance(x, list) else \
        np.asarray(x, np.float32)


def _torch(x):
    return [_torch(a) for a in x] if isinstance(x, list) else nchw(x)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(JAX_NETS))
def test_net_matches_jax(nets, name, train):
    net = nets[name]
    sd0 = numpy_sd(net)
    arrays = _f32(_inputs(name, nets))
    want, stats, masks = jax_apply(JAX_NETS[name](), _import(name, net),
                                   *arrays, train=train,
                                   rng=jax.random.key(8))
    net.train(train)
    got = net(*_torch(arrays),
              **({"masks": masks} if name == "Dis_en" else {}))
    got_l, want_l = flat(got), flat(want)
    assert len(got_l) == len(want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert_out_close(g, w, f"{name} output {i}")
    if train and stats:
        moved = _import(name, net)["batch_stats"]
        for a, b in zip(jax.tree.leaves(moved), jax.tree.leaves(stats)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd0.items()})


@pytest.mark.parametrize("size", [(1, 1), (2, 2), (3, 3), (6, 6), (3, 6)])
def test_adaptive_avg_pool_matches_jax(size):
    x = np.random.RandomState(2).randn(2, 7, 11, 3).astype(np.float32)
    got = F.adaptive_avg_pool2d(nchw(x), size)  # PSPModule's pooling
    want = jsn.adaptive_avg_pool(jnp.asarray(x), size)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name", [n for n in JAX_NETS if n != "PSP"])
def test_importer_reads_the_port_state_dict(nets, name):
    net = nets[name]
    params, stats = jax_variables_from_net(net)
    imported = _import(name, net)
    assert jax.tree.structure(imported["params"]) == \
        jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(imported["params"]),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(imported.get("batch_stats", {})) == \
        jax.tree.structure(stats)


def test_s2d_alt_state_dicts_round_trip(nets):
    names = ("G_1", "Dis_en", "Feature", "Seg_de", "Dep_de")
    back = s2d_alt_state_dicts_from_jax(
        {k: _import(k, nets[k]) for k in names}, _cfg())
    for k in names:
        want = {n: v for n, v in numpy_sd(nets[k]).items()
                if not n.endswith("num_batches_tracked")}
        assert set(back[k]) == set(want), k
        for n, v in want.items():
            np.testing.assert_array_equal(back[k][n].numpy(), v, err_msg=n)


def test_reference_state_dict_loads(nets):
    """A reference Feature_net ``.pth`` with DataParallel keys loads."""
    ref = {f"module.{k}": v.clone() + 1
           for k, v in nets["Feature"].state_dict().items()}
    f = psn.FeatureNet(128)
    f.load_state_dict(ref)
    for k, v in f.state_dict().items():
        torch.testing.assert_close(v, ref[f"module.{k}"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _jax_variables(sds):
    out = {k: ti.import_gbase(sds[k], n_blocks=3) for k in ("G_1", "G_2")}
    out["Dis_en"] = ti.import_drop_discriminator(sds["Dis_en"], 4)
    out["Feature"] = ti.import_feature_net(sds["Feature"])
    for k in ("Seg_de", "Dep_de"):
        out[k] = ti.import_skip_decoder_alt(sds[k])
    return out


def _step_masks(rng, n):
    """The masks of the JAX step's four Dis_en forwards (keys
    ``split(rng, 4)``, each split again by ``_apply``)."""
    x = np.float32(np.random.RandomState(3).randn(n, H // 4, W // 4, 128))
    d = jsn.DropDiscriminator(conv_dim=128)
    v = d.init(jax.random.key(0), jnp.asarray(x))
    return [jax_apply(d, v, x, train=True, rng=jax.random.split(k)[0])[2]
            for k in jax.random.split(rng, 4)]


@pytest.fixture(scope="module")
def run():
    model = create_model(_cfg())
    sds = {k: numpy_sd(n) for k, n in model.init_state().nets.items()}
    v0 = _jax_variables(sds)
    jm = jax_create_model(jax_apply_model_defaults(JaxConfig(**SMALL)))
    params = {k: jax.tree.map(jnp.asarray, v["params"]) for k, v in v0.items()}
    stats = {k: jax.tree.map(jnp.asarray, v.get("batch_stats", {}))
             for k, v in v0.items()}
    jstate = JaxModelState(
        params=params, batch_stats=stats,
        opt_states={k: jm.opts[k].init(params[k]) for k in params},
        pools={}, step=jnp.zeros((), jnp.int32))
    jb, tb = try_batch(1)
    key = jax.random.key(1)
    jstate1, jmetrics = jm.train_step(jstate, jb, key)
    jeval, jvisuals = jm.eval_step(jstate, jb)
    js = jstate1
    want = s2d_alt_state_dicts_from_jax(
        {k: {"params": np_tree(js.params[k]),
             "batch_stats": np_tree(js.batch_stats[k])} for k in js.params},
        _cfg())
    return dict(batch=tb, metrics=jmetrics, want=want, eval=jeval,
                visuals=jvisuals, masks=_step_masks(key, 1))


def test_s2d_alt_step_matches_jax(run, no_onednn):
    """The port's whole step with JAX's dropout masks: every metric; G_1's
    and G_2's statistics (moved once, in the G phase) and parameters, and
    Feature's parameters (its phase starts from the encoders' outputs of
    before their update), by the three pooled checks. The accuracies of
    the Seg phase come from Feature's updated weights, whose flipped
    elements may move one argmax among 28 near-equal tanh outputs: they
    are held within one pixel here, exactly in the test below."""
    model = create_model(_cfg())
    state = model.init_state()
    injected(model, run["masks"])
    seen = []
    state, m = model.train_step_phased(state, run["batch"],
                                       progress=seen.append)
    assert seen == ["G", "Feature", "Seg", "Dep", "D"]
    assert state.step == 1
    assert_metrics_close(m, run["metrics"], model.loss_names,
                         acc_atol=1.0 / (H * W))
    want = run["want"]
    for k in ("G_1", "G_2", "Feature"):
        sd = state.nets[k].state_dict()
        if k != "Feature":
            assert_stats_close(sd, want[k], k)
        _assert_params_close(_params(sd), _params(want[k]), NET_LR[k], k)


def test_s2d_alt_later_phases_match_jax(run, no_onednn):
    """The step with JAX's updated Feature weights loaded after its phase
    (the port's statistics kept): Seg, Dep and D then start from JAX's
    input; every net's statistics (Feature's moved 2 + 3 + 2 + 1 times),
    every metric, and Seg_de's, Dep_de's and Dis_en's parameters by the
    three pooled checks."""
    model = create_model(_cfg())
    state = model.init_state()
    injected(model, run["masks"])
    want = run["want"]
    ctx = model._ctx(state, run["batch"])
    for net in state.nets.values():
        net.train()
    for name, phase in model.PHASES:
        phase(model, state, ctx)
        if name == "Feature":
            net = state.nets["Feature"]
            net.load_state_dict({**want["Feature"],
                                 **dict(net.named_buffers())})
    assert_metrics_close(ctx["metrics"], run["metrics"], model.loss_names)
    for k, net in state.nets.items():
        sd = net.state_dict()
        assert_stats_close(sd, want[k], k)
        if k in ("Dis_en", "Seg_de", "Dep_de"):
            _assert_params_close(_params(sd), _params(want[k]),
                                NET_LR[k], k)


def test_s2d_alt_eval_step_matches_jax(run):
    model = create_model(_cfg())
    state = model.init_state()
    m, visuals = model.eval_step(state, run["batch"])
    assert_metrics_close(m, run["eval"], run["eval"].keys())
    assert set(visuals) == set(run["visuals"]) == set(model.visual_names)
    for k, v in visuals.items():
        want = np.asarray(run["visuals"][k])
        got = v.detach().numpy()
        if got.ndim == 4:
            got = got.transpose(0, 2, 3, 1)
        assert got.shape == want.shape, k
    np.testing.assert_array_equal(visuals["syn_seg_pre"].numpy(),
                                  np.asarray(run["visuals"]["syn_seg_pre"]))


def test_seg_alt_trains_ce_on_tanh():
    """SEGAlt's output is a tanh: the CE of the step sees values in
    (−1, 1), so its loss stays near log 28 (the reference's quirk)."""
    seg = psn.SEGAlt(28)
    feats = [torch.randn(1, c, 16 >> i, 24 >> i)
             for i, c in enumerate((416, 592, 680))]
    out = seg(feats, torch.randn(1, 1024, 4, 6))
    assert out.abs().max() < 1
    loss = F.cross_entropy(out, torch.zeros(1, 64, 96, dtype=torch.long))
    assert abs(float(loss.detach()) - np.log(28)) < 1.0
