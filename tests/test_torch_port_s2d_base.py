"""S2D_base of the port against the JAX package, on the CPU: its nets and
one train step.

Nets (64×96 images, ``dense_block_config`` (2, 2, 2, 2), ``g1_blocks`` 1,
``ndf`` 8, random weights and BatchNorm statistics): ``G1`` with resnet
blocks, ``GeneralNet2`` in modes 'S' and 'R', ``SEG2``, ``DEP2`` and
``DropDiscriminator`` with and without the label map (``dis_seg``, repeat
3), each in train mode (outputs and the moved running statistics) and eval
mode. In train mode the discriminator's Dropout2d is live: the JAX module
runs with a dropout key, its keep-masks are read from its ``Dropout_k``
outputs (``capture_intermediates``) and passed to the port's forward.
Weights go from the port to JAX through the JAX importers
(``import_g1_base``, ``import_general_net2``, ``import_seg2``,
``import_dep2``, ``import_drop_discriminator``); the importers read each
port net's ``state_dict()`` back to ``jax_variables_from_net``'s tree, and
``s2d_base_state_dicts_from_jax`` goes the other way.

The step: the port's init through the importers into the JAX model, the JAX
step run once (``train_step``, key 1), its three Dis_en forwards' masks
recovered at the step's dropout keys and passed to the port's step. Adam
at eps 1e-8 (the JAX model takes no ``adam_eps``).

Limits (fp32): net outputs within 1e-4 of their largest magnitude plus
1e-5, statistics within 1e-4 relative plus 1e-5; the step's metrics within
1e-4 relative, running statistics within 1e-5 relative plus 1e-5, and each
net's parameters by the three checks of ``tests/test_s2d.py::
_assert_params_close`` pooled over the net, as
``tests/test_torch_port_s2d_step.py::_assert_params_close`` applies them.
oneDNN is off in the step tests, as there.
"""

import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch import nn

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
from cycle_depth_estimation_tpu_torch.ops.init import init_weights
from cycle_depth_estimation_tpu_torch.utils.weights import (
    jax_variables_from_net,
    s2d_base_state_dicts_from_jax,
)
from tests.test_torch_port_s2d_step import _assert_params_close, _params

SMALL = dict(model="S2D_base", batch_size=1, ndf=8,
             dense_block_config=[2, 2, 2, 2], g1_blocks=1)
BLOCKS = tuple(SMALL["dense_block_config"])
H, W = 64, 96
LR = 2e-4


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


# ---------------------------------------------------------------------------
# helpers (the S2D_alt test file uses them too)
# ---------------------------------------------------------------------------


def randomize(net, seed):
    """Random weights, biases, BatchNorm parameters and statistics, so that
    every path carries signal."""
    gen = torch.Generator().manual_seed(seed)
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
                    t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo)
                            + lo)
    return net


def numpy_sd(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def flat(out):
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in flat(o)]
    return [out]


def assert_out_close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max() + 1e-5, (what, err)


def keep_masks(intermediates):
    """The keep-masks of a JAX module's ``Dropout_k`` layers, read from
    their captured outputs: a channel of a sample is kept where its output
    is not all zero (its input, a leaky ReLU of a conv, is nowhere 0)."""
    drops = intermediates["intermediates"]
    return [torch.from_numpy(np.array(
        (drops[f"Dropout_{i}"]["__call__"][0] != 0).any(axis=(1, 2))))
        for i in range(len(drops))]


def jax_apply(module, variables, *args, train, rng=None, static=()):
    """``module.apply(variables, *args, *static)`` through jit; in train
    mode also the moved statistics and, with ``rng``, the dropout
    keep-masks."""
    kw = {}
    if train:
        kw["mutable"] = ["batch_stats", "intermediates"]
        kw["capture_intermediates"] = (
            lambda m, _: isinstance(m, fnn.Dropout))
    if rng is not None:
        kw["rngs"] = {"dropout": rng}
    out = jax.jit(lambda v, *a: module.apply(v, *a, *static, train=train,
                                             **kw))(
        variables, *jax.tree.map(jnp.asarray, args))
    if not train:
        return out, None, None
    out, mut = out
    masks = keep_masks(mut) if "intermediates" in mut else None
    return out, mut.get("batch_stats", {}), masks


def assert_stats_close(got_sd, want_sd, what):
    for key, t in got_sd.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want_sd[key].numpy(),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{what}.{key}")


def assert_metrics_close(got, want, names, acc_atol=0.0):
    """Each metric within 1e-4 relative; an accuracy (``acc_*``) also
    within ``acc_atol`` absolute."""
    got = {k: float(v) for k, v in got.items()}
    assert set(got) == set(names) == set(want), (set(got), set(want))
    for k in names:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(
            got[k], float(want[k]), rtol=1e-4,
            atol=acc_atol if k.startswith("acc") else 0.0, err_msg=k)


def try_batch(seed, n=1, h=H, w=W):
    """A seeded NHWC ``try`` batch (numpy) and its NCHW torch copy."""
    rng = np.random.RandomState(seed)
    b = {"img_syn": rng.randn(n, h, w, 3).astype(np.float32) * 0.5,
         "img_real": rng.randn(n, h, w, 3).astype(np.float32) * 0.5,
         "seg_l_syn": rng.randint(0, 28, (n, h, w)).astype(np.int32),
         "seg_l_real": rng.randint(0, 28, (n, h, w)).astype(np.int32),
         "dep_l_syn": (rng.rand(n, h, w, 1) * 2 - 1).astype(np.float32)}
    tb = {k: (nchw(v) if v.ndim == 4 else torch.from_numpy(v.astype(np.int64)))
          for k, v in b.items()}
    return {k: jnp.asarray(v) for k, v in b.items()}, tb


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def injected(model, masks):
    """Make ``model``'s Dis_en forwards take ``masks`` in order."""
    model.dropout_masks = lambda state, n: iter(masks).__next__


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nets():
    out = psn.s2d_base_nets(_cfg())
    out["Dis_seg"] = psn.DropDiscriminator(64, 8, 3, dis_seg=True)
    return {k: randomize(v, i) for i, (k, v) in enumerate(out.items())}


def _import(name, sd):
    if name == "G_1":
        return ti.import_g1_base(sd, n_blocks=SMALL["g1_blocks"])
    if name == "G_2":
        return ti.import_general_net2(sd, BLOCKS)
    if name == "Seg_de":
        return ti.import_seg2(sd)
    if name == "Dep_de":
        return ti.import_dep2(sd)
    return ti.import_drop_discriminator(sd, 3 if name == "Dis_seg" else 4)


JAX_NETS = {
    "G_1": lambda: jsn.G1(n_blocks=SMALL["g1_blocks"], block_type="resnet"),
    "G_2": lambda: jsn.GeneralNet2(block_config=BLOCKS),
    "Seg_de": lambda: jsn.SEG2(n_cls=28),
    "Dep_de": lambda: jsn.DEP2(),
    "Dis_en": lambda: jsn.DropDiscriminator(conv_dim=8, repeat_num=4),
    "Dis_seg": lambda: jsn.DropDiscriminator(conv_dim=8, repeat_num=3),
}


def _inputs(name, nets):
    """Seeded NHWC inputs of each net and its non-tensor arguments."""
    rng = np.random.RandomState(5)
    if name == "G_1":
        return [rng.randn(1, H, W, 3)], ()
    if name == "G_2 S":
        return [rng.randn(1, H // 2, W // 2, 64)], ("S",)
    if name == "G_2 R":
        return [rng.randn(1, H, W, 3)], ("R",)
    if name in ("Seg_de", "Dep_de"):
        fc = nets["G_2"].feature_channels
        scale = (2, 2, 4, 8, 16)
        return [[rng.randn(1, H // s, W // s, c) for s, c in zip(scale, fc)],
                rng.randn(1, H // 16, W // 16, 1024)], ()
    x = rng.randn(2, H // 2, W // 2, 64)
    if name == "Dis_seg":
        return [x, rng.randint(0, 28, (2, H, W, 1))], ()
    return [x], ()


def _f32(x):
    return [_f32(a) for a in x] if isinstance(x, list) else \
        np.asarray(x, np.float32)


def _torch(x):
    return [_torch(a) for a in x] if isinstance(x, list) else nchw(x)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["G_1", "G_2 S", "G_2 R", "Seg_de",
                                  "Dep_de", "Dis_en", "Dis_seg"])
def test_net_matches_jax(nets, name, train):
    key = name.split()[0]
    net = nets[key]
    sd0 = numpy_sd(net)
    arrays, static = _inputs(name, nets)
    arrays = _f32(arrays)
    want, stats, masks = jax_apply(JAX_NETS[key](), _import(key, sd0),
                                   *arrays, train=train, static=static,
                                   rng=jax.random.key(7))
    net.train(train)
    got = net(*_torch(arrays), *static,
              **({"masks": masks} if key.startswith("Dis") else {}))
    if train and key.startswith("Dis"):
        assert [tuple(m.shape) for m in masks] == [
            (2, c) for c in net.widths]
        assert 0 < float(torch.cat(masks, 1).float().mean()) < 1
    got_l, want_l = flat(got), flat(want)
    assert len(got_l) == len(want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert_out_close(g, w, f"{name} output {i}")
    if train and stats:
        moved = _import(key, numpy_sd(net))["batch_stats"]
        for a, b in zip(jax.tree.leaves(moved), jax.tree.leaves(stats)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd0.items()})


def test_drop_discriminator_widths_follow_its_input():
    """flax infers the first conv's input width; the port takes G_1's 64
    channels whatever ``conv_dim`` is, one more with the label map, and
    doubles from ``conv_dim`` (+1)."""
    d = psn.DropDiscriminator(64, 8, 4)
    assert [d.main[3 * i].in_channels for i in range(3)] == [64, 16, 32]
    assert d.widths == (16, 32, 64) and d.conv1.in_channels == 64
    s = psn.DropDiscriminator(64, 64, 3, dis_seg=True)
    assert s.main[0].in_channels == 65 and s.widths == (130, 260)


def test_drop_discriminator_without_masks_draws_its_own():
    """Called in train mode without masks the net drops channels with
    torch's generator, as the reference module does; eval mode keeps
    all."""
    d = psn.DropDiscriminator(16, 8, 3).train()
    x = torch.randn(1, 16, 16, 16)
    torch.manual_seed(1)
    y1 = d(x)
    torch.manual_seed(2)
    assert not torch.equal(y1, d(x))
    d.eval()
    assert torch.equal(d(x), d(x, masks=[torch.zeros(1, c, dtype=torch.bool)
                                         for c in d.widths]))


@pytest.mark.parametrize("name", list(JAX_NETS))
def test_importer_reads_the_port_state_dict(nets, name):
    """The JAX importer reads each port net's ``state_dict()`` to the tree
    that ``jax_variables_from_net`` builds from the net's parts."""
    net = nets[name]
    params, stats = jax_variables_from_net(net)
    imported = _import(name, numpy_sd(net))
    assert jax.tree.structure(imported["params"]) == \
        jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(imported["params"]),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(imported.get("batch_stats", {})) == \
        jax.tree.structure(stats)


def test_s2d_base_state_dicts_round_trip(nets):
    """Port → JAX importers → ``s2d_base_state_dicts_from_jax`` → port:
    every tensor equal (the JAX tree keeps no BatchNorm batch count)."""
    names = ("G_1", "G_2", "Dis_en", "Seg_de", "Dep_de")
    sds = {k: numpy_sd(nets[k]) for k in names}
    back = s2d_base_state_dicts_from_jax(
        {k: _import(k, sd) for k, sd in sds.items()}, _cfg())
    assert set(back) == set(names)
    for k, sd in sds.items():
        want = {n: v for n, v in sd.items()
                if not n.endswith("num_batches_tracked")}
        assert set(back[k]) == set(want), k
        for n, v in want.items():
            np.testing.assert_array_equal(back[k][n].numpy(), v, err_msg=n)


def test_reference_seg2_state_dict_loads(nets):
    """A reference SEG ``.pth``: DataParallel ``module.`` keys and the
    unused ``bn`` of each DeconvBlock (the importer skips them too)."""
    ref = {f"module.{k}": v.clone() + 1
           for k, v in nets["Seg_de"].state_dict().items()}
    for i in range(4):
        ref[f"module.Up.{i}.bn.weight"] = torch.ones(3)
    seg = psn.SEG2(28, feature_nc=nets["G_2"].feature_channels)
    seg.load_state_dict(ref)
    for k, v in seg.state_dict().items():
        torch.testing.assert_close(v, ref[f"module.{k}"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _jax_variables(sds):
    return {"G_1": ti.import_g1_base(sds["G_1"], n_blocks=SMALL["g1_blocks"]),
            "G_2": ti.import_general_net2(sds["G_2"], BLOCKS),
            "Dis_en": ti.import_drop_discriminator(sds["Dis_en"], 4),
            "Seg_de": ti.import_seg2(sds["Seg_de"]),
            "Dep_de": ti.import_dep2(sds["Dep_de"])}


def _step_masks(jm, rng, n):
    """The keep-masks of the JAX step's three Dis_en forwards (G phase,
    then the D phase's synthetic and real ones): the JAX D run at the
    step's dropout keys (``_step_train``'s split, ``_apply``'s split) on
    inputs of the step's shape; the masks depend on the shape only."""
    k_g, k_d = jax.random.split(rng)
    x = np.random.RandomState(3).randn(n, H // 2, W // 2, 64)
    d = jsn.DropDiscriminator(conv_dim=8, repeat_num=4)
    v = d.init(jax.random.key(0), jnp.asarray(x, jnp.float32))
    out = []
    for k in (k_g, k_d, jax.random.fold_in(k_d, 1)):
        out.append(jax_apply(d, v, np.float32(x), train=True,
                             rng=jax.random.split(k)[0])[2])
    return out


@pytest.fixture(scope="module")
def run():
    """The port's init and a batch, and the JAX step (and eval) on them."""
    model = create_model(_cfg())
    sds = {k: numpy_sd(n) for k, n in model.init_state().nets.items()}
    v0 = _jax_variables(sds)
    jm = jax_create_model(jax_apply_model_defaults(JaxConfig(**SMALL)))
    params = {k: jax.tree.map(jnp.asarray, v["params"]) for k, v in v0.items()}
    stats = {k: jax.tree.map(jnp.asarray, v.get("batch_stats", {}))
             for k, v in v0.items()}
    opt = {"G_1": "G_1", "G_2": "G_2", "Seg": "Seg_de", "Dep": "Dep_de",
           "D": "Dis_en"}
    jstate = JaxModelState(
        params=params, batch_stats=stats,
        opt_states={k: jm.opts[k].init(params[n]) for k, n in opt.items()},
        pools={}, step=jnp.zeros((), jnp.int32))
    jb, tb = try_batch(0)
    key = jax.random.key(1)
    jstate1, jmetrics = jm.train_step(jstate, jb, key)
    jeval, jvisuals = jm.eval_step(jstate, jb)
    return dict(batch=tb, metrics=jmetrics, state=jstate1, eval=jeval,
                visuals=jvisuals, masks=_step_masks(jm, key, 1))


def _jax_sds(run, cfg=None):
    js = run["state"]
    return s2d_base_state_dicts_from_jax(
        {k: {"params": np_tree(js.params[k]),
             "batch_stats": np_tree(js.batch_stats[k])}
         for k in js.params}, cfg or _cfg())


def test_s2d_base_step_matches_jax(run, no_onednn):
    """The port's whole step, with JAX's dropout masks: every metric, and
    the nets of the G phase, the step's first update: G_1's and G_2's
    parameters by the three pooled checks, G_1's statistics (moved once,
    before the update). The later phases take G_2's updated weights, whose
    first Adam step is lr·sign(g) and flips where g is rounding; their
    parameters and statistics are held from JAX's G_1 and G_2 below."""
    model = create_model(_cfg())
    state = model.init_state()
    injected(model, run["masks"])
    seen = []
    state, m = model.train_step_phased(state, run["batch"],
                                       progress=seen.append)
    assert seen == ["real", "G", "frozen", "Seg", "Dep", "D"]
    assert state.step == 1
    assert_metrics_close(m, run["metrics"], model.loss_names)
    want = _jax_sds(run)
    assert_stats_close(state.nets["G_1"].state_dict(), want["G_1"], "G_1")
    for k in ("G_1", "G_2"):
        _assert_params_close(_params(state.nets[k].state_dict()),
                            _params(want[k]), LR, k)


def test_s2d_base_later_phases_match_jax(run, no_onednn):
    """The step with JAX's updated G_1 and G_2 weights loaded after the G
    phase (the port's running statistics kept): the frozen pass, Seg, Dep
    and D then start from JAX's input, and every net's running statistics
    (G_2's moved R, S, R, S) are held, Seg_de's, Dep_de's and Dis_en's
    parameters by the three pooled checks, every metric."""
    model = create_model(_cfg())
    state = model.init_state()
    injected(model, run["masks"])
    want = _jax_sds(run)
    ctx = model._ctx(state, run["batch"])
    for net in state.nets.values():
        net.train()
    for name, phase in model.PHASES:
        phase(model, state, ctx)
        if name == "G":
            for k in ("G_1", "G_2"):
                net = state.nets[k]
                net.load_state_dict({**want[k], **dict(net.named_buffers())})
    assert_metrics_close(ctx["metrics"], run["metrics"], model.loss_names)
    for k, net in state.nets.items():
        sd = net.state_dict()
        assert_stats_close(sd, want[k], k)
        if k not in ("G_1", "G_2"):
            _assert_params_close(_params(sd), _params(want[k]), LR, k)


def test_s2d_base_dropout_masks_are_live_and_seeded():
    """The model's own masks: drawn from ``seed`` and the step, the same
    for the same step, others for the next; about 80 % kept."""
    model = create_model(_cfg())
    state = model.init_state()
    draw = model.dropout_masks(state, 4)
    a, b = draw(), draw()
    assert [tuple(m.shape) for m in a] == [(4, 16), (4, 32), (4, 64)]
    assert not all(torch.equal(x, y) for x, y in zip(a, b))
    again = model.dropout_masks(state, 4)()
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    state.step = 1
    assert not all(torch.equal(x, y) for x, y in
                   zip(a, model.dropout_masks(state, 4)()))
    kept = float(torch.cat([torch.cat(m, 1) for m in (a, b)], 1).float()
                 .mean())
    assert 0.6 < kept < 0.95


def test_s2d_base_eval_step_matches_jax(run):
    model = create_model(_cfg())
    state = model.init_state()
    m, visuals = model.eval_step(state, run["batch"])
    assert_metrics_close(m, run["eval"], run["eval"].keys())
    assert set(visuals) == set(run["visuals"]) == set(model.visual_names)
    for k, v in visuals.items():
        want = np.asarray(run["visuals"][k])
        got = v.detach().numpy()
        assert got.shape == (want.shape if got.ndim == 3 else
                             (want.shape[0], want.shape[3], *want.shape[1:3]))
    np.testing.assert_array_equal(visuals["syn_seg_pre"].numpy(),
                                  np.asarray(run["visuals"]["syn_seg_pre"]))


def test_s2d_base_dis_seg_step(no_onednn):
    """``--dis_seg --d_repeat_num 3``: Dis_en takes the label map in front
    of G_1's features (65 channels), the step's three D losses equal the
    JAX ``DropDiscriminator`` on the step's own inputs and masks, every
    metric is finite and every net moves."""
    cfg = _cfg(dis_seg=True, d_repeat_num=3)
    model = create_model(cfg)
    state = model.init_state()
    assert state.nets["Dis_en"].main[0].in_channels == 65
    d0 = numpy_sd(state.nets["Dis_en"])
    p0 = {k: {n: a.copy() for n, a in _params(net.state_dict()).items()}
          for k, net in state.nets.items()}
    jd = jsn.DropDiscriminator(conv_dim=8, repeat_num=3)
    jv = ti.import_drop_discriminator(d0, 3)
    _, tb = try_batch(2)
    x = np.random.RandomState(4).randn(1, H // 2, W // 2, 64)
    x, sege = np.float32(x), np.zeros((1, H, W, 1), np.float32)
    keys = [jax.random.key(i) for i in (11, 12, 13)]
    masks = [jax_apply(jd, jv, x, sege, train=True, rng=k)[2] for k in keys]
    injected(model, masks)
    ctx = model._ctx(state, tb)
    for net in state.nets.values():
        net.train()
    for _, phase in model.PHASES:
        phase(model, state, ctx)
    m = {k: float(v) for k, v in ctx["metrics"].items()}
    assert set(m) == set(model.loss_names)
    assert all(np.isfinite(v) for v in m.values()), m
    sege_of = {k: nhwc(ctx[k]) for k in ("syn_sege", "real_sege")}
    pred = [jax_apply(jd, jv, nhwc(f), sege_of[s], train=True, rng=k)[0]
            for f, s, k in ((ctx["syn_f1"], "syn_sege", keys[0]),
                            (ctx["syn_f1"], "syn_sege", keys[1]),
                            (ctx["real_feats"][0], "real_sege", keys[2]))]
    want = {"G1_dis": np.mean((np.asarray(pred[0]) - 1) ** 2),
            "D_syn": np.mean(np.asarray(pred[1]) ** 2),
            "D_real": np.mean((np.asarray(pred[2]) - 1) ** 2)}
    for k, v in want.items():
        np.testing.assert_allclose(m[k], v, rtol=1e-4, err_msg=k)
    for k, net in state.nets.items():
        after = _params(net.state_dict())
        assert any(not np.array_equal(a, p0[k][n])
                   for n, a in after.items()), k
