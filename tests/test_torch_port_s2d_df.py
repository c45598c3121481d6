"""S2D_df of the port against the JAX package, on the CPU: its nets,
``real_dep_loss`` and one train step.

Nets (random weights and BatchNorm statistics, batch 2, the features of
64×96 images): ``SEGDF`` over 1024 channels, ``DEPDF`` and ``Dis2SegDF``
over SEGDF's 512, each in train mode (outputs and the moved running
statistics) and eval mode. Weights go from the port to JAX through the JAX
importers (``import_seg_df``, ``import_dep_df``, ``import_dis2seg_df``,
``import_general_net2``), which read each port net's ``state_dict()`` to
the tree ``jax_variables_from_net`` builds; ``s2d_df_state_dicts_from_jax``
goes the other way, and a reference ``.pth`` (``module.`` keys, the
DeconvBlocks' unused ``bn``) loads.

The step (64×96, ``dense_block_config`` (2, 2, 2, 2)): the port's init
through the importers into the JAX model, the JAX step run once
(``train_step``, key 1). Adam at eps 1e-8. A second JAX step at
``--df_g1_adv --df_adv_w 5 --df_d_real_w 0.2`` would compile for another
~35 s; the flags are held on the port's step instead: each term they
weight recomputed by the JAX critic on the features the port fed it, and
the losses the G_1, Seg and D phases optimize weighted as the flags say.

Limits (fp32), as in ``tests/test_torch_port_s2d_base.py``, whose helpers
this file uses: net outputs within 1e-4 of their largest magnitude plus
1e-5, statistics within 1e-4 relative plus 1e-5; the step's metrics within
1e-4 relative, running statistics within 1e-5 relative plus 1e-5, and each
net's parameters by the three checks of ``_assert_params_close`` pooled
over the net. oneDNN is off in the step tests.
"""

import numpy as np
import pytest
import torch

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
    s2d_df_state_dicts_from_jax,
)
from tests.test_torch_port_s2d_base import (
    H, W, LR, assert_metrics_close, assert_out_close, assert_stats_close,
    flat, jax_apply, nchw, nhwc, np_tree, numpy_sd, randomize, try_batch,
)
from tests.test_torch_port_s2d_step import _assert_params_close, _params

SMALL = dict(model="S2D_df", batch_size=1, dense_block_config=[2, 2, 2, 2])
BLOCKS = tuple(SMALL["dense_block_config"])
FLAGS = dict(df_g1_adv=True, df_adv_w=5.0, df_d_real_w=0.2)
NET_LR = {"G_1": LR / 3, "G_2": LR / 3, "Seg_de": LR / 2, "Dep_de": LR / 2,
          "Dis0_en": LR / 5}


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
# nets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nets():
    out = psn.s2d_df_nets(_cfg())
    return {k: randomize(out[k], i)
            for i, k in enumerate(("Seg_de", "Dep_de", "Dis0_en"))}


IMPORT = {"G_1": lambda sd: ti.import_general_net2(sd, BLOCKS),
          "G_2": lambda sd: ti.import_general_net2(sd, BLOCKS),
          "Seg_de": ti.import_seg_df, "Dep_de": ti.import_dep_df,
          "Dis0_en": ti.import_dis2seg_df}
JAX_NETS = {"Seg_de": jsn.SEGDF, "Dep_de": jsn.DEPDF,
            "Dis0_en": jsn.Dis2SegDF}
INPUTS = {"Seg_de": (2, H // 16, W // 16, 1024),  # G's psp features
          "Dep_de": (2, H // 8, W // 8, 512),     # SEGDF's features
          "Dis0_en": (2, H // 8, W // 8, 512)}


def jax_critic(module, variables, x):
    """A norm-free critic's JAX forward (it takes no ``train``)."""
    return jax.jit(module.apply)(variables, jnp.asarray(x))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(JAX_NETS))
def test_net_matches_jax(nets, name, train):
    net = nets[name]
    sd0 = numpy_sd(net)
    x = np.random.RandomState(5).randn(*INPUTS[name]).astype(np.float32)
    if name == "Dis0_en":
        want, stats = jax_critic(JAX_NETS[name](), IMPORT[name](sd0), x), None
    else:
        want, stats, _ = jax_apply(JAX_NETS[name](), IMPORT[name](sd0), x,
                                   train=train)
    net.train(train)
    got = net(nchw(x))
    got_l, want_l = flat(got), flat(want)
    assert len(got_l) == len(want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert_out_close(g, w, f"{name} output {i}")
    if train and stats:
        moved = IMPORT[name](numpy_sd(net))["batch_stats"]
        for a, b in zip(jax.tree.leaves(moved), jax.tree.leaves(stats)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd0.items()})


def test_widths_follow_the_nets_before():
    """flax infers each layer's input width; the port takes SEGDF's from
    the trunk's ``mid_nc`` and DEPDF's and Dis0_en's from SEGDF's
    ``feature_nc``: 512 + 8·36 = 800, halved to 400, + 18·36 = 1048, + 2
    coordinate channels into the first DeconvBlock."""
    n = psn.s2d_df_nets(_cfg())
    assert n["Seg_de"].Up[0].deconv.in_channels == n["G_1"].mid_nc == 1024
    f = n["Dep_de"].features
    assert f[0][0].norm1.num_features == psn.SEGDF.feature_nc == 512
    assert (f[1].conv.in_channels, f[1].conv.out_channels) == (800, 400)
    assert n["Dep_de"].Up[0].deconv.in_channels == 1048 + 2
    assert n["Dis0_en"].main[0].in_channels == 512
    assert [n["Dis0_en"].main[2 * i].out_channels for i in range(3)] == [
        256, 128, 64]


def test_real_dep_loss_matches_jax():
    """Per sample, the mask of pixels whose real seg argmax (the first of
    tied maxima in both frameworks) is the synthetic label; no gradient."""
    rng = np.random.RandomState(3)
    seg = rng.randn(2, 8, 12, 28).astype(np.float32)
    seg[:, :3, :, 5] = seg[:, :3, :, 9] = seg[:, :3].max(-1) + 1  # ties
    lab = rng.randint(0, 28, (2, 8, 12)).astype(np.int32)
    lab[:, :3] = 5
    dep, dep_l = (rng.rand(2, 8, 12, 1).astype(np.float32) for _ in "ab")
    want = jsn.real_dep_loss(*map(jnp.asarray, (seg, lab, dep, dep_l)))
    seg_t = nchw(seg).requires_grad_(True)
    dep_t = nchw(dep).requires_grad_(True)
    got = psn.real_dep_loss(seg_t, torch.from_numpy(lab).long(), dep_t,
                            nchw(dep_l))
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    mask = (seg_t.argmax(1) == torch.from_numpy(lab).long())
    assert mask[:, :3].all() and 0 < float(mask.float().mean()) < 1


@pytest.mark.parametrize("name", list(JAX_NETS))
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


def test_s2d_df_state_dicts_round_trip(nets):
    """Port → JAX importers → ``s2d_df_state_dicts_from_jax`` → port:
    every tensor equal."""
    sds = {k: numpy_sd(v) for k, v in nets.items()}
    back = s2d_df_state_dicts_from_jax(
        {k: IMPORT[k](sd) for k, sd in sds.items()}, _cfg())
    assert set(back) == set(sds)
    for k, sd in sds.items():
        want = {n: v for n, v in sd.items()
                if not n.endswith("num_batches_tracked")}
        assert set(back[k]) == set(want), k
        for n, v in want.items():
            np.testing.assert_array_equal(back[k][n].numpy(), v, err_msg=n)


@pytest.mark.parametrize("name", ["Seg_de", "Dep_de"])
def test_reference_decoder_state_dict_loads(nets, name):
    """A reference SEG/DEP ``.pth``: DataParallel ``module.`` keys and the
    unused ``bn`` of each DeconvBlock (the importers skip them too)."""
    ref = {f"module.{k}": v.clone() + 1
           for k, v in nets[name].state_dict().items()}
    for i in range(4):
        ref[f"module.Up.{i}.bn.weight"] = torch.ones(3)
        ref[f"module.Up.{i}.bn.running_mean"] = torch.zeros(3)
    net = psn.s2d_df_nets(_cfg())[name]
    net.load_state_dict(ref)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, ref[f"module.{k}"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def jax_state(jm, sds, opt_of, importers=None):
    """The JAX ``ModelState`` of the port's state dicts ``sds`` through
    ``importers`` (default ``IMPORT``), each optimizer of ``opt_of``
    ({opt: net}) initialised."""
    importers = importers or IMPORT
    v0 = {k: importers[k](sd) for k, sd in sds.items()}
    params = {k: jax.tree.map(jnp.asarray, v["params"]) for k, v in v0.items()}
    stats = {k: jax.tree.map(jnp.asarray, v.get("batch_stats", {}))
             for k, v in v0.items()}
    return JaxModelState(
        params=params, batch_stats=stats,
        opt_states={k: jm.opts[k].init(params[n]) for k, n in opt_of.items()},
        pools={}, step=jnp.zeros((), jnp.int32))


def jax_sds(jstate, convert, cfg):
    return convert({k: {"params": np_tree(jstate.params[k]),
                        "batch_stats": np_tree(jstate.batch_stats[k])}
                    for k in jstate.params}, cfg)


@pytest.fixture(scope="module")
def run():
    """The port's init and a batch, and the JAX step on them."""
    model = create_model(_cfg())
    sds = {k: numpy_sd(n) for k, n in model.init_state().nets.items()}
    jm = jax_create_model(jax_apply_model_defaults(JaxConfig(**SMALL)))
    jstate = jax_state(jm, sds, {"G_1": "G_1", "G_2": "G_2", "Seg": "Seg_de",
                                 "Dep": "Dep_de", "D": "Dis0_en"})
    jb, tb = try_batch(0)
    jstate1, jmetrics = jm.train_step(jstate, jb, jax.random.key(1))
    return dict(batch=tb, metrics=jmetrics,
                want=jax_sds(jstate1, s2d_df_state_dicts_from_jax, _cfg()))


def test_s2d_df_step_matches_jax(run, no_onednn):
    """The port's whole step: every metric, the BatchNorm forwards (G_1
    ×2, G_2 ×2, Seg_de ×7, Dep_de ×3), and the parameters of the nets whose
    phase reads no earlier phase's update (G_1, G_2, Seg_de) by the three
    pooled checks. The Dep and D phases read updated weights, whose first
    Adam step is lr·sign(g) and flips where g is rounding: Dep_de, Dis0_en
    and the running statistics are held from JAX's updated weights
    below."""
    model = create_model(_cfg())
    state = model.init_state()
    seen = []
    state, m = model.train_step_phased(state, run["batch"],
                                       progress=seen.append)
    assert seen == ["G_1", "G_2", "Seg", "Dep", "D"] and state.step == 1
    assert_metrics_close(m, run["metrics"], model.loss_names)
    want = run["want"]
    counts = {"G_1": 2, "G_2": 2, "Seg_de": 7, "Dep_de": 3}
    for k, net in state.nets.items():
        assert {int(b.num_batches_tracked) for b in net.modules()
                if isinstance(b, torch.nn.BatchNorm2d)} <= {counts.get(k)}, k
    for k in ("G_1", "G_2", "Seg_de"):
        _assert_params_close(_params(state.nets[k].state_dict()),
                             _params(want[k]), NET_LR[k], k)


def test_s2d_df_later_phases_match_jax(run, no_onednn):
    """The step with JAX's updated G_1, G_2 and Seg_de weights loaded after
    the Seg phase (the port's running statistics kept): Dep and D then
    start from JAX's input; Dep_de's and Dis0_en's parameters by the three
    pooled checks, every running statistic and every metric."""
    model = create_model(_cfg())
    state = model.init_state()
    want = run["want"]
    ctx = model._ctx(state, run["batch"])
    for net in state.nets.values():
        net.train()
    for name, phase in model.PHASES:
        phase(model, state, ctx)
        if name == "Seg":
            for k in ("G_1", "G_2", "Seg_de"):
                net = state.nets[k]
                net.load_state_dict({**want[k], **dict(net.named_buffers())})
    assert_metrics_close(ctx["metrics"], run["metrics"], model.loss_names)
    for k, net in state.nets.items():
        assert_stats_close(net.state_dict(), want[k], k)
    for k in ("Dep_de", "Dis0_en"):
        _assert_params_close(_params(state.nets[k].state_dict()),
                             _params(want[k]), NET_LR[k], k)


def test_s2d_df_flags_reach_the_step(run, no_onednn):
    """``--df_g1_adv --df_adv_w 5 --df_d_real_w 0.2`` from the default
    step's init and batch, each weighted term recomputed by the JAX
    ``Dis2SegDF`` (at the init's weights: Dis0_en moves last): G_1's loss
    is the default's plus 5 × LSGAN(the critic on SEGDF's features of G_1's
    output, real) — those features, ReLU(Up.0(f1)), pass no BatchNorm, so
    they are recomputed from the carried f1; the losses the Seg and D
    phases hand their optimizers are seg_real + 5 · adv_syn and 0.2 ·
    D_real + D_syn, within 1e-5 relative, with adv_syn, D_syn and D_real
    the critic's LSGAN terms on the features each phase fed it; the
    unweighted metrics are the default's until the updates differ."""
    steps = {}
    for name, flags in (("default", {}), ("flags", FLAGS)):
        model = create_model(_cfg(**flags))
        state = model.init_state()
        ctx = model._ctx(state, run["batch"])
        for net in state.nets.values():
            net.train()
        p0 = {k: {n: v.copy() for n, v in _params(net.state_dict()).items()}
              for k, net in state.nets.items()}  # _params gives views
        fed, losses, step = [], {}, model._step
        hook = state.nets["Dis0_en"].register_forward_pre_hook(
            lambda mod, args: fed.append(args[0].detach().clone()))
        model._step = lambda st, names, loss: (
            losses.__setitem__(names, float(loss)), step(st, names, loss))
        for _, phase in model.PHASES:
            phase(model, state, ctx)
        hook.remove()
        steps[name] = (ctx, p0, fed, losses)
    (c0, p0, _, _), (c1, _, fed, losses) = steps["default"], steps["flags"]
    with torch.no_grad():
        f2 = torch.relu(create_model(_cfg()).init_state()
                        .nets["Seg_de"].Up[0](c1["syn_f1"]))
    dis = IMPORT["Dis0_en"]({k: v for k, v in p0["Dis0_en"].items()})

    def lsgan(x, target):
        return float(np.mean((np.asarray(jax_critic(
            jsn.Dis2SegDF(), dis, nhwc(x))) - target) ** 2))

    # Dis0_en's inputs: G_1's f2, the Seg phase's syn f2, the D phase's
    # syn then real f2
    assert len(fed) == 4
    adv_g1, adv_syn = lsgan(f2, 1.0), lsgan(fed[1], 1.0)
    d_syn, d_real = lsgan(fed[2], 0.0), lsgan(fed[3], 1.0)
    m = {k: float(v) for k, v in c1["metrics"].items()}
    np.testing.assert_allclose(m["G_1"], float(c0["metrics"]["G_1"])
                               + 5.0 * adv_g1, rtol=1e-5)
    for k, v in (("adv_syn", adv_syn), ("D_syn", d_syn), ("D_real", d_real)):
        np.testing.assert_allclose(m[k], v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(losses[("Seg_de",)],
                               m["seg_real"] + 5.0 * adv_syn, rtol=1e-5)
    np.testing.assert_allclose(losses[("Dis0_en",)],
                               0.2 * d_real + d_syn, rtol=1e-5)
    for k in ("G_2", "seg_real", "adv_syn", "acc_syn", "acc_real"):
        assert m[k] == float(c0["metrics"][k]), k


def test_s2d_df_eval_step_matches_jax():
    """Eval mode from the port's init: every metric, the depth maps and the
    label maps."""
    model = create_model(_cfg())
    state = model.init_state()
    jm = jax_create_model(jax_apply_model_defaults(JaxConfig(**SMALL)))
    jstate = jax_state(jm, {k: numpy_sd(n) for k, n in state.nets.items()},
                       {})
    jb, tb = try_batch(0)
    want_m, want_v = jm.eval_step(jstate, jb)
    m, visuals = model.eval_step(state, tb)
    assert_metrics_close(m, want_m, want_m.keys())
    assert set(visuals) == set(want_v) == set(model.visual_names)
    for k in ("syn_dep_pre", "real_dep_pre"):
        assert_out_close(visuals[k], want_v[k], k)
    for k in ("syn_seg_pre", "real_seg_pre"):
        np.testing.assert_array_equal(visuals[k].numpy(),
                                      np.asarray(want_v[k]))
