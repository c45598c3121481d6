"""S2D_nd (model2) of the port against the JAX package, on the CPU: its
nets, ``ordimat``, ``bce_gan_loss``, the WGAN-GP ``calc_gradient_penalty``
and one train step.

Nets (random weights and BatchNorm statistics, batch 2, the 1024-channel
features of 64×96 images): ``SEG`` and ``DEP`` as S2D_nd builds them (ReLU
DeconvBlocks, DEP's tanh) and ``DiscriminatorSeg``, each in train mode
(outputs and the moved running statistics) and eval mode. Weights go from
the port to JAX through ``import_seg_decoder``, ``import_dep_decoder``,
``import_dis2seg_df`` and ``import_general_net2``, and back through
``s2d_nd_state_dicts_from_jax``; a reference ``.pth`` loads. The penalty at
a given alpha, its value and its gradient in the critic's parameters (a
double backward) against the JAX function's at the key that draws that
alpha.

The step (64×96, ``dense_block_config`` (2, 2, 2, 2)): the port's init
through the importers into the JAX model, the JAX step run once
(``train_step``, key 1), the penalty's two alphas computed from the step's
keys (``jax.random.split`` of key 1, as ``_step_train`` splits it) and
passed to the port's step. Adam at eps 1e-8, Dis_en by SGD at lr/3.

Limits (fp32), as in ``tests/test_torch_port_s2d_base.py``, whose helpers
this file uses: net outputs within 1e-4 of their largest magnitude plus
1e-5, statistics within 1e-4 relative plus 1e-5; the step's metrics (the
penalty among them) within 1e-4 relative, running statistics within 1e-5
relative plus 1e-5; each Adam net's parameters by the three checks of
``_assert_params_close`` pooled over the net. The SGD Dis_en's update is
−lr·g, linear in the gradient, but that gradient is ill-conditioned: BCE
toward 1 on the critic's LeakyReLU outputs has the slope −1/p, and the
outputs just inside the clamp (p ~ 1e-5 at this init) carry the rounding of
their inputs into the update at 1/p times its size. From the same
features, the port's fp32 D gradient is 1.2e-4 of its largest magnitude
from its float64 value and 1.9e-4 from JAX's; features that differ by
fp32 rounding (two frameworks' trunks) move it by percents. So the D
phases are held from identical features, each Dis_en parameter within
1e-3 of the update's largest magnitude, and from the step's own features
through the losses (the penalty at JAX's alphas, both BCE terms) and the
statistics. G_2's phase reads that critic through the same BCE, so over
the whole step G_2's first Adam updates (lr·sign(g) at eps 1e-8) follow
the two first D phases apart: G_2 is held from JAX's critic after its
first D phase (run from JAX's own features), by the three pooled checks.
oneDNN is off in the step tests.
"""

import copy

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
from cycle_depth_estimation_tpu.utils import torch_import as ti
from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.models import s2d_networks as psn
from cycle_depth_estimation_tpu_torch.utils.weights import (
    jax_variables_from_net,
    s2d_nd_state_dicts_from_jax,
)
from tests.test_torch_port_s2d_base import (
    H, W, LR, assert_metrics_close, assert_out_close, assert_stats_close,
    flat, jax_apply, nchw, nhwc, np_tree, numpy_sd, randomize, try_batch,
)
from tests.test_torch_port_s2d_df import jax_sds, jax_state
from tests.test_torch_port_s2d_step import _assert_params_close, _params

SMALL = dict(model="S2D_nd", batch_size=1, dense_block_config=[2, 2, 2, 2])
BLOCKS = tuple(SMALL["dense_block_config"])
PSP = (2, H // 16, W // 16, 1024)  # the trunks' features at 64×96


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


IMPORT = {"G_1": lambda sd: ti.import_general_net2(sd, BLOCKS),
          "G_2": lambda sd: ti.import_general_net2(sd, BLOCKS),
          "Seg_de": ti.import_seg_decoder, "Dep_de": ti.import_dep_decoder,
          "Dis_en": ti.import_dis2seg_df, "Dis0_en": ti.import_dis2seg_df,
          "Dis1_en": ti.import_dis2seg_df}


def step_alphas(key):
    """The penalty's alphas of the JAX step at ``key``: its two D phases'
    keys, each drawing one uniform."""
    return torch.tensor([float(jax.random.uniform(k, (), jnp.float32))
                         for k in jax.random.split(key)])


def assert_update_close(got, want, before, what, limit=1e-3):
    """Each parameter within ``limit`` of the net's largest update."""
    scale = max(np.abs(want[k] - before[k]).max() for k in want)
    assert scale > 0, what
    for k, a in got.items():
        err = np.abs(a.astype(np.float64) - want[k]).max()
        assert err <= limit * scale, (what, k, err, scale)


def d_phase_vs_jax(cfg, importers, opt_of, phase, i, jax_phase):
    """D phase ``i`` (0 or 1) of the port's step and of the JAX model's
    (``jax_phase(jm, params, stats, opts, key)``) from one init and the
    same trunk features: the port's G_1 and G_2 forwards in train mode,
    fed to both (JAX's ``_apply`` returns them for its trunks). Returns
    (port metrics, JAX losses, port's D nets' params after, before, JAX's
    after)."""
    model = port_model(cfg, step_alphas(jax.random.key(1)))
    state = model.init_state()
    _, tb = try_batch(0)
    ctx = model._ctx(state, tb)
    with torch.no_grad():
        for net in state.nets.values():
            net.train()
        feats = (state.nets["G_1"](ctx["syn_img"], "R")[1],
                 state.nets["G_2"](ctx["real_img"], "R")[1])
    sds = {k: numpy_sd(n) for k, n in state.nets.items()}
    before = {k: {n: v.copy() for n, v in _params(state.nets[k]
                                                  .state_dict()).items()}
              for k in sds}
    jm = jax_create_model(jax_apply_model_defaults(JaxConfig(
        **{f: getattr(cfg, f) for f in ("model", "batch_size",
                                        "dense_block_config", "nd_4dis")})))
    js = jax_state(jm, sds, opt_of, importers)
    given = {id(jm.net_G_1): jnp.asarray(nhwc(feats[0])),
             id(jm.net_G_2): jnp.asarray(nhwc(feats[1]))}
    apply = jm._apply
    jm._apply = lambda module, p, s, *a, **k: (
        ((None, given[id(module)]), s) if id(module) in given
        else apply(module, p, s, *a, **k))
    params, stats, opts = (dict(js.params), dict(js.batch_stats),
                           dict(js.opt_states))
    losses = jax_phase(jm, params, stats, opts,
                       jax.random.split(jax.random.key(1))[i])
    for k, f in (("G_1", feats[0]), ("G_2", feats[1])):
        state.nets[k] = lambda img, mode, f=f: ([], f)
    phase(model, state, ctx)
    names = [k for k in sds if k.startswith("Dis")]
    after = s2d_nd_state_dicts_from_jax(
        {k: {"params": np_tree(params[k])} for k in names}, cfg)
    return (ctx["metrics"], losses,
            {k: _params(state.nets[k].state_dict()) for k in names},
            before, {k: _params(after[k]) for k in names})


def run_step(cfg, importers, opt_of, key=1):
    """The port's init and a batch, and the JAX step from it."""
    model = create_model(cfg)
    sds = {k: numpy_sd(n) for k, n in model.init_state().nets.items()}
    jm = jax_create_model(jax_apply_model_defaults(JaxConfig(
        **{f: getattr(cfg, f) for f in ("model", "batch_size",
                                        "dense_block_config", "nd_4dis")})))
    jstate = jax_state(jm, sds, opt_of, importers)
    jb, tb = try_batch(0)
    k = jax.random.key(key)
    jstate1, jmetrics = jm.train_step(jstate, jb, k)
    return dict(batch=tb, metrics=jmetrics, alphas=step_alphas(k),
                want=jax_sds(jstate1, s2d_nd_state_dicts_from_jax, cfg),
                jm=jm, jstate=jstate, jbatch=jb, key=k)


def jax_d1_critic(run, cfg):
    """JAX's Dis_en after the first D phase of ``run``'s step (its own
    trunk features, the step's first key), as a port state dict."""
    jm, js, jb = run["jm"], run["jstate"], run["jbatch"]
    params, stats, opts = (dict(js.params), dict(js.batch_stats),
                           dict(js.opt_states))
    jm._d_phase(params, stats, opts, jb["img_syn"], jb["img_real"],
                jax.random.split(run["key"])[0])
    return s2d_nd_state_dicts_from_jax(
        {"Dis_en": {"params": np_tree(params["Dis_en"])}}, cfg)["Dis_en"]


def port_model(cfg, alphas):
    model = create_model(cfg)
    model.gp_alphas = lambda state: alphas.clone()
    return model


# ---------------------------------------------------------------------------
# nets and functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nets():
    out = psn.s2d_nd_nets(_cfg())
    return {k: randomize(out[k], i)
            for i, k in enumerate(("Seg_de", "Dep_de", "Dis_en"))}


JAX_NETS = {"Seg_de": lambda: jsn.SEG(n_cls=28, negative_slope=0.0),
            "Dep_de": lambda: jsn.DEP(tanh_head=True, negative_slope=0.0),
            "Dis_en": lambda: jsn.DiscriminatorSeg(conv_dim=1024)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(JAX_NETS))
def test_net_matches_jax(nets, name, train):
    net = nets[name]
    sd0 = numpy_sd(net)
    x = np.random.RandomState(6).randn(*PSP).astype(np.float32)
    want, stats, _ = jax_apply(JAX_NETS[name](), IMPORT[name](sd0), x,
                               train=train)
    net.train(train)
    got_l, want_l = flat(net(nchw(x))), flat(want)
    assert len(got_l) == len(want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert_out_close(g, w, f"{name} output {i}")
    if train and stats:
        moved = IMPORT[name](numpy_sd(net))["batch_stats"]
        for a, b in zip(jax.tree.leaves(moved), jax.tree.leaves(stats)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd0.items()})


def test_ordimat_matches_jax():
    x = torch.zeros(2, 5, 3, 4, dtype=torch.bfloat16)
    got = psn.ordimat(x)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 2, 3, 4)
    np.testing.assert_array_equal(
        got.float().numpy().transpose(0, 2, 3, 1),
        np.asarray(jsn.ordimat((2, 3, 4))))


@pytest.mark.parametrize("target", [True, False], ids=["real", "fake"])
def test_bce_gan_loss_matches_jax(target):
    """Value and gradient, on outputs inside (0, 1) and past both ends (a
    LeakyReLU head's), where the clamp holds the loss finite and the
    gradient 0."""
    x = np.random.RandomState(2).uniform(-0.5, 1.5, (2, 5, 6, 28))
    x = x.astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda p: jsn.bce_gan_loss(p, target))(jnp.asarray(x))
    t = nchw(x).requires_grad_(True)
    got = psn.bce_gan_loss(t, target)
    (g,) = torch.autograd.grad(got, t)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    g = g.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(g, np.asarray(want_g), rtol=1e-5,
                               atol=1e-9)
    assert (g[(x < 0) | (x > 1)] == 0).all()


def test_gradient_penalty_matches_jax():
    """At the alpha that JAX's key draws: the penalty over a batch of 2
    (only sample 0 interpolated, the norm over channels alone) and its
    gradient in every parameter of the critic."""
    d = randomize(psn.DiscriminatorSeg(64, 64), 4)
    params = ti.import_dis2seg_df(numpy_sd(d))["params"]
    rng = np.random.RandomState(8)
    real, fake = (rng.randn(2, 4, 6, 64).astype(np.float32) for _ in "ab")
    key = jax.random.key(4)
    jd = jsn.DiscriminatorSeg(conv_dim=64)
    want, want_g = jax.value_and_grad(lambda p: jsn.calc_gradient_penalty(
        lambda x: jd.apply({"params": p}, x), jnp.asarray(real),
        jnp.asarray(fake), key))(params)
    alpha = torch.tensor(float(jax.random.uniform(key, (), jnp.float32)))
    got = psn.calc_gradient_penalty(d, nchw(real), nchw(fake), alpha)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    grads = torch.autograd.grad(got, list(d.parameters()))
    gnet = copy.deepcopy(d)
    with torch.no_grad():
        for p, g in zip(gnet.parameters(), grads):
            p.copy_(g)
    got_g = jax_variables_from_net(gnet)[0]
    scale = max(np.abs(np.asarray(v)).max() for v in jax.tree.leaves(want_g))
    for a, b in zip(jax.tree.leaves(got_g), jax.tree.leaves(want_g)):
        assert np.abs(a - np.asarray(b)).max() <= 1e-4 * scale


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


def test_s2d_nd_state_dicts_round_trip(nets):
    sds = {k: numpy_sd(v) for k, v in nets.items()}
    back = s2d_nd_state_dicts_from_jax(
        {k: IMPORT[k](sd) for k, sd in sds.items()}, _cfg())
    assert set(back) == set(sds)
    for k, sd in sds.items():
        want = {n: v for n, v in sd.items()
                if not n.endswith("num_batches_tracked")}
        assert set(back[k]) == set(want), k
        for n, v in want.items():
            np.testing.assert_array_equal(back[k][n].numpy(), v, err_msg=n)


@pytest.mark.parametrize("name", ["Seg_de", "Dep_de", "Dis_en"])
def test_reference_state_dict_loads(nets, name):
    """A reference ``.pth`` with DataParallel ``module.`` keys; the
    decoders' also with each DeconvBlock's unused ``bn``."""
    ref = {f"module.{k}": v.clone() - 1
           for k, v in nets[name].state_dict().items()}
    if name != "Dis_en":
        for i in range(4):
            ref[f"module.Up.{i}.bn.bias"] = torch.ones(3)
    net = psn.s2d_nd_nets(_cfg())[name]
    net.load_state_dict(ref)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, ref[f"module.{k}"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

OPT_OF = {"G_1": "G_1", "G_2": "G_2", "Seg": "Seg_de", "Dep": "Dep_de",
          "D": "Dis_en"}
NET_LR = {"G_1": LR / 2, "G_2": LR / 2, "Seg_de": LR / 2, "Dep_de": LR / 2}


S2D_PHASES = [dict(create_model(_cfg()).PHASES)[k] for k in ("D1", "D2")]


@pytest.fixture(scope="module")
def run():
    return run_step(_cfg(), IMPORT, OPT_OF)


def test_s2d_nd_step_matches_jax(run, no_onednn):
    """The port's whole step with JAX's alphas: the metrics of phases D1
    to Dep, the BatchNorm forwards (G_1 ×3, G_2 ×3, Seg_de ×4), Seg_de's
    statistics, and the parameters of the nets whose phase reads no earlier
    update (G_1, Seg_de, Dep_de) by the three pooled checks. G_2's phase
    reads the first D phase's update and the second D phase G_1's and
    G_2's: G_2, those losses and the trunks' statistics are held from JAX's
    weights below, Dis_en from identical features after that."""
    model = port_model(_cfg(), run["alphas"])
    state = model.init_state()
    assert isinstance(state.optimizers["Dis_en"], torch.optim.SGD)
    assert state.optimizers["Dis_en"].param_groups[0]["lr"] == LR / 3
    seen = []
    state, m = model.train_step_phased(state, run["batch"],
                                       progress=seen.append)
    assert seen == ["D1", "G_1", "G_2", "Seg", "Dep", "D2"]
    names = [k for k in model.loss_names if k not in ("D_syn", "D_real",
                                                      "gp")]
    assert_metrics_close({k: m[k] for k in names},
                         {k: run["metrics"][k] for k in names}, names)
    counts = {"G_1": 3, "G_2": 3, "Seg_de": 4}
    for k, net in state.nets.items():
        assert {int(b.num_batches_tracked) for b in net.modules()
                if isinstance(b, torch.nn.BatchNorm2d)} <= {counts.get(k)}, k
    assert_stats_close(state.nets["Seg_de"].state_dict(),
                       run["want"]["Seg_de"], "Seg_de")
    for k in ("G_1", "Seg_de", "Dep_de"):
        _assert_params_close(_params(state.nets[k].state_dict()),
                             _params(run["want"][k]), NET_LR[k], k)


def test_s2d_nd_later_phases_match_jax(run, no_onednn):
    """JAX's Dis_en after its first D phase loaded after the port's (the
    G_2 phase then starts from JAX's input: G_2's parameters by the three
    pooled checks), and JAX's updated G_1 and G_2 after the G_2 phase (the
    port's statistics kept): the second D phase starts from JAX's input.
    Every metric (the penalty at JAX's second alpha among them) and every
    running statistic."""
    model = port_model(_cfg(), run["alphas"])
    state = model.init_state()
    want = run["want"]
    ctx = model._ctx(state, run["batch"])
    for net in state.nets.values():
        net.train()
    for name, phase in model.PHASES:
        if name == "G_2":
            state.nets["Dis_en"].load_state_dict(jax_d1_critic(run, _cfg()))
        phase(model, state, ctx)
        if name == "G_2":
            _assert_params_close(_params(state.nets["G_2"].state_dict()),
                                 _params(want["G_2"]), NET_LR["G_2"], "G_2")
            for k in ("G_1", "G_2"):
                net = state.nets[k]
                net.load_state_dict({**want[k], **dict(net.named_buffers())})
    assert_metrics_close(ctx["metrics"], run["metrics"], model.loss_names)
    for k, net in state.nets.items():
        assert_stats_close(net.state_dict(), want[k], k)


def _jax_d_phase(jm, params, stats, opts, key):
    return jm._d_phase(params, stats, opts, None, None, key)


@pytest.mark.parametrize("i", [0, 1], ids=["D1", "D2"])
def test_s2d_nd_d_phase_matches_jax(i, no_onednn):
    """Each D phase from the same features on both sides, at the JAX
    step's alpha for that phase: its three losses within 1e-4 relative,
    and Dis_en after its SGD step (lr/3) within 1e-3 of the update's
    largest magnitude."""
    m, losses, got, before, want = d_phase_vs_jax(
        _cfg(), IMPORT, OPT_OF, S2D_PHASES[i], i, _jax_d_phase)
    for k, v in zip(("D_syn", "D_real", "gp"), losses):
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    assert_update_close(got["Dis_en"], want["Dis_en"], before["Dis_en"],
                        "Dis_en")


def test_s2d_nd_alphas_are_seeded():
    """The model's own alphas: two a step in [0, 1), drawn from ``seed``
    and the step, the same again for the same step."""
    model = create_model(_cfg())
    state = model.init_state()
    a = model.gp_alphas(state)
    assert a.shape == (2,) and ((a >= 0) & (a < 1)).all() and a[0] != a[1]
    assert torch.equal(a, model.gp_alphas(state))
    state.step = 1
    assert not torch.equal(a, model.gp_alphas(state))
    assert not torch.equal(a, create_model(_cfg(seed=1)).gp_alphas(
        model.init_state()))


def test_s2d_nd_eval_step_matches_jax(run):
    want_m, want_v = run["jm"].eval_step(run["jstate"], run["jbatch"])
    model = create_model(_cfg())
    m, visuals = model.eval_step(model.init_state(), run["batch"])
    assert_metrics_close(m, want_m, want_m.keys())
    assert set(visuals) == set(want_v) == set(model.visual_names)
    for k in ("syn_dep_pre", "real_dep_pre"):
        assert_out_close(visuals[k], want_v[k], k)
    for k in ("syn_seg_pre", "real_seg_pre"):
        np.testing.assert_array_equal(visuals[k].numpy(),
                                      np.asarray(want_v[k]))
