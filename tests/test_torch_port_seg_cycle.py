"""The port's SegCycle and T2Net slice against the JAX package, on the CPU:
the seg_network blocks, T2Net's ``UNetGenerator`` (both heads), SegCycle's
``UNetEncoder``/``UNetDecoder``, the weight converters both ways,
``cross_entropy_loss`` and ``seg_accuracy``, and one SegCycle and one T2Net
train step (losses, parameters under Adam's sign rule, BatchNorm
statistics, the frozen translator).

Every comparison feeds the same numpy inputs, made from a seed, to the JAX
function and its port counterpart. Weights go from the port to the JAX
layout through ``jax_variables_from_net`` and back through the
``*_from_jax`` converters.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from flax import linen as fnn

from cycle_depth_estimation_tpu.config import Config as JaxConfig
from cycle_depth_estimation_tpu.config import (
    apply_model_defaults as jax_apply_model_defaults,
)
from cycle_depth_estimation_tpu.models import create_model as jax_create_model
from cycle_depth_estimation_tpu.models import encoder_decoder as jed
from cycle_depth_estimation_tpu.models import seg_network as jsn
from cycle_depth_estimation_tpu.models.base_model import (
    ModelState as JaxModelState,
)
from cycle_depth_estimation_tpu.utils.image_pool import init_pool
from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.models import encoder_decoder as ped
from cycle_depth_estimation_tpu_torch.models import seg_network as psn
from cycle_depth_estimation_tpu_torch.models.networks import biases_before_norm
from cycle_depth_estimation_tpu_torch.ops.init import init_weights
from cycle_depth_estimation_tpu_torch.ops.layers import PReLU, norm_uses_bias
from cycle_depth_estimation_tpu_torch.utils.weights import (
    jax_variables_from_net,
    seg_cycle_state_dicts_from_jax,
    seg_state_dicts_from_jax,
    unet_decoder_state_dict_from_jax,
    unet_encoder_state_dict_from_jax,
    unet_task_state_dict_from_jax,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this file runs: the Tier-1 run
    puts six test processes on the machine's cores, and torch's threads
    spinning against each other there cost more than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _image(seed, n=2, h=96, w=128, c=3):
    return (np.random.RandomState(seed).rand(n, h, w, c) * 2 - 1
            ).astype(np.float32)


def _randomize(net, seed):
    """Weights at a scale that keeps the outputs informative, random conv
    biases, BatchNorm parameters and statistics, and a PReLU α other than
    its init."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(net, "xavier", 1.0, gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and \
                    m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
            if isinstance(m, nn.BatchNorm2d):
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.3, 0.3),
                                  (m.running_mean, -0.5, 0.5),
                                  (m.running_var, 0.5, 2.0)):
                    t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)
            if isinstance(m, PReLU):
                m.weight.fill_(0.1)
    return net


def _jax_vars(net):
    params, stats = jax_variables_from_net(net)
    out = {"params": jax.tree.map(jnp.asarray, params)}
    if stats:
        out["batch_stats"] = jax.tree.map(jnp.asarray, stats)
    return out


def _apply_jax(module, variables, x, *static, train, **kw):
    """(output, updated batch_stats or None), jitted: one compile costs
    less than the many small ones of an eager apply."""
    if train and "batch_stats" in variables:
        y, mut = jax.jit(lambda v, x: module.apply(
            v, x, *static, train=True, mutable=["batch_stats"], **kw))(
                variables, x)
        return y, mut["batch_stats"]
    return jax.jit(lambda v, x: module.apply(v, x, *static, train=train,
                                             **kw))(variables, x), None


def _assert_close(got, want, train):
    """Max abs error within TOL of the output's scale, max(1, max |want|).
    In train mode the norms' statistics come from 6×8 center planes at
    batch 2, and fp32 rounding grows through the nets' twenty-odd norms
    (2.5e-7 of scale at the first, 2.8e-5 at ``output1``, measured); in
    eval mode and in one block it stays near 1e-6."""
    want = np.asarray(want)
    err = np.abs(_nhwc(got) - want).max()
    assert err <= (5e-5 if train else 1e-5) * max(1.0, np.abs(want).max()), err


def _assert_stats(net, jstats, site_norms):
    for site, m in site_norms.items():
        if not isinstance(m, nn.BatchNorm2d):
            continue
        tree = jstats
        for part in site.split("."):
            tree = tree[part]
        for ours, theirs in ((m.running_mean, "mean"), (m.running_var, "var")):
            np.testing.assert_allclose(ours.numpy(),
                                       np.asarray(tree["norm"][theirs]),
                                       atol=1e-5, rtol=1e-5, err_msg=site)


# ---------------------------------------------------------------------------
# blocks (ReLU: the PReLU α is a network's, tested with the networks below)
# ---------------------------------------------------------------------------


def _block(kind, norm):
    bias = norm_uses_bias(norm)
    if kind == "inception":
        return (jsn.InceptionBlock(8, norm=norm, width=3, use_bias=bias),
                psn.InceptionBlock(8, 8, norm, nn.ReLU(), 3, 0.0, bias),
                (2, 12, 14, 8))
    if kind == "encoder":
        return (jsn.EncoderBlock(6, 10, norm=norm, use_bias=bias),
                psn.EncoderBlock(4, 6, 10, norm, nn.ReLU(), bias),
                (2, 12, 14, 4))
    if kind == "decoder_up":
        return (jsn.DecoderUpBlock(6, 5, norm=norm, use_bias=bias),
                psn.DecoderUpBlock(4, 6, 5, norm, nn.ReLU(), bias),
                (2, 6, 7, 4))
    return (jsn.OutputBlock(5, 7, use_bias=bias),
            psn.OutputBlock(4, 5, 7, bias), (2, 12, 14, 4))


@pytest.mark.parametrize("kind,norm,train", [
    ("inception", "batch", True), ("inception", "batch", False),
    ("inception", "instance", True), ("encoder", "batch", True),
    ("encoder", "instance", True), ("decoder_up", "batch", True),
    ("decoder_up", "instance", True), ("output", "instance", True)])
def test_seg_block_matches_jax(kind, norm, train):
    jmod, block, shape = _block(kind, norm)
    _randomize(block, 1).train(train)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    variables = _jax_vars(block)
    kw = {} if kind == "output" else dict(train=train, act=fnn.relu)
    if kind == "output":
        want, jstats = jmod.apply(variables, jnp.asarray(x)), None
    else:
        want, jstats = _apply_jax(jmod, variables, jnp.asarray(x), **kw)
    got = block(_nchw(x))
    _assert_close(got, want, False)
    if jstats is not None:
        _assert_stats(block, jstats, block.site_norms())


# ---------------------------------------------------------------------------
# the networks, with the PReLU α and the converters both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm,domain,train", [
    ("batch", "syn", True), ("batch", "real", False),
    ("instance", "real", True)])
def test_unet_generator_matches_jax(norm, domain, train):
    net = _randomize(psn.UNetGenerator(ngf=8, norm=norm), 3).train(train)
    x = _image(4)
    variables = _jax_vars(net)
    jnet = jsn.UNetGenerator(ngf=8, norm=norm)
    want, jstats = _apply_jax(jnet, variables, jnp.asarray(x), domain,
                              train=train)
    got = net(_nchw(x), domain)
    assert got[1].shape == (2, 22 if domain == "syn" else 28, 96, 128)
    for g, w in zip(got, want):
        _assert_close(g, w, train)
    if jstats is not None:
        _assert_stats(net, jstats, net.site_norms())
    # JAX layout → port: every key, the shared α's aliases included
    sd = unet_task_state_dict_from_jax(jax.tree.map(np.asarray, variables),
                                       norm=norm)
    ref = psn.UNetGenerator(ngf=8, norm=norm)
    ref.load_state_dict(sd)
    fresh = _randomize(psn.UNetGenerator(ngf=8, norm=norm), 3)
    for k, v in fresh.state_dict().items():
        assert torch.equal(ref.state_dict()[k], v), k
    alias = [k for k in sd if k.endswith("nonlinearity.weight")]
    assert alias and all(float(sd[k]) == pytest.approx(0.1) for k in alias)


@pytest.mark.parametrize("train", [True, False])
def test_unet_encoder_decoder_match_jax(train):
    enc = _randomize(ped.UNetEncoder(ngf=8), 5).train(train)
    dec = _randomize(ped.UNetDecoder(22, ngf=8), 6).train(train)
    x = _image(7)
    v_enc, v_dec = _jax_vars(enc), _jax_vars(dec)
    jfeats, s_enc = _apply_jax(jed.UNetEncoder(ngf=8), v_enc, jnp.asarray(x),
                               train=train)
    jouts, s_dec = _apply_jax(jed.UNetDecoder(output_nc=22, ngf=8), v_dec,
                              jfeats, train=train)
    feats = enc(_nchw(x))
    outs = dec(feats)
    assert [tuple(o.shape[2:]) for o in outs] == [(6, 8), (12, 16), (24, 32),
                                                  (48, 64), (96, 128)]
    for g, w in zip(feats + outs, list(jfeats) + list(jouts)):
        _assert_close(g, w, train)
    if train:
        _assert_stats(enc, s_enc, enc.site_norms())
        _assert_stats(dec, s_dec, dec.site_norms())
    np_vars = lambda v: jax.tree.map(np.asarray, v)  # noqa: E731
    for net, sd in ((enc, unet_encoder_state_dict_from_jax(np_vars(v_enc))),
                    (dec, unet_decoder_state_dict_from_jax(np_vars(v_dec),
                                                           22))):
        if train:
            continue  # the statistics moved after the export
        want = net.state_dict()
        assert set(sd) | {k for k in want if k.endswith("tracked")} == set(want)
        for k, v in sd.items():
            assert torch.equal(v, want[k]), k


def test_define_task_g_takes_unet_only():
    """The UNet by default; 'ResNet' and 'PreUNet16' (ported since, held
    in ``test_torch_port_seg_network_parts.py``) build their nets; another
    model type raises."""
    net = psn.define_task_G(ngf=8, norm="instance")
    assert isinstance(net, psn.UNetGenerator)
    # one α for the whole net, under many names
    assert sum(isinstance(p, torch.Tensor) for p in net.parameters()) == \
        len({id(p) for p in net.parameters()})
    assert sum(1 for k in net.state_dict() if k.endswith("3.weight")
               and "conv1" in k) == 1
    assert isinstance(psn.define_task_G(ngf=8, model_type="ResNet"),
                      psn.ResGenerator)
    assert isinstance(psn.define_task_G(model_type="PreUNet16"),
                      psn.PreUNet16)
    with pytest.raises(NotImplementedError, match="model type"):
        psn.define_task_G(model_type="VGG")


# ---------------------------------------------------------------------------
# cross-entropy and accuracy
# ---------------------------------------------------------------------------


def _seg_case(seed=8, n=2, h=5, w=6, c=7):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, h, w, c) * 2).astype(np.float32)
    labels = rng.randint(0, c, (n, h, w)).astype(np.int32)
    flat = labels.reshape(-1)
    flat[:12] = [255, -1, c, c + 3, 255, -7, 0, c - 1, 255, 300, 1, c]
    return logits, labels


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_masks_out_of_range_labels_like_jax(weighted):
    logits, labels = _seg_case()
    w = (np.random.RandomState(9).rand(7) + 0.2).astype(np.float32)
    want = float(jsn.cross_entropy_loss(jnp.asarray(logits),
                                        jnp.asarray(labels), 255,
                                        w if weighted else None))
    got = psn.cross_entropy_loss(_nchw(logits), torch.from_numpy(labels),
                                 255, torch.from_numpy(w) if weighted else None)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)
    # on in-range labels it is torch's own cross-entropy
    valid = (labels >= 0) & (labels < 7)
    ref = nn.functional.cross_entropy(
        _nchw(logits), torch.from_numpy(np.where(valid, labels, 255)).long(),
        weight=torch.from_numpy(w) if weighted else None, ignore_index=255)
    assert float(got) == pytest.approx(float(ref), rel=1e-6)
    # bf16 logits: the loss is still fp32
    got16 = psn.cross_entropy_loss(_nchw(logits).bfloat16(),
                                   torch.from_numpy(labels))
    assert got16.dtype == torch.float32


def test_seg_accuracy_matches_jax():
    logits, labels = _seg_case(seed=10)
    labels[0, 0, :3] = 255
    labels[1, 2, 1] = int(np.argmax(logits[1, 2, 1]))
    want = float(jsn.seg_accuracy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(psn.seg_accuracy(_nchw(logits),
                                 torch.from_numpy(labels).long()))
    assert got == pytest.approx(want, rel=1e-7) and 0 < got < 1


# ---------------------------------------------------------------------------
# one SegCycle and one T2Net train step against the JAX step
# ---------------------------------------------------------------------------


SEG_CYCLE = dict(model="seg_cycle", ngf=8, ndf=8, net_g="resnet_3blocks",
                 fine_size=96, batch_size=2, pool_size=2)
SEG = dict(model="seg", ngf=8, net_g="resnet_3blocks", batch_size=2)


def _domain_batch(seed, h, w):
    rng = np.random.RandomState(seed)
    a = (rng.rand(2, h, w, 3) * 2 - 1).astype(np.float32)
    b = (rng.rand(2, h, w, 3) * 2 - 1).astype(np.float32)
    la = rng.randint(0, 22, (2, h, w)).astype(np.int32)
    lb = rng.randint(0, 28, (2, h, w)).astype(np.int32)
    la[0, :4, :5], lb[1, -3:, :7] = 255, 255
    jb = {"img_source": jnp.asarray(a), "img_target": jnp.asarray(b),
          "lab_source": jnp.asarray(la), "lab_target": jnp.asarray(lb)}
    pb = {"img_source": _nchw(a), "img_target": _nchw(b),
          "lab_source": torch.from_numpy(la).long(),
          "lab_target": torch.from_numpy(lb).long()}
    return jb, pb


def jax_state_of(jmodel, state, opts, pools=None):
    """A JAX ``ModelState`` holding the port state's weights: each net
    through ``jax_variables_from_net``, ``opts`` {name: net names} through
    the JAX model's optimizers, empty pools of ``pools`` {name: HWC}."""
    params, stats = {}, {}
    for name, net in state.nets.items():
        p, s = jax_variables_from_net(net)
        params[name] = jax.tree.map(jnp.asarray, p)
        stats[name] = jax.tree.map(jnp.asarray, s)
    opt_states = {k: getattr(jmodel, f"opt_{k}").init(
        {n: params[n] for n in names}) for k, names in opts.items()}
    return JaxModelState(
        params=params, batch_stats=stats, opt_states=opt_states,
        pools={k: init_pool(jmodel.cfg.pool_size, shape)
               for k, shape in (pools or {}).items()},
        step=jnp.zeros((), jnp.int32))


# Share of the parameters allowed an odd update (flipped, or a step size
# moved near eps). Measured 1.7e-3 (SegCycle) and 1.2e-3 (T2Net): a ReLU or
# PReLU kink at one element of a 6×8 center plane, where fp32 and the other
# framework land on the two sides of 0, moves that layer's gradient by
# ~0.5 % (L2; one such flip among 49,152 elements of a T2Net head's norm
# output, against a float64 run), and with it every small gradient
# upstream.
ODD_SHARE = 5e-3


def compare_adam_step(nets, want, before, lr, skip=()):
    """Every parameter and BatchNorm statistic of ``nets`` after one step
    against the JAX step's (``want``) from the same start (``before``):
    statistics to 1e-5; parameters by Adam's first-step rule, lr·g/(|g| +
    eps), about ±lr: they agree to 1e-5, or differ by up to 2·lr with the
    update's sign flipped, or one side's step is measurably under lr (|g|
    within lr/1e-5 eps of 0, where rounding moves its size); the biases that a norm follows (zero gradient up to rounding,
    ``biases_before_norm``) only within 2·lr. Returns (flipped or small,
    compared) counts."""
    odd = total = 0
    for name, net in nets.items():
        if name in skip:
            continue
        noise = biases_before_norm(net)
        for key, got in net.state_dict().items():
            if key.endswith("num_batches_tracked"):
                continue
            ref, p0, got = (want[name][key].numpy(), before[name][key].numpy(),
                            got.numpy())
            if "running" in key:
                np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5,
                                           err_msg=f"{name} {key}")
                continue
            diff = np.abs(got - ref)
            assert np.all(diff <= 2 * lr + 1e-5), (name, key, diff.max())
            if key in noise:
                continue
            past = diff > 1e-5
            flip = past & (np.sign(got - p0) != np.sign(ref - p0))
            small = past & ~flip & (np.minimum(np.abs(ref - p0),
                                               np.abs(got - p0)) < lr - 1e-5)
            bad = past & ~flip & ~small
            assert not bad.any(), (name, key, diff.max(), got[bad][:3],
                                   ref[bad][:3], p0[bad][:3])
            odd += int((flip | small).sum())
            total += diff.size
    return odd, total


@pytest.fixture(scope="module")
def seg_cycle_pair():
    kw = SEG_CYCLE
    cfg = apply_model_defaults(Config(device="cpu", **kw), set(kw))
    model = create_model(cfg)
    state = model.init_state()
    for i, net in enumerate(state.nets.values()):
        _randomize(net, 20 + i)
    jcfg = jax_apply_model_defaults(JaxConfig(**kw), set(kw))
    jmodel = jax_create_model(jcfg)
    jstate = jax_state_of(jmodel, state, {
        "G": ("G_A", "G_B", "encoderA", "encoderB", "decoderA", "decoderB"),
        "D": ("D_A", "D_B")}, {"fake_A": (96, 96, 3), "fake_B": (96, 96, 3)})
    jb, pb = _domain_batch(11, 96, 96)
    jstate1, metrics = jmodel.train_step(jstate, jb, jax.random.key(1))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(cfg=cfg, model=model, state=state, batch=pb,
                before={k: {n: v.clone() for n, v in net.state_dict().items()}
                        for k, net in state.nets.items()},
                params1=np_tree(jstate1.params),
                stats1=np_tree(jstate1.batch_stats),
                metrics={k: float(v) for k, v in metrics.items()})


def test_seg_cycle_step_matches_jax(seg_cycle_pair):
    pair = seg_cycle_pair
    cfg, model, state = pair["cfg"], pair["model"], pair["state"]
    assert (cfg.dataset_mode, cfg.no_dropout) == ("synthia", True)
    state, metrics = model.train_step(state, pair["batch"])
    assert state.step == 1 and set(metrics) == set(model.loss_names)
    for k, want in pair["metrics"].items():
        assert float(metrics[k]) == pytest.approx(want, rel=1e-5), k
    assert {p.count for p in state.pools.values()} == {2}
    want = seg_cycle_state_dicts_from_jax(pair["params1"], pair["stats1"], cfg)
    odd, total = compare_adam_step(state.nets, want, pair["before"], cfg.lr)
    assert odd <= ODD_SHARE * total, (odd, total)
    # the encoders' and decoders' statistics moved twice, G's and D's
    # have none (--norm instance)
    for name in ("encoderA", "encoderB", "decoderA", "decoderB"):
        counts = {int(v) for k, v in state.nets[name].state_dict().items()
                  if k.endswith("tracked")}
        assert counts == {2}, (name, counts)


def test_seg_cycle_eval_step_gives_label_maps(seg_cycle_pair):
    model = seg_cycle_pair["model"]
    state = model.init_state()
    metrics, visuals = model.eval_step(state, seg_cycle_pair["batch"])
    assert set(metrics) == set(model.loss_names)
    assert set(visuals) == set(model.visual_names)
    assert visuals["segAreal"].shape == (2, 96, 96)
    assert int(visuals["segBfake"].max()) < 28
    assert visuals["lab_A"].dtype == torch.long


@pytest.fixture(scope="module")
def seg_pair():
    kw = SEG
    cfg = apply_model_defaults(Config(device="cpu", **kw), set(kw))
    assert (cfg.norm, cfg.dataset_mode) == ("instance", "synthia")
    model = create_model(cfg)
    state = model.init_state()
    for i, net in enumerate(state.nets.values()):
        _randomize(net, 30 + i)
    jmodel = jax_create_model(jax_apply_model_defaults(JaxConfig(**kw),
                                                       set(kw)))
    jstate = jax_state_of(jmodel, state, {})
    jstate = jstate.replace(opt_states={"T": jmodel.opt_T.init(
        jstate.params["img2task"])})
    jb, pb = _domain_batch(12, 96, 128)
    jstate1, metrics = jmodel.train_step(jstate, jb, jax.random.key(1))
    return dict(cfg=cfg, model=model, state=state, batch=pb,
                before={k: {n: v.clone() for n, v in net.state_dict().items()}
                        for k, net in state.nets.items()},
                params1=jax.tree.map(np.asarray, jstate1.params),
                stats1=jax.tree.map(np.asarray, jstate1.batch_stats),
                metrics={k: float(v) for k, v in metrics.items()})


def test_t2net_step_matches_jax_and_keeps_s2t_frozen(seg_pair):
    cfg, model, state = seg_pair["cfg"], seg_pair["model"], seg_pair["state"]
    state, metrics = model.train_step(state, seg_pair["batch"])
    assert set(metrics) == set(model.loss_names)
    for k, want in seg_pair["metrics"].items():
        rel = 1e-5 if k.startswith("loss") else 1e-6
        assert float(metrics[k]) == pytest.approx(want, rel=rel), k
    want = seg_state_dicts_from_jax(seg_pair["params1"], seg_pair["stats1"],
                                    cfg)
    odd, total = compare_adam_step(state.nets, want, seg_pair["before"], 1e-3,
                                   skip=("s2t",))
    assert odd <= ODD_SHARE * total, (odd, total)
    for k, v in state.nets["s2t"].state_dict().items():
        assert torch.equal(v, seg_pair["before"]["s2t"][k]), k
        np.testing.assert_array_equal(v.numpy(), want["s2t"][k].numpy())
    opt = state.optimizers["T"]
    assert (opt.param_groups[0]["lr"], opt.param_groups[0]["betas"]) == (
        1e-3, (0.95, 0.999))
    assert not any(p.requires_grad for p in state.nets["s2t"].parameters())


def test_load_reference_s2t_reads_a_generator_pth(seg_pair, tmp_path):
    model = seg_pair["model"]
    state = model.init_state(seed=3)
    ref = model.init_state(seed=4).nets["s2t"].state_dict()
    torch.save(ref, tmp_path / "latest_net_G_A.pth")
    state = model.load_reference_s2t(state, str(tmp_path / "latest_net_G_A.pth"))
    for k, v in state.nets["s2t"].state_dict().items():
        assert torch.equal(v, ref[k]), k
    assert not any(p.requires_grad for p in state.nets["s2t"].parameters())
