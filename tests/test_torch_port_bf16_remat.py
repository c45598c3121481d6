"""bf16 training and ``--remat`` in the port, on the CPU.

- ``--dtype bfloat16``: one CycleGAN, one pix2pix and one SegCycle train
  step against the JAX package's bf16 step from the same weights (the JAX
  package's own ``tests/test_bf16_models.py`` runs these steps on the CPU),
  and the dtypes at the boundaries: bf16 conv, norm and generator outputs,
  fp32 parameters, Adam state, BatchNorm statistics and losses.
- ``--remat``: a CycleGAN step with the generators checkpointed equals the
  plain step, under ``--norm instance`` and ``--norm batch`` (running
  statistics moved once per application) and with dropout (the same masks
  drawn again).

Both frameworks round to bf16 at every conv and norm, each in its own
order, so a bf16 step is held to the JAX step by its losses, 3e-2
relative, and by the share of parameters whose Adam update agrees in sign,
not by a fixed distance.
"""

import copy

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from cycle_depth_estimation_tpu.config import Config as JaxConfig
from cycle_depth_estimation_tpu.config import (
    apply_model_defaults as jax_apply_model_defaults,
)
from cycle_depth_estimation_tpu.models import create_model as jax_create_model
from cycle_depth_estimation_tpu.models.base_model import (
    ModelState as JaxModelState,
)
from cycle_depth_estimation_tpu.utils.image_pool import init_pool
from cycle_depth_estimation_tpu_torch.config import (Config,
                                                     apply_model_defaults)
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.ops.kernels import (
    instance_norm as kin)
from cycle_depth_estimation_tpu_torch.utils.weights import (
    jax_variables_from_net)

# a bf16 step's losses against the JAX bf16 step's, relative
LOSS_REL = 3e-2
# a net's share of sign-flipped updates against the JAX bf16 step is held to
# twice that of the port's fp32 step, or this floor
FLIP_FLOOR = 1e-2


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


def _images(seed, n, h, w):
    return (np.random.RandomState(seed).rand(n, h, w, 3) * 2 - 1
            ).astype(np.float32)


def _jax_state(jmodel, state, opt_states, pools):
    """A JAX ``ModelState`` with the port state's weights;
    ``opt_states(params)`` builds the JAX optimizer states."""
    params, stats = {}, {}
    for name, net in state.nets.items():
        p, s = jax_variables_from_net(net)
        params[name] = jax.tree.map(jnp.asarray, p)
        stats[name] = jax.tree.map(jnp.asarray, s)
    return JaxModelState(
        params=params, batch_stats=stats, opt_states=opt_states(params),
        pools={k: init_pool(jmodel.cfg.pool_size, s) for k, s in pools.items()},
        step=jnp.zeros((), jnp.int32))


def _flip_share(nets, before, jparams1, lr):
    """Per net, the share of the parameters whose update in the port step
    and in the JAX step differ in sign, among those the JAX step moved by
    more than lr/2 (|g| above eps, where Adam's first step is about ±lr)."""
    shares = {}
    for name, net in nets.items():
        flipped = total = 0
        got_tree, _ = jax_variables_from_net(net)
        for got, p0, want in zip(jax.tree.leaves(got_tree),
                                 jax.tree.leaves(before[name]),
                                 jax.tree.leaves(jax.tree.map(
                                     np.asarray, jparams1[name]))):
            full = np.abs(want - p0) > 0.5 * lr
            flipped += int((full & (np.sign(got - p0) != np.sign(want - p0))
                            ).sum())
            total += int(full.sum())
        shares[name] = flipped / max(total, 1)
    return shares


def _run_bf16(kw, batch_np, opt_states, pools, batch_port):
    """One bf16 step of the port and of the JAX package from the same
    weights, and one fp32 step of the port from them too."""
    steps = {}
    for dtype in ("bfloat16", "float32"):
        cfg = apply_model_defaults(Config(device="cpu", dtype=dtype, **kw),
                                   set(kw) | {"dtype"})
        model = create_model(cfg)
        state = model.init_state()
        if dtype == "bfloat16":
            before = {k: jax_variables_from_net(n)[0]
                      for k, n in state.nets.items()}
            jkw = {**kw, "dtype": "bfloat16"}
            jmodel = jax_create_model(jax_apply_model_defaults(
                JaxConfig(**jkw), set(jkw)))
            jstate = _jax_state(jmodel, state,
                                lambda p: opt_states(jmodel, p), pools)
            jstate1, jm = jmodel.train_step(jstate, batch_np,
                                            jax.random.key(1))
        steps[dtype] = (model,) + model.train_step(state, batch_port)
    return steps, before, jstate1, {k: float(v) for k, v in jm.items()}


def _check_bf16(steps, before, jstate1, jm):
    """Losses within LOSS_REL of the JAX bf16 step's; fp32 parameters,
    Adam state and statistics; and, net by net, updates no further from
    the JAX bf16 step's (in the share of flipped signs) than twice those of
    the port's fp32 step, an implementation without bf16 rounding."""
    model, state, m = steps["bfloat16"]
    assert set(m) == set(model.loss_names)
    for k, want in jm.items():
        got = float(m[k])
        assert m[k].dtype == torch.float32 and np.isfinite(got), k
        assert got == pytest.approx(want, rel=LOSS_REL, abs=1e-3), k
    for name, net in state.nets.items():
        for p in net.parameters():
            assert p.dtype == torch.float32, name
        for b in net.buffers():
            assert b.dtype in (torch.float32, torch.int64), name
    for opt in state.optimizers.values():
        for st in opt.state.values():
            assert st["exp_avg"].dtype == torch.float32
    lr = model.cfg.lr
    shares = _flip_share(state.nets, before, jstate1.params, lr)
    yard = _flip_share(steps["float32"][1].nets, before, jstate1.params, lr)
    over = {k: (v, yard[k]) for k, v in shares.items()
            if v > max(2 * yard[k], FLIP_FLOOR)}
    assert not over, over
    return state


def test_bf16_cycle_gan_step_matches_jax():
    kw = dict(model="cycle_gan", fine_size=32, ngf=8, ndf=8,
              net_g="resnet_3blocks", batch_size=2, pool_size=2,
              d_steps_per_g=1)
    a, b = _images(0, 2, 32, 32), _images(1, 2, 32, 32)
    out = _run_bf16(
        kw, {"img_source": jnp.asarray(a), "img_target": jnp.asarray(b)},
        lambda jm, p: {"G": jm.opt_G.init({k: p[k] for k in ("G_A", "G_B")}),
                       "D": jm.opt_D.init({k: p[k] for k in ("D_A", "D_B")})},
        {"fake_A": (32, 32, 3), "fake_B": (32, 32, 3)},
        {"img_source": _nchw(a), "img_target": _nchw(b)})
    _check_bf16(*out)


def test_bf16_pix2pix_step_matches_jax():
    kw = dict(model="pix2pix", fine_size=128, ngf=4, ndf=4, net_g="unet_128",
              batch_size=2, no_dropout=True)
    a, b = _images(2, 2, 128, 128), _images(3, 2, 128, 128)
    out = _run_bf16(
        kw, {"A": jnp.asarray(a), "B": jnp.asarray(b)},
        lambda jm, p: {"G": jm.opt_G.init(p["G"]), "D": jm.opt_D.init(p["D"])},
        {"fake_AB": (128, 128, 6)}, {"A": _nchw(a), "B": _nchw(b)})
    state = _check_bf16(*out)
    # BatchNorm statistics stay fp32 and moved (G once, D three times)
    tracked = {k: int(v) for k, v in state.nets["D"].state_dict().items()
               if k.endswith("tracked")}
    assert set(tracked.values()) == {3}


def test_bf16_seg_cycle_step_matches_jax():
    kw = dict(model="seg_cycle", ngf=8, ndf=8, net_g="resnet_3blocks",
              fine_size=96, batch_size=2, pool_size=2)
    rng = np.random.RandomState(4)
    a, b = _images(5, 2, 96, 96), _images(6, 2, 96, 96)
    la = rng.randint(0, 22, (2, 96, 96)).astype(np.int32)
    lb = rng.randint(0, 28, (2, 96, 96)).astype(np.int32)
    group = ("G_A", "G_B", "encoderA", "encoderB", "decoderA", "decoderB")
    out = _run_bf16(
        kw, {"img_source": jnp.asarray(a), "img_target": jnp.asarray(b),
             "lab_source": jnp.asarray(la), "lab_target": jnp.asarray(lb)},
        lambda jm, p: {"G": jm.opt_G.init({k: p[k] for k in group}),
                       "D": jm.opt_D.init({k: p[k] for k in ("D_A", "D_B")})},
        {"fake_A": (96, 96, 3), "fake_B": (96, 96, 3)},
        {"img_source": _nchw(a), "img_target": _nchw(b),
         "lab_source": torch.from_numpy(la).long(),
         "lab_target": torch.from_numpy(lb).long()})
    _check_bf16(*out)


def test_bf16_nets_compute_in_bf16_with_fp32_parameters():
    cfg = apply_model_defaults(Config(
        device="cpu", model="seg_cycle", ngf=8, ndf=8, fine_size=96,
        net_g="resnet_3blocks", dtype="bfloat16"))
    state = create_model(cfg).init_state()
    x = torch.rand(1, 3, 96, 96) * 2 - 1
    seen = {}

    def hook(name):
        def record(mod, inp, out):
            seen.setdefault(name, out.dtype)
        return record

    for m in state.nets["encoderA"].modules():
        if isinstance(m, (nn.Conv2d, nn.BatchNorm2d)):
            m.register_forward_hook(hook(type(m).__name__))
    assert state.nets["G_A"](x).dtype == torch.bfloat16
    feats = state.nets["encoderA"](x)
    assert seen == {"Conv2d": torch.bfloat16, "BatchNorm": torch.bfloat16}
    assert state.nets["decoderA"](feats)[-1].dtype == torch.bfloat16
    bn = next(m for m in state.nets["encoderA"].modules()
              if isinstance(m, nn.BatchNorm2d))
    assert bn.running_mean.dtype == torch.float32
    assert all(p.dtype == torch.float32 for n in state.nets.values()
               for p in n.parameters())


# ---------------------------------------------------------------------------
# --remat
# ---------------------------------------------------------------------------


def _cycle(norm, **kw):
    cfg = apply_model_defaults(Config(
        device="cpu", model="cycle_gan", fine_size=32, ngf=4, ndf=4,
        net_g="resnet_3blocks", batch_size=2, pool_size=4, d_steps_per_g=1,
        norm=norm, **kw))
    return cfg


@pytest.mark.parametrize("norm,dropout", [("instance", False),
                                          ("batch", False),
                                          ("instance", True)])
def test_remat_step_equals_plain_step(norm, dropout):
    a, b = _images(7, 2, 32, 32), _images(8, 2, 32, 32)
    batch = {"img_source": _nchw(a), "img_target": _nchw(b)}
    runs = {}
    for remat in (False, True):
        cfg = _cycle(norm, remat=remat, no_dropout=not dropout)
        model = create_model(cfg)
        state = model.init_state()
        torch.manual_seed(11)
        kin.instance_norm.launches = 0
        state, m = model.train_step(state, batch)
        runs[remat] = (state, {k: float(v) for k, v in m.items()},
                       torch.randn(3))
    (s0, m0, r0), (s1, m1, r1) = runs[False], runs[True]
    assert m0 == m1
    assert torch.equal(r0, r1)  # the recompute drew nothing from the RNG
    for name, net in s0.nets.items():
        other = s1.nets[name].state_dict()
        for k, v in net.state_dict().items():
            assert torch.equal(v, other[k]), (name, k)
    if norm == "batch":
        tracked = {int(v) for k, v in s1.nets["G_A"].state_dict().items()
                   if k.endswith("tracked")}
        assert tracked == {3}  # three applications of G_A, once each


def test_remat_recomputes_the_generator_forwards():
    cfg = _cycle("instance", remat=True)
    model = create_model(cfg)
    state = model.init_state()
    calls = []
    real = kin._InstanceNormFn.forward

    def counting(ctx, x, eps, grad):
        calls.append(torch.is_grad_enabled())
        return real(ctx, x, eps, grad)

    a = _nchw(_images(9, 2, 32, 32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kin._InstanceNormFn, "forward", staticmethod(counting))
        model.train_step(state, {"img_source": a, "img_target": a})
    # 3 blocks: 2·3 + 5 = 11 norms a generator, 6 applications, each run
    # again in backward; 3 norms a discriminator, 2 + 1·2·2 passes
    assert len(calls) == 2 * 6 * 11 + 3 * 6
    plain = create_model(_cycle("instance"))
    calls.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kin._InstanceNormFn, "forward", staticmethod(counting))
        plain.train_step(plain.init_state(),
                         {"img_source": a, "img_target": a})
    assert len(calls) == 6 * 11 + 3 * 6


def test_remat_is_off_in_eval_and_copies_nothing():
    cfg = _cycle("batch", remat=True)
    model = create_model(cfg)
    state = model.init_state()
    a = _nchw(_images(10, 2, 32, 32))
    before = copy.deepcopy(state.nets["G_A"].state_dict())
    metrics, visuals = model.eval_step(state, {"img_source": a,
                                               "img_target": a})
    assert set(visuals) == set(model.visual_names)
    for k, v in state.nets["G_A"].state_dict().items():
        assert torch.equal(v, before[k]), k


def test_bf16_t2net_step_is_finite_and_near_fp32():
    rng = np.random.RandomState(12)
    batch = {"img_source": _nchw(_images(13, 2, 96, 128)),
             "img_target": _nchw(_images(14, 2, 96, 128)),
             "lab_source": torch.from_numpy(rng.randint(0, 22, (2, 96, 128))),
             "lab_target": torch.from_numpy(rng.randint(0, 28, (2, 96, 128)))}
    metrics = {}
    for dtype in ("float32", "bfloat16"):
        cfg = apply_model_defaults(Config(
            device="cpu", model="seg", ngf=8, net_g="resnet_3blocks",
            dtype=dtype))
        model = create_model(cfg)
        _, metrics[dtype] = model.train_step(model.init_state(), batch)
    for k, want in metrics["float32"].items():
        got = metrics["bfloat16"][k]
        assert got.dtype == torch.float32 and torch.isfinite(got), k
        assert float(got) == pytest.approx(float(want), rel=LOSS_REL), k
