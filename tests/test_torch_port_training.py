"""The port's training slice against the JAX package, on the CPU: the
discriminators, the losses and LR policies, the InstanceNorm backward, the
ImagePool, one full CycleGAN train step, the eval step and checkpoints.

Every test feeds the same numpy inputs, made from a seed, to the JAX
function and its port counterpart; weights cross through the JAX package's
importers and the port's ``*_from_jax`` converters.
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
from cycle_depth_estimation_tpu.models import networks as jn
from cycle_depth_estimation_tpu.ops.pallas.instance_norm import (
    instance_norm as jax_instance_norm,
)
from cycle_depth_estimation_tpu.utils.torch_import import (
    import_nlayer_discriminator,
)
from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.models import networks as pn
from cycle_depth_estimation_tpu_torch.ops.kernels.instance_norm import (
    instance_norm,
    instance_norm_backward,
    plain_instance_norm_backward,
)
from cycle_depth_estimation_tpu_torch.utils.image_pool import ImagePool
from cycle_depth_estimation_tpu_torch.utils.weights import (
    cycle_gan_state_dicts_from_jax,
    nlayer_discriminator_state_dict_from_jax,
    pixel_discriminator_state_dict_from_jax,
)

SMALL = dict(model="cycle_gan", fine_size=32, ngf=4, ndf=4,
             net_g="resnet_3blocks", batch_size=2, pool_size=4,
             d_steps_per_g=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file's tests run: six test
    processes share the machine's cores in the Tier-1 run, and torch's
    threads would wait on one another there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


# ---------------------------------------------------------------------------
# discriminators (ndf 8, 64² input: the PatchGAN's last maps are 7² and 6²)
# ---------------------------------------------------------------------------


def _image(seed, n=2, size=64):
    return (np.random.RandomState(seed).rand(n, size, size, 3) * 2 - 1
            ).astype(np.float32)


@pytest.mark.parametrize("net_d,n_layers", [("basic", 3), ("n_layers", 4),
                                            ("pixel", 3)])
def test_discriminator_runs_jax_params(net_d, n_layers):
    x = _image(0)
    if net_d == "pixel":
        jd = jn.PixelDiscriminator(ndf=8, norm="instance")
    else:
        jd = jn.NLayerDiscriminator(ndf=8, n_layers=n_layers, norm="instance")
    params = jd.init(jax.random.key(1), jnp.asarray(x))["params"]
    want = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
    params = jax.tree.map(np.asarray, params)
    d = pn.define_D(3, 8, net_d, n_layers).eval()
    d.load_state_dict(pixel_discriminator_state_dict_from_jax(params)
                      if net_d == "pixel" else
                      nlayer_discriminator_state_dict_from_jax(params, n_layers))
    with torch.no_grad():
        got = _nhwc(d(_nchw(x)))
    if net_d == "basic":
        assert got.shape == (2, 6, 6, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_discriminator_state_dict_loads_through_jax_importer():
    x = _image(2)
    d = pn.define_D(3, 8, "basic",
                    generator=torch.Generator().manual_seed(3)).eval()
    sd = {k: v.numpy() for k, v in d.state_dict().items()}
    params = jax.tree.map(jnp.asarray, import_nlayer_discriminator(sd, 3))
    want = jn.NLayerDiscriminator(ndf=8, norm="instance").apply(
        {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = _nhwc(d(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_define_d_rejects_unknown_name():
    with pytest.raises(NotImplementedError):
        pn.define_D(3, 8, "patch")


# ---------------------------------------------------------------------------
# losses and LR policies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["lsgan", "vanilla"])
@pytest.mark.parametrize("target_is_real", [True, False])
def test_gan_loss_matches_jax(mode, target_is_real):
    pred = np.random.RandomState(4).randn(2, 1, 7, 7).astype(np.float32) * 3
    want = float(jn.gan_loss(jnp.asarray(pred), target_is_real, mode))
    got = float(pn.gan_loss(torch.from_numpy(pred), target_is_real, mode))
    assert got == pytest.approx(want, rel=1e-6)


def test_l1_and_mse_losses_match_jax():
    rng = np.random.RandomState(5)
    a, b = rng.randn(2, 3, 8, 8).astype(np.float32), rng.randn(2, 3, 8, 8)
    a16 = torch.from_numpy(a).to(torch.bfloat16)
    for jf, pf in ((jn.l1_loss, pn.l1_loss), (jn.mse_loss, pn.mse_loss)):
        want = float(jf(jnp.asarray(a), jnp.asarray(b, jnp.float32)))
        got = pf(torch.from_numpy(a), torch.from_numpy(b).float())
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6)
        assert pf(a16, a16).dtype == torch.float32


@pytest.mark.parametrize("policy", ["lambda", "step", "cosine", "plateau"])
def test_lr_schedule_matches_jax(policy):
    for epoch in range(0, 45):
        kw = dict(epoch=epoch, niter=7, niter_decay=5, lr_decay_iters=4)
        assert pn.lr_schedule(policy, 2e-4, **kw) == pytest.approx(
            jn.lr_schedule(policy, 2e-4, **kw), rel=1e-12)
    with pytest.raises(NotImplementedError):
        pn.lr_schedule("linear", 2e-4, epoch=1)


# ---------------------------------------------------------------------------
# InstanceNorm backward (the plain version of the backward kernel)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [((2, 7, 7, 5), "float32"),
                                         ((2, 16, 16, 4), "bfloat16")])
def test_instance_norm_backward_matches_jax_vjp(shape, dtype):
    rng = np.random.RandomState(6)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(jax_instance_norm, jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(dy, jdt))
    want = np.asarray(want, np.float32)
    tdt = getattr(torch, dtype)
    xt, dyt = _nchw(x).to(tdt), _nchw(dy).to(tdt)
    plain = plain_instance_norm_backward(xt, dyt)
    assert plain.dtype == tdt
    xg = xt.clone().requires_grad_(True)
    instance_norm(xg).backward(dyt)
    for got in (plain, instance_norm_backward(xt, dyt), xg.grad):
        got = _nhwc(got)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            # both round the same fp32 value to bf16; 2 ulps cover fp32
            # reductions in another order, with a floor where dx ≈ 0
            tol = 2 * _bf16_ulp(np.maximum(np.abs(want), 2.0 ** -8))
            assert np.all(np.abs(got - want) <= tol)


def test_instance_norm_backward_counts_no_cpu_launch_and_checks_device():
    instance_norm_backward.launches = 0
    x = torch.randn(1, 2, 5, 5, requires_grad=True)
    instance_norm(x).sum().backward()
    assert instance_norm_backward.launches == 0
    with pytest.raises(ValueError):
        instance_norm_backward(torch.empty(1, 2, 4, 4, device="meta"),
                               torch.empty(1, 2, 4, 4, device="meta"))


# ---------------------------------------------------------------------------
# ImagePool (as tests/test_models.py holds the JAX pool)
# ---------------------------------------------------------------------------


def test_pool_underfill_returns_input_and_fills():
    pool = ImagePool(4)
    batch = torch.arange(3 * 4, dtype=torch.float32).reshape(3, 1, 2, 2)
    out = pool.query(batch)
    assert torch.equal(out, batch) and out is not batch
    assert pool.count == 3
    assert torch.equal(pool.images[:3], batch)


def test_pool_full_mixes_history():
    pool = ImagePool(2, generator=torch.Generator().manual_seed(0))
    pool.query(torch.ones(2, 1, 1, 1))
    assert pool.count == 2
    seen_history = False
    for _ in range(8):
        out = pool.query(2 * torch.ones(4, 1, 1, 1))
        vals = set(out.flatten().tolist())
        assert vals <= {1.0, 2.0}
        seen_history |= 1.0 in vals
    assert seen_history
    assert set(pool.images.flatten().tolist()) <= {1.0, 2.0}


def test_pool_size_zero_identity():
    pool = ImagePool(0)
    b = torch.ones(2, 1, 1, 1)
    assert pool.query(b) is b
    assert pool.count == 0


# ---------------------------------------------------------------------------
# one CycleGAN train step, the eval step and checkpoints against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_cycle():
    """The JAX CycleGAN at ngf 4 / ndf 4, resnet_3blocks, 32², batch 2,
    d_steps_per_g 2, pool_size 4: its init, one train step and one eval
    step. 2 D steps × 2 images fill the pool exactly, so the step draws no
    random number."""
    cfg = jax_apply_model_defaults(JaxConfig(**SMALL))
    model = jax_create_model(cfg)
    state0 = jax.jit(model.init_state)(jax.random.key(0))
    rng = np.random.RandomState(0)
    a = (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    b = (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    batch = {"img_source": jnp.asarray(a), "img_target": jnp.asarray(b)}
    eval_metrics, visuals = model.eval_step(state0, batch)
    state1, metrics = model.train_step(state0, batch, jax.random.key(1))
    return dict(
        model=model, state0=state0,
        params0=jax.tree.map(np.asarray, state0.params),
        params1=jax.tree.map(np.asarray, state1.params),
        metrics={k: float(v) for k, v in metrics.items()},
        eval_metrics={k: float(v) for k, v in eval_metrics.items()},
        visuals={k: np.asarray(v) for k, v in visuals.items()},
        batch={"img_source": _nchw(a), "img_target": _nchw(b)})


def _port(jax_cycle, **kw):
    cfg = apply_model_defaults(Config(device="cpu", **{**SMALL, **kw}))
    model = create_model(cfg)
    state = model.init_state()
    for name, sd in cycle_gan_state_dicts_from_jax(jax_cycle["params0"],
                                                   cfg).items():
        state.nets[name].load_state_dict(sd)
    return cfg, model, state


def test_train_step_matches_jax(jax_cycle):
    cfg, model, state = _port(jax_cycle)
    state, metrics = model.train_step(state, jax_cycle["batch"])
    assert state.step == 1 and state.pools["fake_B"].count == 4
    assert set(metrics) == set(model.loss_names)
    for k, want in jax_cycle["metrics"].items():
        assert float(metrics[k]) == pytest.approx(want, rel=1e-4), k

    want = cycle_gan_state_dicts_from_jax(jax_cycle["params1"], cfg)
    before = cycle_gan_state_dicts_from_jax(jax_cycle["params0"], cfg)
    flipped = total = 0
    for name, net in state.nets.items():
        steps = 1 if name.startswith("G") else cfg.d_steps_per_g
        # Adam's update is about ±lr per step: where the two frameworks'
        # updates differ in sign they differ by up to 2·lr per step
        bound = 2 * cfg.lr * steps + 1e-5
        noise = pn.biases_before_norm(net)
        for key, got in net.state_dict().items():
            ref, p0 = want[name][key].numpy(), before[name][key].numpy()
            got = got.numpy()
            diff = np.abs(got - ref)
            assert np.all(diff <= bound), (name, key, diff.max())
            assert not np.array_equal(got, p0), (name, key)
            if key in noise:
                continue  # zero gradient up to rounding (biases_before_norm)
            flip = (diff > 1e-5) & (np.sign(got - p0) != np.sign(ref - p0))
            assert np.all((diff <= 1e-5) | flip), (name, key, diff.max())
            flipped += int(flip.sum())
            total += diff.size
    assert flipped <= 1e-3 * total, (flipped, total)


def test_eval_step_matches_jax(jax_cycle):
    _, model, state = _port(jax_cycle)
    metrics, visuals = model.eval_step(state, jax_cycle["batch"])
    for k, want in jax_cycle["eval_metrics"].items():
        assert float(metrics[k]) == pytest.approx(want, rel=1e-4), k
    assert set(visuals) == set(model.visual_names)
    for k, want in jax_cycle["visuals"].items():
        np.testing.assert_allclose(_nhwc(visuals[k]), want, atol=1e-5,
                                   err_msg=k)


def test_plateau_lr_sequence_matches_jax(jax_cycle):
    jmodel, jstate = jax_cycle["model"], jax_cycle["state0"]
    jmodel.cfg = jmodel.cfg.replace(lr_policy="plateau")
    jmodel._plateau = None
    _, model, state = _port(jax_cycle, lr_policy="plateau")
    metrics = [1.0, 0.5] + [0.5] * 6 + [0.3, 0.299, 0.2] + [0.2] * 7 + [None]
    try:
        for epoch, metric in enumerate(metrics, start=1):
            jstate = jmodel.update_learning_rate(jstate, epoch, metric=metric)
            state = model.update_learning_rate(state, epoch, metric=metric)
            for opt in ("G", "D"):
                want = float(jstate.opt_states[opt].hyperparams["learning_rate"])
                got = state.optimizers[opt].param_groups[0]["lr"]
                assert got == pytest.approx(want, rel=1e-6), (epoch, opt)
    finally:
        jmodel.cfg = jmodel.cfg.replace(lr_policy="lambda")
        jmodel._plateau = None
    assert state.optimizers["G"].param_groups[0]["lr"] == pytest.approx(
        2e-4 * 0.04)


def test_checkpoint_round_trip(jax_cycle, tmp_path):
    cfg, model, state = _port(jax_cycle, checkpoints_dir=str(tmp_path),
                              pool_size=3)
    state, _ = model.train_step(state, jax_cycle["batch"])  # pool now full
    paths = model.save_networks(state, 7)
    assert sorted(p.name for p in tmp_path.glob("experiment_name/7_*")) == [
        "7_net_D_A.pth", "7_net_D_B.pth", "7_net_G_A.pth", "7_net_G_B.pth",
        "7_train_state.pth"]
    assert set(torch.load(paths["G_A"])) == set(state.nets["G_A"].state_dict())

    loaded = model.load_networks(model.init_state(seed=9), 7)
    assert loaded.step == 1
    for name, net in state.nets.items():
        for k, v in net.state_dict().items():
            assert torch.equal(loaded.nets[name].state_dict()[k], v), (name, k)
    for name, pool in state.pools.items():
        assert loaded.pools[name].count == pool.count == 3
        assert torch.equal(loaded.pools[name].images, pool.images)
    # the full pool now draws: equal draws give equal next steps
    _, m1 = model.train_step(state, jax_cycle["batch"])
    _, m2 = model.train_step(loaded, jax_cycle["batch"])
    for k in m1:
        assert float(m1[k]) == float(m2[k]), k


def test_bf16_training_is_refused():
    """Nothing refuses bf16 training any more (the name is kept): the model
    builds with fp32 parameters and bf16 convs, and an unknown dtype is
    still refused."""
    cfg = apply_model_defaults(Config(device="cpu", dtype="bfloat16", **SMALL))
    state = create_model(cfg).init_state()
    for net in state.nets.values():
        assert all(p.dtype == torch.float32 for p in net.parameters())
        assert {m.compute_dtype for m in net.modules()
                if isinstance(m, torch.nn.Conv2d)} == {torch.bfloat16}
    with pytest.raises(KeyError):
        create_model(cfg.replace(dtype="float16")).init_state()
