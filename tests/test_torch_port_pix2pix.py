"""The port's pix2pix slice against the JAX package, on the CPU: BatchNorm
(train and eval, the biased running variance), the U-Net (batch and
instance norm, train and eval, dropout), the BatchNorm discriminator, one
pix2pix train step at ``--no_dropout`` (losses, parameters under Adam's
sign rule, BatchNorm statistics), the eval step, checkpoints, and the train
and test CLIs with ``--model pix2pix``.

Every comparison feeds the same numpy inputs, made from a seed, to the JAX
function and its port counterpart; weights cross through the JAX package's
``import_unet_generator`` and the port's ``*_from_jax`` converters.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from cycle_depth_estimation_tpu.config import Config as JaxConfig
from cycle_depth_estimation_tpu.config import (
    apply_model_defaults as jax_apply_model_defaults,
)
from cycle_depth_estimation_tpu.models import create_model as jax_create_model
from cycle_depth_estimation_tpu.models import networks as jn
from cycle_depth_estimation_tpu.ops.layers import Norm as JaxNorm
from cycle_depth_estimation_tpu.utils.torch_import import import_unet_generator
from cycle_depth_estimation_tpu_torch.config import (
    Config,
    apply_model_defaults,
    parse_args,
)
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.models import networks as pn
from cycle_depth_estimation_tpu_torch.ops.layers import BatchNorm, Norm
from cycle_depth_estimation_tpu_torch.utils.weights import (
    nlayer_discriminator_state_dict_from_jax,
    pix2pix_state_dicts_from_jax,
    unet_generator_state_dict_from_jax,
)


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


def _image(seed, n=2, size=64, c=3):
    return (np.random.RandomState(seed).rand(n, size, size, c) * 2 - 1
            ).astype(np.float32)


def _perturb_bn(variables, seed):
    """Random BatchNorm scale, bias and running statistics (the leaves
    under a ``norm`` key), so that eval mode and the statistics' update are
    tested on more than ones and zeros."""
    rng = np.random.RandomState(seed)
    draw = {"scale": (0.5, 1.5), "bias": (-0.3, 0.3), "mean": (-0.5, 0.5),
            "var": (0.5, 2.0)}

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if k == "norm":
                v = {n: rng.uniform(*draw[n], np.shape(a)).astype(np.float32)
                     for n, a in v.items()}
            elif isinstance(v, dict):
                v = walk(v)
            out[k] = v
        return out

    return {k: walk(jax.tree.map(np.asarray, v)) for k, v in variables.items()}


# ---------------------------------------------------------------------------
# Norm('batch')
# ---------------------------------------------------------------------------


def _bn_case(seed=0, shape=(2, 2, 2, 5)):
    """A small batch: N·H·W = 8, so torch's unbiased running variance is
    8/7 of the biased one that flax keeps."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    params = {"norm": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": rng.uniform(-0.3, 0.3, c).astype(np.float32)}}
    stats = {"norm": {"mean": rng.uniform(-0.5, 0.5, c).astype(np.float32),
                      "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}
    return x, params, stats


def _port_bn(params, stats, cls=BatchNorm):
    c = params["norm"]["scale"].shape[0]
    bn = cls(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["norm"]["scale"]))
        bn.bias.copy_(torch.from_numpy(params["norm"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["norm"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["norm"]["var"]))
    return bn


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_flax(train):
    x, params, stats = _bn_case()
    norm = JaxNorm("batch")
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, mut = norm.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        new = jax.tree.map(np.asarray, mut["batch_stats"])["norm"]
    else:
        want, new = norm.apply(variables, jnp.asarray(x), train=False), stats["norm"]
    bn = _port_bn(params, stats)
    bn.train(train)
    got = bn(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), new["mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), new["var"], rtol=1e-6)
    if train:  # flax: 0.9·old + 0.1·(biased batch variance)
        var_b = x.reshape(-1, x.shape[-1]).var(axis=0)
        np.testing.assert_allclose(
            bn.running_var.numpy(), 0.9 * stats["norm"]["var"] + 0.1 * var_b,
            rtol=1e-6)
        assert int(bn.num_batches_tracked) == 1


def test_torch_batch_norm_would_fail_the_running_variance_check():
    """torch's own BatchNorm2d moves the running variance toward the
    unbiased batch variance: the check above tells the two apart."""
    x, params, stats = _bn_case()
    _, mut = JaxNorm("batch").apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
    want = np.asarray(mut["batch_stats"]["norm"]["var"])
    bn = _port_bn(params, stats, cls=lambda c: torch.nn.BatchNorm2d(c))
    bn.train()
    bn(_nchw(x))
    assert not np.allclose(bn.running_var.numpy(), want, rtol=1e-6)
    assert np.abs(bn.running_var.numpy() / want - 1).max() > 1e-3


def test_batch_norm_factory_and_pre_041_state_dict():
    bn = Norm("batch", 4)
    assert isinstance(bn, BatchNorm) and bn.momentum == 0.1 and bn.eps == 1e-5
    with pytest.raises(ValueError):
        Norm("batch")
    old = {k: v for k, v in BatchNorm(4).state_dict().items()
           if k != "num_batches_tracked"}
    fresh = BatchNorm(4)
    fresh.load_state_dict(old)  # strict: the count is filled in as 0
    assert int(fresh.num_batches_tracked) == 0


# ---------------------------------------------------------------------------
# the U-Net
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["batch", "instance"])
def unet(request):
    norm = request.param
    x = _image(1)
    jg = jn.UnetGenerator(output_nc=3, num_downs=6, ngf=4, norm=norm)
    variables = _perturb_bn(jg.init(jax.random.key(2), jnp.asarray(x)), 3)
    g = pn.UnetGenerator(3, 3, num_downs=6, ngf=4, norm=norm)
    g.load_state_dict(unet_generator_state_dict_from_jax(variables, 6, norm))
    return dict(norm=norm, x=x, jg=jg, variables=variables, g=g)


@pytest.mark.parametrize("train", [False, True])
def test_unet_matches_jax(unet, train):
    jg, variables, x = unet["jg"], unet["variables"], unet["x"]
    g = pn.UnetGenerator(3, 3, num_downs=6, ngf=4, norm=unet["norm"])
    g.load_state_dict(unet["g"].state_dict())
    g.train(train)
    if train and unet["norm"] == "batch":
        want, mut = jg.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        stats = jax.tree.map(np.asarray, mut["batch_stats"])
    else:
        want = jg.apply(variables, jnp.asarray(x), train=train)
        stats = variables.get("batch_stats")
    got = g(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if stats:
        sd = unet_generator_state_dict_from_jax(
            {"params": variables["params"], "batch_stats": stats}, 6, "batch")
        for k, v in g.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), sd[k].numpy(),
                                           atol=1e-6, rtol=1e-5, err_msg=k)


def test_unet_state_dict_through_jax_importer(unet):
    sd = {k: v.numpy() for k, v in unet["g"].state_dict().items()}
    assert "model.model.1.model.3.model.3.model.3.model.3.model.1.weight" in sd
    back = import_unet_generator(sd, num_downs=6, norm=unet["norm"])
    want = unet["jg"].apply(jax.tree.map(jnp.asarray, back),
                            jnp.asarray(unet["x"]), train=False)
    with torch.no_grad():
        got = unet["g"].eval()(_nchw(unet["x"]))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_unet_dropout_rate_placement_and_eval_identity():
    g = pn.define_G(3, 3, 4, "unet_128", norm="batch", use_dropout=True,
                    generator=torch.Generator().manual_seed(0))
    plain = pn.define_G(3, 3, 4, "unet_128", norm="batch",
                        generator=torch.Generator().manual_seed(0))
    assert g.state_dict().keys() == plain.state_dict().keys()
    plain.load_state_dict(g.state_dict())
    levels = list(g._levels())
    with_dropout = [lvl for lvl, b in enumerate(levels)
                    if any(isinstance(m, torch.nn.Dropout) for m in b.model)]
    assert with_dropout == [4, 5]  # 4 <= level < num_downs - 1
    for lvl in with_dropout:  # last, right after the up norm
        mods = list(levels[lvl].model)
        assert isinstance(mods[-1], torch.nn.Dropout) and mods[-1].p == 0.5
        assert isinstance(mods[-2], torch.nn.BatchNorm2d)
    x = _nchw(_image(4, n=2, size=128))
    g.eval()
    plain.eval()
    with torch.no_grad():
        assert torch.equal(g(x), plain(x))
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(
        (float((o == 0).float().mean()), float((i[0] == 0).float().mean()))))
        for m in g.modules() if isinstance(m, torch.nn.Dropout)]
    g.train()
    torch.manual_seed(0)
    with torch.no_grad():
        y1, y2 = g(x), g(x)
    for h in hooks:
        h.remove()
    assert not torch.equal(y1, y2)
    for zero_out, zero_in in seen:  # about half of the values dropped
        assert 0.3 < zero_out - zero_in < 0.7


# ---------------------------------------------------------------------------
# the BatchNorm discriminator (JAX → port only: the JAX importer takes
# instance norm only)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_discriminator_matches_jax(train):
    x = _image(5, c=6)
    jd = jn.NLayerDiscriminator(ndf=8, n_layers=3, norm="batch")
    variables = _perturb_bn(jd.init(jax.random.key(6), jnp.asarray(x)), 7)
    d = pn.define_D(6, 8, "basic", norm="batch")
    assert not any(k.endswith("bias") for k in d.state_dict()
                   if k.startswith(("model.2.", "model.5.", "model.8.")))
    d.load_state_dict(nlayer_discriminator_state_dict_from_jax(
        variables["params"], 3, "batch", variables["batch_stats"]))
    d.train(train)
    if train:
        want, mut = jd.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        new = nlayer_discriminator_state_dict_from_jax(
            variables["params"], 3, "batch",
            jax.tree.map(np.asarray, mut["batch_stats"]))
    else:
        want, new = jd.apply(variables, jnp.asarray(x), train=False), None
    got = d(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for k, v in (new or {}).items():
        np.testing.assert_allclose(d.state_dict()[k].numpy(), v.numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# one pix2pix train step, the eval step and checkpoints against JAX
# ---------------------------------------------------------------------------

SMALL = dict(model="pix2pix", fine_size=128, ngf=4, ndf=4, net_g="unet_128",
             batch_size=2, no_dropout=True)


@pytest.fixture(scope="module")
def jax_p2p():
    cfg = jax_apply_model_defaults(JaxConfig(**SMALL), set(SMALL))
    assert (cfg.norm, cfg.no_lsgan, cfg.pool_size) == ("batch", True, 0)
    model = jax_create_model(cfg)
    state0 = jax.jit(model.init_state)(jax.random.key(0))
    rng = np.random.RandomState(0)
    a = (rng.rand(2, 128, 128, 3) * 2 - 1).astype(np.float32)
    b = (rng.rand(2, 128, 128, 3) * 2 - 1).astype(np.float32)
    batch = {"A": jnp.asarray(a), "B": jnp.asarray(b)}
    state1, metrics = model.train_step(state0, batch, jax.random.key(1))
    eval_metrics, visuals = model.eval_step(state1, batch)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(
        params0=np_tree(state0.params), stats0=np_tree(state0.batch_stats),
        params1=np_tree(state1.params), stats1=np_tree(state1.batch_stats),
        metrics={k: float(v) for k, v in metrics.items()},
        eval_metrics={k: float(v) for k, v in eval_metrics.items()},
        visuals={k: np.asarray(v) for k, v in visuals.items()},
        batch={"A": _nchw(a), "B": _nchw(b)})


def _port(jax_p2p, **kw):
    kw = {**SMALL, **kw}
    cfg = apply_model_defaults(Config(device="cpu", **kw), set(kw))
    model = create_model(cfg)
    state = model.init_state()
    for name, sd in pix2pix_state_dicts_from_jax(
            jax_p2p["params0"], jax_p2p["stats0"], cfg).items():
        state.nets[name].load_state_dict(sd)
    return cfg, model, state


def test_pix2pix_config_defaults():
    cfg = parse_args(["--model", "pix2pix", "--lambda_L1", "50"])
    assert (cfg.net_g, cfg.norm, cfg.dataset_mode, cfg.no_lsgan,
            cfg.pool_size, cfg.lambda_l1, cfg.no_dropout) == (
        "unet_256", "batch", "aligned", True, 0, 50.0, False)
    assert parse_args(["--model", "pix2pix", "--norm", "instance"]).norm == \
        "instance"


def test_pix2pix_train_step_matches_jax(jax_p2p):
    cfg, model, state = _port(jax_p2p)
    state, metrics = model.train_step(state, jax_p2p["batch"])
    assert state.step == 1 and set(metrics) == set(model.loss_names)
    for k, want in jax_p2p["metrics"].items():
        assert float(metrics[k]) == pytest.approx(want, rel=1e-5), k

    want = pix2pix_state_dicts_from_jax(jax_p2p["params1"], jax_p2p["stats1"],
                                        cfg)
    before = pix2pix_state_dicts_from_jax(jax_p2p["params0"],
                                          jax_p2p["stats0"], cfg)
    flipped = near_eps = total = n_stats = 0
    for name, net in state.nets.items():
        assert not pn.biases_before_norm(net)  # BatchNorm: no such bias
        bound = 2 * cfg.lr + 1e-5
        for key, got in net.state_dict().items():
            if key.endswith("num_batches_tracked"):
                # G's statistics move once a step, D's three times
                assert int(got) == (1 if name == "G" else 3), (name, key)
                continue
            ref, p0, got = want[name][key].numpy(), before[name][key].numpy(), \
                got.numpy()
            assert not np.array_equal(got, p0), (name, key)
            if "running" in key:
                np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5,
                                           err_msg=f"{name} {key}")
                n_stats += 1
                continue
            diff = np.abs(got - ref)
            assert np.all(diff <= bound), (name, key, diff.max())
            # Adam's first step is lr·g/(|g| + 1e-8), about ±lr: where the
            # two frameworks' gradients differ in sign they differ by 2·lr,
            # and where |g| is within ten times eps (the step is under
            # 0.9·lr) the rounding of g moves the step's size
            past = diff > 1e-5
            flip = past & (np.sign(got - p0) != np.sign(ref - p0))
            small = past & ~flip & (np.abs(ref - p0) < 0.9 * cfg.lr)
            assert np.all(~past | flip | small), (name, key, diff.max())
            flipped += int(flip.sum())
            near_eps += int(small.sum())
            total += diff.size
    assert n_stats == 2 * (2 * 7 - 3) + 2 * 3  # 11 norms of G, 3 of D
    assert flipped + near_eps <= 1e-3 * total, (flipped, near_eps, total)


def test_pix2pix_eval_step_matches_jax(jax_p2p):
    cfg, model, state = _port(jax_p2p)
    model.train_step(state, jax_p2p["batch"])
    metrics, visuals = model.eval_step(state, jax_p2p["batch"])
    for k, want in jax_p2p["eval_metrics"].items():
        assert float(metrics[k]) == pytest.approx(want, rel=1e-4), k
    assert set(visuals) == set(model.visual_names)
    for k, want in jax_p2p["visuals"].items():
        np.testing.assert_allclose(_nhwc(visuals[k]), want, atol=1e-4,
                                   err_msg=k)


def test_pix2pix_checkpoint_round_trip(jax_p2p, tmp_path):
    cfg, model, state = _port(jax_p2p, checkpoints_dir=str(tmp_path))
    state, _ = model.train_step(state, jax_p2p["batch"])
    model.save_networks(state, 3)
    assert sorted(p.name for p in tmp_path.glob("experiment_name/3_*")) == [
        "3_net_D.pth", "3_net_G.pth", "3_train_state.pth"]
    loaded = model.load_networks(model.init_state(seed=9), 3)
    assert loaded.step == 1
    for name, net in state.nets.items():
        for k, v in net.state_dict().items():
            assert torch.equal(loaded.nets[name].state_dict()[k], v), (name, k)
    _, m1 = model.train_step(state, jax_p2p["batch"])
    _, m2 = model.train_step(loaded, jax_p2p["batch"])
    for k in m1:
        assert float(m1[k]) == float(m2[k]), k


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _write_ab(folder, n, size, seed):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (size, 2 * size, 3), np.uint8)
                        ).save(os.path.join(folder, f"ab_{i:02d}.png"))


def test_pix2pix_train_and_test_cli(tmp_path):
    from cycle_depth_estimation_tpu_torch.test import main as test_main
    from cycle_depth_estimation_tpu_torch.train import main as train_main

    root = tmp_path / "facades"
    _write_ab(root / "train", 4, 136, 0)
    _write_ab(root / "test", 2, 128, 1)
    common = ["--dataroot", str(root), "--checkpoints_dir",
              str(tmp_path / "ck"), "--name", "p2p", "--model", "pix2pix",
              "--device", "cpu", "--netG", "unet_128", "--ngf", "4", "--ndf",
              "4", "--load_size", "136", "--fine_size", "128",
              "--batch_size", "2", "--niter", "1", "--niter_decay", "0",
              "--save_epoch_freq", "1", "--print_freq", "2",
              "--display_freq", "4", "--num_threads", "2"]
    state = train_main(common)
    expr = tmp_path / "ck" / "p2p"
    assert state.step == 2
    for f in ("1_net_G.pth", "1_net_D.pth", "1_train_state.pth",
              "latest_net_G.pth", "loss_log.txt", "web/index.html"):
        assert (expr / f).is_file(), f
    assert "G_L1:" in (expr / "loss_log.txt").read_text()
    resumed = train_main(common + ["--continue_train", "--epoch_count", "2",
                                   "--niter", "2"])
    assert resumed.step == 4 and (expr / "2_net_D.pth").is_file()

    web_dir = test_main(["--dataroot", str(root), "--model", "pix2pix",
                         "--checkpoints_dir", str(tmp_path / "ck"),
                         "--name", "p2p", "--netG", "unet_128", "--ngf", "4",
                         "--ndf", "4", "--fine_size", "128", "--device",
                         "cpu", "--results_dir", str(tmp_path / "results")])
    images = sorted(os.listdir(os.path.join(web_dir, "images")))
    assert images == [f"ab_{i:02d}_{k}.png" for i in range(2)
                      for k in ("fake_B", "real_A", "real_B")]


def _session_processes(sid):
    """Running processes of the session ``sid`` (zombies left out)."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        state, _, _, session = stat[stat.rindex(")") + 2:].split()[:4]
        if state != "Z" and int(session) == sid:
            found.append(int(pid))
    return found


@pytest.mark.skipif(not os.path.isdir("/proc"), reason="reads /proc")
def test_pix2pix_train_cli_over_worker_processes_ends_every_process(tmp_path):
    """``python -m ...train --worker_procs 2`` in a session of its own: its
    loader workers, their forkserver and Python's resource tracker all end
    with it."""
    import subprocess
    import sys
    import time

    root = tmp_path / "facades"
    _write_ab(root / "train", 4, 136, 0)
    # output to a file: a process left over would hold a pipe open
    log = open(tmp_path / "cli.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cycle_depth_estimation_tpu_torch.train",
         "--dataroot", str(root), "--checkpoints_dir", str(tmp_path / "ck"),
         "--name", "p2p", "--model", "pix2pix", "--device", "cpu", "--netG",
         "unet_128", "--ngf", "4", "--ndf", "4", "--load_size", "136",
         "--fine_size", "128", "--batch_size", "2", "--niter", "1",
         "--niter_decay", "0", "--save_epoch_freq", "1", "--worker_procs",
         "2", "--device_aug"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    log.seek(0)
    assert proc.returncode == 0, log.read()[-3000:]
    assert (tmp_path / "ck" / "p2p" / "1_net_G.pth").is_file()
    deadline = time.monotonic() + 10
    while _session_processes(proc.pid) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = _session_processes(proc.pid)
    for pid in left:
        os.kill(pid, 9)
    assert not left
