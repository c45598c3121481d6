"""The port's ``parallel/`` against the JAX package's, on the CPU: the ZeRO
rule, ``memory_report`` and ``tp_spec`` against JAX's on the same shapes;
``make_mesh`` and the batch split's errors; and, on two spawned gloo ranks
(one world for every case, with a timeout), the CycleGAN step under ``dp``
against one process and against the JAX step on the 8-device CPU mesh,
``--zero opt|fsdp`` and ``--parallel tp`` against the replicated step, the
trunk split's forward and gradients, the global-batch ``BatchNorm``, masked
means and the replicated ``ImagePool``.
"""

import types

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
from cycle_depth_estimation_tpu.models.base_model import ModelState
from cycle_depth_estimation_tpu.models.networks import (
    ResnetGenerator as JaxResnetGenerator,
)
from cycle_depth_estimation_tpu.ops.layers import Norm as JaxNorm
from cycle_depth_estimation_tpu.parallel import host_shard_batch as jax_hsb
from cycle_depth_estimation_tpu.parallel import make_mesh as jax_make_mesh
from cycle_depth_estimation_tpu.parallel import replicated as jax_replicated
from cycle_depth_estimation_tpu.parallel.tensor import tp_spec as jax_tp_spec
from cycle_depth_estimation_tpu.parallel.zero import (
    leaf_zero_sharding as jax_leaf_zero_sharding,
    memory_report as jax_memory_report,
)
from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.models import create_model
from cycle_depth_estimation_tpu_torch.models.networks import (
    ResnetGenerator,
    biases_before_norm,
)
from cycle_depth_estimation_tpu_torch.parallel import dryrun, mesh as pmesh
from cycle_depth_estimation_tpu_torch.parallel.tensor import (
    tp_shardings,
    tp_spec,
)
from cycle_depth_estimation_tpu_torch.parallel.zero import (
    leaf_zero_sharding,
    memory_report,
    shard_tree_zero,
    state_trees,
)
from cycle_depth_estimation_tpu_torch.utils.weights import (
    cycle_gan_state_dicts_from_jax,
)

import torch_port_parallel_ranks as ranks

CYC = dict(model="cycle_gan", fine_size=32, ngf=4, ndf=4,
           net_g="resnet_3blocks", batch_size=8, pool_size=16,
           d_steps_per_g=2)
SHAPES = [(16, 3, 3, 64), (24, 3, 3, 7), (), (3, 3, 3, 7)]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


# ---- pure rules against JAX -------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
def test_zero_rule_matches_jax_on_the_four_shapes(shape):
    leaf = np.zeros(shape, np.float32)
    want = jax_leaf_zero_sharding(jax_make_mesh(), leaf).spec
    assert leaf_zero_sharding(leaf, 8) == tuple(want)


@pytest.mark.parametrize("n", [2, 8])
def test_zero_rule_matches_jax_on_every_cycle_gan_leaf(n):
    cfg = jax_apply_model_defaults(JaxConfig(**CYC))
    state = jax.jit(jax_create_model(cfg).init_state)(jax.random.key(0))
    mesh = jax_make_mesh([n], devices=jax.devices()[:n])
    port = create_model(apply_model_defaults(Config(device="cpu", **CYC)))
    pstate = port.init_state()
    leaves = (jax.tree.leaves(state.params) + jax.tree.leaves(state.opt_states)
              + [p for net in pstate.nets.values() for p in net.parameters()])
    for leaf in leaves:
        want = tuple(jax_leaf_zero_sharding(mesh, np.zeros(leaf.shape)).spec)
        assert leaf_zero_sharding(leaf, n) == want, leaf.shape
    # the same split decision on each framework's layout of a weight
    got = memory_report(state_trees(pstate), n, shard_params=True)
    want = jax_memory_report(state, mesh, shard_params=True)
    for k in ("replicated_per_device_bytes", "zero_per_device_bytes"):
        assert got[k]["params"] == want[k]["params"], k


def test_shard_tree_zero_takes_the_rank_slice():
    a = torch.arange(16 * 3 * 64, dtype=torch.float32).reshape(16, 3, 64)
    tree = {"a": a, "b": torch.zeros(3, 7), "c": torch.zeros(())}
    got = shard_tree_zero(tree, 8, 3)
    assert torch.equal(got["a"], a[:, :, 24:32])  # the largest, 64, split
    assert got["b"] is tree["b"] and got["c"] is tree["c"]


def test_placements_split_the_batch_over_data():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), ndim=2)
    assert pmesh.batch_sharding(mesh) == (Shard(0), Replicate())
    assert pmesh.replicated(mesh) == (Replicate(), Replicate())


@pytest.mark.parametrize("shard_params", [False, True])
def test_memory_report_matches_jax_dict(shard_params):
    tree = {f"w{i}": np.zeros(s, np.float32) for i, s in enumerate(SHAPES)}
    stats = {"mean": np.zeros((64,), np.float32)}
    state = ModelState(params=tree, batch_stats=stats,
                       opt_states={"mu": tree, "nu": tree}, pools={},
                       step=np.zeros((), np.int32))
    want = jax_memory_report(state, jax_make_mesh(), shard_params=shard_params)
    trees = {"params": list(tree.values()),
             "opt_states": list(tree.values()) * 2,
             "batch_stats": list(stats.values())}
    assert memory_report(trees, 8, shard_params=shard_params) == want


def test_tp_spec_matches_jax_on_the_port_names():
    g = JaxResnetGenerator(output_nc=3, ngf=4, n_blocks=2)
    params = g.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        spec = tuple(jax_tp_spec(path, leaf))
        # the HWIO kernel's O (3) or I (2), or the bias, → the OIHW dim
        dim = (None if "model" not in spec else
               {3: 0, 2: 1}[spec.index("model")] if leaf.ndim == 4 else 0)
        want["/".join(str(k.key) for k in path)] = dim
    net = ResnetGenerator(ngf=4, n_blocks=2)
    names = {id(m): n for n, m in net.named_modules()}
    shardings = tp_shardings(net)
    seen = set()
    for site, conv in net.site_convs().items():
        for pname, jname in (("weight", "kernel"), ("bias", "bias")):
            key = f"{site.replace('.', '/')}/{jname}"
            assert tp_spec(site, pname) == want[key], key
            assert shardings[f"{names[id(conv)]}.{pname}"] == want[key], key
            seen.add(key)
    assert seen == set(want)


@pytest.mark.parametrize("shape,names,world", [
    ([2, 2], ("data",), 8), ([16], None, 8), ([4, 4], None, 8)])
def test_make_mesh_errors_match_jax(shape, names, world):
    with pytest.raises(ValueError) as want:
        jax_make_mesh(shape, names, devices=jax.devices()[:world])
    with pytest.raises(ValueError) as got:
        pmesh.mesh_layout(shape, names, world)
    assert str(got.value) == str(want.value)


def test_make_mesh_defaults_and_refuses_idle_ranks():
    assert pmesh.mesh_layout(None, None, 4) == ([4], ("data",))
    assert pmesh.mesh_layout([2, 2], None, 4) == ([2, 2], ("data", "model"))
    with pytest.raises(ValueError, match="uses 2 of 4 ranks"):
        pmesh.mesh_layout([2], None, 4)


def test_host_shard_batch_rows_and_error():
    batch = {"x": torch.arange(8).reshape(8, 1), "paths": list("abcdefgh")}
    got = pmesh.host_shard_batch(batch, "cpu", size=4, index=2)
    assert got["x"].flatten().tolist() == [4, 5]
    assert got["paths"] == ["e", "f"]
    with pytest.raises(ValueError) as err:
        pmesh.shard_batch({"x": torch.zeros(6)}, size=4, index=0)
    assert str(err.value) == (
        "global batch 6 is not divisible by process_count 4; set "
        "--batch_size to a multiple of the process count (drop_last "
        "already removes partial batches)")


# ---- two ranks -------------------------------------------------------------
@pytest.fixture(scope="module")
def world():
    cfg = jax_apply_model_defaults(JaxConfig(**CYC))
    model = jax_create_model(cfg)
    state0 = jax.jit(model.init_state)(jax.random.key(0))
    rng = np.random.RandomState(0)
    a = (rng.rand(8, 32, 32, 3) * 2 - 1).astype(np.float32)
    b = (rng.rand(8, 32, 32, 3) * 2 - 1).astype(np.float32)
    mesh = jax_make_mesh()
    sharded = jax_hsb(mesh, {"img_source": a, "img_target": b})
    state1, metrics = model.train_step(
        jax.device_put(state0, jax_replicated(mesh)), sharded,
        jax.random.key(1))
    pcfg = apply_model_defaults(Config(device="cpu", **CYC))
    init_sd = cycle_gan_state_dicts_from_jax(
        jax.tree.map(np.asarray, state0.params), pcfg)
    batch = {"img_source": _nchw(a), "img_target": _nchw(b)}

    g = torch.Generator().manual_seed(3)
    tp_x = torch.rand(4, 3, 32, 32, generator=g)
    bn = (torch.randn(8, 4, 6, 6, generator=g) * 2 + 1,
          torch.rand(4, generator=g) + 0.5, torch.randn(4, generator=g),
          torch.randn(8, 4, 6, 6, generator=g))
    labels = torch.randint(0, 5, (8, 6, 6), generator=g)
    labels[:4, :5] = 255  # rank 0's rows mostly ignored, rank 1's not
    ce = (torch.randn(8, 5, 6, 6, generator=g), labels)
    pool = ([torch.rand(4, 3, 4, 4, generator=g) for _ in range(4)], 6, 5)
    gather = (torch.randn(4, 3, generator=g), torch.randn(4, 3, generator=g))
    tp = dict(ngf=4, net_g="resnet_3blocks")
    got = dryrun.spawn(ranks.all_cases, 2,
                       (CYC, batch, init_sd, tp, tp_x, bn, ce, pool, gather),
                       timeout=240)
    one = {"dp": dryrun.model_step(CYC, batch, {}, init_sd),
           "dp_eps": dryrun.model_step(CYC, batch, {}, init_sd, 1e-2),
           "tp": dryrun.tp_case(tp, tp_x, {}),
           "bn": ranks.batch_norm_case(*bn),
           "ce": ranks.cross_entropy_case(*ce),
           "pool": ranks.pool_case(*pool)}
    return dict(ranks=got, one=one, bn=bn, pcfg=pcfg, gather=gather,
                jax_params1=cycle_gan_state_dicts_from_jax(
                    jax.tree.map(np.asarray, state1.params), pcfg),
                jax_params0=init_sd,
                jax_metrics={k: float(v) for k, v in metrics.items()})


def _adam_close(got, want, before, cfg):
    """The CycleGAN step test's bounds: every element within 2·lr a step
    of Adam's moves, and elements whose update differs in sign ≤ 1e-3 (the
    biases before an InstanceNorm, whose gradient is rounding, aside)."""
    nets = create_model(cfg).init_state().nets
    flipped = total = 0
    for name, sd in want.items():
        steps = 1 if name.startswith("G") else cfg.d_steps_per_g
        bound = 2 * cfg.lr * steps + 1e-5
        noise = biases_before_norm(nets[name])
        for key, ref in sd.items():
            if not ref.is_floating_point():
                continue
            p0, out = before[name][key], got[name][key]
            diff = (out - ref).abs()
            assert float(diff.max()) <= bound, (name, key)
            if key in noise:
                continue
            flip = (diff > 1e-5) & ((out - p0).sign() != (ref - p0).sign())
            flipped += int(flip.sum())
            total += diff.numel()
    assert flipped <= 1e-3 * total, (flipped, total)


def test_dp_step_on_two_ranks_equals_one_process_and_jax(world):
    r0, r1 = (r["dp"] for r in world["ranks"])
    for name, sd in r0["params"].items():  # every rank holds one state
        for k, v in sd.items():
            assert torch.equal(v, r1["params"][name][k]), (name, k)
    one, cfg = world["one"]["dp"], world["pcfg"]
    _adam_close(r0["params"], one["params"], world["jax_params0"], cfg)
    _adam_close(r0["params"], world["jax_params1"], world["jax_params0"], cfg)
    for k, want in world["jax_metrics"].items():
        assert r0["metrics"][k] == pytest.approx(want, rel=1e-4), k
        assert r0["metrics"][k] == pytest.approx(one["metrics"][k],
                                                 rel=1e-5), k


@pytest.mark.parametrize("case", ["zero_opt", "zero_fsdp", "tp_step"])
def test_layouts_step_equals_the_replicated_step(world, case):
    want = world["one"]["dp_eps"]["params"]
    for r in world["ranks"]:
        for name, sd in r[case]["params"].items():
            for k, v in sd.items():
                np.testing.assert_allclose(v.numpy(), want[name][k].numpy(),
                                           atol=1e-6, rtol=1e-5,
                                           err_msg=f"{case} {name} {k}")


def test_zero_splits_the_moments_and_fsdp_the_parameters(world):
    r = world["ranks"][0]
    dp = r["dp_eps"]["resident_bytes"]
    opt = r["zero_opt"]["resident_bytes"]
    fsdp = r["zero_fsdp"]["resident_bytes"]
    assert opt["opt_states"] < 0.6 * dp["opt_states"]
    assert opt["params"] == dp["params"]
    assert fsdp["params"] < 0.6 * dp["params"]
    rep = r["zero_fsdp"]["memory_report"]
    assert rep["zero_per_device_bytes"]["params"] < \
        0.6 * rep["replicated_per_device_bytes"]["params"]


def test_tp_forward_and_gradients_equal_the_unsharded_net(world):
    one = world["one"]["tp"]
    for r in world["ranks"]:
        got = r["tp"]
        np.testing.assert_allclose(got["y"].numpy(), one["y"].numpy(),
                                   atol=2e-5)
        for k, g in one["grads"].items():
            np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(),
                                       atol=2e-5, err_msg=k)
        for k, v in one["params"].items():
            assert torch.equal(got["params"][k], v), k


def test_batch_norm_uses_the_global_batch(world):
    x, w, b, r = world["bn"]
    one = world["one"]["bn"]
    for got in (rk["bn"] for rk in world["ranks"]):
        for k in ("y", "dx", "running_mean", "running_var"):
            np.testing.assert_allclose(got[k].numpy(), one[k].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
        # each rank's loss is its rows' part; the average of the ranks'
        # gradients is half the global sum's
        for k in ("dw", "db"):
            np.testing.assert_allclose(2 * got[k].numpy(), one[k].numpy(),
                                       atol=1e-4, rtol=1e-5, err_msg=k)
        assert got["count"] == 1
    # and the JAX BatchNorm on the global batch
    xj = jnp.asarray(x.numpy().transpose(0, 2, 3, 1))
    norm = JaxNorm("batch")
    v = norm.init(jax.random.key(0), xj, train=True)
    v = {"params": {"norm": {"scale": jnp.asarray(w.numpy()),
                             "bias": jnp.asarray(b.numpy())}},
         "batch_stats": v["batch_stats"]}
    y, upd = norm.apply(v, xj, train=True, mutable=["batch_stats"])
    got = world["ranks"][1]["bn"]
    np.testing.assert_allclose(got["y"].numpy().transpose(0, 2, 3, 1),
                               np.asarray(y), atol=1e-5, rtol=1e-5)
    stats = upd["batch_stats"]["norm"]
    np.testing.assert_allclose(got["running_mean"].numpy(),
                               np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(got["running_var"].numpy(),
                               np.asarray(stats["var"]), atol=1e-5)


def test_cross_entropy_with_uneven_masks_is_the_global_mean(world):
    one = world["one"]["ce"]
    for got in (r["ce"] for r in world["ranks"]):
        assert got["loss"] == pytest.approx(one["loss"], rel=1e-6)
        assert got["acc"] == pytest.approx(one["acc"], rel=1e-6)
        # each rank's loss reads the global sum: its gradient is twice
        # the global mean's, and sync_grads' average halves it
        np.testing.assert_allclose(got["dlogits"].numpy() / 2,
                                   one["dlogits"].numpy(), atol=1e-7,
                                   rtol=1e-5)


def test_image_pool_stays_replicated(world):
    one = world["one"]["pool"]
    assert one["count"] == 6
    for got in (r["pool"] for r in world["ranks"]):
        assert got["count"] == one["count"]
        assert torch.equal(got["images"], one["images"])
        for a, b in zip(got["outs"], one["outs"]):
            assert torch.equal(a, b)


def test_all_gather_is_differentiable(world):
    x, w = world["gather"]
    for r in world["ranks"]:
        assert torch.equal(r["gather"]["y"], x)
        # both ranks' losses read every row: each row's gradient sums them
        assert torch.allclose(r["gather"]["dx"], 2 * w)
