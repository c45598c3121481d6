"""The port's spatial parallelism (``parallel/spatial.py``, ``--parallel
sp``) against one process and the JAX package, on the CPU: the split
InstanceNorm's plain entries on uneven rows; then, in one world of four
spawned gloo ranks, every conv kind of the CycleGAN nets and the
InstanceNorm with the height split over 2 and 4 ranks (forward, input and
weight gradients), the generator on (2, 2) and (1, 4) meshes against
JAX's H-sharded forward, and the CycleGAN step under dp×sp (and with
``--zero opt`` or ``--remat``) against the port's one process and the JAX
step.
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
from cycle_depth_estimation_tpu.models.networks import (
    ResnetGenerator as JaxResnetGenerator,
)
from cycle_depth_estimation_tpu.parallel import host_shard_batch as jax_hsb
from cycle_depth_estimation_tpu.parallel import make_mesh as jax_make_mesh
from cycle_depth_estimation_tpu.parallel import replicated as jax_replicated
from cycle_depth_estimation_tpu.parallel.spatial import (
    make_2d_mesh as jax_make_2d_mesh,
    shard_spatial as jax_shard_spatial,
    spatial_sharding as jax_spatial_sharding,
)
from cycle_depth_estimation_tpu_torch.config import Config, apply_model_defaults
from cycle_depth_estimation_tpu_torch.ops.kernels import instance_norm as kin
from cycle_depth_estimation_tpu_torch.parallel import dryrun
from cycle_depth_estimation_tpu_torch.parallel.mesh import (row_range,
                                                            spatial_rows)
from cycle_depth_estimation_tpu_torch.parallel.spatial import (
    spatial_sharding)
from cycle_depth_estimation_tpu_torch.utils.weights import (
    cycle_gan_state_dicts_from_jax,
    resnet_generator_state_dict_from_jax,
)

import torch_port_spatial_ranks as ranks

# test_torch_port_parallel's CycleGAN config: its JAX step serves here
CYC = dict(model="cycle_gan", fine_size=32, ngf=4, ndf=4,
           net_g="resnet_3blocks", batch_size=8, pool_size=16,
           d_steps_per_g=2)
SP = {"mesh_shape": [2, 2], "parallel": "sp"}
# the same step at ngf 8, every ReLU/LeakyReLU mask taken from one process
CYC8 = {**CYC, "ngf": 8, "ndf": 8}
OP_LAYOUTS = {2: {"mesh_shape": [2, 2]}, 4: {"mesh_shape": [1, 4]}}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


# ---- rules, without ranks ---------------------------------------------------
def test_row_rule_splits_uneven_planes_by_one_row():
    assert [row_range(31, 2, r) for r in range(2)] == [(0, 15), (15, 31)]
    assert [row_range(30, 4, r) for r in range(4)] == [
        (0, 7), (7, 15), (15, 22), (22, 30)]
    assert row_range(256, 2, 1) == (128, 256)
    x = torch.arange(2 * 3 * 31 * 5).reshape(2, 3, 31, 5)
    got = spatial_rows({"x": x, "lab": x[:, 0], "paths": ["a", "b"]},
                       size=2, index=1)
    assert torch.equal(got["x"], x[:, :, 15:])
    assert torch.equal(got["lab"], x[:, 0, 15:])
    assert got["paths"] == ["a", "b"]


def test_spatial_sharding_error_matches_jax():
    mesh = jax_make_mesh()  # data only
    with pytest.raises(ValueError) as want:
        jax_spatial_sharding(mesh)
    with pytest.raises(ValueError) as got:
        spatial_sharding(types.SimpleNamespace(mesh_dim_names=("data",)))
    assert str(got.value) == str(want.value)
    from torch.distributed.tensor import Shard

    two = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert spatial_sharding(two) == (Shard(0), Shard(2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_entries_equal_the_whole_plane_on_16_15_rows(dtype):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(2, 3, 31, 9, generator=g) * 3 + 1).to(dtype)
    dy = torch.randn(2, 3, 31, 9, generator=g).to(dtype)
    parts = [x[:, :, :16], x[:, :, 16:]]
    dparts = [dy[:, :, :16], dy[:, :, 16:]]
    count = 31 * 9
    sums = sum(kin.plain_in_stats(p) for p in parts)
    outs = [kin.plain_in_apply(p, sums, count) for p in parts]
    want = kin.plain_instance_norm(x)
    stats = kin.plain_instance_norm_stats(x)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else \
        dict(atol=2 ** -6, rtol=2 ** -7)
    torch.testing.assert_close(torch.cat([y for y, _ in outs], 2), want,
                               **tol)
    torch.testing.assert_close(outs[0][1][0], stats[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(outs[1][1][1], stats[1], atol=1e-5, rtol=1e-5)
    st = outs[0][1]
    bsums = sum(kin.plain_in_bwd_stats(p, d, st)
                for p, d in zip(parts, dparts))
    dx = torch.cat([kin.plain_in_bwd_apply(p, d, st, bsums, count)
                    for p, d in zip(parts, dparts)], 2)
    torch.testing.assert_close(
        dx, kin.plain_instance_norm_backward(x, dy, stats=stats), **tol)
    # the wrappers take the plain versions on a CPU tensor
    y, st2 = kin.in_apply(parts[0], sums, count)
    assert torch.equal(y, outs[0][0]) and torch.equal(st2[0], st[0])
    assert torch.equal(kin.in_stats(parts[1]), kin.plain_in_stats(parts[1]))


# ---- four ranks ---------------------------------------------------------------
@pytest.fixture(scope="module")
def world():
    # JAX: the generator sharded over a (2, 4) mesh (tests/test_parallel.py)
    jmesh = jax_make_2d_mesh(data=2, model=4)
    jg = JaxResnetGenerator(output_nc=3, ngf=4, n_blocks=2)
    xg = jnp.asarray(np.random.RandomState(0).rand(2, 64, 64, 3),
                     jnp.float32)
    gparams = jg.init(jax.random.key(0), xg)
    y_jax = np.asarray(jax.jit(jg.apply)(
        jax.device_put(gparams, jax_replicated(jmesh)),
        jax_shard_spatial(jmesh, xg)))
    g_sd = resnet_generator_state_dict_from_jax(
        jax.tree.map(np.asarray, gparams["params"]), 2, False)

    # JAX: the CycleGAN step of test_torch_port_parallel
    cfg = jax_apply_model_defaults(JaxConfig(**CYC))
    model = jax_create_model(cfg)
    state0 = jax.jit(model.init_state)(jax.random.key(0))
    rng = np.random.RandomState(0)
    a = (rng.rand(8, 32, 32, 3) * 2 - 1).astype(np.float32)
    b = (rng.rand(8, 32, 32, 3) * 2 - 1).astype(np.float32)
    mesh = jax_make_mesh()
    _, metrics = model.train_step(
        jax.device_put(state0, jax_replicated(mesh)),
        jax_hsb(mesh, {"img_source": a, "img_target": b}),
        jax.random.key(1))
    pcfg = apply_model_defaults(Config(device="cpu", **CYC))
    init_sd = cycle_gan_state_dicts_from_jax(
        jax.tree.map(np.asarray, state0.params), pcfg)
    batch = {"img_source": _nchw(a), "img_target": _nchw(b)}

    ops = ranks.op_inputs()
    cases = {f"{name} M={m}": (ranks.op_case, (name, x, w, layout))
             for m, layout in OP_LAYOUTS.items()
             for name, (x, w) in ops.items()}
    xt = _nchw(np.asarray(xg))
    for shape in ([2, 2], [1, 4]):
        cases[f"generator {shape}"] = (dryrun.sp_forward_case, (
            xt, {"mesh_shape": shape}, 4, 2, g_sd, True))
    cases["step"] = (dryrun.model_step,
                     (CYC, batch, SP, init_sd, 1e-2, 1, True))
    cases["step jax eps"] = (dryrun.model_step,
                             (CYC, batch, SP, init_sd, None, 1, False))
    cases["step zero opt"] = (dryrun.model_step,
                              (CYC, batch, {**SP, "zero": "opt"}, init_sd,
                               1e-2, 1, True))
    # --remat runs each generator forward again in backward, its halo
    # exchanges and statistic all-reduces with it
    cases["step remat"] = (dryrun.model_step,
                           ({**CYC, "remat": True}, batch, SP, init_sd, 1e-2,
                            1, True))
    one8 = ranks.masked_step(CYC8, batch, {}, None, 1e-2)
    cases["step ngf 8 masks fixed"] = (ranks.masked_step, (
        CYC8, batch, SP, None, 1e-2, one8.pop("masks")))
    got = dryrun.spawn(dryrun.run_cases, 4, (cases,), timeout=240)
    one = {name: ranks.op_reference(name, x, w)
           for name, (x, w) in ops.items()}
    one["generator"] = dryrun.sp_forward_case(xt, {}, 4, 2, g_sd, True)
    one["step"] = dryrun.model_step(CYC, batch, {}, init_sd, 1e-2, 1, True)
    one["step ngf 8 masks fixed"] = one8
    return dict(ranks=got, one=one, y_jax=y_jax,
                jax_metrics={k: float(v) for k, v in metrics.items()})


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", list(ranks.op_modules()))
def test_each_split_op_equals_the_whole_plane(world, name, m):
    want = world["one"][name]
    for r in world["ranks"]:
        got = r[f"{name} M={m}"]
        assert _rel(got["y"], want["y"]) <= 1e-5, "y"
        assert _rel(got["dx"], want["dx"]) <= 1e-5, "dx"
        for k, g in want["grads"].items():
            assert _rel(got["grads"][k], g) <= 1e-5, k


@pytest.mark.parametrize("shape", ["[2, 2]", "[1, 4]"])
def test_sp_generator_matches_jax_sharded_forward(world, shape):
    one = world["one"]["generator"]
    for r in world["ranks"]:
        got = r[f"generator {shape}"]
        np.testing.assert_allclose(got["y"].numpy().transpose(0, 2, 3, 1),
                                   world["y_jax"], atol=2e-5, rtol=1e-4)
        assert _rel(got["dx"], one["dx"]) <= 1e-5
        big = max(float(g.abs().max()) for g in one["grads"].values())
        for k, g in one["grads"].items():
            assert float((got["grads"][k] - g).abs().max()) <= 1e-5 * big, k


@pytest.mark.parametrize("case", ["step", "step zero opt", "step remat",
                                  "step ngf 8 masks fixed"])
def test_sp_step_equals_one_process(world, case):
    # at ngf 8 the sp forward's ~1e-6 rounding flips a few ReLU/LeakyReLU
    # masks on some inputs, which moves single gradients past 1e-5 of the
    # largest; with every mask taken from one process the step holds at
    # the same bar (the unmasked ngf 4 cases need no such help)
    one = world["one"].get(case, world["one"]["step"])
    big = max(float(g.abs().max()) for g in one["grads"].values())
    for r in world["ranks"]:
        got = r[case]
        for k, g in one["grads"].items():
            assert float((got["grads"][k] - g).abs().max()) <= 1e-5 * big, k
        for k, v in one["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-5,
                                                      abs=1e-7), k
        for name, sd in one["params"].items():
            dryrun.pooled_params_close(got["params"][name], sd, 2e-4,
                                       f"{case} {name}")
        # the split entries ran, never the fused pair: on the CPU no kernel
        # launches, so both counts stay 0
        assert got["launches"] == [(0, 0)]
    a, b = (world["ranks"][i][case]["params"] for i in (0, 3))
    for name, sd in a.items():
        for k, v in sd.items():
            assert torch.equal(v, b[name][k]), (name, k)


def test_sp_step_losses_match_the_jax_step(world):
    for r in world["ranks"]:
        got = r["step jax eps"]["metrics"]
        for k, want in world["jax_metrics"].items():
            assert got[k] == pytest.approx(want, rel=1e-4), k
