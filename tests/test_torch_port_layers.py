"""The port's layers and ResnetGenerator against the JAX package (CPU, fp32).

Weights cross both ways: JAX params through
``resnet_generator_state_dict_from_jax`` into the port, and the port's
``state_dict()`` through the JAX package's own ``import_resnet_generator``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cycle_depth_estimation_tpu.models.networks import (
    ResnetGenerator as JaxResnetGenerator,
)
from cycle_depth_estimation_tpu.ops.layers import InstanceNorm as JaxInstanceNorm
from cycle_depth_estimation_tpu.ops.layers import reflect_pad as jax_reflect_pad
from cycle_depth_estimation_tpu.utils.torch_import import import_resnet_generator
from cycle_depth_estimation_tpu_torch.models.networks import (
    ResnetGenerator,
    define_G,
)
from cycle_depth_estimation_tpu_torch.ops.layers import (
    InstanceNorm,
    Norm,
    reflect_pad,
)
from cycle_depth_estimation_tpu_torch.utils.weights import (
    resnet_generator_state_dict_from_jax,
)
from tools.convergence_compare import build_torch_resnet_g


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _image(seed, n=2, size=32):
    return (np.random.RandomState(seed).rand(n, size, size, 3) * 2 - 1
            ).astype(np.float32)


def test_reflect_pad_matches_jax():
    x = np.random.RandomState(0).randn(2, 7, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(reflect_pad(_nchw(x), 3)),
                                  np.asarray(jax_reflect_pad(jnp.asarray(x), 3)))


def test_instance_norm_module_matches_jax():
    x = (np.random.RandomState(1).randn(2, 10, 12, 6) * 2 + 1).astype(np.float32)
    want = JaxInstanceNorm().apply({}, jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(InstanceNorm()(_nchw(x))), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_norm_factory():
    assert isinstance(Norm("instance"), InstanceNorm)
    x = torch.randn(1, 4, 3, 3)
    assert torch.equal(Norm("none")(x), x)
    with pytest.raises(NotImplementedError):
        Norm("group")


@pytest.mark.parametrize("use_dropout", [False, True])
def test_generator_runs_jax_params(use_dropout):
    x = _image(0)
    jg = JaxResnetGenerator(output_nc=3, ngf=8, n_blocks=2,
                            use_dropout=use_dropout)
    variables = jg.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jg.apply(variables, jnp.asarray(x)))
    params = jax.tree.map(np.asarray, variables["params"])
    g = ResnetGenerator(3, 3, ngf=8, n_blocks=2, use_dropout=use_dropout).eval()
    g.load_state_dict(resnet_generator_state_dict_from_jax(params, 2, use_dropout))
    with torch.no_grad():
        got = _nhwc(g(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("use_dropout", [False, True])
def test_generator_state_dict_through_jax_importer(use_dropout):
    x = _image(1)
    g = define_G(3, 3, 8, "resnet_3blocks", use_dropout=use_dropout,
                 generator=torch.Generator().manual_seed(3)).eval()
    sd = {k: v.numpy() for k, v in g.state_dict().items()}
    params = import_resnet_generator(sd, n_blocks=3, use_dropout=use_dropout)
    jg = JaxResnetGenerator(output_nc=3, ngf=8, n_blocks=3,
                            use_dropout=use_dropout)
    want = np.asarray(jg.apply({"params": jax.tree.map(jnp.asarray, params)},
                               jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(g(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_state_dict_keys_are_the_reference_keys():
    ref = build_torch_resnet_g(3, 3, ngf=8, n_blocks=2)
    port = ResnetGenerator(3, 3, ngf=8, n_blocks=2)
    assert list(port.state_dict()) == list(ref.state_dict())
    for k, v in ref.state_dict().items():
        assert port.state_dict()[k].shape == v.shape, k
    # a reference state dict loads as it is
    port.load_state_dict(ref.state_dict())


def test_seeded_init():
    def make(seed):
        return define_G(3, 3, 8, "resnet_3blocks",
                        generator=torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        if k.endswith("bias"):
            assert not va.any(), k
        else:
            assert not torch.equal(va, vc), k
    w = torch.cat([p.detach().flatten() for n, p in a.named_parameters()
                   if n.endswith("weight")])
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3


@pytest.mark.parametrize("init_type", ["xavier", "kaiming", "orthogonal"])
def test_other_inits_are_seeded_and_scaled(init_type):
    g1 = define_G(3, 3, 8, "resnet_3blocks", init_type=init_type,
                  generator=torch.Generator().manual_seed(0))
    g2 = define_G(3, 3, 8, "resnet_3blocks", init_type=init_type,
                  generator=torch.Generator().manual_seed(0))
    w1 = g1.model[1].weight.detach()
    assert torch.equal(w1, g2.model[1].weight)
    fan_in = w1[0].numel()
    fan_out = w1.shape[0] * w1[0, 0].numel()
    std = {"xavier": 0.02 * np.sqrt(2.0 / (fan_in + fan_out)),
           "kaiming": np.sqrt(2.0 / fan_in)}.get(init_type)
    if std is not None:
        assert abs(float(w1.std()) / std - 1) < 0.2
    else:  # orthogonal rows, scaled by the gain
        m = w1.reshape(w1.shape[0], -1).double()
        np.testing.assert_allclose((m @ m.T).numpy(),
                                   0.02 ** 2 * np.eye(m.shape[0]), atol=1e-9)


def test_define_G_names():
    for name, n in (("resnet_9blocks", 9), ("resnet_6blocks", 6),
                    ("resnet_3blocks", 3), ("3blocks", 3)):
        assert define_G(3, 3, 4, name).n_blocks == n
    for name, n in (("unet_128", 7), ("unet_256", 8)):
        assert define_G(3, 3, 4, name, norm="batch").num_downs == n
    with pytest.raises(NotImplementedError):
        define_G(3, 3, 4, "unet_512")


def test_bf16_forward_is_finite():
    g = define_G(3, 3, 8, "resnet_3blocks").to(torch.bfloat16).eval()
    with torch.no_grad():
        y = g(_nchw(_image(2)).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 3, 32, 32)
    assert torch.isfinite(y.float()).all()
