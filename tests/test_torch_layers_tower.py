"""Parity of the port's layers and 2D tower with the JAX package
(``cnrma_tpu/models/layers.py``, ``resnet_fpn.py``), fp32 on the CPU.

Inputs come from numpy seeds, parameters from the flax init (the whole
tower's: the port's default initialisation as flax variables; norm
statistics randomized so eval norms are not identities) carried over by
``cnrma_torch.bridge.from_flax``.  Tolerances: 1e-6 for elementwise
layers (same fp32 operations), 1e-5 for one convolution (sum order), and
1e-4 of the output scale for the whole tower (about fifty convolutions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnrma_torch.models import layers as tl
from cnrma_torch.models.resnet_fpn import ResNetFPN2D as TorchTower
from cnrma_tpu.models import layers as jl
from cnrma_tpu.models.resnet_fpn import ResNetFPN2D as JaxTower
from test_torch_bridge import randomize_stats, torch_module
from test_torch_test_cli import _flax_tree_from_torch
from _torch_threads import _few_threads  # noqa: F401


def to_cf(x: np.ndarray) -> torch.Tensor:
    """[N, *spatial, C] numpy -> channels-first torch view."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.permute(0, t.dim() - 1, *range(1, t.dim() - 1))


def to_cl(t: torch.Tensor) -> np.ndarray:
    """Channels-first torch -> [N, *spatial, C] numpy."""
    return t.permute(0, *range(2, t.dim()), 1).detach().numpy()


def _flax(module, *inputs, seed=0, **kw):
    variables = module.init(jax.random.PRNGKey(seed), *inputs, **kw)
    variables = randomize_stats(variables, seed + 1)
    return variables, np.asarray(module.apply(variables, *inputs, **kw))


@pytest.mark.parametrize("ndim", [2, 3])
def test_batchnorm_eval(ndim):
    x = np.random.RandomState(ndim).randn(2, *(5,) * ndim, 6) \
        .astype(np.float32)
    variables, want = _flax(jl.BatchNorm(), jnp.asarray(x), train=False)
    got = torch_module(tl.BatchNorm(6), variables)(to_cf(x))
    np.testing.assert_allclose(to_cl(got), want, atol=1e-6)


def test_masked_norms():
    rng = np.random.RandomState(3)
    x = (rng.randn(40, 8) * 3 + 1).astype(np.float32)
    mask = rng.rand(40) > 0.3
    variables, want = _flax(jl.MaskedBatchNorm(), jnp.asarray(x),
                            jnp.asarray(mask), train=False)
    got = torch_module(tl.MaskedBatchNorm(8), variables)(
        torch.from_numpy(x), torch.from_numpy(mask)).detach()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert not got[~torch.from_numpy(mask)].any()
    variables, want = _flax(jl.MaskedInstanceNorm(), jnp.asarray(x[None]),
                            jnp.asarray(mask[None]))
    got = torch_module(tl.MaskedInstanceNorm(8), variables)(
        torch.from_numpy(x), torch.from_numpy(mask)).detach()
    np.testing.assert_allclose(got.numpy(), want[0], atol=1e-5)


@pytest.mark.parametrize("ndim,k,stride", [(2, 7, 2), (2, 3, 1), (2, 1, 2),
                                           (3, 3, 2), (3, 3, 1)])
def test_convbn(ndim, k, stride):
    x = np.random.RandomState(k).randn(2, *(9,) * ndim, 5).astype(np.float32)
    module = jl.ConvBN(7, k, stride, norm="BN", act=jax.nn.relu)
    variables, want = _flax(module, jnp.asarray(x), train=False)
    port = tl.ConvBN(5, 7, k, stride, ndim=ndim,
                     act=torch.nn.functional.relu)
    got = torch_module(port, variables)(to_cf(x))
    np.testing.assert_allclose(to_cl(got), want, atol=1e-5)


@pytest.mark.parametrize("ndim", [2, 3])
def test_upsample_linear_is_half_pixel_interpolate(ndim):
    """The JAX shifted-add x2 kernel equals F.interpolate(align_corners=
    False) up to fp32 rounding of the two evaluation orders."""
    x = np.random.RandomState(ndim).randn(2, *(5,) * ndim, 3) \
        .astype(np.float32)
    want = np.asarray(jl.upsample_linear(jnp.asarray(x), 2))
    got = to_cl(tl.upsample_linear(to_cf(x), 2))
    np.testing.assert_allclose(got, want, atol=1e-6)
    want = np.asarray(jl.upsample_nearest(jnp.asarray(x), 2))
    np.testing.assert_array_equal(to_cl(tl.upsample_nearest(to_cf(x), 2)),
                                  want)


@pytest.fixture(scope="module")
def tower():
    images = (np.random.RandomState(0).rand(2, 64, 64, 3) * 255
              - 120).astype(np.float32)
    module = JaxTower()
    torch.manual_seed(0)
    variables = randomize_stats(_flax_tree_from_torch(
        TorchTower().state_dict(), jax.eval_shape(lambda x: module.init(
            jax.random.PRNGKey(0), x, train=False), jnp.asarray(images))), 1)
    want = np.asarray(jax.jit(lambda v, x: module.apply(v, x, train=False))(
        variables, jnp.asarray(images)))
    return images, variables, want


def test_resnet_fpn_tower(tower):
    images, variables, want = tower
    port = torch_module(TorchTower(), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    assert got.shape == (2, 16, 16, 32) == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * scale)


def test_tower_bfloat16_runs_in_bfloat16(tower):
    """compute_dtype=bf16 casts at the tower's entry like the JAX module
    and stays close to the fp32 result (bf16 keeps ~3 digits: 5e-2 of the
    output scale over fifty layers)."""
    images, variables, want = tower
    port = torch_module(TorchTower(compute_dtype=torch.bfloat16), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=5e-2 * np.abs(want).max())
