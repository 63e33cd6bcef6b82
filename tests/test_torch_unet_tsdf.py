"""Parity of the port's 3D U-Net and TSDF head with the JAX package
(``cnrma_tpu/models/unet3d.py``, ``tsdf_head.py``), fp32 on the CPU.

Parameters are the port's default initialisation (the U-Net's) or the
flax init (the head's) with random norm statistics and scales (so the
zero-initialized residual BNs are not zero), carried over by the bridge.
Tolerances: 1e-4 of each output's scale for the U-Net (about thirty 3D
convolutions summed in another order), 1e-5 absolute for the head (one
1x1x1 convolution and tanh on the shared inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnrma_torch.models.tsdf_head import TSDFHead as TorchHead
from cnrma_torch.models.unet3d import UNet3D as TorchUNet
from cnrma_tpu.models.tsdf_head import TSDFHead as JaxHead
from cnrma_tpu.models.unet3d import UNet3D as JaxUNet
from test_torch_bridge import randomize_stats, torch_module
from test_torch_test_cli import _flax_tree_from_torch
from _torch_threads import _few_threads  # noqa: F401


@pytest.fixture(scope="module")
def unet():
    x = np.random.RandomState(0).rand(1, 16, 16, 16, 32).astype(np.float32)
    module = JaxUNet()
    torch.manual_seed(0)
    variables = randomize_stats(_flax_tree_from_torch(
        TorchUNet().state_dict(), jax.eval_shape(lambda v: module.init(
            jax.random.PRNGKey(0), v, train=False), jnp.asarray(x))), 1)
    want = jax.jit(lambda v, a: module.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    return x, variables, [np.asarray(w) for w in want]


def test_unet3d(unet):
    x, variables, want = unet
    port = torch_module(TorchUNet(), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (1, 4, 4, 4, 128), (1, 8, 8, 8, 64), (1, 16, 16, 16, 32)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("gain", [1.0, 30.0])
def test_tsdf_head(unet, gain):
    """Head on the U-Net's output scales; ``gain`` 30 saturates the coarse
    TSDF so the clamp to sign * 0.999 is exercised."""
    _, _, xs = unet
    xs = [x * gain for x in xs]
    module = JaxHead(voxel_size=0.04)
    variables = module.init(jax.random.PRNGKey(2),
                            [jnp.asarray(x) for x in xs])
    want, _ = module.apply(variables, [jnp.asarray(x) for x in xs])
    port = torch_module(TorchHead(voxel_size=0.04), variables)
    with torch.no_grad():
        got = port([torch.from_numpy(x) for x in xs])
    assert list(got) == [f"scene_tsdf_{k}" for k in ("016", "008", "004")]
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)
    clamped = np.isclose(np.abs(np.asarray(want["scene_tsdf_004"])), 0.999)
    assert clamped.any() == (gain > 1)
