"""Parameter bridge from the JAX package's flax variables to the PyTorch
port (``cnrma_torch.bridge.from_flax``), plus the helpers the other
``test_torch_*`` parity files share: random eval statistics for a flax
variable tree and the flax-to-torch state dict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from cnrma_torch.bridge import from_flax
from cnrma_torch.models.cn_rma import CNRMA as TorchCNRMA
from cnrma_torch.models.fcaf3d import DetectionCapacities as TorchCaps
from test_pipeline import tiny_model


def randomize_stats(variables, seed: int):
    """Copy of a flax variable tree (as numpy) whose norm statistics and
    affine parameters are random, so eval-mode norms are not identities:
    mean ~ N(0, 0.1), var ~ U(0.5, 1.5), scale ~ 1 + N(0, 0.1) (also the
    zero-initialized ones), bias ~ N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        x = np.asarray(x, np.float32)
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "mean" or name == "bias":
            return (rng.randn(*x.shape) * 0.1).astype(np.float32)
        if name == "var":
            return (rng.rand(*x.shape) + 0.5).astype(np.float32)
        if name == "scale":
            return (1 + rng.randn(*x.shape) * 0.1).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(variables))


def torch_module(module, variables):
    """Load flax ``variables`` into the torch ``module`` (eval mode)."""
    module.load_state_dict(from_flax(jax.device_get(variables), module))
    return module.eval()


def tiny_torch_cnrma(**overrides):
    """The port's counterpart of ``test_pipeline.tiny_model``."""
    cfg = dict(voxel_dim=(16, 16, 16), voxel_size=0.1, n_classes=3,
               ray_samples=24, rays_per_view_cap=512, max_points=1024,
               pts_threshold=500, assigner_limit=2, assigner_topk=4,
               nms_pre=16, voxel_size_fcaf3d=0.05,
               capacities=TorchCaps.tiny())
    cfg.update(overrides)
    return TorchCNRMA(**cfg)


@pytest.fixture(scope="module")
def tiny_shapes():
    model, batch = tiny_model()
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": rng, "sample": rng}, batch, train=False))
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)


def test_every_leaf_maps(tiny_shapes):
    """Every leaf of the tiny CNRMA lands in the port, and every port
    parameter and buffer is filled (from_flax raises otherwise)."""
    model = tiny_torch_cnrma()
    state = from_flax(tiny_shapes, model)
    n_leaves = len(jax.tree_util.tree_leaves(tiny_shapes))
    assert len(state) == n_leaves == len(model.state_dict())
    model.load_state_dict(state)


def test_unused_leaf_raises(tiny_shapes):
    extra = jax.tree_util.tree_map(lambda x: x, tiny_shapes)
    extra["params"]["tower2d"]["stray"] = {"kernel": np.zeros((1, 1, 1, 1))}
    with pytest.raises(KeyError, match="stray"):
        from_flax(extra, tiny_torch_cnrma())


def test_unset_parameter_raises(tiny_shapes):
    missing = jax.tree_util.tree_map(lambda x: x, tiny_shapes)
    del missing["batch_stats"]["backbone3d"]["up1_proj_norm"]
    with pytest.raises(KeyError, match="up1_proj_norm.running_mean"):
        from_flax(missing, tiny_torch_cnrma())


def test_shape_mismatch_raises(tiny_shapes):
    bad = jax.tree_util.tree_map(lambda x: x, tiny_shapes)
    bad["params"]["tsdf_head"]["decoder0"]["kernel"] = np.zeros(
        (1, 1, 1, 5, 1), np.float32)
    with pytest.raises(ValueError, match="decoder0.weight"):
        from_flax(bad, tiny_torch_cnrma())


@pytest.mark.parametrize("ndim", [2, 3])
def test_conv_kernel_layout(ndim):
    """A flax conv kernel [k..., Cin, Cout] bridged to [Cout, Cin, k...]
    computes the same convolution (fp32 rounding, 1e-5)."""
    from cnrma_torch.models.layers import Conv
    rng = np.random.RandomState(ndim)
    x = rng.randn(2, *(6,) * ndim, 3).astype(np.float32)
    conv = nn.Conv(4, (3,) * ndim, strides=2, padding=[(1, 1)] * ndim,
                   use_bias=False)
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    port = Conv(3, 4, 3, stride=2, ndim=ndim)
    port.load_state_dict({"weight": from_flax(variables)["weight"]})
    perm = (0, ndim + 1) + tuple(range(1, ndim + 1))
    got = port(torch.from_numpy(x).permute(*perm))
    back = (0,) + tuple(range(2, ndim + 2)) + (1,)
    np.testing.assert_allclose(got.permute(*back).detach().numpy(), want,
                               atol=1e-5)
