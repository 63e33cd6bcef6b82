"""The volume's gradient: the port's ``VolumeAccum`` backward (the plain
version K1b is held against on the card) against ``jax.vjp`` of the JAX
package's ``accumulate_views``, fp32 on the CPU, dense path
(``tile=0``, ``view_chunk=1``).

The scenes hold an invalid view, voxels behind every camera and voxels no
view sees, so the backward must send nothing from them; one puts the
cameras inside the grid.  Both sides scatter
``g / cnt`` per view in fp32, the port with ``index_add_`` and JAX with
``.at[].add``, in the same voxel order: the gradients agree within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnrma_torch.ops import backproject as tbp
from cnrma_tpu.ops import backproject as jbp
from test_torch_volume import _scene

TOL = 1e-6


def _case(seed, views, h, w, dim, vs=0.3):
    proj, feats, valid = _scene(seed, views, h, w, 32, dim, vs)
    # one camera turned round: the voxels it saw now lie behind it
    proj[0] = -proj[0]
    rng = np.random.RandomState(seed + 10)
    g = rng.randn(*dim, 32).astype(np.float32)
    return proj, feats, valid, g, (0.1, -0.2, 0.05)


def _jax_grad(proj, feats, valid, dim, vs, origin, g):
    def f(x):
        return jbp.accumulate_views(
            jnp.asarray(proj), x, jnp.asarray(valid), dim, vs,
            jnp.asarray(origin, jnp.float32), view_chunk=1, tile=0)[0]
    vol, vjp = jax.vjp(f, jnp.asarray(feats))
    return np.asarray(vol), np.asarray(vjp(jnp.asarray(g))[0])


# cameras inside the grid (7.8 x 7.8 x 2.4 m around a ring of 3 m), the
# geometry where K1b's tiles cross the camera plane
INSIDE = (3, 4, 12, 16, (26, 26, 8))


@pytest.mark.parametrize("seed,views,h,w,dim", [
    (0, 5, 24, 32, (20, 16, 12)), (1, 3, 12, 16, (16, 16, 8)),
    (2, 4, 9, 13, (27, 7, 5)), INSIDE])
def test_backward_matches_jax_vjp(seed, views, h, w, dim):
    proj, feats, valid, g, origin = _case(seed, views, h, w, dim)
    if (seed, views, h, w, dim) == INSIDE:
        eyes = [np.linalg.solve(p[:, :3], -p[:, 3]) for p in proj[1:]]
        extent = np.array(dim) * 0.3 + np.array(origin)
        assert all((origin < e).all() and (e < extent).all() for e in eyes)
    jvol, jgrad = _jax_grad(proj, feats, valid, dim, 0.3, origin, g)
    x = torch.from_numpy(feats).requires_grad_()
    vol, ok = tbp.accumulate_views(torch.from_numpy(proj), x,
                                   torch.from_numpy(valid), dim, 0.3, origin)
    assert vol.grad_fn is not None
    # an invalid view, voxels no view sees, and a camera that sees nothing
    assert not valid.all() and not ok.all() and ok.any()
    vol.backward(torch.from_numpy(g))
    np.testing.assert_allclose(vol.detach().numpy(), jvol, atol=TOL)
    np.testing.assert_allclose(x.grad.numpy(), jgrad, atol=TOL)
    assert not x.grad[~torch.from_numpy(valid)].any()
    assert x.grad.abs().sum() > 0


def test_plain_backward_is_the_function():
    """``volume_accum_bwd_plain`` from the count alone equals autograd of
    the differentiable plain forward, in fp32 and cast to bf16."""
    dim = (12, 10, 6)
    proj, feats, valid, g, origin = _case(3, 4, 10, 14, dim)
    x = torch.from_numpy(feats).requires_grad_()
    mean, cnt, _ = tbp.volume_accum_plain(torch.from_numpy(proj), x,
                                          torch.from_numpy(valid), dim, 0.3,
                                          origin)
    mean.backward(torch.from_numpy(g))
    for dtype in (torch.float32, torch.bfloat16):
        got = tbp.volume_accum_bwd_plain(
            torch.from_numpy(proj), torch.from_numpy(g), cnt,
            torch.from_numpy(valid), (10, 14), dim, 0.3, origin, dtype)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   x.grad.to(dtype).float().numpy(),
                                   atol=TOL)


def test_no_gradient_without_requires_grad():
    dim = (8, 8, 4)
    proj, feats, valid, _, origin = _case(4, 2, 8, 8, dim)
    vol, _ = tbp.accumulate_views(torch.from_numpy(proj),
                                  torch.from_numpy(feats),
                                  torch.from_numpy(valid), dim, 0.3, origin)
    assert vol.grad_fn is None and not vol.requires_grad


def test_bf16_features_get_bf16_gradient():
    dim = (10, 8, 6)
    proj, feats, valid, g, origin = _case(5, 3, 8, 12, dim)
    x = torch.from_numpy(feats).to(torch.bfloat16).requires_grad_()
    vol, _ = tbp.accumulate_views(torch.from_numpy(proj), x,
                                  torch.from_numpy(valid), dim, 0.3, origin)
    assert vol.dtype == torch.bfloat16
    vol.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert x.grad.dtype == torch.bfloat16
    assert torch.isfinite(x.grad.float()).all() and x.grad.abs().sum() > 0
