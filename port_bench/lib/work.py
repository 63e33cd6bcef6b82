"""The work a call needs, counted by the benchmark from the cell's own
inputs, whatever implements the model: the bytes and operations of the
volume kernels (K1, K1b) and of the ray march (K2), frozen from
``chip_smoke.py``'s formulas, and the model FLOPs of a forward or a
training step.

The rows the volume reaches, its (voxel, view) pairs and the rays' coarse
march are worked out here with the reference's plain functions, never
read from the program or from a kernel's outputs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Sequence

import torch

from port_bench.reference.ops import backproject as ref_bp
from port_bench.reference.ops import ray_marching as ref_rm
from port_bench.reference.ops import sparse as ref_sp
from port_bench.reference.models import fcaf3d as ref_fcaf3d


def _volume_pairs(proj: torch.Tensor, view_valid: torch.Tensor,
                  dim: Sequence[int], vs: float, origin, h: int, w: int):
    """(distinct pixel rows reached over the views, view count a voxel)."""
    reached = 0
    cnt = torch.zeros(tuple(dim), dtype=torch.float32, device=proj.device)
    for v in range(proj.shape[0]):
        if not bool(view_valid[v]):
            continue
        flat, valid = ref_bp.project_voxels(proj[v], dim, vs, origin, h, w)
        seen = torch.zeros(h * w, dtype=torch.bool, device=proj.device)
        seen[flat[valid]] = True
        reached += int(seen.sum())
        cnt += valid.float()
    return reached, cnt


def volume_work(proj, view_valid, dim, vs, origin, h, w, channels=32,
                esize=4):
    """(bytes, fp32 operations) of K1 on these inputs.  Bytes: the feature
    rows some voxel reaches, the projections and view flags, the volume,
    count and mask written.  Operations: 6 a voxel (its centre), 21 a
    voxel and valid view (the projection), 33 a (voxel, view) pair (32
    channel sums and the count), 32 an observed voxel (the mean)."""
    reached, cnt = _volume_pairs(proj, view_valid, dim, vs, origin, h, w)
    n, nv = cnt.numel(), int(view_valid.sum())
    nbytes = (reached * channels * esize + proj.numel() * 4
              + proj.shape[0] + n * channels * esize + n * 4 + n)
    ops = (6.0 * n + 21.0 * n * nv + 33.0 * float(cnt.sum())
           + 32.0 * int((cnt > 0).sum()))
    return nbytes, ops


def volume_bwd_work(proj, view_valid, dim, vs, origin, h, w, channels=32,
                    esize=4):
    """(bytes, fp32 operations) of K1b on these inputs.  Bytes: the
    cotangent and the count read, the projections and view flags, the
    features' gradient written once.  Operations: 6 a voxel, 21 a voxel
    and valid view, 32 an observed voxel (the division by its count), 32
    a (voxel, view) pair (the sums)."""
    _, cnt = _volume_pairs(proj, view_valid, dim, vs, origin, h, w)
    n, nv, V = cnt.numel(), int(view_valid.sum()), proj.shape[0]
    nbytes = (n * channels * esize + 4 * n + proj.numel() * 4 + V
              + V * h * w * channels * esize)
    ops = (6.0 * n + 21.0 * n * nv + 32.0 * int((cnt > 0).sum())
           + 32.0 * float(cnt.sum()))
    return nbytes, ops


def ray_work(proj, view_valid, tsdf, vs, origin, h, w, n_samples,
             threshold, skip_factor, window, coarse_step):
    """(bytes, fp32 operations) of K2 on these rays and this TSDF, their
    coarse march worked out by the reference.  Bytes: origins,
    directions, view flags, the packed occupancy grid, the distinct TSDF
    voxels the fine windows read, the weights, sample ids, j0 and has_hit
    written.  Operations: 15 a coarse step taken (j0 + 1 on a ray that
    hits, all of them on one that misses), 28 a fine sample of a ray that
    hits."""
    o, d = ref_rm.get_ray_parameters(proj, h, w)
    occ = ref_rm.build_occupancy(tsdf, skip_factor)
    V, HW = d.shape[:2]
    k_max = min(window, math.ceil(1.0 / threshold))
    n_coarse = (n_samples + coarse_step - 1) // coarse_step
    X, Y, Z = tsdf.shape
    t_one = math.sqrt(X * X + Y * Y + Z * Z) * vs / n_samples
    j0, has_hit = ref_rm.coarse_march_plain(o, d, occ, origin, t_one,
                                            coarse_step, n_coarse,
                                            vs * skip_factor)
    ok = view_valid.bool()[:, None]
    j0, has_hit = torch.where(ok, j0, 0), has_hit & ok
    start = torch.clamp(j0 * coarse_step - coarse_step, 0,
                        n_samples - window)[has_hit]
    ts = (start[:, None] + torch.arange(window, device=d.device)).float() \
        * t_one
    places = o[:, None, :].expand(V, HW, 3)[has_hit][:, None, :] \
        + d[has_hit][:, None, :] * ts[..., None]
    flat, inside = ref_rm._voxel_ids(places, origin, vs, tsdf.shape)
    n_tsdf = int(torch.unique(flat[inside]).numel())
    nbytes = (V * 12 + V * HW * 12 + V + ref_rm.pack_occupancy(occ).numel()
              + 4 * n_tsdf + V * HW * (8 * k_max + 5))
    steps = float(torch.where(has_hit, j0 + 1,
                              torch.where(ok, n_coarse, 0)).sum())
    ops = 15.0 * steps + 28.0 * window * int(has_hit.sum())
    return nbytes, ops


class FlopCounter:
    """Model FLOPs of the reference's convolutions and matmuls while it
    runs: dense convolutions from their shapes, sparse convolutions over
    the (output, input) pairs that the kernel maps find, the generative
    transpose over its valid rows, the head's 1x1 products over the valid
    rows.  With ``backward`` each op adds its weight gradient where its
    weight is trained (not under a ``frozen`` prefix) and its input
    gradient where a trained op ran before it in the forward (the data
    and the frozen layers' outputs need none); recomputation is not
    counted."""

    def __init__(self, backward: bool = False, frozen=()):
        self.backward = backward
        self.frozen = tuple(frozen)
        self.trained_seen = False
        self.total = 0.0

    def add(self, fwd: float, trained: bool) -> None:
        self.total += fwd
        if self.backward:
            self.total += fwd * (int(self.trained_seen) + int(trained))
        self.trained_seen = self.trained_seen or trained

    def _trained(self, names: Dict[int, str], w: torch.Tensor) -> bool:
        name = names.get(id(w))
        return name is not None and not name.startswith(self.frozen)

    @contextlib.contextmanager
    def counting(self, model: torch.nn.Module) -> Iterator["FlopCounter"]:
        names = {id(p): n for n, p in model.named_parameters()}
        counter = self

        def dense(mod, args, out):
            w = mod.weight
            counter.add(2.0 * out.numel() * w.shape[1] * w[0, 0].numel(),
                        counter._trained(names, w))

        handles = [mod.register_forward_hook(dense)
                   for mod in model.modules() if type(mod).__name__ == "Conv"]
        orig = (ref_sp.apply_sparse_conv, ref_sp.generative_transpose_conv,
                ref_fcaf3d.FCAF3DHeadNet._forward_single)

        def sparse_conv(feats, weights, idx, found):
            k, cin, cout = weights.shape
            counter.add(2.0 * cin * cout * float(found.sum()),
                        counter._trained(names, weights))
            return orig[0](feats, weights, idx, found)

        def transpose(st, weights):
            cin, cout = st.num_channels, weights.shape[-1]
            counter.add(2.0 * cin * 8 * cout * float(st.valid.sum()),
                        counter._trained(names, weights))
            return orig[1](st, weights)

        def head(self_, st, level):
            outs = (self_.centerness_conv.shape[-1] + self_.reg_conv.shape[-1]
                    + self_.cls_conv.shape[-1])
            counter.add(2.0 * st.num_channels * outs * float(st.valid.sum()),
                        counter._trained(names, self_.cls_conv))
            return orig[2](self_, st, level)

        ref_sp.apply_sparse_conv = sparse_conv
        ref_sp.generative_transpose_conv = transpose
        ref_fcaf3d.FCAF3DHeadNet._forward_single = head
        try:
            yield self
        finally:
            (ref_sp.apply_sparse_conv, ref_sp.generative_transpose_conv,
             ref_fcaf3d.FCAF3DHeadNet._forward_single) = orig
            for h in handles:
                h.remove()
