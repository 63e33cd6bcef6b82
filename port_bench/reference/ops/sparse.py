"""Fixed-capacity sparse voxel tensors and sparse convolution.  Every
coordinate op (voxelization, kernel maps, pooling, the generative
transpose, skip adds, pruning) runs on one scene; a convolution can run
over several scenes' rows at once (``apply_sparse_conv_batch``).

Port of ``cnrma_tpu/ops/sparse.py`` (the MinkowskiEngine replacement).  A
``SparseTensor`` holds packed keys, coordinates and features at a fixed
capacity; empty rows carry the sentinel key.  Kernel maps take one route:
sort the keys, ``torch.searchsorted`` the neighbour keys.  The JAX
package's dense rank-LUT lookups and parent-derived kernel maps are TPU
speed choices that its tests show equal to this route, so the results
here are the same.  Keys are sorted except in the p-major children of a
generative transpose, which ``kernel_map`` sorts for itself.

The convolution itself is a per-offset row gather and matmul with fp32
accumulation (``apply_sparse_conv``), as XLA computed it outside any
Pallas kernel.  Weights are [K offsets, Cin, Cout] like ME kernels.  Row
gathers that carry a gradient are ``index_select``: its backward is an
``index_add_``, where ``feats[idx]``'s sorts the indices first (about
18 ms a gather at the training capacities on the H100, PERF.md).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from port_bench.reference.capacity import report as report_capacity
from port_bench.reference.ops.voxelize import (
    SENTINEL_KEY, VoxelGrid, count_unique, lookup, sort_by_key,
    unique_sorted)


@dataclass(frozen=True)
class SparseTensor:
    """One scene's sparse voxel tensor.  Coordinates are in base-voxel
    units (multiples of ``stride``); row i is valid iff ``keys[i]`` is not
    the sentinel."""
    keys: torch.Tensor          # [N] int32
    coords: torch.Tensor        # [N, 3] int32
    feats: torch.Tensor         # [N, C]
    stride: int
    grid: VoxelGrid = VoxelGrid()

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def num_channels(self) -> int:
        return self.feats.shape[-1]

    @property
    def valid(self) -> torch.Tensor:
        return self.keys != SENTINEL_KEY

    def with_feats(self, feats: torch.Tensor) -> "SparseTensor":
        return replace(self, feats=feats)


def voxelize_points(points: torch.Tensor, feats: torch.Tensor,
                    point_valid: torch.Tensor, voxel_size: float,
                    capacity: int, grid: VoxelGrid = VoxelGrid()
                    ) -> SparseTensor:
    """Quantize a point cloud ([P, 3] metric) into a stride-1 tensor:
    coordinates are floored, duplicate voxels average their features in
    fp32 (the JAX package's ``reduce="mean"``)."""
    cell = torch.tensor(voxel_size, dtype=torch.float32, device=points.device)
    coords = torch.floor(points / cell).to(torch.int32)
    keys = torch.where(point_valid, grid.pack(coords), SENTINEL_KEY)
    keys_sorted, feats_s = sort_by_key(keys, feats)
    report_capacity("voxelize(stride 1)", lambda: count_unique(keys_sorted),
                    capacity)
    out_keys, run_id = unique_sorted(keys_sorted, capacity)
    c = feats.shape[-1]
    sums = feats.new_zeros((capacity + 1, c), dtype=torch.float32)
    sums.index_add_(0, run_id, feats_s.float())
    cnts = feats.new_zeros((capacity + 1,), dtype=torch.float32)
    cnts.index_add_(0, run_id, torch.ones_like(run_id, dtype=torch.float32))
    out = sums[:capacity] / torch.clamp(cnts[:capacity, None], min=1.0)
    return SparseTensor(keys=out_keys, coords=grid.unpack(out_keys),
                        feats=out.to(feats.dtype), stride=1, grid=grid)


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """Static [K, 3] offsets, x fastest (ME ordering)."""
    if kernel_size % 2 == 1:
        r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        r = range(0, kernel_size)
    return np.array([(x, y, z) for z in r for y in r for x in r], np.int32)


def kernel_map(st: SparseTensor, offsets: np.ndarray,
               query_coords: Optional[torch.Tensor] = None,
               query_keys: Optional[torch.Tensor] = None,
               offset_stride: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, M] (index, found): the input row at query m + offset k.

    Queries default to the tensor's own coordinates (submanifold conv);
    offsets are scaled by ``offset_stride`` (default ``st.stride``).  The
    keys need not be sorted: they are sorted here and indices mapped back.
    """
    if query_coords is None:
        query_coords, query_keys = st.coords, st.keys
    s = st.stride if offset_stride is None else offset_stride
    offs = torch.from_numpy(np.asarray(offsets, np.int32) * s).to(
        query_coords.device)
    q = st.grid.pack(query_coords[None, :, :] + offs[:, None, :])   # [K, M]
    if query_keys is not None:
        q = torch.where((query_keys == SENTINEL_KEY)[None, :], SENTINEL_KEY, q)
    keys_sorted, perm = torch.sort(st.keys, stable=True)
    idx, found = lookup(keys_sorted, q.reshape(-1))
    return perm[idx].reshape(q.shape), found.reshape(q.shape)


def apply_sparse_conv(feats: torch.Tensor, weights: torch.Tensor,
                      idx: torch.Tensor, found: torch.Tensor) -> torch.Tensor:
    """out[m] = sum_k W[k]^T feats[idx[k, m]] over found neighbours, in the
    feature dtype.

    One gather and matmul per offset in fp32, summed in fp32 in offset
    order: the products of bf16 rows and bf16-rounded weights are exact in
    fp32, as with the JAX package's ``preferred_element_type=float32``."""
    w = weights.to(feats.dtype).float()
    acc = feats.new_zeros((idx.shape[1], weights.shape[-1]),
                          dtype=torch.float32)
    for k in range(weights.shape[0]):
        g = torch.where(found[k][:, None],
                        feats.index_select(0, idx[k]).float(), 0.0)
        acc += g @ w[k]
    return acc.to(feats.dtype)


def apply_sparse_conv_batch(feats: Sequence[torch.Tensor],
                            weights: torch.Tensor,
                            kmaps: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                            ) -> List[torch.Tensor]:
    """``apply_sparse_conv`` of several scenes at once: their rows side by
    side ([sum N_b, C]), each scene's kernel-map indices shifted by its
    first row, so each offset's gather and matmul runs once for the
    batch; returns each scene's output rows.  One scene takes
    ``apply_sparse_conv`` itself."""
    if len(feats) == 1:
        return [apply_sparse_conv(feats[0], weights, *kmaps[0])]
    starts = np.cumsum([0] + [f.shape[0] for f in feats[:-1]]).tolist()
    idx = torch.cat([i + s for (i, _), s in zip(kmaps, starts)], dim=1)
    found = torch.cat([f for _, f in kmaps], dim=1)
    out = apply_sparse_conv(torch.cat(list(feats)), weights, idx, found)
    return list(out.split([i.shape[1] for i, _ in kmaps]))


def subm_conv(st: SparseTensor, weights: torch.Tensor,
              kmap: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              offsets: Optional[np.ndarray] = None) -> SparseTensor:
    """Submanifold (stride-1) conv on the tensor's own coordinates; pass a
    ``kmap`` to share one neighbour search across a stage."""
    if kmap is None:
        if offsets is None:
            offsets = kernel_offsets(round(len(weights) ** (1 / 3)))
        kmap = kernel_map(st, offsets)
    return st.with_feats(apply_sparse_conv(st.feats, weights, *kmap))


def downsample_coords(st: SparseTensor, factor: int, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Output coordinates of a strided op: unique(floor(c / s') * s').
    Returns (keys [capacity] sorted, coords [capacity, 3])."""
    new_stride = st.stride * factor
    q = torch.div(st.coords, new_stride, rounding_mode="floor") * new_stride
    qkeys = torch.sort(torch.where(st.valid, st.grid.pack(q),
                                   SENTINEL_KEY))[0]
    report_capacity(f"dedup(stride {new_stride})",
                    lambda: count_unique(qkeys), capacity)
    out_keys, _ = unique_sorted(qkeys, capacity)
    return out_keys, st.grid.unpack(out_keys)


def strided_kernel_map(st: SparseTensor, offsets: np.ndarray, factor: int,
                       capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Tuple[torch.Tensor, torch.Tensor]]:
    """The coordinates of a strided op's output (``downsample_coords``)
    and its kernel map: offsets in input-stride units around each output
    coordinate.  Returns (keys, coords, (idx, found))."""
    out_keys, out_coords = downsample_coords(st, factor, capacity)
    kmap = kernel_map(st, offsets, query_coords=out_coords,
                      query_keys=out_keys, offset_stride=st.stride)
    return out_keys, out_coords, kmap


def strided_conv(st: SparseTensor, weights: torch.Tensor, factor: int,
                 capacity: int, offsets: Optional[np.ndarray] = None
                 ) -> SparseTensor:
    """Strided conv (e.g. k3 s2): output on the downsampled coordinates,
    offsets in input-stride units around each output coordinate."""
    if offsets is None:
        offsets = kernel_offsets(round(len(weights) ** (1 / 3)))
    out_keys, out_coords, (idx, found) = strided_kernel_map(
        st, offsets, factor, capacity)
    return SparseTensor(keys=out_keys, coords=out_coords,
                        feats=apply_sparse_conv(st.feats, weights, idx,
                                                found),
                        stride=st.stride * factor, grid=st.grid)


def max_pool(st: SparseTensor, factor: int, capacity: int) -> SparseTensor:
    """Max pooling with kernel = stride = ``factor``; outputs with no
    input are 0."""
    r = range(factor)
    offsets = np.array([(x, y, z) for z in r for y in r for x in r],
                       np.int32)
    out_keys, out_coords, (idx, found) = strided_kernel_map(
        st, offsets, factor, capacity)
    neg = torch.finfo(st.feats.dtype).min
    acc = st.feats.new_full((capacity, st.num_channels), neg)
    for k in range(offsets.shape[0]):
        acc = torch.maximum(acc, torch.where(
            found[k][:, None], st.feats.index_select(0, idx[k]), neg))
    acc = torch.where(found.any(dim=0)[:, None], acc, 0.0)
    return SparseTensor(keys=out_keys, coords=out_coords,
                        feats=acc.to(st.feats.dtype),
                        stride=st.stride * factor, grid=st.grid)


def generative_transpose_conv(st: SparseTensor, weights: torch.Tensor
                              ) -> SparseTensor:
    """Generative transposed conv k2 s2 (ME
    ``MinkowskiGenerativeConvolutionTranspose``): every row emits its 8
    children at half the stride, row ``p * 8 + o`` with child offset o
    x-fastest (p-major, keys not sorted)."""
    if st.stride % 2:
        raise ValueError("cannot upsample a stride-1 tensor")
    child_stride = st.stride // 2
    r = (0, 1)
    offsets = torch.tensor([(x, y, z) for z in r for y in r for x in r],
                           dtype=torch.int32, device=st.keys.device)
    n, cout = st.capacity, weights.shape[-1]
    child_coords = st.coords[:, None, :] + offsets[None] * child_stride
    child_keys = torch.where(st.valid[:, None], st.grid.pack(child_coords),
                             SENTINEL_KEY)
    w_flat = weights.to(st.feats.dtype).float().permute(1, 0, 2).reshape(
        st.num_channels, 8 * cout)
    outs = (st.feats.float() @ w_flat).reshape(8 * n, cout)
    return SparseTensor(keys=child_keys.reshape(8 * n),
                        coords=child_coords.reshape(8 * n, 3).to(torch.int32),
                        feats=outs.to(st.feats.dtype), stride=child_stride,
                        grid=st.grid)


def add_skip_into_children(children: SparseTensor, skip: SparseTensor,
                           parent_keys: torch.Tensor) -> SparseTensor:
    """children += skip by coordinate: a skip row at c lands in child slot
    parent_index(floor(c / s) * s) * 8 + o_index(c), with parents found by
    one search in their sorted keys."""
    s, half = skip.stride * 2, skip.stride
    pc = torch.div(skip.coords, s, rounding_mode="floor") * s
    pkeys = torch.where(skip.valid, skip.grid.pack(pc), SENTINEL_KEY)
    p_idx, found = lookup(parent_keys, pkeys)
    o = torch.div(skip.coords - pc, half, rounding_mode="floor")
    o_idx = o[:, 0] + 2 * o[:, 1] + 4 * o[:, 2]
    slot = torch.where(found, p_idx * 8 + o_idx, children.capacity)
    add = torch.where(found[:, None], skip.feats, 0.0)
    feats = torch.cat([children.feats,
                       children.feats.new_zeros((1, children.num_channels))])
    feats = feats.index_add(0, slot, add.to(feats.dtype))
    return children.with_feats(feats[:children.capacity])


def interpolate_children_scores(scores: torch.Tensor,
                                kmap27: Tuple[torch.Tensor, torch.Tensor],
                                parent_valid: torch.Tensor) -> torch.Tensor:
    """Trilinear parent-grid scores at the 8N p-major child positions: a
    child at parent + o * s/2 averages the parents at offsets c <= o with
    weight 0.5^|o| (missing corners give 0).  scores: [N]."""
    p_idx, p_found = kmap27
    off_index = {tuple(v): i for i, v in enumerate(kernel_offsets(3).tolist())}
    sc = torch.where(parent_valid, scores.float(), 0.0)
    cols = []
    for o in [(x, y, z) for z in (0, 1) for y in (0, 1) for x in (0, 1)]:
        w = 0.5 ** sum(o)
        acc = torch.zeros_like(sc)
        for cx in range(o[0] + 1):
            for cy in range(o[1] + 1):
                for cz in range(o[2] + 1):
                    ei = off_index[(cx, cy, cz)]
                    acc = acc + w * (sc[p_idx[ei]] * p_found[ei])
        cols.append(acc)
    return torch.stack(cols, dim=1).reshape(-1)


def prune_topk(st: SparseTensor, scores: torch.Tensor, keep: int
               ) -> SparseTensor:
    """Keep the ``keep`` highest-scoring valid rows (ties to the lower
    row), re-sorted by key (ME ``MinkowskiPruning`` + per-scene top-k)."""
    s = torch.where(st.valid, scores.float(), torch.finfo(torch.float32).min)
    top = torch.sort(s, descending=True, stable=True)[1][:keep]
    keys = torch.where(st.valid[top], st.keys[top], SENTINEL_KEY)
    keys_sorted, feats_s = sort_by_key(keys, st.feats.index_select(0, top))
    return SparseTensor(keys=keys_sorted, coords=st.grid.unpack(keys_sorted),
                        feats=feats_s, stride=st.stride, grid=st.grid)


def interpolate_at(st: SparseTensor, positions: torch.Tensor,
                   pos_valid: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of a sparse tensor at float positions in
    base-voxel units (ME ``features_at_coordinates``); missing corners
    give 0.  Returns [Q, C] fp32."""
    s = float(st.stride)
    p = positions / torch.tensor(s, device=positions.device)
    p0 = torch.floor(p)
    frac = p - p0
    corners = torch.tensor([(dx, dy, dz) for dz in (0, 1) for dy in (0, 1)
                            for dx in (0, 1)], dtype=torch.float32,
                           device=positions.device)
    w = torch.where(corners[:, None, :] > 0, frac[None], 1 - frac[None]
                    ).prod(dim=-1)                              # [8, Q]
    coord = ((p0[None] + corners[:, None, :]) * s).to(torch.int32)
    keys = torch.where(pos_valid[None, :], st.grid.pack(coord), SENTINEL_KEY)
    idx, found = lookup(st.keys, keys.reshape(-1))
    g = st.feats.index_select(0, idx).float().reshape(
        8, positions.shape[0], st.num_channels)
    return (g * (w * found.reshape(w.shape))[..., None]).sum(dim=0)
