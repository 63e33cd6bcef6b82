"""The CUDA kernels of cnrma_torch against their plain torch versions, on
the card (``python -m pytest --noconftest -m gpu
tests/test_torch_kernels_gpu.py`` on a machine with an NVIDIA GPU and
nvcc).  Skipped where there is no CUDA device.

The two main-path kernels are built with ``--fmad=false`` and sum in the
same order as their plain versions, so ids, masks and counts must be equal;
volumes agree to fp32 rounding (1e-6 absolute on features in [0, 1]) and,
in bf16, to one bf16 ulp of the mean.  The volume's backward (K1b) sums
with fp32 atomics in an order that changes from run to run: within 1e-5
of the largest gradient, and one bf16 ulp more in bf16.  The ray-march
kernel's NeuS weights take their cumulative sum in another order than
torch's CUDA ``cumsum``: its j0/has_hit are equal, its kept sets equal
outside samples within 1e-5 of the weight threshold, and its weights
agree to 1e-5.  The probe kernels
copy, gather or multiply small integers, so they must equal their plain
versions exactly; the tensor-core ``dot`` is held on random integers, which
show a row or column read from the wrong place where all-ones inputs do
not.
"""

import math

import numpy as np
import pytest
import torch

from cnrma_torch.ops import backproject as bp
from cnrma_torch.ops import ray_marching as rm
from cnrma_torch.synthetic import ring_projections, sphere_tsdf
from cnrma_torch.tools import bp_probe, feature_probe, gather_probe

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel has no CPU mode)")
    return torch.device("cuda")


def _volume_check(cuda, dtype, proj, feats, valid, dim, vs, origin):
    """The volume kernel against its plain version; returns the valid
    mask."""
    args = (torch.from_numpy(proj).to(cuda), feats.to(cuda, dtype),
            valid.to(cuda), dim, vs, origin)
    vol, cnt, ok = bp.volume_accum_cuda(*args)
    pvol, pcnt, pok = bp.volume_accum_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ok, pok) and torch.equal(cnt, pcnt)
    # fp32: rounding of the mean; bf16: one bf16 ulp of the mean
    tol = (1e-6 if dtype == torch.float32
           else 2.0 ** -7 * pvol.float().abs() + 1e-30)
    assert bool(((vol.float() - pvol.float()).abs() <= tol).all())
    return ok


def _ring_scene(views, h, w, dim, vs, seed=0):
    rng = np.random.RandomState(seed)
    proj = ring_projections(views, 4 * h, 4 * w, dim, vs)
    proj[:, :2, :] /= 4
    feats = torch.from_numpy(rng.rand(views, h, w, 32).astype(np.float32))
    return proj, feats


def _volume_bwd_check(cuda, dtype, proj, feats, valid, dim, vs, origin,
                      seed=0):
    """K1b against its plain version on K1's count and a random cotangent:
    within 1e-5 of the largest gradient in fp32 (the kernel's atomics sum
    in an order that changes from run to run), and within one bf16 ulp
    more in bf16; then ``VolumeAccum``'s gradient on the card against the
    plain one.  Returns the (voxel, view) pairs and those that skipped the
    kernel's shared-memory window."""
    p = torch.from_numpy(proj).to(cuda)
    f = feats.to(cuda, dtype)
    ok = valid.to(cuda)
    _, cnt, _ = bp.volume_accum_cuda(p, f, ok, dim, vs, origin)
    g = torch.from_numpy(np.random.RandomState(seed).randn(*dim, 32).astype(
        np.float32)).to(cuda, dtype)
    args = (p, g, cnt, ok, tuple(f.shape[1:3]), dim, vs, origin, dtype)
    direct = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = bp.volume_accum_bwd_cuda(*args, direct=direct)
    want = bp.volume_accum_bwd_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype and got.shape == f.shape
    scale = float(want.float().abs().max())
    assert scale > 0
    err = (got.float() - want.float()).abs()
    tol = 1e-5 * scale + (0.0 if dtype == torch.float32
                          else 2.0 ** -7 * want.float().abs())
    assert bool((err <= tol).all())
    assert not got[~ok].any()
    x = f.clone().requires_grad_()
    vol, _ = bp.accumulate_views(p, x, ok, dim, vs, origin)
    vol.backward(g)
    assert bool(((x.grad.float() - want.float()).abs() <= tol).all())
    return float(cnt.sum()), int(direct.item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ring", "ragged", "behind", "inside",
                                  "far"])
def test_volume_backward_kernel_matches_plain(cuda, dtype, case):
    """K1b: a ring of views with one invalid; odd shapes (a grid and
    feature maps that are no multiple of the tile or of 16); a camera
    turned round, whose voxels lie behind it; cameras inside a grid of
    10 cm voxels, so that tiles near them cross the camera plane or cover
    more pixels than the window (the direct path); a 12x16 feature map
    seen from 3 m by a grid of 2 cm voxels, about 30,000 voxels on a few
    pixels (the window path, merging many pairs a row)."""
    origin = (0.0, 0.0, 0.0)
    views, h, w, dim, vs = {"ring": (5, 24, 32, (16, 16, 8), 0.3),
                            "ragged": (3, 17, 23, (21, 13, 11), 0.3),
                            "behind": (4, 30, 40, (20, 20, 12), 0.3),
                            "inside": (4, 60, 80, (80, 80, 16), 0.1),
                            "far": (3, 12, 16, (32, 32, 32), 0.02)}[case]
    proj, feats = _ring_scene(views, h, w, dim, vs, seed=2)
    valid = torch.ones(views, dtype=torch.bool)
    valid[1] = False
    if case == "behind":
        proj[0] = -proj[0]
    if case == "inside":
        eye = [np.linalg.solve(p[:, :3], -p[:, 3]) for p in proj]
        assert all((0 < e).all() and (e < np.array(dim) * vs).all()
                   for e in eye)
    pairs, direct = _volume_bwd_check(cuda, dtype, proj, feats, valid, dim,
                                      vs, origin)
    assert 0 <= direct <= pairs
    if case == "inside":
        assert direct > 0
    if case == "far":
        assert direct == 0 and pairs > 100 * h * w


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_volume_backward_kernel_at_a_rotated_stage1_crop(cuda, dtype,
                                                         tmp_path):
    """K1b at stage 1's shape: 10 views of [120, 160, 32] features over the
    160x160x64 grid of ``configs/atlas_recon_scannet.py``, placed by its
    reader's ``recon_random`` crop of a synthetic room (a random
    z-rotation, here 140 degrees, and translation), in stage 1's bf16 and
    in fp32."""
    from cnrma_torch.core.builder import build_dataset
    from cnrma_torch.core.config import Config
    from cnrma_torch.synthetic import write_scannet
    ann = write_scannet(str(tmp_path), n_scenes=1, n_frames=10,
                        image_size=(640, 480),
                        ann_name="scannet_infos_train.pkl")
    cfg = Config.fromfile("configs/atlas_recon_scannet.py")
    cfg.merge_from_options({"data.train.data_root": str(tmp_path),
                            "data.train.ann_file": ann,
                            "data.train.num_frames": "10"})
    dataset = build_dataset(cfg, "train", seed=1)
    rng = np.random.RandomState(1)      # the reader's draws: frames, angle
    rng.choice(10, 10, replace=False)
    angle = np.degrees(rng.rand() * 2 * np.pi)
    sample = dataset[0]
    proj = sample["projection"].copy()
    proj[:, :2, :] /= 4
    dim = tuple(cfg.model.voxel_dim_train)
    assert dim == (160, 160, 64) and 20 < angle % 90 < 70
    feats = torch.from_numpy(np.random.RandomState(3).rand(
        10, 120, 160, 32).astype(np.float32))
    valid = torch.from_numpy(sample["view_valid"])
    pairs, direct = _volume_bwd_check(cuda, dtype, proj, feats, valid, dim,
                                      cfg.model.voxel_size, (0.0, 0.0, 0.0))
    assert pairs > 0 and 0 <= direct <= pairs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("views,h,w,dim", [(3, 24, 32, (16, 16, 8)),
                                           (7, 60, 80, (48, 40, 24))])
def test_volume_kernel_matches_plain(cuda, dtype, views, h, w, dim):
    vs = 0.3          # the volume reaches past the frustums
    proj, feats = _ring_scene(views, h, w, dim, vs)
    valid = torch.ones(views, dtype=torch.bool)
    valid[1] = False
    ok = _volume_check(cuda, dtype, proj, feats, valid, dim, vs,
                       (0.0, 0.0, 0.0))
    assert ok.any() and not ok.all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged", "one_view", "blind", "inside"])
def test_volume_kernel_tiles(cuda, dtype, case):
    """The tiled kernel's edges: a grid that is not a multiple of the 8x8x4
    tile; one view; invalid views and views that see nothing (all voxels
    behind the camera, or all projected 10,000 pixels off the image), which
    every tile culls; cameras inside the volume, so tiles cross their
    camera planes."""
    vs, origin = 0.3, (0.0, 0.0, 0.0)
    views, h, w, dim = {"ragged": (5, 24, 32, (20, 12, 10)),
                        "one_view": (1, 30, 40, (17, 9, 23)),
                        "blind": (6, 24, 32, (16, 16, 16)),
                        "inside": (4, 60, 80, (40, 40, 20))}[case]
    if case == "inside":
        vs = 0.4          # 16 x 16 x 8 m around a ring of radius 3 m
    proj, feats = _ring_scene(views, h, w, dim, vs, seed=1)
    valid = torch.ones(views, dtype=torch.bool)
    if case == "blind":
        valid[0] = False
        proj[2, 2, 3] = -1e3                                # all behind
        proj[4, 0, :] += 1e4 * proj[4, 2, :]                # off the image
    if case == "inside":
        eye = [np.linalg.solve(p[:, :3], -p[:, 3]) for p in proj]
        assert all((0 < e).all() and (e < np.array(dim) * vs).all()
                   for e in eye)
    ok = _volume_check(cuda, dtype, proj, feats, valid, dim, vs, origin)
    assert ok.any()
    if case == "blind":                   # views 0, 2 and 4 add nothing
        seen = torch.tensor([False, True, False, True, False, True])
        want = bp.volume_accum_plain(
            torch.from_numpy(proj).to(cuda), feats.to(cuda, dtype),
            seen.to(cuda), dim, vs, origin)
        got = bp.volume_accum_cuda(
            torch.from_numpy(proj).to(cuda), feats.to(cuda, dtype),
            valid.to(cuda), dim, vs, origin)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def _rm_scene(cuda, views, h, w, dim, vs):
    tsdf = -sphere_tsdf(dim, vs, radius=0.3 * min(dim) * vs,
                        trunc=3 * vs).to(cuda)
    proj = torch.from_numpy(ring_projections(views, 4 * h, 4 * w, dim, vs))
    proj[:, :2, :] /= 4
    valid = torch.ones(views, dtype=torch.bool, device=cuda)
    valid[1] = False
    return tsdf, proj.to(cuda), valid


@pytest.mark.parametrize("views,h,w,dim,step,skip", [
    (3, 24, 32, (64, 64, 32), 4, True),
    (4, 60, 80, (128, 96, 48), 8, True),
    (3, 24, 32, (64, 64, 32), 8, False)])
def test_ray_march_kernel_matches_plain(cuda, views, h, w, dim, step, skip):
    """The scene kernel against ``march_rays_plain``: j0/has_hit equal,
    kept sets equal outside the threshold band, weights within 1e-5; the
    invalid view emits nothing."""
    vs, n_samples = 0.04, 300
    tsdf, proj, valid = _rm_scene(cuda, views, h, w, dim, vs)
    occ = rm.build_occupancy(tsdf, 8) if skip else None
    o, d = rm.get_ray_parameters(proj, h, w)
    args = (o, d, valid, tsdf, occ, (0.0, 0.0, 0.0), vs, n_samples, 0.05,
            8, 48, step)
    before = rm.RAY_MARCH.launches
    got = rm.march_rays_cuda(*args)
    want = rm.march_rays_plain(*args)
    torch.cuda.synchronize()
    assert rm.RAY_MARCH.launches == before + 1
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert 0 < int(got[3].sum()) < (views - 1) * h * w or not skip
    assert not got[0][1].any() and not got[3][1].any()
    differ, err = rm.kept_mismatch(got[:2], want[:2], n_samples, 0.05)
    assert differ == 0 and err <= 1e-5
    assert int((got[0] > 0).sum()) > 100


@pytest.mark.parametrize("capacity", [4096, 300])
def test_ray_march_scene_selection_on_card(cuda, capacity):
    """The batched per-view selection and payload on the card equal the
    same functions on the CPU, on the kernel's own output.  The valid views
    keep about 4,100, 870 and 870 samples: capacity 4096 mixes the ranked
    branch (view 0) and the compact one in one batch, 300 ranks every
    valid view."""
    h, w, dim, vs = 60, 80, (128, 96, 48), 0.04
    tsdf, proj, valid = _rm_scene(cuda, 4, h, w, dim, vs)
    o, d = rm.get_ray_parameters(proj, h, w)
    weight, sample, _, _ = rm.march_rays_cuda(
        o, d, valid, tsdf, rm.build_occupancy(tsdf, 8), (0.0, 0.0, 0.0), vs,
        300, 0.05, 8, 48, 8)
    t_one = math.sqrt(sum(n * n for n in dim)) * vs / 300
    views = torch.arange(4, device=cuda)
    got = rm._points(weight, sample, o, d, views, t_one, w, capacity)
    want = rm._points(*(t.cpu() for t in (weight, sample, o, d, views)),
                      t_one, w, capacity)
    counts = (weight > 0).flatten(1).sum(1).cpu()
    assert (counts[[0, 2, 3]] > 300).all() and counts[1] == 0
    assert (counts > 4096).any() and (counts[[2, 3]] <= 4096).all()
    for g, c in zip(got, want):
        assert torch.equal(g.cpu(), c)


@pytest.mark.parametrize("xalign", [bp_probe.XALIGN, 1])
def test_rect_gather_kernel_matches_plain(cuda, xalign):
    s = dict(bp_probe.CHECK_SHAPE, K1=37, t3=200)
    featq, ryq0, rx0, code = bp_probe.synth(np.random.RandomState(0), **s,
                                            xalign=xalign)
    code[0, :3] = [-1, -(2 ** 31), 2 ** 30]        # invalid codes give 0
    args = (*bp_probe.to_device(cuda, featq, ryq0, rx0, code), s["Rhq"],
            s["Rw"])
    got = bp_probe.rect_gather_cuda(*args)
    want = bp_probe.rect_gather_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert got.abs().sum() > 0


def test_probe_kernels_refuse_wide_indices(cuda):
    """An int64 index above 2**31 is refused, not narrowed: narrowed, it
    would wrap into the table, where the plain version gives 0."""
    table = torch.zeros(4, 128, device=cuda)
    wide = torch.full((1, 128), 2 ** 31 + 5, dtype=torch.int64, device=cuda)
    assert not gather_probe.lane_gather_plain(table + 1, wide).any()
    with pytest.raises(TypeError, match="must be int32"):
        gather_probe.lane_gather_cuda(table, wide)
    with pytest.raises(TypeError, match="must be int32"):
        gather_probe.flat_gather_cuda(table, wide[0])


def _int_bf16(rng, shape, dev):
    """Random integers in [-4, 4] as bf16: their products and sums are exact
    in fp32, so a kernel that reads one element in the wrong place shows."""
    return torch.from_numpy(rng.randint(-4, 5, shape)).to(dev, torch.bfloat16)


@pytest.mark.parametrize("M,K,N", [(128, 256, 128), (16, 16, 16),
                                   (48, 64, 192), (128, 512, 128)],
                         ids=["probe", "one_box_corner", "m48_n192",
                              "k512_ring"])
def test_dot_kernel_exact_on_integers(cuda, M, K, N):
    """The wgmma kernel on random integers, tolerance 0: the probe's shape
    (whose own all-ones input cannot see a permuted row or column), one
    16x16x16 corner of a TMA box, M and N that are not multiples of the
    64-wide tile, and K = 512, which goes around the ring of 4 stages."""
    rng = np.random.RandomState(M + K + N)
    a, b = _int_bf16(rng, (M, K), cuda), _int_bf16(rng, (K, N), cuda)
    before = feature_probe.LAUNCHES["dot"].launches
    got = feature_probe.dot_cuda(a, b)
    torch.cuda.synchronize()
    assert feature_probe.LAUNCHES["dot"].launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.equal(got, feature_probe.dot_plain(a, b))


@pytest.mark.parametrize("n", [1, 3, 5, 1003])
@pytest.mark.parametrize("offset", [0, 1])
def test_flat_gather_kernel_edges(cuda, n, offset):
    """The flat gather at its edges: n of 1, 3 and 5 (less than a warp) and
    1003 (a ragged last block), an index tensor that starts one element
    past a 16-byte boundary, and indices outside the table at the head,
    the middle and the tail (0 there)."""
    rng = np.random.RandomState(n + offset)
    table = torch.from_numpy(rng.rand(96 * 128).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.randint(0, table.numel(), n + offset)
                           .astype(np.int32)).to(cuda)[offset:]
    if offset:
        assert idx.data_ptr() % 16 == 4
    bad = [-1, table.numel(), 2 ** 31 - 1]
    for pos, value in zip([0, n // 2, n - 1], bad):
        idx[pos] = value
    got = gather_probe.flat_gather_cuda(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_probe.flat_gather_plain(table, idx))
    assert got[0] == 0 and got[n - 1] == 0 and got[n // 2] == 0


def test_flat_gather_kernel_at_probe_size(cuda):
    """The probe's full size: 5.76M queries into the 2.95M-element table,
    with the index tensor offset by one element."""
    rng = np.random.RandomState(0)
    flat, _, idx = gather_probe.tables(rng, cuda, gather_probe.ROWS,
                                       gather_probe.HW * gather_probe.NS + 1)
    idx = idx[1:]
    got = gather_probe.flat_gather_cuda(flat, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_probe.flat_gather_plain(flat, idx))


def test_gather_probe_kernels_match_plain(cuda):
    rows = 96
    rng = np.random.RandomState(0)
    flat, table2d, idx = gather_probe.tables(rng, cuda, rows, 1000 + 3)
    idx[:3] = torch.tensor([-1, rows * 128, 2 ** 31 - 1])    # out of range
    idx2d = gather_probe.lane_indices(rng, cuda, rows)[:77].clone()
    idx2d[0, :2] = torch.tensor([-5, rows])
    got = gather_probe.lane_gather_cuda(table2d, idx2d)
    assert torch.equal(got, gather_probe.lane_gather_plain(table2d, idx2d))
    got = gather_probe.flat_gather_cuda(flat, idx)
    assert torch.equal(got, gather_probe.flat_gather_plain(flat, idx))
    assert not got[:3].any()


@pytest.mark.parametrize("R,L,n_rows,offset", [
    (23040, 128, 23040, 0),      # the probe's
    (23041, 128, 5000, 0),       # R odd, n_rows != R
    (97, 128, 300, 0),           # a short table
    (23040, 20, 1000, 0),        # L not a multiple of 4 or 8
    (23041, 20, 1000, 1),        # a table 4 bytes past 16-byte alignment
    (23041, 4, 777, 0),          # L = 4
    (5001, 128, 100, 0),         # few idx rows
    (929792, 4, 100, 0),         # a tall table
], ids=["probe", "R23041", "R97", "L20", "L20_unaligned", "L4", "R5001",
        "tall"])
def test_lane_gather_kernel_edges(cuda, R, L, n_rows, offset):
    """The lane gather against the plain version, tolerance 0, with indices
    -1, R, 0, R - 1 and the first and last row of each eighth of the table,
    each filling the first and the last idx rows."""
    rng = np.random.RandomState(R + L + offset)
    flat = torch.from_numpy(rng.rand(R * L + offset).astype(np.float32))
    table = flat.to(cuda)[offset:].view(R, L)
    idx = rng.randint(0, R, (n_rows, L)).astype(np.int32)
    share = -(-R // 8)
    edges = [-1, R, 0, R - 1] + [r * share + d for r in range(1, 8)
                                 for d in (-1, 0) if r * share + d < R]
    assert 2 * len(edges) <= n_rows
    idx[:len(edges)] = np.array(edges, np.int32)[:, None]
    idx[n_rows - len(edges):] = np.array(edges[::-1], np.int32)[:, None]
    idx = torch.from_numpy(idx).to(cuda)
    want = gather_probe.lane_gather_plain(table, idx)
    before = gather_probe.LANE_GATHER.launches
    got = gather_probe.lane_gather_cuda(table, idx)
    torch.cuda.synchronize()
    assert gather_probe.LANE_GATHER.launches == before + 1
    assert torch.equal(got, want)
    assert not got[0].any() and not got[1].any()


@pytest.mark.parametrize("M,R,D,offset", [
    (1, 256, 128, 0), (17, 256, 128, 0), (128, 256, 128, 0),
    (128, 2048, 128, 0),         # a 512 KB table
    (64, 300, 24, 0),            # three 16-byte pieces a row
    (33, 100, 20, 0),            # D not a multiple of 8: one element a thread
    (40, 256, 128, 1),           # a table 2 bytes past 16: one element a thread
])
def test_onehot_kernel_edges(cuda, M, R, D, offset):
    """The direct row gather against its plain version (tolerance 0), with
    indices -1, R and 2**31 - 1 where M allows."""
    rng = np.random.RandomState(M + R + D + offset)
    buf = torch.from_numpy(rng.randn(R * D + offset)).to(cuda, torch.bfloat16)
    tab = buf[offset:].view(R, D)
    idx = rng.randint(0, R, M).astype(np.int32)
    if M > 2:
        idx[[0, M // 2, M - 1]] = [-1, R, 2 ** 31 - 1]
    idx = torch.from_numpy(idx).to(cuda)
    got = feature_probe.onehot_cuda(idx, tab)
    torch.cuda.synchronize()
    assert got.shape == (M, D)
    assert torch.equal(got, feature_probe.onehot_plain(idx, tab))


@pytest.mark.parametrize("R,D,row0,rows", [
    (64, 128, 8, 8),             # the probe's: one block of 256 pieces
    (100, 128, 3, 94),           # 47 KB, the old form's most
    (50, 20, 7, 13),             # 65 pieces: no multiple of 256 x 16 B
    (9, 4, 0, 1),                # one piece
    (4096, 128, 1, 4000),        # 2 MB: many blocks
], ids=["probe", "47KB", "65_pieces", "one_piece", "2MB"])
def test_dma_kernel_offsets_and_sizes(cuda, R, D, row0, rows):
    """dma at several row offsets and sizes, equal to 2 x (tolerance 0);
    a slice that starts off a 16-byte boundary is refused."""
    rng = np.random.RandomState(R + D + row0)
    x = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(cuda)
    before = feature_probe.LAUNCHES["dma"].launches
    got = feature_probe.dma_cuda(x, row0, rows)
    torch.cuda.synchronize()
    assert feature_probe.LAUNCHES["dma"].launches == before + 1
    assert torch.equal(got, feature_probe.dma_plain(x, row0, rows))
    shifted = x.reshape(-1)[1:1 + (R - 1) * D].view(R - 1, D)
    with pytest.raises(ValueError, match="16-byte aligned"):
        feature_probe.dma_cuda(shifted, row0, rows)


@pytest.mark.parametrize("name", feature_probe.NAMES)
def test_feature_probe_kernel_matches_plain(cuda, name):
    args_k, want = feature_probe.probe_inputs(name, cuda)
    args_p, _ = feature_probe.probe_inputs(name, cuda)
    got, ref = feature_probe.KERNELS[name][0](*args_k), \
        feature_probe.KERNELS[name][1](*args_p)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert np.array_equal(got.cpu().numpy(), want)
    if name == "alias":
        assert got.data_ptr() == args_k[0].data_ptr()


def test_feature_probe_kernels_off_the_probe_shapes(cuda):
    """dot on integer matrices of another shape (exact in fp32), onehot with
    indices outside the table and a table above 64 KB, dyn_slice with a
    start past the end (clamped), prefetch with a skipped id."""
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randint(-4, 5, (48, 64))).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.randint(-4, 5, (64, 32))).to(cuda, torch.bfloat16)
    assert torch.equal(feature_probe.dot_cuda(a, b),
                       feature_probe.dot_plain(a, b))
    tab = torch.from_numpy(rng.randn(400, 128)).to(cuda, torch.bfloat16)
    idx = torch.from_numpy(rng.randint(-3, 403, 70).astype(np.int32)).to(cuda)
    assert torch.equal(feature_probe.onehot_cuda(idx, tab),
                       feature_probe.onehot_plain(idx, tab))
    x = torch.from_numpy(rng.randn(20, 64).astype(np.float32)).to(cuda)
    start = torch.tensor([17], dtype=torch.int32, device=cuda)
    assert torch.equal(feature_probe.dyn_slice_cuda(start, x, 8),
                       x[12:20])
    xb = x.reshape(5, 4, 64)
    tids = torch.tensor([4, 0, 7, 1, 2], dtype=torch.int32, device=cuda)
    assert torch.equal(feature_probe.prefetch_cuda(tids, xb),
                       feature_probe.prefetch_plain(tids, xb))
    assert torch.equal(feature_probe.dma_cuda(x, 3, 12), 2 * x[3:15])
