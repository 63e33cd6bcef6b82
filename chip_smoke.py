#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain torch version at the full ScanNet shapes,
drives the CN-RMA test-mode forward once at full width, and checks a small
input against the CPU reference path.

    python3 chip_smoke.py

Phases (each prints a few lines; any failure raises and exits non-zero):
  1. device: CUDA required; card name and power limit from nvidia-smi.
  2. build: every kernel source in cnrma_torch/csrc through nvcc; then
     ``cuobjdump`` of the library: the dot kernel's SASS must hold the
     tensor cores' warpgroup MMA (HGMMA) and the TMA load (UTMALDG), and
     the registers and local memory of the dot, flat gather, lane gather
     and onehot kernels are logged.
  3. volume kernel vs plain at the full_ship shape (50 views of
     [120, 160, 32], 256x256x96 voxels at 4 cm), fp32 and bf16; the
     pixel-row reads (hits) against the distinct rows.
  4. ray-march kernel vs plain at the full_ship shape (50 views x 19,200
     rays, 38 coarse steps, a 48-sample window) on a planted ball TSDF
     and its occupancy grid: j0/has_hit equal, kept sets equal outside
     the threshold band, weights within 1e-5.
  5. end to end: one full_ship scene through ``CNRMA`` in bf16 with
     bench.py's synthesized parameters; each kernel launched once, output
     shapes and finiteness, warm forward time, the ray-march stage alone
     (CUDA events), peak memory; the ray-march stage once more with CUDA
     sync debugging set to "error", so a host sync inside it fails.
  5b. surface: the same model's ray march and detector on a planted ball
     TSDF, so that points and boxes come out at full size; the ray-march
     stage alone beside them.
  6. reference: a tiny scene in fp32 on the GPU (kernels) and on the CPU
     (plain versions), same parameters and draw; TSDFs, points and boxes
     must agree.
  6b. test CLI: two synthetic ScanNet scenes written on disk (60 frames
     of 1296x968 JPEG, a room TSDF over the 256x256x96 grid, the planted
     boxes as GT) through ``python -m cnrma_torch.tools.test`` with
     ``configs/ray_marching_scannet.py`` at its own test widths and
     default-initialised parameters saved as a ``.pt`` checkpoint; each
     scene's four files checked, K1 and K2 launched once a scene, the
     per-scene seconds, mesh faces, PLY bytes and peak memory printed; the
     torch ``nms_bbox`` and ``evaluate_bbox`` on the results (mAP printed)
     and on planted dumps equal to the GT (mAP@0.25 and mAP@0.50 exactly
     1.0; shifted up by dz/2, mAP@0.50 exactly 0); one scene again with
     ``CNRMA_CAPACITY_DEBUG=1``, its capacity lines printed.
  7. probes: first the dot kernel on random integers in [-4, 4] at the
     probe's 128x256x128 (exact in fp32, tolerance 0; the probe's own
     all-ones input cannot see a permuted row or column); then the three
     probe tools (``cnrma_torch.tools.bp_probe bench``, ``gather_probe``,
     ``feature_probe``) at their bench shapes, with the launch counts set
     to 0 before and read after; then each of their kernels against its
     plain version (tolerance 0: every one is a copy, a gather or an exact
     product) and timed beside it and beside the one PyTorch call that
     computes the same function, where there is one.
  8. device time: every kernel's device time per call in a
     ``torch.profiler`` trace (``device_ms``: its own ``__global__``
     function only), its library call's (``library_device_ms``: all the
     call's device work), and the launch floor (``floor_ms``, on every
     row: the device time of an empty kernel, one block of 32 threads);
     last, because a profiler session slows the host's later launches.
Every kernel row carries its bound: the larger of the bytes its function
must move (each input read once, each output written once, counted from
this run's data) over 3.35 TB/s and its operations over the peak rate of
their type (H100 SXM data sheet).  Its ``ms`` is CUDA events around one
call, so it holds the host's launch work, which dominates calls under
~0.1 ms; ``device_ms`` leaves that out.  The line before the last is the
kernel table as JSON; the last line is the device record.
"""

import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from cnrma_torch.timing import time_ms

# H100 SXM data sheet: HBM bytes/s, fp32 (outside the tensor cores) and
# dense bf16 tensor-core operations/s
PEAK = {"bytes": 3.35e12, "fp32": 67e12, "bf16_tensor": 989e12}

FULL_SHIP = dict(voxel_dim=(256, 256, 96), voxel_size=0.04, views=50, h=480,
                 w=640, ray_samples=300, rays_cap=98304, max_points=500000,
                 coarse_step=8, skip_factor=8)


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, kernel=None, reps: int = 10, tries: int = 5):
    """Device time of one call of ``fn``: in a profiler trace of ``reps``
    calls, the summed time of the device work over ``reps``, counting only
    the ``__global__`` function named ``kernel`` where it is given (not the
    wrapper's fills or copies).  Now and then a trace holds the launches
    but no device event at all, in runs of one to three traces that
    recur every few seconds (``python -m cnrma_torch.tools.trace_check``
    counts them); such a trace is taken again, up to ``tries`` traces in
    all.  None where none holds the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    named = None if kernel is None else re.compile(rf"\b{kernel}\b")
    fn()
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation
                 and (named is None or named.search(e.name)))
        if us > 0:
            return us / reps / 1e3
        log(f"[device time] trace {attempt + 1} of {kernel or 'library'} "
            f"held no device time")
    return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(nbytes: float, ops: float, ops_type: str = "fp32") -> dict:
    """Least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / PEAK["bytes"] * 1e3
    t_ops = ops / PEAK[ops_type] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); this script runs only "
                         "on a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    # fp32 means fp32: no TF32 in convolutions or matmuls (the main path
    # itself runs in bf16)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; count {torch.cuda.device_count()}")
    log(f"[device] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    log(smi)
    return name


# instructions each kernel's SASS must hold: the dot kernel runs on the
# tensor cores through wgmma (HGMMA) fed by TMA loads (UTMALDG)
SASS_MUST_HOLD = {"dot_kernel": ("HGMMA", "UTMALDG")}
RESOURCES_LOGGED = ("dot_kernel", "flat_gather_kernel", "lane_gather_kernel",
                    "onehot_kernel")


def _functions(text: str, pattern: str) -> dict:
    """``cuobjdump`` output split per function: {mangled name: its text}."""
    parts = re.split(pattern, text)
    return dict(zip(parts[1::2], parts[2::2]))


def _named(functions: dict, kernel: str) -> str:
    """The text of the one function named ``kernel``, matched by its
    length-prefixed mangled name, so that a longer name ending in the same
    words does not match."""
    found = [text for name, text in functions.items()
             if f"{len(kernel)}{kernel}" in name]
    if len(found) != 1:
        raise AssertionError(f"cuobjdump: {len(found)} functions named "
                             f"{kernel}")
    return found[0]


def sass_check() -> None:
    """``cuobjdump`` of the built library: raise unless each kernel of
    ``SASS_MUST_HOLD`` holds its instructions; log the registers and local
    memory of ``RESOURCES_LOGGED``."""
    from cnrma_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")

    def dump(flag):
        return subprocess.run([tool, flag, str(_build.library_path())],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
    sass = _functions(dump("-sass"), r"\n\s*Function : (\S+)")
    for kernel, ops in SASS_MUST_HOLD.items():
        text = _named(sass, kernel)
        missing = [op for op in ops if op not in text]
        if missing:
            raise AssertionError(f"{kernel}: SASS holds no {missing}")
        log(f"[build] {kernel} SASS holds " + ", ".join(
            f"{op} x{text.count(op)}" for op in ops))
    usage = _functions(dump("-res-usage"), r"Function (\S+):")
    for kernel in RESOURCES_LOGGED:
        text = _named(usage, kernel)
        regs = re.search(r"REG:(\d+)", text).group(1)
        local = re.search(r"LOCAL:(\d+)", text).group(1)
        log(f"[build] {kernel}: {regs} registers, {local} B local memory")


def phase_build() -> None:
    from cnrma_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} "
        f"s from {_build.CSRC}")
    sass_check()


def full_ship_projections(dev) -> torch.Tensor:
    from cnrma_torch.synthetic import ring_projections
    c = FULL_SHIP
    proj = ring_projections(c["views"], c["h"], c["w"], c["voxel_dim"],
                            c["voxel_size"])
    return torch.from_numpy(proj).to(dev)


def volume_args(dev, dtype) -> tuple:
    """The volume kernel's arguments at the full_ship shape: 50 views of
    [120, 160, 32] features drawn from seed 0, one view left out."""
    c = FULL_SHIP
    v, h, w = c["views"], c["h"] // 4, c["w"] // 4
    proj = full_ship_projections(dev)
    proj[:, :2, :] /= 4
    feats = torch.rand(v, h, w, 32, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev).to(dtype)
    view_valid = torch.ones(v, dtype=torch.bool, device=dev)
    view_valid[v // 2] = False
    return (proj, feats, view_valid, c["voxel_dim"], c["voxel_size"],
            (0.0, 0.0, 0.0))


def phase_volume(dev) -> dict:
    from cnrma_torch.ops import backproject as bp
    row = None
    for dtype, tol_name in ((torch.float32, "1e-6"),
                            (torch.bfloat16, "one bf16 ulp of the mean")):
        args = volume_args(dev, dtype)
        vol, cnt, ok = bp.volume_accum_cuda(*args)
        pvol, pcnt, pok = bp.volume_accum_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(ok, pok) or not torch.equal(cnt, pcnt):
            raise AssertionError(f"volume kernel: valid mask or counts "
                                 f"differ from the plain version ({dtype})")
        err = (vol.float() - pvol.float()).abs()
        tol = (torch.full_like(err, 1e-6) if dtype == torch.float32
               else 2.0 ** -7 * pvol.float().abs())
        if not bool((err <= tol).all()):
            raise AssertionError(f"volume kernel: error {err.max().item()} "
                                 f"beyond {tol_name} ({dtype})")
        ms = time_ms(lambda: bp.volume_accum_cuda(*args), dev)
        plain_ms = time_ms(lambda: bp.volume_accum_plain(*args), dev)
        log(f"[volume] {str(dtype)[6:]}: mask+counts equal, max|err| "
            f"{err.max().item():.3g} (tol {tol_name}); observed voxels "
            f"{ok.float().mean().item():.4f}, max views "
            f"{cnt.max().item():.0f}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms")
        nbytes, ops, reached = volume_work(*args, cnt)
        hits = int(cnt.sum())
        row = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                   **bound(nbytes, ops))
        log(f"[volume] {str(dtype)[6:]}: bound {row['bound_ms']:.4f} ms "
            f"by {row['bound_by']}; pixel-row reads (hits) {hits}, distinct "
            f"rows reached {reached}, ratio {hits / reached:.1f}")
    return row            # the main path's dtype (bf16) is measured last


def volume_work(proj, feats, view_valid, voxel_dim, voxel_size, origin,
                cnt):
    """(bytes, fp32 operations, distinct pixel rows reached) of the volume
    function on these inputs.
    Bytes: the feature rows some voxel reaches, the projections and view
    flags, the volume, count and mask written.  Operations: 6 per voxel
    (its centre), 21 per voxel and valid view (projection: 18, one
    reciprocal, two products), 33 per view that sees a voxel (32 channel
    sums and the count), 32 per observed voxel (the mean)."""
    from cnrma_torch.ops import backproject as bp
    V, H, W, C = feats.shape
    n = cnt.numel()
    esize = feats.element_size()
    reached = 0
    for v in range(V):
        if not bool(view_valid[v]):
            continue
        flat, valid = bp.project_voxels(proj[v], voxel_dim, voxel_size,
                                        origin, H, W)
        seen = torch.zeros(H * W, dtype=torch.bool, device=feats.device)
        seen[flat[valid]] = True
        reached += int(seen.sum())
    n_views = int(view_valid.sum())
    nbytes = (reached * C * esize + proj.numel() * 4 + V
              + n * C * esize + n * 4 + n)
    ops = (6.0 * n + 21.0 * n * n_views + 33.0 * float(cnt.sum())
           + 32.0 * int((cnt > 0).sum()))
    return nbytes, ops, reached


RAY_TOL = 1e-5          # NeuS weights: kernel against plain version


def planted_ball(dev) -> torch.Tensor:
    """A 0.5 m ball TSDF at the centre of the full_ship grid, positive
    inside (the sign the NeuS weights respond to): [X, Y, Z] fp32."""
    from cnrma_torch.synthetic import sphere_tsdf
    c = FULL_SHIP
    return -sphere_tsdf(c["voxel_dim"], c["voxel_size"], radius=0.5,
                        trunc=3 * c["voxel_size"]).to(dev)


def ray_args(dev) -> tuple:
    """The ray-march kernel's arguments at the full_ship shape: the rays of
    the 50 views, a planted 0.5 m ball TSDF (positive inside, the sign the
    NeuS weights respond to) and its occupancy grid, the march's
    constants."""
    from cnrma_torch.ops import ray_marching as rm
    c = FULL_SHIP
    vs = c["voxel_size"]
    tsdf = planted_ball(dev)
    proj = full_ship_projections(dev)
    proj[:, :2, :] /= 4
    o, d = rm.get_ray_parameters(proj, c["h"] // 4, c["w"] // 4)
    valid = torch.ones(c["views"], dtype=torch.bool, device=dev)
    return (o, d, valid, tsdf, rm.build_occupancy(tsdf, c["skip_factor"]),
            (0.0, 0.0, 0.0), vs, c["ray_samples"], 0.05, c["skip_factor"],
            48, c["coarse_step"])


def ray_work(args, j0, has_hit) -> tuple:
    """(bytes, fp32 operations) of the ray-march function on these inputs.
    Bytes: origins, directions, view flags, the packed occupancy grid, the
    distinct TSDF voxels the fine windows read, and the weights, sample
    ids, j0 and has_hit written.  Operations: 15 per coarse step taken
    (sample distance 3; per axis a product, two sums and a division), j0 + 1
    steps on a ray that hits and all of them on one that misses; 28 per
    fine sample of a ray that hits (position 7, voxel id 6, sigmoid 3,
    alpha 4, log1p 3, running sum and weight 4, threshold 1)."""
    from cnrma_torch.ops import ray_marching as rm
    o, d, valid, tsdf, occ, origin, vs, n_samples, thr, factor, window, \
        step = args
    V, HW = d.shape[:2]
    k_max = min(window, math.ceil(1.0 / thr))
    n_coarse = (n_samples + step - 1) // step
    X, Y, Z = tsdf.shape
    t_one = math.sqrt(X * X + Y * Y + Z * Z) * vs / n_samples
    start = torch.clamp(j0 * step - step, 0, n_samples - window)[has_hit]
    ts = (start[:, None] + torch.arange(window, device=d.device)).float() \
        * t_one
    places = o[:, None, :].expand(V, HW, 3)[has_hit][:, None, :] \
        + d[has_hit][:, None, :] * ts[..., None]
    flat, inside = rm._voxel_ids(places, origin, vs, tsdf.shape)
    n_tsdf = int(torch.unique(flat[inside]).numel())
    nbytes = (V * 12 + V * HW * 12 + V + rm.pack_occupancy(occ).numel()
              + 4 * n_tsdf + V * HW * (8 * k_max + 5))
    steps = float(torch.where(has_hit, j0 + 1,
                              torch.where(valid[:, None], n_coarse, 0)).sum())
    ops = 15.0 * steps + 28.0 * window * int(has_hit.sum())
    return nbytes, ops


def phase_ray_march(dev) -> dict:
    from cnrma_torch.ops import ray_marching as rm
    args = ray_args(dev)
    got = rm.march_rays_cuda(*args)
    want = rm.march_rays_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])):
        raise AssertionError("ray-march kernel: j0/has_hit differ from the "
                             "plain version")
    n_samples, thr = args[7], args[8]
    differ, err = rm.kept_mismatch(got[:2], want[:2], n_samples, thr)
    kept = int((got[0] > 0).sum())
    band = int(((got[0] - thr).abs() < 1e-5).sum())
    if differ or err > RAY_TOL or kept == 0:
        raise AssertionError(f"ray-march kernel: {differ} kept samples "
                             f"differ outside the threshold band, weight "
                             f"max|err| {err} (tol {RAY_TOL}), {kept} kept")
    V, HW = args[1].shape[:2]
    share = int(got[3].sum()) / (V * HW)
    ms = time_ms(lambda: rm.march_rays_cuda(*args), dev)
    plain_ms = time_ms(lambda: rm.march_rays_plain(*args), dev, reps=3)
    work = bound(*ray_work(args, got[2], got[3]))
    log(f"[ray march] {V} views x {HW} rays, one launch: j0/has_hit equal; "
        f"hit share {share:.4f}; kept samples {kept} ({band} within 1e-5 of "
        f"the threshold, masked), sets equal, weight max|err| {err:.3g} "
        f"(tol {RAY_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {work['bound_ms']:.6f} ms by {work['bound_by']}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **work)


def full_ship_model(dev):
    from cnrma_torch.models.cn_rma import CNRMA
    from cnrma_torch.models.fcaf3d import DetectionCapacities
    from cnrma_torch.synthetic import synthesize_parameters
    c = FULL_SHIP
    model = CNRMA(voxel_dim=c["voxel_dim"], voxel_size=c["voxel_size"],
                  n_classes=18, n_reg_outs=6, ray_samples=c["ray_samples"],
                  rays_per_view_cap=c["rays_cap"],
                  max_points=c["max_points"],
                  ray_skip_coarse_step=c["coarse_step"],
                  capacities=DetectionCapacities(
                      voxelize=409600, stride2=262144, stride4=131072,
                      levels=(32768, 12288, 4096, 2048),
                      neck=(262144, 65536, 16384)),
                  bp_accum_dtype="bfloat16", compute_dtype=torch.bfloat16)
    synthesize_parameters(model, seed=1)
    return model.to(dev).eval()


def full_ship_batch(dev) -> dict:
    """One full_ship scene: 50 views of 480x640 random pixels (seed 0),
    the ring projections, every view valid."""
    c = FULL_SHIP
    v, h, w = c["views"], c["h"], c["w"]
    rng = np.random.RandomState(0)
    return {
        "imgs": torch.from_numpy(
            rng.rand(1, v, h, w, 3).astype(np.float32) * 255).to(dev),
        "projection": full_ship_projections(dev)[None],
        "view_valid": torch.ones(1, v, dtype=torch.bool, device=dev),
        "offset": torch.zeros(1, 3, device=dev),
    }


def features_and_fine_tsdf(model, batch) -> tuple:
    """The forward's 2D features and its fine TSDF, the ray-march stage's
    inputs."""
    with torch.no_grad():
        feats = model.extract_2d(batch["imgs"])
        volume, _ = model.build_volume(feats, batch["projection"],
                                       batch["view_valid"])
        return feats, model.reconstruct(volume)["scene_tsdf_004"]


def time_ray_stage(dev, model, batch, feats, tsdf, reps: int = 5) -> float:
    """Median time by CUDA events of the ray-march stage alone
    (``CNRMA.ray_march``: scene march, point normalisation and subsample,
    feature gather) on these features and [1, X, Y, Z] TSDF."""
    args = (feats, batch["projection"], batch["view_valid"], tsdf)
    with torch.no_grad():
        return time_ms(lambda: model.ray_march(
            *args, torch.Generator(device=dev).manual_seed(0)), dev,
            reps=reps)


def ray_stage(dev, model, batch, feats, tsdf, tag: str) -> float:
    """``time_ray_stage``, after one run under CUDA sync debugging set to
    "error", where a host sync inside the stage raises."""
    args = (feats, batch["projection"], batch["view_valid"], tsdf)
    gen = torch.Generator(device=dev).manual_seed(0)
    model.ray_march(*args, gen)              # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.ray_march(*args, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = time_ray_stage(dev, model, batch, feats, tsdf)
    log(f"[{tag}] ray-march stage alone: {ms:.3f} ms (CUDA events, median "
        f"of 5); no host sync inside it")
    return ms


def phase_end_to_end(dev):
    from cnrma_torch.ops.backproject import VOLUME_ACCUM
    from cnrma_torch.ops.ray_marching import RAY_MARCH
    c = FULL_SHIP
    model = full_ship_model(dev)
    batch = full_ship_batch(dev)

    def forward():
        return model(batch, generator=torch.Generator(device=dev)
                     .manual_seed(0))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    VOLUME_ACCUM.launches = 0
    RAY_MARCH.launches = 0
    t0 = time.perf_counter()
    out = forward()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {"volume_accum": VOLUME_ACCUM.launches,
                "ray_march": RAY_MARCH.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[e2e] launches in one forward: {launches}")
    if launches != {"volume_accum": 1, "ray_march": 1}:
        raise AssertionError(f"one scene must launch each main-path kernel "
                             f"once: {launches}")
    X, Y, Z = c["voxel_dim"]
    k = 4 * model.detector.nms_pre      # the top rows of each of 4 levels
    checks = {"bboxes": (out["bboxes"], (1, k, 6)),
              "scores": (out["scores"], (1, k, 18)),
              "scene_tsdf_004": (out["tsdf"]["scene_tsdf_004"], (1, X, Y, Z))}
    for name, (t, shape) in checks.items():
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} (want "
                                 f"{shape}) or non-finite values")
    n_points = int(out["points"].valid.sum())
    times = []
    for _ in range(4):                   # one warm-up, then three timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"[e2e] full_ship bf16 forward: outputs finite, bboxes "
        f"{tuple(out['bboxes'].shape)} scores {tuple(out['scores'].shape)} "
        f"tsdf {tuple(checks['scene_tsdf_004'][0].shape)}; kept ray-march "
        f"points {n_points}; valid boxes {int(out['bbox_valid'].sum())}")
    log(f"[e2e] first forward {cold:.3f} s; warm forward median of 3: "
        f"{statistics.median(times[1:]) * 1e3:.1f} ms "
        f"({', '.join(f'{t * 1e3:.1f}' for t in times[1:])}); peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    feats, fine = features_and_fine_tsdf(model, batch)
    with torch.no_grad():
        ray_stage(dev, model, batch, feats, fine, "e2e")
    return launches, model, batch


def phase_surface(dev, model, batch) -> None:
    """The data-dependent half of the forward at full size.  bench.py's
    parameters give a TSDF that is flat near 0, so no ray-march sample
    clears the weight threshold and the detector sees an empty cloud; here
    the fine TSDF is a planted ball (0.5 m radius at the volume centre,
    positive inside, which is the sign the NeuS weights respond to) and the
    ray march and the detector run on it."""
    c = FULL_SHIP
    tsdf = planted_ball(dev)[None]
    with torch.no_grad():
        feats = model.extract_2d(batch["imgs"])

        def march_and_detect():
            pts = model.ray_march(feats, batch["projection"],
                                  batch["view_valid"], tsdf,
                                  torch.Generator(device=dev).manual_seed(0))
            xyz = pts.xyz + batch["offset"][:, None, :]
            return pts, model.detector.get_bboxes(
                model.detector(xyz, pts.feats, pts.valid))
        pts, (bboxes, scores, bvalid) = march_and_detect()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            march_and_detect()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ray_stage(dev, model, batch, feats, tsdf, "surface")
    n_points, n_boxes = int(pts.valid.sum()), int(bvalid.sum())
    finite = all(bool(torch.isfinite(t).all())
                 for t in (pts.xyz, pts.feats, bboxes, scores))
    log(f"[surface] planted ball, full_ship bf16: kept ray-march points "
        f"{n_points} of {c['max_points']}; valid boxes {n_boxes}; ray march "
        f"+ detection median of 3: {statistics.median(times) * 1e3:.1f} ms "
        f"({', '.join(f'{t * 1e3:.1f}' for t in times)})")
    if not finite or n_points == 0 or n_boxes == 0:
        raise AssertionError("planted surface: no points, no boxes or "
                             "non-finite values")


def phase_reference(dev) -> None:
    from cnrma_torch.models.cn_rma import CNRMA
    from cnrma_torch.models.fcaf3d import DetectionCapacities
    torch.manual_seed(0)
    model = CNRMA(voxel_dim=(16, 16, 16), voxel_size=0.1, n_classes=3,
                  ray_samples=64, rays_per_view_cap=512, max_points=1024,
                  pts_threshold=500, nms_pre=16, voxel_size_fcaf3d=0.05,
                  capacities=DetectionCapacities.tiny()).eval()
    rng = np.random.RandomState(0)
    intr = np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]], np.float32)
    E = np.eye(4, dtype=np.float32)
    E[:3, 3] = [0.8, 0.8, -0.4]
    proj = (intr @ np.linalg.inv(E)[:3]).astype(np.float32)
    batch = {"imgs": torch.from_numpy(
                 rng.rand(1, 2, 32, 32, 3).astype(np.float32) * 255),
             "projection": torch.from_numpy(np.broadcast_to(
                 proj, (1, 2, 3, 4)).copy()),
             "view_valid": torch.ones(1, 2, dtype=torch.bool),
             "offset": torch.zeros(1, 3)}
    uniform = torch.from_numpy(rng.rand(1, 2 * 512).astype(np.float32))
    ref = model(batch, uniform=uniform)
    model.to(dev)
    got = model({k: t.to(dev) for k, t in batch.items()},
                uniform=uniform.to(dev))
    tsdf_err = max((got["tsdf"][k].cpu() - ref["tsdf"][k]).abs().max().item()
                   for k in ref["tsdf"])
    n_ref = int(ref["points"].valid.sum())
    n_got = int(got["points"].valid.sum())

    def boxes(o):
        v = o["bbox_valid"][0].cpu()
        s = o["scores"][0].cpu()[v]
        b = o["bboxes"][0].cpu()[v]
        order = torch.argsort(s.max(dim=1).values, descending=True)
        return b[order], s[order]
    rb, rs = boxes(ref)
    gb, gs = boxes(got)
    log(f"[reference] tiny fp32 scene, GPU vs CPU: tsdf max|err| "
        f"{tsdf_err:.3g}; points {n_got} vs {n_ref}; valid boxes "
        f"{len(gb)} vs {len(rb)}")
    if tsdf_err > 1e-4 or n_ref == 0 or n_got != n_ref or len(gb) != len(rb):
        raise AssertionError("GPU path disagrees with the CPU reference")
    box_err = (gb - rb).abs().max().item() if len(rb) else 0.0
    score_err = (gs - rs).abs().max().item() if len(rb) else 0.0
    log(f"[reference] boxes max|err| {box_err:.3g}, scores max|err| "
        f"{score_err:.3g} (tol 1e-3)")
    if box_err > 1e-3 or score_err > 1e-3:
        raise AssertionError("GPU boxes disagree with the CPU reference")


CLI_CONFIG = "configs/ray_marching_scannet.py"
CLI_FILES = ("{s}.npz", "{s}.ply", "{s}_bbox_raw.npz")


def _check_scene_files(save: str, middle: str, scene: str, dim) -> dict:
    """Raise unless a scene's four result files hold the right keys, shapes
    and finite values and its raw boxes are not empty; returns the counts
    of raw boxes and middle points."""
    d = os.path.join(save, scene)
    for f in CLI_FILES:
        if not os.path.isfile(os.path.join(d, f.format(s=scene))):
            raise AssertionError(f"{scene}: {f.format(s=scene)} missing")
    with np.load(os.path.join(d, scene + ".npz")) as z:
        tsdf, origin = z["tsdf"], z["origin"]
        ok = (tsdf.shape == tuple(dim) and origin.shape == (1, 3)
              and float(z["voxel_size"]) == 0.04
              and np.isfinite(tsdf).all() and np.isfinite(origin).all())
    with open(os.path.join(d, scene + ".ply"), "rb") as f:
        ok &= f.read(3) == b"ply"
    with np.load(os.path.join(d, scene + "_bbox_raw.npz")) as z:
        b, sc = z["bboxes"], z["scores"]
        ok &= (b.ndim == 2 and b.shape[1] == 6 and sc.shape == (len(b), 18)
               and len(b) > 0 and np.isfinite(b).all()
               and np.isfinite(sc).all())
    vert = np.load(os.path.join(middle, scene + "_vert.npy"))
    ok &= vert.ndim == 2 and vert.shape[1] == 35 and np.isfinite(vert).all()
    if not ok:
        raise AssertionError(f"{scene}: a result file has the wrong keys, "
                             f"shapes or values (raw boxes {len(b)})")
    return {"raw_boxes": len(b), "middle_points": len(vert)}


def _plant_dumps(data: str, out: str, scenes, shift: bool) -> None:
    """Raw box dumps whose every prediction is a GT box of its scene (score
    0.9 in its class, 0.001 elsewhere), optionally shifted up by dz/2."""
    from cnrma_torch.tools.evaluate_bbox import SCANNET_CAT_IDS
    for scene in scenes:
        gt = np.load(os.path.join(data, "scannet_instance_data",
                                  scene + "_aligned_bbox.npy"))
        boxes = gt[:, :6].astype(np.float32).copy()
        if shift:
            boxes[:, 2] += boxes[:, 5] / 2
        labels = [SCANNET_CAT_IDS.index(int(c)) for c in gt[:, 6]]
        scores = np.full((len(gt), 18), 0.001, np.float32)
        scores[np.arange(len(gt)), labels] = 0.9
        os.makedirs(os.path.join(out, scene), exist_ok=True)
        np.savez(os.path.join(out, scene, scene + "_bbox_raw.npz"),
                 bboxes=boxes, scores=scores)


def _score(data: str, results: str) -> dict:
    from cnrma_torch.tools import evaluate_bbox, nms_bbox
    with contextlib.redirect_stdout(io.StringIO()):
        nms_bbox.main(["--result_path", results])
        return evaluate_bbox.main(["--data_path", data,
                                   "--result_path", results])


def phase_test_cli(dev) -> None:
    """The user's loop on the card: the torch test CLI over two synthetic
    ScanNet scenes at the config's own test widths, then the torch NMS and
    mAP; planted dumps whose answer is known; one scene with the capacity
    report on."""
    from cnrma_torch.core.builder import build_model
    from cnrma_torch.core.config import Config
    from cnrma_torch.ops.backproject import VOLUME_ACCUM
    from cnrma_torch.ops.ray_marching import RAY_MARCH
    from cnrma_torch.synthetic import write_scannet
    from cnrma_torch.tools import test as test_cli
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="cli_", dir="build")
    try:
        t0 = time.perf_counter()
        data = os.path.join(root, "data")
        ann = write_scannet(data, n_scenes=2, n_frames=60)
        cfg = Config.fromfile(CLI_CONFIG)
        dim = tuple(cfg.model.voxel_dim_test)
        torch.manual_seed(0)
        ckpt = os.path.join(root, "init.pt")
        torch.save(build_model(cfg).state_dict(), ckpt)
        log(f"[cli] wrote 2 scenes (60 frames of 1296x968 JPEG, room TSDF "
            f"over {dim}) and a default-initialised checkpoint in "
            f"{time.perf_counter() - t0:.1f} s")
        save, middle = os.path.join(root, "res"), os.path.join(root, "mid")
        argv = [CLI_CONFIG, ckpt, "--save-path", save, "--middle-save-path",
                middle, "--cfg-options", f"data.test.data_root={data}",
                f"data.test.ann_file={ann}"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        VOLUME_ACCUM.launches = 0
        RAY_MARCH.launches = 0
        t0 = time.perf_counter()
        records = test_cli.main(argv + ["--max-scenes", "2"])
        wall = time.perf_counter() - t0
        launches = {"volume_accum": VOLUME_ACCUM.launches,
                    "ray_march": RAY_MARCH.launches}
        peak = torch.cuda.max_memory_allocated()
        log(f"[cli] {len(records)} scenes in {wall:.2f} s; launches "
            f"{launches}; peak memory {peak / 2 ** 30:.2f} GiB")
        if launches != {"volume_accum": 2, "ray_march": 2}:
            raise AssertionError(f"two scenes must launch each main-path "
                                 f"kernel twice: {launches}")
        scenes = sorted(os.listdir(save))
        if scenes != ["scene0000_00", "scene0001_00"] or len(records) != 2:
            raise AssertionError(f"--max-scenes 2 wrote {scenes}")
        for r in records:
            r.update(_check_scene_files(save, middle, r["scene"], dim))
            log(f"[cli] {r['scene']}: load {r['load_s']:.3f} s (waited "
                f"{r['wait_s']:.3f}), forward {r['forward_s']:.3f} s, write "
                f"{r['write_s']:.3f} s (mesh {r['mesh_s']:.3f} s); "
                f"{r['faces']} faces, {r['ply_bytes']} PLY bytes; "
                f"{r['raw_boxes']} raw boxes, {r['middle_points']} points")
        m = _score(data, save)
        log(f"[cli] synthesized scenes scored: mAP@0.25 "
            f"{m['mAP_0.25']:.4f}, mAP@0.50 {m['mAP_0.50']:.4f} (printed, "
            f"not checked)")
        exact = os.path.join(root, "planted")
        _plant_dumps(data, exact, scenes, shift=False)
        m = _score(data, exact)
        shifted = os.path.join(root, "shifted")
        _plant_dumps(data, shifted, scenes, shift=True)
        ms = _score(data, shifted)
        log(f"[cli] planted dumps: mAP@0.25 {m['mAP_0.25']}, mAP@0.50 "
            f"{m['mAP_0.50']}; shifted up by dz/2: mAP@0.50 "
            f"{ms['mAP_0.50']}")
        if m["mAP_0.25"] != 1.0 or m["mAP_0.50"] != 1.0 \
                or ms["mAP_0.50"] != 0.0:
            raise AssertionError("torch NMS + mAP: planted predictions must "
                                 "score exactly 1.0, shifted ones 0 at 0.5")
        buf = io.StringIO()
        os.environ["CNRMA_CAPACITY_DEBUG"] = "1"
        try:
            with contextlib.redirect_stdout(buf):
                test_cli.main(argv + ["--max-scenes", "1", "--save-path",
                                      os.path.join(root, "cap")])
        finally:
            del os.environ["CNRMA_CAPACITY_DEBUG"]
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("[capacity]")]
        log(f"[cli] scene0000_00 with CNRMA_CAPACITY_DEBUG=1: "
            f"{len(lines)} capacity lines")
        for ln in lines:
            log(f"[cli] {ln}")
        names = {ln.split(":")[0] for ln in lines}
        want = {"[capacity] voxelize(stride 1)",
                "[capacity] ray-march kept samples/view",
                "[capacity] scene points before max_points subsample"}
        if not want <= names:
            raise AssertionError(f"capacity report: {sorted(want - names)} "
                                 f"missing")
        _mesh_at_full_width(dev, root, data, dim)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _mesh_at_full_width(dev, root: str, data: str, dim) -> None:
    """``TSDF.get_mesh`` on the card where a surface is real: the planted
    room's GT ``tsdf_04`` and a uniform noise TSDF over the config's test
    grid (seed 0), the worst case a badly trained model could predict.
    Prints the faces, seconds, peak memory and PLY bytes of each."""
    from cnrma_torch.geometry.tsdf import TSDF
    from cnrma_torch.utils.ply import write_ply_mesh
    room = TSDF.load(os.path.join(data, "atlas_tsdf", "scene0000_00",
                                  "tsdf_04.npz"))
    noise = TSDF(0.04, np.zeros((1, 3), np.float32),
                 np.random.RandomState(0).uniform(-1, 1, dim)
                 .astype(np.float32))
    for name, tsdf in (("room tsdf_04", room), ("noise", noise)):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        verts, faces, normals = tsdf.get_mesh(dev)
        mesh_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ply = os.path.join(root, "mesh.ply")
        t0 = time.perf_counter()
        write_ply_mesh(ply, verts, faces, vertex_normals=normals)
        ply_s = time.perf_counter() - t0
        ply_bytes = os.path.getsize(ply)
        os.remove(ply)
        log(f"[cli] mesh of the {name} TSDF {tsdf.tsdf_vol.shape}: "
            f"{len(faces)} faces, {len(verts)} vertices in {mesh_s:.3f} s, "
            f"peak memory {peak / 2 ** 30:.2f} GiB; PLY {ply_bytes} bytes "
            f"written in {ply_s:.3f} s")
        if len(faces) == 0 or not np.isfinite(verts).all() \
                or int(faces.max()) >= len(verts):
            raise AssertionError(f"mesh of the {name} TSDF is empty or "
                                 f"malformed")


def dot_integer_check(dev) -> None:
    """The dot kernel at the probe's 128x256x128 on random integers in
    [-4, 4] (seed 0): every product and sum is exact in fp32, so it must
    equal its plain version (tolerance 0) and a row or column read from the
    wrong place shows."""
    from cnrma_torch.tools import feature_probe
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.randint(-4, 5, shape)).to(dev,
                                                           torch.bfloat16)
            for shape in ((128, 256), (256, 128)))
    got = feature_probe.dot_cuda(a, b)
    err = float((got - feature_probe.dot_plain(a, b)).abs().max())
    log(f"[probes] dot on random integers, 128x256x128: max|err| {err:g} "
        f"(tolerance 0)")
    if err != 0.0:
        raise AssertionError("dot kernel: a layout fault, random integers "
                             "differ from the plain version")


def phase_probes(dev):
    """The dot kernel on random integers, the probe tools' own path (their
    CLIs' functions at the bench shapes), then each of their kernels
    against its plain version.  Gives the kernel rows and, per row, the
    kernel and library calls."""
    from cnrma_torch.tools import bp_probe, feature_probe, gather_probe
    t0 = time.perf_counter()
    dot_integer_check(dev)
    tools = ((bp_probe, ["bench"]), (gather_probe, []), (feature_probe, []))
    cases = [c for tool, _ in tools for c in tool.bench_cases(dev)]
    for c in cases:
        c.counter.launches = 0
    for tool, argv in tools:
        if tool.main(argv) != 0:
            raise AssertionError(f"{tool.__name__} {argv} failed")
    torch.cuda.synchronize()
    launches = {c.name: c.counter.launches for c in cases}
    log(f"[probes] launches in the probes' run: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a probe kernel never launched: {launches}")
    rows = []
    for c in cases:
        got, want = c.kernel(), c.plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{c.name}: kernel gives {got.dtype} "
                                 f"{tuple(got.shape)}, plain {want.dtype} "
                                 f"{tuple(want.shape)}")
        err = float((got.float() - want.float()).abs().max())
        if err != 0.0:
            raise AssertionError(f"{c.name}: max|err| {err} against the "
                                 f"plain version (tolerance 0)")
        lib_note = "no single torch call"
        library_ms = None
        if c.library is not None:
            lib_err = float((c.library().float() - want.float()).abs().max())
            library_ms = time_ms(c.library, dev)
            lib_note = f"library {library_ms:.4f} ms (max|err| {lib_err:g})"
        row = dict(name=c.name, route="cuda", source=c.source,
                   replaces=c.replaces, launches=launches[c.name],
                   max_abs_err=err, ms=time_ms(c.kernel, dev),
                   plain_ms=time_ms(c.plain, dev),
                   **bound(c.bytes, c.ops, c.ops_type), library_ms=library_ms)
        log(f"[probes] {c.name}: equal to plain; kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, {lib_note}; bound "
            f"{row['bound_ms']:.6f} ms by {row['bound_by']} "
            f"({c.bytes} B, {c.ops:.0f} ops)")
        rows.append(row)
    log(f"[probes] phase took {time.perf_counter() - t0:.1f} s")
    return rows, [(c.symbol, c.kernel, c.library) for c in cases]


def phase_device_time(dev, rows, probe_calls) -> None:
    """Each kernel's device time per call (``device_ms``), and its library
    call's where there is one, from profiler traces; K1 and K2 on the bf16
    volume and the ray-march scene of their phases, inputs made again here
    so that no phase before holds them (K1's fp32 time is logged beside
    its bf16 row).  The launch floor (``floor_ms``, the device time of the
    empty kernel) goes on every row.  Last of all: once a profiler session
    has run, CUPTI's launch callbacks stay on and slow every later launch
    on the host, so host-timed phases come first."""
    from cnrma_torch.ops import backproject as bp
    from cnrma_torch.ops import ray_marching as rm
    from cnrma_torch.tools import feature_probe
    floor = device_ms(lambda: feature_probe.empty_cuda(dev), "empty_kernel",
                      reps=50)
    log(f"[device time] launch floor (empty kernel): {fmt_ms(floor)}")
    vol32 = volume_args(dev, torch.float32)
    fp32_ms = device_ms(lambda: bp.volume_accum_cuda(*vol32),
                        "volume_accum_kernel")
    log(f"[device time] volume_accum fp32: kernel {fmt_ms(fp32_ms)}")
    del vol32
    vol = volume_args(dev, torch.bfloat16)
    rays = ray_args(dev)
    calls = [("volume_accum_kernel", lambda: bp.volume_accum_cuda(*vol),
              None),
             ("ray_march_kernel", lambda: rm.march_rays_cuda(*rays), None),
             *probe_calls]
    for row, (symbol, kernel, library) in zip(rows, calls):
        row["device_ms"] = device_ms(kernel, symbol)
        row["library_device_ms"] = (None if library is None
                                    else device_ms(library))
        row["floor_ms"] = floor
        log(f"[device time] {row['name']}: kernel "
            f"{fmt_ms(row['device_ms'])}, library "
            f"{fmt_ms(row['library_device_ms'])}, bound "
            f"{row['bound_ms']:.6f} ms, floor {fmt_ms(floor)}")


def main() -> None:
    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    vol = phase_volume(dev)
    ray = phase_ray_march(dev)
    launches, model, batch = phase_end_to_end(dev)
    phase_surface(dev, model, batch)
    del model, batch
    phase_reference(dev)
    phase_test_cli(dev)
    probes, probe_calls = phase_probes(dev)
    kernels = [
        dict(name="volume_accum", route="cuda",
             source="cnrma_torch/csrc/volume_accum.cu",
             replaces="cnrma_tpu/ops/pallas_bp.py:140",
             launches=launches["volume_accum"], **vol, library_ms=None),
        dict(name="ray_march", route="cuda",
             source="cnrma_torch/csrc/ray_march.cu",
             replaces="cnrma_tpu/ops/pallas_ray.py:108",
             launches=launches["ray_march"], **ray, library_ms=None),
        *probes,
    ]
    phase_device_time(dev, kernels, probe_calls)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
