#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain torch version at the full ScanNet shapes,
drives the CN-RMA test-mode forward once at full width, and checks a small
input against the CPU reference path.

    python3 chip_smoke.py

Phases (each prints a few lines; any failure raises and exits non-zero):
  1. device: CUDA required; card name and power limit from nvidia-smi.
  2. build: both kernels from cnrma_torch/csrc through nvcc.
  3. volume kernel vs plain at the full_ship shape (50 views of
     [120, 160, 32], 256x256x96 voxels at 4 cm), fp32 and bf16.
  4. coarse-march kernel vs plain at the full_ship shape (19,200 rays per
     view, 38 coarse steps) on the occupancy grid of a sphere TSDF.
  5. end to end: one full_ship scene through ``CNRMA`` in bf16 with
     bench.py's synthesized parameters; kernel launch counts, output
     shapes and finiteness, warm forward time, peak memory.
  5b. surface: the same model's ray march and detector on a planted ball
     TSDF, so that points and boxes come out at full size.
  6. reference: a tiny scene in fp32 on the GPU (kernels) and on the CPU
     (plain versions), same parameters and draw; TSDFs, points and boxes
     must agree.
The line before the last is the kernel table as JSON; the last line is the
device record.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

FULL_SHIP = dict(voxel_dim=(256, 256, 96), voxel_size=0.04, views=50, h=480,
                 w=640, ray_samples=300, rays_cap=98304, max_points=500000,
                 coarse_step=8, skip_factor=8)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_build() -> None:
    from cnrma_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} "
        f"s from {_build.CSRC}")


def full_ship_projections(dev) -> torch.Tensor:
    from cnrma_torch.synthetic import ring_projections
    c = FULL_SHIP
    proj = ring_projections(c["views"], c["h"], c["w"], c["voxel_dim"],
                            c["voxel_size"])
    return torch.from_numpy(proj).to(dev)


def phase_volume(dev) -> dict:
    from cnrma_torch.ops import backproject as bp
    c = FULL_SHIP
    v, h, w = c["views"], c["h"] // 4, c["w"] // 4
    proj = full_ship_projections(dev)
    proj[:, :2, :] /= 4
    feats32 = torch.rand(v, h, w, 32, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    view_valid = torch.ones(v, dtype=torch.bool, device=dev)
    view_valid[v // 2] = False      # one view left out
    row = None
    for dtype, tol_name in ((torch.float32, "1e-6"),
                            (torch.bfloat16, "one bf16 ulp of the mean")):
        args = (proj, feats32.to(dtype), view_valid, c["voxel_dim"],
                c["voxel_size"], (0.0, 0.0, 0.0))
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
        ms = cuda_time_ms(lambda: bp.volume_accum_cuda(*args))
        plain_ms = cuda_time_ms(lambda: bp.volume_accum_plain(*args))
        log(f"[volume] {str(dtype)[6:]}: mask+counts equal, max|err| "
            f"{err.max().item():.3g} (tol {tol_name}); observed voxels "
            f"{ok.float().mean().item():.4f}, max views "
            f"{cnt.max().item():.0f}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms")
        row = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms)
    return row            # the main path's dtype (bf16) is measured last


def phase_coarse(dev) -> dict:
    from cnrma_torch.ops import ray_marching as rm
    from cnrma_torch.synthetic import sphere_tsdf
    c = FULL_SHIP
    dim, vs = c["voxel_dim"], c["voxel_size"]
    tsdf = sphere_tsdf(dim, vs, radius=0.5, trunc=3 * vs).to(dev)
    occ = rm.build_occupancy(tsdf, c["skip_factor"])
    proj = full_ship_projections(dev)
    proj[:, :2, :] /= 4
    h, w = c["h"] // 4, c["w"] // 4
    t_one = math.sqrt(sum(n * n for n in dim)) * vs / c["ray_samples"]
    step = c["coarse_step"]
    n_coarse = (c["ray_samples"] + step - 1) // step
    cell = vs * c["skip_factor"]
    origin = torch.zeros(3, device=dev)
    rays = [rm.get_ray_parameters(p, h, w) for p in proj]
    hits, err = 0, 0.0
    for o, d in rays:
        got = rm.coarse_march_cuda(o, d, occ, origin, t_one, step, n_coarse,
                                   cell)
        want = rm.coarse_march_plain(o, d, occ, origin, t_one, step,
                                     n_coarse, cell)
        torch.cuda.synchronize()
        err = max(err, float((got[0] - want[0]).abs().max()),
                  float((got[1] != want[1]).sum()))
        hits += int(got[1].sum())
    if err != 0.0:
        raise AssertionError(f"coarse-march kernel: j0/has_hit differ from "
                             f"the plain version (max|err| {err})")
    share = hits / (len(rays) * h * w)
    if not 0.0 < share < 1.0:
        raise AssertionError(f"coarse march: degenerate hit share {share}")
    o, d = rays[0]
    ms = cuda_time_ms(lambda: rm.coarse_march_cuda(
        o, d, occ, origin, t_one, step, n_coarse, cell))
    plain_ms = cuda_time_ms(lambda: rm.coarse_march_plain(
        o, d, occ, origin, t_one, step, n_coarse, cell))
    log(f"[coarse] {len(rays)} views x {h * w} rays, {n_coarse} steps, grid "
        f"{tuple(occ.shape)} ({occ.mean().item():.3f} occupied): j0/has_hit "
        f"equal; hit share {share:.4f}; kernel {ms:.4f} ms/view, plain "
        f"{plain_ms:.4f} ms/view")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


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


def phase_end_to_end(dev):
    from cnrma_torch.ops.backproject import VOLUME_ACCUM
    from cnrma_torch.ops.ray_marching import COARSE_MARCH
    c = FULL_SHIP
    v, h, w = c["views"], c["h"], c["w"]
    model = full_ship_model(dev)
    rng = np.random.RandomState(0)
    batch = {
        "imgs": torch.from_numpy(
            rng.rand(1, v, h, w, 3).astype(np.float32) * 255).to(dev),
        "projection": full_ship_projections(dev)[None],
        "view_valid": torch.ones(1, v, dtype=torch.bool, device=dev),
        "offset": torch.zeros(1, 3, device=dev),
    }

    def forward():
        return model(batch, generator=torch.Generator(device=dev)
                     .manual_seed(0))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    VOLUME_ACCUM.launches = 0
    COARSE_MARCH.launches = 0
    t0 = time.perf_counter()
    out = forward()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {"volume_accum": VOLUME_ACCUM.launches,
                "coarse_march": COARSE_MARCH.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[e2e] launches in one forward: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
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
    return launches, model, batch


def phase_surface(dev, model, batch) -> None:
    """The data-dependent half of the forward at full size.  bench.py's
    parameters give a TSDF that is flat near 0, so no ray-march sample
    clears the weight threshold and the detector sees an empty cloud; here
    the fine TSDF is a planted ball (0.5 m radius at the volume centre,
    positive inside, which is the sign the NeuS weights respond to) and the
    ray march and the detector run on it."""
    from cnrma_torch.synthetic import sphere_tsdf
    c = FULL_SHIP
    tsdf = -sphere_tsdf(c["voxel_dim"], c["voxel_size"], radius=0.5,
                        trunc=3 * c["voxel_size"])[None].to(dev)
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


def main() -> None:
    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    vol = phase_volume(dev)
    coarse = phase_coarse(dev)
    launches, model, batch = phase_end_to_end(dev)
    phase_surface(dev, model, batch)
    del model, batch
    phase_reference(dev)
    kernels = [
        dict(name="volume_accum", route="cuda",
             source="cnrma_torch/csrc/volume_accum.cu",
             replaces="cnrma_tpu/ops/pallas_bp.py:140",
             launches=launches["volume_accum"], **vol),
        dict(name="coarse_march", route="cuda",
             source="cnrma_torch/csrc/coarse_march.cu",
             replaces="cnrma_tpu/ops/pallas_ray.py:108",
             launches=launches["coarse_march"], **coarse),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
