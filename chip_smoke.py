#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain torch version at the full ScanNet and ARKit
shapes, drives the CN-RMA test-mode forward (NeuS and depth marching), the
test CLI (also over two processes), the train CLI with its mid-training
evaluation, the three-stage training recipe, data-parallel training, the
ARKit yaw path with its own three-stage chain and ScanNet's data
preparation at full width, checks small inputs against the CPU reference
path, and runs the whole-model and the detector-only learning checks on
synthetic scenes.

    python3 chip_smoke.py
    python3 chip_smoke.py --train-child TRAIN_CLI_ARGS [--then
        TRAIN_CLI_ARGS ...]   (the ddp phase's child: the train CLI runs
        in turn, then each one's launches, model hash and step records to
        a file)
    python3 chip_smoke.py --learn-child OUT TOOL TOOL_ARGS   (a child of
        the learn phase: ``run(TOOL_ARGS)`` of cnrma_torch.tools.TOOL, its
        result and launches to OUT)

Phases (each prints a few lines; any failure raises and exits non-zero):
  1. device: CUDA required; card name and power limit from nvidia-smi.
  2. build: every kernel source in cnrma_torch/csrc through nvcc; then
     ``cuobjdump`` of the library: the dot kernel's SASS must hold the
     tensor cores' warpgroup MMA (HGMMA) and the TMA load (UTMALDG); the
     registers and local memory of the dot, flat gather, lane gather,
     onehot, volume and volume backward kernels, and the volume backward's
     atomic instructions, are logged.
  3. volume kernel vs plain at the full_ship shape (50 views of
     [120, 160, 32], 256x256x96 voxels at 4 cm), fp32 and bf16; the
     pixel-row reads (hits) against the distinct rows; its sum mode (a
     rank's partial volume: the fp32 sum, undivided) at tolerance 0.
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
  depth. the same forward with ``ray_marching_type='depth'``
     (``depth_points`` 2): K1 once and K2 never, outputs finite, its time
     and peak memory; the depth march alone on the planted ball for
     ``depth_points`` 2 and 0 (kept points, finite boxes, its milliseconds
     with no host sync, its peak memory); a tiny fp32 scene's depth march
     on the card against the CPU's, as kept sets.
  6. reference: a tiny scene in fp32 on the GPU (kernels) and on the CPU
     (plain versions), same parameters and draw; TSDFs, points and boxes
     must agree.
  6b. test CLI: three synthetic ScanNet scenes written on disk (60 frames
     of 1296x968 JPEG, a room TSDF over the 256x256x96 grid, the planted
     boxes as GT) through ``python -m cnrma_torch.tools.test`` with
     ``configs/ray_marching_scannet.py`` at its own test widths and
     default-initialised parameters saved as a ``.pt`` checkpoint; each
     scene's four files checked, K1 and K2 launched once a scene, the
     per-scene seconds, mesh faces, PLY bytes and peak memory printed; the
     torch ``nms_bbox`` and ``evaluate_bbox`` on the results (mAP printed)
     and on planted dumps equal to the GT (mAP@0.25 and mAP@0.50 exactly
     1.0; shifted up by dz/2, mAP@0.50 exactly 0); one scene again with
     ``CNRMA_CAPACITY_DEBUG=1``, its capacity lines printed; the test
     reader alone over two such scenes at 1 and 4 worker threads in
     turns (seconds a scene, each ``load_s`` and ``wait_s``; the samples
     must hash alike); the test CLI over the three scenes with
     ``--n-devices 2`` (two processes on the one card) against the
     one-process run: TSDFs and points within 1e-5, raw box rows matched
     as sets, where only two near-tied rows may swap at a cut (the
     voxelisation's atomics, F6), seconds a scene.
  6c. volume backward: K1b against its plain version at the training shape
     (40 views of [120, 160, 32], a 192x192x80 grid), bf16 and fp32,
     within 1e-5 of the largest gradient (its fp32 atomics sum in an order
     that changes from run to run; bf16 one bf16 ulp more), timed beside
     the plain version and ``index_add_``; the (voxel, view) pairs, the
     distinct (tile, view, pixel) rows its tiles merge them into (counted
     in torch on the card) and the pairs that skipped its shared-memory
     window (counted by the kernel).
  6d. train reference: a tiny fp32 training step on the GPU against the
     same step on the CPU (same parameters, batch, draws and kept points):
     losses, gradients (the 2D tower's as groups and, by cosine, each
     leaf) and running statistics within their stated limits; then three
     planted faults in the GPU step (K1b's output losing a view, the
     trunk's norms on running statistics, one tower leaf's gradient lost),
     each of which must break a limit of the tower's.
  6e. train CLI: ``python -m cnrma_torch.tools.train`` on two synthetic
     ScanNet scenes (40 frames of 1296x968 JPEG) at the config's full
     training width (40 views of 480x640, the 192x192x80 grid, fp32) for 3
     steps from default-initialised weights: each loss, the gradient norm,
     the step's and the reader wait's seconds, the peak memory and the
     step's stage times (CUDA events marked inside the train loop) per
     step, all finite; K1, K1b and K2 once a step; the mid-training
     evaluation at the stop by ``--max-steps``: the val split (the same two
     scenes) scored at the config's test grid (256x256x96, read by a hook
     on the test twin's TSDF head), K1 and K2 once a scene, its losses and
     mAP and seconds printed, ``best.pt`` with a finite ``val_total_loss``
     and an mAP in [0, 1]; one backward of the reconstruction losses alone
     must reach the 2D tower; the test CLI on one scene from ``best.pt``;
     then 3 steps from the same start with depth marching
     (``model.ray_marching_type=depth model.depth_points=2``): K1 and K1b
     once a step, K2 never, finite losses, each step's seconds, peak
     memory, march and backward stages beside the NeuS step's.
  6f. the three-stage recipe (``doc/train_val.md``) on two synthetic
     ScanNet scenes (60 frames of 1296x968 JPEG) written under ``build/``:
     stage 1, the train CLI on ``configs/atlas_recon_scannet.py`` for 3
     steps at its full width (50 views of 480x640, the 160x160x64 grid,
     ``recon_random`` crops, bf16, Adam) from the CLI's default
     initialisation, with K1 and K1b once a step and the missing R-50
     reported as 0 tensors loaded, and its evaluation on a val split read
     as its test split (``recon_test``, 256x256x96, 50 views; losses
     only); K1b against its plain version at stage
     1's shape (the reader's rotated crop, bf16, phase 6c's tolerance), its
     time and pairs off its window; the stage-1 checkpoint through the
     test CLI (the config's 256x256x96 test grid, views cut from 500 to 50)
     and ``evaluate_mesh`` against the scene's GT mesh (finite metrics, a
     metrics file); the stage-2.1 dump (the test CLI on
     ``configs/scannet_middle.py`` from the stage-1 checkpoint, two scenes
     at full width, K1 and K2 once a scene), each dump held against this
     process's forward of the checkpoint; stage 2, the train CLI on
     ``configs/fcaf3d_middle_scannet.py`` for 3 steps at 500,000 points a
     scene, on synthetic dumps of 600,000 points on each room's surface and
     again on the 2.1 dumps that are not empty; ``combine_models`` of the
     two checkpoints, every tensor bit for bit; one stage-3 step from the
     merged file with finite losses.  The stage-1 reader alone over the
     two rooms at 1 and 4 workers, as phase 6b's.
  ddp. on phase 6f's scenes and dumps: the train CLI for 2 steps of
     stage 2 (500,000 points) and of stage 3 (20 views, 192x192x80,
     fp32) in this process, then both in turn in one child under
     ``torchrun --nproc_per_node 1`` on NCCL (``chip_smoke.py
     --train-child ... --then ...``): the step-1 losses equal (bit for
     bit, or within 1e-5: the voxelisation's atomics), K1, K1b and K2 once
     a step in the child, its step times beside those alone; stage 2 on
     two
     ranks (gloo sharing the one card; NCCL across two where there are
     two): the ranks' parameters equal bit for bit after each step, and
     after step 1 those of a one-process step on the mean of both scenes'
     gradients and statistics within stated tolerances, the detector's
     positive count and centerness sum as the group averaged them against
     the mean of the two scenes' own; then the view step on the same two
     ranks: one stage-3 scene of 20 views split across them (K1's sum
     mode on each rank's views at tolerance 0; the full and the
     recon-only view-sharded step from one start, K1's sum, K1b and K2
     once a step a rank, the ranks equal after them, each against the
     one-process step of this process: the TSDF losses within 1e-5 and
     the U-Net's and head's gradients within 3e-3, in the recon-only step
     the 2D tower's within 0.05; the recon-only step with the boundary
     planted to sum the ranks' copies must break them; seconds, peaks
     and stage times); on several cards also stage 3 on a rank a card
     and the view-sharded paths across cards (``phase_view_cards``: stage
     3 at 40 views, with NeuS and depth marching and on ARKit's config,
     stage 1 at 50, and the val evaluation at the test grid, on two
     cards against one card).
  batch. training batches of two scenes, on phase 6f's scenes and dumps:
     the tiny fp32 step of phase 6d at two scenes on the GPU against the
     CPU at ``TRAIN_LIMITS`` (the 3D U-Net held as a group, like the
     tower's), K1b launched once a scene, then the step with the sparse
     batch norms' per-scene statistics planted, which must break the
     running statistics' limit on a detector norm; the train CLI at
     ``--batch-size 2`` for 2 steps on stage 2 (500,000 points a scene)
     and stage 1 (50 views, 160x160x64, bf16), K1 and K1b twice a stage-1
     step; stage 3 at 14 views a scene (widths and grid kept: 40 do not
     fit) for 2 steps at one scene and then at two from the merged
     checkpoint, K1, K1b and K2 once a scene, the two-scene run scoring
     the val split in one batch of two at the test grid (finite, or F13's
     overflow); each step's seconds and the peak memory beside one
     scene's (stages 1 and 2: phase 6f's runs); the val batch through the
     test model once against each scene alone: TSDFs and kept points
     within 1e-5, raw box rows as sets.
  arkit. the ARKitScenes 7-DoF path on two synthetic ARKit scenes (60 PNG
     frames of 256x192 in ARKit's ``lowres_wide`` layout, five yaw boxes a
     room) under ``build/``: the yaw model's tiny fp32 forward GPU against
     CPU (phase 6's tolerances, yaw compared modulo pi); the test CLI on
     ``configs/ray_marching_arkit.py`` at its full test width (40 views of
     480x640, 192x192x80, fp32, ``middle`` space), K1 and K2 once a scene,
     7-column boxes and 17 scores, then the rotated ``nms_bbox`` and
     ``evaluate_bbox --dataset arkit`` on the card (planted yaw boxes
     exactly 1.0, the same turned by pi/2 under 1 at 0.5), rotated NMS of
     4000 boxes of one class timed (its keep mask held against the CPU's
     on 1000), points and boxes on a planted ball, one scene's capacity
     lines; then ARKit's recipe as a chain: 3 stage-1 steps on
     ``configs/atlas_recon_arkit.py`` at its width (50 views, 160x160x64,
     bf16; K1 and K1b once a step), the stage-2.1 dump of both scenes on
     ``configs/arkit_middle.py`` from that checkpoint (K1 and K2 once a
     scene; finite points within ``max_points``, each dump held against
     this process's forward of the checkpoint), 3 stage-2 steps on
     ``configs/fcaf3d_middle_arkit.py`` at full width on synthetic dumps
     of 600,000 points and 3 on the 2.1 dumps, each step with positives
     for the rotated IoU loss, the merge bit for bit, and 3
     stage-3 steps of the train CLI at full width from the merged
     checkpoint (finite losses and gradient norms, K1, K1b and K2 once a
     step) with its evaluation of the val split at 192x192x80 (losses and
     rotated mAP); K1 and K2 at the ARKit test shape and K1b at its
     training shape against their plain versions, timed (their device
     times in phase 8).
  prep. ScanNet's data preparation through the port's CLIs on one
     synthetic scene under ``build/``: a ``.sens`` of 300 frames (1296x968
     JPEG colour, 640x480 depth ray-cast from the planted room of the
     208x208x80 stage-3 test extent) and its scan; ``extract_posed_images``,
     ``generate_tsdf`` on the card on the F17 route (the colour intrinsic)
     and on the consistent route (the depth intrinsic),
     ``batch_load_scannet_data``, ``aggregate_data`` (train, val), one
     stage-3 train CLI step at full width on the result (finite losses;
     K1, K1b and K2 once); the fusion's CUDA-event time at 4, 8 and 16 cm
     (frames and voxel-frames a second), the host's PNG read, peak memory
     and the chain's wall time; the card's fusion against the CPU's at 16
     cm (300 frames) and 4 cm (20 frames) by the CPU tests' rule; the 4 cm
     TSDF's sign agreement with the planted room (the consistent route
     held at ``PREP_SIGN_BOUND``, the F17 route's printed).
  learn. ``python -m cnrma_torch.tools.overfit_full``, ScanNet-style and
     ``--yaw``: the tiny CNRMA trained on two synthetic rooms as one batch
     for 70 steps; the first and last total and reconstruction losses,
     mAP@0.25 and @0.50, seconds a step, peak memory, the launches; and
     ``python -m cnrma_torch.tools.overfit_check --steps CHECK_STEPS``
     (the tiny ``FCAF3DOnly`` on two box scenes) with
     ``CNRMA_CAPACITY_DEBUG=1``: its loss curve, mAP, seconds a step,
     peak memory and capacity fills; each fails unless its tool's PASS
     rule holds.  All three are host-bound and run in child processes
     (``chip_smoke.py --learn-child``), the detector-only one from the
     start of ``arkit`` on, the whole model's from the start of ``prep``
     on, so the seconds of ``arkit``, ``prep`` and ``learn`` and of the
     checks' steps are printed as taken beside them, on a shared host.
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
     then K1b at stage 1's shape and K1, K2 and K1b at ARKit's, beside the
     floor and, for K1b, ``index_add_``'s device time; last, because a
     profiler session slows the host's later launches.
Every kernel row carries its bound: the larger of the bytes its function
must move (each input read once, each output written once, counted from
this run's data) over 3.35 TB/s and its operations over the peak rate of
their type (H100 SXM data sheet).  Its ``ms`` is CUDA events around one
call, so it holds the host's launch work, which dominates calls under
~0.1 ms; ``device_ms`` leaves that out.  Before the kernel table, a line
gives the script's seconds so far; the line before the last is the
kernel table as JSON; the last line is the device record.  Each phase's
seconds follow it (``[seconds]`` lines), the script's total last
(``[script]``).
"""

import collections
import contextlib
import gc
import io
import json
import math
import os
import pickle
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


def no_tf32() -> None:
    """fp32 means fp32: no TF32 in convolutions or matmuls (the main path
    itself runs in bf16); every process of the script sets it."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); this script runs only "
                         "on a GPU")
    name = torch.cuda.get_device_name(0)
    smi = card()
    no_tf32()
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
                    "onehot_kernel", "volume_accum_kernel",
                    "volume_accum_bwd_kernel")
# kernels whose atomic instructions are logged: K1b's shared-memory window
# sums with shared atomics (ATOMS) and flushes with global ones (RED)
ATOMICS_LOGGED = ("volume_accum_bwd_kernel",)


def _functions(text: str, pattern: str) -> dict:
    """``cuobjdump`` output split per function: {mangled name: its text}."""
    parts = re.split(pattern, text)
    return dict(zip(parts[1::2], parts[2::2]))


def _all_named(functions: dict, kernel: str) -> dict:
    """{mangled name: text} of every function named ``kernel`` (each
    template instance), matched by the length-prefixed mangled name, so
    that a longer name ending in the same words does not match."""
    found = {name: text for name, text in functions.items()
             if f"{len(kernel)}{kernel}" in name}
    if not found:
        raise AssertionError(f"cuobjdump: no function named {kernel}")
    return found


def _named(functions: dict, kernel: str) -> str:
    """The text of the one function named ``kernel``."""
    found = list(_all_named(functions, kernel).values())
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
    for kernel in ATOMICS_LOGGED:
        for name, text in _all_named(sass, kernel).items():
            ops = collections.Counter(re.findall(
                r"\b((?:ATOMS|ATOMG|ATOM|RED)\.[A-Z0-9_.]+)", text))
            log(f"[build] {name} atomics in SASS: {dict(ops)}")
    usage = _functions(dump("-res-usage"), r"Function (\S+):")
    for kernel in RESOURCES_LOGGED:
        for name, text in _all_named(usage, kernel).items():
            regs = re.search(r"REG:(\d+)", text).group(1)
            local = re.search(r"LOCAL:(\d+)", text).group(1)
            log(f"[build] {name}: {regs} registers, {local} B local memory")


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
        # the plain version takes about 0.35 s a call: three timed runs
        plain_ms = time_ms(lambda: bp.volume_accum_plain(*args), dev, reps=3)
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


def phase_volume_sum(dev) -> dict:
    """K1's sum mode (a rank's partial volume of a view-sharded scene: the
    fp32 sum, undivided) against its plain version at tolerance 0, at the
    full_ship shape in fp32 and bf16 features; its row (bf16, the
    forward's dtype, last)."""
    from cnrma_torch.ops import backproject as bp
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        args = volume_args(dev, dtype)
        total, cnt, ok = bp.volume_accum_cuda(*args, write_sum=True)
        ptotal, pcnt, pok = bp.volume_accum_plain(*args, write_sum=True)
        torch.cuda.synchronize()
        if not (torch.equal(ok, pok) and torch.equal(cnt, pcnt)
                and total.dtype == torch.float32
                and torch.equal(total, ptotal)):
            raise AssertionError(f"volume kernel, sum mode: differs from "
                                 f"the plain version ({dtype})")
        ms = time_ms(lambda: bp.volume_accum_cuda(*args, write_sum=True),
                     dev)
        plain_ms = time_ms(lambda: bp.volume_accum_plain(
            *args, write_sum=True), dev, reps=3)
        nbytes, ops, _ = volume_work(*args, cnt, write_sum=True)
        row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                   **bound(nbytes, ops))
        log(f"[volume sum] {str(dtype)[6:]} features: the fp32 sum and "
            f"counts equal the plain version's bit for bit (tol 0); kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}")
        del args, total, cnt, ok, ptotal, pcnt, pok
    return row


def volume_work(proj, feats, view_valid, voxel_dim, voxel_size, origin,
                cnt, write_sum: bool = False):
    """(bytes, fp32 operations, distinct pixel rows reached) of the volume
    function on these inputs.
    Bytes: the feature rows some voxel reaches, the projections and view
    flags, the volume (fp32 in the sum mode), count and mask written.
    Operations: 6 per voxel (its centre), 21 per voxel and valid view
    (projection: 18, one reciprocal, two products), 33 per view that sees
    a voxel (32 channel sums and the count), 32 per observed voxel (the
    mean; none in the sum mode)."""
    from cnrma_torch.ops import backproject as bp
    V, H, W, C = feats.shape
    n = cnt.numel()
    esize = feats.element_size()
    out_size = 4 if write_sum else esize
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
              + n * C * out_size + n * 4 + n)
    ops = (6.0 * n + 21.0 * n * n_views + 33.0 * float(cnt.sum())
           + (0 if write_sum else 32.0 * int((cnt > 0).sum())))
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


def _depth_kept(pts, o, d, w):
    """A scene's kept depth-march points as arrays on the host ordered by
    (view, pixel, distance along the pixel's ray): (view and pixel ids,
    weights, positions)."""
    keep = (pts.weight > 0).cpu()
    view = pts.view.cpu()[keep].long()
    uv = pts.uv.cpu()[keep].long()
    xyz = pts.xyz.cpu()[keep]
    pix = uv[:, 1] * w + uv[:, 0]
    t = ((xyz - o.cpu()[view]) * d.cpu()[view, pix]).sum(-1)
    order = np.lexsort((t.numpy(), pix.numpy(), view.numpy()))
    return (torch.stack([view, pix], 1)[order], pts.weight.cpu()[keep][order],
            xyz[order])


def _depth_against_cpu(dev) -> None:
    """The depth march of a tiny fp32 scene on the card against the same
    function on the CPU, as kept sets (ROADMAP F6): 3 views of [16, 24]
    rays through a planted 16^3 ball, 300 samples, for ``depth_points`` 2
    and 0; view, pixel and weight equal, positions within 1e-5."""
    from cnrma_torch.ops import ray_marching as rm
    dims, vs = (16, 16, 16), 0.1
    ii = np.stack(np.meshgrid(*[np.arange(n) for n in dims], indexing="ij"),
                  -1).astype(np.float32) * vs
    ball = np.clip((np.linalg.norm(ii - np.array([0.8, 0.75, 0.85]), axis=-1)
                    - 0.45) / (3 * vs), -1, 1).astype(np.float32)
    projs = []
    for x in (0.75, 0.6, 0.9):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [x, 0.7, -0.6]
        intr = np.array([[16.0, 0, 12], [0, 16.0, 8], [0, 0, 1]], np.float32)
        projs.append(intr @ np.linalg.inv(pose)[:3])
    proj = torch.from_numpy(np.stack(projs).astype(np.float32))
    tsdf, valid = torch.from_numpy(ball), torch.ones(3, dtype=torch.bool)
    o, d = rm.get_ray_parameters(proj, 16, 24)
    for dp in (2, 0):
        args = (dims, vs, (0.0, 0.0, 0.0), 16, 24)
        want = _depth_kept(rm.ray_march_depth_scene(
            proj, tsdf, valid, *args, depth_points=dp, capacity=4096),
            o, d, 24)
        got = _depth_kept(rm.ray_march_depth_scene(
            proj.to(dev), tsdf.to(dev), valid.to(dev), *args,
            depth_points=dp, capacity=4096), o, d, 24)
        same = (len(got[0]) == len(want[0]) > 0
                and torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1]))
        err = float((got[2] - want[2]).abs().max()) if same else float("nan")
        log(f"[depth] tiny fp32 scene, depth_points {dp}, GPU vs CPU: "
            f"{len(got[0])} vs {len(want[0])} kept points, sets equal "
            f"{same}, positions max|err| {err:.3g} (tol 1e-5)")
        if not same or not err <= 1e-5:
            raise AssertionError(f"the depth march on the card disagrees "
                                 f"with the CPU (depth_points {dp})")


def phase_depth(dev, model, batch) -> None:
    """The test forward with ``ray_marching_type='depth'`` at full_ship
    (bf16, bench.py's synthesized parameters, ``depth_points`` 2): K1
    launched once and K2 never, outputs finite, the warm forward's time
    and peak memory beside NeuS's; then for ``depth_points`` 2 and 0 the
    depth march alone on the planted ball of phase 5b (its kept points, the
    detector's boxes finite, the stage's milliseconds without a host sync,
    its peak memory over its inputs); then the tiny GPU-against-CPU
    check."""
    from cnrma_torch.ops.backproject import VOLUME_ACCUM
    from cnrma_torch.ops.ray_marching import RAY_MARCH
    t_phase = time.perf_counter()
    model.ray_marching_type, model.depth_points = "depth", 2

    def forward():
        return model(batch, generator=torch.Generator(device=dev)
                     .manual_seed(0))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        VOLUME_ACCUM.launches = RAY_MARCH.launches = 0
        out = forward()
        torch.cuda.synchronize()
        launches = {"volume_accum": VOLUME_ACCUM.launches,
                    "ray_march": RAY_MARCH.launches}
        peak = torch.cuda.max_memory_allocated()
        finite = all(bool(torch.isfinite(t).all()) for t in (
            out["bboxes"], out["scores"], out["tsdf"]["scene_tsdf_004"]))
        times = []
        for _ in range(4):               # one warm-up, then three timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        log(f"[depth] full_ship bf16 forward, depth_points 2: launches "
            f"{launches}; kept points {int(out['points'].valid.sum())}, "
            f"valid boxes {int(out['bbox_valid'].sum())}, outputs finite "
            f"{finite}; warm forward median of 3 "
            f"{statistics.median(times[1:]) * 1e3:.1f} ms ("
            f"{', '.join(f'{t * 1e3:.1f}' for t in times[1:])}); peak "
            f"memory {peak / 2 ** 30:.2f} GiB")
        if launches != {"volume_accum": 1, "ray_march": 0} or not finite:
            raise AssertionError(f"the depth forward must launch K1 once, K2 "
                                 f"never, with finite outputs: {launches}")
        del out
        tsdf = planted_ball(dev)[None]
        with torch.no_grad():
            feats = model.extract_2d(batch["imgs"])
            for dp in (2, 0):
                model.depth_points = dp
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                pts = model.ray_march(feats, batch["projection"],
                                      batch["view_valid"], tsdf,
                                      torch.Generator(device=dev).manual_seed(0))
                torch.cuda.synchronize()
                stage_peak = torch.cuda.max_memory_allocated() - base
                xyz = pts.xyz + batch["offset"][:, None, :]
                bboxes, scores, bvalid = model.detector.get_bboxes(
                    model.detector(xyz, pts.feats, pts.valid))
                n_points, n_boxes = int(pts.valid.sum()), int(bvalid.sum())
                ms = ray_stage(dev, model, batch, feats, tsdf,
                               f"depth {dp}")
                finite = all(bool(torch.isfinite(t).all())
                             for t in (pts.xyz, pts.feats, bboxes, scores))
                log(f"[depth {dp}] planted ball: kept points {n_points} of "
                    f"{model.max_points}; valid boxes {n_boxes}, finite "
                    f"{finite}; depth march {ms:.3f} ms; its peak memory "
                    f"over its inputs {stage_peak / 2 ** 30:.3f} GiB")
                if not finite or n_points == 0 or n_boxes == 0:
                    raise AssertionError(f"depth march on a planted surface "
                                         f"(depth_points {dp}): no points, "
                                         f"no boxes or non-finite values")
                del pts, xyz, bboxes, scores, bvalid
        _depth_against_cpu(dev)
    finally:
        model.ray_marching_type, model.depth_points = "neus", 2
    log(f"[depth] phase took {time.perf_counter() - t_phase:.1f} s")


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
    gpu_against_cpu(dev, model, batch, uniform, "reference")


def gpu_against_cpu(dev, model, batch, uniform, tag: str) -> None:
    """One tiny fp32 test forward of ``model`` on the CPU (plain versions)
    and on the card (kernels), same parameters, batch and subsample draw:
    TSDFs within 1e-4, the same number of kept points (at least one) and
    of valid boxes, boxes and scores (ordered by score) within 1e-3.  A
    yaw is compared modulo pi (a box turned by pi is the same box)."""
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
    log(f"[{tag}] tiny fp32 scene, GPU vs CPU: tsdf max|err| "
        f"{tsdf_err:.3g}; points {n_got} vs {n_ref}; valid boxes "
        f"{len(gb)} vs {len(rb)} of {rb.shape[-1]} columns")
    if tsdf_err > 1e-4 or n_ref == 0 or n_got != n_ref or len(gb) != len(rb):
        raise AssertionError(f"[{tag}] GPU path disagrees with the CPU "
                             f"reference")
    diff = gb - rb
    if diff.shape[-1] == 7:
        diff[:, 6] = torch.remainder(diff[:, 6] + math.pi / 2,
                                     math.pi) - math.pi / 2
    box_err = diff.abs().max().item() if len(rb) else 0.0
    score_err = (gs - rs).abs().max().item() if len(rb) else 0.0
    log(f"[{tag}] boxes max|err| {box_err:.3g}, scores max|err| "
        f"{score_err:.3g} (tol 1e-3)")
    if box_err > 1e-3 or score_err > 1e-3:
        raise AssertionError(f"[{tag}] GPU boxes disagree with the CPU "
                             f"reference")


CLI_CONFIG = "configs/ray_marching_scannet.py"
CLI_FILES = ("{s}.npz", "{s}.ply", "{s}_bbox_raw.npz")
CLI_SCENES = 3              # phase 6b's scenes, also over two processes


def _check_scene_files(save: str, middle: str, scene: str, dim,
                       need_points: bool = True, box_dim: int = 6,
                       n_classes: int = 18, overflow_ok: bool = False
                       ) -> dict:
    """Raise unless a scene's four result files hold the right keys, shapes
    (``box_dim`` box columns, ``n_classes`` scores) and finite values, and
    it has raw boxes exactly when it has kept points (the detector's top-k
    rows are valid where the points' voxels are); ``need_points`` also asks
    for a non-empty cloud.  ``overflow_ok`` lets a box row be not finite
    where its face distances overflowed fp32 (``overflowed_rows``), and
    only there.  Returns the counts of raw boxes, of those overflowed and
    of middle points."""
    from cnrma_torch.tools.overflow_survey import overflowed_rows
    d = os.path.join(save, scene)
    for f in CLI_FILES:
        if not os.path.isfile(os.path.join(d, f.format(s=scene))):
            raise AssertionError(f"{scene}: {f.format(s=scene)} missing")
    bad = []
    with np.load(os.path.join(d, scene + ".npz")) as z:
        tsdf, origin = z["tsdf"], z["origin"]
        if not (tsdf.shape == tuple(dim) and origin.shape == (1, 3)
                and float(z["voxel_size"]) == 0.04
                and np.isfinite(tsdf).all() and np.isfinite(origin).all()):
            bad.append(f"tsdf {tsdf.shape}, origin {origin.shape}")
    with open(os.path.join(d, scene + ".ply"), "rb") as f:
        if f.read(3) != b"ply":
            bad.append("no PLY header")
    with np.load(os.path.join(d, scene + "_bbox_raw.npz")) as z:
        b, sc = z["bboxes"], z["scores"]
    shaped = (b.ndim == 2 and b.shape[1] == box_dim
              and sc.shape == (len(b), n_classes))
    if not shaped:
        over = None
    elif overflow_ok and box_dim == 6:
        over = overflowed_rows(b)
    else:
        over = 0 if np.isfinite(b).all() else None
    if not (shaped and over is not None and np.isfinite(sc).all()):
        bad.append(f"boxes {b.shape}, {int((~np.isfinite(b)).sum())} "
                   f"values not finite"
                   + (" (not all from overflow)" if overflow_ok else "")
                   + f"; scores {sc.shape}, "
                   f"{int((~np.isfinite(sc)).sum())} not finite")
    vert = np.load(os.path.join(middle, scene + "_vert.npy"))
    if not (vert.ndim == 2 and vert.shape[1] == 35
            and np.isfinite(vert).all()):
        bad.append(f"points {vert.shape}")
    if (len(b) > 0) != (len(vert) > 0) or (need_points and not len(vert)):
        bad.append(f"{len(b)} raw boxes from {len(vert)} points")
    if bad:
        raise AssertionError(f"{scene}: a result file has the wrong keys, "
                             f"shapes or values: {'; '.join(bad)}")
    return {"raw_boxes": len(b), "overflowed": over,
            "middle_points": len(vert)}


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


def _score(data: str, results: str, dataset: str = "scannet") -> dict:
    """``nms_bbox`` and ``evaluate_bbox`` on the card; the metrics, with
    the seconds of each under ``nms_s`` and ``map_s``."""
    from cnrma_torch.tools import evaluate_bbox, nms_bbox
    with contextlib.redirect_stdout(io.StringIO()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nms_bbox.main(["--result_path", results])
        t1 = time.perf_counter()
        m = evaluate_bbox.main(["--dataset", dataset, "--data_path", data,
                                "--result_path", results])
        return dict(m, nms_s=t1 - t0, map_s=time.perf_counter() - t1)


def phase_test_cli(dev) -> None:
    """The user's loop on the card: the torch test CLI over two synthetic
    ScanNet scenes at the config's own test widths, then the torch NMS and
    mAP; planted dumps whose answer is known; one scene with the capacity
    report on."""
    from cnrma_torch.core.builder import build_dataset, build_model
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
        ann = write_scannet(data, n_scenes=CLI_SCENES, n_frames=60)
        cfg = Config.fromfile(CLI_CONFIG)
        dim = tuple(cfg.model.voxel_dim_test)
        torch.manual_seed(0)
        ckpt = os.path.join(root, "init.pt")
        torch.save(build_model(cfg).state_dict(), ckpt)
        log(f"[cli] wrote {CLI_SCENES} scenes (60 frames of 1296x968 JPEG, "
            f"room TSDF over {dim}) and a default-initialised checkpoint in "
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
        records = test_cli.main(argv + ["--max-scenes", str(CLI_SCENES)])
        wall = time.perf_counter() - t0
        launches = {"volume_accum": VOLUME_ACCUM.launches,
                    "ray_march": RAY_MARCH.launches}
        peak = torch.cuda.max_memory_allocated()
        first = records[0]["wait_s"]
        n = len(records)
        log(f"[cli] {n} scenes in {wall:.2f} s, {wall / n:.3f} s a scene, "
            f"{(wall - first) / n:.3f} after the first wait (4 reader "
            f"workers); launches {launches}; peak memory "
            f"{peak / 2 ** 30:.2f} GiB ({card()})")
        if launches != {"volume_accum": CLI_SCENES, "ray_march": CLI_SCENES}:
            raise AssertionError(f"each scene must launch each main-path "
                                 f"kernel once: {launches}")
        scenes = sorted(os.listdir(save))
        if scenes != [f"scene{i:04d}_00" for i in range(CLI_SCENES)] \
                or len(records) != CLI_SCENES:
            raise AssertionError(f"--max-scenes {CLI_SCENES} wrote {scenes}")
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
        lines = _capacity_lines(argv, os.path.join(root, "cap"), "cli")
        names = {ln.split(":")[0] for ln in lines}
        want = {"[capacity] voxelize(stride 1)",
                "[capacity] ray-march kept samples/view",
                "[capacity] scene points before max_points subsample"}
        if not want <= names:
            raise AssertionError(f"capacity report: {sorted(want - names)} "
                                 f"missing")
        _mesh_at_full_width(dev, root, data, dim)
        test_opts = {"data.test.data_root": data, "data.test.ann_file": ann}
        with open(ann, "rb") as f:
            infos = pickle.load(f)
        two = os.path.join(data, "scannet_infos_two.pkl")
        with open(two, "wb") as f:          # the reader over two scenes
            pickle.dump(infos[:2], f)
        cfg.merge_from_options({"data.test.data_root": data,
                                "data.test.ann_file": two})
        _reader_turns("cli readers", lambda: build_dataset(cfg, "test",
                                                           seed=0))
        _cli_sharded(root, [CLI_CONFIG, ckpt, "--cfg-options",
                            *(f"{k}={v}" for k, v in test_opts.items())],
                     scenes)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _capacity_lines(argv, save: str, tag: str) -> list:
    """The test CLI (``argv``) on its first scene with
    ``CNRMA_CAPACITY_DEBUG=1``: its capacity lines, logged (a line that
    repeats, such as each view's kept samples, once with its count)."""
    from cnrma_torch.tools import test as test_cli
    buf = io.StringIO()
    os.environ["CNRMA_CAPACITY_DEBUG"] = "1"
    try:
        with contextlib.redirect_stdout(buf):
            test_cli.main(argv + ["--max-scenes", "1", "--save-path", save])
    finally:
        del os.environ["CNRMA_CAPACITY_DEBUG"]
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[capacity]")]
    log(f"[{tag}] the first scene with CNRMA_CAPACITY_DEBUG=1: "
        f"{len(lines)} capacity lines")
    for ln, n in collections.Counter(lines).items():
        log(f"[{tag}] {ln}" + (f" (x{n})" if n > 1 else ""))
    return lines


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


TRAIN_FULL = dict(voxel_dim=(192, 192, 80), voxel_size=0.04, views=40,
                  h=480, w=640)
K1B_TOL = 1e-5      # of the largest gradient: fp32 atomics, varying order


def volume_bwd_args(dev, dtype) -> tuple:
    """K1b's arguments at the training shape: 40 views of [120, 160, 32]
    features (seed 0) on a ring around the 192x192x80 grid, one view left
    out; K1's count for them; a gaussian cotangent (seed 1) in ``dtype``."""
    from cnrma_torch.synthetic import ring_projections
    c = TRAIN_FULL
    v = c["views"]
    proj = torch.from_numpy(ring_projections(
        v, c["h"], c["w"], c["voxel_dim"], c["voxel_size"])).to(dev)
    view_valid = torch.ones(v, dtype=torch.bool, device=dev)
    view_valid[v // 2] = False
    return volume_bwd_args_at(dev, dtype, proj, view_valid, c["voxel_dim"],
                              c["voxel_size"], c["h"], c["w"])


def volume_bwd_args_at(dev, dtype, proj, view_valid, voxel_dim, voxel_size,
                       h, w) -> tuple:
    """K1b's arguments for full-resolution projections [V, 3, 4] of
    ``h`` x ``w`` images and their view flags: features at stride 4
    (uniform, seed 0), K1's count for them over ``voxel_dim`` voxels at
    the origin, a gaussian cotangent (seed 1), in ``dtype``."""
    from cnrma_torch.ops import backproject as bp
    proj = proj.clone()
    proj[:, :2, :] /= 4
    v, h, w = proj.shape[0], h // 4, w // 4
    feats = torch.rand(v, h, w, 32, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev).to(dtype)
    origin = (0.0, 0.0, 0.0)
    _, cnt, _ = bp.volume_accum_cuda(proj, feats, view_valid, voxel_dim,
                                     voxel_size, origin)
    g = torch.randn(*voxel_dim, 32, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev).to(dtype)
    return (proj, g, cnt, view_valid, (h, w), tuple(voxel_dim), voxel_size,
            origin, dtype)


def check_volume_bwd(args, what: str) -> dict:
    """K1b against its plain version on ``args`` within ``K1B_TOL`` of the
    largest gradient (plus one bf16 ulp in bf16); raises beyond it.
    Returns the error, its tolerance's name and the largest gradient."""
    from cnrma_torch.ops import backproject as bp
    dtype = args[-1]
    got = bp.volume_accum_bwd_cuda(*args)
    want = bp.volume_accum_bwd_plain(*args)
    torch.cuda.synchronize()
    scale = float(want.float().abs().max())
    err = (got.float() - want.float()).abs()
    tol = K1B_TOL * scale + (0.0 if dtype == torch.float32
                             else 2.0 ** -7 * want.float().abs())
    tol_name = ("1e-5 of the largest gradient" if dtype == torch.float32
                else "1e-5 of the largest gradient + one bf16 ulp")
    if got.dtype != dtype or scale == 0 or not bool((err <= tol).all()):
        raise AssertionError(f"volume backward kernel ({what}): error "
                             f"{err.max().item()} beyond {tol_name} "
                             f"({dtype}, largest gradient {scale})")
    return dict(err=err.max().item(), tol_name=tol_name, scale=scale)


def volume_bwd_work(args) -> tuple:
    """(bytes, fp32 operations, (voxel, view) pairs) of the volume backward
    on these inputs.  Bytes: the cotangent and the count read, the
    projections and view flags, the gradient written once in the feature
    dtype (the kernel's fp32 zeroing exists only for its atomics and is
    not counted).  Operations: 6 per voxel (its centre), 21 per voxel
    and valid view (the projection), 32 per observed voxel (the division by
    its count), 32 per pair (the sums)."""
    proj, g, cnt, ok, (h, w), dim, vs, origin, dtype = args
    V, n, es = proj.shape[0], cnt.numel(), g.element_size()
    pairs = float(cnt.sum())
    nbytes = (n * 32 * es + 4 * n + proj.numel() * 4 + V
              + V * h * w * 32 * es)
    ops = (6.0 * n + 21.0 * n * int(ok.sum()) + 32.0 * int((cnt > 0).sum())
           + 32.0 * pairs)
    return nbytes, ops, pairs


def volume_bwd_rows(args, tile) -> int:
    """Distinct (tile, view, pixel) rows of the volume backward on these
    inputs, tiles of ``tile`` voxels: the rows K1b's blocks merge their
    (voxel, view) pairs into before they leave as atomics."""
    from cnrma_torch.ops import backproject as bp
    proj, g, cnt, ok, (h, w), dim, vs, origin, dtype = args
    ids = [torch.arange(n, device=g.device) // t for n, t in zip(dim, tile)]
    per = [-(-n // t) for n, t in zip(dim, tile)]
    tile_id = ((ids[0][:, None, None] * per[1] + ids[1][None, :, None])
               * per[2] + ids[2][None, None, :])
    rows = 0
    for v in range(proj.shape[0]):
        if not bool(ok[v]):
            continue
        flat, valid = bp.project_voxels(proj[v], dim, vs, origin, h, w)
        m = valid & (cnt > 0)
        rows += torch.unique(tile_id[m] * (h * w) + flat[m]).numel()
    return rows


def index_add_library(args):
    """The one PyTorch call that computes the volume backward:
    ``Tensor.index_add_`` of every valid (voxel, view) pair's row
    ``g / cnt`` into the zeroed [V * h * w, 32] at its pixel, the pairs'
    pixel ids and rows made beforehand, in the rows' dtype (bf16 sums in
    bf16 there)."""
    from cnrma_torch.ops import backproject as bp
    proj, g, cnt, ok, (h, w), dim, vs, origin, dtype = args
    g_sum = bp._sum_cotangent(g, cnt)
    dst, src = [], []
    for v in range(proj.shape[0]):
        flat, valid = bp.project_voxels(proj[v], dim, vs, origin, h, w)
        idx = torch.nonzero(valid.reshape(-1) & ok[v]).squeeze(1)
        dst.append(flat.reshape(-1)[idx] + v * h * w)
        src.append(idx)
    dst, rows = torch.cat(dst), g_sum[torch.cat(src)]
    n_pix = proj.shape[0] * h * w
    return lambda: torch.zeros(n_pix, 32, device=g.device,
                               dtype=rows.dtype).index_add_(0, dst, rows)


def phase_volume_backward(dev) -> dict:
    """K1b against its plain version at the training shape, bf16 then fp32
    (the training step's dtype, whose row is kept), timed beside the plain
    version and, in fp32, beside ``index_add_``."""
    from cnrma_torch.ops import backproject as bp
    row = None
    for dtype in (torch.bfloat16, torch.float32):
        args = volume_bwd_args(dev, dtype)
        c = check_volume_bwd(args, "training shape")
        err, scale, tol_name = c["err"], c["scale"], c["tol_name"]
        ms = time_ms(lambda: bp.volume_accum_bwd_cuda(*args), dev)
        plain_ms = time_ms(lambda: bp.volume_accum_bwd_plain(*args), dev,
                           reps=3)
        nbytes, ops, pairs = volume_bwd_work(args)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   **bound(nbytes, ops), library_ms=None)
        note = ""
        if dtype == torch.float32:
            library = index_add_library(args)
            want = bp.volume_accum_bwd_plain(*args)
            lib_err = float((library().reshape(want.shape) - want)
                            .abs().max())
            row["library_ms"] = time_ms(library, dev)
            note = (f", index_add_ {row['library_ms']:.4f} ms (max|err| "
                    f"{lib_err:.3g})")
            del library
        log(f"[volume bwd] {str(dtype)[6:]}: max|err| {err:.3g}"
            f" = {err / scale:.3g} of the largest gradient "
            f"{scale:.4g} (tol {tol_name}); (voxel, view) pairs {pairs:.0f}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms{note}; bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}")
        if dtype == torch.float32:
            direct = torch.zeros(1, dtype=torch.int64, device=dev)
            bp.volume_accum_bwd_cuda(*args, direct=direct)
            rows = volume_bwd_rows(args, bp.K1B_TILE)
            log(f"[volume bwd] tiles of {bp.K1B_TILE}: distinct (tile, view, "
                f"pixel) rows {rows} for {pairs:.0f} pairs ({pairs / rows:.2f}"
                f" pairs a row); pairs that skipped the window "
                f"{int(direct.item())}")
        del args
        torch.cuda.empty_cache()
    return row


def tiny_train_case(scenes: int = 1):
    """The tiny training step of ``tests/test_torch_train.py`` without
    JAX: the tiny CNRMA at 1 cm detector voxels, ``synthesize_parameters``
    (seed 1), ``scenes`` scenes of two 64x64 views and a GT box twice
    (numpy seed 0), the subsample's uniform draws and one augmentation
    draw a scene fixed."""
    from cnrma_torch.models import cn_rma as tcn
    from cnrma_torch.models.fcaf3d import DetectionCapacities
    from cnrma_torch.synthetic import synthesize_parameters
    model = tcn.CNRMA(voxel_dim=(16, 16, 16), voxel_size=0.1, n_classes=3,
                      ray_samples=24, rays_per_view_cap=512, max_points=1024,
                      pts_threshold=500, assigner_limit=2, assigner_topk=4,
                      nms_pre=16, voxel_size_fcaf3d=0.01,
                      capacities=DetectionCapacities.tiny())
    synthesize_parameters(model, 1)
    rng = np.random.RandomState(0)
    intr = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.8, 0.8, -0.4]
    proj = (intr @ np.linalg.inv(pose)[:3]).astype(np.float32)
    b = scenes
    batch = {
        "imgs": torch.from_numpy(rng.rand(b, 2, 64, 64, 3).astype(np.float32)
                                 * 255),
        "projection": torch.from_numpy(np.broadcast_to(proj, (b, 2, 3, 4))
                                       .copy()),
        "view_valid": torch.ones(b, 2, dtype=torch.bool),
        "offset": torch.zeros(b, 3),
        "gt_boxes": torch.tensor([[[0.8, 0.8, 0.8, 0.6, 0.6, 0.6, 0.0]] * 2]
                                 * b),
        "gt_labels": torch.ones(b, 2, dtype=torch.int32),
        "gt_valid": torch.ones(b, 2, dtype=torch.bool),
        "tsdf_list": {f"tsdf_gt_{k}": torch.from_numpy(
            rng.rand(b, n, n, n).astype(np.float32) * 2 - 1)
            for k, n in (("010", 16), ("020", 8), ("040", 4))}}
    draws = dict(
        uniform=torch.from_numpy(rng.rand(b, 1024).astype(np.float32)),
        aug_draws=[tcn.draw_feature_transform(
            torch.Generator().manual_seed(1 + i), "cpu") for i in range(b)])
    return ({k: v.clone() for k, v in model.state_dict().items()}, model,
            batch, draws)


def _step(model, batch, draws, plant=None):
    """One training forward and backward; ``plant(model)`` runs after
    ``model.train()``."""
    from cnrma_torch.train.loop import total_loss
    model.train()
    if plant is not None:
        plant(model)
    losses = model.forward_train(batch, **draws)
    total_loss(losses).backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().double().cpu() for n, p in model.named_parameters()}
    stats = {n: b.detach().cpu().clone() for n, b in model.named_buffers()}
    return {k: float(v.detach()) for k, v in losses.items()}, grads, stats


# The tiny step's limits, GPU against CPU: losses (relative), every
# gradient leaf past the 2D tower (of the leaf's largest magnitude), the
# tower's three groups (cosine, relative L2 error), each tower leaf
# (cosine), the running statistics (absolute).
TRAIN_LIMITS = {"losses": 1e-4, "leaf": 5e-3, "group_cos": 0.999,
                "group_err": 0.02, "leaf_cos": 0.99, "stats": 1e-5}
TOWER_GROUPS = ("tower2d.resnet.", "tower2d.fpn.", "tower2d.fuse.")
# the one-leaf fault's leaf: under 1% of the trunk's gradient by L2 norm
ONE_TOWER_LEAF = "tower2d.resnet.res5_block2.conv3.norm.bias"


def _cosine(a, b) -> float:
    na, nb = float(a.norm()), float(b.norm())
    if na == 0 or nb == 0:
        return float(na == nb)
    return float(a @ b) / (na * nb)


def _train_readings(got, want, group_names=TOWER_GROUPS) -> dict:
    """The readings of ``TRAIN_LIMITS`` for the step ``got`` against
    ``want`` ((losses, gradients, statistics) each), with the worst leaf
    or group: the leaves of ``group_names`` held as groups and by cosine,
    every other leaf by its largest magnitude."""
    (gl, gg, gs), (wl, wg, ws) = got, want
    grouped = [k for k in wg if k.startswith(group_names)]
    r = {"losses": max((abs(gl[k] - w) / abs(w), k)
                       for k, w in wl.items() if w),
         "leaf": max((float((gg[k] - wg[k]).abs().max()
                            / wg[k].abs().max().clamp(min=1e-30)), k)
                     for k in wg if k not in grouped),
         "leaf_cos": min((_cosine(gg[k].ravel(), wg[k].ravel()), k)
                         for k in grouped),
         "stats": max((float((gs[k].float() - ws[k].float()).abs().max()), k)
                      for k in ws if ws[k].is_floating_point())}
    groups = []
    for name in group_names:
        keys = [k for k in wg if k.startswith(name)]
        a = torch.cat([gg[k].ravel() for k in keys])
        b = torch.cat([wg[k].ravel() for k in keys])
        groups.append((_cosine(a, b), float((a - b).norm() / b.norm()),
                       name[:-1]))
    r["group_cos"] = min((c, n) for c, _, n in groups)
    r["group_err"] = max((e, n) for _, e, n in groups)
    r["groups"] = groups
    return r


def _train_failures(r) -> list:
    return sorted(k for k, lim in TRAIN_LIMITS.items()
                  if (r[k][0] < lim if k.endswith("cos") else r[k][0] > lim))


def _fmt_readings(r) -> str:
    return "; ".join(
        [f"{k} {r[k][0]:{'.6f' if k.endswith('cos') else '.3g'}} "
         f"({r[k][1]}; limit {lim})" for k, lim in TRAIN_LIMITS.items()]
        + ["groups " + ", ".join(f"{n} cos {c:.6f} err {e:.3g}"
                                 for c, e, n in r["groups"])])


def _planted_faults():
    """Faults the phase plants in the GPU step, each a (plant before the
    forward, change of the gradients after it) pair: the volume's backward
    dropping view 1's gradient (K1b still launches), the 2D trunk's
    train-mode norms running on their running statistics, and one tower
    leaf's gradient lost."""
    from cnrma_torch.models import layers

    def trunk_eval(model):
        for m in model.tower2d.resnet.modules():
            if isinstance(m, layers.BatchNorm):
                m.eval()

    def lose_leaf(grads):
        grads[ONE_TOWER_LEAF].zero_()
    return {"k1b_drops_view": (None, None),
            "trunk_norms_eval": (trunk_eval, None),
            "one_tower_leaf": (None, lose_leaf)}


def phase_train_reference(dev) -> None:
    """The tiny training step in fp32 on the GPU (kernels, K1b in the
    backward) and on the CPU (plain versions), same parameters, batch,
    draws and kept points (the CPU run's subsample given to the GPU run),
    held at ``TRAIN_LIMITS``: the losses within 1e-4 relative, the running
    statistics within 1e-5, every gradient leaf past the 2D tower within
    5e-3 of the leaf's largest magnitude (cuDNN's 3D convolutions round
    otherwise than the CPU's: the U-Net's leaves differ by up to 1.4e-3 of
    theirs); the tower's leaves, whose training backward is chaotic in
    fp32 (``tests/test_torch_train.py``), as three groups (R-50, FPN,
    fuse: cosine at least 0.999, relative L2 error at most 0.02) and each
    leaf at a cosine of at least 0.99.  Then the same step with each of
    ``_planted_faults`` must break a limit of the tower's."""
    from cnrma_torch.models import cn_rma as tcn
    from cnrma_torch.ops import backproject as bp
    state, model, batch, draws = tiny_train_case()
    real, kept = tcn._normalize_subsample, {}

    def spy(*args, **kw):
        kept["points"] = real(*args, **kw)
        return kept["points"]
    gpu_batch = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                     if isinstance(v, dict) else v.to(dev))
                 for k, v in batch.items()}
    gpu_draws = dict(uniform=draws["uniform"].to(dev),
                     aug_draws=[{k: v.to(dev) for k, v in d.items()}
                                for d in draws["aug_draws"]])

    def gpu_step(plant=None):
        model.load_state_dict(state)
        model.zero_grad(set_to_none=True)
        return _step(model, gpu_batch, gpu_draws, plant)
    tcn._normalize_subsample = spy
    real_bwd = bp.volume_accum_bwd
    try:
        want = _step(model, batch, draws)
        tcn._normalize_subsample = lambda *args, **kw: tuple(
            t.to(dev) for t in kept["points"])
        model.to(dev)
        bp.VOLUME_ACCUM_BWD.launches = 0
        got = gpu_step()
        launches = bp.VOLUME_ACCUM_BWD.launches
        faults = {}
        for name, (plant, change) in _planted_faults().items():
            if name == "k1b_drops_view":
                def drop_view(*args):
                    g = real_bwd(*args).clone()
                    g[1] = 0
                    return g
                bp.volume_accum_bwd = drop_view
            bad = gpu_step(plant)
            bp.volume_accum_bwd = real_bwd
            if change is not None:
                change(bad[1])
            faults[name] = _train_readings(bad, want)
    finally:
        tcn._normalize_subsample = real
        bp.volume_accum_bwd = real_bwd
    r = _train_readings(got, want)
    log(f"[train reference] tiny fp32 step, GPU vs CPU: K1b launched "
        f"{launches}; kept points {int(kept['points'][4].sum())}; "
        + _fmt_readings(r))
    tower = {"group_cos", "group_err", "leaf_cos"}
    caught = {}
    for name, fr in faults.items():
        caught[name] = _train_failures(fr)
        log(f"[train reference] planted fault {name}: breaks "
            f"{caught[name]}; " + _fmt_readings(fr))
    if launches != 1 or set(got[0]) != set(want[0]) or _train_failures(r):
        raise AssertionError(f"the GPU training step disagrees with the "
                             f"CPU: {_train_failures(r)}")
    missed = [n for n, f in caught.items() if not tower & set(f)]
    if missed:
        raise AssertionError(f"the tower's limits pass planted faults: "
                             f"{missed}")


def _test_forward_tsdf(cfg, data: str, ann: str, ckpts, written, dev):
    """The fine TSDF of the test split's first scene under each checkpoint
    in ``ckpts`` (as the test CLI reads it: dataset seed 0, generator seed
    0), each held against ``written``: the max abs differences."""
    from cnrma_torch.core.builder import build_dataset, build_model
    from cnrma_torch.tools import test as test_cli
    cfg.merge_from_options({"data.test.data_root": data,
                            "data.test.ann_file": ann})
    sample = build_dataset(cfg, "test", seed=0)[0]
    batch = {k: torch.from_numpy(np.asarray(sample[k])[None]).to(dev)
             for k in ("imgs", "projection", "view_valid", "offset")}
    model = build_model(cfg, mode="test")
    diffs = []
    for ckpt in ckpts:
        test_cli.load_parameters(model, ckpt, 0)
        model.to(dev)
        out = model(batch, generator=torch.Generator(dev).manual_seed(0))
        fine = out["tsdf"][f"scene_tsdf_{model.tsdf_head.keys[-1]}"][0]
        diffs.append(float((fine.float().cpu() - written).abs().max()))
        del out, fine
    del model, batch
    torch.cuda.empty_cache()
    return diffs


@contextlib.contextmanager
def _eval_probe():
    """What the train CLI's val evaluations inside the block saw: the
    fine TSDF shape of each test forward of its test twin (``grids``, a
    hook on the twin's TSDF head) and, on a model with a detector, its
    head's valid rows whose face distances or yaw ratio ``q`` passed
    fp32's range in ``exp`` (``overflowed``, ROADMAP F13) and those not
    finite for any other reason (``unexplained``)."""
    from cnrma_torch.tools import train as train_cli
    from cnrma_torch.tools.overflow_survey import head_overflow
    seen = {"grids": [], "overflowed": 0, "unexplained": 0}
    evaluate = train_cli.evaluate_split

    def tsdf_hook(key):
        return lambda m, i, o: seen["grids"].append(tuple(o[key].shape[1:]))

    def head_hook(module, inputs, outs):
        over, bad = head_overflow(outs)
        seen["overflowed"] += over
        seen["unexplained"] += bad

    def probe(model, *args, **kw):
        hooks = []
        if hasattr(model, "tsdf_head"):
            key = f"scene_tsdf_{model.tsdf_head.keys[-1]}"
            hooks.append(model.tsdf_head.register_forward_hook(
                tsdf_hook(key)))
        if hasattr(model, "detector"):
            hooks.append(model.detector.head.register_forward_hook(
                head_hook))
        try:
            return evaluate(model, *args, **kw)
        finally:
            for h in hooks:
                h.remove()
    train_cli.evaluate_split = probe
    try:
        yield seen
    finally:
        train_cli.evaluate_split = evaluate


# the val scores of the detector's losses, which a head overflow (F13)
# can make not finite
DETECTOR_LOSSES = ("val/loss_centerness", "val/loss_bbox", "val/loss_cls",
                   "val/total_loss")


def _check_val(tag: str, records, seen, grid, n_scenes: int, metric: str,
               work_dir: str, batch: int = 1) -> str:
    """The train CLI's evaluation at its stop by ``--max-steps``: a val
    record, each of the ``n_scenes`` val scenes scored at ``grid`` (the
    config's test grid), and ``best.pt`` with the record's scores in its
    meta; logs the scores and the seconds the evaluation took beside the
    steps'.  The TSDF losses and, for ``metric='mAP'``, ``0 <= mAP,
    mAR <= 1`` must hold in every run.  The detector's losses and the
    total must be finite unless the val forwards' head overflowed fp32
    (``seen`` of ``_eval_probe``): a checkpoint 3 steps from its
    initialisation can (ROADMAP F13), and then the losses of the boxes
    past fp32's range are not finite, as the reference's would be; a
    value not finite for any other reason fails.  The split is read in
    batches of ``batch`` scenes, a forward a batch.  Returns the path of
    ``best.pt``.  The CLI's warn-and-skip of a missing val split fails
    here."""
    from cnrma_torch.train.state import read_checkpoint
    evals = [r for r in records if "val" in r]
    if not evals:
        raise AssertionError(f"[{tag}] no val record: the evaluation did "
                             f"not run")
    rec = evals[-1]
    grids = seen["grids"]
    steps_s = sum(r["step_s"] for r in records)
    log(f"[{tag}] val at step {rec['step']}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in rec["val"].items())
        + f"; evaluation {rec['eval_s']:.2f} s for {n_scenes} scenes "
        f"({rec['eval_s'] / n_scenes:.2f} s a scene; the {len(records)} "
        f"steps {steps_s:.2f} s, the evaluation "
        f"{rec['eval_s'] / (rec['eval_s'] + steps_s):.1%} of both); "
        f"scored at {sorted(set(grids))}; head rows past fp32 in exp "
        f"{seen['overflowed']}, not finite otherwise {seen['unexplained']}")
    if seen["unexplained"]:
        raise AssertionError(f"[{tag}] {seen['unexplained']} head rows of "
                             f"the val forwards are not finite for a reason "
                             f"other than exp's overflow")
    not_finite = [k for k, v in rec["val"].items() if not math.isfinite(v)]
    if not_finite and not (seen["overflowed"] and set(not_finite) <= set(
            DETECTOR_LOSSES)):
        raise AssertionError(f"[{tag}] val scores not finite: {not_finite} "
                             f"({seen['overflowed']} head rows past fp32)")
    if not_finite:
        log(f"[{tag}] {not_finite} not finite: {seen['overflowed']} head "
            f"rows of the val forwards passed fp32's range in exp (F13)")
    maps = [k for k in rec["val"] if k.startswith(("val/mAP", "val/mAR"))]
    if metric == "mAP" and (len(maps) != 3 or not all(
            0.0 <= rec["val"][k] <= 1.0 for k in maps)):
        raise AssertionError(f"[{tag}] val mAP and mAR must lie in [0, 1]: "
                             f"{rec['val']}")
    forwards = -(-n_scenes // batch) * len(evals)
    if len(grids) != forwards or set(grids) != {tuple(grid)}:
        raise AssertionError(f"[{tag}] the val split must be scored at the "
                             f"test grid {tuple(grid)}, a forward a batch "
                             f"of {batch}: {grids}")
    best = os.path.join(work_dir, "best.pt")
    meta = read_checkpoint(best)["meta"]
    log(f"[{tag}] best.pt: {meta}")
    loss = meta["val_total_loss"]
    ok = meta["eval_metric"] == metric and (
        math.isfinite(loss) or "val/total_loss" in not_finite)
    if metric == "mAP":
        ok = ok and 0.0 <= meta["val_mAP_0.25"] <= 1.0
    if not ok:
        raise AssertionError(f"[{tag}] best.pt's meta: {meta}")
    return best


def phase_train_cli(dev) -> dict:
    """The user's training loop on the card: ``python -m
    cnrma_torch.tools.train configs/ray_marching_scannet.py --max-steps 3``
    at the config's full training width (40 views of 480x640 from 1296x968
    JPEG frames, the 192x192x80 grid, fp32) on two synthetic ScanNet scenes
    written under ``build/``, from default-initialised weights
    (``--load-from``); per step each loss, the gradient norm, the step's
    and the reader wait's seconds, the peak memory and the stage times
    (``timing.stage_marks`` in the train loop); K1, K1b and K2 once
    a step; the mid-training evaluation at the stop by ``--max-steps``:
    the val split (the same two scenes, 50 views) scored at the config's
    test grid, 256x256x96, losses and mAP, K1 and K2 once a scene, and
    ``best.pt``; then one backward of the reconstruction losses alone,
    which must reach the 2D tower (through K1b); then the test CLI on one
    scene from ``best.pt``, whose TSDF must be this process's test forward
    of that checkpoint; then 3 steps with depth marching from the same
    start (``_depth_train_steps``).  Returns the NeuS run's launches."""
    from cnrma_torch.core.builder import build_dataset, build_model
    from cnrma_torch.core.config import Config
    from cnrma_torch.data.loader import collate_scenes
    from cnrma_torch.ops.backproject import VOLUME_ACCUM, VOLUME_ACCUM_BWD
    from cnrma_torch.ops.ray_marching import RAY_MARCH
    from cnrma_torch.synthetic import write_scannet
    from cnrma_torch.tools import test as test_cli
    from cnrma_torch.tools import train as train_cli
    from cnrma_torch.train.loop import device_batch, step_generator
    from cnrma_torch.train.state import read_checkpoint
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_", dir="build")
    try:
        t0 = time.perf_counter()
        data = os.path.join(root, "data")
        ann = write_scannet(data, n_scenes=2, n_frames=40,
                            ann_name="scannet_infos_train.pkl")
        val = os.path.join(data, "scannet_infos_val.pkl")
        shutil.copy(ann, val)
        cfg = Config.fromfile(CLI_CONFIG)
        torch.manual_seed(0)
        init = os.path.join(root, "init.pt")
        torch.save(build_model(cfg, mode="train").state_dict(), init)
        log(f"[train cli] wrote 2 scenes (40 frames of 1296x968 JPEG, room "
            f"TSDF and boxes) and a default-initialised checkpoint in "
            f"{time.perf_counter() - t0:.1f} s")
        opts = [f"data.train.data_root={data}", f"data.train.ann_file={ann}",
                f"data.val.data_root={data}", f"data.val.ann_file={val}",
                "log_config.interval=1"]
        wd = os.path.join(root, "wd")
        torch.cuda.synchronize()
        for c in (VOLUME_ACCUM, VOLUME_ACCUM_BWD, RAY_MARCH):
            c.launches = 0
        t0 = time.perf_counter()
        with _eval_probe() as seen:
            records, ckpt = train_cli.main(
                [CLI_CONFIG, "--work-dir", wd, "--load-from", init,
                 "--max-steps", "3", "--cfg-options", *opts])
        wall = time.perf_counter() - t0
        launches = {"volume_accum": VOLUME_ACCUM.launches,
                    "volume_accum_bwd": VOLUME_ACCUM_BWD.launches,
                    "ray_march": RAY_MARCH.launches}
        log(f"[train cli] 3 steps in {wall:.2f} s; launches {launches}")
        for r in records:
            log(f"[train cli] step {r['step']}: "
                + ", ".join(f"{k} {v:.4f}" for k, v in r["log_vars"].items())
                + f"; step {r['step_s']:.3f} s, read {r['load_s']:.3f} s, "
                f"waited {r['wait_s']:.3f} s, peak memory "
                f"{r['peak_gib'] or 0:.2f} GiB; stages (CUDA events, ms) "
                + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
                    r["stages_ms"].items(), key=lambda kv: -kv[1]))
                + f", sum {sum(r['stages_ms'].values()):.1f}")
        finite = all(np.isfinite(v) for r in records
                     for v in r["log_vars"].values())
        if len(records) != 3 or not finite:
            raise AssertionError("the train CLI must take 3 steps with "
                                 "finite losses and gradient norms")
        if launches != {"volume_accum": 5, "volume_accum_bwd": 3,
                        "ray_march": 5}:
            raise AssertionError(f"each step must launch K1, K1b and K2 "
                                 f"once, each val scene K1 and K2 once: "
                                 f"{launches}")
        best = _check_val("train cli", records, seen,
                          cfg.model.voxel_dim_test, 2, "mAP", wd)
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in opts))
        model = build_model(cfg, mode="train")
        model.load_state_dict(read_checkpoint(ckpt)["model"])
        model.to(dev)
        batch = device_batch(collate_scenes(
            [build_dataset(cfg, "train", seed=0)[0]]), dev)
        losses = model.forward_train(batch, step_generator(0, 3, dev))
        sum(v for k, v in losses.items() if k.startswith("tsdf_")).backward()
        tower = [p.grad for p in model.tower2d.parameters()
                 if p.grad is not None]
        norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in tower)))
        log(f"[train cli] the reconstruction losses alone give the 2D tower "
            f"a gradient of norm {norm:.4g} ({len(tower)} leaves)")
        if not math.isfinite(norm) or norm <= 0:
            raise AssertionError("no gradient reached the 2D tower from "
                                 "the reconstruction losses")
        del model, batch, losses, tower
        torch.cuda.empty_cache()
        save, middle = os.path.join(root, "res"), os.path.join(root, "mid")
        recs = test_cli.main([CLI_CONFIG, best, "--max-scenes", "1",
                              "--save-path", save, "--middle-save-path",
                              middle, "--cfg-options",
                              f"data.test.data_root={data}",
                              f"data.test.ann_file={val}"])
        scene = recs[0]["scene"]
        # a few AdamW steps from random weights move the TSDF far (its
        # surface, and so the kept points and boxes, come and go from run
        # to run), so the files must be well formed but may hold no points;
        # such a checkpoint's eval-mode norms keep most of their initial
        # statistics, and on a dense cloud its sparse ResNet's outputs grow
        # until the head's exp overflows fp32 (the reference's arithmetic
        # too; ``python -m cnrma_torch.tools.overflow_survey``), so boxes
        # may be infinite there, and only there
        n = _check_scene_files(save, middle, scene, cfg.model.voxel_dim_test,
                               need_points=False, overflow_ok=True)
        log(f"[train cli] the test CLI ran {scene} from "
            f"{os.path.basename(best)}: forward {recs[0]['forward_s']:.3f} "
            f"s, {n['raw_boxes']} raw boxes ({n['overflowed']} with face "
            f"distances past fp32), {n['middle_points']} points, files well "
            f"formed")
        with np.load(os.path.join(save, scene, scene + ".npz")) as z:
            written = torch.from_numpy(z["tsdf"])
        err, moved = _test_forward_tsdf(cfg, data, val, (best, init),
                                        written, dev)
        log(f"[train cli] {scene}'s TSDF from the CLI against this "
            f"process's test forward of {os.path.basename(best)}: max|err| "
            f"{err:.3g} (tol 1e-5); of the initial weights: max|diff| "
            f"{moved:.3g} (must exceed 1e-3)")
        if not err <= 1e-5 or not moved > 1e-3:
            raise AssertionError("the test CLI's TSDF is not the trained "
                                 "checkpoint's")
        gc.collect()
        torch.cuda.empty_cache()
        _depth_train_steps(root, init, opts[:2], records)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


DEPTH_OPTIONS = ("model.ray_marching_type=depth", "model.depth_points=2")


def _depth_train_steps(root: str, init: str, data_opts, neus) -> None:
    """Depth marching in training: 3 steps of the train CLI with
    ``DEPTH_OPTIONS`` at the config's full width on phase 6e's scenes, from
    the same start as 6e's NeuS run (``neus``, its records): K1 and K1b
    once a step and K2 never, finite losses; each step's CUDA-event
    stages, seconds and peak memory beside the NeuS step's."""
    from cnrma_torch.ops.backproject import VOLUME_ACCUM, VOLUME_ACCUM_BWD
    from cnrma_torch.ops.ray_marching import RAY_MARCH
    counters = {"volume_accum": VOLUME_ACCUM,
                "volume_accum_bwd": VOLUME_ACCUM_BWD, "ray_march": RAY_MARCH}
    records, _, launches, _ = _run_train_cli(
        [CLI_CONFIG, "--work-dir", os.path.join(root, "depth"),
         "--load-from", init, "--max-steps", "3", "--cfg-options",
         *data_opts, "evaluation=None", "log_config.interval=1",
         *DEPTH_OPTIONS], counters, 3, "train cli depth")
    if launches != {"volume_accum": 3, "volume_accum_bwd": 3,
                    "ray_march": 0}:
        raise AssertionError(f"each depth step must launch K1 and K1b once "
                             f"and K2 never: {launches}")
    for d, n in zip(records, neus):
        log(f"[train cli depth] step {d['step']}: {d['step_s']:.3f} s "
            f"(NeuS {n['step_s']:.3f}), peak {d['peak_gib'] or 0:.2f} GiB "
            f"(NeuS {n['peak_gib'] or 0:.2f}); march "
            f"{d['stages_ms'].get('march', float('nan')):.1f} ms (NeuS "
            f"{n['stages_ms'].get('march', float('nan')):.1f}), backward "
            f"{d['stages_ms'].get('backward', float('nan')):.1f} ms (NeuS "
            f"{n['stages_ms'].get('backward', float('nan')):.1f}) ({card()})")


STAGE1_CONFIG = "configs/atlas_recon_scannet.py"
MIDDLE_CONFIG = "configs/scannet_middle.py"
STAGE2_CONFIG = "configs/fcaf3d_middle_scannet.py"
STAGE1_TEST_VIEWS = 50      # the Atlas config tests on 500 views


class _Tee(io.StringIO):
    """Standard output kept as well as shown."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)

    def flush(self):
        self.out.flush()


def _counts(counters: dict) -> dict:
    return {name: c.launches for name, c in counters.items()}


def _run_train_cli(argv, counters, steps: int, tag: str):
    """``python -m cnrma_torch.tools.train`` with ``argv``, the launch
    counts set to 0 just before it; logs each step and checks ``steps``
    steps with finite losses.  Returns the records, the last checkpoint,
    the launches and the CLI's standard output."""
    from cnrma_torch.tools import train as train_cli
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        records, ckpt = train_cli.main(argv)
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    log(f"[{tag}] {len(records)} steps in {wall:.2f} s; launches {launches}")
    for r in records:
        log(f"[{tag}] step {r['step']}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["log_vars"].items())
            + f"; step {r['step_s']:.3f} s, read {r['load_s']:.3f} s, "
            f"waited {r['wait_s']:.3f} s, peak memory "
            f"{r['peak_gib'] or 0:.2f} GiB; stages (CUDA events, ms) "
            + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
                r["stages_ms"].items(), key=lambda kv: -kv[1]))
            + f", sum {sum(r['stages_ms'].values()):.1f}")
    if len(records) != steps or not all(
            np.isfinite(v) for r in records for v in r["log_vars"].values()):
        raise AssertionError(f"[{tag}] the train CLI must take {steps} "
                             f"steps with finite losses and gradient norms")
    return records, ckpt, launches, tee.getvalue()


def _stage1_volume_bwd(dev, cfg, data: str, ann: str) -> list:
    """K1b at stage 1's shape: the projections of the stage-1 reader's
    first sample (a random z-rotation and crop of the room, 50 views, the
    160x160x64 grid), against its plain version at phase 6c's tolerance,
    in stage 1's bf16 and in fp32; its time beside the plain version's
    and ``index_add_``'s; the pairs that skipped its window.
    Returns its device-time calls for phase 8, as ``_arkit_kernels``,
    with ``index_add_`` as the library call in both dtypes."""
    from cnrma_torch.core.builder import build_dataset
    from cnrma_torch.ops import backproject as bp
    cfg.merge_from_options({"data.train.data_root": data,
                            "data.train.ann_file": ann})
    sample = build_dataset(cfg, "train", seed=0)[0]
    proj = torch.from_numpy(sample["projection"]).to(dev)
    valid = torch.from_numpy(sample["view_valid"]).to(dev)
    h, w = sample["imgs"].shape[1:3]
    angle = math.degrees(math.atan2(float(sample["projection"][0, 1, 0]),
                                    float(sample["projection"][0, 0, 0])))
    log(f"[stage 1] K1b at stage 1's shape: {int(valid.sum())} views of "
        f"[{h // 4}, {w // 4}, 32], {tuple(cfg.model.voxel_dim_train)} "
        f"voxels, crop offset {np.round(sample['offset'], 3).tolist()}, "
        f"view 0's projection turned {angle:.1f} deg")
    for dtype in (torch.bfloat16, torch.float32):
        args = volume_bwd_args_at(dev, dtype, proj, valid,
                                  tuple(cfg.model.voxel_dim_train),
                                  cfg.model.voxel_size, h, w)
        c = check_volume_bwd(args, "stage 1's shape")
        ms = time_ms(lambda: bp.volume_accum_bwd_cuda(*args), dev)
        plain_ms = time_ms(lambda: bp.volume_accum_bwd_plain(*args), dev,
                           reps=3)
        library = index_add_library(args)
        note = f", index_add_ {time_ms(library, dev):.4f} ms"
        del library
        nbytes, ops, pairs = volume_bwd_work(args)
        direct = torch.zeros(1, dtype=torch.int64, device=dev)
        bp.volume_accum_bwd_cuda(*args, direct=direct)
        log(f"[stage 1] K1b {str(dtype)[6:]}: max|err| {c['err']:.3g} = "
            f"{c['err'] / c['scale']:.3g} of the largest gradient (tol "
            f"{c['tol_name']}); kernel {ms:.4f} ms, plain {plain_ms:.3f} "
            f"ms{note}; bound {bound(nbytes, ops)['bound_ms']:.4f} ms; "
            f"(voxel, view) pairs {pairs:.0f}, pairs that skipped the "
            f"window {int(direct.item())} "
            f"({int(direct.item()) / max(pairs, 1):.1%})")
        del args
        torch.cuda.empty_cache()
    dim = tuple(cfg.model.voxel_dim_train)
    return [(f"K1b at stage 1's shape, {str(dtype)[6:]}",
             "volume_accum_bwd_kernel",
             lambda dtype=dtype: volume_bwd_args_at(
                 dev, dtype, proj, valid, dim, cfg.model.voxel_size, h, w),
             lambda a: bp.volume_accum_bwd_cuda(*a), index_add_library)
            for dtype in (torch.bfloat16, torch.float32)]


def _gt_meshes(dev, data: str, scenes, out: str) -> None:
    """Each scene's GT mesh, ``{out}/{scene}.ply``: the marching-cubes
    surface of its ``tsdf_04``."""
    from cnrma_torch.geometry.tsdf import TSDF
    from cnrma_torch.utils.ply import write_ply_mesh
    os.makedirs(out, exist_ok=True)
    for scene in scenes:
        gt = TSDF.load(os.path.join(data, "atlas_tsdf", scene, "tsdf_04.npz"))
        verts, faces, normals = gt.get_mesh(dev)
        write_ply_mesh(os.path.join(out, scene + ".ply"), verts, faces,
                       vertex_normals=normals)


def _dump_against_forward(cfg, data: str, ann: str, ckpt: str, mid: str,
                          dev, tag: str = "stage 2.1") -> list:
    """Each scene's stage-2.1 dump held against this process's own test
    forward of the same checkpoint (the reader at seed 0, the CLI's
    generator seeded by the scene's index, the detector synthesized from
    seed 0): the kept points' count must be the same and their rows
    within 1e-5.  Returns the points a scene."""
    from cnrma_torch.core.builder import build_dataset, build_model
    from cnrma_torch.tools import test as test_cli
    cfg.merge_from_options({"data.test.data_root": data,
                            "data.test.ann_file": ann})
    dataset = build_dataset(cfg, "test", seed=0)
    model = build_model(cfg, mode="test")
    test_cli.load_parameters(model, ckpt, 0, keep_missing=("detector.",))
    model.to(dev)
    counts = []
    for index in range(len(dataset)):
        sample = dataset[index]
        batch = {k: torch.from_numpy(np.asarray(sample[k])[None]).to(dev)
                 for k in ("imgs", "projection", "view_valid", "offset")}
        out = model(batch, generator=torch.Generator(dev).manual_seed(index))
        pts = out["points"]
        v = pts.valid[0]
        want = torch.cat([pts.xyz[0][v], pts.feats[0][v]], 1).float().cpu()
        got = torch.from_numpy(np.load(os.path.join(
            mid, sample["scene"] + "_vert.npy")))
        err = (float((got - want).abs().max()) if len(want) and
               got.shape == want.shape else 0.0)
        log(f"[{tag}] {sample['scene']}: the dump holds {len(got)} "
            f"points, this process's forward of the checkpoint "
            f"{len(want)}; max|err| {err:.3g} (tol 1e-5)")
        if got.shape != want.shape or err > 1e-5:
            raise AssertionError(f"{sample['scene']}: the stage-2.1 dump is "
                                 f"not the checkpoint's forward")
        counts.append(len(got))
        del out, pts, batch
    del model
    torch.cuda.empty_cache()
    return counts


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _merge(s1: str, s2: str, merged: str, tag: str) -> None:
    """``combine_models`` of the stage-1 checkpoint ``s1`` and the stage-2
    one ``s2`` into ``merged``, which must hold both stages' tensors bit
    for bit."""
    from cnrma_torch.tools import combine_models
    with contextlib.redirect_stdout(io.StringIO()):
        state = combine_models.main(["--recon", s1, "--detector", s2,
                                     "--output", merged])
    written = torch.load(merged, map_location="cpu", weights_only=True)
    a = combine_models.read_state(s1)
    b = combine_models.read_state(s2)
    same_a = all(_bit_equal(written[k], v) for k, v in a.items())
    same_b = all(_bit_equal(written[k], v) for k, v in b.items())
    log(f"[{tag}] {len(written)} tensors: {len(a)} from stage 1 bit-equal "
        f"{same_a}, {len(b)} from stage 2 bit-equal {same_b}")
    if not (same_a and same_b and len(written) == len(a) + len(b)
            == len(state)):
        raise AssertionError(f"[{tag}] the merged checkpoint must hold "
                             f"stage 1's and stage 2's tensors bit for bit")


def phase_three_stages(dev) -> list:
    """The three-stage ScanNet recipe on the card (``doc/train_val.md``),
    on two synthetic ScanNet scenes written under ``build/``: stage 1 (the
    train CLI on ``configs/atlas_recon_scannet.py``, 3 steps at its full
    width: 50 views of 480x640, 160x160x64, ``recon_random``, bf16, Adam;
    no R-50 file, so 0 pretrained tensors and the warning); K1b at stage
    1's shape; the stage-1 checkpoint through the test CLI (its config's
    test grid, views cut to 50) and ``evaluate_mesh`` against the GT
    meshes; the stage-2.1 dump (the test CLI on ``configs/
    scannet_middle.py`` from the stage-1 checkpoint, two scenes at full
    width), held against this process's forward; stage 2 (the train CLI on
    ``configs/fcaf3d_middle_scannet.py``, 3 steps at 500,000 points a scene,
    on synthetic dumps and on the 2.1 dumps that are not empty); the merge,
    bit for bit; one stage-3 step from the merged file.  Returns K1b's
    device-time calls at stage 1's shape for phase 8."""
    from cnrma_torch.core.builder import build_dataset
    from cnrma_torch.core.config import Config
    from cnrma_torch.ops.backproject import VOLUME_ACCUM, VOLUME_ACCUM_BWD
    from cnrma_torch.ops.ray_marching import RAY_MARCH
    from cnrma_torch.synthetic import write_point_dumps, write_scannet
    from cnrma_torch.tools import evaluate_mesh
    from cnrma_torch.tools import test as test_cli
    counters = {"volume_accum": VOLUME_ACCUM,
                "volume_accum_bwd": VOLUME_ACCUM_BWD, "ray_march": RAY_MARCH}
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="stages_", dir="build")
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        data = os.path.join(root, "data")
        ann = write_scannet(data, n_scenes=2, n_frames=60,
                            ann_name="scannet_infos_train.pkl")
        val = os.path.join(data, "scannet_infos_val.pkl")
        shutil.copy(ann, val)
        scenes = ["scene0000_00", "scene0001_00"]
        cfg1 = Config.fromfile(STAGE1_CONFIG)
        log(f"[stages] wrote 2 scenes (60 frames of 1296x968 JPEG, room "
            f"TSDF and boxes) in {time.perf_counter() - t0:.1f} s")

        # 1. stage 1, from the CLI's default initialisation (seed 0), with
        # a val split read as the config's test split (the stage-1 configs
        # have none): two scenes at the test grid, views cut to 50
        val_split = dict(cfg1.data.test, data_root=data, ann_file=val,
                         num_frames=STAGE1_TEST_VIEWS)
        with _eval_probe() as seen:
            records, s1, launches, out = _run_train_cli(
                [STAGE1_CONFIG, "--work-dir", os.path.join(root, "s1"),
                 "--max-steps", "3", "--cfg-options",
                 f"data.train.data_root={data}",
                 f"data.train.ann_file={ann}", f"data.val={val_split!r}",
                 "log_config.interval=1"], counters, 3, "stage 1")
        pre = [ln for ln in out.splitlines() if "backbone2d.pretrained" in ln
               or "pretrained 2D-backbone" in ln]
        log(f"[stage 1] R-50: {pre}")
        if not (len(pre) == 1 and "(0 tensors loaded)" in pre[0]):
            raise AssertionError("stage 1 must say it loaded 0 R-50 "
                                 "tensors, the file being missing")
        if launches != {"volume_accum": 5, "volume_accum_bwd": 3,
                        "ray_march": 0}:
            raise AssertionError(f"each stage-1 step must launch K1 and K1b "
                                 f"once, each val scene K1 once, K2 never: "
                                 f"{launches}")
        _check_val("stage 1", records, seen, cfg1.model.voxel_dim_test, 2,
                   "loss", os.path.join(root, "s1"))

        # the stage-1 reader alone at 1 and 4 workers over the two rooms
        cfg_r = Config.fromfile(STAGE1_CONFIG)
        cfg_r.merge_from_options({"data.train.data_root": data,
                                  "data.train.ann_file": ann})
        _reader_turns("stage 1 readers",
                      lambda: build_dataset(cfg_r, "train", seed=0))

        # 2. K1b at stage 1's shape
        calls = _stage1_volume_bwd(dev, Config.fromfile(STAGE1_CONFIG), data,
                                   ann)

        # 3. stage 1's output: the TSDF and mesh, scored against GT meshes
        res1 = os.path.join(root, "res1")
        log(f"[stage 1] test CLI on {scenes[0]} at the config's test grid "
            f"{tuple(cfg1.model.voxel_dim_test)}, views cut from "
            f"{cfg1.data.test.num_frames} to {STAGE1_TEST_VIEWS}")
        recs = test_cli.main([STAGE1_CONFIG, s1, "--max-scenes", "1",
                              "--save-path", res1, "--cfg-options",
                              f"data.test.data_root={data}",
                              f"data.test.ann_file={val}",
                              f"data.test.num_frames={STAGE1_TEST_VIEWS}"])
        files = sorted(os.listdir(os.path.join(res1, scenes[0])))
        if files != [scenes[0] + ".npz", scenes[0] + ".ply"]:
            raise AssertionError(f"an Atlas scene writes its TSDF and mesh "
                                 f"only: {files}")
        gt = os.path.join(root, "gt_meshes")
        _gt_meshes(dev, data, scenes[:1], gt)
        with contextlib.redirect_stdout(io.StringIO()):
            mean = evaluate_mesh.main(["--data_path", data, "--result_path",
                                       res1, "--gt_path", gt])
        metrics = os.path.join(res1, scenes[0], "metrics.json")
        log(f"[stage 1] {scenes[0]}: forward {recs[0]['forward_s']:.3f} s, "
            f"{recs[0]['faces']} faces; evaluate_mesh against the GT mesh: "
            + ", ".join(f"{k} {v:.4f}" for k, v in mean.items()))
        if not (os.path.isfile(metrics) and set(mean) ==
                set(evaluate_mesh.KEYS)
                and all(math.isfinite(v) for v in mean.values())):
            raise AssertionError("evaluate_mesh must write metrics.json with "
                                 "finite metrics")

        # 4. stage 2.1: the dump from the stage-1 checkpoint
        cfgm = Config.fromfile(MIDDLE_CONFIG)
        res21, mid = os.path.join(root, "res21"), os.path.join(root, "mid")
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        recs = test_cli.main([MIDDLE_CONFIG, s1, "--save-path", res21,
                              "--middle-save-path", mid, "--cfg-options",
                              f"data.test.data_root={data}",
                              f"data.test.ann_file={ann}"])
        launches = _counts(counters)
        dim = tuple(cfgm.model.voxel_dim_test)
        log(f"[stage 2.1] {len(recs)} scenes in "
            f"{time.perf_counter() - t0:.2f} s at {dim}, "
            f"{cfgm.data.test.num_frames} views; launches {launches}")
        if launches != {"volume_accum": 2, "volume_accum_bwd": 0,
                        "ray_march": 2}:
            raise AssertionError(f"each dumped scene must launch K1 and K2 "
                                 f"once: {launches}")
        counts = _dump_against_forward(cfgm, data, ann, s1, mid, dev)

        # 5. stage 2: synthetic dumps beside the scenes, then the 2.1 dumps
        syn = os.path.join(data, "middle_points")
        t0 = time.perf_counter()
        write_point_dumps(data, syn, n_points=600000)
        log(f"[stage 2] wrote synthetic dumps of 600000 points on each "
            f"room's GT surface in {time.perf_counter() - t0:.1f} s")
        runs = [("synthetic", syn, scenes)]
        kept = [sc for sc, n in zip(scenes, counts) if n > 0]
        if kept:
            nonempty = os.path.join(root, "mid_nonempty")
            os.makedirs(nonempty)
            for sc in kept:
                shutil.copy(os.path.join(mid, sc + "_vert.npy"), nonempty)
            runs.append(("stage 2.1", nonempty, kept))
        log(f"[stage 2] runs: " + "; ".join(
            f"{name} dumps of {used}" for name, _, used in runs)
            + ("" if kept else "; every stage-2.1 dump is empty, so none "
               "trains"))
        s2 = None
        for name, points_dir, used in runs:
            recs2, ckpt, launches, _ = _run_train_cli(
                [STAGE2_CONFIG, "--work-dir", os.path.join(
                    root, "s2_" + name.replace(" ", "_")), "--max-steps",
                 "3", "--cfg-options", f"data.train.data_root={data}",
                 f"data.train.ann_file={ann}",
                 f"data.train.points_dir={points_dir}",
                 "log_config.interval=1"], counters, 3,
                f"stage 2 on {name} dumps of {', '.join(used)}")
            if any(launches.values()):
                raise AssertionError(f"stage 2 launches no volume or march "
                                     f"kernel: {launches}")
            if s2 is None:
                s2, stage2_records = ckpt, recs2

        # 6. merge, then one stage-3 step from the merged file
        merged = os.path.join(root, "merged.pt")
        _merge(s1, s2, merged, "merge")
        _, _, launches, _ = _run_train_cli(
            [CLI_CONFIG, "--work-dir", os.path.join(root, "s3"),
             "--load-from", merged, "--max-steps", "1", "--cfg-options",
             f"data.train.data_root={data}", f"data.train.ann_file={ann}",
             "evaluation=None", "log_config.interval=1"], counters, 1,
            "stage 3")
        if launches != {"volume_accum": 1, "volume_accum_bwd": 1,
                        "ray_march": 1}:
            raise AssertionError(f"the stage-3 step must launch K1, K1b and "
                                 f"K2 once: {launches}")
        log(f"[stages] phase took {time.perf_counter() - t_phase:.1f} s")
        phase_ddp(dev, root, data, ann, syn)
        phase_batch(dev, root, data, ann, syn, merged,
                    {"stage 1": records, "stage 2": stage2_records})
        return calls
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- readers with workers, scene-sharded testing, data-parallel training -----

READER_WORKERS = (1, 4)     # the reader runs at each count, in turns
CLI_FILE_TOL = 1e-5         # the test CLI's TSDF and points against a run
CLI_BOX_TOL = 1e-4          # a raw box row's match, of the largest value
DDP_LOSS_TOL = 1e-5         # step-1 losses, relative (voxelize's atomics)
# The two-rank step against the one-process mean step: atomics in the
# forward and backward (F6) move the gradients, most where a leaf's is
# small.  Each limit is about 3x the largest of five sound runs on an H100
# (gradients 4.8e-5-8.1e-4, the worst leaf 2.2e-4-1.3e-3, statistics
# 2.3e-7-4.7e-6, parameters 1.8e-4-4.5e-4); the counts are exact.
DDP_GRAD_TOL = 2.5e-3       # all gradients, |g - g_ref| / |g_ref|
DDP_LEAF_TOL = 1e-2         # the worst leaf, of its own norm
DDP_STATS_TOL = 1.5e-5      # running statistics, of their largest magnitude
DDP_PARAM_SHARE = 1.5e-3    # params moved apart by more than lr / 100
DDP_COUNTS_TOL = 1e-6       # the group's [n_pos, denorm], relative
# stage 3's views a scene at world size 1 (40 in the config: the views
# were cut, widths and grid kept, to pay for the batch phase's time)
DDP_STAGE3_VIEWS = 20


def _sample_hash(batch) -> str:
    """A hash of a loader batch's arrays and names (not its timings)."""
    import hashlib
    h = hashlib.sha256()
    for key in sorted(batch):
        value = batch[key]
        if key in ("load_s", "wait_s"):
            continue
        if key == "tsdf_list":
            for k in sorted(value):
                h.update(k.encode() + np.ascontiguousarray(value[k]).tobytes())
        elif isinstance(value, np.ndarray):
            h.update(key.encode() + str(value.dtype).encode()
                     + np.ascontiguousarray(value).tobytes())
        else:
            h.update(f"{key}={value!r}".encode())
    return h.hexdigest()


def _reader_turns(tag: str, make) -> dict:
    """The reader alone (``SceneLoader`` over ``make()``, no consumer) at
    each of ``READER_WORKERS`` in turns: seconds a scene, each scene's
    ``load_s`` and ``wait_s``; the samples must hash alike at every
    count.  Returns the seconds a scene by worker count."""
    from cnrma_torch.data.loader import SceneLoader
    want, out = None, {}
    for workers in READER_WORKERS:
        loader = SceneLoader(make(), shuffle=False, num_workers=workers)
        t0 = time.perf_counter()
        got, loads, waits = [], [], []
        for batch in loader:
            got.append(_sample_hash(batch))
            loads.append(batch["load_s"])
            waits.append(batch["wait_s"])
        wall = time.perf_counter() - t0
        out[workers] = wall / len(got)
        log(f"[{tag}] {workers} worker(s): {len(got)} scenes in {wall:.2f} "
            f"s, {out[workers]:.3f} s a scene; load_s "
            + " ".join(f"{v:.3f}" for v in loads) + "; wait_s "
            + " ".join(f"{v:.3f}" for v in waits) + f" ({card()})")
        if want is None:
            want = got
        elif got != want:
            raise AssertionError(f"[{tag}] {workers} workers read other "
                                 f"samples than {READER_WORKERS[0]}")
    log(f"[{tag}] the samples hash alike at {READER_WORKERS} workers; "
        f"{out[READER_WORKERS[0]] / out[READER_WORKERS[-1]]:.2f}x the "
        f"scenes a second at {READER_WORKERS[-1]}")
    return out


def _matched(a: np.ndarray, b: np.ndarray, tol: float) -> np.ndarray:
    """Which of ``a``'s rows some row of ``b`` equals within ``tol`` (of
    the largest magnitude) in every column."""
    if not len(b):
        return np.zeros(len(a), bool)
    scale = max(1.0, float(np.abs(a).max()))
    return (np.abs(a[:, None, :] - b[None, :, :]).max(-1)
            <= tol * scale).any(1)


def _box_rows_against(boxes_a, scores_a, boxes_b, scores_b, what: str
                      ) -> int:
    """Two sets of raw box rows (boxes and scores together) matched as
    sets within ``CLI_BOX_TOL``, but for rows that pair off across the two
    with top scores within ``CLI_BOX_TOL``: near-equal scores can swap
    across a level's top-k cut (F6).  Raises past that; returns the rows
    that pair off so."""
    rows = [np.nan_to_num(np.concatenate([bx, sc], 1), posinf=1e30,
                          neginf=-1e30)
            for bx, sc in ((boxes_a, scores_a), (boxes_b, scores_b))]
    if rows[0].shape != rows[1].shape:
        raise AssertionError(f"{what}: {rows[1].shape} raw box rows against "
                             f"{rows[0].shape}")
    k = scores_a.shape[1]
    top = [np.sort(r[~_matched(r, o, CLI_BOX_TOL), -k:].max(1))
           for r, o in (rows, rows[::-1])]
    if len(top[0]) != len(top[1]) or not np.allclose(
            *top, rtol=0, atol=CLI_BOX_TOL):
        raise AssertionError(f"{what}: raw box rows differ, not as ties "
                             f"swapped at a cut: top scores {top}")
    return len(top[0])


def _files_against(ref: str, got: str, scenes) -> dict:
    """Two test CLI runs' files of ``scenes`` (``ref``/``got`` each holding
    ``res`` and ``mid``): the TSDFs and the kept points within
    ``CLI_FILE_TOL``; the raw boxes as row sets, since the detector's
    voxelisation averages duplicate points with ``index_add_``'s atomics,
    whose order moves its scores' last bits and so can swap two rows of
    near-equal score across a level's top-k cut (F6): as many rows, each
    matched within ``CLI_BOX_TOL`` (box and scores together), but for
    rows that pair off across the two files with top scores within
    ``CLI_BOX_TOL``.  Raises past these; returns the differences."""
    errs = {"tsdf": 0.0, "points": 0.0, "box_rows_unmatched": 0}

    def load(root, scene, f):
        with np.load(os.path.join(root, "res", scene, f.format(s=scene))) \
                as z:
            return {k: z[k] for k in z.files}
    for s in scenes:
        a, b = load(ref, s, "{s}.npz"), load(got, s, "{s}.npz")
        errs["tsdf"] = max(errs["tsdf"], float(np.abs(a["tsdf"]
                                                      - b["tsdf"]).max()))
        pa, pb = (np.load(os.path.join(r, "mid", s + "_vert.npy"))
                  for r in (ref, got))
        if pa.shape != pb.shape:
            raise AssertionError(f"{s}: {pb.shape} points against "
                                 f"{pa.shape}")
        if len(pa):
            errs["points"] = max(errs["points"], float(
                np.abs(pa - pb).max() / max(1.0, np.abs(pa).max())))
        a, b = load(ref, s, "{s}_bbox_raw.npz"), load(got, s,
                                                      "{s}_bbox_raw.npz")
        if a["bboxes"].shape != b["bboxes"].shape:
            raise AssertionError(f"{s}: {b['bboxes'].shape} raw boxes "
                                 f"against {a['bboxes'].shape}")
        errs["box_rows_unmatched"] = max(
            errs["box_rows_unmatched"],
            _box_rows_against(a["bboxes"], a["scores"], b["bboxes"],
                              b["scores"], s))
    if errs["tsdf"] > CLI_FILE_TOL or errs["points"] > CLI_FILE_TOL:
        raise AssertionError(f"the files differ: {errs}")
    return errs


def _cli_sharded(root: str, base, scenes) -> None:
    """The test CLI over ``scenes`` on two processes sharing the card
    (``--n-devices 2``, the config's 4 reader workers each), against the
    one-process run whose files are under ``root`` (``res``, ``mid``);
    its seconds a scene."""
    from cnrma_torch.tools import test as test_cli
    out = os.path.join(root, "n_devices_2")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = test_cli.main(base[:2] + [
        "--n-devices", "2", "--save-path",
        os.path.join(out, "res"), "--middle-save-path",
        os.path.join(out, "mid")] + base[2:])
    wall = time.perf_counter() - t0
    if sorted(os.listdir(os.path.join(out, "res"))) != scenes \
            or [r["index"] for r in recs] != list(range(len(scenes))):
        raise AssertionError("[cli sharded] --n-devices 2 wrote other "
                             "scenes")
    log(f"[cli sharded] --n-devices 2: {len(recs)} scenes in {wall:.2f} s "
        f"with the processes' start, {wall / len(recs):.3f} s a scene; per "
        f"scene (rank, load, waited, forward, write s): "
        + "; ".join(f"{r['rank']} {r['load_s']:.3f} {r['wait_s']:.3f} "
                    f"{r['forward_s']:.3f} {r['write_s']:.3f}"
                    for r in recs) + f" ({card()})")
    errs = _files_against(root, out, scenes)
    log(f"[cli sharded] --n-devices 2 against one process: {errs} "
        f"(TSDF and points tolerance {CLI_FILE_TOL}; box rows matched "
        f"within {CLI_BOX_TOL}, but for ties swapped at a cut)")


CHILD_THEN = "--then"        # separates the train CLI runs of one child


def _train_child(argv) -> int:
    """``chip_smoke.py --train-child ARGV [--then ARGV ...]``: ``python -m
    cnrma_torch.tools.train ARGV`` in this process (under ``torchrun``, a
    rank), each ARGV in turn, then for each writes ``{its work
    dir}/child_rank{RANK}.json``: the launches of K1, K1b and K2 it made, a
    hash of its trained model and the CLI's per-step records."""
    from cnrma_torch.tools import train as train_cli
    no_tf32()
    runs = [[]]
    for a in argv:
        if a == CHILD_THEN:
            runs.append([])
        else:
            runs[-1].append(a)
    rank = os.environ.get("RANK", "0")
    real = train_cli.run_training
    for run_argv in runs:
        states = []

        def keep(state, *args, **kw):
            states.append(state)
            return real(state, *args, **kw)
        train_cli.run_training = keep
        counters = _kernel_counters()
        for c in counters.values():
            c.launches = 0
        records, _ = train_cli.main(run_argv)
        with open(os.path.join(train_cli.parse_args(run_argv).work_dir,
                               f"child_rank{rank}.json"), "w") as f:
            json.dump({"launches": _counts(counters),
                       "digest": _digest(states[0].model),
                       "records": records}, f)
        del states
        gc.collect()
        torch.cuda.empty_cache()
    train_cli.run_training = real
    return 0


def _child_reports(work_dir: str) -> list:
    """The reports ``_train_child`` wrote in ``work_dir``, in rank order."""
    names = sorted((f for f in os.listdir(work_dir)
                    if f.startswith("child_rank")),
                   key=lambda f: int(f[len("child_rank"):-len(".json")]))
    out = []
    for name in names:
        with open(os.path.join(work_dir, name)) as f:
            out.append(json.load(f))
    return out


def _world_one(root: str, runs, counters) -> None:
    """For each of ``runs`` (``(tag, argv, want)``): the train CLI for 2
    steps in this process without a group; then all of them in turn in
    one child under ``torchrun`` at world size 1 on NCCL (one process
    start for all): step 1's losses within ``DDP_LOSS_TOL`` (bit for bit
    printed), step 2's difference printed (F6), each step's time alone and
    in the group; each run must launch its ``want``."""
    alone = {}
    for tag, argv, want in runs:
        recs, _, launches, _ = _run_train_cli(
            argv + ["--work-dir", os.path.join(root, tag + "_alone")],
            counters, 2, f"ddp {tag} alone")
        if launches != want:
            raise AssertionError(f"[ddp {tag}] launches {launches}, not "
                                 f"{want}")
        alone[tag] = recs
    gc.collect()
    torch.cuda.empty_cache()            # the child needs the card's memory
    child = []
    for tag, argv, _ in runs:
        if child:
            child.append(CHILD_THEN)
        child += argv + ["--work-dir", os.path.join(root, tag + "_group")]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", os.path.abspath(__file__),
         "--train-child"] + child, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[ddp] the torchrun child failed "
                             f"({proc.returncode}):\n{proc.stdout[-4000:]}"
                             f"\n{proc.stderr[-4000:]}")
    for tag, _, want in runs:
        _check_world_one(tag, alone[tag], _child_reports(
            os.path.join(root, tag + "_group"))[0], want, wall)


def _check_world_one(tag: str, recs, child: dict, want: dict,
                     wall: float) -> None:
    """A ``_world_one`` child's report against its in-process run."""
    launches, got = child["launches"], child["records"]
    log(f"[ddp {tag}] torchrun --nproc_per_node 1 (NCCL, world size 1): "
        f"{len(got)} steps, the child's wall {wall:.1f} s (every run); "
        f"launches {launches}")
    if launches != want or len(got) != 2:
        raise AssertionError(f"[ddp {tag}] the child must take 2 steps and "
                             f"launch {want}: {launches}")
    for a, b in zip(recs, got):
        rel = {k: abs(b["log_vars"][k] - v) / max(abs(v), 1e-30)
               for k, v in a["log_vars"].items()}
        log(f"[ddp {tag}] step {a['step']}: {a['step_s']:.3f} s alone, "
            f"{b['step_s']:.3f} s in the group (all-reduce "
            f"{b['stages_ms'].get('all_reduce', float('nan')):.1f} ms); "
            f"largest relative loss difference {max(rel.values()):.3g} "
            f"({card()})")
    losses = {k: v for k, v in recs[0]["log_vars"].items() if "loss" in k}
    same = {k: got[0]["log_vars"][k] for k in losses} == losses
    worst = max(abs(got[0]["log_vars"][k] - v) / max(abs(v), 1e-30)
                for k, v in losses.items())
    log(f"[ddp {tag}] step 1's losses in the group against alone: bit for "
        f"bit {same}, largest relative difference {worst:.3g} (tolerance "
        f"{DDP_LOSS_TOL}: the detector's voxelisation sums duplicate "
        f"points with index_add_'s atomics)")
    if worst > DDP_LOSS_TOL:
        raise AssertionError(f"[ddp {tag}] step 1's losses in the group "
                             f"differ from those alone")
    if not all(np.isfinite(v) for r in got for v in r["log_vars"].values()):
        raise AssertionError(f"[ddp {tag}] a log var is not finite")


def _world_n(root: str, tag: str, argv, n: int, want: dict,
             steps: int = 2) -> list:
    """The train CLI for ``steps`` steps as ``torchrun --nproc_per_node
    n`` on NCCL, one card a rank: every rank ends with the same parameters
    and statistics (a hash of each), each launches ``want``; rank 0's step
    and all-reduce times.  Returns rank 0's records."""
    wd = os.path.join(root, f"{tag}_world{n}")
    gc.collect()
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), os.path.abspath(__file__),
           "--train-child"] + argv + ["--work-dir", wd]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[ddp {tag}] torchrun of {n} failed "
                             f"({proc.returncode}):\n{proc.stdout[-4000:]}"
                             f"\n{proc.stderr[-4000:]}")
    reports = _child_reports(wd)
    digests = [r["digest"] for r in reports]
    launches = [r["launches"] for r in reports]
    recs = reports[0]["records"]
    log(f"[ddp {tag}] torchrun --nproc_per_node {n} (NCCL, a card a rank): "
        f"{len(recs)} steps in the child's wall {wall:.1f} s; launches "
        f"{launches}; ranks' hashes equal {len(set(digests)) == 1}"
        f" ({len(digests)} ranks); each rank's peak "
        + ", ".join(f"{max(x['peak_gib'] or 0 for x in r['records']):.2f}"
                    for r in reports) + " GiB")
    for r in recs:
        log(f"[ddp {tag}] world {n} step {r['step']}: {r['step_s']:.3f} s, "
            f"all-reduce {r['stages_ms'].get('all_reduce', float('nan')):.1f}"
            f" ms, waited {r['wait_s']:.3f} s, peak {r['peak_gib'] or 0:.2f} "
            f"GiB; total loss {r['log_vars']['total_loss']:.4f}; stages ms "
            + ", ".join(f"{k} {v:.1f}" for k, v in r["stages_ms"].items())
            + f" ({card()})")
    if len(digests) != n or len(set(digests)) != 1 \
            or len(recs) != steps or any(c != want for c in launches) \
            or len(launches) != n:
        raise AssertionError(f"[ddp {tag}] {n} ranks must take {steps} "
                             f"steps, launch {want} each and end equal")
    return recs


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _digest(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode() + v.detach().cpu().contiguous().numpy()
                 .tobytes())
    return h.hexdigest()


def _stage2_trainer(cfg, dev):
    """The train CLI's stage-2 model (seed 0) and optimizer on ``dev``."""
    from cnrma_torch.core.builder import build_model
    from cnrma_torch.train.optim import (
        FROZEN_PREFIXES_FREEZE_AT_2, build_lr_schedule, build_optimizer)
    torch.manual_seed(0)
    model = build_model(cfg, mode="train").to(dev)
    opt = build_optimizer(
        cfg.optimizer, model, build_lr_schedule(
            cfg.get("lr_config", {}), cfg.optimizer["lr"], 1),
        grad_clip=cfg.optimizer_config.grad_clip.max_norm,
        frozen_prefixes=FROZEN_PREFIXES_FREEZE_AT_2)
    return model, opt


def _ddp_rank(rank: int, port: int, out: str, opts,
              device_type: str = "cuda", cards: int = 1,
              view_opts=None) -> None:
    """Rank ``rank`` of two, under gloo on one card (``cards`` 1; NCCL
    refuses two ranks on one device) or NCCL on a card each: two data-parallel
    stage-2 steps, one scene a rank; rank 0 also takes the one-process
    step on the mean of both scenes' gradients and statistics and holds
    it against its own after step 1, and holds the detector's positive
    count and centerness sum that the group averaged against the mean of
    the scenes' own.  With ``view_opts`` (a stage-3 split), then the
    view-sharded step of one scene on the two ranks (``_view_step``).
    Writes ``{out}/rank{rank}.json``."""
    import types
    from cnrma_torch.core.builder import build_dataset
    from cnrma_torch.core.config import Config
    from cnrma_torch.data.loader import SceneLoader
    from cnrma_torch.models import fcaf3d
    from cnrma_torch.parallel import dist
    from cnrma_torch.train import loop
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE="2",
                      LOCAL_RANK=str(rank if cards > 1 else 0))
    no_tf32()
    group, dev = dist.init_from_env(
        device_type, backend="nccl" if cards > 1 else "gloo")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda d: None)
    cfg = Config.fromfile(STAGE2_CONFIG)
    cfg.merge_from_options(dict(kv.split("=", 1) for kv in opts))
    model, opt = _stage2_trainer(cfg, dev)
    bucket = sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for b in loop.running_stats(model))

    def loader(r):
        return SceneLoader(build_dataset(cfg, "train", seed=0), seed=0,
                           num_workers=4, rank=r, world_size=2)
    seen, real = [], fcaf3d.dist

    def recording(t, g):
        seen.append(real.all_mean(t, g).clone())
        return t
    fcaf3d.dist = types.SimpleNamespace(all_mean=recording)
    report = {"bucket": bucket, "digests": [], "step_s": []}
    mine, batches = loader(rank), []
    while len(batches) < 2:                 # two steps, epochs as they come
        batches += list(mine)[:2 - len(batches)]
    for step, batch in enumerate(batches):
        on_device = loop.device_batch(batch, dev)
        sync(dev)
        t0 = time.perf_counter()
        logs = loop.train_step(model, opt, on_device,
                               loop.step_generator(0, step, dev, rank),
                               group=group)
        sync(dev)
        report["step_s"].append(time.perf_counter() - t0)
        report.setdefault("log_vars", []).append(
            {k: float(v) for k, v in logs.items()})
        report["digests"].append(_digest(model))
        if rank == 0 and step == 0:
            other = next(iter(loader(1)))
            report["reference"] = _mean_reference(
                cfg, dev, model, [on_device, loop.device_batch(other, dev)],
                seen[-1].cpu())
    fcaf3d.dist = real
    if view_opts is not None:
        del model, opt, on_device, batches
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        report["view"] = _view_step(rank, group, dev, view_opts, out)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.shutdown(group)


def _mean_reference(cfg, dev, model, batches, group_mean) -> dict:
    """One step of a fresh stage-2 model (the ranks' start) on the mean
    of ``batches``' gradients and running statistics.  Each scene's
    detector loss is normalised by the mean of the two scenes' own
    positive counts and centerness sums, taken from a forward of each
    without a gradient, not from the group; ``group_mean`` (what the
    group's collective gave) is held against that mean.  Returns the
    largest differences from ``model`` after the ranks' step 1."""
    import types
    from cnrma_torch.models import fcaf3d
    from cnrma_torch.train import loop
    ref, ref_opt = _stage2_trainer(cfg, dev)
    params = dict(ref.named_parameters())
    start = [b.clone() for b in loop.running_stats(ref)]
    ours, own = fcaf3d.dist, []

    def forward(r, batch):
        for b, s in zip(loop.running_stats(ref), start):
            b.copy_(s)
        ref.train()
        return ref.forward_train(
            batch, generator=loop.step_generator(0, 0, dev, r),
            group="reference")
    try:
        fcaf3d.dist = types.SimpleNamespace(
            all_mean=lambda t, g: own.append(t.clone()) or t)
        with torch.no_grad():
            for r, batch in enumerate(batches):
                forward(r, batch)
        mean = (own[0] + own[1]) / 2
        fcaf3d.dist = types.SimpleNamespace(
            all_mean=lambda t, g: mean.clone())
        grads, stats = [], []
        for r, batch in enumerate(batches):
            losses = forward(r, batch)
            ref.zero_grad(set_to_none=True)
            loop.total_loss(losses).backward()
            grads.append({n: p.grad if p.grad is not None
                          else torch.zeros_like(p) for n, p in
                          params.items()})
            stats.append([b.clone() for b in loop.running_stats(ref)])
    finally:
        fcaf3d.dist = ours
    counts = mean.cpu()
    counts_err = float(((group_mean - counts).abs()
                        / counts.abs().clamp_min(1e-30)).max())
    mean_grads = {n: (grads[0][n] + grads[1][n]) / 2 for n in params}
    with torch.no_grad():
        for b, s0, s1 in zip(loop.running_stats(ref), *stats):
            b.copy_((s0 + s1) / 2)
    lr = ref_opt.lr()
    ref_opt.step(mean_grads)
    mine = dict(model.named_parameters())
    leaf_err = {n: float((mine[n].grad - g).norm() / g.norm())
                for n, g in mean_grads.items() if float(g.norm()) > 0}
    worst = max(leaf_err, key=leaf_err.get)
    total = float(torch.sqrt(sum(((mine[n].grad - g) ** 2).sum()
                                 for n, g in mean_grads.items()))
                  / torch.sqrt(sum((g ** 2).sum()
                                   for g in mean_grads.values())))
    stats_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for a, b in zip(loop.running_stats(model),
                                loop.running_stats(ref)))
    n = sum(p.numel() for p in params.values())
    off = sum(int(((mine[k].detach() - p.detach()).abs() > lr / 100).sum())
              for k, p in params.items())
    moved = max(float((mine[k].detach() - p.detach()).abs().max())
                for k, p in params.items())
    return {"grads": total, "grads_leaf": leaf_err[worst],
            "grads_leaf_name": worst, "stats": stats_err,
            "param_share": off / n, "param_max_over_lr": moved / lr,
            "counts": counts.tolist(), "group_counts": group_mean.tolist(),
            "counts_err": counts_err}


# --- one scene split across ranks (the view-sharded step) ------------------

# The view-sharded stage-3 step on the card against the one-process step on
# the same scene, parameters and draws, each from the same start.  The full
# step: its TSDF losses (relative) and the U-Net's and TSDF head's
# gradients (each group as one vector, relative L2), which the detector
# does not reach (its gradient enters the 2D tower through the points, not
# the U-Net or the head).  The untrained detector's losses, the tower's
# gradients and the detector's input are logged, not held: on the card the
# per-view slots of kept samples reorder under ulp-level changes and the
# subsample follows the slots, so a one-process step on images one ulp off
# takes 163,032 other points of 500,000 and moves the tower's groups by
# 1.25 (PERF.md, PR 15).  The recon-only step (the detection losses
# weighted 0, so no gradient reaches the tower through the points) holds
# the tower's groups as well, at their own limit: the tower's gradient
# from the TSDF losses alone comes back through the U-Net's and the
# tower's train-mode norms, and one ulp of the images moves it by about
# as much as the split does (the ``ulp`` reading, logged).  The same
# recon-only step with the boundary planted to sum the n copies
# (``_sum_copies``) must break a limit.
VIEW_TSDF_TOL = 1e-5        # the TSDF losses, relative (measured 3.8e-7)
VIEW_GROUP_TOL = 3e-3       # the U-Net and head (measured 5.8e-4, 1.7e-6)
VIEW_TOWER_TOL = 0.05       # the tower's groups, recon-only (1.5e-2)
VIEW_HELD = ("backbone3d.", "tsdf_head.")
VIEW_GROUPS = TOWER_GROUPS + VIEW_HELD + ("detector.",)
# what the children of the ddp phase's two ranks report of their view step
VIEW_REPORT = {}


def _grads_cpu(model) -> dict:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().float().cpu() for n, p in model.named_parameters()}


def _view_readings(got: dict, want: dict) -> dict:
    """A step's losses, gradient groups and leaves, and the detector's
    input, ``got`` against the one-process ``want``: each loss's relative
    difference, the largest of the TSDF losses', each group's relative L2
    error, the worst leaf cosine with its name, and ``_cloud_diff``; in
    float64 on the card where there is one (on the host's CPU four
    readings of the stage-3 model's gradients took tens of seconds)."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    mine, ref = ({k: v.to(dev, torch.float64).ravel() for k, v in
                  g["grads"].items()} for g in (got, want))

    def cos(a, b):
        na, nb = float(a.norm()), float(b.norm())
        return float(na == nb) if na == 0 or nb == 0 else \
            float(a @ b) / (na * nb)
    losses = {k: abs(got["losses"][k] - w) / max(abs(w), 1e-30)
              for k, w in want["losses"].items()}
    groups = {}
    for prefix in VIEW_GROUPS:
        keys = [k for k in ref if k.startswith(prefix)]
        a = torch.cat([mine[k] for k in keys])
        b = torch.cat([ref[k] for k in keys])
        groups[prefix] = float((a - b).norm() / b.norm().clamp_min(1e-30))
    return {"losses": losses,
            "tsdf": max(v for k, v in losses.items()
                        if k.startswith("tsdf_loss")),
            "groups": groups,
            "leaf_cos": min((cos(mine[k], w), k) for k, w in ref.items()),
            "points": _cloud_diff(*([t.to(dev) for t in g["points"]]
                                    for g in (got, want)))}


def _view_failures(r: dict, groups) -> list:
    """What of the readings ``r`` breaks its limit: the TSDF losses and
    each of ``groups``."""
    out = ["tsdf losses"] if r["tsdf"] > VIEW_TSDF_TOL else []
    return out + [p for p in groups if r["groups"][p] > (
        VIEW_TOWER_TOL if p in TOWER_GROUPS else VIEW_GROUP_TOL)]


def _cloud_diff(got, want) -> dict:
    """Two detector inputs (xyz [P, 3], features [P, C], valid [P]) as
    sets of points (their slots differ where a kept point comes or goes,
    F6): the valid counts, the points in one and not the other (positions
    on a 0.1 mm lattice), and the largest feature difference of the
    points in both, of the features' largest magnitude."""
    def keyed(x, f, v):
        k = torch.round(x[v].double() * 1e4).long() + (1 << 20)
        k = (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]
        order = torch.argsort(k)
        return k[order], f[v][order]
    (gk, gf), (wk, wf) = keyed(*got), keyed(*want)
    common = torch.isin(gk, wk)
    at = torch.searchsorted(wk, gk[common])
    err = ((gf[common] - wf[at]).abs().max() / wf.abs().max().clamp_min(
        1e-30)) if bool(common.any()) else torch.zeros(())
    return {"valid": [len(gk), len(wk)],
            "differ": int((~common).sum()) + int((~torch.isin(wk, gk)).sum()),
            "feats": float(err)}


def _view_batch(opts, dev):
    """The stage-3 config of ``opts`` and the first scene of its training
    split (seed 0), on ``dev``: what the view step and its one-process
    reference take."""
    from cnrma_torch.core.builder import build_dataset
    from cnrma_torch.core.config import Config
    from cnrma_torch.data.loader import SceneLoader
    from cnrma_torch.train import loop
    cfg = Config.fromfile(CLI_CONFIG)
    cfg.merge_from_options(dict(kv.split("=", 1) for kv in opts))
    return cfg, loop.device_batch(next(iter(SceneLoader(
        build_dataset(cfg, "train", seed=0), seed=0, num_workers=4))), dev)


def _view_once(dev, m, o, data, start, recon_only=False, **kw) -> dict:
    """One training step of model ``m`` (optimizer ``o``) on ``data`` from
    the state ``start`` with row 0's step-1 draws; ``recon_only`` weights
    the detection losses 0.  Its seconds, peak GiB, stage times, losses,
    gradients (on the host) and the detector's input."""
    from cnrma_torch.timing import stage_marks
    from cnrma_torch.train import loop
    cuda = dev.type == "cuda"
    m.load_state_dict(start)
    weight, seen = m.loss_weight_detection, []
    m.loss_weight_detection = 0.0 if recon_only else weight
    hook = m.detector.register_forward_pre_hook(
        lambda mod, inputs: seen.append(
            [t[0].detach().cpu() for t in inputs[:3]]))
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        with stage_marks(dev) as marks:
            logs = loop.train_step(m, o, data, loop.step_generator(
                0, 0, dev, 0), **kw)
        if cuda:
            torch.cuda.synchronize(dev)
    finally:
        hook.remove()
        m.loss_weight_detection = weight
    return {"s": time.perf_counter() - t0, "stages_ms": marks.ms(),
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if cuda else 0.0),
            "losses": {name: float(v) for name, v in logs.items()
                       if "loss" in name},
            "grads": _grads_cpu(m), "points": seen[0]}


def _view_pair(dev, m, o, data, **kw) -> dict:
    """The full step and the recon-only step (``_view_once``) of ``m``,
    each from ``m``'s state now."""
    start = {k: v.detach().clone() for k, v in m.state_dict().items()}
    return {"full": _view_once(dev, m, o, data, start, **kw),
            "recon": _view_once(dev, m, o, data, start, True, **kw),
            "start": start}


def _view_reference(dev, opts) -> dict:
    """In this process (its cuDNN warm from the phase's stage-3 runs): the
    full and the recon-only one-process step of a fresh stage-3 model
    (seed 0) on the view step's scene, each from that start, and the
    recon-only step on the images moved by one ulp (``ulp``)."""
    cfg, batch = _view_batch(opts, dev)
    model, opt = _stage2_trainer(cfg, dev)
    ref = _view_pair(dev, model, opt, batch)
    nudged = dict(batch, imgs=torch.nextafter(
        batch["imgs"], torch.full_like(batch["imgs"], 1e9)))
    ref["ulp"] = _view_once(dev, model, opt, nudged, ref.pop("start"), True)
    del model, opt, batch, nudged
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ref


def _sum_copies():
    """The planted fault of the view step: the replicated boundary's
    backward sums the n ranks' copies of the cotangent (all-reduce) before
    it keeps the rank's slice.  Returns the undo."""
    from cnrma_torch.parallel import shard
    real = shard.gather_replicated

    class SumCopies(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dim, group):
            ctx.meta = (dim, torch.distributed.get_rank(group), x.shape[dim],
                        group)
            return shard.gather_cat(x, dim, group)

        @staticmethod
        def backward(ctx, g):
            dim, r, size, group = ctx.meta
            g = shard.all_reduce_sum(g.contiguous().clone(), group)
            return g.narrow(dim, r * size, size), None, None
    shard.gather_replicated = lambda x, dim, group: SumCopies.apply(
        x, dim, group)
    return lambda: setattr(shard, "gather_replicated", real)


def _view_step(rank: int, group, dev, opts, out: str) -> dict:
    """Rank ``rank`` of a view group of two (gloo sharing one card, or
    NCCL on two), on the first scene of the stage-3 split ``opts`` gives
    (``DDP_STAGE3_VIEWS`` views, 192x192x80, the config's widths): K1's sum
    mode on the rank's block of the views (random fp32 features) against
    its plain version at tolerance 0; the full and the recon-only
    view-sharded step of a fresh model from one start (``train_step`` with
    ``shards``), K1, K1's sum mode, K1b and K2 counted from 0 over them;
    then the recon-only step with ``_sum_copies`` planted.  Rank 0 writes
    the three steps' losses, gradients and detector inputs to
    ``{out}/view_steps.pt`` for ``_check_view_ranks``.  Returns the
    report."""
    from cnrma_torch.ops import backproject as bp
    from cnrma_torch.parallel import dist
    cfg, batch = _view_batch(opts, dev)
    shards = dist.view_shards(group, 2)
    model, opt = _stage2_trainer(cfg, dev)
    V, H, W = batch["imgs"].shape[1:4]
    vs, stride = V // 2, model.backbone2d_stride
    mine = slice(rank * vs, (rank + 1) * vs)
    feats = torch.randn(vs, H // stride, W // stride, 32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            rank))
    args = (model._scaled_projections(batch["projection"][0, mine]), feats,
            batch["view_valid"][0, mine], model.voxel_dim, model.voxel_size,
            model.origin)
    total, cnt, _ = bp.volume_accum(*args, write_sum=True)
    ptotal, pcnt, _ = bp.volume_accum_plain(*args, write_sum=True)
    report = {"views": V, "sum_equal": bool(torch.equal(total, ptotal)
                                            and torch.equal(cnt, pcnt))}
    del args, feats, total, cnt, ptotal, pcnt
    counters = _kernel_counters()
    for c in counters.values():
        c.launches = 0
    steps = _view_pair(dev, model, opt, batch, group=group, shards=shards)
    report["launches"] = _counts(counters)
    report["digest"] = _digest(model)
    undo = _sum_copies()
    try:
        steps["fault"] = _view_once(dev, model, opt, batch, steps.pop(
            "start"), True, group=group, shards=shards)
    finally:
        undo()
    report.update({k: {"s": v["s"], "peak_gib": v["peak_gib"],
                       "stages_ms": v["stages_ms"], "losses": v["losses"]}
                   for k, v in steps.items()})
    if rank == 0:
        torch.save(steps, os.path.join(out, "view_steps.pt"))
    return report


def _check_view_ranks(ranks: list, how: str, reference: dict,
                      got: dict) -> None:
    """The two ranks' view steps (``_view_step``): K1's sum mode equal to
    its plain version, the steps' launches, the ranks' models equal after
    them, the full and the recon-only step (``got``) against the
    one-process ones of ``_view_reference`` within the VIEW limits, and the
    planted fault beyond them; logs seconds, peaks and stage times beside
    the one-process steps'."""
    views = [r["view"] for r in ranks]
    v0 = views[0]

    def peak(r):
        return max(r["full"]["peak_gib"], r["recon"]["peak_gib"])
    log(f"[view] K1's sum mode on each rank's {v0['views'] // 2} views "
        f"(fp32 features, 192x192x80) against its plain version: equal bit "
        f"for bit {[v['sum_equal'] for v in views]} (tol 0)")
    log(f"[view] stage 3, {v0['views']} views of one scene on two ranks "
        f"({how}): the full step (the first) {v0['full']['s']:.3f} s, the "
        f"recon-only step {v0['recon']['s']:.3f} s (rank 0), peak "
        + ", ".join(f"{peak(v):.2f}" for v in views)
        + f" GiB (each rank's own); the one-process steps on the same scene "
        f"{reference['full']['s']:.3f} and {reference['recon']['s']:.3f} s, "
        f"peak {peak(reference):.2f} GiB ({card()})")
    log(f"[view] launches in the two view-sharded steps, each rank: "
        f"{[v['launches'] for v in views]}; ranks equal after them "
        f"{views[0]['digest'] == views[1]['digest']}")
    readings = {k: _view_readings(got[k], reference[
        "full" if k == "full" else "recon"])
        for k in ("full", "recon", "fault")}
    readings["ulp"] = _view_readings(reference["ulp"], reference["recon"])
    held = {"full": VIEW_HELD, "recon": TOWER_GROUPS + VIEW_HELD,
            "fault": TOWER_GROUPS + VIEW_HELD, "ulp": ()}
    fails = {k: _view_failures(r, held[k]) for k, r in readings.items()}
    for k, what in (("full", "the full view-sharded step"),
                    ("recon", "the recon-only view-sharded step"),
                    ("fault", "the recon-only step, boundary summing the "
                              "copies (planted)"),
                    ("ulp", "the recon-only one-process step on images one "
                            "ulp off")):
        x = readings[k]
        log(f"[view] {what} against the one-process step: TSDF losses "
            f"{x['tsdf']:.3g} relative, groups (relative L2) "
            + ", ".join(f"{p} {e:.3g}" for p, e in x["groups"].items())
            + f"; held: {', '.join(held[k])}; breaks {fails[k] or 'none'}; "
            f"other losses "
            + ", ".join(f"{n} {e:.3g}" for n, e in x["losses"].items()
                        if not n.startswith("tsdf_loss"))
            + f"; worst leaf cosine {x['leaf_cos'][0]:.6f} "
            f"({x['leaf_cos'][1]}); the detector's input {x['points']}")
    log(f"[view] limits: TSDF losses {VIEW_TSDF_TOL}, the U-Net and head "
        f"{VIEW_GROUP_TOL}, the tower {VIEW_TOWER_TOL}; losses "
        f"{v0['full']['losses']} against {reference['full']['losses']}")
    log("[view] stage ms of the recon-only step, view-sharded (rank 0): "
        + ", ".join(f"{k} {v:.1f}" for k, v in v0["recon"]["stages_ms"]
                    .items())
        + "; one-process: " + ", ".join(
            f"{k} {v:.1f}" for k, v in reference["recon"]["stages_ms"]
            .items()))
    want = {"volume_accum": 0, "volume_accum_sum": 2,
            "volume_accum_bwd": 2, "ray_march": 2}
    if not all(v["sum_equal"] for v in views):
        raise AssertionError("[view] K1's sum mode differs from its plain "
                             "version")
    if any(v["launches"] != want for v in views):
        raise AssertionError(f"[view] each rank must launch {want}")
    if views[0]["digest"] != views[1]["digest"]:
        raise AssertionError("[view] the ranks' models differ")
    if fails["full"] or fails["recon"]:
        raise AssertionError(f"[view] the view-sharded step is not the "
                             f"one-process step: {fails}")
    if not fails["fault"]:
        raise AssertionError("[view] the planted boundary fault passes the "
                             "view step's limits")
    VIEW_REPORT.update(launches=v0["launches"])


def _view_cards(root: str, data: str, ann: str, cards: int,
                counters: dict) -> None:
    """One scene across cards (NCCL, a card a rank): the train CLI with
    ``--view-shards 2`` at the config's 40 views for 2 steps against the
    same CLI on one card in this process (``_view_against_one``); the same
    with depth marching and on ARKit's config (``_view_variants``); with
    four cards ``--view-shards 2`` at world 4 and two scenes a step (2 data
    rows x 2 view ranks, 40 views a scene, which one card cannot hold);
    stage 1 alike (``_view_stage1``); the test CLI's ``--view-shard`` over
    the cards against the one-card CLI on the same two scenes at the test
    width (forward seconds a scene, TSDFs within ``VIEW_CLI_TOL``); the
    train CLI's val evaluation under ``--view-shards 2`` against one
    card's (``_view_val``)."""
    s3 = ["--max-steps", "2", "--cfg-options", f"data.train.data_root={data}",
          f"data.train.ann_file={ann}", "evaluation=None",
          "log_config.interval=1"]
    want = {"volume_accum": 0, "volume_accum_sum": 2, "volume_accum_bwd": 2,
            "ray_march": 2}
    _view_against_one(root, "view 40", CLI_CONFIG, s3, counters, want)
    _view_variants(root, s3, counters)
    if cards >= 4:
        _world_n(root, "view 2x2", [CLI_CONFIG, "--view-shards", "2",
                                    "--batch-size", "2"] + s3, 4, want)
    _view_stage1(root, s3[3:], counters)
    _view_test_cli(root, data, ann, cards)
    _view_val(root, s3[3:5], ann, counters)


def _view_against_one(root: str, tag: str, config: str, argv, counters,
                      want: dict, tol: float = VIEW_TSDF_TOL) -> None:
    """The train CLI on ``config`` with ``argv`` (2 steps) on one card in
    this process, then with ``--view-shards 2`` on two NCCL cards
    (``_world_n``: each rank launches ``want``, the ranks end equal): step
    1's TSDF losses within ``tol`` of one card's, relative; each run's
    step seconds and peak memory."""
    one, _, _, _ = _run_train_cli(
        [config, "--work-dir", os.path.join(root, tag.replace(" ", "_")
                                            + "_one")] + argv,
        counters, 2, tag + " one card")
    got = _world_n(root, tag.replace(" ", "_"),
                   [config, "--view-shards", "2"] + argv, 2, want)
    tsdf = {k: (abs(got[0]["log_vars"][k] - v) / max(abs(v), 1e-30))
            for k, v in one[0]["log_vars"].items()
            if k.startswith("tsdf_loss")}
    log(f"[view] {tag}: step 1's TSDF losses on two cards against one "
        f"card, relative: {tsdf} (tol {tol}); step 2 on two cards "
        f"{got[-1]['step_s']:.3f} s, peak {got[-1]['peak_gib'] or 0:.2f} "
        f"GiB (rank 0), on one {one[-1]['step_s']:.3f} s, peak "
        f"{one[-1]['peak_gib'] or 0:.2f} GiB ({card()})")
    if not tsdf or max(tsdf.values()) > tol:
        raise AssertionError(f"[view] {tag}: the step on two cards is not "
                             f"the one-card step")


def _view_variants(root: str, s3, counters) -> None:
    """``_view_against_one`` for the stage-3 step with depth marching (the
    ScanNet scenes of ``s3``, 40 views; K2 never) and for ARKit's 7-DoF
    config (``configs/ray_marching_arkit.py``, 40 views of 480x640, on two
    synthetic ARKit scenes of 60 frames written under ``root``)."""
    from cnrma_torch.synthetic import write_arkit
    _view_against_one(root, "view depth", CLI_CONFIG,
                      s3 + ["model.ray_marching_type=depth"], counters,
                      {"volume_accum": 0, "volume_accum_sum": 2,
                       "volume_accum_bwd": 2, "ray_march": 0})
    data = os.path.join(root, "arkit")
    val = write_arkit(data, n_scenes=2, n_frames=60)
    train = os.path.join(data, "arkit_infos_train.pkl")
    shutil.copy(val, train)
    _view_against_one(root, "view arkit", ARKIT_CONFIG,
                      s3[:3] + [f"data.train.data_root={data}",
                                f"data.train.ann_file={train}"] + s3[5:],
                      counters, {"volume_accum": 0, "volume_accum_sum": 2,
                                 "volume_accum_bwd": 2, "ray_march": 2})


# stage 1's TSDF losses on two cards against one card in its own bf16: the
# tower's and U-Net's bf16 roundings follow the synced statistics' sum
# order, so the losses move by bf16's half ulp, 2^-9, not by fp32's
VIEW_BF16_TOL = 2.0 ** -9


def _view_stage1(root: str, opts, counters) -> None:
    """Stage 1 (``configs/atlas_recon_scannet.py``: 50 views, 160x160x64)
    with ``--view-shards 2`` on two NCCL cards for 2 steps against the same
    CLI on one card in this process (``_view_against_one``), in fp32 (step
    1's TSDF losses within ``VIEW_TSDF_TOL``) and in the config's bf16
    (within ``VIEW_BF16_TOL``); K1's sum mode and K1b once a step a rank,
    K2 never."""
    for dtype, tol in (("float32", VIEW_TSDF_TOL), ("bfloat16",
                                                     VIEW_BF16_TOL)):
        _view_against_one(
            root, f"view stage 1 {dtype}", STAGE1_CONFIG,
            ["--max-steps", "2", "--cfg-options", *opts,
             f"model.compute_dtype={dtype}"], counters,
            {"volume_accum": 0, "volume_accum_sum": 2,
             "volume_accum_bwd": 2, "ray_march": 0}, tol)


VIEW_CLI_TOL = 1e-4         # the --view-shard test CLI's TSDF, absolute
# the val evaluation's step: the config's AdamW at rate 0, so that both runs
# score the same parameters (one step of AdamW moves a parameter by about
# lr times its gradient's sign, which the two runs' ulp-apart gradients
# can flip; ROADMAP F6) and the val losses read the evaluation alone
VIEW_VAL_OPTS = ("optimizer.lr=0.0", "log_config.interval=1")


def _view_test_cli(root: str, data: str, ann: str, cards: int) -> None:
    """The test CLI on two scenes at the config's test width in this
    process (one card), then under ``torchrun --nproc_per_node cards``
    with ``--view-shard``: forward seconds a scene of each, the TSDFs."""
    from cnrma_torch.core.builder import build_model
    from cnrma_torch.core.config import Config
    from cnrma_torch.tools import test as test_cli
    cfg = Config.fromfile(CLI_CONFIG)
    torch.manual_seed(0)
    ckpt = os.path.join(root, "view_init.pt")
    torch.save(build_model(cfg).state_dict(), ckpt)
    opts = ["--max-scenes", "2", "--cfg-options",
            f"data.test.data_root={data}", f"data.test.ann_file={ann}"]
    one = os.path.join(root, "view_one")
    records = test_cli.main([CLI_CONFIG, ckpt, "--save-path", one] + opts)
    gc.collect()
    torch.cuda.empty_cache()
    many = os.path.join(root, "view_many")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(cards), "-m", "cnrma_torch.tools.test",
           CLI_CONFIG, ckpt, "--view-shard", "--save-path", many] + opts
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"[view] the --view-shard test CLI failed "
                             f"({proc.returncode}):\n{proc.stdout[-4000:]}"
                             f"\n{proc.stderr[-4000:]}")
    shared = [float(m) for m in re.findall(r"forward ([0-9.]+) s",
                                           proc.stdout)]
    err = 0.0
    for rec in records:
        scene = rec["scene"]
        with np.load(os.path.join(one, scene, scene + ".npz")) as a, \
                np.load(os.path.join(many, scene, scene + ".npz")) as b:
            err = max(err, float(np.abs(a["tsdf"] - b["tsdf"]).max()))
    log(f"[view] test CLI, 50 views at the test width: forward seconds a "
        f"scene on one card {[round(r['forward_s'], 3) for r in records]}, "
        f"with --view-shard over {cards} cards {shared}; TSDFs "
        f"{err:.3g} apart (tol {VIEW_CLI_TOL}) ({card()})")
    if len(shared) != len(records) or err > VIEW_CLI_TOL:
        raise AssertionError("[view] the --view-shard test CLI's scenes "
                             "differ from one card's")


def _view_val(root: str, train_opts, ann: str, counters) -> None:
    """The train CLI for one step (``VIEW_VAL_OPTS``) and the config's
    val evaluation at its stop, at the config's test grid on the two
    scenes of ``ann``: on one card in this process, then with
    ``--view-shards 2`` on two NCCL cards (each val scene through the
    test forward's view sharding, ``tools/train.py:val_evaluator``).
    The val TSDF losses within ``VIEW_TSDF_TOL`` of one card's,
    relative; the detector's val losses and mAP are logged, not held
    (the untrained detector reorders its kept points under ulp-level
    changes, ROADMAP F6)."""
    data = os.path.dirname(ann)
    argv = ["--max-steps", "1", "--cfg-options", *train_opts,
            f"data.val.data_root={data}", f"data.val.ann_file={ann}",
            *VIEW_VAL_OPTS]
    one, _, launches, _ = _run_train_cli(
        [CLI_CONFIG, "--work-dir", os.path.join(root, "view_val_one")]
        + argv, counters, 1, "view val one card")
    if launches != {"volume_accum": 3, "volume_accum_sum": 0,
                    "volume_accum_bwd": 1, "ray_march": 3}:
        raise AssertionError(f"[view val] one card: the step and two val "
                             f"scenes must launch K1 3, K1b 1, K2 3: "
                             f"{launches}")
    got = _world_n(root, "view_val", [CLI_CONFIG, "--view-shards", "2"]
                   + argv, 2, {"volume_accum": 0, "volume_accum_sum": 3,
                               "volume_accum_bwd": 1, "ray_march": 3},
                   steps=1)
    want, val = one[-1].get("val") or {}, got[-1].get("val") or {}
    tsdf = {k: abs(val[k] - v) / max(abs(v), 1e-30)
            for k, v in want.items() if k.startswith("val/tsdf_loss")}
    log(f"[view val] the val evaluation at the test grid, 2 scenes of 50 "
        f"views: on one card {one[-1].get('eval_s', 0):.2f} s, with "
        f"--view-shards 2 on two cards {got[-1].get('eval_s', 0):.2f} s; "
        f"TSDF losses against one card, relative: {tsdf} (tol "
        f"{VIEW_TSDF_TOL}); not held: the detector's val losses and mAP "
        f"on one card {dict((k, v) for k, v in want.items() if k not in tsdf)}"
        f", on two {dict((k, v) for k, v in val.items() if k not in tsdf)} "
        f"({card()})")
    if len(tsdf) != 3 or max(tsdf.values()) > VIEW_TSDF_TOL:
        raise AssertionError("[view val] the val TSDF losses on two cards "
                             "are not one card's")


def phase_view_cards() -> None:
    """``_view_cards`` alone on a machine with several cards, on two
    synthetic scenes of 60 frames written under ``build/``: ``python3 -c
    "import chip_smoke as c; c.phase_view_cards()"``."""
    from cnrma_torch.synthetic import write_scannet
    phase_device()
    phase_build()
    cards = torch.cuda.device_count()
    if cards < 2:
        raise SystemExit("phase_view_cards needs two or more cards")
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="view_", dir="build")
    try:
        data = os.path.join(root, "data")
        ann = write_scannet(data, n_scenes=2, n_frames=60,
                            ann_name="scannet_infos_train.pkl")
        _view_cards(root, data, ann, cards, _kernel_counters())
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_two_ranks() -> None:
    """The ``ddp`` phase's two ranks alone (``_two_ranks``: stage 2, then
    the view step), on two synthetic scenes of 60 frames and their point
    dumps written under ``build/``: ``python3 -c "import chip_smoke as c;
    c.phase_two_ranks()"``."""
    from cnrma_torch.synthetic import write_point_dumps, write_scannet
    phase_device()
    phase_build()
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="ranks_", dir="build")
    try:
        data = os.path.join(root, "data")
        ann = write_scannet(data, n_scenes=2, n_frames=60,
                            ann_name="scannet_infos_train.pkl")
        syn = os.path.join(data, "middle_points")
        write_point_dumps(data, syn, n_points=600000)
        _two_ranks(root, [f"data.train.data_root={data}",
                          f"data.train.ann_file={ann}",
                          f"data.train.points_dir={syn}", "evaluation=None",
                          "log_config.interval=1"], view_opts=[
            f"data.train.data_root={data}", f"data.train.ann_file={ann}",
            f"data.train.num_frames={DDP_STAGE3_VIEWS}"])
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _two_ranks(root: str, opts, device_type: str = "cuda",
               view_opts=None) -> None:
    """Stage 2 at full width on two ranks (``_ddp_rank``): gloo sharing
    the one card, or NCCL across two where the machine has two or more;
    after each step the ranks' parameters and
    statistics are equal bit for bit, and after step 1 they are the
    one-process mean step's within ``DDP_GRAD_TOL``, ``DDP_STATS_TOL``
    and ``DDP_PARAM_SHARE``, the group's positive count and centerness
    sum the scenes' own mean's within ``DDP_COUNTS_TOL``.  With
    ``view_opts``, then one scene of that stage-3 split on the two ranks
    (``_view_step``, ``_check_view_ranks``)."""
    cards = min(2, torch.cuda.device_count()) if device_type == "cuda" \
        else 1
    how = ("NCCL, a card each" if cards > 1 else "gloo, sharing one card"
           if device_type == "cuda" else "gloo on the CPU")
    out = os.path.join(root, "two_ranks")
    os.makedirs(out)
    reference = (_view_reference(torch.device(device_type, 0), view_opts)
                 if view_opts is not None else None)
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _ddp_rank, args=(_free_port(), out, opts, device_type, cards,
                         view_opts),
        nprocs=2, join=False,
        start_method="spawn")
    deadline = time.monotonic() + 600
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise AssertionError("[ddp two ranks] still running after "
                                     "600 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    ref = ranks[0]["reference"]
    log(f"[ddp two ranks] stage 2, 500,000 points a scene, {how} "
        f"({time.perf_counter() - t0:.1f} s with the "
        f"processes' start): bucket {ranks[0]['bucket']} fp32 values "
        f"({ranks[0]['bucket'] * 4 / 1e9:.3f} GB); step seconds rank 0 "
        + " ".join(f"{s:.3f}" for s in ranks[0]["step_s"]) + ", rank 1 "
        + " ".join(f"{s:.3f}" for s in ranks[1]["step_s"])
        + "; total loss a step "
        + str([r["total_loss"] for r in ranks[0]["log_vars"]])
        + f" ({card()})")
    log(f"[ddp two ranks] ranks equal bit for bit after each step: "
        f"{ranks[0]['digests'] == ranks[1]['digests']}; against the "
        f"one-process mean step: gradients {ref['grads']:.3g} of their "
        f"norm (tol {DDP_GRAD_TOL}), the worst leaf {ref['grads_leaf']:.3g} "
        f"of its own ({ref['grads_leaf_name']}, tol {DDP_LEAF_TOL}), "
        f"statistics {ref['stats']:.3g} (tol "
        f"{DDP_STATS_TOL}), parameters off by more than lr/100 "
        f"{ref['param_share']:.3g} of them (tol {DDP_PARAM_SHARE}), "
        f"largest {ref['param_max_over_lr']:.3g} lr; [n_pos, denorm] of "
        f"the group {ref['group_counts']}, the scenes' own mean "
        f"{ref['counts']} ({ref['counts_err']:.3g} apart, tol "
        f"{DDP_COUNTS_TOL})")
    if ranks[0]["digests"] != ranks[1]["digests"] \
            or len(ranks[0]["digests"]) != 2:
        raise AssertionError("[ddp two ranks] the ranks' parameters "
                             "differ")
    if not (ref["grads"] <= DDP_GRAD_TOL
            and ref["grads_leaf"] <= DDP_LEAF_TOL
            and ref["stats"] <= DDP_STATS_TOL
            and ref["param_share"] <= DDP_PARAM_SHARE
            and ref["counts_err"] <= DDP_COUNTS_TOL):
        raise AssertionError(f"[ddp two ranks] the ranks' step is not the "
                             f"one-process mean step: {ref}")
    if view_opts is not None:
        got = torch.load(os.path.join(out, "view_steps.pt"),
                         weights_only=False)
        _check_view_ranks(ranks, how, reference, got)


def _kernel_counters() -> dict:
    """The launch counters of the training path's kernels by name."""
    from cnrma_torch.ops.backproject import (
        VOLUME_ACCUM, VOLUME_ACCUM_BWD, VOLUME_ACCUM_SUM)
    from cnrma_torch.ops.ray_marching import RAY_MARCH
    return {"volume_accum": VOLUME_ACCUM, "volume_accum_sum": VOLUME_ACCUM_SUM,
            "volume_accum_bwd": VOLUME_ACCUM_BWD, "ray_march": RAY_MARCH}


def phase_ddp(dev, root: str, data: str, ann: str, syn: str) -> None:
    """The data-parallel path on the card, on phase 6f's scenes and
    synthetic dumps: the train CLI at world size 1
    under ``torchrun`` on NCCL (stage 2 at 500,000 points, stage 3 at
    ``DDP_STAGE3_VIEWS`` views and 192x192x80) against the same run
    without a group; on a
    machine with several cards, stage 3 on a rank a card; stage 2 on two
    ranks (gloo sharing one card, or NCCL on two) against the one-process
    mean step."""
    t0 = time.perf_counter()
    counters = _kernel_counters()
    ddp = os.path.join(root, "ddp")
    os.makedirs(ddp)
    s2 = [f"data.train.data_root={data}", f"data.train.ann_file={ann}",
          f"data.train.points_dir={syn}", "evaluation=None",
          "log_config.interval=1"]
    _world_one(ddp, [
        ("stage 2", [STAGE2_CONFIG, "--max-steps", "2", "--cfg-options",
                     *s2],
         {"volume_accum": 0, "volume_accum_sum": 0, "volume_accum_bwd": 0,
          "ray_march": 0}),
        ("stage 3", [CLI_CONFIG, "--max-steps", "2", "--cfg-options",
                     f"data.train.data_root={data}",
                     f"data.train.ann_file={ann}",
                     f"data.train.num_frames={DDP_STAGE3_VIEWS}",
                     "evaluation=None", "log_config.interval=1"],
         {"volume_accum": 2, "volume_accum_sum": 0, "volume_accum_bwd": 2,
          "ray_march": 2})], counters)
    cards = torch.cuda.device_count()
    if cards > 1:            # the rooms once a rank: a step an epoch
        with open(ann, "rb") as f:
            infos = pickle.load(f)
        ranks = os.path.join(data, "scannet_infos_ranks.pkl")
        with open(ranks, "wb") as f:
            pickle.dump([infos[i % len(infos)] for i in range(cards)], f)
        _world_n(ddp, "stage 3", [CLI_CONFIG, "--max-steps", "2",
                                  "--cfg-options",
                                  f"data.train.data_root={data}",
                                  f"data.train.ann_file={ranks}",
                                  "evaluation=None", "log_config.interval=1"],
                 cards, {"volume_accum": 2, "volume_accum_sum": 0,
                         "volume_accum_bwd": 2, "ray_march": 2})
        _view_cards(ddp, data, ann, cards, counters)
    gc.collect()
    torch.cuda.empty_cache()
    _two_ranks(ddp, s2, view_opts=[
        f"data.train.data_root={data}", f"data.train.ann_file={ann}",
        f"data.train.num_frames={DDP_STAGE3_VIEWS}"])
    log(f"[ddp] phase took {time.perf_counter() - t0:.1f} s ({card()})")


# --- more than one scene a training batch ----------------------------------

BATCH = 2                   # scenes a training batch in the batch phase
BATCH_STEPS = 2             # the batch phase's steps a run
# stage 3's views a scene at B = 2, widths and grid kept: the config's 40
# do not fit (PERF.md: a scene holds about 23.0 GiB that does not scale
# with the views and 0.75 GiB a view, plus 1.78 GiB of state; 14 views,
# 68.9 GiB, are the most under 70)
STAGE3_BATCH_VIEWS = 14
# the tiny step at two scenes, card against CPU: the 2D tower's groups and
# the 3D U-Net's as one more, whose norms see variances under their
# epsilon at two scenes (tests/test_torch_batch.py, BATCH_LIMITS)
BATCH_GROUPS = TOWER_GROUPS + ("backbone3d.",)
EVAL_BATCH_TOL = 1e-5       # a scene's outputs in a batch against alone


def _per_scene_statistics():
    """The planted fault of the batch phase: the sparse batch norms take
    each scene's own statistics and update the running ones once a scene
    (the one-scene loop run over a batch).  Returns the undo."""
    from cnrma_torch.models import layers
    real = layers.MaskedBatchNorm.forward

    def per_scene(self, feats, mask):
        if feats.dim() == 2 or not self.training:
            return real(self, feats, mask)
        return torch.stack([real(self, f, m) for f, m in zip(feats, mask)])
    layers.MaskedBatchNorm.forward = per_scene
    return lambda: setattr(layers.MaskedBatchNorm, "forward", real)


def _batch_reference(dev) -> None:
    """The tiny fp32 training step of phase 6d at two scenes on the GPU
    (kernels) and on the CPU (plain versions), same parameters, batch,
    draws and kept points, at ``TRAIN_LIMITS`` with the U-Net held as a
    group like the tower's (``BATCH_GROUPS``); K1b launched once a scene.
    Then the step with the sparse norms' per-scene statistics planted
    must break the running statistics' limit on a detector norm."""
    from cnrma_torch.models import cn_rma as tcn
    from cnrma_torch.ops import backproject as bp
    state, model, batch, draws = tiny_train_case(BATCH)
    real, kept = tcn._normalize_subsample, []

    def spy(*args, **kw):
        kept.append(real(*args, **kw))
        return kept[-1]

    def replay(*args, **kw):
        replay.calls += 1
        return tuple(t.to(dev) for t in kept[(replay.calls - 1) % BATCH])
    gpu_batch = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                     if isinstance(v, dict) else v.to(dev))
                 for k, v in batch.items()}
    gpu_draws = dict(uniform=draws["uniform"].to(dev),
                     aug_draws=[{k: v.to(dev) for k, v in d.items()}
                                for d in draws["aug_draws"]])

    def gpu_step():
        model.load_state_dict(state)
        model.zero_grad(set_to_none=True)
        replay.calls = 0
        return _step(model, gpu_batch, gpu_draws)
    tcn._normalize_subsample = spy
    try:
        want = _step(model, batch, draws)
        tcn._normalize_subsample = replay
        model.to(dev)
        bp.VOLUME_ACCUM_BWD.launches = 0
        got = gpu_step()
        launches = bp.VOLUME_ACCUM_BWD.launches
        undo = _per_scene_statistics()
        try:
            bad = gpu_step()
        finally:
            undo()
    finally:
        tcn._normalize_subsample = real
    r = _train_readings(got, want, BATCH_GROUPS)
    log(f"[batch reference] tiny fp32 step of {BATCH} scenes, GPU vs CPU: "
        f"K1b launched {launches}; kept points "
        f"{[int(k[4].sum()) for k in kept]}; " + _fmt_readings(r))
    fr = _train_readings(bad, want, BATCH_GROUPS)
    caught = _train_failures(fr)
    log(f"[batch reference] planted fault per-scene sparse statistics: "
        f"breaks {caught}; " + _fmt_readings(fr))
    if launches != BATCH or set(got[0]) != set(want[0]) \
            or _train_failures(r):
        raise AssertionError(f"the GPU step of {BATCH} scenes disagrees "
                             f"with the CPU: {_train_failures(r)}")
    if "stats" not in caught or not fr["stats"][1].startswith("detector."):
        raise AssertionError("the running statistics' limit passes the "
                             "per-scene statistics of the sparse norms")


def _batch_eval(dev, cfg, ckpt: str) -> None:
    """The val split's first batch of ``BATCH`` scenes through the test
    model of ``ckpt`` once, and each scene alone, each scene's subsample
    seeded by its index either way: the TSDFs and kept points within
    ``EVAL_BATCH_TOL``, the same kept count, the raw box rows as sets
    (``_box_rows_against``)."""
    from cnrma_torch.core.builder import build_dataset, build_model
    from cnrma_torch.data.loader import SceneLoader
    from cnrma_torch.train.loop import device_batch
    from cnrma_torch.train.state import read_checkpoint
    model = build_model(cfg, mode="test")
    model.load_state_dict(read_checkpoint(ckpt)["model"])
    model.to(dev).eval()
    loader = SceneLoader(build_dataset(cfg, "val", seed=0), shuffle=False,
                         drop_last=False, batch_size=BATCH)
    batch = next(iter(loader))
    index = batch["index"]
    tb = device_batch(batch, dev)

    def gens(ids):
        return [torch.Generator(dev).manual_seed(int(i)) for i in ids]
    t0 = time.perf_counter()
    with torch.no_grad():
        both = model(tb, generator=gens(index))
        torch.cuda.synchronize()
        t_both = time.perf_counter() - t0
        errs = {"tsdf": 0.0, "points": 0.0, "box rows paired off": 0}
        t_one = 0.0
        for b, i in enumerate(index):
            one_batch = {k: (v[b:b + 1] if torch.is_tensor(v) else
                             {kk: vv[b:b + 1] for kk, vv in v.items()})
                         for k, v in tb.items()}
            t0 = time.perf_counter()
            one = model(one_batch, generator=gens([i]))
            torch.cuda.synchronize()
            t_one += time.perf_counter() - t0
            for k, t in one["tsdf"].items():
                errs["tsdf"] = max(errs["tsdf"], float(
                    (both["tsdf"][k][b] - t[0]).abs().max()))
            va, vb = both["points"].valid[b], one["points"].valid[0]
            pa = torch.cat([both["points"].xyz[b][va],
                            both["points"].feats[b][va]], 1).float().cpu()
            pb = torch.cat([one["points"].xyz[0][vb],
                            one["points"].feats[0][vb]], 1).float().cpu()
            if pa.shape != pb.shape:
                raise AssertionError(f"[batch eval] scene {i}: {len(pa)} "
                                     f"kept points in the batch, {len(pb)} "
                                     f"alone")
            if len(pa):
                errs["points"] = max(errs["points"], float(
                    (pa - pb).abs().max() / max(1.0, float(
                        pa.abs().max()))))
            bv, ov = both["bbox_valid"][b], one["bbox_valid"][0]
            errs["box rows paired off"] += _box_rows_against(
                both["bboxes"][b][bv].float().cpu().numpy(),
                both["scores"][b][bv].float().cpu().numpy(),
                one["bboxes"][0][ov].float().cpu().numpy(),
                one["scores"][0][ov].float().cpu().numpy(),
                f"[batch eval] scene {i}")
    log(f"[batch eval] the val batch of scenes {index} at "
        f"{tuple(cfg.model.voxel_dim_test)} through the test model once "
        f"({t_both:.3f} s) against each scene alone ({t_one:.3f} s): "
        f"kept points {[int(v.sum()) for v in both['points'].valid]}, "
        f"TSDF max|err| {errs['tsdf']:.3g}, points {errs['points']:.3g} "
        f"(tol {EVAL_BATCH_TOL}), raw box rows matched as sets "
        f"({errs['box rows paired off']} paired off as near ties)")
    if errs["tsdf"] > EVAL_BATCH_TOL or errs["points"] > EVAL_BATCH_TOL:
        raise AssertionError(f"a scene's test forward in a batch differs "
                             f"from alone: {errs}")
    del model, both, tb
    torch.cuda.empty_cache()


def _batch_steps(tag: str, recs) -> dict:
    """The steps' seconds (the mean of those after the first, which pays
    cuDNN's first use) and the peak memory of a train CLI run."""
    later = [r["step_s"] for r in recs[1:]] or [recs[0]["step_s"]]
    return {"step_s": statistics.mean(later),
            "peak_gib": max(r["peak_gib"] or 0.0 for r in recs)}


def phase_batch(dev, root: str, data: str, ann: str, syn: str,
                merged: str, one_scene: dict) -> None:
    """Training batches of ``BATCH`` scenes on the card, on phase 6f's two
    scenes and synthetic dumps: the tiny step against the CPU with its
    planted fault (``_batch_reference``); the train CLI at ``--batch-size
    2`` for 3 steps on stage 2 (500,000 points a scene) and on stage 1
    (50 views, 160x160x64, bf16), each step's seconds and the peak memory
    beside phase 6f's one-scene runs of the same call (``one_scene``);
    stage 3 at ``STAGE3_BATCH_VIEWS`` views a scene (widths and grid
    kept) for ``BATCH_STEPS`` steps at one scene and then at two, from the
    merged
    checkpoint, the two-scene run scoring the val split (the same two
    scenes at the test grid) in one batch; K1, K1b and K2 once a scene;
    that run's checkpoint through ``_batch_eval``."""
    from cnrma_torch.core.config import Config
    from cnrma_torch.ops.backproject import VOLUME_ACCUM, VOLUME_ACCUM_BWD
    from cnrma_torch.ops.ray_marching import RAY_MARCH
    t_phase = time.perf_counter()
    counters = {"volume_accum": VOLUME_ACCUM,
                "volume_accum_bwd": VOLUME_ACCUM_BWD, "ray_march": RAY_MARCH}
    gc.collect()
    torch.cuda.empty_cache()
    _batch_reference(dev)
    wd = os.path.join(root, "batch")
    os.makedirs(wd)
    base = [f"data.train.data_root={data}", f"data.train.ann_file={ann}",
            "evaluation=None", "log_config.interval=1"]
    runs = {"stage 2": ([STAGE2_CONFIG], [f"data.train.points_dir={syn}"],
                        {"volume_accum": 0, "volume_accum_bwd": 0,
                         "ray_march": 0}),
            "stage 1": ([STAGE1_CONFIG], [],
                        {"volume_accum": BATCH_STEPS * BATCH,
                         "volume_accum_bwd": BATCH_STEPS * BATCH,
                         "ray_march": 0})}
    summary = {}
    for tag, (cfg_arg, extra, want) in runs.items():
        gc.collect()
        torch.cuda.empty_cache()
        recs, _, launches, _ = _run_train_cli(
            cfg_arg + ["--work-dir", os.path.join(wd, tag.replace(" ", "")),
                       "--batch-size", str(BATCH), "--max-steps",
                       str(BATCH_STEPS), "--cfg-options", *base, *extra],
            counters, BATCH_STEPS,
            f"batch {tag}")
        if launches != want:
            raise AssertionError(f"[batch {tag}] launches {launches}, not "
                                 f"{want}: K1 and K1b once a scene")
        summary[tag] = (_batch_steps(tag, one_scene[tag]),
                        _batch_steps(tag, recs))
    views = f"data.train.num_frames={STAGE3_BATCH_VIEWS}"
    cfg3 = Config.fromfile(CLI_CONFIG)
    val = os.path.join(data, "scannet_infos_val.pkl")
    for b in (1, BATCH):
        gc.collect()
        torch.cuda.empty_cache()
        extra = ([f"data.val.data_root={data}", f"data.val.ann_file={val}",
                  "log_config.interval=1"] if b > 1 else base[2:])
        probe = _eval_probe() if b > 1 else contextlib.nullcontext()
        with probe as seen:
            recs, ckpt, launches, _ = _run_train_cli(
                [CLI_CONFIG, "--work-dir", os.path.join(wd, f"stage3_b{b}"),
                 "--load-from", merged, "--batch-size", str(b),
                 "--max-steps", str(BATCH_STEPS), "--cfg-options",
                 *base[:2], views, *extra], counters, BATCH_STEPS,
                f"batch stage 3 B={b}")
        scored = BATCH if b > 1 else 0
        want = {"volume_accum": BATCH_STEPS * b + scored,
                "volume_accum_bwd": BATCH_STEPS * b,
                "ray_march": BATCH_STEPS * b + scored}
        if launches != want:
            raise AssertionError(f"[batch stage 3 B={b}] launches "
                                 f"{launches}, not {want}: K1, K1b and K2 "
                                 f"once a scene a step, K1 and K2 once a "
                                 f"val scene")
        summary.setdefault("stage 3", []).append(_batch_steps("", recs))
    _check_val("batch stage 3", recs, seen, cfg3.model.voxel_dim_test, 2,
               "mAP", os.path.join(wd, f"stage3_b{BATCH}"), batch=BATCH)
    cfg3.merge_from_options({"data.val.data_root": data,
                             "data.val.ann_file": val})
    _batch_eval(dev, cfg3, ckpt)
    for tag, (one, two) in summary.items():
        note = (f" at {STAGE3_BATCH_VIEWS} views a scene" if tag == "stage 3"
                else " (one scene: phase 6f's run)")
        log(f"[batch {tag}] a step of 1 scene {one['step_s']:.3f} s, of "
            f"{BATCH} scenes {two['step_s']:.3f} s "
            f"({two['step_s'] / one['step_s']:.2f}x){note}; peak memory "
            f"{one['peak_gib']:.2f} -> {two['peak_gib']:.2f} GiB ({card()})")
    log(f"[batch] phase took {time.perf_counter() - t_phase:.1f} s "
        f"({card()})")


ARKIT_CONFIG = "configs/ray_marching_arkit.py"
ARKIT_STAGE1_CONFIG = "configs/atlas_recon_arkit.py"
ARKIT_MIDDLE_CONFIG = "configs/arkit_middle.py"
ARKIT_STAGE2_CONFIG = "configs/fcaf3d_middle_arkit.py"


def _arkit_tiny(dev, root: str) -> None:
    """The ARKit model's tiny fp32 test forward, GPU against CPU: the yaw
    head of ``configs/ray_marching_arkit.py`` (17 classes, 8 regression
    outputs) cut to a 16^3 grid and the tiny detector capacities, the
    default initialisation (seed 0), on a tiny synthetic ARKit scene read
    by the ARKit reader (4 views of 96x64, ``middle`` space)."""
    from cnrma_torch.core.builder import build_dataset, build_model
    from cnrma_torch.core.config import Config
    from cnrma_torch.synthetic import write_arkit
    data = os.path.join(root, "tiny")
    ann = write_arkit(data, n_scenes=1, n_frames=6, tsdf_dim=(24, 24, 16),
                      image_size=(128, 96))
    cfg = Config.fromfile(ARKIT_CONFIG)
    cfg.merge_from_options({
        "data.test.data_root": data, "data.test.ann_file": ann,
        "data.test.num_frames": "4", "data.test.image_size": "(96,64)",
        "model.voxel_dim_test": "(16,16,16)",
        "data.test.voxel_dim": "(16,16,16)", "model.ray_samples": "64",
        "model.rays_per_view_cap": "2048", "model.max_points": "8192",
        "model.detection_head.pts_threshold": "500",
        "model.detection_head.test_cfg.nms_pre": "16",
        "model.capacities": "{'voxelize':2048,'stride2':1024,'stride4':512,"
                            "'levels':(256,128,64,32),'neck':(512,256,128)}"})
    torch.manual_seed(0)
    model = build_model(cfg)
    sample = build_dataset(cfg, "test", seed=0)[0]
    batch = {k: torch.from_numpy(np.asarray(sample[k])[None])
             for k in ("imgs", "projection", "view_valid", "offset")}
    uniform = torch.from_numpy(np.random.RandomState(0).rand(
        1, 4 * 2048).astype(np.float32))
    gpu_against_cpu(dev, model, batch, uniform, "arkit tiny")
    del model
    torch.cuda.empty_cache()


def _plant_arkit_dumps(data: str, out: str, scenes, turn: bool) -> None:
    """Raw box dumps whose every prediction is a GT yaw box of its scene
    (score 0.9 in its class, 0.001 elsewhere), optionally turned by pi/2
    about its centre (the boxes are not square, so the turned box no longer
    matches it)."""
    for scene in scenes:
        gt = np.load(os.path.join(data, "arkit_instance_data",
                                  scene + "_aligned_bbox.npy"))
        boxes = gt[:, :7].astype(np.float32).copy()
        if turn:
            boxes[:, 6] += math.pi / 2
        scores = np.full((len(gt), 17), 0.001, np.float32)
        scores[np.arange(len(gt)), gt[:, 7].astype(int)] = 0.9
        os.makedirs(os.path.join(out, scene), exist_ok=True)
        np.savez(os.path.join(out, scene, scene + "_bbox_raw.npz"),
                 bboxes=boxes, scores=scores)


def _rotated_nms_at_capacity(dev) -> None:
    """Rotated NMS of one class at the head's largest output, 4 levels of
    ``nms_pre`` 1000 rows (random yaw boxes in a 6 m room, seed 0): the
    seconds and peak memory of its [4000, 4000] rotated BEV IoU and walk
    on the card; the keep mask of its first 1000 boxes against the CPU's
    (the whole set takes the CPU too long)."""
    from cnrma_torch.ops.nms import nms_bev
    rng = np.random.RandomState(0)
    n = 4000
    boxes = torch.from_numpy(np.concatenate([
        rng.uniform(0, 6, (n, 2)), rng.uniform(0, 2, (n, 1)),
        rng.uniform(0.2, 1.5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
        1).astype(np.float32))
    scores = torch.from_numpy(rng.rand(n).astype(np.float32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    keep = nms_bev(boxes.to(dev), scores.to(dev), 0.5, rotated=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    k = 1000
    t0 = time.perf_counter()
    keep_cpu = nms_bev(boxes[:k], scores[:k], 0.5, rotated=True)
    cpu_s = time.perf_counter() - t0
    same = bool(torch.equal(nms_bev(boxes[:k].to(dev), scores[:k].to(dev),
                                    0.5, rotated=True).cpu(), keep_cpu))
    log(f"[arkit] rotated NMS of one class at 4 x nms_pre = {n} boxes: "
        f"{secs:.3f} s on the card, peak memory {peak / 2 ** 30:.2f} GiB, "
        f"{int(keep.sum())} kept; its first {k} boxes: keep mask equal to "
        f"the CPU's {same} (CPU {cpu_s:.3f} s)")
    if not same:
        raise AssertionError("rotated NMS on the card keeps other boxes "
                             "than on the CPU")


def _arkit_test_cli(dev, root: str, data: str, ann: str) -> list:
    """The test CLI on the two scenes at the ARKit config's full test width
    (40 views of 480x640 from 256x192 PNG frames, 192x192x80, fp32,
    ``middle`` space) from a default-initialised checkpoint; K1 and K2 once
    a scene; the files (7-column boxes, 17 scores); the rotated NMS and mAP
    on the card: of the CLI's boxes (printed), of planted GT boxes
    (exactly 1.0) and of the same turned by pi/2 (mAP@0.50 under 1); the
    rotated NMS at the head's capacity; points and boxes on a planted
    surface; one scene's capacity lines.  Returns the scenes."""
    from cnrma_torch.core.builder import build_model
    from cnrma_torch.core.config import Config
    from cnrma_torch.ops.backproject import VOLUME_ACCUM
    from cnrma_torch.ops.ray_marching import RAY_MARCH
    from cnrma_torch.tools import test as test_cli
    cfg = Config.fromfile(ARKIT_CONFIG)
    dim = tuple(cfg.model.voxel_dim_test)
    torch.manual_seed(0)
    ckpt = os.path.join(root, "init.pt")
    torch.save(build_model(cfg).state_dict(), ckpt)
    save, middle = os.path.join(root, "res"), os.path.join(root, "mid")
    argv = [ARKIT_CONFIG, ckpt, "--save-path", save, "--middle-save-path",
            middle, "--cfg-options", f"data.test.data_root={data}",
            f"data.test.ann_file={ann}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    VOLUME_ACCUM.launches = 0
    RAY_MARCH.launches = 0
    t0 = time.perf_counter()
    records = test_cli.main(argv)
    wall = time.perf_counter() - t0
    launches = {"volume_accum": VOLUME_ACCUM.launches,
                "ray_march": RAY_MARCH.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[arkit cli] {len(records)} scenes at {dim}, "
        f"{cfg.data.test.num_frames} views, in {wall:.2f} s; launches "
        f"{launches}; peak memory {peak / 2 ** 30:.2f} GiB")
    if launches != {"volume_accum": 2, "ray_march": 2} or len(records) != 2:
        raise AssertionError(f"two ARKit scenes must launch each main-path "
                             f"kernel twice: {launches}")
    for r in records:
        # the default initialisation's TSDF is nearly flat here, so a scene
        # may keep no point and so no box: ``_arkit_surface`` plants one
        r.update(_check_scene_files(save, middle, r["scene"], dim,
                                    need_points=False, box_dim=7,
                                    n_classes=17))
        log(f"[arkit cli] {r['scene']}: read {r['load_s']:.3f} s (waited "
            f"{r['wait_s']:.3f}), forward {r['forward_s']:.3f} s, write "
            f"{r['write_s']:.3f} s (mesh {r['mesh_s']:.3f} s); "
            f"{r['faces']} faces; {r['raw_boxes']} raw boxes of 7 columns, "
            f"{r['middle_points']} points")
    m = _score(data, save, "arkit")
    log(f"[arkit cli] the CLI's boxes scored: rotated NMS "
        f"{m['nms_s']:.3f} s, rotated mAP {m['map_s']:.3f} s; mAP@0.25 "
        f"{m['mAP_0.25']:.4f}, mAP@0.50 {m['mAP_0.50']:.4f} (printed, not "
        f"checked)")
    scenes = [r["scene"] for r in records]
    exact, turned = os.path.join(root, "planted"), os.path.join(root, "turned")
    _plant_arkit_dumps(data, exact, scenes, turn=False)
    _plant_arkit_dumps(data, turned, scenes, turn=True)
    m, mt = _score(data, exact, "arkit"), _score(data, turned, "arkit")
    log(f"[arkit cli] planted rotated boxes: mAP@0.25 {m['mAP_0.25']}, "
        f"mAP@0.50 {m['mAP_0.50']} (NMS {m['nms_s']:.3f} s, mAP "
        f"{m['map_s']:.3f} s); turned by pi/2: mAP@0.25 {mt['mAP_0.25']:.4f}"
        f", mAP@0.50 {mt['mAP_0.50']:.4f}")
    if m["mAP_0.25"] != 1.0 or m["mAP_0.50"] != 1.0 \
            or not mt["mAP_0.50"] < 1.0:
        raise AssertionError("rotated NMS + mAP: planted yaw boxes must "
                             "score exactly 1.0, turned ones under 1 at 0.5")
    _rotated_nms_at_capacity(dev)
    _arkit_surface(dev, root, data, ann)
    lines = _capacity_lines(argv, os.path.join(root, "cap"), "arkit cli")
    if not any("voxelize" in ln for ln in lines):
        raise AssertionError("capacity report: no voxelize line")
    return scenes


def _arkit_surface(dev, root: str, data: str, ann: str) -> None:
    """The data-dependent half of the ARKit test forward at full size, as
    phase 5b's: the yaw model with bench.py's synthesized parameters (seed
    0; the default initialisation's untrained norms blow its activations
    up past fp32 at full depth) on the first scene's reader sample (40
    views of 480x640, ``middle`` space, fp32), its fine TSDF replaced by a
    planted 0.5 m ball at the grid's centre (positive inside); the ray
    march and the detector on it must give points and finite 7-column
    boxes with 17 scores.  Every box scores over the NMS threshold in
    every class, so ``nms_bbox`` and ``evaluate_bbox`` on them time the
    rotated NMS and mAP at the head's full output."""
    from cnrma_torch.core.builder import build_dataset, build_model
    from cnrma_torch.core.config import Config
    from cnrma_torch.synthetic import sphere_tsdf, synthesize_parameters
    cfg = Config.fromfile(ARKIT_CONFIG)
    cfg.merge_from_options({"data.test.data_root": data,
                            "data.test.ann_file": ann})
    model = build_model(cfg)
    synthesize_parameters(model, 0)
    model.to(dev)
    sample = build_dataset(cfg, "test", seed=0)[0]
    batch = {k: torch.from_numpy(np.asarray(sample[k])[None]).to(dev)
             for k in ("imgs", "projection", "view_valid", "offset")}
    dim, vs = tuple(cfg.model.voxel_dim_test), cfg.model.voxel_size
    tsdf = -sphere_tsdf(dim, vs, radius=0.5, trunc=3 * vs).to(dev)[None]
    with torch.no_grad():
        feats = model.extract_2d(batch["imgs"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pts = model.ray_march(feats, batch["projection"],
                              batch["view_valid"], tsdf,
                              torch.Generator(device=dev).manual_seed(0))
        xyz = pts.xyz + batch["offset"][:, None, :]
        bboxes, scores, bvalid = model.detector.get_bboxes(
            model.detector(xyz, pts.feats, pts.valid))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    v = bvalid[0]
    n_points, n_boxes = int(pts.valid.sum()), int(v.sum())
    finite = {name: bool(torch.isfinite(t).all()) for name, t in
              (("points", pts.xyz), ("features", pts.feats),
               ("boxes", bboxes[0][v]), ("scores", scores[0][v]))}
    log(f"[arkit surface] planted ball, the ARKit test shape in fp32: "
        f"{n_points} kept points of {model.max_points}; {n_boxes} valid "
        f"boxes of {bboxes.shape[-1]} columns, {scores.shape[-1]} scores; "
        f"ray march + detection {secs * 1e3:.1f} ms; finite {finite}")
    if not all(finite.values()) or n_points == 0 or n_boxes == 0 \
            or bboxes.shape[-1] != 7 or scores.shape[-1] != 17:
        raise AssertionError("ARKit planted surface: no points, no boxes, "
                             "non-finite values or not 7-DoF boxes")
    out = os.path.join(root, "surface", sample["scene"])
    os.makedirs(out)
    np.savez(os.path.join(out, sample["scene"] + "_bbox_raw.npz"),
             bboxes=bboxes[0][v].cpu().numpy(),
             scores=scores[0][v].cpu().numpy())
    del model, batch, feats, pts, bboxes, scores
    torch.cuda.empty_cache()
    m = _score(data, os.path.dirname(out), "arkit")
    kept = np.load(os.path.join(out, sample["scene"] + "_atlas_bbox.npz"))
    log(f"[arkit surface] rotated NMS of its {n_boxes} boxes in 17 classes "
        f"on the card: {m['nms_s']:.3f} s, {len(kept['boxes'])} kept; "
        f"rotated mAP {m['map_s']:.3f} s")


def arkit_volume_args(dev, proj_full, view_valid) -> tuple:
    """K1's arguments at an ARKit shape: a reader's projections ([40, 3,
    4] for 480x640), 40 views of [120, 160, 32] fp32 features (uniform,
    seed 0) over the 192x192x80 grid at 4 cm."""
    c = TRAIN_FULL
    proj = proj_full.clone()
    proj[:, :2, :] /= 4
    feats = torch.rand(proj.shape[0], c["h"] // 4, c["w"] // 4, 32,
                       generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    return (proj, feats, view_valid, c["voxel_dim"], c["voxel_size"],
            (0.0, 0.0, 0.0))


def arkit_ray_args(dev, proj_full, view_valid) -> tuple:
    """K2's arguments at an ARKit shape: the rays of a reader's 40 views at
    [120, 160] on a planted 0.5 m ball TSDF at the 192x192x80 grid's
    centre (positive inside) and its occupancy, the config's march
    constants."""
    from cnrma_torch.ops import ray_marching as rm
    from cnrma_torch.synthetic import sphere_tsdf
    c = TRAIN_FULL
    proj = proj_full.clone()
    proj[:, :2, :] /= 4
    tsdf = -sphere_tsdf(c["voxel_dim"], c["voxel_size"], radius=0.5,
                        trunc=3 * c["voxel_size"]).to(dev)
    o, d = rm.get_ray_parameters(proj, c["h"] // 4, c["w"] // 4)
    return (o, d, view_valid, tsdf, rm.build_occupancy(tsdf, 8),
            (0.0, 0.0, 0.0), c["voxel_size"], 300, 0.05, 8, 48, 8)


def arkit_volume_bwd_args(dev, proj_full, view_valid) -> tuple:
    """K1b's arguments at an ARKit shape, fp32 (``volume_bwd_args_at``)."""
    c = TRAIN_FULL
    return volume_bwd_args_at(dev, torch.float32, proj_full, view_valid,
                              c["voxel_dim"], c["voxel_size"], c["h"],
                              c["w"])


def _arkit_kernels(dev, test_sample, train_sample) -> list:
    """K1 and K2 at the ARKit test shape, K1b at its training shape (the
    readers' projections of a synthetic scene), fp32 as the config runs,
    each against its plain version (phases 3, 4 and 6c's tolerances) and
    timed by CUDA events beside it.  Returns the device-time calls for
    phase 8: (label, kernel symbol, the call's arguments' maker, call, the
    maker of the library call on those arguments or None)."""
    from cnrma_torch.ops import backproject as bp
    from cnrma_torch.ops import ray_marching as rm

    def views(sample):
        return (torch.from_numpy(sample["projection"]).to(dev),
                torch.from_numpy(sample["view_valid"]).to(dev))
    test_views, train_views = views(test_sample), views(train_sample)
    vol = arkit_volume_args(dev, *test_views)
    got, cnt, ok = bp.volume_accum_cuda(*vol)
    want, pcnt, pok = bp.volume_accum_plain(*vol)
    err = float((got - want).abs().max())
    if not (torch.equal(ok, pok) and torch.equal(cnt, pcnt)) or err > 1e-6:
        raise AssertionError(f"volume kernel at the ARKit test shape: error "
                             f"{err} or masks differ")
    b = bound(*volume_work(*vol, cnt)[:2])
    log(f"[arkit kernels] K1 fp32, 40 views of [120, 160, 32] over "
        f"192x192x80: mask and counts equal, max|err| {err:.3g} (tol 1e-6);"
        f" kernel {time_ms(lambda: bp.volume_accum_cuda(*vol), dev):.4f} ms"
        f" event, plain {time_ms(lambda: bp.volume_accum_plain(*vol), dev, reps=3):.3f}"
        f" ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']}; observed "
        f"voxels {ok.float().mean().item():.4f}, (voxel, view) pairs "
        f"{float(cnt.sum()):.0f}")
    del vol, got, want
    ray = arkit_ray_args(dev, *test_views)
    got, want = rm.march_rays_cuda(*ray), rm.march_rays_plain(*ray)
    differ, err = rm.kept_mismatch(got[:2], want[:2], 300, 0.05)
    kept = int((got[0] > 0).sum())
    if not (torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])) \
            or differ or err > RAY_TOL or kept == 0:
        raise AssertionError(f"ray-march kernel at the ARKit test shape: "
                             f"{differ} kept samples differ, weight error "
                             f"{err}, {kept} kept")
    work = bound(*ray_work(ray, got[2], got[3]))
    log(f"[arkit kernels] K2, 40 views x 19,200 rays on a planted ball: "
        f"j0/has_hit equal, hit share "
        f"{float(got[3].float().mean()):.4f}, {kept} kept samples, sets "
        f"equal, weight max|err| {err:.3g} (tol {RAY_TOL}); kernel "
        f"{time_ms(lambda: rm.march_rays_cuda(*ray), dev):.4f} ms event, "
        f"plain {time_ms(lambda: rm.march_rays_plain(*ray), dev, reps=3):.3f}"
        f" ms; bound {work['bound_ms']:.6f} ms by {work['bound_by']}")
    del ray, got, want
    bwd = arkit_volume_bwd_args(dev, *train_views)
    c = check_volume_bwd(bwd, "ARKit training shape")
    nbytes, ops, pairs = volume_bwd_work(bwd)
    b = bound(nbytes, ops)
    direct = torch.zeros(1, dtype=torch.int64, device=dev)
    bp.volume_accum_bwd_cuda(*bwd, direct=direct)
    log(f"[arkit kernels] K1b fp32 at the training shape: max|err| "
        f"{c['err']:.3g} = {c['err'] / c['scale']:.3g} of the largest "
        f"gradient (tol {c['tol_name']}); kernel "
        f"{time_ms(lambda: bp.volume_accum_bwd_cuda(*bwd), dev):.4f} ms "
        f"event, plain "
        f"{time_ms(lambda: bp.volume_accum_bwd_plain(*bwd), dev, reps=3):.3f}"
        f" ms, index_add_ {time_ms(index_add_library(bwd), dev):.4f} ms; "
        f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}; pairs "
        f"{pairs:.0f}, off the window {int(direct.item())} "
        f"({int(direct.item()) / max(pairs, 1):.1%})")
    del bwd
    torch.cuda.empty_cache()
    return [("K1 at the ARKit test shape", "volume_accum_kernel",
             lambda: arkit_volume_args(dev, *test_views),
             lambda a: bp.volume_accum_cuda(*a), None),
            ("K2 at the ARKit test shape", "ray_march_kernel",
             lambda: arkit_ray_args(dev, *test_views),
             lambda a: rm.march_rays_cuda(*a), None),
            ("K1b at the ARKit training shape", "volume_accum_bwd_kernel",
             lambda: arkit_volume_bwd_args(dev, *train_views),
             lambda a: bp.volume_accum_bwd_cuda(*a), index_add_library)]


def phase_arkit(dev) -> list:
    """The ARKitScenes 7-DoF path on the card, on two synthetic ARKit
    scenes (60 frames of 256x192 PNG, ``lowres_wide`` layout, five yaw
    boxes a room) written under ``build/``: (a) the yaw model's tiny fp32
    forward, GPU against CPU; (b) the test CLI at the config's full width,
    rotated NMS and mAP on the card; then ARKit's recipe as a chain: (f) 3
    stage-1 steps of ``configs/atlas_recon_arkit.py`` at its width (50
    views of 480x640, 160x160x64, bf16), K1 and K1b once a step; (g) the
    stage-2.1 dump (the test CLI on ``configs/arkit_middle.py`` from that
    checkpoint, the detector synthesized) of both scenes, K1 and K2 once a
    scene, every dump's points finite and within the config's
    ``max_points``, each held against this process's forward of the
    checkpoint; (d) 3 stage-2 steps on ``configs/fcaf3d_middle_arkit.py``
    at full width, on synthetic dumps of 600,000 points on the yaw boxes'
    faces, then 3 on the 2.1 dumps, each step with positives for the
    rotated IoU loss; the merge of stage 1 and the 2.1 dumps' stage 2; (c) 3 stage-3 steps of the train CLI at full
    width (``configs/ray_marching_arkit.py``: 40 views of 480x640,
    192x192x80, fp32, the rotated IoU loss) from the merged checkpoint,
    with its val evaluation; (e) K1 and K2 at the ARKit test shape and K1b
    at its training shape against their plain versions.  Returns (e)'s
    device-time calls for phase 8."""
    from cnrma_torch.core.builder import build_dataset
    from cnrma_torch.core.config import Config
    from cnrma_torch.ops.backproject import VOLUME_ACCUM, VOLUME_ACCUM_BWD
    from cnrma_torch.ops.ray_marching import RAY_MARCH
    from cnrma_torch.synthetic import write_arkit, write_point_dumps
    from cnrma_torch.tools import test as test_cli
    counters = {"volume_accum": VOLUME_ACCUM,
                "volume_accum_bwd": VOLUME_ACCUM_BWD, "ray_march": RAY_MARCH}
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="arkit_", dir="build")
    t_phase = time.perf_counter()
    try:
        _arkit_tiny(dev, root)
        t0 = time.perf_counter()
        data = os.path.join(root, "data")
        val = write_arkit(data, n_scenes=2, n_frames=60)
        train = os.path.join(data, "arkit_infos_train.pkl")
        shutil.copy(val, train)
        log(f"[arkit] wrote 2 scenes (60 PNG frames of 256x192, room TSDF "
            f"over 168x152x64, five yaw boxes) in "
            f"{time.perf_counter() - t0:.1f} s")
        _arkit_test_cli(dev, root, data, val)

        # (f) stage 1 at its width, from the CLI's default initialisation
        s1_records, s1, launches, _ = _run_train_cli(
            [ARKIT_STAGE1_CONFIG, "--work-dir", os.path.join(root, "s1"),
             "--max-steps", "3", "--cfg-options",
             f"data.train.data_root={data}", f"data.train.ann_file={train}",
             "evaluation=None", "log_config.interval=1"], counters, 3,
            "arkit stage 1")
        if launches != {"volume_accum": 3, "volume_accum_bwd": 3,
                        "ray_march": 0}:
            raise AssertionError(f"each ARKit stage-1 step must launch K1 "
                                 f"and K1b once, K2 never: {launches}")
        one = _batch_steps("", s1_records)
        log(f"[arkit stage 1] a warm step {one['step_s']:.3f} s, peak "
            f"{one['peak_gib']:.2f} GiB ({card()})")

        # (g) the stage-2.1 dump of both scenes from the stage-1 checkpoint
        cfgm = Config.fromfile(ARKIT_MIDDLE_CONFIG)
        mid = os.path.join(root, "mid")
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        recs = test_cli.main([ARKIT_MIDDLE_CONFIG, s1, "--save-path",
                              os.path.join(root, "res21"),
                              "--middle-save-path", mid, "--cfg-options",
                              f"data.test.data_root={data}",
                              f"data.test.ann_file={train}"])
        launches = _counts(counters)
        log(f"[arkit stage 2.1] {len(recs)} scenes in "
            f"{time.perf_counter() - t0:.2f} s at "
            f"{tuple(cfgm.model.voxel_dim_test)}, "
            f"{cfgm.data.test.num_frames} views; launches {launches}; "
            f"forward seconds {[round(r['forward_s'], 3) for r in recs]}")
        if launches != {"volume_accum": 2, "volume_accum_bwd": 0,
                        "ray_march": 2}:
            raise AssertionError(f"each dumped ARKit scene must launch K1 "
                                 f"and K2 once: {launches}")
        for r in recs:
            pts = np.load(os.path.join(mid, r["scene"] + "_vert.npy"))
            log(f"[arkit stage 2.1] {r['scene']}: {pts.shape} points (of "
                f"max_points {cfgm.model.max_points}), finite "
                f"{bool(np.isfinite(pts).all())}")
            if (pts.ndim != 2 or len(pts) > cfgm.model.max_points
                    or not np.isfinite(pts).all()):
                raise AssertionError(f"{r['scene']}: the dump must hold "
                                     f"finite points within max_points")
        counts = _dump_against_forward(cfgm, data, train, s1, mid, dev,
                                       "arkit stage 2.1")

        # (d) stage 2 at full width on synthetic dumps (600,000 points on
        # the yaw boxes' faces, 500,000 drawn a step), then on the 2.1 dumps
        # that hold points; positives in every step of both, so the rotated
        # IoU loss and its backward run
        syn = os.path.join(data, "middle_points")
        write_point_dumps(data, syn, n_points=600000,
                          ann_name="arkit_infos_train.pkl")
        kept = [r["scene"] for r, n in zip(recs, counts) if n > 0]
        if not kept:
            raise AssertionError("every ARKit stage-2.1 dump is empty: "
                                 "stage 2 has no points to train on")
        dumps = os.path.join(root, "mid_nonempty")
        os.makedirs(dumps)
        for sc in kept:
            shutil.copy(os.path.join(mid, sc + "_vert.npy"), dumps)
        for name, points_dir, used in (
                ("synthetic", syn, [r["scene"] for r in recs]),
                ("stage 2.1", dumps, kept)):
            records, s2, launches, _ = _run_train_cli(
                [ARKIT_STAGE2_CONFIG, "--work-dir", os.path.join(
                    root, "s2_" + name.replace(" ", "_")), "--max-steps",
                 "3", "--cfg-options", f"data.train.data_root={data}",
                 f"data.train.ann_file={train}",
                 f"data.train.points_dir={points_dir}",
                 "log_config.interval=1"], counters, 3,
                f"arkit stage 2 on {name} dumps of {used}")
            if any(launches.values()):
                raise AssertionError(f"stage 2 launches no volume or march "
                                     f"kernel: {launches}")
            positives = [r["log_vars"]["loss_bbox"] > 0 for r in records]
            log(f"[arkit stage 2] {name} dumps: steps with positives "
                f"(loss_bbox > 0): {sum(positives)} of 3")
            if not all(positives):
                raise AssertionError(f"ARKit stage 2 on {name} dumps: a "
                                     f"step without positives (loss_bbox "
                                     f"0)")
        # the merge takes the checkpoint of the 2.1 dumps' run (the last)
        merged = os.path.join(root, "merged.pt")
        _merge(s1, s2, merged, "arkit merge")

        # (c) stage 3 from the merged checkpoint, with its val evaluation
        with _eval_probe() as seen:
            records, _, launches, _ = _run_train_cli(
                [ARKIT_CONFIG, "--work-dir", os.path.join(root, "s3"),
                 "--load-from", merged, "--max-steps", "3", "--cfg-options",
                 f"data.train.data_root={data}",
                 f"data.train.ann_file={train}", f"data.val.data_root={data}",
                 f"data.val.ann_file={val}", "log_config.interval=1"],
                counters, 3, "arkit stage 3")
        log(f"[arkit stage 3] launches: {launches} (3 steps and 2 val "
            f"scenes); a finite grad_norm each step: every leaf's gradient "
            f"finite; steps with positives (loss_bbox > 0): "
            f"{sum(r['log_vars']['loss_bbox'] > 0 for r in records)} of 3 "
            f"(the merged checkpoint may keep no point)")
        if launches != {"volume_accum": 5, "volume_accum_bwd": 3,
                        "ray_march": 5}:
            raise AssertionError(f"each ARKit stage-3 step must launch K1, "
                                 f"K1b and K2 once, each val scene K1 and "
                                 f"K2 once: {launches}")
        _check_val("arkit stage 3", records, seen,
                   Config.fromfile(ARKIT_CONFIG).model.voxel_dim_test, 2,
                   "mAP", os.path.join(root, "s3"))

        cfg = Config.fromfile(ARKIT_CONFIG)
        cfg.merge_from_options({"data.test.data_root": data,
                                "data.test.ann_file": val,
                                "data.train.data_root": data,
                                "data.train.ann_file": train})
        calls = _arkit_kernels(dev, build_dataset(cfg, "test", seed=0)[0],
                               build_dataset(cfg, "train", seed=0)[0])
        log(f"[arkit] phase took {time.perf_counter() - t_phase:.1f} s")
        return calls
    finally:
        shutil.rmtree(root, ignore_errors=True)


PREP_FRAMES = 300           # extract_posed_images' default --max_frames
PREP_TSDF_DIM = (208, 208, 80)   # the stage-3 test extent at 4 cm
PREP_CPU_FRAMES = {0.04: 20, 0.16: PREP_FRAMES}   # held against the CPU
# the consistent route's sign agreement at 4 cm: 0.9704 of 37,827
# observed voxels on the first H100 run of this phase, the F17 route's
# 0.4272 of 25,487 (the scene is made from a seed: the same every run)
PREP_SIGN_BOUND = 0.95


def card() -> str:
    """The first card's name and power limit, as nvidia-smi gives them
    (``phase_device`` logs every card's)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _prep_fusion(dev, cons: str, scene: str, on: str) -> None:
    """The scene's frames read as ``generate_tsdf`` reads them (the host's
    PNG decode and pose text timed), fused on the card at 4, 8 and 16 cm
    (CUDA events with the frames already on the card, then streamed from
    the host as the CLI does; peak memory), and held against the CPU's
    fusion of the same frames (``PREP_CPU_FRAMES``) by the CPU tests'
    rule (``tsdf_fusion.fusion_mismatch``)."""
    from cnrma_torch.geometry import tsdf_fusion as fus
    from cnrma_torch.tools.data_prepare import generate_tsdf
    args = generate_tsdf.parse_args(["--data_path", cons, "--save_path", "",
                                     "--device", "cpu"])
    t0 = time.perf_counter()
    intr, depths, c2w, projs, _ = generate_tsdf.read_scene(args, scene)
    read_s = time.perf_counter() - t0
    origin, dim4 = generate_tsdf.scene_bounds(args, intr, depths, c2w)
    n = len(depths)
    log(f"[prep] host read of {n} frames (640x480 depth PNG decode and pose "
        f"text): {read_s:.3f} s, {1e3 * read_s / n:.2f} ms a frame {on}")
    projs = np.stack(projs).astype(np.float32)
    ok = np.ones(n, bool)
    frames = torch.from_numpy(np.stack(depths)).to(dev)
    for vs in (0.04, 0.08, 0.16):
        k = int(round(vs / 0.04))
        dim = tuple(d // k for d in dim4)
        voxels = int(np.prod(dim))
        fus.fuse_tsdf(frames[:2], projs[:2], ok[:2], origin, dim, vs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fus.fuse_tsdf(frames, projs, ok, origin, dim, vs)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        t0 = time.perf_counter()
        card_t, card_w = fus.fuse_tsdf(depths, projs, ok, origin, dim, vs,
                                       device=dev)
        torch.cuda.synchronize()
        streamed = time.perf_counter() - t0
        log(f"[prep] fusion at {100 * vs:.0f} cm, {dim[0]}x{dim[1]}x{dim[2]} "
            f"({voxels / 1e6:.2f}M voxels), {n} frames: {ms:.2f} ms of CUDA "
            f"events with the frames on the card, {1e3 * n / ms:.0f} frames "
            f"a second, {1e3 * n * voxels / ms / 1e9:.2f}G voxel-frames a "
            f"second; streamed from the host {streamed:.3f} s; peak memory "
            f"{peak:.3f} GiB over the {base / 2 ** 30:.3f} GiB held before "
            f"{on}")
        m = PREP_CPU_FRAMES.get(vs)
        if m is None:
            continue
        if m < n:
            card_t, card_w = fus.fuse_tsdf(frames[:m], projs[:m], ok[:m],
                                           origin, dim, vs)
        t0 = time.perf_counter()
        cpu = fus.fuse_tsdf(depths[:m], projs[:m], ok[:m], origin, dim, vs)
        cpu_s = time.perf_counter() - t0
        share, unexplained = fus.fusion_mismatch(
            (card_t.cpu(), card_w.cpu()), cpu, depths[:m], projs[:m], origin,
            vs)
        log(f"[prep] card against CPU at {100 * vs:.0f} cm over {m} frames: "
            f"{share:.2e} of the voxels differ, {len(unexplained)} of them "
            f"no near tie; observed voxels {int((card_w > 0).sum())}; the "
            f"CPU took {cpu_s:.2f} s")
        if len(unexplained) or share > fus.PARITY_MAX_SHARE:
            raise AssertionError(f"[prep] the card's fusion differs from the "
                                 f"CPU's at {100 * vs:.0f} cm: share "
                                 f"{share}, voxels {unexplained[:5]}")
        del card_t, card_w, cpu
    del frames
    torch.cuda.empty_cache()


def phase_prep(dev) -> None:
    """ScanNet's data preparation (``doc/data.md``'s chain) through the
    port's CLIs on one synthetic scene of realistic size, written under
    ``build/``: a ``.sens`` of ``PREP_FRAMES`` frames (1296x968 JPEG colour,
    640x480 depth ray-cast from the planted room through the depth
    camera's intrinsic) and the scan of the same room.
    ``extract_posed_images``; ``generate_tsdf --device cuda:0`` on the
    F17 route (the colour intrinsic, as ``extract_posed_images`` writes
    it) and on the consistent route (the same PNGs through the depth
    intrinsic); ``batch_load_scannet_data``; ``aggregate_data`` for train
    and val; one stage-3 step of the train CLI at full width on the
    result, with finite losses and K1, K1b and K2 once.  Then the fusion
    timed on the card and held against the CPU (``_prep_fusion``), and
    the 4 cm TSDFs' sign agreement with the planted room: at least
    ``PREP_SIGN_BOUND`` on the consistent route; the F17 route's printed
    beside it."""
    from cnrma_torch.ops.backproject import VOLUME_ACCUM, VOLUME_ACCUM_BWD
    from cnrma_torch.ops.ray_marching import RAY_MARCH
    from cnrma_torch.synthetic import (fused_sign_agreement, room_boxes,
                                       write_scannet_raw)
    from cnrma_torch.tools.data_prepare import (
        aggregate_data, batch_load_scannet_data, extract_posed_images,
        generate_tsdf)
    counters = {"volume_accum": VOLUME_ACCUM,
                "volume_accum_bwd": VOLUME_ACCUM_BWD, "ray_march": RAY_MARCH}
    on = f"({card()})"
    scene = "scene0000_00"
    os.makedirs("build", exist_ok=True)
    root = os.path.abspath(tempfile.mkdtemp(prefix="prep_", dir="build"))
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        cams = write_scannet_raw(root, n_frames=PREP_FRAMES,
                                 tsdf_dim=PREP_TSDF_DIM)
        sens = os.path.join(root, "scans", scene, scene + ".sens")
        log(f"[prep] wrote the raw scene ({PREP_FRAMES} frames of 1296x968 "
            f"JPEG and 640x480 depth in a .sens of "
            f"{os.path.getsize(sens) / 2 ** 20:.1f} MiB, the scan) in "
            f"{time.perf_counter() - t0:.1f} s")
        data, meta = os.path.join(root, "scannet"), os.path.join(root,
                                                                 "meta_data")
        posed = os.path.join(data, "posed_images")
        f17 = os.path.join(root, "f17")
        cons = os.path.join(root, "consistent")
        steps = {}

        def step(name, fn, argv):
            t = time.perf_counter()
            fn(argv)
            steps[name] = time.perf_counter() - t

        t_chain = time.perf_counter()
        step("extract_posed_images", extract_posed_images.main,
             ["--scans_path", os.path.join(root, "scans"), "--output_path",
              posed])
        step("generate_tsdf (F17 route)", generate_tsdf.main,
             ["--data_path", data, "--save_path", f17, "--device", "cuda:0"])
        own = os.path.join(cons, "posed_images", scene)
        os.makedirs(own)
        for f in os.listdir(os.path.join(posed, scene)):
            if f != "intrinsic.txt":
                os.symlink(os.path.join(posed, scene, f), os.path.join(own, f))
        np.savetxt(os.path.join(own, "intrinsic.txt"),
                   cams["intrinsic_depth"], fmt="%.6f")
        step("generate_tsdf", generate_tsdf.main,
             ["--data_path", cons, "--save_path", data, "--device",
              "cuda:0"])
        step("batch_load_scannet_data", batch_load_scannet_data.main,
             ["--scans_path", os.path.join(root, "scans"), "--label_map",
              os.path.join(meta, "scannetv2-labels.combined.tsv"),
              "--output_path", os.path.join(data, "scannet_instance_data")])
        for split in ("train", "val"):
            step(f"aggregate_data {split}", aggregate_data.main,
                 ["--dataset", "scannet", "--data_path", data, "--split",
                  split, "--scene_list",
                  os.path.join(meta, f"scannetv2_{split}.txt")])
        chain_s = time.perf_counter() - t_chain
        log(f"[prep] the chain in {chain_s:.2f} s of wall time: "
            + ", ".join(f"{k} {v:.2f} s" for k, v in steps.items()) + f" {on}")
        tsdf_dir = os.path.join(data, "atlas_tsdf", scene)
        if sorted(os.listdir(tsdf_dir)) != ["info.json", "tsdf_04.npz",
                                            "tsdf_08.npz", "tsdf_16.npz"]:
            raise AssertionError(f"[prep] generate_tsdf wrote "
                                 f"{sorted(os.listdir(tsdf_dir))}")
        inst = sorted(os.listdir(os.path.join(data, "scannet_instance_data")))
        with open(os.path.join(data, "scannet_infos_train.pkl"), "rb") as f:
            infos = pickle.load(f)
        if (len(inst) != 6 or [i["scene"] for i in infos] != [scene]
                or len(infos[0]["total_image_ids"]) != PREP_FRAMES
                or infos[0]["annos"]["gt_num"] != 4):
            got = [(i["scene"], len(i["total_image_ids"]),
                    i["annos"]["gt_num"]) for i in infos]
            raise AssertionError(f"[prep] instance data {inst}, infos "
                                 f"(scene, frames, boxes) {got}")
        for name in ("tsdf_04", "tsdf_08", "tsdf_16"):
            with np.load(os.path.join(tsdf_dir, name + ".npz")) as z:
                t = z["tsdf"]
                log(f"[prep] {name}: {t.shape}, origin "
                    f"{np.round(z['origin'][0], 4).tolist()}, observed "
                    f"{(np.abs(t) < 1).mean():.4f}, free only "
                    f"{(t == -1).mean():.4f}, unseen {(t == 1).mean():.4f}")
                if not np.isfinite(t).all():
                    raise AssertionError(f"[prep] {name} not finite")

        train = os.path.join(data, "scannet_infos_train.pkl")
        records, _, launches, _ = _run_train_cli(
            [CLI_CONFIG, "--work-dir", os.path.join(root, "s3"),
             "--max-steps", "1", "--cfg-options",
             f"data.train.data_root={data}", f"data.train.ann_file={train}",
             "log_config.interval=1"], counters, 1, "prep stage 3")
        if launches != {"volume_accum": 1, "volume_accum_bwd": 1,
                        "ray_march": 1}:
            raise AssertionError(f"[prep] the stage-3 step must launch K1, "
                                 f"K1b and K2 once: {launches}")

        _prep_fusion(dev, cons, scene, on)
        extent = np.asarray(PREP_TSDF_DIM, np.float64) * 0.04
        boxes = room_boxes(extent)
        shares = {}
        for route, base in (("consistent", data), ("F17", f17)):
            with np.load(os.path.join(base, "atlas_tsdf", scene,
                                      "tsdf_04.npz")) as z:
                shares[route] = fused_sign_agreement(
                    z["tsdf"], z["origin"][0], 0.04, extent, boxes)
            log(f"[prep] {route} route at 4 cm: {shares[route][0]:.4f} of "
                f"{shares[route][1]} observed voxels agree in sign with the "
                f"planted room")
        if shares["consistent"][0] < PREP_SIGN_BOUND:
            raise AssertionError(f"[prep] the consistent route's sign "
                                 f"agreement {shares['consistent'][0]} is "
                                 f"under {PREP_SIGN_BOUND}")
        log(f"[prep] phase took {time.perf_counter() - t_phase:.1f} s {on}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# steps, each on both rooms as one batch (cut from 80 to pay for the batch
# phase's time; both modes pass at 70 on the CPU and at 80 on the card,
# PERF.md)
LEARN_STEPS = 70
LEARN_ROOMS = 2
# the detector-only check's steps: the fewest multiple of 50 at which the
# card's deterministic run passes the JAX tool's rule (it passes at every
# reading from 150 to 300, and at 1000).  The margin against another
# summation order is small: with the order free, no run of four passed
# before 250 and one stayed on the loss plateau to 350 (PERF.md), so a
# change of that order reads this again (``overfit_check --score-every``)
CHECK_STEPS = 150
# the learning checks run in child processes (``chip_smoke.py
# --learn-child``), all host-bound at these sizes: the detector-only one
# from the start of ``arkit`` on, the whole model's two from the start of
# ``prep`` on, each read in ``learn``; so the seconds of those phases and
# of the checks' steps are shared ones
SHARED = "beside the learning checks' children: a shared host"


def phase_learn(children) -> None:
    """The learning checks on the card, read from their ``children``
    (``_start_learn``).  The whole-model one: ``python -m
    cnrma_torch.tools.overfit_full --steps LEARN_STEPS``, ScanNet-style
    (``full``) and ``--yaw`` (``full --yaw``), its two rooms as one batch,
    each in a child of its own that counts its launches from 0 (K1, K1b
    and K2 once a room a training step; K1 and K2 once a scored room);
    fails unless the tool's PASS rule holds.  Then the detector-only one
    (``check``, ``_learn_detector``)."""
    for tag in ("full", "full --yaw"):
        out, wall, _ = _learn_result(f"learn {tag}", children[tag])
        launches = out["launches"]
        steps = out["steps"]
        log(f"[learn {tag}] {steps} steps (two rooms a step) in {wall:.1f} "
            f"s, a child process ({SHARED}): total loss "
            f"{out['first']:.4f} -> {out['final']:.4f}, recon "
            f"{out['first_recon']:.4f} -> {out['final_recon']:.4f}; "
            f"mAP@0.25 {out['mAP_0.25']:.4f}, mAP@0.50 "
            f"{out['mAP_0.50']:.4f}; {out['step_s']:.4f} s a step, peak "
            f"memory {out['peak_gib']:.2f} GiB; launches {launches}; "
            f"PASS {out['ok']}")
        n = LEARN_ROOMS
        if launches != {"volume_accum": n * steps + n, "volume_accum_sum": 0,
                        "volume_accum_bwd": n * steps,
                        "ray_march": n * steps + n}:
            raise AssertionError(f"[learn {tag}] each step must launch K1, "
                                 f"K1b and K2 once a room, each scored room "
                                 f"K1 and K2: {launches}")
        if not out["ok"]:
            raise AssertionError(f"[learn {tag}] the learning check failed "
                                 f"its rule (total < 0.6 x first, recon < "
                                 f"0.5 x first, mAP@0.25 >= 0.5)")
    _learn_detector(children["check"])


def _start_learn(tool: str, argv, env=None):
    """Start ``chip_smoke.py --learn-child OUT TOOL ARGV``: ``run(ARGV)``
    of ``cnrma_torch.tools.TOOL`` in a child process with ``env`` added
    to its environment.  Returns the process, the file its result goes to
    and its start time; ``_stop_learn`` ends it."""
    os.makedirs("build", exist_ok=True)
    out = os.path.join(tempfile.mkdtemp(prefix="learn_", dir="build"),
                       "result.json")
    with open(out + ".log", "w") as log_file:     # the child keeps its own
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--learn-child",
             out, tool, *argv], stdout=log_file, stderr=subprocess.STDOUT,
            env=dict(os.environ, **(env or {})))
    return proc, out, time.perf_counter()


def _stop_learn(child) -> None:
    """Kill ``_start_learn``'s child if it still runs, and remove its
    files."""
    proc, out, _ = child
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    shutil.rmtree(os.path.dirname(out), ignore_errors=True)


def _learn_child(out: str, tool: str, argv) -> int:
    """``chip_smoke.py --learn-child OUT TOOL ARGV``: ``run(ARGV)`` of
    ``cnrma_torch.tools.TOOL`` in this process, then its result and the
    launches of K1, K1's sum mode, K1b and K2 it made to the file
    ``OUT``."""
    import importlib
    counters = _kernel_counters()
    result = importlib.import_module(f"cnrma_torch.tools.{tool}").run(argv)
    result["launches"] = _counts(counters)
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


def _learn_result(tag: str, child):
    """A ``_start_learn`` child's result, its wall seconds from its start
    and its output, once it has ended (killed after 900 s)."""
    proc, out, t0 = child
    try:
        proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    wall = time.perf_counter() - t0
    with open(out + ".log") as f:
        text = f.read()
    if proc.returncode != 0 or not os.path.isfile(out):
        raise AssertionError(f"[{tag}] the child failed "
                             f"({proc.returncode}):\n{text[-4000:]}")
    with open(out) as f:
        return json.load(f), wall, text


def _learn_detector(child) -> None:
    """The detector-only learning check's child read back: its loss curve,
    mAP, seconds a step (beside the other work of its time, and with the
    capacity reads), peak memory and each capacity site's largest fill; no
    volume or march kernel; fails unless the JAX tool's PASS rule holds
    (final loss < 0.5 x the first, mAP@0.25 >= 0.5)."""
    res, wall, text = _learn_result("learn check", child)
    launches = res["launches"]
    log(f"[learn check] overfit_check --steps {res['steps']} (two scenes a "
        f"step; a child process beside the arkit, prep and learn phases, on "
        f"a shared host) in {wall:.1f} s: loss every 10 "
        f"steps " + " ".join(f"{v:.3f}" for v in res["losses"][::10])
        + f"; {res['first']:.4f} -> {res['final']:.4f}; mAP@0.25 "
        f"{res['mAP_0.25']:.4f}, mAP@0.50 {res['mAP_0.50']:.4f}; "
        f"{res['step_s']:.4f} s a step, peak memory {res['peak_gib']:.3f} "
        f"GiB; launches {launches}; PASS {res['ok']} ({card()})")
    for line in text.splitlines():
        if line.startswith(("  pred", "  gt", "loss ", "overfit check")):
            log(f"[learn check] {line}")
    log("[learn check] largest capacity fills: " + ", ".join(
        f"{k} {n}/{cap}" for k, (n, cap) in res["fills"].items()))
    if any(launches.values()) or not res["fills"]:
        raise AssertionError(f"[learn check] the detector-only check "
                             f"launches no volume or march kernel and "
                             f"reports its capacities: {launches}")
    if not res["ok"]:
        raise AssertionError("[learn check] the detector-only learning "
                             "check failed its rule (final < 0.5 x first, "
                             "mAP@0.25 >= 0.5)")


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


def phase_device_time(dev, rows, probe_calls, shape_calls) -> None:
    """Each kernel's device time per call (``device_ms``), and its library
    call's where there is one, from profiler traces; K1 and K2 on the bf16
    volume and the ray-march scene of their phases, inputs made again here
    so that no phase before holds them (K1's fp32 time is logged beside
    its bf16 row).  The launch floor (``floor_ms``, the device time of the
    empty kernel) goes on every row.  Then ``shape_calls``, the main-path
    kernels at the other shapes the phases drive (K1b at stage 1's crop;
    K1, K2 and K1b at ARKit's), logged beside the floor and, for K1b,
    beside ``index_add_``'s device time on the same inputs.  Last of all: once
    a profiler session
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
    bwd = volume_bwd_args(dev, torch.float32)
    calls = [("volume_accum_kernel", lambda: bp.volume_accum_cuda(*vol),
              None),
             ("volume_accum_kernel",
              lambda: bp.volume_accum_cuda(*vol, write_sum=True), None),
             ("ray_march_kernel", lambda: rm.march_rays_cuda(*rays), None),
             ("volume_accum_bwd_kernel",
              lambda: bp.volume_accum_bwd_cuda(*bwd),
              index_add_library(bwd)),
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
    del vol, rays, bwd, calls
    for label, symbol, make, call, library in shape_calls:
        args = make()
        ms = device_ms(lambda: call(args), symbol)
        ratio = f", {ms / floor:.2f}x the floor" if ms and floor else ""
        lib = ("" if library is None else
               f", library (index_add_) {fmt_ms(device_ms(library(args)))}")
        log(f"[device time] {label}: kernel {fmt_ms(ms)}{ratio}{lib}")
        del args
        torch.cuda.empty_cache()


def _timed(tag: str, fn, *args):
    """``fn(*args)``, then a line with its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[seconds] phase {tag}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    t_script = time.perf_counter()
    name = _timed("device", phase_device)
    dev = torch.device("cuda", 0)
    _timed("build", phase_build)
    vol = _timed("volume", phase_volume, dev)
    vol_sum = _timed("volume sum", phase_volume_sum, dev)
    ray = _timed("ray march", phase_ray_march, dev)
    launches, model, batch = _timed("end to end", phase_end_to_end, dev)
    _timed("surface", phase_surface, dev, model, batch)
    _timed("depth", phase_depth, dev, model, batch)
    del model, batch
    _timed("reference", phase_reference, dev)
    _timed("test cli", phase_test_cli, dev)
    bwd = _timed("volume backward", phase_volume_backward, dev)
    _timed("train reference", phase_train_reference, dev)
    train_launches = _timed("train cli", phase_train_cli, dev)
    stage1_calls = _timed("stages, ddp, batch", phase_three_stages, dev)
    # the learning checks, host-bound, run in children (``SHARED``)
    children = {"check": _start_learn("overfit_check", [
        "--steps", str(CHECK_STEPS)], {"CNRMA_CAPACITY_DEBUG": "1"})}
    log(f"[learn check] started; the arkit, prep and learn phases run "
        f"{SHARED}")
    try:
        arkit_calls = _timed(f"arkit ({SHARED})", phase_arkit, dev)
        for flags in ([], ["--yaw"]):
            children[" ".join(["full", *flags])] = _start_learn(
                "overfit_full", ["--steps", str(LEARN_STEPS), *flags])
        _timed(f"prep ({SHARED})", phase_prep, dev)
        _timed(f"learn ({SHARED})", phase_learn, children)
    finally:
        for child in children.values():
            _stop_learn(child)
    probes, probe_calls = _timed("probes", phase_probes, dev)
    kernels = [
        dict(name="volume_accum", route="cuda",
             source="cnrma_torch/csrc/volume_accum.cu",
             replaces="cnrma_tpu/ops/pallas_bp.py:140",
             launches=launches["volume_accum"], **vol, library_ms=None),
        dict(name="volume_accum (sum mode)", route="cuda",
             source="cnrma_torch/csrc/volume_accum.cu",
             replaces="cnrma_tpu/ops/pallas_bp.py:140",
             launches=VIEW_REPORT["launches"]["volume_accum_sum"],
             **vol_sum, library_ms=None),
        dict(name="ray_march", route="cuda",
             source="cnrma_torch/csrc/ray_march.cu",
             replaces="cnrma_tpu/ops/pallas_ray.py:108",
             launches=launches["ray_march"], **ray, library_ms=None),
        dict(name="volume_accum_bwd", route="cuda",
             source="cnrma_torch/csrc/volume_accum_bwd.cu",
             replaces="cnrma_tpu/ops/backproject.py:302",
             launches=train_launches["volume_accum_bwd"], **bwd),
        *probes,
    ]
    _timed("device time", phase_device_time, dev, kernels, probe_calls,
           stage1_calls + arkit_calls)
    log(f"[script] every phase passed in "
        f"{time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-child"]:
        sys.exit(_train_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--learn-child"]:
        sys.exit(_learn_child(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
