"""The test forward: ``CNRMA.forward`` of the config's test model under
``torch.no_grad()``, one scene a call, its outputs synchronised, as
``tools/test.py`` runs it; the march given the scene's planted room.

After the window, ``judge`` holds what the window produced for a sample
of the pool's scenes against the reference:

* ``tsdf_err``: the fine TSDF (tower, volume, U-Net and head), the
  reference's from the same images and weights;
* ``cloud_err``: the detector's input cloud (points and weighted
  features), each point keyed by its march sample (view, pixel, sample),
  against the reference's own cloud: its march of the same planted TSDF,
  its subsample by the same draw and its own features, so that the march
  and the subsample are held with the features; a sample one side keeps
  and the other not counts in full;
* ``det_err``: every level's centerness, box distances and class logits,
  keyed by voxel, against the reference detector's on the program's
  cloud (the cloud's 500,000 points reorder under ulp-level changes, so
  the reference follows the program's cloud; the cloud itself is held
  by ``cloud_err``);
* ``score_err``: each level's top ``nms_pre`` best class scores, sorted,
  against the reference's ``get_bboxes`` on its own levels.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from cnrma_torch.timing import mark
from port_bench.lib import compare, harness, weights, work
from port_bench.reference import build as ref_build
from port_bench.reference.models import cn_rma as ref_cn_rma
from port_bench.reference.ops import ray_marching as ref_rm
from port_bench.reference.ops.ray_marching import RayMarchPoints
from port_bench.traffic import rooms

N_SAMPLE = 3


class Entry:
    first_index = 0

    def __init__(self, cell: harness.Cell):
        from cnrma_torch.core.builder import build_model
        self.cell = cell
        dev = cell.device
        self.m = cell.config["model"]
        self.keys = cell.workload["batch_keys"]
        model = build_model(cell.config, mode="test").to(dev)
        weights.load(model, weights.make_state(model, cell.seed, dev))
        self.fine_key = f"scene_tsdf_{model.tsdf_head.keys[-1]}"
        self.holder: Dict[str, torch.Tensor] = {}
        harness.plant(model, self.holder)
        self._capturing = False
        self._march = self._levels = None
        orig_march, orig_boxes = model._march, model.detector.get_bboxes

        def _march(*a, **k):
            out = orig_march(*a, **k)
            if self._capturing:
                self._march = out
            return out

        def get_bboxes(level_outs):
            if self._capturing:
                self._levels = level_outs
            return orig_boxes(level_outs)
        model._march, model.detector.get_bboxes = _march, get_bboxes
        self.model = model
        harness.log("model built")
        self.pool = rooms.make_pool(cell.mix, cell.config, "test", cell.seed,
                                    dev, pin=dev.type == "cuda")
        harness.log("pool made")
        self.sampled = cell.sample(N_SAMPLE, len(self.pool))
        self.copies: Dict[int, harness.HostCopy] = {}
        # warm-up: the sampled scenes, which also sizes their host copies
        for s in self.sampled:
            self.run_scene(s)
        harness.log("warmed up")
        first = self.outputs(self.sampled[0])
        xyz, valid = first["cloud"][0], first["cloud"][2].bool()
        self.kept = int(valid.sum())
        occupied = int(torch.unique(torch.floor(xyz[valid] / 0.01).long(),
                                    dim=0).shape[0]) if self.kept else 0
        print(f"[march] scene {self.sampled[0]}: kept points {self.kept}, "
              f"occupied 1 cm voxels {occupied}, GT boxes "
              f"{self.pool[self.sampled[0]]['n_boxes']}, valid output boxes "
              f"{int(first['bvalid'].sum())}", flush=True)
        if self.kept == 0:
            raise SystemExit("the march kept no point: the traffic would "
                             "bypass the march and the detector")

    def step(self, i: int) -> int:
        s = i % len(self.pool)
        self.run_scene(s)
        return s

    def run_scene(self, s: int) -> None:
        dev = self.cell.device
        b = rooms.to_device(self.pool[s], dev)
        mark("copy")
        self.holder["planted"] = b["planted"][None]
        self._capturing = s in self.sampled
        out = self.model(harness.batch_of(b, self.keys), uniform=b["uniform"])
        mark("march_detect")
        if self._capturing:
            tensors = self._flat(out)
            if s not in self.copies:
                self.copies[s] = harness.HostCopy(tensors)
            self.copies[s].fill(tensors)
            self._march = self._levels = None
            self._capturing = False
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _flat(self, out) -> List[torch.Tensor]:
        pts = out["points"]
        levels = [t[0] for lv in self._levels for t in lv]
        return ([out["tsdf"][self.fine_key][0]] + list(self._march)
                + [pts.xyz[0], pts.feats[0], pts.valid[0]] + levels
                + [out["bboxes"][0], out["scores"][0], out["bbox_valid"][0]])

    def outputs(self, s: int) -> Dict[str, Any]:
        """The sampled scene's outputs of its last call, as host tensors."""
        b = self.copies[s].bufs
        n_lv = (len(b) - 11) // 5
        return {"tsdf": b[0], "march": b[1:5], "cloud": b[5:8],
                "levels": [b[8 + 5 * i:13 + 5 * i] for i in range(n_lv)],
                "bboxes": b[-3], "scores": b[-2], "bvalid": b[-1]}

    def free(self) -> None:
        self.model = None
        self.holder.clear()

    # -- the reference ----------------------------------------------------
    def reference(self, tf32: bool = False):
        dev = self.cell.device
        ref = ref_build.build_model(self.cell.config, mode="test").to(dev)
        weights.load(ref, weights.make_state(ref, self.cell.seed, dev))
        holder: Dict[str, torch.Tensor] = {}
        harness.plant(ref, holder)
        return ref, holder

    def judge(self) -> Dict[str, float]:
        ref, holder = self.reference()
        numbers: Dict[str, float] = {}
        for s in self.sampled:
            got = self.judge_scene(ref, holder, s, self.outputs(s))
            for k, v in got.items():
                numbers[k] = max(numbers.get(k, 0.0), v)
        return numbers

    @torch.no_grad()
    def reference_outputs(self, ref, holder, s: int) -> Dict[str, Any]:
        """The reference's own outputs of scene ``s`` in the program's
        structure: the control's, when it runs in a lower precision."""
        b = rooms.to_device(self.pool[s], self.cell.device)
        holder["planted"] = b["planted"][None]
        box = {}
        orig = ref.detector.get_bboxes

        def get_bboxes(level_outs):
            box["levels"] = level_outs
            return orig(level_outs)
        marches = []
        orig_march = ref._march

        def _march(*a, **k):
            marches.append(orig_march(*a, **k))
            return marches[-1]
        ref.detector.get_bboxes, ref._march = get_bboxes, _march
        try:
            out = ref(harness.batch_of(b, self.keys), uniform=b["uniform"])
        finally:
            del ref.detector.get_bboxes, ref._march
        pts = out["points"]
        return {"tsdf": out["tsdf"][self.fine_key][0],
                "march": list(marches[0]),
                "cloud": [pts.xyz[0], pts.feats[0], pts.valid[0]],
                "levels": [[t[0] for t in lv] for lv in box["levels"]],
                "bboxes": out["bboxes"][0], "scores": out["scores"][0],
                "bvalid": out["bbox_valid"][0]}

    @torch.no_grad()
    def judge_scene(self, ref, holder, s: int, got: Dict[str, Any]
                    ) -> Dict[str, float]:
        dev, m = self.cell.device, self.m
        got = {k: ([[t.to(dev) for t in lv] for lv in v] if k == "levels"
                   else [t.to(dev) for t in v] if isinstance(v, list)
                   else v.to(dev)) for k, v in got.items()}
        b = rooms.to_device(self.pool[s], dev)
        planted = b["planted"]
        batch = harness.batch_of(b, self.keys)
        feats, vv, tsdf = ref.reconstruct_views(batch)
        out = {"tsdf_err": compare.rel_rms(got["tsdf"],
                                           tsdf[self.fine_key][0])}
        del tsdf
        proj = ref._scaled_projections(batch["projection"])[0]
        h, w = feats.shape[2:4]
        o, d = ref_rm.get_ray_parameters(proj, h, w)
        n_samples = int(m["ray_samples"])
        t_one = ref_rm._t_one(planted.shape, float(m["voxel_size"]),
                              n_samples)

        def keys(p: RayMarchPoints) -> torch.Tensor:
            return compare.sample_keys(p.xyz, p.uv, p.view, o, d, t_one, w,
                                       n_samples)
        uniform, cap = b["uniform"][0], int(m["max_points"])
        # the reference's own cloud: its march of the planted TSDF, its
        # subsample by the same draw, its own features
        march = ref._march(proj, planted, vv[0], h, w)
        rx, rw, ruv, rview, rvalid = ref_cn_rma._normalize_subsample(
            RayMarchPoints(*(f.flatten(0, 1) for f in march)), cap, None,
            uniform)
        rf = ref_cn_rma._gather_point_feats(feats[0], ruv, rview,
                                            rvalid) * rw[:, None]
        kr = keys(RayMarchPoints(rx[rvalid], rw[rvalid], ruv[rvalid],
                                 rview[rvalid]))
        del march
        # the program's cloud, each point keyed by the sample of the
        # program's march that the same draw puts at its row
        pm = RayMarchPoints(*(f.flatten(0, 1) for f in got["march"]))
        order = torch.argsort(torch.where(pm.weight > 0, uniform, torch.inf),
                              stable=True)[:cap]
        gx, gf, gv = got["cloud"]
        gv = gv.bool()
        at = order[gv]
        kp = keys(RayMarchPoints(pm.xyz[at], pm.weight[at], pm.uv[at],
                                 pm.view[at]))
        out["cloud_err"] = max(
            compare.keyed_rel_rms([(kp, gx[gv] - batch["offset"][0], kr,
                                    rx[rvalid])]),
            compare.keyed_rel_rms([(kp, gf[gv], kr, rf[rvalid])]))
        del feats, rx, rf, pm
        levels = ref.detector(gx[None], gf[None], gv[None])
        vsz = float(m["voxel_size_fcaf3d"])
        out["det_err"] = compare.keyed_rel_rms([
            (*compare.level_rows(g, vsz),
             *compare.level_rows([t[0] for t in r], vsz))
            for g, r in zip(got["levels"], levels)])
        _, scores, bvalid = ref.detector.get_bboxes(levels)
        per_level = [min(ref.detector.nms_pre, lv.valid.shape[1])
                     for lv in levels]
        out["score_err"] = compare.rel_rms(
            compare.sorted_scores(got["scores"], got["bvalid"], per_level),
            compare.sorted_scores(scores[0], bvalid[0], per_level))
        return out

    # -- the work of the traced window --------------------------------------
    @torch.no_grad()
    def work(self, scenes: List[int]) -> Dict[str, float]:
        """Model FLOPs and the kernels' least times (seconds), summed over
        the scenes the traced window ran."""
        ref, holder = self.reference()
        m, dev = self.m, self.cell.device
        per: Dict[int, Dict[str, float]] = {}
        dims = tuple(m["voxel_dim_test"])
        vs = float(m["voxel_size"])
        stride = int(m["backbone2d_stride"])
        for s in sorted(set(scenes)):
            b = rooms.to_device(self.pool[s], dev)
            holder["planted"] = b["planted"][None]
            counter = work.FlopCounter()
            with counter.counting(ref):
                ref(harness.batch_of(b, self.keys), uniform=b["uniform"])
            proj = ref._scaled_projections(b["projection"])[0]
            h, w = (n // stride for n in self.cell.config["image_hw"])
            vv = torch.ones(proj.shape[0], dtype=torch.bool, device=dev)
            from port_bench.lib.device import bound_s
            k1 = bound_s(*work.volume_work(proj, vv, dims, vs, (0, 0, 0), h,
                                           w))
            k2 = bound_s(*work.ray_work(
                proj, vv, b["planted"], vs, (0, 0, 0), h, w,
                int(m["ray_samples"]), float(m["neus_threshold"]),
                int(m.get("ray_skip_factor", 8)),
                int(m.get("ray_skip_window", 48)),
                int(m.get("ray_skip_coarse_step", 8))))
            per[s] = {"flops": counter.total, "volume_accum_kernel": k1,
                      "ray_march_kernel": k2}
        keys = per[scenes[0]].keys() if scenes else ()
        return {k: sum(per[s][k] for s in scenes) for k in keys}
