"""A run of each cell at a tiny size on the CPU, the look for a card
skipped: the last line's schema, the port held equal to the reference,
each fault that the cell can have turning ``correct`` false, the cell's
files against ``BENCHMARK.json``, and no JAX module loaded."""

import importlib
import json
import os
import re
import subprocess
import sys
from unittest import mock

import pytest
import torch

from port_bench.lib import harness
from port_bench.tests._tiny import run_tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = harness.load_json(ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
# every cell the harness has files for, those not in the manifest too
FILES = sorted(os.path.splitext(f)[0] for f in os.listdir(
    os.path.join(ROOT, "port_bench", "workloads")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _last_line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("workload", FILES)
def test_last_line_and_parity(workload, capsys):
    result = run_tiny(workload)
    line = _last_line(capsys)
    assert line == json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    wl = harness.load_json(ROOT, "port_bench", "workloads",
                           f"{workload}.json")
    assert set(line["metrics"]) == set(wl["end_to_end"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            m["unit"] == "GiB"
    assert line["attempted"] >= 1 and line["failed"] == 0
    # the port's plain paths on the CPU against the reference's copy
    assert line["correct"] is True
    for name, check in line["checks"].items():
        assert check["value"] <= 1e-6, name


def _perturb_tsdf(orig):
    def forward(self, *a, **k):
        out = orig(self, *a, **k)
        return {key: v + 1e-2 * v.abs().mean() for key, v in out.items()}
    return forward


def _perturb_levels(orig):
    def forward(self, *a, **k):
        levels = orig(self, *a, **k)
        return [lv._replace(cls_scores=lv.cls_scores * 1.01) for lv in levels]
    return forward


def _frozen_step(orig):
    def step(self, grads):
        before = {n: p.detach().clone() for n, p in self.params.items()}
        norm = orig(self, grads)
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(before[n])
        return norm
    return step


def _half_views(orig):
    def forward_train(self, batch, *a, **k):
        h = (batch["imgs"].shape[1] + 1) // 2
        half = dict(batch, imgs=batch["imgs"][:, :h],
                    projection=batch["projection"][:, :h])
        if k.get("uniform") is not None:
            k["uniform"] = k["uniform"][:, :h * self.rays_per_view_cap]
        return orig(self, half, *a, **k)
    return forward_train


def _half_points(orig):
    def forward_train(self, batch, *a, **k):
        valid = batch["point_valid"].clone()
        valid[:, ::2] = False
        return orig(self, dict(batch, point_valid=valid), *a, **k)
    return forward_train


FAULTS = {
    "scannet.test.room": {
        "tsdf_altered": ("cnrma_torch.models.tsdf_head", "TSDFHead",
                         "forward", _perturb_tsdf),
        "scores_altered": ("cnrma_torch.models.fcaf3d", "FCAF3DHeadNet",
                           "forward", _perturb_levels),
    },
    "fcaf3d.train.room": {
        "state_unchanged": ("cnrma_torch.train.optim", "Optimizer", "step",
                            _frozen_step),
        "half_the_batch": ("cnrma_torch.models.fcaf3d_only", "FCAF3DOnly",
                           "forward_train", _half_points),
    },
    "scannet.train.room": {
        "state_unchanged": ("cnrma_torch.train.optim", "Optimizer", "step",
                            _frozen_step),
        "half_the_batch": ("cnrma_torch.models.cn_rma", "CNRMA",
                           "forward_train", _half_views),
    },
}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in FILES for f in FAULTS[w]])
def test_a_fault_is_not_correct(workload, fault):
    module, cls, attr, wrap = FAULTS[workload][fault]
    owner = getattr(importlib.import_module(module), cls)
    with mock.patch.object(owner, attr, wrap(getattr(owner, attr))):
        result = run_tiny(workload, seed=2 ** 31 + 101)
    assert result["correct"] is False
    failing = [k for k, c in result["checks"].items()
               if not c["value"] <= c["limit"]]
    assert failing, result["checks"]


def test_files_match_the_manifest():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        wl = harness.load_json(ROOT, "port_bench", "workloads",
                               f"{w['name']}.json")
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert wl["chips"] == w["chips"]
        assert wl["why"] == w["why"]
        assert "setup_s" in wl["end_to_end"] and len(wl["end_to_end"]) >= 2
        for name in wl["end_to_end"]:
            assert w["name"] in e2e[name].get("workloads", CELLS)
        assert wl["per_layer"]
        for name in wl["per_layer"]:
            spec = per_layer[name]
            assert w["name"] in spec["workloads"]
            assert spec["moves"] in wl["end_to_end"]
            mod = importlib.import_module(
                "port_bench.metrics." + name.replace(".", "_"))
            assert mod.MOVES == spec["moves"]
            assert mod.UNIT == spec["unit"]
    for name, spec in per_layer.items():
        # a metric's file names the cells it was written for; a later
        # cell that reports it is listed in the manifest alone
        mod = importlib.import_module(
            "port_bench.metrics." + name.replace(".", "_"))
        assert set(mod.WORKLOADS) <= set(spec["workloads"])
        for cell in spec["workloads"]:
            wl = harness.load_json(ROOT, "port_bench", "workloads",
                                   f"{cell}.json")
            assert name in wl["per_layer"]
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        cfg = harness.load_json(ROOT, c["file"])
        assert cfg["reduced"] == c["reduced"]


def test_names_and_units_keep_the_rules():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


NO_JAX = """
import sys, torch
sys.path.insert(0, {root!r})
from port_bench.tests._tiny import run_tiny
run_tiny({workload!r})
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


@pytest.mark.parametrize("workload", ["scannet.test.room",
                                      "fcaf3d.train.room"])
def test_a_rehearsal_loads_no_jax(workload):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", NO_JAX.format(root=ROOT, workload=workload)],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "cnrma_torch" in loaded and "port_bench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "cnrma_tpu"}
