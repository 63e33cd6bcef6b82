"""The JAX reference's own spread between host settings, on the inputs of
the port's parity tests whose limits rest on it (ROADMAP F22).

The reference rounds otherwise from host to host: its TSDF resample maps
the grid with numpy's ``@`` (an OpenBLAS sgemm whose kernel the CPU picks)
and XLA:CPU compiles for the CPU's widest vector ISA.  This script runs
the parity tests in child processes, once under the host's defaults and
once under each other setting, records what the reference computed there,
and prints the spread:

* the resample
  (``test_torch_postprocess.py::test_tsdf_mesh_resample_and_ply`` and
  ``test_torch_stages.py::test_recon_reader_matches_jax``), defaults
  against ``OPENBLAS_CORETYPE=Sandybridge``: for each JAX resample, the
  voxels that differ, the largest difference, that difference in units of
  one ulp of the farthest sample position times the source volume's
  largest neighbour step (``resample_failures``' unit), the sample
  positions' largest difference in ulps, and the voxels whose nearest
  pick changed;
* the forms of the port's affine tried against the reference's grid map
  (the rotated grid of the postprocess case) under each kernel: the
  share of coordinates where each form differs from the reference;
* the training steps (``test_torch_train.py::test_train_step_matches_jax``
  and ``test_torch_stages.py::test_atlas_train_step_matches_jax``),
  defaults against ``XLA_FLAGS=--xla_cpu_max_isa=AVX2``: each gradient
  leaf outside the R-50 trunk whose spread exceeds 5e-4 of its largest
  magnitude, and the trunk's relative L2 spread.

Run from the repository's root, on the CPU (a few minutes; the children
write up to 2 GB under ``--out``, deleted at the end)::

    JAX_PLATFORMS=cpu python tests/torch_host_spread.py [--out DIR]

It is also the pytest plugin its children load (``-p torch_host_spread``).
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PATH = os.pathsep.join([HERE, os.path.dirname(HERE)])
RESAMPLE_TESTS = ["tests/test_torch_postprocess.py::"
                  "test_tsdf_mesh_resample_and_ply",
                  "tests/test_torch_stages.py::test_recon_reader_matches_jax"]
STEP_TESTS = ["tests/test_torch_train.py::test_train_step_matches_jax",
              "tests/test_torch_stages.py::test_atlas_train_step_matches_jax"]
BLAS_OTHER = {"OPENBLAS_CORETYPE": "Sandybridge"}
ISA_OTHER = {"XLA_FLAGS": "--xla_cpu_max_isa=AVX2"}
_OUT = "TORCH_HOST_SPREAD_OUT"


# --- the plugin: what the children record ------------------------------------

def _save(kind, **arrays):
    out = os.environ[_OUT]
    n = len([f for f in os.listdir(out) if f.startswith(kind)])
    np.savez(os.path.join(out, f"{kind}_{n:03d}.npz"), **arrays)


def pytest_sessionstart(session):
    """Record each JAX resample (output, sample positions, source volume)
    and each step test's JAX gradients, in call order."""
    if _OUT not in os.environ:
        return
    sys.path.insert(0, HERE)
    from cnrma_tpu.geometry import tsdf as j_tsdf
    import test_torch_train as ttt
    real_nearest = j_tsdf.TSDF._sample_nearest
    real_transform = j_tsdf.TSDF.transform
    seen = []

    def nearest(self, sample):
        seen.append((np.array(sample, np.float64), self.tsdf_vol))
        return real_nearest(self, sample)

    def transform(self, *args, **kw):
        seen.clear()
        out = real_transform(self, *args, **kw)
        sample, vol = seen[-1]
        _save("resample", out=out.tsdf_vol, sample=sample, vol=vol)
        return out
    j_tsdf.TSDF._sample_nearest = nearest
    j_tsdf.TSDF.transform = transform
    real_readings = ttt._step_readings

    def readings(port, tb, kw, want, fault=None):
        import jax
        from cnrma_torch.bridge import _convert
        if fault is None:
            grads = {}
            for path, g in jax.tree_util.tree_leaves_with_path(
                    want["grads"]):
                key, arr = _convert("params", ttt._path(path), np.asarray(g))
                grads[key] = arr
            _save("step", **grads)
        return real_readings(port, tb, kw, want, fault)
    ttt._step_readings = readings


def _forms(out):
    """The postprocess case's rotated grid mapped by the reference's
    ``@`` and by each form of the port's affine, saved to ``out``."""
    import torch
    from test_torch_postprocess import rotated_case
    t, world = rotated_case()
    tt, w = torch.from_numpy(t), torch.from_numpy(world)
    cols = [tt[:, i:i + 1] * w[i] for i in range(4)]
    np.savez(out, reference=t @ world, torch_matmul=(tt @ w).numpy(),
             products_and_sums=(cols[0] + cols[1] + cols[2]
                                + cols[3]).numpy(),
             addcmul_chain=torch.addcmul(torch.addcmul(torch.addcmul(
                 cols[3], tt[:, 2:3], w[2]), tt[:, 1:2], w[1]),
                 tt[:, 0:1], w[0]).numpy(),
             fp64_rounded=(tt.double() @ w.double()).float().numpy())


# --- the parent: children and comparison -------------------------------------

def affine_forms(root):
    """Print, under the defaults and ``BLAS_OTHER``, the share of the
    rotated grid's coordinates where each form of the affine differs from
    the reference's ``@``."""
    print("the affine's forms against the reference, share of coordinates "
          "that differ:")
    for tag, env in (("defaults", {}), (str(BLAS_OTHER), BLAS_OTHER)):
        out = os.path.join(root, f"forms_{len(tag)}.npz")
        subprocess.run([sys.executable, __file__, "--forms", out], check=True,
                       env=dict(os.environ, PYTHONPATH=PATH, **env))
        z = np.load(out)
        print(f"  {tag}: " + ", ".join(
            f"{k} {(z[k] != z['reference']).mean():.4f}"
            for k in z.files if k != "reference"))


def _child(tests, env, out):
    """Run ``tests`` in one child process with ``env`` added, recording
    into the fresh directory ``out``."""
    os.makedirs(out)
    e = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=PATH, **{_OUT: out},
             **env)
    subprocess.run([sys.executable, "-m", "pytest", "-q", "-p",
                    "no:cacheprovider", "-p", "no:randomly", "-p",
                    "torch_host_spread", *tests], env=e, check=False,
                   stdout=subprocess.DEVNULL)
    return sorted(os.path.join(out, f) for f in os.listdir(out))


def _ulp(x):
    return float(np.spacing(np.float32(np.abs(x).max())))


def resample_spread(root):
    """Print each JAX resample's spread, defaults against
    ``BLAS_OTHER``."""
    a = _child(RESAMPLE_TESTS, {}, os.path.join(root, "blas_default"))
    b = _child(RESAMPLE_TESTS, BLAS_OTHER, os.path.join(root, "blas_other"))
    assert a and len(a) == len(b), (len(a), len(b))
    print(f"resample: defaults against {BLAS_OTHER}")
    for i, (fa, fb) in enumerate(zip(a, b)):
        x, y = np.load(fa), np.load(fb)
        ulp = _ulp(x["sample"])
        vol = x["vol"].astype(np.float64)
        step = max(float(np.abs(np.diff(vol, axis=k)).max())
                   for k in range(vol.ndim))
        d = np.abs(x["out"].astype(np.float64) - y["out"])
        picks = (np.rint(x["sample"]) != np.rint(y["sample"])).any(0)
        print(f"  {i:2d} {x['out'].shape}: {int((d > 0).sum())} of {d.size} "
              f"voxels differ, up to {d.max():.3g} = "
              f"{d.max() / (ulp * step):.3f} ulp-steps (ulp {ulp:.3g} x "
              f"step {step:.4g}); samples up to "
              f"{np.abs(x['sample'] - y['sample']).max() / ulp:.1f} ulp "
              f"apart; {int(picks.sum())} nearest picks changed")


def step_spread(root):
    """Print each step's gradient spread, defaults against ``ISA_OTHER``:
    the leaves outside the trunk above 5e-4 of their largest, and the
    trunk's relative L2 spread."""
    a = _child(STEP_TESTS, {}, os.path.join(root, "isa_default"))
    b = _child(STEP_TESTS, ISA_OTHER, os.path.join(root, "isa_other"))
    assert a and len(a) == len(b), (len(a), len(b))
    print(f"steps: defaults against {ISA_OTHER}")
    for name, fa, fb in zip(("CNRMA", "Atlas"), a, b):
        x, y = np.load(fa), np.load(fb)
        rows, trunk = [], ([], [])
        for k in x.files:
            g, h = x[k].astype(np.float64), y[k].astype(np.float64)
            if k.startswith("tower2d.resnet."):
                trunk[0].append(g.ravel())
                trunk[1].append(h.ravel())
            else:
                rows.append((float(np.abs(g - h).max()
                                   / max(np.abs(g).max(), 1e-30)), k))
        g, h = np.concatenate(trunk[0]), np.concatenate(trunk[1])
        trunk_l2 = np.linalg.norm(g - h) / np.linalg.norm(g)
        print(f"  {name} step: the trunk {trunk_l2:.3g} relative L2; "
              "leaves above 5e-4 of their largest:")
        for spread, k in sorted(rows, reverse=True):
            if spread > 5e-4:
                print(f"    {spread:.4g} {k}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", help="directory for the children's records "
                   "(default: a temporary one); deleted at the end")
    p.add_argument("--forms", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.forms:
        return _forms(args.forms)
    root = tempfile.mkdtemp(dir=args.out)
    try:
        resample_spread(root)
        affine_forms(root)
        step_spread(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
