"""The port's probe tools (``cnrma_torch/tools``) against the JAX probes
(``tools/pallas_*_probe.py``), on the CPU, where each runs its plain torch
version.  Every comparison is exact (tolerance 0): the probes copy, gather,
or multiply small integers.

P1's plain version is held against the probe's own Pallas kernel in
interpret mode and against its numpy oracle.  The P2 and P3 Pallas kernels
are closures inside the probes' ``main``, which run only on a TPU; for them
the probes' own reference expressions stand in (``t_np[i_np, arange]``,
``table_flat[idx_flat]`` and the seven ``want``s), and P3's ``dot`` body is
restated in an interpret-mode ``pallas_call``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnrma_torch.ops import _build
from cnrma_torch.tools import (bp_probe, feature_probe, gather_probe,
                                trace_check)
from _torch_threads import _few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tpu_probe(name):
    spec = importlib.util.spec_from_file_location(
        f"tpu_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tpu_bp():
    return _load_tpu_probe("pallas_bp_probe")


def _torch_args(featq, ryq0, rx0, code):
    return (torch.from_numpy(np.asarray(featq, np.float32)).bfloat16(),
            *(torch.from_numpy(np.array(a)) for a in (ryq0, rx0, code)))


@pytest.mark.parametrize("tb", [1, 4])
def test_rect_gather_plain_matches_pallas_interpret(tpu_bp, tb):
    s = bp_probe.CHECK_SHAPE
    featq, ryq0, rx0, code = tpu_bp.synth(
        np.random.RandomState(0), s["Hq"], s["W"], s["Rhq"], s["Rw"], s["C"],
        s["t3"], s["K1"], jnp.bfloat16)
    run = tpu_bp.make_kernel(s["Hq"], s["W"], s["Rhq"], s["Rw"], s["C"],
                             s["t3"], s["K1"], jnp.bfloat16, jnp.bfloat16,
                             interpret=True, tb=tb)
    want = np.asarray(jax.jit(run)(ryq0, rx0, code, featq), np.float32)
    got = bp_probe.rect_gather(*_torch_args(featq, ryq0, rx0, code),
                               s["Rhq"], s["Rw"])
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.array_equal(got.float().numpy(), want)
    assert np.abs(want).sum() > 0


@pytest.mark.parametrize("case", ["unaligned_rx0", "all_invalid"])
def test_rect_gather_plain_matches_ref_gather(tpu_bp, case):
    s = bp_probe.CHECK_SHAPE
    featq, ryq0, rx0, code = bp_probe.synth(np.random.RandomState(1), **s,
                                            xalign=1)
    if case == "unaligned_rx0":
        assert (rx0 % bp_probe.XALIGN).any()
    else:
        code[:] = s["Rhq"] * s["Rw"] * bp_probe.PACK
        code[0, :4] = [-1, -4, 2 ** 30, -2 ** 31]
    args = _torch_args(featq, ryq0, rx0, code)
    got = bp_probe.rect_gather(*args, s["Rhq"], s["Rw"]).float().numpy()
    f32 = args[0].float().numpy()
    want = tpu_bp.ref_gather(f32, ryq0, rx0, code, s["Rhq"], s["Rw"], s["C"],
                             s["t3"])
    assert np.array_equal(got, want)
    assert np.array_equal(want, bp_probe.ref_gather(
        f32, ryq0, rx0, code, s["Rhq"], s["Rw"], s["C"], s["t3"]))
    assert (case == "all_invalid") == (not got.any())


def test_gather_probe_plain_matches_references():
    rows = 64
    rng = np.random.RandomState(0)
    flat, table2d, idx = gather_probe.tables(rng, "cpu", rows, 16 * 300)
    idx2d = gather_probe.lane_indices(rng, "cpu", rows)
    t_np, i_np = table2d.numpy(), idx2d.numpy()
    assert np.array_equal(gather_probe.lane_gather(table2d, idx2d).numpy(),
                          t_np[i_np, np.arange(128)[None, :]])
    assert np.array_equal(gather_probe.flat_gather(flat, idx).numpy(),
                          flat.numpy()[idx.numpy()])


def test_gather_probe_plain_out_of_range_is_zero():
    table = torch.arange(4 * 128, dtype=torch.float32).reshape(4, 128)
    idx2d = torch.full((2, 128), 4, dtype=torch.int32)
    idx2d[1] = -1
    idx2d[0, 5] = 3
    got = gather_probe.lane_gather(table, idx2d)
    assert got[0, 5] == table[3, 5] and got.sum() == table[3, 5]
    idx = torch.tensor([-1, 0, 511, 512], dtype=torch.int32)
    assert gather_probe.flat_gather(table, idx).tolist() == [0, 0, 511, 0]


@pytest.mark.parametrize("name", feature_probe.NAMES)
def test_feature_probe_plain_matches_want(name):
    args, want = feature_probe.probe_inputs(name, torch.device("cpu"))
    out = feature_probe.run(name, *args)
    assert out.dtype == torch.float32
    assert np.array_equal(out.numpy(), want)
    if name == "alias":
        assert out.data_ptr() == args[0].data_ptr()


def test_dot_plain_matches_pallas_interpret():
    """``dot_plain`` against the P3 probe's ``dot`` kernel body
    (``jnp.dot(..., preferred_element_type=jnp.float32)``, restated in a
    ``pl.pallas_call`` in interpret mode, since the probe's own runs only
    on a TPU), on random integers in [-4, 4] at the probe's shape: exact
    in fp32, and unlike the probe's all-ones input, a permuted row or
    column shows."""
    from jax.experimental import pallas as pl

    def kernel(a_ref, b_ref, o_ref):
        o_ref[:] = jnp.dot(a_ref[:], b_ref[:],
                           preferred_element_type=jnp.float32)
    rng = np.random.RandomState(0)
    a = rng.randint(-4, 5, (128, 256)).astype(np.float32)
    b = rng.randint(-4, 5, (256, 128)).astype(np.float32)
    want = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((128, 128), jnp.float32),
        interpret=True)(jnp.asarray(a, jnp.bfloat16),
                        jnp.asarray(b, jnp.bfloat16))
    got = feature_probe.run("dot", torch.from_numpy(a).bfloat16(),
                            torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.abs(np.asarray(want)).max() > 8


@pytest.mark.parametrize("tool,argv", [
    (bp_probe, ["check"]),
    (gather_probe, ["--rows", "64", "--rays", "16"]),
    (feature_probe, []),
], ids=["bp_probe", "gather_probe", "feature_probe"])
def test_probe_cli_on_cpu(tool, argv, capsys):
    assert tool.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and "False" not in out


def test_probe_cli_needs_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no CUDA device")
    for tool in (feature_probe, trace_check):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([])
    with pytest.raises(ValueError, match="no kernel for device"):
        bp_probe.rect_gather(torch.empty(1, 1, 128, device="meta"),
                             None, None, None, 1, 1)


WIDE = 2 ** 31 + 5        # an int64 index that narrowing would wrap to 5


def _wide_index_call(name):
    """A kernel wrapper given an int64 index of ``WIDE``: its arguments
    are otherwise ones it takes."""
    big = lambda *shape: torch.full(shape, WIDE, dtype=torch.int64)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    if name == "rect_gather":
        featq = torch.zeros(16, 48, 4 * bp_probe.C, dtype=torch.bfloat16)
        return lambda: bp_probe.rect_gather_cuda(featq, i32(2), i32(2),
                                                 big(2, 4), 8, 16)
    if name == "lane_gather":
        return lambda: gather_probe.lane_gather_cuda(torch.zeros(4, 128),
                                                     big(1, 128))
    if name == "flat_gather":
        return lambda: gather_probe.flat_gather_cuda(torch.zeros(4, 128),
                                                     big(3))
    if name == "onehot":
        tab = torch.zeros(4, 128, dtype=torch.bfloat16)
        return lambda: feature_probe.onehot_cuda(big(3), tab)
    if name == "prefetch":
        return lambda: feature_probe.prefetch_cuda(big(4),
                                                   torch.zeros(4, 8, 128))
    return lambda: feature_probe.dyn_slice_cuda(big(1), torch.zeros(64, 128),
                                                8)


@pytest.mark.parametrize("name", ["rect_gather", "lane_gather", "flat_gather",
                                  "onehot", "prefetch", "dyn_slice"])
def test_kernel_wrappers_refuse_wide_indices(name):
    """The kernels read int32 indices.  A wrapper refuses any other index
    type before it launches, rather than narrow an int64 that would wrap
    into range where the plain version gives 0."""
    with pytest.raises(TypeError, match="must be int32"):
        _wide_index_call(name)()


def test_onehot_takes_a_table_past_shared_memory(monkeypatch):
    """The direct row gather stages nothing, so ``onehot_cuda`` refuses no
    table on its size: a 2048 x 128 bf16 table (512 KB, past the 227 KB of
    shared memory a block may hold) goes to the launcher with its shape."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda fn, counter, dev, *args: calls.append(
                            (fn, args[3:])))
    tab = torch.zeros(2048, 128, dtype=torch.bfloat16)
    out = feature_probe.onehot_cuda(torch.zeros(5, dtype=torch.int32), tab)
    assert calls == [("cnrma_probe_onehot", (5, 2048, 128))]
    assert out.shape == (5, 128) and out.dtype == torch.float32

