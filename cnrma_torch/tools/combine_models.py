"""Merge a stage-1 and a stage-2 checkpoint into the stage-3 model's.

    python -m cnrma_torch.tools.combine_models --recon A --detector B
        --output C

Port of ``tools/combine_models.py``: the reconstruction half
(``tower2d.*``, ``backbone3d.*``, ``tsdf_head.*``) comes from ``A``, an
``Atlas`` checkpoint, and the detector (``detector.*``) from ``B``, an
``FCAF3DOnly`` checkpoint; the three stages' models share these names, so
the merge renames nothing.  ``A`` and ``B`` may each be a checkpoint of the
train CLI (``{"model": ...}``) or a model state dict (``.pt``).  ``C`` is a
state dict of ``CNRMA`` that ``python -m cnrma_torch.tools.train
--load-from C`` and the test CLI read.  Every tensor is copied bit for
bit.  The merge fails, writing nothing, when a key lies outside those
four submodules, when ``A`` holds detector keys or ``B`` reconstruction
keys, or when a key of ``CNRMA`` is missing from the result.
"""

from __future__ import annotations

import argparse
import functools
from typing import Dict, FrozenSet, Optional, Sequence

import torch

from cnrma_torch.models.cn_rma import CNRMA

RECON = ("tower2d.", "backbone3d.", "tsdf_head.")
DETECTOR = ("detector.",)


def read_state(path: str) -> Dict[str, torch.Tensor]:
    """A model state dict, or the ``model`` entry of a train checkpoint."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in state and "optimizer" in state:
        state = state["model"]
    return dict(state)


@functools.lru_cache(maxsize=1)
def cnrma_keys() -> FrozenSet[str]:
    """The names of ``CNRMA``'s state dict (built on the meta device: no
    tensor is allocated)."""
    with torch.device("meta"):
        return frozenset(CNRMA().state_dict())


def combine(recon: Dict[str, torch.Tensor],
            detector: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The stage-3 state dict: ``recon``'s reconstruction tensors and
    ``detector``'s detector tensors, the same tensor objects.  Raises on
    an unknown, overlapping or missing key."""
    known = RECON + DETECTOR
    for name, state, own in (("recon", recon, RECON),
                             ("detector", detector, DETECTOR)):
        unknown = sorted(k for k in state if not k.startswith(known))
        if unknown:
            raise KeyError(f"{name} checkpoint: keys of no CN-RMA "
                           f"submodule: {unknown[:5]}")
        other = sorted(k for k in state if not k.startswith(own))
        if other:
            raise KeyError(f"{name} checkpoint: keys the other checkpoint "
                           f"gives (overlapping): {other[:5]}")
    merged = {**recon, **detector}
    want = cnrma_keys()
    missing = sorted(want - set(merged))
    unknown = sorted(set(merged) - want)
    if missing or unknown:
        raise KeyError(f"merged checkpoint: CNRMA keys missing "
                       f"{missing[:5]} ({len(missing)}), keys CNRMA does "
                       f"not have {unknown[:5]} ({len(unknown)})")
    return merged


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """Run the CLI; returns the merged state dict it wrote."""
    p = argparse.ArgumentParser(description="Merge a stage-1 Atlas and a "
                                            "stage-2 FCAF3DOnly checkpoint")
    p.add_argument("--recon", required=True,
                   help="stage-1 Atlas checkpoint (.pt)")
    p.add_argument("--detector", required=True,
                   help="stage-2 FCAF3DOnly checkpoint (.pt)")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    recon, detector = read_state(args.recon), read_state(args.detector)
    merged = combine(recon, detector)
    torch.save(merged, args.output)
    print(f"wrote {args.output}: {len(recon)} tensors from {args.recon}, "
          f"{len(detector)} from {args.detector}", flush=True)
    return merged


if __name__ == "__main__":
    main()
