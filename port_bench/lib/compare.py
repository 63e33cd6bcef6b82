"""The numbers that decide ``correct``: each a relative gap between what
the timed path produced and what the reference makes of the same
inputs, held against its limit in the workload file.

* ``rel_rms``: the norm of the difference over the norm of the
  reference's;
* ``keyed_rel_rms``: the same over rows matched by an integer key (a
  voxel, a ray sample), a row that one side lacks counting as zeros on
  that side, so that a row lost or gained counts in full;
* ``norm_gap``: for training, the worst leaf's gap between the program's
  norm and the reference's, over the reference's norm of that leaf or of
  the median leaf, whichever is larger.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import torch


def rel_rms(p: torch.Tensor, r: torch.Tensor) -> float:
    p, r = p.double(), r.double().to(p.device)
    den = float(r.norm())
    num = float((p - r).norm())
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def keyed_rel_rms(parts: Iterable[Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]]
                  ) -> float:
    """Over (keys_p [N], vals_p [N, F], keys_r [M], vals_r [M, F]) parts:
    sqrt(sum |p - r|^2 / sum |r|^2) over the union of each part's keys."""
    num = den = 0.0
    for kp, vp, kr, vr in parts:
        kr, vr = kr.to(kp.device), vr.to(kp.device)
        keys, inv = torch.unique(torch.cat([kp, kr]), return_inverse=True)
        up = torch.zeros(len(keys), vp.shape[1], dtype=torch.float64,
                         device=kp.device)
        ur = torch.zeros_like(up)
        up.index_add_(0, inv[:len(kp)], vp.double())
        ur.index_add_(0, inv[len(kp):], vr.double())
        num += float(((up - ur) ** 2).sum())
        den += float((ur ** 2).sum())
    return (num / den) ** 0.5 if den > 0 else float("inf")


def sample_keys(xyz: torch.Tensor, uv: torch.Tensor, view: torch.Tensor,
                o: torch.Tensor, d: torch.Tensor, t_one: float, width: int,
                n_samples: int) -> torch.Tensor:
    """A key (view, pixel, sample) for each marched point [N]: the sample
    index recovered from the point's distance along its ray."""
    v = view.long()
    pix = uv[:, 1].long() * width + uv[:, 0].long()
    dist = ((xyz - o[v]) * d[v, pix]).sum(-1)
    smp = torch.round(dist / t_one).long()
    return (v * d.shape[1] + pix) * (n_samples + 1) + smp


def level_rows(level, voxel_size: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(key, values [N, 25]) of one detector level's valid rows: key the
    voxel (from its point), values the centerness, the log of the box
    distances and the class logits."""
    ctr, bbox, cls, points, valid = (t.float() for t in level)
    valid = valid.bool()
    c = torch.round(points[valid] / voxel_size).long() + 4096
    key = (c[:, 0] * 8192 + c[:, 1]) * 8192 + c[:, 2]
    n_dist = 6
    vals = torch.cat([ctr[valid][:, None],
                      torch.log(bbox[valid][:, :n_dist].clamp(min=1e-30)),
                      bbox[valid][:, n_dist:], cls[valid]], dim=1)
    return key, vals


def sorted_scores(scores: torch.Tensor, valid: torch.Tensor,
                  per_level: List[int]) -> torch.Tensor:
    """Each level's rows' best class score, invalid rows 0, sorted
    descending within the level: [K]."""
    best = torch.where(valid.bool(), scores.float().max(-1).values, 0.0)
    out, at = [], 0
    for k in per_level:
        out.append(torch.sort(best[at:at + k], descending=True).values)
        at += k
    return torch.cat(out)


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(worst gap, its leaf) of per-leaf norms over ``leaves`` (all of
    the reference's by default)."""
    names = list(leaves if leaves is not None else ref)
    med = statistics.median(ref[n] for n in ref)
    worst, where = 0.0, ""
    for n in names:
        den = max(ref[n], med)
        gap = abs(prog.get(n, 0.0) - ref[n]) / den if den > 0 else 0.0
        if gap > worst:
            worst, where = gap, n
    return worst, where


def median_gap(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Iterable[str]) -> float:
    """The median over ``leaves`` of each leaf's norm gap over its own
    reference norm."""
    return statistics.median(abs(prog.get(n, 0.0) - ref[n]) / ref[n]
                             if ref[n] > 0 else 0.0 for n in leaves)


def moved_leaves(ref_grad: Dict[str, float], share: float = 1e-3
                 ) -> List[str]:
    """The leaves whose gradient in the reference's first step is at least
    ``share`` of the median leaf's: the others (a key's bias under
    softmax, a norm shift that a following norm cancels) move under Adam
    by round-off alone."""
    med = statistics.median(ref_grad.values())
    return [n for n, v in ref_grad.items() if v >= share * med]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, List[List]]:
    """(every number within its limit, [[name, number, limit], ...])."""
    rows = [[k, numbers.get(k, float("inf")), float(limits[k])]
            for k in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
