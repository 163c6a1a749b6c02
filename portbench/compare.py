"""The comparison that decides ``correct``: each served cloud against the
reference's cloud of the same upload.

A served point carries its grid cell in its coordinates (x = u·z/f with
u = col·step − w/2, and likewise y), so each point is placed back on the
strided grid. Per cloud:

* ``misplaced``: points that land on no grid cell, or on a cell taken
  already, plus points whose colour differs from the upload's pixel there
  (colours are exact u8 on both sides);
* ``keep_sure_diff``: the share of grid cells kept by one side only (the
  outlier rule's decisions), among the cells whose decision the
  reference makes with a margin: a mean neighbour distance at least
  ``SURE`` of the threshold away from it. Rounding in the served dtype
  flips decisions near the threshold, as the reference's own f32 would
  against f64, so those are not compared;
* ``depth_mae``: the mean gap of z over the cells both sides keep, as a
  share of the depth scale (the model, the normalization and the codec).

A run reports the sum of ``misplaced`` and the largest ``keep_sure_diff``
and ``depth_mae`` over its sampled clouds; each is held to its limit in
``portbench/limits/<workload>.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from portbench.reference.ops import focal
from portbench.reference.pipeline import Cloud

NUMBERS = ("misplaced", "keep_sure_diff", "depth_mae")
SURE = 0.1


def compare_cloud(points: np.ndarray, colors: np.ndarray, ref: Cloud, depth_scale: float) -> dict:
    """One served cloud ((M, 3) points, (M, 3) colours) against ``ref``."""
    hh, ww = ref.keep.shape
    pts = np.asarray(points, np.float64)
    cols = np.asarray(colors)
    if pts.ndim != 2 or pts.shape[1] != 3 or len(cols) != len(pts):
        return {"misplaced": hh * ww, "keep_sure_diff": 1.0, "depth_mae": 1.0}
    f = focal(ref.h, ref.w)
    z = pts[:, 2]
    zs = np.where(z != 0, z, 1e-6)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        gj = (pts[:, 0] * f / zs + ref.w / 2.0) / ref.step
        gi = (pts[:, 1] * f / zs + ref.h / 2.0) / ref.step
    ri, rj = np.rint(gi), np.rint(gj)
    ok = (np.isfinite(gi) & np.isfinite(gj) & (np.abs(gi - ri) < 0.25) & (np.abs(gj - rj) < 0.25)
          & (ri >= 0) & (ri < hh) & (rj >= 0) & (rj < ww))
    cell = np.where(ok, ri * ww + rj, -1).astype(np.int64)
    # The first point on a cell counts; later ones are misplaced.
    placed = np.nonzero(ok)[0]
    first = np.zeros(len(cell), bool)
    first[placed[np.unique(cell[placed], return_index=True)[1]]] = True
    served_keep = np.zeros(hh * ww, bool)
    served_keep[cell[first]] = True
    ref_cols = ref.colors.reshape(-1, 3)[cell[first]]
    bad_colour = np.any(np.rint(np.asarray(cols[first], np.float64)) != ref_cols, axis=1).sum()
    misplaced = int(len(pts) - first.sum() + bad_colour)
    ref_keep = ref.keep.reshape(-1)
    both = served_keep & ref_keep
    z_served = np.zeros(hh * ww)
    z_served[cell[first]] = z[first]
    z_ref = ref.points.reshape(-1, 3)[:, 2].astype(np.float64)
    gap = np.abs(z_served[both] - z_ref[both]) / depth_scale
    differ = served_keep != ref_keep
    sure = ref.margin.reshape(-1) >= SURE
    return {
        "misplaced": misplaced,
        "keep_sure_diff": float(np.count_nonzero(differ & sure) / max(1, np.count_nonzero(sure))),
        "depth_mae": float(gap.mean()) if gap.size else 1.0,
    }


def reduce_numbers(per_cloud: list[dict]) -> dict:
    """A run's numbers from its clouds' (an empty sample compares
    nothing, and fails)."""
    if not per_cloud:
        return {"misplaced": 1, "keep_sure_diff": 1.0, "depth_mae": 1.0}
    out = {k: max(c[k] for c in per_cloud) for k in NUMBERS}
    out["misplaced"] = int(sum(c["misplaced"] for c in per_cloud))
    return out


def load_limits(root: Path, workload: str) -> dict:
    """{number: limit} of a workload."""
    data = json.loads((root / "limits" / f"{workload}.json").read_text())
    return {k: float(v["limit"]) for k, v in data["numbers"].items()}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): each number the workload's
    limits name at or under its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS if k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
