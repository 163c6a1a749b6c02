"""The ops under the port's advanced pipelines against the JAX package's,
on the CPU: voxel downsampling, high-resolution tiling, the exact O(N²)
kNN outlier search (and ``exact_outlier`` through the pipeline), and the
metric unprojection.

Tolerances:

* ``voxel_downsample``: the same count, the same voxel order and the same
  means bit for bit (the CPU scatter-add sums in the sorted order, as
  XLA's does); on a wide cloud under a tiny voxel (per-axis indices ~1e6,
  whose product would wrap int32) too.
* ``plan_tiles`` and ``extract_tiles`` exact; ``blend_tiles`` within 1e-6
  of the mosaic's scale (f32 means and sums taken in another order).
* ``knn_mean_distances``: within 1e-4 relative + 1e-7. ``|q|² + |k|² -
  2 q·k`` rounds in another order than XLA's HIGHEST dot, and its
  cancellation turns an ulp of |q|² (far points: ~5e-4) into ~3e-6 of a
  mean distance (measured: 1.5e-5 relative at most). The keep masks of
  ``statistical_outlier_mask`` equal.
* ``exact_outlier`` through ``DepthPipeline`` against the JAX graph: the
  slice bar of ``tests/test_torch_model.py`` (keep agreement ≥ 99.5 %,
  RMSE < 1e-3, colours exact).
* ``unproject_intrinsics`` and ``num_points``: exact.
"""

from __future__ import annotations

import importlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.ops import outlier as tout
from image_to_pointcloud_tpu_torch.ops.voxel import voxel_downsample
from image_to_pointcloud_tpu_torch.parallel import tiling as ttile

# The module, not the package-level ``unproject`` function of the same
# name that ``ops/__init__.py`` re-exports, as the JAX package's does.
tunp = importlib.import_module("image_to_pointcloud_tpu_torch.ops.unproject")

sys.path.insert(0, str(Path(__file__).resolve().parent))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------- voxel ----------


def _cloud(kind: str, rng):
    if kind == "wide_tiny_voxel":
        # ~1e6 cells per axis: a combined x·y·z key would wrap int32.
        pts = rng.uniform(0.0, 1000.0, (3000, 3)).astype(np.float32)
        pts[1000:1500] = pts[:500] + np.float32(1e-5)  # shared voxels
        return pts, rng.uniform(0, 255, (3000, 3)).astype(np.float32), 1e-3, None
    pts = rng.normal(0.0, 1.0, (5000, 3)).astype(np.float32)
    valid = rng.uniform(size=5000) > 0.1 if kind == "masked" else None
    return pts, rng.uniform(0, 255, (5000, 3)).astype(np.float32), 0.25, valid


@pytest.mark.parametrize("kind", ["plain", "masked", "wide_tiny_voxel"])
def test_voxel_downsample_matches_jax(rng, kind):
    from image_to_pointcloud_tpu.ops import voxel_downsample as jvoxel

    pts, cols, voxel, valid = _cloud(kind, rng)
    ref = [np.asarray(r) for r in jvoxel(pts, cols, voxel, None if valid is None else jnp.asarray(valid))]
    ours = [r.numpy() for r in voxel_downsample(_t(pts), _t(cols), voxel,
                                                None if valid is None else _t(valid))]
    cnt = int(ref[3])
    assert int(ours[3]) == cnt and 0 < cnt < len(pts)
    np.testing.assert_array_equal(ours[2], ref[2])
    np.testing.assert_array_equal(ours[0][:cnt], ref[0][:cnt])
    np.testing.assert_array_equal(ours[1][:cnt], ref[1][:cnt])


# ---------- tiling ----------


@pytest.mark.parametrize("h,w,tile,overlap", [(112, 140, 56, 14), (1024, 1024, 518, 128),
                                              (84, 126, 84, 83), (56, 56, 56, 0), (600, 518, 518, 0)])
def test_plan_and_extract_tiles_match_jax(rng, h, w, tile, overlap):
    from image_to_pointcloud_tpu.parallel.tiling import extract_tiles, plan_tiles

    corners = ttile.plan_tiles(h, w, tile, overlap)
    assert corners == plan_tiles(h, w, tile, overlap)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttile.extract_tiles(_t(img), corners, tile).numpy(),
                                  np.asarray(extract_tiles(jnp.asarray(img), corners, tile)))


def test_plan_tiles_refuses_like_jax():
    from image_to_pointcloud_tpu.parallel.tiling import plan_tiles

    for args in [(84, 126, 200, 14), (112, 112, 56, 56), (112, 112, 0, 0)]:
        with pytest.raises(ValueError):
            plan_tiles(*args)
        with pytest.raises(ValueError):
            ttile.plan_tiles(*args)


@pytest.mark.parametrize("anchor", [False, True])
def test_blend_tiles_matches_jax(rng, anchor):
    from image_to_pointcloud_tpu.parallel.tiling import blend_tiles

    h, w, tile = 112, 140, 56
    corners = ttile.plan_tiles(h, w, tile, 14)
    td = rng.uniform(0.5, 3.0, (len(corners), tile, tile)).astype(np.float32)
    anc = rng.uniform(1.0, 2.0, (h, w)).astype(np.float32) if anchor else None
    ref = np.asarray(blend_tiles(jnp.asarray(td), corners, (h, w),
                                 anchor=None if anc is None else jnp.asarray(anc)))
    ours = ttile.blend_tiles(_t(td), corners, (h, w), anchor=None if anc is None else _t(anc)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


# ---------- exact kNN ----------


@pytest.mark.parametrize("n,qb,kb", [(700, 128, 256), (333, 512, 2048), (1500, 256, 512)])
def test_knn_mean_distances_matches_jax(rng, n, qb, kb):
    """N not a multiple of either block (padding at both edges), an
    invalid mask, and coincident points (zero distances)."""
    from image_to_pointcloud_tpu.ops.outlier import knn_mean_distances, statistical_outlier_mask

    pts = rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    pts[: n // 10] = pts[n // 10 : 2 * (n // 10)]  # duplicates
    pts[-5:] *= 20.0  # outliers
    valid = rng.uniform(size=n) > 0.05
    ref = np.asarray(knn_mean_distances(jnp.asarray(pts), jnp.asarray(valid), query_block=qb,
                                        key_block=kb))
    ours = tout.knn_mean_distances(_t(pts), _t(valid), query_block=qb, key_block=kb).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-7)
    assert (ours[~valid] == 0).all()
    keep = np.asarray(statistical_outlier_mask(jnp.asarray(pts), jnp.asarray(valid),
                                               query_block=qb, key_block=kb))
    ours_keep = tout.statistical_outlier_mask(_t(pts), _t(valid), query_block=qb, key_block=kb)
    np.testing.assert_array_equal(ours_keep.numpy(), keep)
    assert not keep[-5:].any()


def test_exact_outlier_pipeline_matches_jax(rng, monkeypatch):
    """``PipelineOptions(exact_outlier=True)`` through both packages'
    DepthPipeline; the port's graph never reaches the grid search (K2 on
    the card)."""
    from test_torch_model import _flax_pair

    from image_to_pointcloud_tpu.pipeline.graph import DepthPipeline as JPipe
    from image_to_pointcloud_tpu.pipeline.graph import PipelineOptions as JOpts
    from image_to_pointcloud_tpu_torch.pipeline import graph as tgraph

    jcfg, params, model = _flax_pair(layers=4, out_layers=(0, 1, 2, 3))
    yy, xx = np.mgrid[0:64, 0:80]
    img = np.stack([xx * 3, yy * 4, (xx + yy) * 2], -1) + rng.integers(0, 40, (64, 80, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    a = JPipe(jcfg, params, quantized_transfer=False, model_target=56).run(
        img, depth_scale=15.0, options=JOpts(exact_outlier=True))

    def no_grid(*_a, **_k):
        raise AssertionError("the exact path ran the grid search")

    monkeypatch.setattr(tgraph, "grid_statistical_outlier_mask", no_grid)
    b = tgraph.DepthPipeline(model, model_target=56).run(
        img, depth_scale=15.0, options=tgraph.PipelineOptions(exact_outlier=True))
    np.testing.assert_array_equal(b.packed[3:6], a.packed[3:6])
    ka, kb = a.packed[6] > 0.5, b.packed[6] > 0.5
    assert (ka == kb).mean() >= 0.995 and not ka.all()
    both = ka & kb
    assert np.sqrt(((a.packed[:3, both] - b.packed[:3, both]) ** 2).sum(0).mean()) < 1e-3


# ---------- metric unprojection ----------


@pytest.mark.parametrize("step", [1, 2, 3])
def test_unproject_intrinsics_matches_jax(rng, step):
    from image_to_pointcloud_tpu.ops.unproject import num_points, unproject_intrinsics

    d = rng.uniform(0.0, 5.0, (2, 37, 53)).astype(np.float32)
    d[:, 4, ::3] = 0.0  # not valid
    img = rng.integers(0, 256, (2, 37, 53, 3), dtype=np.uint8)
    cams = [(100.0, 110.0, 26.5, 18.5), (91.3, 87.1, 20.0, 15.0)]
    ours = tunp.unproject_intrinsics(
        _t(d), _t(img), **{k: torch.tensor([c[i] for c in cams]) for i, k in
                           enumerate(("fx", "fy", "cx", "cy"))}, step=step).numpy()
    for b, (fx, fy, cx, cy) in enumerate(cams):
        ref = np.asarray(unproject_intrinsics(jnp.asarray(d[b]), jnp.asarray(img[b]), fx=fx, fy=fy,
                                              cx=cx, cy=cy, step=step))
        np.testing.assert_array_equal(ours[b], ref)
    assert ours.shape[-1] == tunp.num_points(37, 53, step) == num_points(37, 53, step)
