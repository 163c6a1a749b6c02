"""The port's advanced pipelines (``pipeline/advanced.py``: metric, tiled
high resolution, video) against the JAX package's, on the CPU.

Each test of ``tests/test_advanced.py`` has a counterpart here: the same
tiny Depth-Anything weights (``test_model_parity._build_pair``, through
the bridge), the same numpy inputs, through both packages, on both
transfer contracts. Tolerances:

* a cloud from the f32 transfer: the same point count and order, colours
  equal, per-point RMSE < 1e-3 (PARITY.md's end-to-end bar) and every
  coordinate within 1e-4;
* a cloud through a quantized transfer (12-bit, or u16 with
  ``IPC_TPU_DEPTH16=1``): RMSE < 1e-3, and every coordinate within one
  code step of the codec (its range / 4095 or / 65535, times the largest
  |u - cx| / f, ≤ 1) plus 1e-4: the two packages' depths agree to ~1e-6,
  and a depth that close to a code's boundary rounds to the next code;
* a voxel-downsampled cloud: the same voxel count and order, and the
  means within 1e-4 (points) and 1e-3 (colours).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax
from image_to_pointcloud_tpu_torch.models.depth_anything import DepthAnything, DepthAnythingConfig
from image_to_pointcloud_tpu_torch.models.dinov2 import DinoV2Config
from image_to_pointcloud_tpu_torch.models.dpt import DPTConfig
from image_to_pointcloud_tpu_torch.pipeline import advanced as tadv

sys.path.insert(0, str(Path(__file__).resolve().parent))

INTR = dict(fx=100.0, fy=110.0, cx=42.0, cy=35.0)


def _port_model(jcfg, params) -> DepthAnything:
    fields = lambda cls, obj: {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}  # noqa: E731
    cfg = DepthAnythingConfig(backbone=DinoV2Config(**fields(DinoV2Config, jcfg.backbone)),
                              neck=DPTConfig(**fields(DPTConfig, jcfg.neck)))
    model = DepthAnything(cfg)
    model.load_state_dict(
        state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def relative():
    """(JAX config, params, port model): tests/test_advanced.py's model."""
    from test_model_parity import _build_pair

    _, model, variables = _build_pair(image_size=56)
    return model.cfg, variables["params"], _port_model(model.cfg, variables["params"])


@pytest.fixture(scope="module")
def metric(relative):
    """The same weights under the metric head (sigmoid × 5)."""
    from image_to_pointcloud_tpu.models import DepthAnythingConfig as JCfg

    jcfg, params, _ = relative
    mcfg = JCfg(backbone=jcfg.backbone,
                neck=dataclasses.replace(jcfg.neck, metric_depth=True, max_depth=5.0))
    return mcfg, params, _port_model(mcfg, params)


def _rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(((a - b) ** 2).sum(axis=1).mean()))


def _assert_cloud(ours, ref, *, step_err: float = 0.0, colors_atol: float = 0.0):
    """Same points in the same order: RMSE < 1e-3 and each coordinate
    within ``step_err`` (a codec's code step, 0 for an f32 cloud) +
    1e-4."""
    assert ours[0].shape == ref[0].shape and ours[1].shape == ref[1].shape
    assert _rmse(ours[0], ref[0]) < 1e-3
    np.testing.assert_allclose(ours[0], ref[0], atol=step_err + 1e-4, rtol=0)
    np.testing.assert_allclose(ours[1], ref[1], atol=colors_atol, rtol=0)


# ---------- metric ----------


def _metric_pipes(metric, **kw):
    from image_to_pointcloud_tpu.pipeline.advanced import MetricPipeline

    mcfg, params, model = metric
    return (tadv.MetricPipeline(model, model_target=56, **kw),
            MetricPipeline(mcfg, params, model_target=56, **kw))


def test_metric_cloud_intrinsics(metric, rng):
    from image_to_pointcloud_tpu.pipeline.advanced import CameraIntrinsics

    ours, ref = _metric_pipes(metric, quantized_transfer=False)
    img = rng.integers(0, 256, (70, 84, 3), dtype=np.uint8)
    a = ours.run(img, tadv.CameraIntrinsics(**INTR), step=2)
    b = ref.run(img, CameraIntrinsics(**INTR), step=2)
    assert (a[0][:, 2] > 0).all() and (a[0][:, 2] <= 5.0).all()
    _assert_cloud(a, b)


@pytest.mark.parametrize("bits", [12, 16])
def test_metric_quantized_transfer_matches_jax(metric, rng, monkeypatch, bits):
    """The quantized metric bundle (12-bit, or u16 under
    IPC_TPU_DEPTH16=1), port against JAX, and the port's against its own
    f32 cloud within the JAX test's budgets (1.5e-3; u16 2e-4)."""
    from image_to_pointcloud_tpu.pipeline.advanced import CameraIntrinsics

    if bits == 16:
        monkeypatch.setenv("IPC_TPU_DEPTH16", "1")
    ours, ref = _metric_pipes(metric, quantized_transfer=True)
    img = rng.integers(0, 256, (70, 84, 3), dtype=np.uint8)
    a = ours.run(img, tadv.CameraIntrinsics(**INTR), step=2)
    b = ref.run(img, CameraIntrinsics(**INTR), step=2)
    _assert_cloud(a, b, step_err=5.0 / (4095 if bits == 12 else 65535))
    f32 = _metric_pipes(metric, quantized_transfer=False)[0].run(
        img, tadv.CameraIntrinsics(**INTR), step=2)
    np.testing.assert_allclose(a[0], f32[0], atol=1.5e-3 if bits == 12 else 2e-4)
    np.testing.assert_array_equal(a[1], f32[1])


def test_metric_run_batch_matches_jax(metric, rng):
    """run_batch with per-image intrinsics, port against JAX, and against
    the port's own per-image run."""
    from image_to_pointcloud_tpu.pipeline.advanced import CameraIntrinsics

    ours, ref = _metric_pipes(metric, quantized_transfer=True)
    imgs = rng.integers(0, 256, (3, 70, 84, 3), dtype=np.uint8)
    cams = [INTR, dict(fx=90.0, fy=90.0, cx=40.0, cy=30.0), dict(fx=120.0, fy=100.0, cx=44.0, cy=36.0)]
    a = ours.run_batch(imgs, [tadv.CameraIntrinsics(**c) for c in cams], step=2)
    b = ref.run_batch(imgs, [CameraIntrinsics(**c) for c in cams], step=2)
    for i in range(3):
        _assert_cloud(a[i], b[i], step_err=5.0 / 4095)
        single = ours.run(imgs[i], tadv.CameraIntrinsics(**cams[i]), step=2)
        _assert_cloud(a[i], single, step_err=5.0 / 4095)


def test_fov_constructor_matches_jax():
    from image_to_pointcloud_tpu.pipeline.advanced import CameraIntrinsics

    for h, w, fov in [(100, 200, 90.0), (518, 518, 60.0), (480, 640, 70.0)]:
        assert tadv.CameraIntrinsics.from_fov(h, w, fov) == tadv.CameraIntrinsics(
            **dataclasses.asdict(CameraIntrinsics.from_fov(h, w, fov)))


def test_metric_refuses_a_relative_model(relative):
    with pytest.raises(ValueError, match="metric-head"):
        tadv.MetricPipeline(relative[2])


# ---------- high resolution ----------


def _highres_pipes(relative, **kw):
    from image_to_pointcloud_tpu.pipeline.advanced import HighResPipeline

    jcfg, params, model = relative
    return (tadv.HighResPipeline(model, model_target=56, **kw),
            HighResPipeline(jcfg, params, model_target=56, **kw))


@pytest.mark.parametrize("case", ["budget", "smaller_than_tile", "step1_budget"])
def test_highres_device_path_matches_jax(relative, rng, case):
    """The f32 transfer (the CPU default): the device unprojects and
    voxel-downsamples. Tiles 56/14 on 112×140 with a 2000-point budget;
    an oversized tile and overlap on 84×126 (clamped); step 1 on 112² with
    a 500-point budget."""
    kw, shape, run = {
        "budget": (dict(tile=56, overlap=14), (112, 140, 3), dict(step=2, voxel_budget=2000)),
        "smaller_than_tile": (dict(tile=200, overlap=300), (84, 126, 3),
                              dict(step=2, voxel_budget=None)),
        "step1_budget": (dict(tile=56, overlap=14), (112, 112, 3), dict(step=1, voxel_budget=500)),
    }[case]
    ours, ref = _highres_pipes(relative, quantized_transfer=False, **kw)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    a, b = ours.run(img, **run), ref.run(img, **run)
    if run["voxel_budget"] is None:
        assert len(a[0]) == 42 * 63
        _assert_cloud(a, b)
    else:
        assert len(a[0]) < 4 * run["voxel_budget"]
        _assert_cloud(a, b, colors_atol=1e-3)


def test_highres_depth_grid_matches_jax(relative, rng):
    """The depth-grid transfer (native host reconstruct), port against
    JAX, and against the port's own device unprojection within the
    12-bit budget, colours within half a level."""
    from image_to_pointcloud_tpu_torch import native

    if not native.available():
        pytest.skip("native library unavailable")
    ours, ref = _highres_pipes(relative, quantized_transfer=True, tile=56, overlap=14)
    img = rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)
    a, b = ours.run(img, step=1, voxel_budget=None), ref.run(img, step=1, voxel_budget=None)
    _assert_cloud(a, b, step_err=10.0 / 4095)
    f32 = _highres_pipes(relative, quantized_transfer=False, tile=56, overlap=14)[0].run(
        img, step=1, voxel_budget=None)
    np.testing.assert_allclose(a[0], f32[0], atol=10.0 / 2 / 4095 + 1e-6)
    np.testing.assert_allclose(a[1], f32[1], atol=0.5 + 1e-6)


def test_highres_native_voxel_matches_jax(relative, rng):
    """The budgeted depth-grid path (the native voxel average) equals the
    JAX package's on the same input, and the port's voxel op on its own
    reconstructed cloud."""
    from image_to_pointcloud_tpu_torch import native
    from image_to_pointcloud_tpu_torch.ops.voxel import voxel_downsample

    if not native.available():
        pytest.skip("native library unavailable")
    ours, ref = _highres_pipes(relative, quantized_transfer=True, tile=56, overlap=14)
    img = rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)
    budget = 500
    full = ours.run(img, step=1, voxel_budget=None)
    got = ours.run(img, step=1, voxel_budget=budget)
    want = ref.run(img, step=1, voxel_budget=budget)
    assert len(got[0]) < 4 * budget and len(got[0]) == len(want[0])
    _assert_cloud(got, want, step_err=10.0 / 4095, colors_atol=1e-3)
    lo, hi = full[0].min(axis=0), full[0].max(axis=0)
    voxel = (float(np.prod(np.maximum(hi - lo, 1e-6))) / budget) ** (1.0 / 3.0)
    vp, vc, _, cnt = voxel_downsample(torch.from_numpy(full[0]), torch.from_numpy(full[1]), voxel)
    assert int(cnt) == len(got[0])
    np.testing.assert_allclose(got[0], vp[: int(cnt)].numpy(), atol=1e-4)
    np.testing.assert_allclose(got[1], vc[: int(cnt)].numpy(), atol=1e-3)


def test_highres_quantized_device_voxel_matches_jax(relative, rng, monkeypatch):
    """Without the native library the quantized transfer takes the device
    voxel path: bbox-normalized u16 XYZ + u8 RGB, port against JAX (an
    error of extent/65535 a coordinate)."""
    from image_to_pointcloud_tpu import native as jnative
    from image_to_pointcloud_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    ours, ref = _highres_pipes(relative, quantized_transfer=True, tile=56, overlap=14)
    img = rng.integers(0, 256, (112, 140, 3), dtype=np.uint8)
    a, b = ours.run(img, step=2, voxel_budget=2000), ref.run(img, step=2, voxel_budget=2000)
    extent = float((b[0].max(axis=0) - b[0].min(axis=0)).max())
    _assert_cloud(a, b, step_err=extent / 65535, colors_atol=1.0)


# ---------- video ----------


def _video_pipes(relative, **kw):
    from image_to_pointcloud_tpu.pipeline.advanced import VideoPipeline

    jcfg, params, model = relative
    return (tadv.VideoPipeline(model, model_target=56, **kw),
            VideoPipeline(jcfg, params, model_target=56, **kw))


def test_video_clip_matches_jax(relative, rng):
    """The f32 transfer: every frame's cloud, and the voxel-fused clip."""
    ours, ref = _video_pipes(relative, quantized_transfer=False)
    clip = rng.integers(0, 256, (4, 56, 70, 3), dtype=np.uint8)
    a, b = ours.run(clip, step=2), ref.run(clip, step=2)
    assert len(a[0]) == 4 * 28 * 35
    _assert_cloud(a, b)
    fa, fb = ours.run(clip, step=2, fuse_voxel=0.5), ref.run(clip, step=2, fuse_voxel=0.5)
    assert len(fa[0]) < len(a[0])
    _assert_cloud(fa, fb, colors_atol=1e-3)


@pytest.mark.parametrize("bits", [12, 16])
def test_video_quantized_matches_jax(relative, rng, monkeypatch, bits):
    """The packed strided depth (12-bit, or u16 under IPC_TPU_DEPTH16=1),
    port against JAX, and against the port's own f32 clip within the JAX
    test's budgets (depth_scale/2·4095; u16 2e-4)."""
    if bits == 16:
        monkeypatch.setenv("IPC_TPU_DEPTH16", "1")
    ours, ref = _video_pipes(relative, quantized_transfer=True)
    clip = rng.integers(0, 256, (3, 56, 70, 3), dtype=np.uint8)
    a, b = ours.run(clip, step=2), ref.run(clip, step=2)
    _assert_cloud(a, b, step_err=10.0 / (4095 if bits == 12 else 65535))
    f32 = _video_pipes(relative, quantized_transfer=False)[0].run(clip, step=2)
    np.testing.assert_allclose(a[0], f32[0], atol=10.0 / 2 / 4095 + 1e-6 if bits == 12 else 2e-4)
    np.testing.assert_array_equal(a[1], f32[1])
