"""The advanced pipelines' and the v2 matte's signature callables (one CUDA
graph per JAX jit signature on the card) against the JAX package, on the
CPU.

``MetricPipeline._fn``, ``HighResPipeline._fn``, ``VideoPipeline._fn``
and ``MatteModel._fn`` keep one callable per signature under the JAX
cache key; the voxel downsample and the voxel quantization one per input
shape. On the CPU a callable runs its eager body, so:

* after the same calls, the keys of each port pipeline's ``_compiled``
  equal the JAX pipeline's;
* ``_fn(...)`` on the host inputs (u8 pixels, f32 scalars as (1,) or
  (B,) arrays) equals the eager body ``_forward`` bit for bit on the
  inputs as the port handed them over before the callables (the pixels
  as a float tensor, the depth scale as a Python float, the intrinsics as
  tensors from numpy): the callable's inputs change no bit;
* two calls of one signature at different ``depth_scale`` or intrinsics
  each match JAX's at ``tests/test_torch_advanced.py``'s tolerances (an
  f32 cloud within 1e-4 a coordinate, RMSE < 1e-3; through a codec one
  code step more);
* ``voxel_downsample`` takes a tensor voxel size, bit for bit the float's
  and JAX's; ``_quantize_voxels`` gives JAX's bytes;
* ``blend_tiles``'s feather weights are a device constant;
* the matte's callable equals its eager body bit for bit and JAX's
  ``MatteModel`` within the golden fixture's tolerance (5e-5
  max-normalized).

A tiny metric DA-V2 (64-wide heads) and a SegFormer-B0 matte
(``tests/test_torch_exact_f32.py``'s fixtures), and a tiny relative
DA-V2 for the high-resolution and video clouds (``tests/
test_torch_graph.py``'s, whose depth maps vary enough for the
per-coordinate bound), all with weights drawn with numpy and carried
across by ``models/bridge.py``; inputs from numpy seeds. The graphs themselves (capture, replay at a new value,
launches a replay) are checked on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch import native
from image_to_pointcloud_tpu_torch.pipeline import advanced as tadv

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_advanced import INTR, _assert_cloud  # noqa: E402
from test_torch_exact_f32 import matte_pair, metric64  # noqa: E402, F401
from test_torch_graph import da_pair  # noqa: E402, F401

CAMS = [INTR, dict(fx=90.0, fy=95.0, cx=40.0, cy=30.0)]


def _pipes(pair, kind: str, **kw):
    """(port pipeline, JAX pipeline) of ``kind`` over the same weights."""
    from image_to_pointcloud_tpu.pipeline import advanced as jadv

    jcfg, params, model = pair
    return (getattr(tadv, kind)(model, model_target=56, **kw),
            getattr(jadv, kind)(jcfg, params, model_target=56, **kw))


def _cams(cams: list[dict]) -> tuple[np.ndarray, ...]:
    return tuple(np.asarray([c[a] for c in cams], np.float32) for a in ("fx", "fy", "cx", "cy"))


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


# ---------- metric ----------


def test_metric_keys_and_two_intrinsics_match_jax(metric64, rng):
    """One signature called at two sets of intrinsics, and a second
    signature: each cloud JAX's (the f32 transfer; the bundle's intrinsics
    are the host's), and the port's keys JAX's."""
    from image_to_pointcloud_tpu.pipeline.advanced import CameraIntrinsics

    ours, ref = _pipes(metric64, "MetricPipeline", quantized_transfer=False)
    imgs = rng.integers(0, 256, (2, 70, 84, 3), dtype=np.uint8)
    for cams in (CAMS, CAMS[::-1]):
        a = ours.run_batch(imgs, [tadv.CameraIntrinsics(**c) for c in cams], step=2)
        b = ref.run_batch(imgs, [CameraIntrinsics(**c) for c in cams], step=2)
        for x, y in zip(a, b):
            _assert_cloud(x, y)
    _assert_cloud(ours.run(imgs[0], tadv.CameraIntrinsics(**CAMS[1]), step=2),
                  ref.run(imgs[0], CameraIntrinsics(**CAMS[1]), step=2))
    assert set(ours._compiled) == set(ref._compiled) == {(2, 70, 84, 2), (1, 70, 84, 2)}


@pytest.mark.parametrize("quantized", [False, True])
def test_metric_fn_equals_eager_forward(metric64, rng, quantized):
    pipe = tadv.MetricPipeline(metric64[2], model_target=56, quantized_transfer=quantized)
    imgs = rng.integers(0, 256, (2, 70, 84, 3), dtype=np.uint8)
    cams = _cams(CAMS)
    out = pipe._fn(2, 70, 84, 2)(imgs, *cams)
    ref = pipe._forward(torch.from_numpy(imgs).float(), *map(torch.from_numpy, cams), step=2)
    assert _equal(out, ref)
    assert pipe._fn(2, 70, 84, 2) is pipe._fn(2, 70, 84, 2)


# ---------- high resolution ----------


def test_highres_keys_and_two_scales_match_jax(da_pair, rng):
    """The device path (the f32 transfer, where the depth scale enters the
    device program) at two depth scales of one signature."""
    img = rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)
    ours, ref = _pipes(da_pair, "HighResPipeline", quantized_transfer=False, tile=56, overlap=14)
    for scale in (10.0, 4.0):
        _assert_cloud(ours.run(img, depth_scale=scale, step=2, voxel_budget=None),
                      ref.run(img, depth_scale=scale, step=2, voxel_budget=None))
    assert set(ours._compiled) == set(ref._compiled) == {(112, 112, 2, False)}


@pytest.mark.parametrize("grid", [False, True])
def test_highres_fn_equals_eager_forward(metric64, rng, grid):
    pipe = tadv.HighResPipeline(metric64[2], tile=56, overlap=14, model_target=56)
    img = rng.integers(0, 256, (112, 140, 3), dtype=np.uint8)
    out = pipe._fn(112, 140, 2, grid)(img, np.asarray([7.5], np.float32))
    ref = pipe._forward(torch.from_numpy(img).float(), 7.5, step=2, grid=grid)
    assert _equal(out, ref)


def test_highres_voxel_callables_keyed_by_shape(metric64, rng, monkeypatch):
    """The budgeted device path runs the voxel downsample, and without the
    native library the voxel quantization, each through the callable of
    its inputs' shapes; the quantization's bytes are JAX's on the same
    inputs."""
    from image_to_pointcloud_tpu.pipeline.advanced import HighResPipeline as JHighRes

    monkeypatch.setattr(native, "available", lambda: False)
    pipe = tadv.HighResPipeline(metric64[2], tile=56, overlap=14, model_target=56,
                                quantized_transfer=True)
    img = rng.integers(0, 256, (112, 140, 3), dtype=np.uint8)
    pts, cols = pipe.run(img, step=2, voxel_budget=1000)
    assert 0 < len(pts) < 4 * 1000 and np.isfinite(pts).all()
    n = 56 * 70
    assert set(pipe._op_graphs) == {("voxel_downsample", (n, 3), (n, 3), (1,)),
                                    ("quantize_voxels", (n, 3), (n, 3), (3,), (3,))}
    assert set(pipe._compiled) == {(112, 140, 2, False)}
    vp = rng.normal(0.0, 1.0, (500, 3)).astype(np.float32)
    vc = rng.uniform(0.0, 255.0, (500, 3)).astype(np.float32)
    lo, hi = vp.min(axis=0), vp.max(axis=0)
    ours = pipe._quantize_voxels(*map(torch.from_numpy, (vp, vc, lo, hi))).numpy()
    ref = np.asarray(JHighRes._quantize_voxels(*map(jnp.asarray, (vp, vc, lo, hi))))
    np.testing.assert_array_equal(ours, ref)


# ---------- video ----------


def test_video_keys_and_two_scales_match_jax(da_pair, rng):
    """The f32 transfer (unfused, and voxel-fused at two depth scales) and
    the quantized one at two depth scales."""
    clip = rng.integers(0, 256, (3, 56, 70, 3), dtype=np.uint8)
    for quantized in (False, True):
        ours, ref = _pipes(da_pair, "VideoPipeline", quantized_transfer=quantized)
        runs = [dict(depth_scale=s) for s in (10.0, 3.0)]
        if not quantized:
            runs += [dict(depth_scale=s, fuse_voxel=0.5) for s in (10.0, 3.0)]
        for kw in runs:
            a, b = ours.run(clip, step=2, **kw), ref.run(clip, step=2, **kw)
            if "fuse_voxel" in kw:
                _assert_cloud(a, b, colors_atol=1e-3)
            else:
                _assert_cloud(a, b, step_err=kw["depth_scale"] / 4095 if quantized else 0.0)
        assert set(ours._compiled) == set(ref._compiled) == {(3, 56, 70, 2, quantized)}
        n = 3 * 28 * 35
        assert set(ours._op_graphs) == (
            set() if quantized else {("voxel_downsample", (n, 3), (n, 3), (1,))})


@pytest.mark.parametrize("quant", [False, True])
def test_video_fn_equals_eager_forward(metric64, rng, quant):
    pipe = tadv.VideoPipeline(metric64[2], model_target=56)
    clip = rng.integers(0, 256, (3, 56, 70, 3), dtype=np.uint8)
    out = pipe._fn(3, 56, 70, 2, quant)(clip, np.asarray([12.0], np.float32))
    ref = pipe._forward(torch.from_numpy(clip).float(), 12.0, step=2, quant=quant)
    assert _equal(out, ref)


# ---------- the ops ----------


@pytest.mark.parametrize("size", ["0-d", "(1,)"])
def test_voxel_downsample_takes_a_tensor_voxel_size(rng, size):
    """A tensor voxel size: the float's outputs bit for bit, and JAX's."""
    from image_to_pointcloud_tpu.ops.voxel import voxel_downsample as jvoxel
    from image_to_pointcloud_tpu_torch.ops.voxel import voxel_downsample

    pts = rng.normal(0.0, 1.0, (4000, 3)).astype(np.float32)
    cols = rng.uniform(0.0, 255.0, (4000, 3)).astype(np.float32)
    vsize = torch.tensor(0.37, dtype=torch.float32)
    if size == "(1,)":
        vsize = vsize.reshape(1)
    ours = voxel_downsample(torch.from_numpy(pts), torch.from_numpy(cols), vsize)
    assert all(torch.equal(a, b) for a, b in zip(
        ours, voxel_downsample(torch.from_numpy(pts), torch.from_numpy(cols), 0.37)))
    ref = jvoxel(jnp.asarray(pts), jnp.asarray(cols), jnp.float32(0.37))
    cnt = int(ref[3])
    assert int(ours[3]) == cnt and 0 < cnt < 4000
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy()[:cnt], np.asarray(b)[:cnt])


def test_blend_tiles_feather_is_a_device_constant(rng):
    """The feather weights are made once per tile size, as the cached
    device constant, with the numpy outer product's bits."""
    from image_to_pointcloud_tpu_torch.parallel import tiling
    from image_to_pointcloud_tpu_torch.utils.constants import device_constant

    corners = tiling.plan_tiles(90, 120, 45, 9)
    td = torch.from_numpy(rng.uniform(0.5, 3.0, (len(corners), 45, 45)).astype(np.float32))
    out = tiling.blend_tiles(td, corners, (90, 120))

    def made_again():
        raise AssertionError("the feather weights were not cached")

    fw = device_constant(("feather", 45), "cpu", torch.float32, made_again)
    f1 = tiling._feather_1d(45)
    assert torch.equal(fw, torch.from_numpy(np.outer(f1, f1)))
    assert torch.equal(out, tiling.blend_tiles(td, corners, (90, 120)))


# ---------- the v2 matte ----------


def test_matte_fn_matches_jax(matte_pair, rng):
    """The matte's callable: its eager body's bits, JAX's probability
    within 5e-5 max-normalized, one key a shape."""
    from image_to_pointcloud_tpu_torch.serve.matting import MatteModel

    ref, sd = matte_pair
    matte = MatteModel(sd, 1, "cpu")
    im = rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    out = matte._fn(1, 64, 64)(im)
    assert torch.equal(out, matte._forward(torch.from_numpy(im)))
    assert np.array_equal(matte.prob(im), out.numpy())
    want = np.asarray(ref._fn(ref._params, im))
    assert out.shape == want.shape == (1, 512, 512) and want.std() > 1e-3
    np.testing.assert_allclose(out.numpy() / np.abs(want).max(), want / np.abs(want).max(),
                               atol=5e-5, rtol=0)
    assert set(matte._compiled) == {(1, 64, 64)}
