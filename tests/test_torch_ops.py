"""Parity of the PyTorch port's ops (image_to_pointcloud_tpu_torch.ops and
the attention module) with the JAX package, on the CPU.

The same inputs, made by numpy from a seed, go through the JAX function
and its port. On the CPU the port takes each kernel's plain version; the
JAX side runs as its own tests run it (Pallas kernels in interpret mode,
or the XLA/scan forms). Tolerances:

* attention module: 2e-5 abs, f32 — the JAX flash test's own;
* grid-kNN module: rtol 1e-5, atol 1e-7 — the JAX Pallas test's own;
* depthnorm, blur, colormap, outlier threshold rule: bit-exact;
* unproject (K3 module): z, colors, valid rows bit-exact against both
  JAX forms, the jnp ``unproject`` and the Pallas ``unproject_pallas`` in
  interpret mode; x and y bit-exact with numpy's f32 ``u·z / f`` and
  within 1 ulp of JAX, which multiplies by ``1/f`` (the Pallas kernel
  does so explicitly, and XLA's CPU backend folds the jnp form's
  division by the constant focal length into the same product);
* resize: rtol 1e-6 (f32 sums in another order).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.models.attention import (
    flash_attention,
    multi_head_attention,
)
from image_to_pointcloud_tpu_torch.ops.outlier import (
    grid_knn_mean_distances,
    grid_knn_mean_distances_cuda,
    grid_knn_mean_distances_plain,
    outlier_keep_from_means,
)
from torch_depth_cases import NORMALIZE_CASES, depth_planes


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------- K1 module: attention ----------


@pytest.mark.parametrize("n", [200, 77])
def test_attention_matches_jax(rng, n):
    from image_to_pointcloud_tpu.models.attention import (
        multi_head_attention as jmha,
    )

    q, k, v = (rng.normal(0, 1, (2, n, 64)).astype(np.float32) for _ in range(3))
    ours = multi_head_attention(_t(q), _t(k), _t(v), num_heads=2).numpy()
    xla = np.asarray(jmha(q, k, v, num_heads=2, use_flash=False))
    flash = np.asarray(jmha(q, k, v, num_heads=2, use_flash=True, interpret=True))
    np.testing.assert_allclose(ours, xla, atol=2e-5)
    np.testing.assert_allclose(ours, flash, atol=2e-5)


def test_flash_wrapper_refuses_cpu_tensors(rng):
    """On the CPU only the plain version runs; the kernel wrapper itself
    takes CUDA tensors or raises."""
    q = _t(rng.normal(0, 1, (1, 2, 16, 64)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)


# ---------- K2 module: grid kNN ----------


def test_grid_knn_matches_pallas(rng):
    """Batched, on an odd grid: the Pallas kernel's tile (rounded up to
    32×128) overhangs the 30×50 grid, and its sentinel overhang must not
    move real centers. One kernel configuration, because each costs
    ~30 s of interpret-mode compile on the CPU."""
    from image_to_pointcloud_tpu.ops.outlier_pallas import (
        grid_knn_mean_distances_pallas,
    )

    pts = (rng.random((2, 30, 50, 3)) * 3).astype(np.float32)
    ref = np.asarray(
        grid_knn_mean_distances_pallas(
            jnp.asarray(pts), k=20, window=4, tile=(128, 256), interpret=True
        )
    )
    ours = grid_knn_mean_distances(_t(pts)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)


def test_grid_knn_nan_inf_matches_jax(rng):
    """NaN and inf points, as a bad depth value hands them over. The JAX
    package's scan form and Pallas kernel (interpret mode, the same shape
    and tile as above, so the compile is shared) propagate a NaN distance
    through the cascade: the point's mean is 0 and it drops out of the
    statistics. The plain version (K2's reference on the card) must put
    its zeros at the same points and agree elsewhere."""
    from image_to_pointcloud_tpu.ops.outlier import grid_knn_mean_distances as jscan
    from image_to_pointcloud_tpu.ops.outlier_pallas import (
        grid_knn_mean_distances_pallas,
    )

    pts = (rng.random((2, 30, 50, 3)) * 3).astype(np.float32)
    pts[0, 4, 9, 1] = np.nan  # poisons every window that holds it
    pts[0, 20, 33, 0] = np.inf  # poisons its own point (inf - inf)
    pts[1, 0, 0, 2] = -np.inf  # at a corner
    pts[1, 29, 49] = np.nan
    ours = grid_knn_mean_distances(_t(pts)).numpy()
    pallas = np.asarray(
        grid_knn_mean_distances_pallas(
            jnp.asarray(pts), k=20, window=4, tile=(128, 256), interpret=True
        )
    )
    scan = np.stack([np.asarray(jscan(jnp.asarray(p), k=20, window=4)) for p in pts])
    zeros = ours == 0
    assert zeros.sum() > 4 and np.isfinite(ours).all()
    for ref in (pallas, scan):
        np.testing.assert_array_equal(zeros, ref == 0)
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)


def _centre_out_cascade(points_grid: torch.Tensor, k: int = 20, r: int = 4) -> torch.Tensor:
    """The plain version's cascade with the taps visited as the CUDA
    kernel visits them: ascending dy² + dx², ties by (dy, dx), and a tap
    that is not below the running k-th value skipped."""
    p = points_grid.float()
    b, hh, ww, _ = p.shape
    pad = torch.full((b, hh + 2 * r, ww + 2 * r, 3), 1e9)
    pad[:, r : r + hh, r : r + ww] = p
    big = torch.full((), 1e30)
    best = [big.expand(b, hh, ww)] * k
    taps = sorted(
        ((dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)),
        key=lambda o: (o[0] ** 2 + o[1] ** 2, o),
    )
    assert taps[0] == (0, 0) and len(taps) == (2 * r + 1) ** 2
    for dy, dx in taps:
        diff = pad[:, r + dy : r + dy + hh, r + dx : r + dx + ww] - p
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
        d2 = d2 + diff[..., 2] * diff[..., 2]
        v = torch.where(d2 > 1e17, big, d2)
        v = torch.where(v < best[k - 1], v, big)  # the early reject
        for i in range(k):
            best[i], v = torch.minimum(best[i], v), torch.maximum(best[i], v)
    acc = torch.zeros((b, hh, ww))
    cnt = torch.zeros_like(acc)
    for s in best:
        found = s < 0.5e30
        acc = acc + torch.where(found, torch.sqrt(s.clamp_min(0.0)), 0.0)
        cnt = cnt + found.float()
    return (acc / cnt.clamp_min(1.0)).reshape(b, hh * ww)


@pytest.mark.parametrize("shape", [(1, 30, 33, 3), (2, 3, 5, 3)])
def test_grid_knn_centre_out_order_is_exact(rng, shape):
    """The CPU evidence for K2's tap order: the sorted top-20 does not
    depend on the insertion order, so the centre-out cascade with its early
    reject gives the plain version's means bit for bit, here on points of
    a ¼ lattice, where many distances tie."""
    pts = rng.integers(0, 8, shape).astype(np.float32) * np.float32(0.25)
    assert torch.equal(_centre_out_cascade(_t(pts)), grid_knn_mean_distances_plain(_t(pts)))


def test_grid_knn_plain_matches_scan_form(rng):
    from image_to_pointcloud_tpu.ops.outlier import grid_knn_mean_distances as jscan

    pts = (rng.random((1, 17, 23, 3)) * 2).astype(np.float32)
    ref = np.asarray(jscan(jnp.asarray(pts[0]), k=8, window=3))
    ours = grid_knn_mean_distances_plain(_t(pts), k=8, window=3)[0].numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)


def test_grid_knn_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        grid_knn_mean_distances_cuda(torch.zeros(1, 4, 4, 3))


def test_outlier_keep_matches_jax(rng):
    from image_to_pointcloud_tpu.ops.outlier import outlier_keep_from_means as jkeep

    means = rng.random((3, 500)).astype(np.float32)
    means[:, ::7] = 0.0
    means[:, ::50] *= 20.0
    ref = np.asarray(jkeep(means, means > 0, 2.0, axis=-1))
    ours = outlier_keep_from_means(_t(means), _t(means) > 0, 2.0).numpy()
    np.testing.assert_array_equal(ours, ref)


# ---------- exact ops ----------


@pytest.mark.parametrize("case", NORMALIZE_CASES)
@pytest.mark.parametrize("shape", [(37, 45), (64, 80)])
@pytest.mark.parametrize("invert", [True, False])
def test_normalize_depth_bit_exact(rng, case, shape, invert):
    """The batched plain version (and ``normalize_depth`` on one plane)
    equals the JAX package plane by plane, bit for bit: -0.0 below +0.0
    in the ranks and the clip, as the JAX package's total order has it."""
    from image_to_pointcloud_tpu.ops.depthnorm import normalize_depth as jnorm
    from image_to_pointcloud_tpu_torch.ops.depthnorm import normalize_depth, normalize_depth_planes

    planes = depth_planes(rng, case, shape)
    ours = normalize_depth_planes(_t(planes), invert).numpy()
    assert ours.shape == planes.shape and ours.dtype == np.float32
    for b, plane in enumerate(planes):
        ref = np.asarray(jnorm(plane, invert))
        np.testing.assert_array_equal(ours[b].view(np.uint32), ref.view(np.uint32))
    if len(planes) == 1:
        np.testing.assert_array_equal(normalize_depth(_t(planes[0]), invert).numpy().view(np.uint32),
                                      ours[0].view(np.uint32))


def test_normalize_depth_cuda_refuses_cpu_tensors():
    from image_to_pointcloud_tpu_torch.ops.depthnorm import normalize_depth_cuda

    with pytest.raises(ValueError, match="CUDA"):
        normalize_depth_cuda(torch.zeros(2, 16))


@pytest.mark.parametrize("step", [1, 2, 4])
@pytest.mark.parametrize("fov", [None, 60.0])
def test_unproject_bit_exact(rng, step, fov):
    from image_to_pointcloud_tpu import ops as jops
    from image_to_pointcloud_tpu_torch.ops.unproject import focal_length, unproject

    h, w = 37, 45
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    d = rng.random((h, w)).astype(np.float32)
    d[5, 6] = 0.0  # the z == 0 epsilon path
    ref = np.asarray(
        jops.unproject(d, img, depth_scale=10.0, step=step, h=h, w=w, fov_deg=fov)
    )
    ours = unproject(
        _t(d), _t(img), depth_scale=10.0, step=step, h=h, w=w, fov_deg=fov
    ).numpy()
    np.testing.assert_array_equal(ours[2:], ref[2:])
    z = d[::step, ::step] * np.float32(10.0)
    zs = np.where(z != 0, z, np.float32(1e-6))
    f = np.float32(focal_length(h, w, fov))
    u = np.arange(zs.shape[1], dtype=np.float32) * step - np.float32(w / 2)
    v = (np.arange(zs.shape[0], dtype=np.float32) * step - np.float32(h / 2))[:, None]
    np.testing.assert_array_equal(ours[0], (u * zs / f).reshape(-1))
    np.testing.assert_array_equal(ours[1], (v * zs / f).reshape(-1))
    ulp = np.spacing(np.abs(ref[:2]).astype(np.float32))
    assert (np.abs(ours[:2] - ref[:2]) <= ulp).all()
    # Batched with one scale per image.
    both = unproject(
        _t(np.stack([d, d])), _t(np.stack([img, img])),
        depth_scale=torch.tensor([10.0, 2.5]), step=step, h=h, w=w, fov_deg=fov,
    ).numpy()
    np.testing.assert_array_equal(both[0], ours)
    ref2 = np.asarray(
        jops.unproject(d, img, depth_scale=2.5, step=step, h=h, w=w, fov_deg=fov)
    )
    np.testing.assert_array_equal(both[1][2:], ref2[2:])


@pytest.mark.parametrize(
    "hw,step,fov", [((40, 64), 2, None), ((37, 45), 1, 60.0), ((30, 41), 4, None)]
)
def test_unproject_plain_matches_pallas(rng, hw, step, fov):
    """K3: the plain version against the Pallas kernel, run in interpret
    mode as tests/test_ops.py runs it."""
    from image_to_pointcloud_tpu.ops.unproject import unproject_pallas
    from image_to_pointcloud_tpu_torch.ops.unproject import unproject, unproject_plain

    h, w = hw
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    d = rng.random((h, w)).astype(np.float32)
    d[4, 8] = 0.0  # the z == 0 epsilon path
    ref = np.asarray(
        unproject_pallas(
            d, img, depth_scale=7.5, step=step, h=h, w=w, fov_deg=fov, interpret=True
        )
    )
    kw = dict(depth_scale=7.5, step=step, h=h, w=w, fov_deg=fov)
    ours = unproject_plain(_t(d), _t(img), **kw).numpy()
    assert ours.shape == ref.shape == (8, -(-h // step) * -(-w // step))
    np.testing.assert_array_equal(ours[2:], ref[2:])
    ulp = np.spacing(np.abs(ref[:2]).astype(np.float32))
    assert (np.abs(ours[:2] - ref[:2]) <= ulp).all()
    # On a CPU tensor the dispatching unproject is the plain version.
    np.testing.assert_array_equal(unproject(_t(d), _t(img), **kw).numpy(), ours)


def test_unproject_cuda_wrapper_refuses_cpu_tensors():
    from image_to_pointcloud_tpu_torch.ops.unproject import unproject_cuda

    with pytest.raises(ValueError, match="CUDA"):
        unproject_cuda(
            torch.zeros(1, 4, 4), torch.zeros(1, 4, 4, 3), depth_scale=1.0, step=1, h=4, w=4
        )


@pytest.mark.parametrize("ksize", [5, 11])
def test_gaussian_blur_bit_exact(rng, ksize):
    from image_to_pointcloud_tpu.ops.gaussian import gaussian_blur as jblur
    from image_to_pointcloud_tpu_torch.ops.gaussian import gaussian_blur

    x = rng.random((33, 41)).astype(np.float32)
    np.testing.assert_array_equal(
        gaussian_blur(_t(x), ksize).numpy(), np.asarray(jblur(x, ksize))
    )


def test_colormap_table_identical():
    from image_to_pointcloud_tpu.ops.colormap import PLASMA_RGB as jlut
    from image_to_pointcloud_tpu_torch.ops.colormap import PLASMA_RGB

    np.testing.assert_array_equal(PLASMA_RGB, jlut)


@pytest.mark.parametrize(
    "method,out_hw",
    [("bicubic_pil", (56, 70)), ("area", (20, 17)), ("linear", (50, 61)), ("linear_ac", (80, 90))],
)
def test_resize_matches_jax(rng, method, out_hw):
    from image_to_pointcloud_tpu.ops.resize import resize_batched as jresize
    from image_to_pointcloud_tpu_torch.ops.resize import resize_batched

    x = (rng.random((2, 40, 45, 3)) * 255).astype(np.float32)
    ref = np.asarray(jresize(jnp.asarray(x), out_hw, method))
    ours = resize_batched(_t(x), out_hw, method).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("hw", [(64, 80), (300, 400), (518, 3072), (1000, 37)])
def test_processor_output_size_matches_jax(hw):
    from image_to_pointcloud_tpu.pipeline.preprocess import (
        processor_output_size as jsize,
    )
    from image_to_pointcloud_tpu_torch.pipeline.preprocess import (
        processor_output_size,
    )

    assert processor_output_size(*hw) == jsize(*hw)
    assert processor_output_size(*hw, target=56) == jsize(*hw, target=56)
