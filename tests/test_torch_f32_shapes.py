"""f32 serving, BEiT without LayerScale, the per-row outlier rule, and K1
and K2's plain versions at the shapes the TPU kernels take beyond the
served ones, against the JAX package on the CPU.

The same numpy inputs from a seed go through the JAX function and its
port. Tolerances:

* ``ModelManager(use_bf16=..., use_flash_attention=...)``: the dtype and
  the attention flag of the built model, as the JAX manager decides them
  on the CPU; :func:`exact_f32` restores the TF32 flags exactly;
* ``BeitBlock`` with ``layer_scale=False``: 5e-5 max-normalized
  (PARITY.md's model tolerance);
* ``outlier_keep_from_means`` (``axis=None`` and ``-1``) and
  ``grid_statistical_outlier_mask`` on a batch: exact;
* ``attention_plain`` at D = 160 and 256 against
  ``flash_attention(..., interpret=True)``: 2e-5 abs in f32, the JAX flash
  test's own;
* the plain K2 at (k, window) = (100, 5) and (20, 12) against the JAX scan
  form ``grid_knn_mean_distances``: rtol 1e-5, atol 1e-7 with the same
  zero means (``test_grid_knn_plain_matches_scan_form_at_10_7``'s rule:
  XLA's CPU backend rounds the mean a few ulp away from the sum in list
  order), and bit for bit against a numpy reference that sorts each
  point's d² and sums the first k found in ascending order;
* the k_eff = min(k, taps) identity and the sorted closed form against the
  cascade: bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------- f32 serving ----------


@pytest.fixture(scope="module")
def served_pipelines():
    """DA-V2-Small served on the CPU with and without
    ``use_flash_attention``, built once for the tests below."""
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    return {flash: ModelManager("cpu", model_target=28, use_bf16=False,
                                use_flash_attention=flash).get("depth-anything-v2")
            for flash in (None, False)}


@pytest.mark.parametrize("use_bf16", [True, False])
@pytest.mark.parametrize("flash", [None, False])
def test_model_manager_dtype_and_attention_flag(served_pipelines, use_bf16, flash):
    from image_to_pointcloud_tpu.serve.models import ModelManager as JaxManager
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    mm = ModelManager("cpu", model_target=28, use_bf16=use_bf16, use_flash_attention=flash)
    ref = JaxManager(use_bf16=use_bf16, use_flash_attention=flash, model_target=28)
    # bf16 only on an accelerator, in both packages.
    assert mm.dtype == torch.float32 and mm.use_bf16 == ref.use_bf16 is False
    assert mm.use_flash is (flash is None)
    pipe = served_pipelines[flash]  # built as mm builds it: use_bf16 is moot on the CPU
    assert pipe.dtype == torch.float32 and not pipe.exact_f32  # TF32 scope: CUDA only
    assert all(p.dtype == torch.float32 for p in pipe.model.parameters())
    assert pipe.cfg.backbone.use_flash_attention is (flash is None)
    assert all(b.use_flash is (flash is None) for b in pipe.model.backbone.blocks)


def test_model_manager_plain_attention_serves_as_flash_default(served_pipelines):
    """On the CPU both settings run the plain attention: the same depth."""
    img = np.random.default_rng(0).integers(0, 256, (40, 52, 3), dtype=np.uint8)
    outs = [served_pipelines[flash].run(img).points for flash in (None, False)]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_exact_f32_restores_the_flags_after_the_last_scope():
    from image_to_pointcloud_tpu_torch.pipeline.graph import exact_f32

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with exact_f32():
            with exact_f32():  # a concurrent forward
                assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        with exact_f32(False):
            assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_init_distributed_refuses_cuda_without_it():
    from image_to_pointcloud_tpu_torch.parallel.sharding import init_distributed

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where CUDA is missing")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed(init_method="tcp://127.0.0.1:1", world_size=1, rank=0)


# ---------- BEiT without LayerScale ----------


@pytest.mark.parametrize("layer_scale", [False, True])
def test_beit_block_layer_scale_matches_jax(layer_scale):
    from image_to_pointcloud_tpu.models import beit as jbeit
    from image_to_pointcloud_tpu_torch.models.beit import (
        BeitBlock,
        BeitConfig,
        relative_position_index,
    )

    kw = dict(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
              window_size=4, layer_scale=layer_scale)
    grid = (4, 4)
    x = np.random.default_rng(3).normal(0, 1, (2, 17, 32)).astype(np.float32)
    jblock = jbeit.BeitBlock(jbeit.BeitConfig(**kw))
    params = jax.jit(jblock.init, static_argnums=2)(jax.random.PRNGKey(0), jnp.asarray(x), grid)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.5, np.shape(a)).astype(np.float32), params["params"])
    assert ("ls1" in params) is layer_scale
    ref = np.asarray(jblock.apply({"params": params}, jnp.asarray(x), grid))

    block = BeitBlock(BeitConfig(**kw)).eval()
    block.load_state_dict(state_dict_from_flax(params), strict=True)
    assert (block.ls1 is None) is not layer_scale
    index = torch.from_numpy(relative_position_index(*grid).astype(np.int64))
    with torch.no_grad():
        ours = block(_t(x), grid, index).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours / scale, ref / scale, atol=5e-5)


# ---------- the outlier rule ----------


@pytest.mark.parametrize("axis", [None, -1])
def test_outlier_keep_from_means_axis_matches_jax(axis):
    from image_to_pointcloud_tpu.ops.outlier import outlier_keep_from_means as jkeep
    from image_to_pointcloud_tpu_torch.ops.outlier import outlier_keep_from_means

    rng = np.random.default_rng(5)
    means = np.abs(rng.normal(1.0, 0.3, (2, 300))).astype(np.float32)
    means[1] *= 4.0  # a second cloud at another scale
    means[:, :20] = 0.0
    means[0, 50] = 9.0
    pos = means > 0
    ref = np.asarray(jkeep(jnp.asarray(means), jnp.asarray(pos), 2.0, axis=axis))
    ours = outlier_keep_from_means(_t(means), _t(pos), 2.0, axis=axis).numpy()
    np.testing.assert_array_equal(ours, ref)
    # One cloud and one rule per row differ on this input.
    other = outlier_keep_from_means(_t(means), _t(pos), 2.0, axis=-1 if axis is None else None)
    assert not np.array_equal(other.numpy(), ours)


def test_grid_mask_of_a_batch_is_per_row():
    """Two grids at scales 1 and 40: each row's mask is the JAX function's
    on that grid alone (one shared statistic would keep every point of
    the small grid and drop the large one's)."""
    from image_to_pointcloud_tpu.ops.outlier import grid_statistical_outlier_mask as jmask
    from image_to_pointcloud_tpu_torch.ops.outlier import grid_statistical_outlier_mask

    rng = np.random.default_rng(6)
    grids = rng.random((2, 12, 10, 3)).astype(np.float32)
    grids[1] *= 40.0
    grids[:, 5, 5] = (3.0, 3.0, 3.0)
    ours = grid_statistical_outlier_mask(_t(grids), k=8, window=2).numpy()
    for i in range(2):
        ref = np.asarray(jmask(jnp.asarray(grids[i]), k=8, window=2))
        np.testing.assert_array_equal(ours[i], ref)


# ---------- K1's plain version above D = 128 ----------


@pytest.mark.parametrize("shape", [(1, 2, 70, 160), (1, 1, 40, 256)])
def test_attention_plain_wide_heads_match_jax_flash(shape):
    from image_to_pointcloud_tpu.models.attention import flash_attention as jflash
    from image_to_pointcloud_tpu_torch.models.attention import attention_plain

    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(3))
    ref = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    ours = attention_plain(_t(q), _t(k), _t(v), shape[-1] ** -0.5).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-5)


# ---------- K2's plain version at larger (k, window) ----------


def _cube(rng, shape=(2, 14, 17, 3), nan=True):
    pts = (rng.random(shape) * 3).astype(np.float32)
    if nan:
        pts[0, 4, 9, 1] = np.nan  # poisons every window that holds it
        pts[-1, 10, 3, 0] = np.inf  # poisons its own point
    return pts


def _knn_numpy(pts: np.ndarray, k: int, r: int) -> np.ndarray:
    """Each point's window d² (sentinel 1e9 beyond the grid, > 1e17 no
    neighbour), sorted ascending; the first k found summed in that order,
    in f32; 0 where a distance is NaN. The roots are torch's: its CPU f32
    sqrt is not always correctly rounded (numpy's is), and what this holds
    is the order of the sum."""
    b, hh, ww, _ = pts.shape
    pad = np.full((b, hh + 2 * r, ww + 2 * r, 3), 1e9, np.float32)
    pad[:, r : r + hh, r : r + ww] = pts
    d2 = []
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            e = pad[:, dy : dy + hh, dx : dx + ww] - pts
            d2.append((e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) + e[..., 2] * e[..., 2])
    d2 = np.stack(d2, -1)
    v = np.sort(np.where(d2 > 1e17, np.float32(1e30), d2), -1)[..., :k]
    acc = np.zeros((b, hh, ww), np.float32)
    cnt = np.zeros((b, hh, ww), np.float32)
    for i in range(v.shape[-1]):
        found = v[..., i] < 5e29
        root = torch.sqrt(_t(np.maximum(v[..., i], 0))).numpy()
        acc = acc + np.where(found, root, 0).astype(np.float32)
        cnt = cnt + found.astype(np.float32)
    mean = acc / np.maximum(cnt, 1)
    return np.where(np.isnan(d2).any(-1), 0, mean).astype(np.float32).reshape(b, hh * ww)


@pytest.mark.parametrize("k,window", [(100, 5), (20, 12)])
def test_grid_knn_plain_large_k_window_matches_scan_form(k, window):
    from image_to_pointcloud_tpu.ops.outlier import grid_knn_mean_distances as jscan
    from image_to_pointcloud_tpu_torch.ops.outlier import grid_knn_mean_distances_plain

    pts = _cube(np.random.default_rng(8), (1, 14, 17, 3))
    ours = grid_knn_mean_distances_plain(_t(pts), k=k, window=window).numpy()
    np.testing.assert_array_equal(ours, _knn_numpy(pts, k, window))
    ref = np.asarray(jscan(jnp.asarray(pts[0]), k=k, window=window))
    np.testing.assert_array_equal(ours[0] == 0, ref == 0)
    np.testing.assert_allclose(ours[0], ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("k,window", [(30, 2), (100, 3), (65, 4), (300, 8), (500, 12)])
def test_grid_knn_k_eff_identity(k, window):
    """The cascade over k entries equals the cascade over min(k, taps)
    entries, and (above 64 entries) the sorted closed form, bit for bit."""
    from image_to_pointcloud_tpu_torch.ops import outlier

    pts = _t(_cube(np.random.default_rng(9)))
    taps = (2 * window + 1) ** 2
    k_eff = min(k, taps)
    got = outlier.grid_knn_mean_distances_plain(pts, k=k, window=window)
    if k * taps <= 20000:  # the full cascade, k·taps tensor ops
        full = outlier._knn_cascade(pts, k, window)
        assert torch.equal(outlier._knn_cascade(pts, k_eff, window), full)
        assert torch.equal(got, full)
    if k_eff > outlier.MAX_REGISTER_K:
        assert torch.equal(got, outlier._knn_sorted(pts, k_eff, window))
        assert torch.equal(outlier._knn_sorted(pts, k, window), got)
    np.testing.assert_array_equal(got.numpy(), _knn_numpy(pts.numpy(), k_eff, window))
    assert (got == 0).any() and (got > 0).any()
