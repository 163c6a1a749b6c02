"""Parity of the PyTorch port's model and pipeline slice with the JAX
package, on the CPU.

Flax parameters (JAX init, or the committed HF-oracle fixture) cross to
the port through models/bridge.py; the same numpy inputs go through both
packages. Tolerances:

* model forward and golden replay: 5e-5 max-normalized (PARITY.md);
* slice: equal point counts, exact colors, keep masks agreeing on
  ≥ 99.5 % of points, per-point RMSE < 1e-3 on points both keep, gray
  preview within ±1 level.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch import cuda
from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax
from image_to_pointcloud_tpu_torch.models.depth_anything import (
    DepthAnything,
    DepthAnythingConfig,
    init_weights,
    preset,
)
from image_to_pointcloud_tpu_torch.models.dinov2 import DinoV2Config
from image_to_pointcloud_tpu_torch.models.dpt import DPTConfig
from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline, PipelineOptions

FIXDIR = Path(__file__).resolve().parent / "fixtures"


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _tiny_kwargs(layers=2, out_layers=(0, 1, 1, 1)):
    backbone = dict(
        hidden_size=32, num_layers=layers, num_heads=2, pos_embed_size=4,
        out_layers=out_layers,
    )
    neck = dict(
        hidden_size=32, neck_hidden_sizes=(8, 16, 32, 32),
        fusion_hidden_size=16, head_hidden_size=8,
    )
    return backbone, neck


def _flax_pair(seed=0, **kw):
    """(JAX config, Flax params as numpy, port model with those weights)."""
    from image_to_pointcloud_tpu.models import DepthAnything as JDA
    from image_to_pointcloud_tpu.models import DepthAnythingConfig as JCfg
    from image_to_pointcloud_tpu.models.dinov2 import DinoV2Config as JB
    from image_to_pointcloud_tpu.models.dpt import DPTConfig as JN

    bb, nk = _tiny_kwargs(**kw)
    jcfg = JCfg(backbone=JB(**bb), neck=JN(**nk))
    params = jax.jit(JDA(jcfg).init)(jax.random.PRNGKey(seed), jnp.zeros((1, 56, 56, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model = DepthAnything(DepthAnythingConfig(backbone=DinoV2Config(**bb), neck=DPTConfig(**nk)))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jcfg, params, model


@pytest.fixture(scope="module")
def pair():
    """One tiny JAX/port model pair for the module (Flax init is eager
    and slow on the CPU)."""
    return _flax_pair(layers=4, out_layers=(0, 1, 2, 3))


def _assert_close_normalized(ours, ref, atol=5e-5):
    assert ours.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(ours / scale, ref / scale, atol=atol)


# ---------- model ----------


@pytest.mark.parametrize("hw", [(56, 56), (42, 70)])
def test_model_forward_matches_flax(rng, pair, hw):
    from image_to_pointcloud_tpu.models import DepthAnything as JDA

    jcfg, params, model = pair
    x = rng.normal(0, 1, (2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JDA(jcfg).apply)({"params": params}, jnp.asarray(x)))
    assert np.abs(ref).max() > 1e-3  # a non-degenerate depth map
    with torch.no_grad():
        ours = model(_t(x)).numpy()
    _assert_close_normalized(ours, ref)


def test_golden_depth_anything_replay():
    """The committed HF-oracle fixture through convert_depth_anything →
    bridge → port, as tests/test_golden_fixtures.py replays it in Flax."""
    from image_to_pointcloud_tpu.models import convert_depth_anything

    z = np.load(FIXDIR / "golden_depth_anything.npz")
    meta = json.loads(bytes(z["meta"]).decode())
    assert meta["builder_kwargs"]["hidden"] == 32
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd/")}
    bb, nk = _tiny_kwargs(layers=4, out_layers=(0, 1, 2, 3))
    model = DepthAnything(DepthAnythingConfig(backbone=DinoV2Config(**bb), neck=DPTConfig(**nk)))
    model.load_state_dict(
        state_dict_from_flax(convert_depth_anything(sd, num_layers=4)), strict=True
    )
    with torch.no_grad():
        ours = model(_t(z["input"])).numpy()
    _assert_close_normalized(ours, z["output"])


def test_init_is_deterministic_and_nondegenerate():
    cfg = preset("depth-anything-v2-small")
    bb = DinoV2Config(**{**vars(cfg.backbone), "num_layers": 2, "out_layers": (0, 1, 1, 1)})
    cfg = DepthAnythingConfig(backbone=bb, neck=cfg.neck)
    a = init_weights(DepthAnything(cfg), torch.Generator().manual_seed(3))
    b = init_weights(DepthAnything(cfg), torch.Generator().manual_seed(3))
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    x = torch.randn(1, 112, 112, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        d = a(x)
    assert d.shape == (1, 112, 112) and torch.isfinite(d).all() and (d > 0).any()


# ---------- the slice ----------


@pytest.mark.parametrize(
    "opts",
    [
        {},
        {"density": "high", "smooth_depth": True},
        {"density": "low", "invert_depth": False, "fov": 70.0},
    ],
)
def test_pipeline_slice_matches_jax(rng, pair, opts):
    from image_to_pointcloud_tpu.pipeline.graph import DepthPipeline as JPipe
    from image_to_pointcloud_tpu.pipeline.graph import PipelineOptions as JOpts

    jcfg, params, model = pair
    yy, xx = np.mgrid[0:64, 0:80]
    img = np.stack([xx * 3, yy * 4, (xx + yy) * 2], -1) + rng.integers(0, 40, (64, 80, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)

    a = JPipe(jcfg, params, quantized_transfer=False, model_target=56).run(
        img, depth_scale=15.0, options=JOpts(**opts)
    )
    b = DepthPipeline(model, model_target=56).run(
        img, depth_scale=15.0, options=PipelineOptions(**opts)
    )
    assert b.raw_point_count == a.raw_point_count
    assert b.grid_hw == a.grid_hw
    np.testing.assert_array_equal(b.packed[3:6], a.packed[3:6])
    ka, kb = a.packed[6] > 0.5, b.packed[6] > 0.5
    assert (ka == kb).mean() >= 0.995
    both = ka & kb
    rmse = np.sqrt(((a.packed[:3, both] - b.packed[:3, both]) ** 2).sum(0).mean())
    assert rmse < 1e-3
    diff = np.abs(a.depth_preview_gray.astype(int) - b.depth_preview_gray.astype(int))
    assert diff.max() <= 1
    assert b.depth_preview_rgb.shape == a.depth_preview_rgb.shape
    assert len(b.points) == b.kept_point_count == int(kb.sum())


def test_pipeline_batch_equals_single_runs(rng, pair):
    _, _, model = pair
    pipe = DepthPipeline(model, model_target=56)
    imgs = rng.integers(0, 256, (3, 48, 60, 3), dtype=np.uint8)
    batch = pipe.run_batch(imgs, depth_scales=[5.0, 10.0, 15.0])
    for img, s, res in zip(imgs, [5.0, 10.0, 15.0], batch):
        one = pipe.run(img, depth_scale=s)
        np.testing.assert_allclose(res.packed, one.packed, rtol=0, atol=1e-4)


def test_launch_counters_untouched_on_cpu(rng, pair):
    """The CPU path never counts a kernel launch."""
    before = [k.launches for k in cuda.KERNELS]
    _, _, model = pair
    DepthPipeline(model, model_target=56).run(
        rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    )
    assert [k.launches for k in cuda.KERNELS] == before
