"""Parity of the port's classic-DPT (MiDaS 3.0) and ZoeDepth families with
the JAX package, on the CPU.

Tiny configs (the golden-fixture literals of tests/test_golden_fixtures.py)
are initialized by JAX; every parameter leaf is then replaced by seeded
random numbers, so the zero-initialized leaves (BEiT's relative-position
tables and CLS token) and the unit LayerScales take part, and the Flax
tree crosses to the port through models/bridge.py. Tolerances:

* model forward and golden replay: 5e-5 max-normalized (PARITY.md), on
  the native grid, a larger square grid and a non-square grid, which
  resample the position embeddings (ViT) or the bias tables (BEiT, with
  HF's (width, height) reshape quirk);
* the slice, PNG and hybrid-JPEG ingest: equal point counts, exact
  colours, keep masks agreeing on ≥ 99.5 % of points, per-point RMSE
  < 1e-3 on points both keep, gray preview within ±1 level
  (tests/test_torch_model.py's).
"""

from __future__ import annotations

import dataclasses
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.models import depth_anything as tda
from image_to_pointcloud_tpu_torch.models.beit import BeitConfig, relative_position_index
from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax
from image_to_pointcloud_tpu_torch.models.convert import convert_checkpoint
from image_to_pointcloud_tpu_torch.models.dpt_classic import DPTClassicConfig
from image_to_pointcloud_tpu_torch.models.vit import ViTConfig
from image_to_pointcloud_tpu_torch.models.zoedepth import ZoeDepthConfig
from image_to_pointcloud_tpu_torch.pipeline import preprocess
from image_to_pointcloud_tpu_torch.pipeline.graph import (
    DepthPipeline,
    PipelineOptions,
    plan_jpeg_input,
)

FIXDIR = Path(__file__).resolve().parent / "fixtures"
H = 32

# The golden-fixture configs (tests/test_golden_fixtures.py:90-153), as
# keyword arguments both packages' dataclasses take.
DPT_KW = dict(
    backbone=dict(
        hidden_size=H, num_layers=4, num_heads=2, patch_size=16, pos_embed_size=4,
        out_layers=(0, 1, 2, 3),
    ),
    neck_hidden_sizes=(H // 2, H, H * 2, H * 2),
    fusion_hidden_size=16,
)
ZOE_KW = dict(
    backbone=dict(
        hidden_size=H, num_layers=4, num_heads=2, intermediate_size=H * 2, patch_size=16,
        window_size=4, out_layers=(1, 2, 3, 4),
    ),
    neck_hidden_sizes=(8, 16, 24, 32),
    fusion_hidden_size=16,
    bottleneck_features=16,
    num_relative_features=8,
    bin_embedding_dim=8,
    n_bins=16,
    num_attractors=(4, 3, 2, 1),
)


def _port_cfg(family: str):
    if family == "dpt_classic":
        return DPTClassicConfig(**{**DPT_KW, "backbone": ViTConfig(**DPT_KW["backbone"])})
    return ZoeDepthConfig(**{**ZOE_KW, "backbone": BeitConfig(**ZOE_KW["backbone"])})


def _jax_cfg(family: str):
    from image_to_pointcloud_tpu import models as jm

    if family == "dpt_classic":
        return jm.DPTClassicConfig(**{**DPT_KW, "backbone": jm.ViTConfig(**DPT_KW["backbone"])})
    return jm.ZoeDepthConfig(**{**ZOE_KW, "backbone": jm.BeitConfig(**ZOE_KW["backbone"])})


def _randomize(tree, rng):
    """Every leaf replaced by seeded random numbers of the leaf's own scale
    (0.5 for the all-zero leaves); scales (LayerNorm, LayerScale) near 1."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _randomize(val, rng)
            continue
        val = np.asarray(val)
        if key in ("scale", "ls1", "ls2"):
            out[key] = (1.0 + rng.normal(0.0, 0.2, val.shape)).astype(np.float32)
        else:
            std = float(val.std()) or 0.5
            out[key] = rng.normal(0.0, std, val.shape).astype(np.float32)
    return out


def _pair(family: str, seed: int = 0):
    """(JAX config, randomized Flax params as numpy, port model)."""
    from image_to_pointcloud_tpu.models import build_model

    jcfg = _jax_cfg(family)
    x0 = jnp.zeros((1, 64, 64, 3))
    params = jax.jit(build_model(jcfg).init)(jax.random.PRNGKey(seed), x0)["params"]
    params = _randomize(jax.tree_util.tree_map(np.asarray, params), np.random.default_rng(seed))
    model = tda.build_model(_port_cfg(family))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jcfg, params, model.eval()


@pytest.fixture(scope="module")
def dpt_pair():
    return _pair("dpt_classic")


@pytest.fixture(scope="module")
def zoe_pair():
    return _pair("zoedepth")


def _assert_close_normalized(ours, ref, atol=5e-5):
    assert ours.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(ours / scale, ref / scale, atol=atol)


# ---------- model forwards ----------


@pytest.mark.parametrize("family", ["dpt_classic", "zoedepth"])
@pytest.mark.parametrize("hw", [(64, 64), (96, 96), (64, 96)])
def test_forward_matches_flax(request, family, hw):
    """Native grid, a larger square grid and a non-square one (4×6 patches
    against the 4×4 window): the position-embedding or bias-table
    resampling is on the path in the last two."""
    from image_to_pointcloud_tpu.models import build_model

    jcfg, params, model = request.getfixturevalue(
        "dpt_pair" if family == "dpt_classic" else "zoe_pair"
    )
    x = np.random.default_rng(1).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(build_model(jcfg).apply)({"params": params}, jnp.asarray(x)))
    assert np.abs(ref).max() > 1e-3 and np.isfinite(ref).all()
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    _assert_close_normalized(ours, ref)


@pytest.mark.parametrize("family", ["dpt_classic", "zoedepth"])
def test_golden_replay_through_port_converter(family):
    """The committed HF-oracle fixture through the port's own converter:
    no JAX and no transformers on this path."""
    z = np.load(FIXDIR / f"golden_{family}.npz")
    assert json.loads(bytes(z["meta"]).decode())
    sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd/")}
    cfg = _port_cfg(family)
    model = tda.build_model(cfg)
    model.load_state_dict(convert_checkpoint(cfg, sd), strict=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(z["input"])).numpy()
    _assert_close_normalized(ours, z["output"])


def test_bias_table_resampling_matches_jax():
    """The re-interpolated BEiT bias table and the relative index, against
    the JAX functions, off a non-square window (the reshape quirk)."""
    from image_to_pointcloud_tpu.models import beit as jbeit
    from image_to_pointcloud_tpu_torch.models.beit import _interp_bias_table

    table = np.random.default_rng(2).normal(0, 1, ((2 * 4 - 1) ** 2 + 3, 3)).astype(np.float32)
    ref = np.asarray(jbeit._interp_bias_table(jnp.asarray(table), (4, 4), (5, 7)))
    ours = _interp_bias_table(torch.from_numpy(table), (4, 4), (5, 7)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(relative_position_index(5, 7), jbeit.relative_position_index(5, 7))


def test_bias_table_cache_follows_the_parameter(zoe_pair):
    """The served model resamples each table once per grid; an in-place
    change to the parameter (a checkpoint load) invalidates it."""
    _, _, model = zoe_pair
    attn = model.backbone.blocks[0].attn
    index = model.backbone._rel_index((4, 6), torch.device("cpu"))
    with torch.no_grad():
        a = attn._bias((4, 6), index)
        assert attn._bias((4, 6), index).data_ptr() != 0
        cached = attn._table_cache[1]
        attn._bias((4, 6), index)
        assert attn._table_cache[1] is cached
        saved = attn.rel_pos_table.clone()
        attn.rel_pos_table.add_(1.0)
        b = attn._bias((4, 6), index)
        attn.rel_pos_table.copy_(saved)
    torch.testing.assert_close(b, a + 1.0)


# ---------- presets, dispatch and init ----------


def _fields(cfg) -> dict:
    """Config fields without the JAX package's compute switches."""
    skip = {"dtype", "use_flash_attention", "remat_blocks", "flash_min_seq", "quantized",
            "layer_scale"}
    out = {}
    for f in dataclasses.fields(cfg):
        if f.name in skip:
            continue
        val = getattr(cfg, f.name)
        out[f.name] = _fields(val) if dataclasses.is_dataclass(val) else (
            tuple(val) if isinstance(val, (list, tuple)) else val
        )
    return out


def test_presets_match_jax():
    from image_to_pointcloud_tpu.models.depth_anything import PRESETS as JPRESETS

    assert set(tda.PRESETS) == set(JPRESETS)
    for name, jcfg in JPRESETS.items():
        cfg = tda.preset(name)
        assert type(cfg).__name__ == type(jcfg).__name__, name
        assert _fields(cfg) == _fields(jcfg), name
    with pytest.raises(ValueError, match="Unknown model preset"):
        tda.preset("no-such-model")


@pytest.mark.parametrize("family", ["dpt_classic", "zoedepth"])
def test_init_is_deterministic_with_flax_statistics(family):
    a = tda.init_weights(tda.build_model(_port_cfg(family)), torch.Generator().manual_seed(3))
    b = tda.init_weights(tda.build_model(_port_cfg(family)), torch.Generator().manual_seed(3))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("rel_pos_table", "bias") or (leaf == "cls_token" and family == "zoedepth"):
            assert not pa.any(), name
        elif leaf in ("ls1", "ls2"):
            assert torch.equal(pa, torch.ones_like(pa)), name
        elif leaf in ("cls_token", "pos_embed"):
            assert 0.01 < pa.std() < 0.03, name
    with torch.no_grad():
        d = a(torch.randn(1, 64, 96, 3, generator=torch.Generator().manual_seed(0)))
    assert d.shape == (1, 64, 96) and torch.isfinite(d).all() and (d > 0).any()


# ---------- preprocess ----------


def test_preprocess_spec_and_margins_match_jax():
    from image_to_pointcloud_tpu.models import preset as jpreset
    from image_to_pointcloud_tpu.pipeline import preprocess as jpre

    for family in ("dpt_classic", "zoedepth"):
        for target in (None, 96, (64, 96)):
            assert preprocess.model_preprocess_spec(_port_cfg(family), target) == (
                jpre.model_preprocess_spec(_jax_cfg(family), target)
            )
    da = tda.preset("depth-anything-v2-small")
    assert preprocess.model_preprocess_spec(da) == jpre.model_preprocess_spec(
        jpreset("depth-anything-v2-small")
    )
    for h, w in [(518, 518), (614, 300), (5, 9), (3072, 2048)]:
        for family in ("dpt_classic", "zoedepth"):
            assert preprocess.reflect_pad_margins(_port_cfg(family), h, w) == (
                jpre.reflect_pad_margins(_jax_cfg(family), h, w)
            )
        assert preprocess.processor_output_size(h, w, (384, 512), 32) == (
            jpre.processor_output_size(h, w, (384, 512), 32)
        )


# ---------- the slice ----------


def _image():
    yy, xx = np.mgrid[0:88, 0:120]
    rng = np.random.default_rng(4)
    img = np.stack([xx * 2, yy * 2, (xx + yy)], -1) + rng.integers(0, 40, (88, 120, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _jpeg_bytes(img) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=88)
    return buf.getvalue()


# A fixed 64² for classic DPT (its processor keeps no aspect ratio); a
# (64, 96) tuple target for ZoeDepth, which its reflect pad and crop follow.
_TARGETS = {"dpt_classic": 64, "zoedepth": (64, 96)}


@pytest.mark.parametrize("family", ["dpt_classic", "zoedepth"])
@pytest.mark.parametrize("ingest", ["png", "jpeg"])
def test_slice_matches_jax(request, family, ingest):
    """PNG: pixels through the f32 return. JPEG: the hybrid device decode
    through the quantized bundle with host colours (exact on both
    sides: one native routine rebuilds them)."""
    from image_to_pointcloud_tpu import native as jnative
    from image_to_pointcloud_tpu.pipeline import graph as jgraph
    from image_to_pointcloud_tpu_torch import native

    jcfg, params, model = request.getfixturevalue(
        "dpt_pair" if family == "dpt_classic" else "zoe_pair"
    )
    target = _TARGETS[family]
    img = _image()
    quantized = ingest == "jpeg"
    a_pipe = jgraph.DepthPipeline(jcfg, params, quantized_transfer=quantized, model_target=target)
    b_pipe = DepthPipeline(model, quantized_transfer=quantized, model_target=target)
    if ingest == "png":
        opts = dict(density="high", smooth_depth=True)
        a = a_pipe.run(img, depth_scale=15.0, options=jgraph.PipelineOptions(**opts))
        b = b_pipe.run(img, depth_scale=15.0, options=PipelineOptions(**opts))
    else:
        if not (native.available() and jnative.available()):
            pytest.skip("the native library (g++ build) is unavailable")
        data = _jpeg_bytes(img)
        a = a_pipe.run_jpeg(jgraph.plan_jpeg_input(data), depth_scale=15.0)
        b = b_pipe.run_jpeg(plan_jpeg_input(data), depth_scale=15.0)
    assert b.raw_point_count == a.raw_point_count and b.grid_hw == a.grid_hw
    np.testing.assert_array_equal(b.packed[3:6], a.packed[3:6])
    ka, kb = a.packed[6] > 0.5, b.packed[6] > 0.5
    assert (ka == kb).mean() >= 0.995
    both = ka & kb
    assert np.sqrt(((a.packed[:3, both] - b.packed[:3, both]) ** 2).sum(0).mean()) < 1e-3
    assert b.depth_preview_gray.shape == a.depth_preview_gray.shape
    diff = np.abs(a.depth_preview_gray.astype(int) - b.depth_preview_gray.astype(int))
    assert diff.max() <= 1


def test_zoedepth_preview_is_at_the_working_size(zoe_pair):
    """After the crop the depth grid is the working size, not the model
    input: the preview and the point path both read (h, w)."""
    _, _, model = zoe_pair
    res = DepthPipeline(model, model_target=(64, 96)).run(_image(), depth_scale=10.0)
    assert res.depth_preview_gray.shape == (88, 120)
    assert res.grid_hw == (44, 60)


# ---------- dummy-model graphs ----------


@pytest.mark.parametrize("density", ["low", "medium", "high"])
def test_dummy_point_cloud_graph_bit_identical(density):
    from image_to_pointcloud_tpu.pipeline import graph as jgraph
    from image_to_pointcloud_tpu_torch.pipeline import graph

    img = np.random.default_rng(5).integers(0, 256, (61, 83, 3), dtype=np.uint8)
    pts, cols = graph.dummy_point_cloud_graph(img, density, "cpu")
    rpts, rcols = jgraph.dummy_point_cloud_graph(img, density)
    np.testing.assert_array_equal(pts, rpts)
    np.testing.assert_array_equal(cols, rcols)


def test_demo_depth_map_graph_bit_identical():
    from image_to_pointcloud_tpu.pipeline import graph as jgraph
    from image_to_pointcloud_tpu_torch.pipeline import graph

    img = np.random.default_rng(6).integers(0, 256, (61, 83, 3), dtype=np.uint8)
    ours = graph.demo_depth_map_graph(img, "cpu")
    ref = np.asarray(jgraph.demo_depth_map_graph(jnp.asarray(img)))
    assert ours.dtype == np.uint8 and ours.shape == (61, 83, 3)
    np.testing.assert_array_equal(ours, ref)
