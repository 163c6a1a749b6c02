"""The port's GPipe (``parallel/pipeline_par.py``) against the JAX
package's, on the CPU: every JAX mesh is (data=2, pipe=4) over the eight
fake devices of ``tests/conftest.py``, every port mesh the same over
``["cpu"] * 8`` slots. Each pipelined forward is held against JAX's
``pipelined_*_apply`` (5e-5 max-normalized, PARITY.md's model tolerance)
and against the port's own unmeshed forward (1e-5 absolute); the bare
``gpipe_apply`` over DINOv2 blocks to 1e-5, as tests/test_parallel.py
holds JAX's against its sequential oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax
from image_to_pointcloud_tpu_torch.parallel import pipeline_par as tpp
from test_torch_parallel import CPU, da_pair, family_pair

STAGES, DATA = 4, 2


@pytest.fixture(scope="module")
def jmesh():
    from image_to_pointcloud_tpu.parallel.pipeline_par import make_pipe_mesh

    return make_pipe_mesh(pipe=STAGES, data=DATA)


def pmesh():
    return tpp.make_pipe_mesh(STAGES, data=DATA, devices=[CPU] * (STAGES * DATA))


def _close(ours, ref, tol=5e-5):
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(ours) / scale, np.asarray(ref) / scale, atol=tol)


def test_gpipe_blocks_match_jax_and_sequential(jmesh):
    """Boundary taps (DA-S/B): y and every stage's tap against JAX's
    gpipe_apply and the sequential blocks, 8 blocks, 4 microbatches."""
    from image_to_pointcloud_tpu.models.dinov2 import Block as JBlock
    from image_to_pointcloud_tpu.models.dinov2 import DinoV2Config as JCfg
    from image_to_pointcloud_tpu.parallel import pipeline_par as jpp

    from image_to_pointcloud_tpu_torch.models.dinov2 import Block, DinoV2Config

    layers, hidden = 8, 32
    jblock = JBlock(JCfg(hidden_size=hidden, num_layers=layers, num_heads=2))
    x = np.random.default_rng(0).normal(0, 1, (8, 10, hidden)).astype(np.float32)
    params, key = {}, jax.random.PRNGKey(0)
    for i in range(layers):
        key, sub = jax.random.split(key)
        params[f"block{i}"] = jblock.init(sub, jnp.asarray(x))["params"]
    with jmesh:
        jy, jtaps = jax.jit(lambda p, xx: jpp.gpipe_apply(
            jmesh, jpp.make_stage_fn(jblock), p, xx, num_microbatches=4))(
            jpp.stack_block_params(params, layers, STAGES), jnp.asarray(x))

    cfg = DinoV2Config(hidden_size=hidden, num_layers=layers, num_heads=2)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    blocks = []
    for i in range(layers):
        blk = Block(cfg)
        pre = f"blocks.{i}."
        blk.load_state_dict({k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)})
        blocks.append(blk.eval())
    stacked = tpp.stack_block_params(blocks, layers, STAGES)
    with torch.no_grad():
        y, taps = tpp.gpipe_apply(pmesh(), tpp.make_stage_fn(), stacked, torch.from_numpy(x),
                                  num_microbatches=4)
        ref, bounds = torch.from_numpy(x), []
        for i, blk in enumerate(blocks):
            ref = blk(ref)
            if (i + 1) % (layers // STAGES) == 0:
                bounds.append(ref)
    assert taps.shape == (STAGES, *x.shape)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(taps.numpy(), np.asarray(jtaps), atol=1e-5)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-5)
    for s, bnd in enumerate(bounds):
        np.testing.assert_allclose(taps[s].numpy(), bnd.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="stage count 2"):
        tpp.gpipe_apply(pmesh(), tpp.make_stage_fn(), stacked[:2], torch.from_numpy(x),
                        num_microbatches=4)


def test_tap_indices_require_ascending_out_layers():
    assert tpp.stage_tap_indices(8, 4, (1, 3, 4, 7)) == [1, 1, 0, 1]
    with pytest.raises(AssertionError, match="ascending"):
        tpp.stage_tap_indices(8, 4, (3, 1, 4, 7))


def _jax_pipelined(family, jcfg, params, x, jmesh):
    from image_to_pointcloud_tpu.parallel import pipeline_par as jpp

    build = jpp.build_beit_stage_params if family == "zoedepth" else jpp.build_stage_params
    apply = {"depth_anything": jpp.pipelined_depth_apply,
             "dpt_classic": jpp.pipelined_dpt_classic_apply,
             "zoedepth": jpp.pipelined_zoedepth_apply}[family]
    stages = build(jcfg, params)
    with jmesh:
        return np.asarray(jax.jit(lambda p, sp, px: apply(
            jcfg, p, sp, px, jmesh, num_microbatches=2))(params, stages, jnp.asarray(x)))


@pytest.mark.parametrize("family", ["tapped_da", "dpt_classic", "zoedepth"])
def test_pipelined_forward_matches_jax(family, jmesh):
    """DA with taps mid-stage (the DA-Large pattern: out_layers (1, 3, 4,
    7) of 8, taps 3 and 4 inside stages), classic DPT (CLS-bearing taps)
    and ZoeDepth (BEiT, boundary taps, the bias index on each slot)."""
    if family == "tapped_da":
        jcfg, params, model = da_pair(layers=8, out_layers=(1, 3, 4, 7))
        fam, side = "depth_anything", 28
    else:
        jcfg, params, model = family_pair(family)
        fam, side = family, 64
    x = np.random.default_rng(3).normal(0, 1, (4, side, side, 3)).astype(np.float32)
    ref = _jax_pipelined(fam, jcfg, params, x, jmesh)
    build = tpp.build_beit_stage_params if fam == "zoedepth" else tpp.build_stage_params
    apply = {"depth_anything": tpp.pipelined_depth_apply,
             "dpt_classic": tpp.pipelined_dpt_classic_apply,
             "zoedepth": tpp.pipelined_zoedepth_apply}[fam]
    mesh = pmesh()
    with torch.no_grad():
        got = apply(model, build(model.cfg, model, mesh=mesh), torch.from_numpy(x), mesh,
                    num_microbatches=2)
        plain = model(torch.from_numpy(x))
        served = tpp.PipelinedModel(model, mesh, num_microbatches=2)(torch.from_numpy(x))
    _close(got.numpy(), ref)
    assert float((got - plain).abs().max()) <= 1e-5
    assert float((served - plain).abs().max()) <= 1e-5


def test_pipe_mesh_serves_and_pads():
    """DepthPipeline on (data=2, pipe=4): batches of 4, 3 and 1 (padded
    onto the data slots, microbatches cut to what divides each slot's
    rows) against the unmeshed pipeline; pipe must equal the tap count."""
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline, PipelineOptions

    _, _, model = family_pair("depth_anything")
    imgs = np.random.default_rng(4).integers(0, 255, (4, 56, 56, 3)).astype(np.uint8)
    opts = PipelineOptions(density="medium")
    piped = DepthPipeline(model, model_target=56, mesh=pmesh(), pipe_microbatches=2)
    plain = DepthPipeline(model, model_target=56)
    ref = plain.run_batch(imgs, options=opts)
    for n in (4, 3, 1):
        got = piped.run_batch(imgs[:n], options=opts)
        assert len(got) == n
        for a, b in zip(ref[:n], got):
            assert a.kept_point_count == b.kept_point_count
            np.testing.assert_allclose(a.points, b.points, atol=2e-4)
    with pytest.raises(ValueError, match="must equal the model's stage count"):
        DepthPipeline(model, model_target=56,
                      mesh=tpp.make_pipe_mesh(2, data=1, devices=[CPU] * 2))
