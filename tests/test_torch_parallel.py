"""The port's ``parallel/`` (mesh, TP rules, meshed model and pipeline,
sequence and ring attention) against the JAX package's, on the CPU.

Each JAX mesh uses the eight fake CPU devices of ``tests/conftest.py``;
each port mesh is ``["cpu"] * n`` slots. Tiny models (hidden 32, 4
layers, 2 heads) carry their randomized Flax weights across by
``models/bridge.py`` (biases and LayerScales random too, so a bias added
once per slot instead of once shows). Tolerances:

* TP=2/DP=4 forwards: 5e-5 max-normalized against JAX's ``shard_params``
  forward (PARITY.md's model tolerance), and 1e-5 absolute against the
  port's own unsharded forward; the int8 encoder bit for bit against the
  port's unsharded int8 encoder;
* sequence-sharded and ring attention: 1e-5 against the JAX functions;
* the meshed ``DepthPipeline``: equal kept counts, per-point RMSE < 1e-3
  against JAX's meshed pipeline (and the port's unmeshed one).
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.models import depth_anything as tda
from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax
from image_to_pointcloud_tpu_torch.parallel import sharding as ts

CPU = torch.device("cpu")


def cpu_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return ts.make_mesh(**axes, devices=[CPU] * n)


def da_pair(seed: int = 0, layers: int = 4, out_layers=(0, 1, 2, 3)):
    """(JAX config, randomized Flax params, port model): tests/
    test_torch_model.py's tiny DA-V2 with every leaf randomized."""
    from test_torch_families import _randomize
    from test_torch_model import _flax_pair

    jcfg, params, model = _flax_pair(seed, layers=layers, out_layers=out_layers)
    params = _randomize(params, np.random.default_rng(seed))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jcfg, params, model.eval()


@functools.lru_cache(maxsize=None)
def family_pair(family: str):
    """(JAX config, Flax params, port model) of ``family``, or ``int8``:
    the int8 DA-V2 (built once per module: Flax init is slow on the CPU;
    the tests do not change the models)."""
    if family == "int8":
        return int8_pair(*family_pair("depth_anything"))
    if family == "depth_anything":
        return da_pair()
    from test_torch_families import _pair

    return _pair(family)


def int8_pair(jcfg, params, model):
    """The int8 W8A8 counterparts: (JAX config, JAX int8 params, port
    int8 model)."""
    from image_to_pointcloud_tpu.models.quantize import quantize_encoder_params as jq

    qparams = jax.tree_util.tree_map(np.asarray, jq(params, jcfg.backbone.num_layers))
    qmodel = tda.build_model(model.cfg.with_quantized(True))
    qmodel.load_state_dict(state_dict_from_flax(qparams), strict=True)
    return jcfg.with_quantized(True), qparams, qmodel.eval()


def _side(family: str) -> int:
    return 56 if family == "depth_anything" else 64  # whole patches of 14 or 16


# ---------- the mesh ----------


def test_mesh_shapes_and_slot_count(caplog):
    from image_to_pointcloud_tpu_torch.parallel.pipeline_par import make_pipe_mesh

    # The default slots are every visible CUDA device: no quiet CPU mesh.
    if torch.cuda.is_available():
        assert ts.make_mesh().devices.flat[0].type == "cuda"
    else:
        for build in (ts.make_mesh, functools.partial(make_pipe_mesh, 1)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                build()
    assert ts.make_mesh(devices=[CPU]).shape == {"data": 1, "model": 1, "seq": 1}
    mesh = ts.make_mesh(model=4, devices=[CPU] * 8)
    assert mesh.shape == {"data": 2, "model": 4, "seq": 1}
    assert mesh.axis_names == ("data", "model", "seq")
    assert mesh.devices.shape == (2, 4, 1) and all(d == CPU for d in mesh.devices.flat)
    assert make_pipe_mesh(4, devices=[CPU] * 8).shape == {"data": 2, "pipe": 4}
    with caplog.at_level(logging.WARNING):
        ts.make_mesh(data=2, devices=[CPU] * 8)
    assert "uses 2 of 8 devices; 6 idle" in caplog.text
    with pytest.raises(ValueError, match="more slots than devices"):
        ts.make_mesh(data=2, model=2, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="more slots than devices"):
        make_pipe_mesh(4, data=2, devices=[CPU] * 4)


@pytest.mark.parametrize("axis", ["model", "pipe"])
def test_slot0_holds_its_share_of_the_encoder(axis):
    """On a mesh the pipeline keeps no whole encoder: its model is the
    trunk without blocks, and slot 0 holds 1/model of every split block
    parameter (each in its own storage, not a view of the whole tensor),
    or the 1/pipe of the blocks that is its stage."""
    from image_to_pointcloud_tpu_torch.parallel.pipeline_par import make_pipe_mesh
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline

    model = family_pair("depth_anything")[2]  # placed, not changed: its slots are the CPU
    whole = {n: p.numel() for n, p in model.backbone.blocks.named_parameters()}
    if axis == "model":
        pipe = DepthPipeline(model, mesh=cpu_mesh(data=1, model=2))
        split = {n: p for n, p in pipe.meshed.shards[0].named_parameters()
                 if "model" in ts.param_sharding_rules(f"backbone.blocks.{n}")}
        assert len(split) == 10 * 4  # q, k, v, fc1: weight and bias; proj, fc2: weight
        assert 2 * sum(p.numel() for p in split.values()) == sum(whole[n] for n in split)
        assert all(p.untyped_storage().nbytes() == p.numel() * p.element_size()
                   for p in split.values())
    else:
        pipe = DepthPipeline(model, mesh=make_pipe_mesh(4, data=1, devices=[CPU] * 4))
        stage0 = pipe.meshed._rows[0][2][0]["blocks"]
        assert 4 * sum(p.numel() for p in stage0.parameters()) == sum(whole.values())
    assert len(pipe.model.backbone.blocks) == 0


# ---------- the TP rules ----------


def _flax_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _nest(path, leaf):
    out = leaf
    for k in reversed(path):
        out = {k: out}
    return out


@pytest.mark.parametrize("family", ["depth_anything", "dpt_classic", "zoedepth", "int8"])
def test_every_jax_rule_has_its_counterpart(family):
    """For every parameter, the port's spec is the JAX PartitionSpec of
    the Flax path mapped through the bridge (reversed for a transposed
    kernel), and shard_params places each model slot's piece."""
    from image_to_pointcloud_tpu.parallel.sharding import param_sharding_rules as jrule

    jcfg, params, model = family_pair(family)
    mesh = cpu_mesh(data=1, model=2)
    n_split = 0
    for path, leaf in _flax_leaves(params):
        (name, t), = state_dict_from_flax(_nest(path, leaf)).items()
        spec = tuple(jrule("/".join(path)))
        if path[-1] in ("kernel", "kernel_q") and leaf.ndim == 2:
            spec = spec[::-1]
        assert ts.param_sharding_rules(name) == spec, (path, name)
        if "model" in spec:
            n_split += 1
            dim = spec.index("model")
            placed = ts.device_put(t, ts.NamedSharding(mesh, spec))
            for m in range(2):
                assert torch.equal(placed.slot(model=m), t.chunk(2, dim)[m]), name
            assert torch.equal(placed.gather(), t)
    # q, k, v, proj, fc1, fc2: kernel + bias (BEiT: k has no bias, the
    # table is split), or the int8 kernel_q + kernel_scale + bias.
    per_block = {"depth_anything": 10, "dpt_classic": 10, "zoedepth": 10, "int8": 14}[family]
    assert n_split == per_block * jcfg.backbone.num_layers


# ---------- TP forwards ----------


@pytest.fixture(scope="module")
def jax_tp_mesh():
    from image_to_pointcloud_tpu.parallel.sharding import make_mesh

    return make_mesh(model=2)  # data=4 over the 8 fake devices


@pytest.mark.parametrize("family", ["depth_anything", "int8", "zoedepth", "dpt_classic"])
def test_tp_forward_matches_jax(family, jax_tp_mesh):
    from image_to_pointcloud_tpu.models import build_model
    from image_to_pointcloud_tpu.parallel.sharding import batch_sharding, shard_params

    jcfg, params, model = family_pair(family)
    side = _side("depth_anything" if family == "int8" else family)
    x = np.random.default_rng(1).normal(0, 1, (4, side, side, 3)).astype(np.float32)

    jmodel = build_model(jcfg)
    sharded = shard_params(params, jax_tp_mesh)
    xs = jax.device_put(jnp.asarray(x), batch_sharding(jax_tp_mesh, 4))
    ref = np.asarray(jax.jit(lambda p, xx: jmodel.apply({"params": p}, xx))(sharded, xs))

    meshed = ts.MeshedModel(model, cpu_mesh(data=4, model=2))
    with torch.no_grad():
        ours = meshed(torch.from_numpy(x))
        plain = model(torch.from_numpy(x))
    if family == "int8":
        # Bit for bit (codes, accumulator, output): TP=2 against the
        # unsharded int8 encoder on the same batch, and TP=2/DP=4 against
        # it on each data slot's row (the CPU's f32 BLAS rounds by batch
        # size, which moves an int8 code upstream of a quantizer).
        with torch.no_grad():
            tp_only = ts.MeshedModel(model, cpu_mesh(data=1, model=2))(torch.from_numpy(x))
            rows = torch.cat([model(torch.from_numpy(x[i : i + 1])) for i in range(4)])
        assert torch.equal(tp_only, plain) and torch.equal(ours, rows)
    else:
        assert float((ours - plain).abs().max()) <= 1e-5
    scale = max(float(np.abs(ref).max()), 1e-6)
    tol = 5e-5
    if family == "int8":
        # An f32 difference upstream of a quantizer can move one int8 code
        # (tests/test_torch_quantize.py's model bar); the rest to 5e-5.
        diff = np.abs(ours.numpy() - ref) / scale
        assert np.mean(diff > tol) < 0.01 and diff.max() < 1e-2, (np.mean(diff > tol), diff.max())
    else:
        np.testing.assert_allclose(ours.numpy() / scale, ref / scale, atol=tol)


def test_tp_slot_runs_its_own_heads():
    """A model slot's block has heads/model heads of the full head width:
    multi_head_attention gets the local count (3 heads of 64 read as 6 of
    32 would compute something else without error)."""
    _, _, model = family_pair("depth_anything")
    meshed = ts.MeshedModel(model, cpu_mesh(data=1, model=2))
    blk = meshed.shards[0][0]
    assert blk.num_heads == 1 and blk.q.out_features == 16 and blk.mlp.fc1.out_features == 64
    assert meshed.shards[0][0].q.weight.data_ptr() != meshed.shards[1][0].q.weight.data_ptr()
    sd = meshed.gathered_state_dict()
    assert set(sd) == set(model.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())


def test_int8_row_parallel_is_bit_exact():
    """One row-parallel QuantLinear pair (fc1 → fc2 at DA-V2's 4x MLP
    ratio) over two slots equals the unsharded layers bit for bit, with
    rows whose max |x| lies in either slot's half."""
    from image_to_pointcloud_tpu_torch.models.quantize import QuantLinear, quantize_dense_params

    r = np.random.default_rng(2)
    w = torch.from_numpy(r.normal(0, 0.05, (32, 128)).astype(np.float32))
    b = torch.from_numpy(r.normal(0, 0.1, 32).astype(np.float32))
    full = QuantLinear(128, 32)
    full.load_state_dict(quantize_dense_params(w, b))
    x = torch.from_numpy(r.normal(0, 1, (40, 128)).astype(np.float32))
    x[::2, 5] = 9.0   # the row max in slot 0's features
    x[1::2, 100] = -9.0  # in slot 1's
    placed = ts.shard_params({f"blocks.0.mlp.fc2.{k}": v for k, v in full.state_dict().items()},
                             cpu_mesh(data=1, model=2))
    halves = []
    for m in range(2):
        lay = QuantLinear(64, 32)
        lay.load_state_dict({k.rsplit(".", 1)[1]: s.slot(model=m) for k, s in placed.items()})
        halves.append(lay)
    assert torch.equal(ts.row_parallel(halves, list(x.chunk(2, dim=-1))), full(x))


# ---------- sequence and ring attention ----------


@pytest.mark.parametrize("fn", ["sequence_sharded_attention", "ring_attention"])
def test_context_attention_matches_jax(fn):
    from image_to_pointcloud_tpu.parallel import context as jctx
    from image_to_pointcloud_tpu.parallel.sharding import make_mesh

    from image_to_pointcloud_tpu_torch.parallel import context

    r = np.random.default_rng(0)
    q, k, v = (r.normal(0, 1, (2, 2, 64, 16)).astype(np.float32) for _ in range(3))
    ref = np.asarray(getattr(jctx, fn)(*map(jnp.asarray, (q, k, v)), make_mesh(data=1, seq=8)))
    mesh = cpu_mesh(data=1, seq=8)
    parts = [list(torch.from_numpy(a).chunk(8, dim=2)) for a in (q, k, v)]
    out = getattr(context, fn)(*parts, mesh)
    assert len(out) == 8 and out[0].shape == (2, 2, 8, 16)
    np.testing.assert_allclose(torch.cat(out, dim=2).numpy(), ref, atol=1e-5)
    with pytest.raises(ValueError, match="one tensor per 'seq' slot"):
        getattr(context, fn)(*(p[:4] for p in parts), mesh)


# ---------- the meshed pipeline ----------


def _rmse(a, b) -> float:
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


def test_meshed_pipeline_matches_jax(jax_tp_mesh):
    """DP=4, TP=2 ``DepthPipeline`` against JAX's on the same mesh shape,
    with batches of 4, 3 and 1 (padded onto the data slots and cut back);
    the PNG ingest and the hybrid JPEG one, the f32 return and the bundle."""
    from image_to_pointcloud_tpu.pipeline.graph import DepthPipeline as JPipe
    from image_to_pointcloud_tpu.pipeline.graph import PipelineOptions as JOpts

    from image_to_pointcloud_tpu_torch.pipeline.graph import (
        DepthPipeline,
        PipelineOptions,
        plan_jpeg_input,
    )
    from test_torch_families import _image, _jpeg_bytes

    jcfg, params, model = family_pair("depth_anything")
    imgs = np.random.default_rng(4).integers(0, 255, (4, 56, 56, 3)).astype(np.uint8)
    jp = JPipe(jcfg, params, model_target=56, mesh=jax_tp_mesh)
    mesh = cpu_mesh(data=4, model=2)
    ours = DepthPipeline(model, model_target=56, mesh=mesh)
    plain = DepthPipeline(model, model_target=56)
    assert ours.device == CPU and ours._data_pad(3) == 1 and ours._data_pad(1) == 3
    for n in (4, 3, 1):
        ref = jp.run_batch(imgs[:n], options=JOpts(density="medium"), want_preview=False)
        got = ours.run_batch(imgs[:n], options=PipelineOptions(density="medium"),
                             want_preview=True)
        base = plain.run_batch(imgs[:n], options=PipelineOptions(density="medium"))
        assert len(got) == n
        for a, b, c in zip(ref, got, base):
            assert a.kept_point_count == b.kept_point_count == c.kept_point_count
            assert _rmse(a.points, b.points) < 1e-3 and _rmse(b.points, c.points) < 1e-3
            np.testing.assert_array_equal(b.colors, c.colors)
            assert np.abs(b.depth_preview_gray.astype(int) - c.depth_preview_gray).max() <= 1
    # The hybrid JPEG ingest on the mesh; then the quantized bundle against
    # the unmeshed bundle, both with the u16 depth codec (IPC_TPU_DEPTH16's):
    # the default tiled codec's coarse steps move on an f32 difference as
    # small as the batch size's rounding, and are the codec's, not the mesh's.
    im = _image()
    jpegs = [plan_jpeg_input(_jpeg_bytes(np.ascontiguousarray(a)))
             for a in (im, im[::-1], im[:, ::-1])]
    assert all(j is not None for j in jpegs)
    opts = PipelineOptions(density="medium")
    got = ours.collect(ours.submit_batch_jpeg(jpegs, options=opts))
    ref = plain.collect(plain.submit_batch_jpeg(jpegs, options=opts))
    bundled = DepthPipeline(model, model_target=56, mesh=mesh, quantized_transfer=True)
    unmeshed = DepthPipeline(model, model_target=56, quantized_transfer=True)
    bundled.depth_bits = unmeshed.depth_bits = 16
    handle = bundled.submit_batch_jpeg(jpegs, options=opts)
    assert handle.quantized and handle.out.dtype == torch.uint8 and handle.out.shape[0] == 3
    ref_b = unmeshed.collect(unmeshed.submit_batch_jpeg(jpegs, options=opts))
    for a, b, c, d in zip(ref, got, bundled.collect(handle), ref_b):
        assert a.kept_point_count == b.kept_point_count == c.kept_point_count
        assert _rmse(a.points, b.points) < 1e-3 and _rmse(c.points, d.points) < 1e-3


def test_manager_mesh_auto_and_explicit():
    """``ModelManager(mesh="auto")`` with one device means no mesh; an
    explicit mesh reaches the pipeline."""
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    assert ModelManager("cpu", mesh="auto").mesh is None
    mm = ModelManager("cpu", mesh=cpu_mesh(data=2, model=2))
    assert mm.mesh.shape == {"data": 2, "model": 2, "seq": 1} and mm.device == CPU
