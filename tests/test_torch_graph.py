"""The port's signature cache (one CUDA graph per signature on the card)
against the JAX package's compiled graph, on the CPU.

``bucket_sizes``, ``pack_payload``, ``select_sparse_caps`` and the cache's
keys are held to the JAX package's exactly. On the CPU a signature's
callable runs its eager body, so ``compiled_graph(...)(pack_payload(...))``
is held bit for bit to ``_run_slots`` on the pixels and scales as the
port moved them before the payload (a float tensor of the pixels, the
scales as f32): the payload's unpack changes no bit. Against JAX's
``compiled_graph`` on the same payload, both returns (the f32 packed
buffer, and the quantized bundle decoded by the port's collect): PARITY.md's
slice tolerance, per-point RMSE < 1e-3 on the points both keep, keep masks
agreeing on >= 99.5 % of the points, colours exact, previews within one
level. Tiny DA-V2 and ZoeDepth configs with the weights carried across by
``models/bridge.py``; inputs from numpy seeds. The launch counters'
capture record and the device constants are checked here too; their
effect on the card (replays counted, capture legal) by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu.pipeline import graph as jgraph
from image_to_pointcloud_tpu.serve import batching as jbatching
from image_to_pointcloud_tpu_torch import cuda
from image_to_pointcloud_tpu_torch.pipeline import graph
from image_to_pointcloud_tpu_torch.serve import batching

sys.path.insert(0, str(Path(__file__).resolve().parent))


def _random_params(jax_model, hw: tuple[int, int], seed: int = 0) -> dict:
    """Seeded random weights for every leaf of a Flax model's tree, as
    numpy (its shapes from ``jax.eval_shape``, so nothing compiles):
    kernels at 1/sqrt(fan in), scales near 1, every other leaf at 0.1."""
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, *hw, 3)))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("scale", "ls1", "ls2"):
            return (1.0 + rng.normal(0.0, 0.2, s.shape)).astype(np.float32)
        std = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if name == "kernel" else 0.1
        return rng.normal(0.0, std, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _bridged(jcfg, port_cfg, hw):
    """(JAX config, random Flax params, the port model with those weights,
    carried across by ``models/bridge.py``)."""
    from image_to_pointcloud_tpu import models as jm
    from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax
    from image_to_pointcloud_tpu_torch.models.depth_anything import build_model

    params = _random_params(jm.build_model(jcfg), hw)
    model = build_model(port_cfg)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jcfg, params, model.eval()


@pytest.fixture(scope="module")
def da_pair():
    from test_torch_model import _tiny_kwargs

    from image_to_pointcloud_tpu import models as jm
    from image_to_pointcloud_tpu.models.dinov2 import DinoV2Config as JBackbone
    from image_to_pointcloud_tpu.models.dpt import DPTConfig as JNeck
    from image_to_pointcloud_tpu_torch.models.depth_anything import DepthAnythingConfig
    from image_to_pointcloud_tpu_torch.models.dinov2 import DinoV2Config
    from image_to_pointcloud_tpu_torch.models.dpt import DPTConfig

    bb, nk = _tiny_kwargs(layers=2, out_layers=(0, 1, 1, 1))
    return _bridged(jm.DepthAnythingConfig(backbone=JBackbone(**bb), neck=JNeck(**nk)),
                    DepthAnythingConfig(backbone=DinoV2Config(**bb), neck=DPTConfig(**nk)),
                    (56, 56))


@pytest.fixture(scope="module")
def zoe_pair():
    from test_torch_families import _jax_cfg, _port_cfg

    return _bridged(_jax_cfg("zoedepth"), _port_cfg("zoedepth"), (64, 64))


# (fixture, model target) of the two families.
FAMILIES = {"da": ("da_pair", 56), "zoe": ("zoe_pair", (64, 96))}


def _images(seed: int, b: int, h: int = 37, w: int = 29) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 7, yy * 5, (xx + yy) * 3], -1)
    return np.clip(base[None] + rng.integers(0, 60, (b, h, w, 3)), 0, 255).astype(np.uint8)


def _jpeg(seed: int, h: int = 72, w: int = 96, noise: int = 20) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 2, yy * 3, xx + yy], -1) + rng.integers(0, noise + 1, (h, w, 3))
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, "JPEG", quality=88)
    return buf.getvalue()


def _plans(data: bytes):
    """The same JPEG planned by both packages, or skip without the native
    library."""
    a, b = jgraph.plan_jpeg_input(data), graph.plan_jpeg_input(data)
    if a is None or b is None:
        pytest.skip("the native library (g++ build) is unavailable")
    return a, b


def _normal_key(key: tuple) -> tuple:
    """A cache key with its dataclasses (options, JpegSpec) as (name,
    fields), so the two packages' keys compare."""
    return tuple((type(k).__name__, dataclasses.astuple(k)) if dataclasses.is_dataclass(k) else k
                 for k in key)


def _assert_slice_agrees(a, b):
    assert b.raw_point_count == a.raw_point_count and b.grid_hw == a.grid_hw
    ka, kb = a.packed[6] > 0.5, b.packed[6] > 0.5
    assert (ka == kb).mean() >= 0.995
    both = ka & kb
    assert np.sqrt(((a.packed[:3, both] - b.packed[:3, both]) ** 2).sum(0).mean()) < 1e-3
    np.testing.assert_array_equal(b.packed[3:6], a.packed[3:6])


# ---------- the host-side pieces, exactly the JAX package's ----------


@pytest.mark.parametrize("max_batch", [1, 3, 5, 8, 16, 24, 32, 48])
def test_bucket_sizes_match_jax(max_batch):
    assert batching.bucket_sizes(max_batch) == jbatching.bucket_sizes(max_batch)


def test_bucket_sizes_of_the_default_max_batch():
    from image_to_pointcloud_tpu_torch.core.config import ServiceConfig

    assert batching.bucket_sizes(ServiceConfig().max_batch) == [1, 2, 4, 8, 12, 16]


def test_pack_payload_bytes_match_jax():
    imgs = _images(0, 3)
    scales = np.array([15.0, 2.5, -1e-3], np.float32)
    ours = graph.DepthPipeline.pack_payload(imgs, scales)
    np.testing.assert_array_equal(ours, jgraph.DepthPipeline.pack_payload(imgs, scales))
    assert ours.dtype == np.uint8 and ours.shape == (3, 37 * 29 * 3 + 4)


def test_select_sparse_caps_ratchets_as_jax(da_pair):
    """One spec's batches: a sparse one, a denser one (the caps ratchet up),
    the sparse one again (they hold): the port's caps are JAX's at each
    step, and never below what the batch alone needs."""
    jcfg, params, model = da_pair
    jpipe = jgraph.DepthPipeline(jcfg, params, model_target=56)
    pipe = graph.DepthPipeline(model, model_target=56)
    smooth, busy = _jpeg(1, noise=2), _jpeg(2, noise=40)
    seq = []
    for data in (smooth, busy, smooth, smooth):
        a, b = _plans(data)
        assert a.spec.height == b.spec.height
        caps = pipe.select_sparse_caps([b, b])
        assert caps == jpipe.select_sparse_caps([a, a])
        alone = graph.plan_sparse_batch([b, b])
        assert caps is not None and caps[0] >= alone[0] and caps[1] >= alone[1]
        seq.append(caps)
    assert seq[1] > seq[0] and seq[2] == seq[3] == seq[1]


def test_cache_holds_one_callable_per_jax_key(da_pair):
    jcfg, params, model = da_pair
    jpipe = jgraph.DepthPipeline(jcfg, params, model_target=56)
    pipe = graph.DepthPipeline(model, model_target=56)
    ja, pa = _plans(_jpeg(3))
    calls = [
        (1, (37, 29), {}, True), (1, (37, 29), {}, True), (2, (37, 29), {}, True),
        (1, (37, 29), {"density": "high"}, True), (1, (40, 29), {}, False),
    ]
    fns = []
    for batch, hw, opts, preview in calls:
        jpipe.compiled_graph(batch, hw, jgraph.PipelineOptions(**opts), preview)
        fns.append(pipe.compiled_graph(batch, hw, graph.PipelineOptions(**opts), preview))
    for sparse_cap, host_colors in [(None, False), ((64, 8), True), ((64, 8), True)]:
        jpipe.compiled_graph_jpeg(2, ja.spec, jgraph.PipelineOptions(), True,
                                  sparse_cap=sparse_cap, host_colors=host_colors)
        fns.append(pipe.compiled_graph_jpeg(2, pa.spec, graph.PipelineOptions(), True,
                                            sparse_cap=sparse_cap, host_colors=host_colors))
    assert {_normal_key(k) for k in pipe._compiled} == {_normal_key(k) for k in jpipe._compiled}
    assert len(pipe._compiled) == 6
    assert fns[0] is fns[1] and fns[-1] is fns[-2]
    assert len({id(f) for f in fns}) == 6


# ---------- the signature's callable: eager on the CPU ----------


@pytest.mark.parametrize("family", ["da", "zoe"])
@pytest.mark.parametrize("quantized", [False, True])
def test_compiled_graph_equals_eager_run_slots(request, family, quantized):
    """The payload's unpack changes no bit: the callable against
    ``_run_slots`` on the pixels and scales handed over as tensors."""
    fixture, target = FAMILIES[family]
    model = request.getfixturevalue(fixture)[2]
    pipe = graph.DepthPipeline(model, model_target=target, quantized_transfer=quantized)
    imgs, scales = _images(4, 3), np.array([15.0, 4.0, 9.5], np.float32)
    opts = graph.PipelineOptions(density="high")
    out, prev = pipe.compiled_graph(3, (37, 29), opts, True)(pipe.pack_payload(imgs, scales))
    ref, ref_prev = pipe._run_slots(
        lambda d, dev: (torch.from_numpy(imgs).float(), torch.from_numpy(scales)),
        (37, 29), opts, True)
    assert torch.equal(out, ref) and torch.equal(prev, ref_prev)


@pytest.mark.parametrize("family", ["da", "zoe"])
@pytest.mark.parametrize("quantized", [False, True])
def test_compiled_graph_matches_jax(request, family, quantized):
    """The same payload through both packages' compiled graph: the port's
    outputs collected by its own handle, JAX's through the port's collect
    too (the bundle's bytes follow one layout), within the slice
    tolerance; previews within one level."""
    fixture, target = FAMILIES[family]
    jcfg, params, model = request.getfixturevalue(fixture)
    jpipe = jgraph.DepthPipeline(jcfg, params, quantized_transfer=quantized, model_target=target)
    pipe = graph.DepthPipeline(model, model_target=target, quantized_transfer=quantized)
    imgs, scales = _images(5, 2, 44, 60), np.array([15.0, 6.0], np.float32)
    payload = pipe.pack_payload(imgs, scales)
    opts = graph.PipelineOptions()
    out, prev = pipe.compiled_graph(2, (44, 60), opts, True)(payload)
    jout, jprev = jpipe.compiled_graph(2, (44, 60), jgraph.PipelineOptions(), True)(
        jpipe.params, jnp.asarray(payload))
    ours = pipe.collect(pipe._handle(out, prev, (44, 60), opts, scales, 2, imgs=imgs))
    ref = pipe.collect(pipe._handle(torch.from_numpy(np.array(jout)),
                                    torch.from_numpy(np.array(jprev)), (44, 60), opts,
                                    scales, 2, imgs=imgs))
    for a, b in zip(ref, ours):
        _assert_slice_agrees(a, b)
        diff = np.abs(a.depth_preview_gray.astype(int) - b.depth_preview_gray.astype(int))
        assert diff.max() <= 1


def test_compiled_graph_jpeg_sparse_and_dense(da_pair):
    """The hybrid ingest's callable on the sparse and the dense payload of
    one batch: the same bits as each other, and JAX's sparse graph within
    the slice tolerance (host colours: one native routine on both sides)."""
    jcfg, params, model = da_pair
    jpipe = jgraph.DepthPipeline(jcfg, params, quantized_transfer=True, model_target=56)
    pipe = graph.DepthPipeline(model, model_target=56, quantized_transfer=True)
    (ja, pa), (jb, pb) = _plans(_jpeg(6)), _plans(_jpeg(7))
    scales = np.array([15.0, 3.0], np.float32)
    caps = pipe.select_sparse_caps([pa, pb])
    assert caps is not None and caps == jpipe.select_sparse_caps([ja, jb])
    sparse = pipe.compiled_graph_jpeg(2, pa.spec, graph.PipelineOptions(), True,
                                      sparse_cap=caps, host_colors=True)(
        pipe.pack_jpeg_sparse_payload([pa, pb], scales, *caps))
    dense = pipe.compiled_graph_jpeg(2, pa.spec, graph.PipelineOptions(), True,
                                     host_colors=True)(pipe.pack_jpeg_payload([pa, pb], scales))
    assert all(torch.equal(s, d) for s, d in zip(sparse, dense))
    jout, jprev = jpipe.compiled_graph_jpeg(2, ja.spec, jgraph.PipelineOptions(), True,
                                            sparse_cap=caps, host_colors=True)(
        jpipe.params, jnp.asarray(jpipe.pack_jpeg_sparse_payload([ja, jb], scales, *caps)))
    host_rgb = np.stack([p.grid_colors(2) for p in (pa, pb)])
    hw = (pa.spec.height, pa.spec.width)
    ours, ref = (
        pipe.collect(pipe._handle(o, p, hw, graph.PipelineOptions(), scales, 2, host_rgb=host_rgb))
        for o, p in (sparse, (torch.from_numpy(np.array(jout)), torch.from_numpy(np.array(jprev))))
    )
    for a, b in zip(ref, ours):
        _assert_slice_agrees(a, b)


# ---------- batches in flight: submit, then collect ----------


def _assert_same_results(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for name in ("points", "colors", "packed", "depth_preview_rgb", "depth_preview_gray"):
            a, b = getattr(g, name), getattr(r, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=name)
        assert (g.raw_point_count, g.kept_point_count, g.grid_hw) == (
            r.raw_point_count, r.kept_point_count, r.grid_hw)


@pytest.mark.parametrize("ingest", ["pixel", "jpeg"])
@pytest.mark.parametrize("quantized", [False, True])
def test_batches_in_flight_collect_in_either_order(da_pair, ingest, quantized):
    """Two batches submitted before either is collected, then collected in
    either order, give the bits of each batch run alone. On the CPU the
    outputs are host tensors already: a collect counts no device copy
    (``ipc_d2h_collects_total``, ``ipc_d2h_ready_total``), and
    ``ipc_d2h_bytes_total`` counts the bundle and the preview it reads."""
    from image_to_pointcloud_tpu_torch.utils import spans

    pipe = graph.DepthPipeline(da_pair[2], model_target=56, quantized_transfer=quantized)
    scales = [np.array([15.0, 4.0], np.float32), np.array([9.5], np.float32)]
    if ingest == "pixel":
        batches = [_images(11, 2), _images(12, 1)]
        ref = [pipe.run_batch(x, depth_scales=s) for x, s in zip(batches, scales)]

        def submit(i):
            return pipe.submit_batch(batches[i], depth_scales=scales[i])
    else:
        batches = [[_plans(_jpeg(s))[1] for s in (13, 14)], [_plans(_jpeg(15))[1]]]

        def submit(i):
            return pipe.submit_batch_jpeg(batches[i], depth_scales=scales[i])

        ref = [pipe.collect(submit(i)) for i in range(2)]
    names = ("ipc_d2h_collects_total", "ipc_d2h_ready_total", "ipc_d2h_bytes_total")
    for order in ((0, 1), (1, 0)):
        handles = [submit(i) for i in range(2)]
        for i in order:
            before = {k: spans.total(k) for k in names}
            _assert_same_results(pipe.collect(handles[i]), ref[i])
            h = handles[i]
            assert h.copied is None and not h.out.is_pinned()
            assert spans.total("ipc_d2h_collects_total") == before["ipc_d2h_collects_total"]
            assert spans.total("ipc_d2h_ready_total") == before["ipc_d2h_ready_total"]
            copied = h.out.numpy().nbytes + h.preview.numpy().nbytes
            assert spans.total("ipc_d2h_bytes_total") - before["ipc_d2h_bytes_total"] == copied


# ---------- the queue and the warmup ----------


def test_queue_pads_a_drain_to_its_bucket(da_pair):
    """Three queued items at ``max_batch=4`` go out as one batch of 4 (the
    last item repeated), and the three waiters get the unpadded batch's
    results."""
    model = da_pair[2]
    pipe = graph.DepthPipeline(model, model_target=56)
    sizes = []
    submit = pipe.submit_batch
    pipe.submit_batch = lambda imgs, **kw: sizes.append(len(imgs)) or submit(imgs, **kw)
    imgs = _images(8, 3)

    async def run():
        queue = batching.BatchingQueue(pipe, max_batch=4, window_ms=200.0)
        try:
            return await asyncio.wait_for(asyncio.gather(
                *(queue.submit(img, 15.0, graph.PipelineOptions()) for img in imgs)), timeout=120)
        finally:
            await queue.close()

    got = asyncio.run(run())
    assert sizes == [4] and len(got) == 3
    ref = graph.DepthPipeline(model, model_target=56).run_batch(imgs, depth_scales=15.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.points, r.points)
        np.testing.assert_array_equal(g.colors, r.colors)


def test_warmup_covers_every_bucket_on_both_ingests(tmp_path):
    """As the JAX package's test of its warmup: with the hybrid ingest on
    and ``max_batch=4``, every bucket is run on each ingest, one JpegInput
    a size shared by every item of a bucket; the port's calls are the JAX
    warmup's, in the same order."""
    from image_to_pointcloud_tpu.serve.app_v1 import V1Service as JService
    from image_to_pointcloud_tpu.serve.models import ModelManager as JManager
    from image_to_pointcloud_tpu_torch.serve.app_v1 import V1Service
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    _plans(_jpeg(9))  # skips without the native library

    def recording(calls):
        class RecordingPipe:
            def run_batch(self, images, depth_scales=None, options=None):
                calls.append(("pixel", len(images), tuple(np.shape(images)[1:3])))
                return []

            def submit_batch_jpeg(self, jpegs, options=None):
                assert len({j.spec for j in jpegs}) == 1
                calls.append(("jpeg", len(jpegs), jpegs[0].orig_hw))
                return "handle"

            def collect(self, handle):
                assert handle == "handle"
                return []

        return RecordingPipe()

    ours, theirs = [], []
    mm = ModelManager("cpu")
    mm._cache["depth-anything-v2"] = recording(ours)
    V1Service(output_dir=str(tmp_path / "port"), models=mm, warmup_sizes=[(64, 64)],
              durable_jobs=False, max_batch=4, jpeg_device_decode=True).warmup()
    jmm = JManager(use_bf16=False, use_flash_attention=False)
    jmm._cache["depth-anything-v2"] = recording(theirs)
    JService(output_dir=str(tmp_path / "jax"), models=jmm, warmup_sizes=[(64, 64)],
             durable_jobs=False, max_batch=4, jpeg_device_decode=True).warmup()
    assert ours == theirs
    assert [c[1] for c in ours if c[0] == "pixel"] == [1, 2, 4]
    assert [c[1] for c in ours if c[0] == "jpeg"] == [1, 2, 4]


# ---------- what makes a capture legal ----------


def test_launches_recorded_in_a_capture_count_on_each_replay():
    """Inside ``recording_launches`` a wrapper's count goes to the record,
    not the counter; each ``replayed`` adds the record; nesting keeps the
    outer record."""
    k1, k2 = cuda.FLASH_ATTENTION, cuda.GRID_KNN
    base = (k1.launches, k2.launches)
    with cuda.recording_launches() as outer:
        k1.count()
        with cuda.recording_launches() as inner:
            k2.count()
        k1.count()
    assert (k1.launches, k2.launches) == base
    assert outer == {k1: 2} and inner == {k2: 1}
    cuda.replayed(outer)
    cuda.replayed(outer)
    k2.count()
    assert (k1.launches, k2.launches) == (base[0] + 4, base[1] + 1)


def test_device_constants_keep_their_bits_and_serve_autograd():
    """The cached constants equal the conversions they replace, bit for bit
    (f32 and bf16 resampling matrices, the mean and std, the keep-bit
    weights), are made once, and are ordinary tensors: one made under
    inference mode still enters a forward that autograd records."""
    from image_to_pointcloud_tpu_torch.ops.resize import resample_matrix, resample_weights
    from image_to_pointcloud_tpu_torch.pipeline.preprocess import IMAGENET_MEAN
    from image_to_pointcloud_tpu_torch.utils.constants import device_constant

    for dtype in (torch.float32, torch.bfloat16):
        like = torch.zeros((), dtype=dtype)
        with torch.inference_mode():
            w = resample_weights(37, 23, "bicubic_pil", like)
        ref = torch.from_numpy(resample_matrix(37, 23, "bicubic_pil")).to(dtype=dtype)
        assert torch.equal(w, ref) and w.dtype == dtype
        assert w is resample_weights(37, 23, "bicubic_pil", like)
        assert not w.is_inference()
    mean = device_constant(("pixel_mean", tuple(IMAGENET_MEAN)), "cpu", torch.float32,
                           lambda: IMAGENET_MEAN)
    assert torch.equal(mean, torch.tensor(IMAGENET_MEAN, dtype=torch.float32))
    x = torch.ones(23, requires_grad=True)
    (w.float().T @ x).sum().backward()
    assert x.grad is not None
