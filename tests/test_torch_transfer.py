"""The PyTorch port's quantized device→host transfer against the JAX
package, on the CPU.

The codecs (``pipeline/transfer.py``) take the same numpy depth as the
JAX package's and must give the same bytes, the depth8t side-list tie
case included; the host halves must invert them. The quantized slice
runs the tiny bridged model through both packages' quantized
``collect``. Tolerances: codec bytes and host decodes exact; slice as
tests/test_torch_model.py's (keep masks agree on ≥ 99.5 % of points,
per-point RMSE < 1e-3) with colours exact on the pixel path.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu.pipeline import graph as jgraph
from image_to_pointcloud_tpu_torch.pipeline import graph, transfer

sys.path.insert(0, str(Path(__file__).resolve().parent))


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _depth(rng, shape):
    """Smooth depth with a few sharp edges, in [0, 1]: the codec's real
    input (wide tiles land in the side list)."""
    b, hh, ww = shape
    yy, xx = np.mgrid[0:hh, 0:ww]
    base = 0.5 + 0.3 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    d = np.broadcast_to(base, shape) + rng.normal(0, 0.01, shape)
    d[:, hh // 3 :, : ww // 2] -= 0.4  # depth edges
    return np.clip(d, 0, 1).astype(np.float32)


# ---------- device codecs: byte-identical ----------


@pytest.mark.parametrize("shape", [(2, 37, 45), (1, 130, 130), (1, 9, 9), (3, 16, 24)])
def test_depth_codecs_byte_identical(rng, shape):
    dn = _depth(rng, shape)
    pairs = [
        (jgraph.pack_depth8t, transfer.pack_depth8t),
        (jgraph.pack_depth12, transfer.pack_depth12),
    ]
    for jax_pack, port_pack in pairs:
        np.testing.assert_array_equal(
            port_pack(_t(dn)).numpy(), np.asarray(jax_pack(jnp.asarray(dn)))
        )
    # The u16 contract, as the JAX graph writes it inline.
    d16 = np.asarray(jnp.round(jnp.asarray(dn) * 65535.0).astype(jnp.uint16))
    np.testing.assert_array_equal(
        transfer.pack_depth16(_t(dn)).numpy(), d16.view(np.uint8).reshape(shape[0], -1)
    )


def test_depth8t_side_list_ties_take_lowest_tile_index():
    """Ten of the 25 tiles share the largest range, and the side list
    holds ceil(25/8) = 4: the lowest four tile indices must win, as under
    ``lax.top_k``, and the bundle bytes must equal the JAX package's."""
    dn = np.full((1, 40, 40), 0.5, np.float32)
    ramp = np.linspace(0.0, 0.6, 64, dtype=np.float32).reshape(8, 8)
    tied = [3, 5, 6, 9, 12, 14, 17, 20, 22, 24]
    for t in range(25):
        ti, tj = divmod(t, 5)
        scale = 1.0 if t in tied else 0.3 + 0.01 * t
        dn[0, ti * 8 : ti * 8 + 8, tj * 8 : tj * 8 + 8] = 0.2 + ramp * scale
    ours = transfer.pack_depth8t(_t(dn)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jgraph.pack_depth8t(jnp.asarray(dn))))
    _, _, t, k = transfer._d8t_geometry(40, 40)
    o = 4 * t + 64 * t
    side_idx = ours[0, o : o + k].astype(int) | (ours[0, o + k : o + 2 * k].astype(int) << 8)
    assert side_idx.tolist() == tied[:k]


def test_keep_bits_byte_identical(rng):
    for n in (64, 67, 1):
        mask = rng.random((3, n)) > 0.4
        np.testing.assert_array_equal(
            transfer.pack_keep_bits(_t(mask)).numpy(),
            np.asarray(jgraph.pack_keep_bits(jnp.asarray(mask))),
        )
        bits = transfer.pack_keep_bits(_t(mask)).numpy()
        back = np.unpackbits(bits, axis=-1, bitorder="little")[:, :n].astype(bool)
        np.testing.assert_array_equal(back, mask)


# ---------- host halves ----------


@pytest.mark.parametrize("shape", [(2, 37, 45), (1, 130, 130)])
def test_host_unpacks_invert(rng, shape):
    dn = _depth(rng, shape)
    b, hh, ww = shape
    d12 = np.round(dn * np.float32(4095.0)).astype(np.uint16)
    flat = transfer.unpack_depth12(transfer.pack_depth12(_t(dn)).numpy(), hh * ww)
    np.testing.assert_array_equal(flat.reshape(shape), d12)

    sec = transfer.pack_depth8t(_t(dn)).numpy()
    assert sec.shape[1] == transfer.depth8t_section_len(hh, ww)
    ours = transfer.unpack_depth8t(sec, hh, ww)
    np.testing.assert_array_equal(ours, jgraph.unpack_depth8t(sec, hh, ww))
    # Side-list tiles decode exactly; coded tiles within the two
    # roundings' range/510 + 0.5 d12 steps.
    th, tw, t, k = transfer._d8t_geometry(hh, ww)
    o = 68 * t
    err = np.abs(ours.astype(int) - d12.astype(int))
    for i in range(b):
        rng_t = sec[i, 2 * t : 3 * t].astype(int) | (sec[i, 3 * t : 4 * t].astype(int) << 8)
        side = sec[i, o : o + k].astype(int) | (sec[i, o + k : o + 2 * k].astype(int) << 8)
        for tile in range(t):
            ti, tj = divmod(tile, tw)
            e = err[i, ti * 8 : ti * 8 + 8, tj * 8 : tj * 8 + 8]
            assert e.max() <= (0 if tile in side else rng_t[tile] / 510 + 0.5)


def test_host_reconstruct_copies_match_jax(rng):
    d16 = rng.integers(0, 4096, (2, 11, 13)).astype(np.uint16)
    d16[0, 3, 4] = 0  # z == 0
    kw = dict(step=2, f=31.2, cx=13.0, cy=11.0, denom=4095.0)
    np.testing.assert_array_equal(
        transfer.depth16_to_xyz(d16, np.float32([10.0, 2.5]), **kw),
        jgraph.depth16_to_xyz(d16, np.float32([10.0, 2.5]), **kw),
    )
    y = rng.integers(0, 256, (2, 11, 13), dtype=np.uint8)
    cb = rng.integers(0, 256, (2, 6, 7), dtype=np.uint8)
    cr = rng.integers(0, 256, (2, 6, 7), dtype=np.uint8)
    np.testing.assert_array_equal(
        transfer.ycc420_to_rgb_f32(y, cb, cr), jgraph.ycc420_to_rgb_f32(y, cb, cr)
    )


# ---------- the transfer default ----------


@pytest.mark.parametrize(
    "device,env,expected",
    [("cpu", None, False), ("cuda", None, True), ("cpu", "1", True), ("cuda", "0", False)],
)
def test_default_quantized_transfer(monkeypatch, device, env, expected):
    if env is None:
        monkeypatch.delenv("IPC_TPU_QUANTIZED", raising=False)
    else:
        monkeypatch.setenv("IPC_TPU_QUANTIZED", env)
    assert graph.default_quantized_transfer(device) is expected


def test_pipeline_transfer_follows_the_default(monkeypatch):
    from test_torch_model import _flax_pair

    _, _, model = _flax_pair()
    monkeypatch.delenv("IPC_TPU_QUANTIZED", raising=False)
    assert graph.DepthPipeline(model).quantized_transfer is False
    monkeypatch.setenv("IPC_TPU_QUANTIZED", "1")
    assert graph.DepthPipeline(model).quantized_transfer is True
    assert graph.DepthPipeline(model, quantized_transfer=False).quantized_transfer is False


# ---------- the quantized slice against JAX's ----------


@pytest.fixture(scope="module")
def pair():
    from test_torch_model import _flax_pair

    return _flax_pair(layers=4, out_layers=(0, 1, 2, 3))


def _img(rng, h=64, w=80):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 3, yy * 4, (xx + yy) * 2], -1) + rng.integers(0, 40, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _assert_slice_agrees(a, b):
    assert b.raw_point_count == a.raw_point_count and b.grid_hw == a.grid_hw
    ka, kb = a.packed[6] > 0.5, b.packed[6] > 0.5
    assert (ka == kb).mean() >= 0.995
    both = ka & kb
    assert np.sqrt(((a.packed[:3, both] - b.packed[:3, both]) ** 2).sum(0).mean()) < 1e-3
    np.testing.assert_array_equal(b.packed[3:6], a.packed[3:6])
    assert len(b.points) == b.kept_point_count == int(kb.sum())


@pytest.mark.parametrize(
    "opts,env",
    [
        ({}, {}),
        ({"density": "high", "smooth_depth": True}, {"IPC_TPU_DEPTH12": "1"}),
        ({"density": "low", "fov": 70.0}, {"IPC_TPU_DEPTH16": "1"}),
        # The working size shrinks on the device: u8 RGB rides along.
        ({}, {"MAX_IMAGE_DIM": 64}),
    ],
)
def test_quantized_slice_matches_jax(rng, pair, monkeypatch, opts, env):
    jcfg, params, model = pair
    for name, value in env.items():
        if name == "MAX_IMAGE_DIM":
            monkeypatch.setattr(jgraph, name, value)
            monkeypatch.setattr(graph, name, value)
        else:
            monkeypatch.setenv(name, value)
    img = _img(rng)
    scales = [15.0, 4.0]
    jpipe = jgraph.DepthPipeline(jcfg, params, quantized_transfer=True, model_target=56)
    pipe = graph.DepthPipeline(model, model_target=56, quantized_transfer=True)
    imgs = np.stack([img, img[::-1]])
    a = jpipe.run_batch(imgs, depth_scales=scales, options=jgraph.PipelineOptions(**opts))
    b = pipe.run_batch(imgs, depth_scales=scales, options=graph.PipelineOptions(**opts))
    for ra, rb in zip(a, b):
        _assert_slice_agrees(ra, rb)
    # The native fused reconstruct (no packed buffer) gives the same cloud.
    fast = pipe.run_batch(
        imgs, depth_scales=scales, options=graph.PipelineOptions(**opts), want_packed=False
    )
    for rf, rb in zip(fast, b):
        np.testing.assert_array_equal(rf.points, rb.points)
        np.testing.assert_array_equal(rf.colors, rb.colors)


def test_quantized_and_f32_returns_agree(rng, pair, monkeypatch):
    """The two device→host returns of the port give one cloud, up to the
    depth quantization: under the u16 contract z moves by at most half a
    step, 0.5·scale/65535 (plus f32 rounding)."""
    _, _, model = pair
    monkeypatch.setenv("IPC_TPU_DEPTH16", "1")
    img = _img(rng)
    q = graph.DepthPipeline(model, model_target=56, quantized_transfer=True).run(img)
    f = graph.DepthPipeline(model, model_target=56, quantized_transfer=False).run(img)
    np.testing.assert_array_equal(q.packed[3:7], f.packed[3:7])
    assert np.abs(q.packed[:3] - f.packed[:3]).max() <= 0.5 * 10.0 / 65535 + 1e-5
