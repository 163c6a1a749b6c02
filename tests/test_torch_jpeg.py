"""The PyTorch port's hybrid JPEG ingest against the JAX package, on the
CPU.

The host half (``native`` entropy decode, sparse block pack, payload
layouts) is shared or copied, so its products must be equal; the device
half (sparse scatter, dequant + IDCT + chroma upsample + colour, in
torch) takes the same coefficients as the JAX package's. Tolerances:
scatter and payload bytes exact; the port's sparse decode equal to its
dense decode bit for bit; decoded RGB within 1 level of JAX's (f32 sums
in another order can move a value across a rounding boundary) and within
libjpeg's ±3-4 levels of PIL's; the slice as tests/test_torch_model.py's
(keep masks agree on ≥ 99.5 % of points, per-point RMSE < 1e-3).
"""

from __future__ import annotations

import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu import native as jnative
from image_to_pointcloud_tpu.ops import jpeg as jjpeg
from image_to_pointcloud_tpu.ops import jpeg_sparse as jsparse
from image_to_pointcloud_tpu.pipeline import graph as jgraph
from image_to_pointcloud_tpu_torch import native
from image_to_pointcloud_tpu_torch.ops import jpeg as tjpeg
from image_to_pointcloud_tpu_torch.ops import jpeg_sparse as tsparse
from image_to_pointcloud_tpu_torch.pipeline import graph

sys.path.insert(0, str(Path(__file__).resolve().parent))


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not (native.available() and jnative.available()):
        pytest.skip("the native library (g++ build) is unavailable")


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _photo(w=120, h=88, noise=8.0, seed=0):
    """Photograph-like content: smooth fields + moderate texture."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 4 * np.pi, w)
    y = np.linspace(0, 3 * np.pi, h)
    base = np.stack(
        [
            127 + 110 * np.sin(x)[None, :] * np.cos(y)[:, None],
            127 + 90 * np.cos(2 * x)[None, :] + 0 * y[:, None],
            127 + 70 * np.sin(y)[:, None] + 0 * x[None, :],
        ],
        -1,
    )
    return (base + rng.normal(0, noise, base.shape)).clip(0, 255).astype(np.uint8)


def _encode(img, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _specs(r, k):
    fields = (r["width"], r["height"], r["ncomp"], tuple(r["h"]), tuple(r["v"]), k)
    return jjpeg.JpegSpec(*fields), tjpeg.JpegSpec(*fields)


# ---------- device decode ----------


@pytest.mark.parametrize(
    "kw,gray,tol", [({"subsampling": 0}, False, 3), ({"subsampling": 1}, False, 4),
                    ({"subsampling": 2}, False, 4), ({}, True, 3)]
)
@pytest.mark.parametrize("k", [8, 2])
def test_decode_matches_jax_and_pil(kw, gray, tol, k):
    from PIL import Image

    img = _photo(w=250, h=179)
    data = _encode(img[..., 0] if gray else img, quality=88, **kw)
    r = native.jpeg_coefficients(data)
    jspec, tspec = _specs(r, k)
    co = [jjpeg.host_truncate_coeffs(c, k) for c in r["coeffs"]]
    qt = r["qtables"].astype(np.float32)
    ref = np.asarray(jjpeg.decode_jpeg_to_rgb(tuple(co), qt, jspec))
    ours = tjpeg.decode_jpeg_to_rgb(tuple(_t(c) for c in co), _t(qt), tspec).numpy()
    assert ours.shape == ref.shape == (*tspec.out_hw, 3)
    assert np.abs(ours - ref).max() <= 1.0
    # Batched: the same planes, bit for bit.
    batched = tjpeg.decode_jpeg_to_rgb(
        tuple(_t(np.stack([c, c])) for c in co), _t(np.stack([qt, qt])), tspec
    ).numpy()
    np.testing.assert_array_equal(batched[1], ours)
    if k == 8:
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32)
        assert np.abs(ours - pil).max() <= tol


def _random_coeffs(spec, density, seed):
    rng = np.random.default_rng(seed)
    out = []
    for c in range(spec.ncomp):
        bh, bw = spec.block_grid(c)
        vals = rng.integers(-1024, 1024, (bh, bw, spec.k, spec.k))
        out.append((vals * (rng.random(vals.shape) < density)).astype(np.int16))
    return out


def _padded(packed, cap, ecap):
    """The packer's padding of one image's sparse streams to the buckets."""
    counts, dc, pos, val, exc_idx, exc_val = packed
    ppos, pval = np.zeros(cap, np.uint8), np.zeros(cap, np.int8)
    ppos[: len(pos)], pval[: len(val)] = pos, val
    pei, pev = np.full(ecap, cap, np.int32), np.zeros(ecap, np.int16)
    pei[: len(exc_idx)], pev[: len(exc_val)] = exc_idx, exc_val
    return counts.astype(np.int32), dc, ppos.astype(np.int32), pval, pei, pev


@pytest.mark.parametrize(
    "w,h,ncomp,k,density",
    [(250, 179, 3, 8, 0.1), (250, 179, 3, 2, 0.3), (64, 64, 1, 8, 0.05), (64, 48, 1, 1, 0.5)],
)
def test_scatter_matches_jax(w, h, ncomp, k, density):
    """±1024 coefficients: most AC nonzeros are wide, so the exception
    channel is exercised too."""
    jspec = jjpeg.JpegSpec(w, h, ncomp, (2, 1, 1)[:ncomp], (2, 1, 1)[:ncomp], k)
    tspec = tjpeg.JpegSpec(w, h, ncomp, jspec.h, jspec.v, k)
    imgs = [_random_coeffs(jspec, density, seed) for seed in (0, 1)]
    packs = [tsparse.block_pack(co) for co in imgs]
    for co, p in zip(imgs, packs):
        for a, b in zip(p, tsparse._block_pack_numpy(co)):
            np.testing.assert_array_equal(a, b)
    _, total = tsparse.coeff_layout(tspec)
    cap = tsparse.capacity_bucket(max(len(p[2]) for p in packs), total)
    ecap = tsparse.exception_bucket(max(len(p[4]) for p in packs))
    fields = [_padded(p, cap, ecap) for p in packs]
    ours = tsparse.scatter_from_blocks(*(_t(np.stack(f)) for f in zip(*fields)), tspec)
    for i, (co, f) in enumerate(zip(imgs, fields)):
        ref = jsparse.scatter_from_blocks(*f, jspec)
        for c in range(ncomp):
            np.testing.assert_array_equal(ours[c][i].numpy(), np.asarray(ref[c]))
            np.testing.assert_array_equal(ours[c][i].numpy(), co[c])


# ---------- host planning and payloads ----------


def test_plan_and_payloads_match_jax():
    datas = [_encode(_photo(seed=s), quality=88) for s in (0, 1)]
    ours = [graph.plan_jpeg_input(d) for d in datas]
    refs = [jgraph.plan_jpeg_input(d) for d in datas]
    for a, b in zip(refs, ours):
        assert b is not None and _same_spec(a.spec, b.spec)
        for x, y in zip(a.coeffs, b.coeffs):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.qtables, b.qtables)
        for x, y in zip(a.sparse(), b.sparse()):
            np.testing.assert_array_equal(x, y)
    caps = graph.plan_sparse_batch(ours)
    assert caps is not None and caps == jgraph.plan_sparse_batch(refs)
    scales = np.float32([15.0, 2.5])
    np.testing.assert_array_equal(
        graph.DepthPipeline.pack_jpeg_sparse_payload(ours, scales, *caps),
        jgraph.DepthPipeline.pack_jpeg_sparse_payload(refs, scales, *caps),
    )
    np.testing.assert_array_equal(
        graph.DepthPipeline.pack_jpeg_payload(ours, scales),
        jgraph.DepthPipeline.pack_jpeg_payload(refs, scales),
    )


def _same_spec(jspec, tspec) -> bool:
    keys = ("width", "height", "ncomp", "h", "v", "k")
    return all(getattr(jspec, k) == getattr(tspec, k) for k in keys)


def test_plan_declines_what_the_jax_planner_declines():
    from image_to_pointcloud_tpu_torch.io.image import encode_png

    noise = np.random.default_rng(0).integers(0, 256, (96, 96, 3), dtype=np.uint8)
    for data in (encode_png(noise), _encode(noise, quality=100)):
        assert jgraph.plan_jpeg_input(data) is None
        assert graph.plan_jpeg_input(data) is None


def test_sparse_decode_equals_dense_decode():
    """Both payloads of the same batch decode to the same pixels, bit for
    bit, and carry the same depth scales."""
    jpegs = [graph.plan_jpeg_input(_encode(_photo(seed=s), quality=88)) for s in (0, 1)]
    spec = jpegs[0].spec
    scales = np.float32([15.0, 2.5])
    caps = graph.plan_sparse_batch(jpegs)
    sparse = _t(graph.DepthPipeline.pack_jpeg_sparse_payload(jpegs, scales, *caps))
    dense = _t(graph.DepthPipeline.pack_jpeg_payload(jpegs, scales))
    img_s, sc_s = graph._unpack_jpeg_sparse_batch(sparse, spec, *caps)
    img_d, sc_d = graph._unpack_jpeg_batch(dense, spec)
    assert img_s.shape == (2, *spec.out_hw, 3)
    assert torch.equal(img_s, img_d)
    np.testing.assert_array_equal(sc_s.numpy(), scales)
    np.testing.assert_array_equal(sc_d.numpy(), scales)


# ---------- the JPEG slice against JAX's ----------


@pytest.fixture(scope="module")
def pair():
    from test_torch_model import _flax_pair

    return _flax_pair(layers=4, out_layers=(0, 1, 2, 3))


@pytest.mark.parametrize(
    "quantized,host_colors", [(True, True), (True, False), (False, True)]
)
def test_jpeg_slice_matches_jax(pair, monkeypatch, quantized, host_colors):
    jcfg, params, model = pair
    if not host_colors:
        monkeypatch.setenv("IPC_TPU_HOST_COLORS", "0")
    data = _encode(_photo(), quality=88)
    a = jgraph.DepthPipeline(jcfg, params, quantized_transfer=quantized, model_target=56).run_jpeg(
        jgraph.plan_jpeg_input(data), depth_scale=15.0
    )
    pipe = graph.DepthPipeline(model, model_target=56, quantized_transfer=quantized)
    b = pipe.run_jpeg(graph.plan_jpeg_input(data), depth_scale=15.0)
    assert b.raw_point_count == a.raw_point_count and b.grid_hw == a.grid_hw
    ka, kb = a.packed[6] > 0.5, b.packed[6] > 0.5
    assert (ka == kb).mean() >= 0.995
    both = ka & kb
    assert np.sqrt(((a.packed[:3, both] - b.packed[:3, both]) ** 2).sum(0).mean()) < 1e-3
    # Host colours come from one native routine on both sides; device
    # colours from two decodes that differ by ≤ 1 level (± the 4:2:0
    # ride-along's own rounding).
    col = np.abs(a.packed[3:6] - b.packed[3:6]).max()
    assert col == 0 if (quantized and host_colors) else col <= 2
    if quantized:
        # The native fused reconstruct equals the numpy path.
        fast = pipe.run_jpeg(graph.plan_jpeg_input(data), depth_scale=15.0, want_packed=False)
        np.testing.assert_array_equal(fast.points, b.points)
        np.testing.assert_array_equal(fast.colors, b.colors)
