"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero, and the result lines are not printed):

1. device: CUDA must be available; the card's name and power limit.
2. build: the CUDA kernels from ``image_to_pointcloud_tpu_torch/csrc``.
3. K1 flash attention vs its plain version: bf16 (the tensor-core
   kernel) at DA-V2-Small's (1, 6, 1370, 64) and (2, 6, 1370, 64), at
   classic DPT-Large's (1, 16, 577, 64) and at a ragged (1, 3, 65, 64);
   f32 (the SIMT kernel) at (2, 6, 1370, 64). Timed at the two serving
   shapes: device time, host-inclusive time, the plain version's, and
   ``scaled_dot_product_attention``'s on the same tensors (the yardstick,
   never called by the port), beside the bound.
4. K2 grid-kNN vs its plain version, bit for bit, on two inputs at
   (1, 259, 259, 3) — 518² at medium density, one request: points
   uniform in a cube (the worst case: grid position says nothing about
   3-D distance) and a synthetic back-projected depth surface (sinusoids,
   a step edge, 1 % outliers, through K3 as ``graph.py`` calls it; the
   main path's kind of input under a trained model); random cubes at (2, 259, 259, 3), (1, 150,
   200, 3) and (1, 3, 5, 3); the (1, 150, 200, 3) grid with NaN and inf
   points (zero means where the plain version's are); distances below
   2^-101 (the square root's slow path); contiguous (B, hh, ww, 3)
   tensors as well as the planar view, ragged and at batch 2. Both 259²
   inputs are timed beside two bounds (the work no tap order can skip,
   and the reference's full cascade on every tap), with the share of the
   61 taps after the first 20 that insert into the top-20 list, per lane
   and per 8×4 warp (replayed in plain torch). The kernels line reports
   the cube, as every PR has; the surface rides along.
5. K3 unproject vs its plain version, bit for bit, with u8 and f32
   images: (1, 518, 518) step 2 (one request), batch 2, odd N at steps
   1, 2 and 4 (output rows starting at every residue mod 4), even N, and
   a 2-point grid; timed at (1, 518, 518) step 2 with both image types
   beside the bound and the launch floor (a one-element ``zero_()`` on
   the same harness).
6. the transfer codecs on the card vs the CPU, byte for byte.
7. the JPEG device decode of a q88 4:2:0 518² frame: sparse vs dense
   payload bit for bit, card vs CPU within 1 level, vs PIL within 3.
8. the slice on the card vs the slice on the CPU, for tiny configs of
   the three families (Depth-Anything-V2, classic DPT, ZoeDepth) with
   64-wide heads, same weights, f32, TF32 off, through the f32 return
   and through the quantized bundle.
9. the v1 server in this process, bf16, each main path read on its own
   (the launch counters zeroed just before and read just after):
   Depth-Anything-V2-Small with 518² and 400×300 PNG → PLY requests
   through the default quantized bundle, and in a second app with the
   hybrid JPEG ingest five q88 518² JPEG → PLY requests, every one of
   which must take the device decode; then ``dpt-large`` (ViT-L/16,
   384², K1 in all 24 layers) and ``zoedepth`` (BEiT-L/16, 518² padded
   to 614² and run at 512², whose biased attention is plain torch ops,
   so K1 must stay at zero) at full width, random init, one cold and
   three 518² PNG → PLY requests each. Each path must launch K1 exactly
   12 (DA-V2), 24 (``dpt-large``) or 0 (``zoedepth``) times a request,
   and K2 and K3 once.
10. a ``triposr`` request, and the dummy graphs on the card vs the CPU,
    bit for bit.
11. batch-1 ``submit_batch`` + ``collect`` medians, in turns: PNG with
    the f32 return, PNG with the quantized bundle, JPEG with the bundle.
12. ``/profile/start`` and ``/profile/stop`` around one ``dpt-large``
    request: the Chrome trace must exist and name the CUDA kernels. Last,
    so that no profiler session precedes the timings of phase 11.

Each phase logs its wall time. Kernel times: ``device`` is a CUDA graph
of 20 captured calls, replayed and timed with CUDA events (no host time
between launches; the median of 5 replays, per call); ``host-inclusive``
is 50 back-to-back calls between two CUDA events, wrapper and launch
path included. A bound is the larger of the bytes the call must move
(inputs read once, outputs written once) over 3.35 TB/s and its
operations over the H100's peak for their type (989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s f32 on the FP32 cores).

It prints the per-kernel JSON line, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. It needs
the repository checkout (run it from its root) and imports no JAX and
nothing of the JAX package (it checks ``sys.modules`` at the end).
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import uuid

import numpy as np
import torch

# Tolerances (max abs error, kernel vs plain on the same inputs):
# K1 bf16: the plain version rounds logits to bf16 before the softmax
# (the JAX package's _attention_xla storage precision) while the kernel
# keeps them in f32, as the Pallas kernel does: ~2^-8 of a logit of ~4.
K1_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# K2, K3, codecs, sparse vs dense decode: bit-identical (the same
# operations rounded at the same points, no FMA contraction; K2 inserts in
# another order, which leaves its sorted top-20 unchanged).
# JPEG decode: card vs CPU within 1 level (f32 GEMMs sum in another
# order); vs PIL within libjpeg's integer-IDCT tolerance.
JPEG_CPU_TOL, JPEG_PIL_TOL = 1.0, 3.0
# Slice, card vs CPU (the port's CPU parity tolerances; ZoeDepth through
# the quantized bundle: the larger of SLICE_RMSE and the codec's own error,
# see _slice_card_vs_cpu).
SLICE_KEEP_AGREE, SLICE_RMSE = 0.995, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


# The H100's published peaks (NVIDIA's data sheet, SXM, dense).
HBM_BYTES_S, BF16_TC_FLOP_S, F32_FLOP_S = 3.35e12, 989e12, 67e12


def cuda_time_ms(fn, iters: int) -> float:
    """Host-inclusive time of one call: ``iters`` back-to-back calls
    between two CUDA events."""
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call: a CUDA graph of ``calls`` captured calls,
    replayed and timed with CUDA events; the median replay, per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(nbytes: float, ops: float, rate: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak for their type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _timed_kernel(name: str, kernel, plain, library=None) -> dict:
    """The kernel's device and host-inclusive times, the plain version's,
    and the library call's device time where there is one."""
    out = {"ms": device_time_ms(kernel), "host_ms": cuda_time_ms(kernel, 50),
           "plain_ms": cuda_time_ms(plain, 5),
           "library_ms": None if library is None else device_time_ms(library)}
    out["device_ms"] = out["ms"]
    lib = "none" if library is None else f"{out['library_ms']:.5f} ms"
    log(f"{name}: device {out['ms']:.5f} ms, host-inclusive {out['host_ms']:.5f} ms, "
        f"plain {out['plain_ms']:.5f} ms, library {lib}")
    return out


def phase_k1() -> dict:
    from image_to_pointcloud_tpu_torch.models.attention import attention_plain, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    timed = {}
    for shape, dtype in [((1, 6, 1370, 64), torch.bfloat16), ((2, 6, 1370, 64), torch.bfloat16),
                         ((1, 16, 577, 64), torch.bfloat16), ((1, 3, 65, 64), torch.bfloat16),
                         ((2, 6, 1370, 64), torch.float32)]:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        o = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention_plain(q, k, v, 1.0 / 8.0)
        torch.cuda.synchronize()
        err = (o.float() - ref).abs().max().item()
        tol = K1_TOL[dtype]
        log(f"K1 {tuple(shape)} {str(dtype)[6:]}: max_abs_err {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"K1 disagrees with its plain version at {shape} {dtype}")
        if dtype == torch.bfloat16 and shape in ((1, 6, 1370, 64), (1, 16, 577, 64)):
            b, h, n, d = shape
            flops = 4 * b * h * n * n * d  # Q·Kᵀ and P·V, 2 per multiply-add
            res = {"shape": list(shape), "max_abs_err": err, **_timed_kernel(
                f"K1 {shape} bf16", lambda: flash_attention(q, k, v),
                lambda: attention_plain(q, k, v, 1.0 / 8.0),
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
                **bound(4 * b * h * n * d * 2, flops, BF16_TC_FLOP_S)}
            log(f"K1 {shape} bf16: {flops / 1e9:.3f} GFLOP, {b * h * n * n / 1e6:.2f} M "
                f"exponentials, {4 * b * h * n * d * 2 / 1e6:.2f} MB: bound {res['bound_ms']:.5f} "
                f"ms ({res['bound_by']})")
            timed[shape] = res
    # The line's numbers are DA-V2-Small's at one image; classic DPT-Large's ride along.
    return {**timed[(1, 6, 1370, 64)], "also": [timed[(1, 16, 577, 64)]]}


def _knn_taps(hh: int, ww: int, r: int = 4) -> int:
    """Window taps inside an (hh, ww) grid, summed over its points."""
    def line(n):
        return sum(min(i + r, n - 1) - max(i - r, 0) + 1 for i in range(n))

    return line(hh) * line(ww)


# The order in which K2 visits its 81 window taps: ascending dy² + dx²,
# ties by (dy, dx) (csrc/grid_knn.cu's centre_out()).
KNN_CENTRE_OUT = sorted(((dy, dx) for dy in range(-4, 5) for dx in range(-4, 5)),
                        key=lambda o: (o[0] ** 2 + o[1] ** 2, o))


def knn_cube(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    """K2's worst case: points uniform in a 3³ cube, where grid position
    says nothing about 3-D distance. Rows 0-2 of a planar (B, 8, N) buffer,
    as a (B, hh, ww, 3) view (the main path's layout, read in place)."""
    b, hh, ww, _ = shape
    packed = torch.rand((b, 8, hh * ww), generator=gen, device="cuda") * 3
    return packed[:, :3].transpose(1, 2).reshape(b, hh, ww, 3)


def knn_surface(gen: torch.Generator) -> torch.Tensor:
    """A synthetic stand-in for K2's main-path input under a trained model:
    a back-projected depth surface, where a point's grid neighbours are its
    nearest 3-D neighbours. (With random weights the served model's depth
    is flat, and K2 sees a plane.) A smooth depth
    map (a few low-frequency sinusoids, scaled to [0, 1]) with one step
    edge and 1 % of its pixels at random depths (outliers), through K3 at
    (1, 518, 518), step 2, depth scale 15, as ``graph.py`` calls it; rows
    0-2 of the packed buffer, read in place."""
    from image_to_pointcloud_tpu_torch.ops.unproject import unproject_cuda

    h = w = 518
    yy, xx = torch.meshgrid(torch.linspace(0, 1, h, device="cuda"),
                            torch.linspace(0, 1, w, device="cuda"), indexing="ij")
    ph = torch.rand(4, generator=gen, device="cuda") * 6.2832
    d = (torch.sin(6.2832 * 1.3 * xx + ph[0]) * torch.cos(6.2832 * 0.7 * yy + ph[1])
         + 0.5 * torch.sin(6.2832 * 2.1 * (xx + yy) + ph[2])
         + 0.3 * torch.cos(6.2832 * 0.4 * xx - ph[3]))
    d = d + 1.5 * (xx > 0.6)  # the step edge
    d = (d - d.min()) / (d.max() - d.min())
    outlier = torch.rand((h, w), generator=gen, device="cuda") < 0.01
    d = torch.where(outlier, torch.rand((h, w), generator=gen, device="cuda"), d)[None]
    img = torch.rand((1, h, w, 3), generator=gen, device="cuda").mul(255).round()
    packed = unproject_cuda(d, img, depth_scale=15.0, step=2, h=h, w=w)
    return packed[:, :3].transpose(1, 2).reshape(1, 259, 259, 3)


def knn_cascade_share(pts: torch.Tensor) -> dict:
    """The share of the taps K2 tests against the list's 20th value (the
    61 after the first 20, which a sorting network orders) that insert, per
    lane (v below the running 20th value) and per warp (any of its 32
    lanes: an 8×4 patch of the grid, as the kernel lays its warps out).
    Replays the centre-out order in plain torch; a diagnostic, not a
    kernel."""
    p = pts.float()
    b, hh, ww, _ = p.shape
    big = torch.full((), 1e30, device=p.device)
    pad = torch.full((b, hh + 8, ww + 8, 3), 1e9, device=p.device)
    pad[:, 4:4 + hh, 4:4 + ww] = p
    best = [big.expand(b, hh, ww)] * 20
    hpad, wpad = -(-hh // 4) * 4, -(-ww // 8) * 8
    lanes = torch.zeros((), device=p.device)
    warps = torch.zeros((), device=p.device)
    for t, (dy, dx) in enumerate(KNN_CENTRE_OUT):
        diff = pad[:, 4 + dy:4 + dy + hh, 4 + dx:4 + dx + ww] - p
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
        v = torch.where(d2 > 1e17, big, d2)
        if t >= 20:
            take = v < best[19]
            lanes += take.sum()
            lanes_of_warps = torch.nn.functional.pad(take.float(), (0, wpad - ww, 0, hpad - hh))
            warps += lanes_of_warps.view(b, hpad // 4, 4, wpad // 8, 8).amax((2, 4)).sum()
        for i in range(20):
            best[i], v = torch.minimum(best[i], v), torch.maximum(best[i], v)
    taps = len(KNN_CENTRE_OUT) - 20
    return {"lane": lanes.item() / (b * hh * ww * taps),
            "warp": warps.item() / (b * (hpad // 4) * (wpad // 8) * taps)}


def _k2_check(name: str, pts: torch.Tensor) -> float:
    """K2 against its plain version, bit for bit; returns the max abs error
    (0) and logs where the means are 0."""
    from image_to_pointcloud_tpu_torch.ops.outlier import (
        grid_knn_mean_distances_cuda,
        grid_knn_mean_distances_plain,
    )

    o = grid_knn_mean_distances_cuda(pts)
    torch.cuda.synchronize()
    ref = grid_knn_mean_distances_plain(pts)
    torch.cuda.synchronize()
    same = torch.equal(o, ref)
    zeros = int((o == 0).sum())
    zeros_agree = torch.equal(o == 0, ref == 0)
    err = (o - ref).abs().max().item()
    log(f"K2 {name} {tuple(pts.shape)} strides {pts.stride()}: bit-identical {same}, "
        f"max_abs_err {err:.3e}, {zeros} zero means (where plain's are: {zeros_agree})")
    if not same:
        raise AssertionError(f"K2 disagrees with its plain version: {name} {tuple(pts.shape)}")
    return err


def phase_k2() -> dict:
    from image_to_pointcloud_tpu_torch.ops.outlier import (
        grid_knn_mean_distances_cuda,
        grid_knn_mean_distances_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    timed = {}
    inputs = {"random cube": knn_cube(gen, (1, 259, 259, 3)), "synthetic surface": knn_surface(gen)}
    for shape in [(2, 259, 259, 3), (1, 150, 200, 3), (1, 3, 5, 3)]:
        _k2_check("random cube", knn_cube(gen, shape))
    naninf = knn_cube(gen, (1, 150, 200, 3))
    # A NaN coordinate poisons every window that holds it; an infinite one
    # poisons its own point (inf - inf) and is no neighbour to the others.
    for (i, j), val in [((5, 7), float("nan")), ((70, 120), float("inf")),
                        ((149, 199), float("-inf")), ((0, 0), float("nan"))]:
        naninf[0, i, j, (i + j) % 3] = val
    _k2_check("NaN/inf", naninf)
    # Distances below 2^-101, where the square root takes its slow path.
    _k2_check("tiny", torch.rand((1, 20, 40, 3), generator=gen, device="cuda") * 1e-15)
    # Both layouts the wrapper takes, ragged and at batch 2.
    for shape in [(2, 37, 45, 3), (1, 3, 5, 3)]:
        _k2_check("contiguous", torch.rand(shape, generator=gen, device="cuda") * 3)
    surface = inputs["synthetic surface"]
    surface2 = torch.cat([surface, surface.flip(1)])
    _k2_check("surface, contiguous batch 2", surface2.contiguous())
    b, hh, ww = 1, 259, 259
    taps = _knn_taps(hh, ww)
    # Operations: the work no tap order can skip (per in-grid tap 3 sub, 3
    # mul, 2 add and the compare with the 20th value; ~100 a point for the
    # mean of the square roots), and the reference's full cascade (40 more
    # per tap), the Pallas kernel's work. f32 on the FP32 cores.
    ops = b * (taps * 9 + hh * ww * 100)
    ops_full = b * (taps * 49 + hh * ww * 100)
    nbytes = b * hh * ww * (12 + 4)
    for name, pts in inputs.items():
        err = _k2_check(name, pts)
        share = knn_cascade_share(pts)
        res = {"input": name, "shape": list(pts.shape), "max_abs_err": err, **_timed_kernel(
            f"K2 {name} {tuple(pts.shape)}", lambda: grid_knn_mean_distances_cuda(pts),
            lambda: grid_knn_mean_distances_plain(pts)),
            **bound(nbytes, ops, F32_FLOP_S),
            "bound_full_cascade_ms": bound(nbytes, ops_full, F32_FLOP_S)["bound_ms"],
            "cascade_share": share}
        log(f"K2 {name}: of the 61 taps after the first 20, inserts at {share['lane']:.4f} of "
            f"lane-taps, {share['warp']:.4f} of warp-taps; {ops / 1e6:.1f} M ops (full cascade {ops_full / 1e6:.1f} M), "
            f"{nbytes / 1e6:.2f} MB: bound {res['bound_ms']:.5f} ms ({res['bound_by']}), "
            f"full-cascade bound {res['bound_full_cascade_ms']:.5f} ms")
        timed[name] = res
    # The line's numbers are the random cube's, the input every PR has timed
    # K2 on (its worst case); the synthetic depth surface rides along.
    return {**timed["random cube"], "also": [timed["synthetic surface"]]}


def k3_inputs(gen: torch.Generator, b: int, h: int, w: int, u8: bool):
    """Depth in [0, 1) with a row of zeros (the z == 0 epsilon path) and
    an RGB image, u8 or f32 with integer values, on the card."""
    d = torch.rand((b, h, w), generator=gen, device="cuda")
    d[:, min(7, h - 1), ::5] = 0.0
    img = torch.randint(0, 256, (b, h, w, 3), generator=gen, device="cuda", dtype=torch.uint8)
    return d, (img if u8 else img.float())


def phase_k3() -> dict:
    from image_to_pointcloud_tpu_torch.ops.unproject import unproject_cuda, unproject_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    timed = {}
    # N = hh·ww odd (67081, 30351, 120701, 7575: output rows start at every
    # residue mod 4) or even (120000, 30150), a grid smaller than a float4
    # (2 points), batch 2; steps 1, 2 and 4; u8 and f32 images.
    for (b, h, w), step, fov in [((1, 518, 518), 2, None), ((2, 518, 518), 2, None),
                                 ((2, 301, 401), 2, None), ((1, 301, 401), 1, 70.0),
                                 ((1, 299, 401), 4, None), ((1, 400, 300), 1, 70.0),
                                 ((1, 300, 402), 2, None), ((1, 3, 5), 4, None)]:
        for u8 in (False, True):
            d, img = k3_inputs(gen, b, h, w, u8)
            kw = dict(depth_scale=torch.tensor([15.0, 2.5][:b], device="cuda"), step=step,
                      h=h, w=w, fov_deg=fov)
            o = unproject_cuda(d, img, **kw)
            torch.cuda.synchronize()
            ref = unproject_plain(d, img, **kw)
            err = (o - ref).abs().max().item()
            kind = "u8" if u8 else "f32"
            log(f"K3 ({b}, {h}, {w}) step {step} fov {fov} {kind}: N {o.shape[-1]}, "
                f"max_abs_err {err:.3e}, bit-identical {torch.equal(o, ref)}")
            if not torch.equal(o, ref):
                raise AssertionError(f"K3 disagrees with its plain version at {(b, h, w)} "
                                     f"step {step} {kind}")
            if (b, h, w) == (1, 518, 518):
                # Bytes: the sampled depth (4 B) and RGB (12 B f32, 3 B u8)
                # of each output point, and its 8 f32 output rows; ~10
                # flops a point.
                n = b * (-(-h // step)) * (-(-w // step))
                nbytes = n * (4 + (3 if u8 else 12) + 32)
                res = {"image": kind, "shape": [b, h, w], "step": step, "max_abs_err": err,
                       **_timed_kernel(f"K3 ({b}, {h}, {w}) step {step} {kind}",
                                       lambda: unproject_cuda(d, img, **kw),
                                       lambda: unproject_plain(d, img, **kw)),
                       **bound(nbytes, n * 10, F32_FLOP_S)}
                log(f"K3 ({b}, {h}, {w}) step {step} {kind}: {nbytes / 1e6:.2f} MB: bound "
                    f"{res['bound_ms']:.5f} ms ({res['bound_by']})")
                timed[kind] = res
    # The smallest launch the card does, on the same harness: a yardstick
    # for K3's few microseconds, never called by the port.
    one = torch.empty(1, device="cuda")
    floor = device_time_ms(one.zero_)
    log(f"launch floor (one-element zero_, CUDA graph of 20): {floor:.5f} ms")
    # The main path hands K3 an f32 image on both ingests (graph.py's
    # submit_batch converts the upload on the card); the u8 case rides along.
    return {**timed["f32"], "launch_floor_ms": floor, "also": [timed["u8"]]}


def phase_codecs() -> None:
    from image_to_pointcloud_tpu_torch.pipeline import transfer

    gen = torch.Generator(device="cuda").manual_seed(3)
    dn = torch.rand((2, 259, 259), generator=gen, device="cuda")
    dn[:, 90:, :140] *= 0.25  # depth edges: wide tiles fill the side list
    same = {}
    for pack in (transfer.pack_depth8t, transfer.pack_depth12, transfer.pack_keep_bits):
        x = dn > 0.4 if pack is transfer.pack_keep_bits else dn
        same[pack.__name__] = torch.equal(pack(x).cpu(), pack(x.cpu()))
    log(f"codecs card vs CPU, byte-identical: {same}")
    if not all(same.values()):
        raise AssertionError("a transfer codec on the card disagrees with the CPU")


def _frame(h: int, w: int, seed: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    img = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 127 // (h + w)], -1)
    return np.clip(img + rng.integers(0, 24, (h, w, 3)), 0, 255).astype(np.uint8)


def _jpeg(h: int, w: int, seed: int) -> bytes:
    """A q88 4:2:0 JPEG (PIL's default subsampling)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_frame(h, w, seed)).save(buf, "JPEG", quality=88)
    return buf.getvalue()


def phase_jpeg_decode() -> None:
    import io

    from PIL import Image

    from image_to_pointcloud_tpu_torch import native
    from image_to_pointcloud_tpu_torch.pipeline import graph

    if not native.available():
        raise AssertionError("the native library did not build: no hybrid JPEG ingest")
    data = _jpeg(518, 518, 0)
    jpeg = graph.plan_jpeg_input(data)
    if jpeg is None:
        raise AssertionError("plan_jpeg_input declined the q88 518² frame")
    caps = graph.plan_sparse_batch([jpeg])
    scale = np.float32([15.0])
    sparse = torch.from_numpy(graph.DepthPipeline.pack_jpeg_sparse_payload([jpeg], scale, *caps))
    dense = torch.from_numpy(graph.DepthPipeline.pack_jpeg_payload([jpeg], scale))
    card, _ = graph._unpack_jpeg_sparse_batch(sparse.cuda(), jpeg.spec, *caps)
    card_dense, _ = graph._unpack_jpeg_batch(dense.cuda(), jpeg.spec)
    cpu, _ = graph._unpack_jpeg_sparse_batch(sparse, jpeg.spec, *caps)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32)
    card_np = card[0].cpu().numpy()
    same = torch.equal(card, card_dense)
    cpu_err = float(np.abs(card_np - cpu[0].numpy()).max())
    pil_err = float(np.abs(card_np - pil).max())
    log(f"JPEG decode 518² q88 4:2:0 (caps {caps}, {len(sparse[0])} B sparse vs "
        f"{len(dense[0])} B dense): sparse == dense {same}, card vs CPU max {cpu_err} "
        f"(<= {JPEG_CPU_TOL}), vs PIL max {pil_err} (<= {JPEG_PIL_TOL})")
    if not (same and cpu_err <= JPEG_CPU_TOL and pil_err <= JPEG_PIL_TOL):
        raise AssertionError("the JPEG device decode disagrees")


def _tiny_configs() -> dict:
    """Tiny configs of the three families with 64-wide heads (K1 runs in
    the ViTs on the card), and each one's model target."""
    from image_to_pointcloud_tpu_torch.models.beit import BeitConfig
    from image_to_pointcloud_tpu_torch.models.depth_anything import DepthAnythingConfig
    from image_to_pointcloud_tpu_torch.models.dinov2 import DinoV2Config
    from image_to_pointcloud_tpu_torch.models.dpt import DPTConfig
    from image_to_pointcloud_tpu_torch.models.dpt_classic import DPTClassicConfig
    from image_to_pointcloud_tpu_torch.models.vit import ViTConfig
    from image_to_pointcloud_tpu_torch.models.zoedepth import ZoeDepthConfig

    return {
        "Depth-Anything-V2": (DepthAnythingConfig(
            backbone=DinoV2Config(hidden_size=128, num_layers=2, num_heads=2,
                                  out_layers=(0, 1, 1, 1)),
            neck=DPTConfig(hidden_size=128, neck_hidden_sizes=(32, 64, 128, 128),
                           fusion_hidden_size=32),
        ), 140),
        # A 128² input on a 64²-native model: the position embeddings are
        # resampled.
        "classic DPT": (DPTClassicConfig(
            backbone=ViTConfig(hidden_size=128, num_layers=2, num_heads=2, pos_embed_size=4,
                               out_layers=(0, 1, 1, 1)),
            neck_hidden_sizes=(32, 64, 128, 128), fusion_hidden_size=32,
        ), 128),
        # Reflect-padded 260×328 → 128×160: an 8×10 grid on a 4×4 window,
        # so the bias tables are resampled.
        "ZoeDepth": (ZoeDepthConfig(
            backbone=BeitConfig(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                                window_size=4, out_layers=(1, 2, 2, 2)),
            neck_hidden_sizes=(32, 64, 96, 128), fusion_hidden_size=32, bottleneck_features=32,
            num_relative_features=8, bin_embedding_dim=16, n_bins=16,
        ), (128, 160)),
    }


def phase_slice() -> None:
    from image_to_pointcloud_tpu_torch.models.depth_anything import build_model, init_weights

    for family, (cfg, target) in _tiny_configs().items():
        _slice_card_vs_cpu(
            family,
            init_weights(build_model(cfg), torch.Generator().manual_seed(0)),
            init_weights(build_model(cfg), torch.Generator().manual_seed(0)).to("cuda"),
            target,
        )


def _rmse(a, b) -> float:
    """Per-point RMSE of two results' packed points, on points both keep."""
    both = (a.packed[6] > 0.5) & (b.packed[6] > 0.5)
    return float(np.sqrt(((a.packed[:3, both] - b.packed[:3, both]) ** 2).sum(0).mean()))


def _slice_card_vs_cpu(family: str, cpu_model, gpu_model, target) -> None:
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline

    img = np.random.default_rng(0).integers(0, 256, (200, 260, 3), dtype=np.uint8)
    cpu_f32 = None
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for quantized in (False, True):
            kw = dict(model_target=target, quantized_transfer=quantized)
            cpu = DepthPipeline(cpu_model, **kw).run(img, depth_scale=15.0)
            gpu = DepthPipeline(gpu_model, **kw).run(img, depth_scale=15.0)
            kc, kg = cpu.packed[6] > 0.5, gpu.packed[6] > 0.5
            agree = float((kc == kg).mean())
            rmse = _rmse(cpu, gpu)
            tol, codec = SLICE_RMSE, ""
            if not quantized:
                cpu_f32 = cpu
            elif family == "ZoeDepth":
                # The random-init ZoeDepth map spans only ±8 % of its mean
                # (the others span their whole range), so the depth
                # normalization scales its card-vs-CPU f32 differences up
                # ~9x, and the bundle's per-tile codes flip by one step
                # where the others' do not. Its bundle is held to the
                # codec's own error on this map instead.
                codec_rmse = _rmse(cpu, cpu_f32)
                tol = max(SLICE_RMSE, codec_rmse)
                codec = f", the codec's own rmse on the CPU {codec_rmse:.3e}"
            colors = bool(np.array_equal(cpu.packed[3:6], gpu.packed[3:6]))
            prev = int(np.abs(cpu.depth_preview_gray.astype(int)
                              - gpu.depth_preview_gray.astype(int)).max())
            log(f"{family} slice card vs CPU, {'quantized bundle' if quantized else 'f32 return'}: "
                f"points {gpu.raw_point_count}/{cpu.raw_point_count}, colors exact {colors}, "
                f"keep agree {agree:.5f} (>= {SLICE_KEEP_AGREE}), rmse {rmse:.3e} "
                f"(< {tol:.3e}{codec}), preview max diff {prev}")
            if not (gpu.raw_point_count == cpu.raw_point_count and colors
                    and agree >= SLICE_KEEP_AGREE and rmse < tol and prev <= 1):
                raise AssertionError(f"{family} slice on the card disagrees with the CPU")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _multipart(data: bytes, ctype: str) -> tuple[bytes, str]:
    boundary = uuid.uuid4().hex
    body = (
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
        f"filename=\"img\"\r\nContent-Type: {ctype}\r\n\r\n"
    ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _http(url: str, data: bytes | None = None, ctype: str | None = None) -> bytes:
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    if ctype:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def _request(base: str, data: bytes, ctype: str = "image/png",
             model: str = "depth-anything-v2") -> tuple[float, dict, bytes]:
    """POST /process → poll /status → GET /download; returns (seconds from
    the upload to the downloaded PLY, final status, the PLY)."""
    body, ctype = _multipart(data, ctype)
    t0 = time.perf_counter()
    job = json.loads(_http(f"{base}/process?output_format=ply&point_density=medium"
                           f"&depth_scale=15&model={model}", body, ctype))["job_id"]
    deadline = t0 + 600
    while True:
        st = json.loads(_http(f"{base}/status/{job}?wait_ms=2000"))
        if st["status"] in ("completed", "error"):
            break
        if time.perf_counter() > deadline:
            raise TimeoutError(f"job {job} did not finish")
    if st["status"] != "completed":
        raise AssertionError(f"job failed: {st['message']}")
    ply = _http(f"{base}{st['results']['downloadUrl']}")
    latency = time.perf_counter() - t0
    timings = json.loads(_http(f"{base}/timings/{job}"))["timings"]
    return latency, {**st, "timings": timings}, ply


def _check_ply(data: bytes, n: int) -> None:
    from image_to_pointcloud_tpu_torch.io import read_ply

    v = read_ply(data)["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1)
    if not (len(xyz) == n > 0 and np.isfinite(xyz).all()):
        raise AssertionError(f"bad PLY: {len(xyz)} points (expected {n}), finite "
                             f"{np.isfinite(xyz).all()}")


def _png(h: int, w: int, seed: int) -> bytes:
    from image_to_pointcloud_tpu_torch.io.image import encode_png

    return encode_png(_frame(h, w, seed))


# The main paths the server drives: (ingest, model, 518² requests after
# the cold one, K1 launches per request: one per transformer layer).
SERVED_PATHS = [
    ("png", "depth-anything-v2", 5, 12),
    ("jpeg", "depth-anything-v2", 5, 12),
    ("png", "dpt-large", 3, 24),
    # BEiT's attention carries an additive bias: plain torch ops, not K1.
    ("png", "zoedepth", 3, 0),
]


def _served_requests(base: str, kind: str, model: str, n: int, k1_per_request: int
                     ) -> dict[str, int]:
    """One main path through the server: the launch counters are zeroed
    just before its requests and read just after."""
    from image_to_pointcloud_tpu_torch import cuda

    make, ctype, stage = {
        "png": (_png, "image/png", "decode"),
        "jpeg": (_jpeg, "image/jpeg", "jpeg_plan"),
    }[kind]
    # The first request of a path builds the model and the kernels: not
    # timed as serving.
    lat, st, _ = _request(base, make(518, 518, 0), ctype, model)
    log(f"server cold {model} {kind} request 518x518: {lat * 1e3:.1f} ms, "
        f"timings {st['timings']}")

    for k in cuda.KERNELS:
        k.reset()
    lats = []
    extra = [(300, 400)] if (kind, model) == ("png", "depth-anything-v2") else []
    for i, (h, w) in enumerate([(518, 518)] * n + extra):
        lat, st, ply = _request(base, make(h, w, 10 + i), ctype, model)
        _check_ply(ply, st["results"]["pointCloud"]["points"])
        if stage not in st["timings"]:
            raise AssertionError(f"{kind} request #{i} did not take the {stage} ingest: "
                                 f"timings {st['timings']}")
        if (h, w) == (518, 518):
            lats.append(lat)
        log(f"{model} {kind} request {w}x{h} #{i}: {lat * 1e3:.1f} ms, "
            f"{st['results']['pointCloud']['points']} points, timings {st['timings']}")
    counts = {k.name: k.launches for k in cuda.KERNELS}
    n_requests = n + len(extra)
    log(f"server p50 latency 518x518 {model} {kind.upper()} -> PLY: "
        f"{statistics.median(lats) * 1e3:.1f} ms over {len(lats)} sequential requests")
    log(f"kernel launches during the {n_requests} served {model} {kind} requests: {counts}")
    expected = {"flash_attention": k1_per_request * n_requests, "grid_knn": n_requests,
                "unproject": n_requests}
    if counts != expected:
        raise AssertionError(f"the {model} {kind} path launched {counts}; expected {expected}")
    return counts


class _Server:
    """The port's v1 app behind the first-party HTTP server, on a private
    event-loop thread."""

    def __init__(self, out_dir: str, models, **app_kw):
        from image_to_pointcloud_tpu_torch.serve.http import HttpServer
        from image_to_pointcloud_tpu_torch.serve.app_v1 import create_v1_app

        self.loop = asyncio.new_event_loop()
        self.app = create_v1_app(output_dir=out_dir, models=models, durable_jobs=False,
                                 **app_kw)
        self.server = HttpServer(self.app.router, "127.0.0.1", 0)
        self.loop.run_until_complete(self.server.start())
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.bound_port}"

    def stop(self) -> None:
        _stop(self.loop, self.thread, self.server, self.app)


def phase_server(out_dir: str, models) -> tuple[dict[str, int], dict[str, dict[str, float]]]:
    """Launch counts summed over the served paths, and per request of each
    path."""
    counts: dict[str, int] = {}
    per_request: dict[str, dict[str, float]] = {}
    servers = {"png": _Server(out_dir, models), "jpeg": None}
    try:
        servers["jpeg"] = _Server(out_dir, models, jpeg_device_decode=True)
        for kind, model, n, k1_per_request in SERVED_PATHS:
            t0 = time.perf_counter()
            path_counts = _served_requests(servers[kind].base, kind, model, n, k1_per_request)
            n_requests = path_counts["unproject"]  # one launch a request
            for name, c in path_counts.items():
                counts[name] = counts.get(name, 0) + c
                per_request.setdefault(name, {})[f"{model} {kind}"] = c / n_requests
            log(f"served path {model} {kind}: {time.perf_counter() - t0:.1f} s")
        for name in ("dpt-large", "zoedepth"):
            if not models.random_weights[name]:
                raise AssertionError(f"{name} was expected to serve the random init")
        phase_triposr(servers["png"].base)
    finally:
        for srv in servers.values():
            if srv is not None:
                srv.stop()
    if not models.get("depth-anything-v2").quantized_transfer:
        raise AssertionError("the server on the card did not default to the quantized bundle")
    return counts, per_request


def phase_triposr(base: str) -> None:
    """A dummy-model request, and the dummy graphs on the card against the
    CPU, bit for bit."""
    from image_to_pointcloud_tpu_torch.pipeline import graph

    lat, st, ply = _request(base, _png(518, 518, 3), model="triposr")
    n = st["results"]["pointCloud"]["points"]
    _check_ply(ply, n)
    if n != 130 * 130:
        raise AssertionError(f"triposr returned {n} points, expected 130*130")
    img = _frame(301, 402, 4)
    pts_c, cols_c = graph.dummy_point_cloud_graph(img, "medium", "cuda")
    pts, cols = graph.dummy_point_cloud_graph(img, "medium", "cpu")
    same = (np.array_equal(pts_c, pts) and np.array_equal(cols_c, cols)
            and np.array_equal(graph.demo_depth_map_graph(img, "cuda"),
                               graph.demo_depth_map_graph(img, "cpu")))
    log(f"triposr request 518x518: {lat * 1e3:.1f} ms, {n} points; dummy graphs card == CPU "
        f"{same}")
    if not same:
        raise AssertionError("the dummy graphs on the card disagree with the CPU")


def phase_profile(out_dir: str, models) -> None:
    """/profile/start → one dpt-large request → /profile/stop: the Chrome
    trace names the CUDA kernels the request ran."""
    from pathlib import Path

    srv = _Server(out_dir, models)
    try:
        _http(f"{srv.base}/profile/start", b"", "application/json")
        _request(srv.base, _png(518, 518, 5), model="dpt-large")
        stop = _http(f"{srv.base}/profile/stop", b"", "application/json")
    finally:
        srv.stop()
    trace = Path(json.loads(stop)["trace"])
    names = {e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "kernel"}
    found = {k: [n for n in names if k in n] for k in
             ("flash_fwd_bf16_wgmma_kernel", "grid_knn_kernel", "unproject_kernel")}
    log(f"/profile trace {trace.relative_to(out_dir)}: {trace.stat().st_size} bytes, "
        f"{len(names)} distinct CUDA kernels, ours: {found}")
    if not all(found.values()):
        raise AssertionError("the /profile trace does not name the port's three CUDA kernels")


def _stop(loop, thread, server, app) -> None:
    async def _shutdown():
        await server.stop()
        await app.shutdown()

    asyncio.run_coroutine_threadsafe(_shutdown(), loop).result(60)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=60)
    app.jobs.close()


def phase_timing(models, reps: int = 20) -> None:
    """Batch-1 submit+collect, host wall time to the collected result, as
    the batcher runs it (no packed buffer, gray preview), in turns."""
    from image_to_pointcloud_tpu_torch.pipeline import graph

    served = models.get("depth-anything-v2")
    f32 = graph.DepthPipeline(served.model, quantized_transfer=False)
    quant = graph.DepthPipeline(served.model, quantized_transfer=True)
    img = _frame(518, 518, 1)
    jpeg = graph.plan_jpeg_input(_jpeg(518, 518, 1))
    jpeg.grid_colors(2)  # the server's planner does this off the drain
    runs = {
        "PNG/f32": lambda: f32.collect(f32.submit_batch([img], depth_scales=15.0),
                                       want_packed=False, want_preview_rgb=False),
        "PNG/quantized": lambda: quant.collect(quant.submit_batch([img], depth_scales=15.0),
                                               want_packed=False, want_preview_rgb=False),
        "JPEG/quantized": lambda: quant.collect(
            quant.submit_batch_jpeg([jpeg], depth_scales=15.0),
            want_packed=False, want_preview_rgb=False),
    }
    walls = {name: [] for name in runs}
    for fn in runs.values():
        fn()  # warm-up
    for _ in range(reps):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            walls[name].append(time.perf_counter() - t0)
    for name, w in walls.items():
        log(f"batch-1 submit+collect 518x518 {name}: median {statistics.median(w) * 1e3:.2f} ms "
            f"(min {min(w) * 1e3:.2f}, max {max(w) * 1e3:.2f}) over {reps}, in turns")


def timed(phase, *args):
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    from image_to_pointcloud_tpu_torch import cuda

    t0 = time.perf_counter()
    cuda.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for line in next(cuda.BUILD_DIR.glob("*.log")).read_text().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    k1 = timed(phase_k1)
    k2 = timed(phase_k2)
    k3 = timed(phase_k3)
    timed(phase_codecs)
    timed(phase_jpeg_decode)
    timed(phase_slice)

    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    models = ModelManager("cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        counts, per_request = timed(phase_server, out_dir, models)
        timed(phase_timing, models)
        timed(phase_profile, out_dir, models)
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    if any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules):
        raise AssertionError("JAX was imported")
    if any(m.split(".")[0] == "image_to_pointcloud_tpu" for m in sys.modules):
        raise AssertionError("a module of the JAX package was imported")
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "image_to_pointcloud_tpu_torch/csrc/flash_attention.cu",
         "replaces": "image_to_pointcloud_tpu/models/attention.py:175",
         "launches": counts["flash_attention"], "launches_per_request": per_request["flash_attention"], **k1},
        {"name": "grid_knn", "route": "cuda",
         "source": "image_to_pointcloud_tpu_torch/csrc/grid_knn.cu",
         "replaces": "image_to_pointcloud_tpu/ops/outlier_pallas.py:134",
         "launches": counts["grid_knn"], "launches_per_request": per_request["grid_knn"], **k2},
        {"name": "unproject", "route": "cuda",
         "source": "image_to_pointcloud_tpu_torch/csrc/unproject.cu",
         "replaces": "image_to_pointcloud_tpu/ops/unproject.py:208",
         "launches": counts["unproject"], "launches_per_request": per_request["unproject"], **k3},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
