"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero, and the result lines are not printed):

1. device: CUDA must be available; the card's name and power limit.
2. build: the CUDA kernels from ``image_to_pointcloud_tpu_torch/csrc``.
3. K1 flash attention vs its plain version: bf16 (the tensor-core
   kernel) at DA-V2-Small's (1, 6, 1370, 64) and (2, 6, 1370, 64), at
   classic DPT-Large's (1, 16, 577, 64) and at a ragged (1, 3, 65, 64);
   f32 (the 3xTF32 kernel) at (2, 6, 1370, 64) and at the f32 serving
   shapes (1, 6, 1370, 64) and (1, 16, 577, 64); at the head dims no
   preset serves, in bf16 and f32: (1, 6, 1370, 32) and (1, 4, 1370, 128)
   (the kD = 32 and 128 instances), (1, 6, 1370, 40) and (1, 8, 577, 80)
   (D below its instance's width), and above 128 (O in 128-column panels,
   S once a key tile: bf16 warpgroups of a CTA, f32 CTAs of a cluster)
   (1, 4, 577, 160), (1, 4, 1370, 192), (1, 2, 1370, 256) and (1, 2, 300,
   320), with (1, 2, 577, 136) and (1, 3, 129, 392) checked only. Timed
   at the serving shapes and at each of the four: device time,
   host-inclusive time, the plain version's, and
   ``scaled_dot_product_attention``'s on the same tensors (the yardstick,
   never called by the port), beside the bound of the design that runs
   (bf16 tensor cores, or 3xTF32) and, for f32, the FP32-core bound.
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
   and per 8×4 warp (replayed in plain torch). The general kernel
   (k_eff <= 64) at (k, window) = (10, 7), (64, 8), (1, 1), (40, 2),
   (16, 3), (20, 12), (64, 16), at the edges of its list sizes (9, 2),
   (24, 3), (33, 4), (63, 5), and on either side of its halo's widest
   window, (8, 50) and (8, 51), and the sorted kernels (k_eff > 64, a
   bitonic sort a warp a point) at (100, 5), (300, 8), (500, 12), (121,
   5), (1000, 15) (in registers) and (100, 16) (in shared memory), bit for
   bit on the 259² cube, the surface and the NaN/inf grid; every general
   pair timed on both 259² inputs, the sorted ones but (121, 5) on the
   cube, beside their bounds. The kernels line
   reports the cube at (20, 4), as every PR has; the rest rides along.
5. K3 unproject vs its plain version, bit for bit, with u8 and f32
   images: (1, 518, 518) step 2 (one request), batch 2, odd N at steps
   1, 2 and 4 (output rows starting at every residue mod 4), even N, and
   a 2-point grid; timed at (1, 518, 518) step 2 with both image types
   beside the bound and the launch floor (a one-element ``zero_()`` on
   the same harness).
5b. the depthnorm kernel vs its plain version run on the CPU, bit for
   bit, on the CPU tests' special planes (NaN and ±inf, signed zeros at
   the percentile ranks, ties, constant, all-non-finite, smooth) at (1,
   37, 45), (1, 518, 518) and all in one batch at (16, 384, 384) and
   (16, 518, 518); timed at (16, 518, 518), (16, 384, 384) and (1, 518,
   518) on smooth depth maps, each timed call's output checked bit for
   bit too, beside its bytes bound and the plain version on the card.
6. the transfer codecs on the card vs the CPU, byte for byte.
7. the JPEG device decode of a q88 4:2:0 518² frame: sparse vs dense
   payload bit for bit, card vs CPU within 1 level, vs PIL within 3.
8. the slice on the card vs the slice on the CPU, for tiny configs of
   the three families (Depth-Anything-V2, classic DPT, ZoeDepth) with
   64-wide heads, same weights, f32, TF32 off, through the f32 return
   and through the quantized bundle (its bytes equal to the CPU's codec
   on the card's depth, that depth near the CPU's); then the same over
   their int8 W8A8 encoders. Each result is logged beside the host CPU's
   capability, the f32 return's RMSE, the bundle codec's own RMSE on the
   CPU and the decoded bundle's RMSE between two CPU runs.
9. the advanced pipelines (metric, tiled high resolution, video) on a
   tiny Depth-Anything, card vs CPU, on both transfer contracts; the
   voxel op card vs CPU on one 200,000-point cloud.
10. ``QuantLinear`` at the served int8 shapes (DA-V2's and DPT-Large's
    fc1 and fc2, ZoeDepth's fc1), card vs CPU: the int32 accumulator and
    the output bit for bit; ``torch._int_mm``, the whole ``QuantLinear``
    and the bf16 ``nn.Linear`` timed beside the int8 bound.
11. the served models at full width, card (bf16, the quantized bundle)
    vs CPU (f32), same weights, same frame: ``depth-anything-v2``,
    ``dpt-large`` and ``zoedepth``, each stage's error logged (every
    encoder block, the taps, the neck, the head's raw output), the raw
    output within ``FULL_WIDTH_TOL`` max-normalized, the card's
    normalized depth not flat (p98 - p2 > 0) and more than one z value in
    the points; the depth normalization card vs CPU bit for bit.
11b. (after 12) f32 serving: ``ModelManager("cuda", use_bf16=False)``
    for ``depth-anything-v2`` and ``dpt-large``, the TF32 flags at
    torch's defaults: each stage against phase 11's CPU stages, the
    head's raw output within ``F32_FULL_WIDTH_TOL`` max-normalized, the
    flags restored after the forward; then two 518² PNG requests of each
    (and a 400×300 one of DA-V2) through the v1 app, read on their own:
    K1 (the f32 kernel) exactly 12 / 24 times a request, K2 and K3 once,
    PLYs not flat.
12. the v1 server in this process, bf16, each main path read on its own
    (the launch counters zeroed just before and read just after):
    Depth-Anything-V2-Small with 518² and 400×300 PNG → PLY requests
    through the default quantized bundle, and in a second app with the
    hybrid JPEG ingest five q88 518² JPEG → PLY requests, every one of
    which must take the device decode; then ``dpt-large`` (ViT-L/16,
    384², K1 in all 24 layers) and ``zoedepth`` (BEiT-L/16, 518² padded
    to 614² and run at 512², whose biased attention is plain torch ops,
    so K1 must stay at zero) at full width, random init, one cold and
    three 518² PNG → PLY requests each; and a third app over
    ``ModelManager(int8=True)``: int8 DA-V2-Small, three requests. Each
    path must launch K1 exactly 12 (DA-V2, int8 too), 24 (``dpt-large``)
    or 0 (``zoedepth``) times a request, and K2 and K3 once; every PLY
    must hold finite points whose depth is not flat.
12b. (after 11b) one CUDA graph per signature (``DepthPipeline.
    compiled_graph``, ``compiled_graph_jpeg``): for DA-V2 bf16 (PNG, and
    JPEG through the sparse and the dense payload), ``dpt-large``,
    ``zoedepth``, int8 DA-V2 and f32 DA-V2 at full width, 518², buckets 1
    and 4, each on a fresh pipeline over the served model: the replay
    against the signature's eager body (``fn.run``, which is
    ``_run_slots``) on the same payload, byte for byte (the bundle and the
    preview; where bytes differ, the fallback rule is logged and checked:
    the graph's bundle equals the CPU codec on the graph's own depth, and
    that depth is within ``SLICE_RMSE`` of eager's); the launches of a
    replay exactly the eager forward's (K1 one a layer, K2 and K3 one a
    batch; the capture counts none); capture time and the pool's memory.
    Two DA-V2 batches submitted before either is collected equal the
    sequential runs; a 400×300 signature is captured on this thread while
    another replays 518². A v1 app at ``max_batch=4``, warmup 518² and
    ``jpeg_device_decode``: the warmup captures exactly buckets 1, 2, 4
    on both ingests; a drain of three queued frames goes out as one
    bucket of 4 with three results; three concurrent requests capture
    nothing new (their drain sizes are logged).
13. a ``triposr`` request, and the dummy graphs on the card vs the CPU,
    bit for bit.
14. the CLI (``cli.main``) on the card at full width: ``highres`` on a
    1024² frame (tile 518, overlap 128), ``metric`` with
    ``depth-anything-v2-metric-small`` and ``zoedepth-small``, ``video``
    on four 518² frames with and without ``--voxel``, ``convert`` to
    ply, las, xyz, pcd and glb and once with ``--int8``; each run held to
    its exact K1/K2/K3 launches, each output file read back; each advanced
    run's wall logged beside its wall when the advanced pipelines ran
    eagerly (a run now pays one capture a signature).
15. batch-1 ``submit_batch`` + ``collect`` medians, in turns: PNG with
    the f32 return, PNG with the quantized bundle, JPEG with the bundle;
    then DA-V2 (PNG, JPEG, int8, f32), ``dpt-large`` and ``zoedepth`` at
    batch 1 and at bucket 4, the graph against the eager forward in turns,
    the median per image (the busy share of each is measured last but
    one, so that no profiler session precedes a timing).
16. the v2 server in this process at full width (DA-V2-Small, random
    init): two 512² PNG generations, one with ``remove_background`` and no
    remesh, one with ``remesh_option=triangle`` and ``target_count=2000``,
    then three timed ones; each read on its own and held to exactly 12 K1,
    1 K2 and 1 K3 launches; ``mesh.glb`` (the glTF magic, a JSON chunk with
    an image, a texture and UVs), ``pointcloud.ply`` (not flat) and
    ``metadata.json`` (its vertex and face counts equal the GLB's) checked;
    the p50 with each stage (preprocess and matte, pipeline, mesh and GLB,
    preview) and the metadata's ``generation_time``.
17. the learned matte: the port's SegFormer on the golden fixture (an HF
    state dict, its input and the HF logits) through ``convert_segformer``
    on the card, TF32 off, within 5e-5 max-normalized; a random-init
    full-width SegFormer-B0 ``MatteModel`` at 512², card vs CPU, and its
    device time; a ``Depth3DProcessor`` with it generating on the card.
18. fine-tuning on the card: the CLI's ``train`` on
    ``depth-anything-v2-metric-small`` at full width (hidden 384, 12
    layers, 518², batch 2, f32, remat) for 3 steps, each step timed, peak
    memory; the loss finite, every q/k/v weight with a nonzero gradient and
    no K1 launch; its checkpoint served by a v1 request through
    ``IPC_TPU_CHECKPOINT_DIR`` (depth unlike the random init's; 12/1/1
    launches); one tiny trainer step card (its CUDA graph) vs CPU, TF32
    off; the trainer's step as one CUDA graph a signature at full width
    (the same model, 518², batch 2, f32, remat, one slot, lr 1e-3): a
    graph trainer and an eager one from one weight set and one batch,
    step 1's loss bit for bit eager's, every parameter within the larger
    of two eager steps' spread and Adam's first-step bound, 8 steps of
    each in turns (median wall), device time a step, busy share and
    kernels a step in a profiler window of 3, capture seconds, pool MiB,
    peak memory, a replay's hand-kernel launches (none), Adam's step count
    equal to the calls; ``depth_metrics``'s graph vs its eager body bit for
    bit, with and without a mask; ``convert-ckpt`` on an HF-layout
    safetensors written from a random state_dict, back bit for bit.
19. ``parallel/`` on the one card, every mesh slot ``cuda:0`` (so it
    measures correctness and the host's cost per slot, not a multi-GPU
    speed-up), each path against the port's unsharded card result: K1
    at the TP slots' shapes (1, 3, 1370, 64) and (1, 8, 577, 64) and the
    full-head ones, held against the plain attention and timed; TP
    (``data=1, model=2``) through the served ``DepthPipeline`` for
    DA-V2-Small and ``dpt-large`` at full width (raw output within
    ``FULL_WIDTH_TOL``, the normalized depth within ``MESH_NORM_TOL``, K1
    exactly 24 and 48 a request); int8 TP (a row-parallel ``QuantLinear``
    at DA-V2's fc2 and the int8 DA-V2 encoder at ``model=2``, bit for bit,
    and the int8 TP pipeline's replay the unsharded int8 pipeline's, byte
    for byte); DP (``data=2``, a batch of 1 and of 3, padded, against the
    unmeshed pipeline on each slot's rows: equal kept counts, points
    within 2e-4, K2 and K3 once per data slot); GPipe (``pipe=4``, M=4,
    batch 4: DA-V2 and ``dpt-large`` at full width, a 4-block ZoeDepth
    tiny); each of these pipelines as CUDA graphs, one a signature and
    data slot (``_mesh_graph``): every replay byte for byte its eager
    body, its launches the eager body's, capture seconds, pool MiB, graph
    and eager walls in turns; sequence-sharded and ring attention at (1,
    6, 1370, 64) bf16, ``seq=2``, against the plain attention in f32; the
    meshed trainer (``depth-anything-v2-metric-small``, 518², batch 2,
    f32, remat, ``data=2, model=2``, 3 steps at lr 5e-6, a batch each) as
    its CUDA graph, beside an eager meshed trainer (step 1's loss bit for
    bit) and against the one-device trainer (its CUDA graph): the losses,
    which must move, step 1's parameters and each tensor's three-step
    update; then its step graph against eager in turns, busy share,
    capture and pool; the server: ``serve --mesh data=1,model=1`` in a
    child process (a non-flat PLY), ``serve --mesh data=2`` refused with
    the slot-count error, the one-slot mesh's pipeline in this process as
    its graph, and a ``ModelManager`` on (``data=2, model=2``): its
    pipeline as graphs, then behind the v1 app three PNG requests of
    exactly 48 K1, 2 K2 and 2 K3; each mesh's submit+collect of a lone
    request, graph against eager in turns. Host walls of a TP, a DP and a
    GPipe request (graphs) beside the unmeshed ones.
20. the device's busy share of each of phase 15's runs (eager and graph,
    batch 1 and 4), as ``tools/profile_torch_pipeline.py`` measures it:
    CUDA kernel time in a ``torch.profiler`` window over the window's wall.
21. ``/profile/start`` and ``/profile/stop`` around one ``dpt-large``
    request: the Chrome trace must exist and name the CUDA kernels. Last,
    so that no profiler session precedes the timings of phase 15.
22. (after 20, before 21) one CUDA graph per signature of the advanced
    pipelines and the v2 matte (``_fn``, the JAX cache keys), at full
    width, random init, bf16 (the matte f32), each on a fresh pipeline:
    ``MetricPipeline`` with ``depth-anything-v2-metric-small`` and
    ``zoedepth`` on 518² frames at batch 1 and 4, both transfers;
    ``HighResPipeline`` with DA-V2-Small on a 1024² frame (tile 518,
    overlap 128: the anchor and 9 tiles), the depth grid and the device
    path; ``VideoPipeline`` with DA-V2-Small on 30 518² frames at step 2,
    quantized and unfused; ``MatteModel`` (SegFormer-B0, 512²). Each
    replay against its eager body byte for byte, at the captured and at a
    second depth scale, intrinsics or image (the output must move where
    the value enters the device program); the launches of a replay, the
    eager body's and exactly K1 12 (DA), 0 (``zoedepth``, the matte), 24
    (high-res), K3 1 on the high-res device path and the unfused video, K2
    never; capture seconds and pool MiB; the wall a call, graph against
    eager in turns (6 each, median), and the device time a call (the
    kernels' sum in a profiler window of 3). The voxel downsample's graph
    (keyed by shapes) on the high-res cloud (budget 1 M) and the clip
    (voxel 0.05) against the eager op: the same count and valid mask,
    each mean within ``VOXEL_RTOL`` or, for a voxel of many points, the
    f32 bound of its sum in another order (two eager calls logged beside);
    the voxel quantization's graph byte for byte. Then each public entry point once, read on its own: ``run_batch``
    (12/0/0 or 0/0/0), high-res ``run`` (24/0/0 on the depth grid, 24/0/1
    with the device voxel), video ``run`` (12/0/0, ``fuse_voxel`` 12/0/1)
    and the matte's ``alpha``.

Each phase logs its wall time. Kernel times: ``device`` is a CUDA graph
of 20 captured calls, replayed and timed with CUDA events (no host time
between launches; the median of 5 replays, per call); ``host-inclusive``
is 50 back-to-back calls between two CUDA events, wrapper and launch
path included. A bound is the larger of the bytes the call must move
(inputs read once, outputs written once) over 3.35 TB/s and its
operations over the H100's peak for the design that runs them (989
TFLOP/s bf16 on the tensor cores; K1 in f32 3xTF32, three products at
494.7 TFLOP/s TF32 for each f32 one, with the 67 TFLOP/s FP32-core bound
beside it; K2's f32 operations at 67 TFLOP/s on the FP32 cores).

It prints the per-kernel JSON line, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. It needs
the repository checkout (run it from its root) and imports no JAX and
nothing of the JAX package (it checks ``sys.modules`` at the end).
"""

from __future__ import annotations

import asyncio
import gc
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
# Slice, card vs CPU (the port's CPU parity tolerances; ZoeDepth's int8
# encoder: the larger of SLICE_RMSE and the codec's own error, see
# _slice_card_vs_cpu).
SLICE_KEEP_AGREE, SLICE_RMSE = 0.995, 1e-3
# Full-width raw model output, card (bf16) vs CPU (f32), max-normalized:
# bf16 alone (the same model in bf16 on the CPU) differs from f32 by
# 1.5-2.7 % on the three served models; the card is held to about twice
# the largest.
FULL_WIDTH_TOL = 0.05
# The SegFormer golden fixture on the card, max-normalized (PARITY.md's
# model tolerance; TF32 off), and the B0 matte's foreground probability,
# card vs CPU at 512² (TF32 off; f32 sums in another order).
SEGFORMER_TOL, MATTE_TOL = 5e-5, 1e-4
# A trainer step's gradients card vs CPU (f32, TF32 off), max-normalized
# per tensor: cuDNN's weight-gradient algorithms for the neck's
# convolutions sum in other orders than the CPU's (3.8e-3 at worst on an
# H100 80GB HBM3 at 700 W; the backbone's linears agree to 1e-3).
TRAIN_GRAD_TOL = 1e-2
# The voxel op card vs CPU on one cloud: CUDA's scatter-add is atomic, so
# each voxel's sum is taken in another order (a few f32 ulp of the mean).
VOXEL_RTOL = 1e-5
# Beyond it, a voxel of n points may differ by what two f32 sums of its
# points in different orders can: 2·(n-1)·2^-24·mean|p| (each order's
# worst case, (n-1)·2^-24·Σ|p|, over n), plus the division's rounding. On
# a depth map whose normalized tail sits at 0, tens of thousands of points
# share the voxel at the origin, where a mean of ~1e-3 makes VOXEL_RTOL
# ~100 points' worth of that bound; two eager calls on the card differ
# there by 1.4e-5 relative (an H100 80GB HBM3 at 700 W).


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


# K1 at head dims other than the served 64 (no preset serves one): the
# kD = 32 and 128 instances, and D below its instance's width (40, 80).
K1_HEAD_DIM_SHAPES = [(1, 6, 1370, 32), (1, 6, 1370, 40), (1, 8, 577, 80), (1, 4, 1370, 128)]
# Above D = 128: O in 128-column panels, one a warpgroup, the logits once a
# key tile per group of panels (up to 384 columns in bf16, 1024 in f32).
K1_WIDE_SHAPES = [(1, 4, 577, 160), (1, 4, 1370, 192), (1, 2, 1370, 256), (1, 2, 300, 320)]
# Checked, not timed: D a multiple of 8 but not of 16, and D past 384 (a
# second group of panels) with B·H = 3.
K1_WIDE_CHECKED = [(1, 2, 577, 136), (1, 3, 129, 392)]
# The f32 kernel is 3xTF32: three TF32 products for each f32 one.
TF32_TC_FLOP_S = 494.7e12


def _k1_bound(dtype, nbytes: float, flops: float) -> dict:
    """The bound of the design that runs: bf16 on the bf16 tensor cores (at
    every D); f32 in 3xTF32 (3·flops on the TF32 tensor cores). Every f32
    row also carries the FP32-core bound, the SIMT design's."""
    if dtype == torch.float32:
        return {**bound(nbytes, 3 * flops, TF32_TC_FLOP_S), "bound_design": "3xTF32",
                "fp32_core_bound_ms": bound(nbytes, flops, F32_FLOP_S)["bound_ms"]}
    return {**bound(nbytes, flops, BF16_TC_FLOP_S), "bound_design": "bf16 tensor cores"}


def phase_k1() -> dict:
    from image_to_pointcloud_tpu_torch.models.attention import attention_plain, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    timed = {}
    f32, bf16 = torch.float32, torch.bfloat16
    served = [((1, 6, 1370, 64), bf16), ((2, 6, 1370, 64), bf16), ((1, 16, 577, 64), bf16),
              ((1, 3, 65, 64), bf16), ((2, 6, 1370, 64), f32), ((1, 6, 1370, 64), f32),
              ((1, 16, 577, 64), f32)]
    head_dims = [(s, dt) for s in K1_HEAD_DIM_SHAPES + K1_WIDE_SHAPES for dt in (bf16, f32)]
    checked = [(s, dt) for s in K1_WIDE_CHECKED for dt in (bf16, f32)]
    timed_served = {((1, 6, 1370, 64), bf16), ((1, 16, 577, 64), bf16),
                    ((1, 6, 1370, 64), f32), ((1, 16, 577, 64), f32)}
    for shape, dtype in served + head_dims + checked:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        scale = shape[-1] ** -0.5
        o = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        err = (o.float() - ref).abs().max().item()
        tol = K1_TOL[dtype]
        log(f"K1 {tuple(shape)} {str(dtype)[6:]}: max_abs_err {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"K1 disagrees with its plain version at {shape} {dtype}")
        if (shape, dtype) in head_dims or (shape, dtype) in timed_served:
            b, h, n, d = shape
            flops = 4 * b * h * n * n * d  # Q·Kᵀ and P·V, 2 per multiply-add
            nbytes = 4 * b * h * n * d * q.element_size()
            name = f"K1 {shape} {str(dtype)[6:]}"
            res = {"shape": list(shape), "dtype": str(dtype)[6:], "max_abs_err": err,
                   **_timed_kernel(name, lambda: flash_attention(q, k, v),
                                   lambda: attention_plain(q, k, v, scale),
                                   lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
                   **_k1_bound(dtype, nbytes, flops)}
            fp32 = (f", FP32-core bound {res['fp32_core_bound_ms']:.5f} ms"
                    if dtype == f32 else "")
            log(f"{name}: {flops / 1e9:.3f} GFLOP, {b * h * n * n / 1e6:.2f} M "
                f"exponentials, {nbytes / 1e6:.2f} MB: {res['bound_design']} bound "
                f"{res['bound_ms']:.5f} ms ({res['bound_by']}){fp32}")
            timed[(shape, dtype)] = res
    # The line's numbers are DA-V2-Small's at one image; classic DPT-Large's,
    # the f32 serving shapes and the other head dims ride along.
    main = timed.pop(((1, 6, 1370, 64), bf16))
    return {**main, "also": list(timed.values())}


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


def _k2_check(name: str, pts: torch.Tensor, k: int = 20, window: int = 4) -> float:
    """K2 against its plain version, bit for bit; returns the max abs error
    (0) and logs where the means are 0."""
    from image_to_pointcloud_tpu_torch.ops.outlier import (
        grid_knn_mean_distances_cuda,
        grid_knn_mean_distances_plain,
    )

    o = grid_knn_mean_distances_cuda(pts, k=k, window=window)
    torch.cuda.synchronize()
    ref = grid_knn_mean_distances_plain(pts, k=k, window=window)
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


# K2 at (k, window) pairs other than the served (20, 4). The general
# kernel (k_eff = min(k, taps) <= 64): the JAX tests' (10, 7), the largest
# list at (64, 8), the smallest (1, 1), k above the taps at (40, 2) and
# (16, 3), the wide windows (20, 12) and (64, 16); list sizes at their
# edges (k_eff 9 a list of 16 with 7 entries at -inf, 24 and 63 the top
# of theirs, 33 a list of 40), and the widest window of the halo tile
# (50) beside the first on global taps (51). The sorted kernels (k_eff >
# 64: (100, 5), (300, 8) with k_eff = 289, (500, 12), k_eff = T at
# (121, 5), the largest register sort at (1000, 15), the shared-memory
# sort at (100, 16)).
K2_GENERAL_PAIRS = [(10, 7), (64, 8), (1, 1), (40, 2), (16, 3), (20, 12), (64, 16), (9, 2),
                    (24, 3), (33, 4), (63, 5), (8, 50), (8, 51)]
K2_SORTED_PAIRS = [(100, 5), (300, 8), (500, 12), (121, 5), (1000, 15), (100, 16)]
K2_PAIRS = K2_GENERAL_PAIRS + K2_SORTED_PAIRS
# Timed: every general pair on both 259² inputs, these sorted ones on the
# cube.
K2_TIMED_SORTED = {(100, 5), (300, 8), (500, 12), (1000, 15), (100, 16)}


def _k2_pairs(gen: torch.Generator, surface: torch.Tensor) -> list[dict]:
    """The general and sorted kernels, bit for bit against the plain
    version at each pair on the cube, the surface and a NaN/inf grid; the
    general pairs timed on both 259² inputs, K2_TIMED_SORTED on the cube,
    beside the bound."""
    from image_to_pointcloud_tpu_torch.ops.outlier import (
        grid_knn_mean_distances_cuda,
        grid_knn_mean_distances_plain,
    )

    cube = knn_cube(gen, (1, 259, 259, 3))
    naninf = knn_cube(gen, (1, 150, 200, 3))
    for (i, j), val in [((5, 7), float("nan")), ((70, 120), float("inf")),
                        ((149, 199), float("-inf")), ((0, 0), float("nan"))]:
        naninf[0, i, j, (i + j) % 3] = val
    out = []
    for k, r in K2_PAIRS:
        for name, pts in [("random cube", cube), ("synthetic surface", surface),
                          ("NaN/inf", naninf)]:
            err = _k2_check(f"k={k} window={r} {name}", pts, k=k, window=r)
            res = {"k": k, "window": r, "input": name, "shape": list(pts.shape),
                   "max_abs_err": err}
            if ((k, r) in K2_GENERAL_PAIRS and name != "NaN/inf") or (
                    (k, r) in K2_TIMED_SORTED and name == "random cube"):
                b, hh, ww, _ = pts.shape
                # Operations as the served row counts them: per in-grid tap
                # 3 sub, 3 mul, 2 add and the compare with the list's last
                # entry; ~5 an entry of the k_eff summed for the mean of
                # the square roots.
                k_eff = min(k, (2 * r + 1) ** 2)
                ops = b * (_knn_taps(hh, ww, r) * 9 + hh * ww * 5 * k_eff)
                nbytes = b * hh * ww * (12 + 4)
                res.update(_timed_kernel(
                    f"K2 k={k} window={r} {name} {tuple(pts.shape)}",
                    lambda: grid_knn_mean_distances_cuda(pts, k=k, window=r),
                    lambda: grid_knn_mean_distances_plain(pts, k=k, window=r)))
                res.update(bound(nbytes, ops, F32_FLOP_S))
                log(f"K2 k={k} window={r} {name}: {ops / 1e6:.1f} M ops, {nbytes / 1e6:.2f} MB: "
                    f"bound {res['bound_ms']:.5f} ms ({res['bound_by']})")
            out.append(res)
    return out


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
    # K2 on (its worst case); the synthetic depth surface and the other
    # (k, window) pairs ride along.
    return {**timed["random cube"],
            "also": [timed["synthetic surface"], *_k2_pairs(gen, inputs["synthetic surface"])]}


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


# depthnorm's timed shapes: DPT-Large's bulk batch at the working size and
# at its 384² preview, and one served 518² request.
DEPTHNORM_TIMED = [(16, 518, 518), (16, 384, 384), (1, 518, 518)]


def phase_depthnorm() -> dict:
    """The depthnorm kernel against its plain version run on the CPU, bit
    for bit, on the CPU tests' special planes (each alone at 37×45 and
    518², all in one batch of 16 at every batch shape of ``DEPTHNORM_TIMED``);
    timed at ``DEPTHNORM_TIMED`` on smooth depth maps beside its bound (the
    planes read once, written once) and the plain version on the card (its
    two key sorts a batch), its output checked bit for bit there too."""
    from pathlib import Path

    from image_to_pointcloud_tpu_torch.ops.depthnorm import (
        normalize_depth_cuda,
        normalize_depth_plain,
    )

    # The tests' planes, with the tests directory on the path as pytest puts
    # it (an installed package named ``tests`` may shadow the checkout's).
    tests_dir = str(Path(__file__).resolve().parent / "tests")
    sys.path.insert(0, tests_dir)
    try:
        from torch_depth_cases import NORMALIZE_CASES, depth_planes
    finally:
        sys.path.remove(tests_dir)

    rng = np.random.default_rng(23)
    cases = [c for c in NORMALIZE_CASES if c != "batch3"]
    for b, h, w in [(1, 37, 45), (1, 518, 518), (16, 384, 384), (16, 518, 518)]:
        planes = [depth_planes(rng, c, (h, w))[0] for c in cases]
        groups = [[p] for p in planes] if b == 1 else [[planes[i % len(planes)] for i in range(b)]]
        for invert in (True, False):
            for group in groups:
                x = torch.from_numpy(np.stack(group).reshape(len(group), -1))
                got = normalize_depth_cuda(x.cuda(), invert)
                torch.cuda.synchronize()
                if not torch.equal(got.cpu().view(torch.int32),
                                   normalize_depth_plain(x, invert).view(torch.int32)):
                    raise AssertionError(f"depthnorm disagrees with its plain version at "
                                         f"{(len(group), h, w)} invert {invert}")
        log(f"depthnorm ({b}, {h}, {w}): bit-identical to the plain version on the CPU on "
            f"{len(cases)} kinds of plane, invert and not")
    timed = {}
    for b, h, w in DEPTHNORM_TIMED:
        x = torch.from_numpy(np.stack([depth_planes(rng, "smooth", (h, w))[0]
                                       for _ in range(b)]).reshape(b, -1)).cuda()
        if not torch.equal(normalize_depth_cuda(x).cpu().view(torch.int32),
                           normalize_depth_plain(x.cpu()).view(torch.int32)):
            raise AssertionError(f"depthnorm disagrees with its plain version at {(b, h, w)}, smooth")
        nbytes = 2 * x.numel() * 4
        res = {"shape": [b, h, w],
               **_timed_kernel(f"depthnorm ({b}, {h}, {w})", lambda: normalize_depth_cuda(x),
                               lambda: normalize_depth_plain(x)),
               **bound(nbytes, 0, F32_FLOP_S)}
        log(f"depthnorm ({b}, {h}, {w}): {nbytes / 1e6:.2f} MB: bound {res['bound_ms']:.5f} ms "
            f"({res['bound_by']}), {res['bound_ms'] / res['ms'] * 100:.1f} % of it")
        timed[f"{b}x{h}x{w}"] = res
    return {**timed["16x518x518"], "also": [timed["16x384x384"], timed["1x518x518"]]}


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


# The served models at full width, card (bf16, as served) against the CPU
# (f32).
FULL_WIDTH_MODELS = ("depth-anything-v2", "dpt-large", "zoedepth")


def _max_norm_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, in f32 on the CPU."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _stage_hooks(model) -> tuple[dict, list]:
    """Forward hooks that keep each encoder block's output, the encoder's
    taps, the last fusion layer's output (the neck) and the model's raw
    output (the head), as f32."""
    caps: dict = {"blocks": []}
    fusion = model.neck.fusion3 if hasattr(model, "neck") else model.fusion3

    def keep(key):
        def hook(_m, _i, out):
            if key == "blocks":
                caps["blocks"].append(out.float())
            elif key == "taps":
                caps["taps"] = [t.float() for t in out]
            else:
                caps[key] = out.float()
        return hook

    hooks = [blk.register_forward_hook(keep("blocks")) for blk in model.backbone.blocks]
    hooks += [model.backbone.register_forward_hook(keep("taps")),
              fusion.register_forward_hook(keep("neck")), model.register_forward_hook(keep("head"))]
    return caps, hooks


def _eager_submit(pipe, imgs: np.ndarray, depth_scale: float = 15.0):
    """``pipe.submit_batch(imgs)`` without its CUDA graph: the signature's
    eager body (``_run_slots`` through ``fn.run``: every forward's Python
    runs, so hooks and wrappers see it) on the same payload, and the same
    handle."""
    from image_to_pointcloud_tpu_torch.pipeline.graph import PipelineOptions

    opts = PipelineOptions()
    b, h, w = imgs.shape[:3]
    pad = pipe._data_pad(b)
    run_imgs = np.concatenate([imgs, imgs[-1:].repeat(pad, 0)]) if pad else imgs
    scales = np.full((b + pad,), depth_scale, np.float32)
    fn = pipe.compiled_graph(b + pad, (h, w), opts, True)
    out, prev = fn.run(torch.from_numpy(pipe.pack_payload(run_imgs, scales)))
    return pipe._handle(out, prev, (h, w), opts, scales[:b], b, imgs=imgs)


def _eager_submit_jpeg(pipe, jpegs: list, depth_scale: float = 15.0):
    """``pipe.submit_batch_jpeg(jpegs)`` without its CUDA graph, as
    :func:`_eager_submit`."""
    from image_to_pointcloud_tpu_torch.pipeline.graph import PipelineOptions

    opts = PipelineOptions()
    b, spec = len(jpegs), jpegs[0].spec
    scales = np.full((b,), depth_scale, np.float32)
    cols = [j.grid_colors(2) for j in jpegs]
    host_rgb = (np.stack(cols) if pipe.quantized_transfer and pipe.host_colors_enabled
                and all(c is not None for c in cols) else None)
    caps = pipe.select_sparse_caps(jpegs)
    fn = pipe.compiled_graph_jpeg(b, spec, opts, True, sparse_cap=caps,
                                  host_colors=host_rgb is not None)
    payload = (pipe.pack_jpeg_sparse_payload(jpegs, scales, *caps) if caps is not None
               else pipe.pack_jpeg_payload(jpegs, scales))
    out, prev = fn.run(torch.from_numpy(payload))
    return pipe._handle(out, prev, (spec.height, spec.width), opts, scales, b, host_rgb=host_rgb)


def _served_stages(pipe, frame: np.ndarray) -> tuple[dict, object]:
    """The stages of one eager forward (hooks run only where Python runs:
    not in a graph's replay) and its result."""
    caps, hooks = _stage_hooks(pipe.model)
    try:
        res = pipe.collect(_eager_submit(pipe, frame[None]))[0]
    finally:
        for h in hooks:
            h.remove()
    return caps, res


def _full_width_compare(cpu_caps: dict, caps: dict) -> dict:
    """Each stage's max-normalized error, card against CPU."""
    return {
        "blocks": [_max_norm_err(g, c) for g, c in zip(caps["blocks"], cpu_caps["blocks"])],
        "taps": [_max_norm_err(g, c) for g, c in zip(caps["taps"], cpu_caps["taps"])],
        "neck": _max_norm_err(caps["neck"], cpu_caps["neck"]),
        "head": _max_norm_err(caps["head"], cpu_caps["head"]),
    }


def phase_full_width(models, cpu_models, cpu_stages: dict) -> dict:
    """The served DepthPipeline of each full-width model on the card (bf16,
    the quantized bundle) against the CPU (f32, the f32 return), same
    weights (the seeded init is made on the CPU), same frame: the raw
    model output, max-normalized, within ``FULL_WIDTH_TOL``; the card's normalized
    depth is not flat (p98 - p2 > 0) and more than one z value reaches the
    points. Every stage's error is logged: each encoder block, the taps,
    the neck (last fusion layer), the head's raw output; the depth
    normalization on the card is held to the CPU's bit for bit on the
    CPU's raw output. The CPU's stages are kept in ``cpu_stages`` for the
    f32 phase."""
    from image_to_pointcloud_tpu_torch.ops.depthnorm import normalize_depth

    frame = _frame(518, 518, 0)
    draw = torch.empty(4)
    torch.nn.init.trunc_normal_(draw, std=0.1, a=-0.2, b=0.2, generator=torch.Generator().manual_seed(0))
    log(f"this torch build's seeded init draws (trunc_normal_, seed 0): {draw.tolist()}")
    out = {}
    failed = []
    for name in FULL_WIDTH_MODELS:
        cpu_caps, cpu_res = _served_stages(cpu_models.get(name), frame)
        cpu_stages[name] = cpu_caps
        caps, res = _served_stages(models.get(name), frame)
        err = _full_width_compare(cpu_caps, caps)
        raw, cpu_raw = caps["head"], cpu_caps["head"]
        dn = normalize_depth(raw)
        p2, p98 = torch.quantile(dn.flatten().cpu(), torch.tensor([0.02, 0.98])).tolist()
        dn_same = torch.equal(normalize_depth(cpu_raw.cuda()).cpu(), normalize_depth(cpu_raw))
        z = np.unique(res.points[:, 2])
        log(f"full width {name}: raw output card [{raw.min():.4g}, {raw.max():.4g}] "
            f"({float((raw > 0).float().mean()):.3f} > 0), CPU [{cpu_raw.min():.4g}, "
            f"{cpu_raw.max():.4g}] ({float((cpu_raw > 0).float().mean()):.3f} > 0)")
        log(f"full width {name}: max-normalized error card vs CPU, blocks "
            f"{[round(e, 5) for e in err['blocks']]}, taps {[round(e, 5) for e in err['taps']]}, "
            f"neck {err['neck']:.5f}, head {err['head']:.5f} (tol {FULL_WIDTH_TOL:g})")
        log(f"full width {name}: normalized depth on the card p2 {p2:.4f} p98 {p98:.4f}; "
            f"depthnorm card == CPU on the CPU's output {dn_same}; {len(z)} distinct z of "
            f"{len(res.points)} points (CPU {len(np.unique(cpu_res.points[:, 2]))})")
        out[name] = {**err, "p98_minus_p2": p98 - p2, "distinct_z": len(z)}
        if not (err["head"] <= FULL_WIDTH_TOL and p98 - p2 > 0 and len(z) > 1 and dn_same):
            failed.append(name)
    if failed:
        raise AssertionError(f"the full-width forward on the card disagrees with the CPU: {failed}")
    return out


# f32 served on the card against the CPU's f32, max-normalized: the same
# operations in f32 (K1 in 3xTF32, TF32 off for the convolutions and
# matmuls), summed in other orders.
F32_FULL_WIDTH_TOL = 1e-4
F32_SERVED = (("depth-anything-v2", 12), ("dpt-large", 24))


def phase_full_width_f32(out_dir: str, cpu_stages: dict, f32_models
                         ) -> tuple[dict[str, int], dict]:
    """``ModelManager("cuda", use_bf16=False)``: each model's f32 forward on
    the card against the CPU's stages from :func:`phase_full_width` (the
    same seeded weights and frame), every stage logged, the head's raw
    output within ``F32_FULL_WIDTH_TOL`` (a miss points at an op left in
    TF32); the TF32 flags at torch's defaults around it, off inside the
    forward and restored after. Then two 518² PNG requests of each model
    through the v1 app, each read on its own: K1 (all f32 launches, the
    model being f32) exactly 12 / 24 times a request, K2 and K3 once,
    PLYs not flat. ``f32_models`` is ``ModelManager("cuda",
    use_bf16=False)``. Returns the launch counts and per-request counts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # torch's defaults
    frame = _frame(518, 518, 0)
    failed = []
    for name, _ in F32_SERVED:
        pipe = f32_models.get(name)
        if not (pipe.dtype == torch.float32 and pipe.exact_f32):
            raise AssertionError(f"{name}: ModelManager(use_bf16=False) did not build f32")
        caps, res = _served_stages(pipe, frame)
        err = _full_width_compare(cpu_stages[name], caps)
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        log(f"f32 full width {name}: max-normalized error card vs CPU, blocks "
            f"{[f'{e:.2e}' for e in err['blocks']]}, taps {[f'{e:.2e}' for e in err['taps']]}, "
            f"neck {err['neck']:.3e}, head {err['head']:.3e} (tol {F32_FULL_WIDTH_TOL:g}); "
            f"TF32 flags after (matmul, cudnn) {flags}; {len(np.unique(res.points[:, 2]))} distinct z")
        if not (err["head"] <= F32_FULL_WIDTH_TOL and flags == (False, True)
                and len(np.unique(res.points[:, 2])) > 1):
            failed.append(name)
    if failed:
        raise AssertionError(f"the f32 forward on the card disagrees with the CPU's: {failed}")
    counts: dict[str, int] = {}
    per_request: dict[str, dict[str, float]] = {}
    srv = _Server(out_dir, f32_models)
    try:
        for name, k1 in F32_SERVED:
            path_counts = _served_requests(srv.base, "png", name, 2, k1)
            n_requests = path_counts["unproject"]
            for kname, c in path_counts.items():
                counts[kname] = counts.get(kname, 0) + c
                per_request.setdefault(kname, {})[f"{name} png f32"] = c / n_requests
    finally:
        srv.stop()
    return counts, per_request


def _host_kernels() -> str:
    """What picks the host's and the card's kernels beyond torch's CPU
    capability: the CPU's AMX and AVX512-BF16 flags, the CPU threads, and
    cuDNN's version (two hosts with the same capability have given CPU
    references that differ, see PERF.md §7)."""
    try:
        flags = next((line.split(":", 1)[1].split() for line in open("/proc/cpuinfo")
                      if line.startswith("flags")), [])
    except OSError:
        flags = []
    return (f"amx {'amx_tile' in flags}, avx512_bf16 {'avx512_bf16' in flags}, "
            f"{torch.get_num_threads()} threads, cuDNN {torch.backends.cudnn.version()}")


class _Recorded:
    """Mixin of a DepthPipeline that keeps the inputs and bytes of the last
    device→host bundle it built (in a graph: the capture's tensors, which
    hold each replay's values)."""

    def _bundle(self, dn_s, keep, pix, *, ycc):
        out = super()._bundle(dn_s, keep, pix, ycc=ycc)
        self.last_bundle = (dn_s, keep, pix, ycc, out)
        return out


def _rmse(a, b) -> float:
    """Per-point RMSE of two results' packed points, on points both keep."""
    both = (a.packed[6] > 0.5) & (b.packed[6] > 0.5)
    return float(np.sqrt(((a.packed[:3, both] - b.packed[:3, both]) ** 2).sum(0).mean()))


def _slice_card_vs_cpu(family: str, cpu_model, gpu_model, target) -> None:
    """One tiny model's slice on the card against the same slice on the
    CPU, through the f32 return and through the quantized bundle.

    Both returns: the same point count, colours exact, keep masks agreeing
    on ``SLICE_KEEP_AGREE`` of the points, previews within one level. The
    f32 return: point RMSE below ``SLICE_RMSE``. The bundle: the card's
    bytes equal the CPU's codec on the card's own inputs (the strided
    normalized depth, keep mask and colours that entered it), and that
    depth is within ``SLICE_RMSE`` of the CPU's, in the points' units
    (times the depth scale). The decoded bundles are not held to each
    other: two f32 runs of one model whose depths differ by a few ulps
    flip a handful of 8-bit tile codes, and one flip moves the RMSE by
    ~3e-4. That RMSE is logged beside the same figure between the CPU at
    its threads and at one thread (the noise floor of f32 itself)."""
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline

    Recording = type("Recording", (_Recorded, DepthPipeline), {})

    def run(model, quantized):
        pipe = Recording(model, model_target=target, quantized_transfer=quantized)
        return pipe, pipe.run(img, depth_scale=15.0)

    img = np.random.default_rng(0).integers(0, 256, (200, 260, 3), dtype=np.uint8)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    threads = torch.get_num_threads()
    try:
        cpu_pipes, cpu_runs = zip(*(run(cpu_model, q) for q in (False, True)))
        codec_rmse = _rmse(cpu_runs[1], cpu_runs[0])
        torch.set_num_threads(1)
        try:
            cpu_noise = _rmse(cpu_runs[1], run(cpu_model, True)[1])
        finally:
            torch.set_num_threads(threads)
        gpu_pipes, gpu_runs = zip(*(run(gpu_model, q) for q in (False, True)))
        f32_rmse = _rmse(cpu_runs[0], gpu_runs[0])
        tol = SLICE_RMSE
        if family == "ZoeDepth int8":
            # The random-init ZoeDepth map spans only ±8 % of its mean
            # (the others span their whole range), so the depth
            # normalization scales its card-vs-CPU differences up ~9x and
            # the int8 encoder's activation codes flip by one step (1/127
            # of a token's max). Held to the bundle codec's own error on
            # this map instead, the precision a served request has.
            tol = max(SLICE_RMSE, codec_rmse)
        # Beside each result, which side a failure moved: the host CPU's
        # kernels (the CPU reference and the codec run there), the f32
        # return's error, and the codec's own error on the CPU.
        context = (f"; cpu capability {torch.backends.cpu.get_cpu_capability()} "
                   f"({_host_kernels()}), f32 return rmse {f32_rmse:.3e}, codec's own rmse on "
                   f"the CPU {codec_rmse:.3e}")
        for quantized, (cpu, gpu) in enumerate(zip(cpu_runs, gpu_runs)):
            kc, kg = cpu.packed[6] > 0.5, gpu.packed[6] > 0.5
            agree = float((kc == kg).mean())
            rmse = _rmse(cpu, gpu)
            colors = bool(np.array_equal(cpu.packed[3:6], gpu.packed[3:6]))
            prev = int(np.abs(cpu.depth_preview_gray.astype(int)
                              - gpu.depth_preview_gray.astype(int)).max())
            same = (gpu.raw_point_count == cpu.raw_point_count and colors
                    and agree >= SLICE_KEEP_AGREE and prev <= 1)
            if quantized:
                cpu_dn = cpu_pipes[1].last_bundle[0]
                dn_s, keep, pix, ycc, sent = gpu_pipes[1].last_bundle
                replay = cpu_pipes[1]._bundle(
                    dn_s.cpu(), keep.cpu(), None if pix is None else pix.cpu(), ycc=ycc)
                exact = torch.equal(sent.cpu(), replay)
                depth_rmse = 15.0 * float((dn_s.cpu() - cpu_dn).pow(2).mean().sqrt())
                values = (f"bundle == the CPU's codec on the card's depth {exact}, that depth "
                          f"vs the CPU's rmse {depth_rmse:.3e} (< {tol:.3e}), decoded rmse "
                          f"{rmse:.3e} (CPU vs CPU at 1 thread {cpu_noise:.3e}, not bounded)")
                ok = exact and depth_rmse < tol
            else:
                values = f"rmse {rmse:.3e} (< {tol:.3e})"
                ok = rmse < tol
            log(f"{family} slice card vs CPU, {'quantized bundle' if quantized else 'f32 return'}: "
                f"points {gpu.raw_point_count}/{cpu.raw_point_count}, colors exact {colors}, "
                f"keep agree {agree:.5f} (>= {SLICE_KEEP_AGREE}), {values}, "
                f"preview max diff {prev}{context}")
            if not (same and ok):
                raise AssertionError(f"{family} slice on the card disagrees with the CPU")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# The served int8 matmul shapes at one image: (rows, in, out).
INT8_SHAPES = {
    "DA-V2 fc1": (1370, 384, 1536), "DA-V2 fc2": (1370, 1536, 384),
    "DPT-Large fc1": (577, 1024, 4096), "DPT-Large fc2": (577, 4096, 1024),
    "ZoeDepth fc1": (1025, 1024, 4096),
}
INT8_TOP_S = 1979e12  # the H100's dense int8 tensor-core peak


def phase_int8_linear() -> dict:
    """``QuantLinear`` on the card against its CPU run at the served
    shapes, bf16 activations: the codes' int32 accumulator and the output
    bit-identical. Times (device, CUDA graph): ``torch._int_mm`` alone
    beside its bound, the whole ``QuantLinear`` forward, and the bf16
    ``nn.Linear`` it replaces."""
    from image_to_pointcloud_tpu_torch.models.quantize import (
        QuantLinear,
        int8_matmul,
        quantize_activations,
        quantize_dense_params,
    )

    gen = torch.Generator().manual_seed(4)
    out = {}
    for name, (m, k, n) in INT8_SHAPES.items():
        lin = torch.nn.Linear(k, n)
        x = torch.randn(m, k, generator=gen).to(torch.bfloat16)
        cpu = QuantLinear(k, n)
        cpu.load_state_dict(quantize_dense_params(lin.weight, lin.bias))
        card = QuantLinear(k, n)
        card.load_state_dict(cpu.state_dict())
        card = card.to("cuda", torch.bfloat16)
        codes, _ = quantize_activations(x)
        xg, cg = x.cuda(), codes.cuda()
        same_acc = torch.equal(int8_matmul(cg, card.weight_q.T).cpu(), int8_matmul(codes, cpu.weight_q.T))
        with torch.inference_mode():
            same_out = torch.equal(card(xg).cpu(), cpu(x))
        lin = lin.to("cuda", torch.bfloat16)
        res = {"int_mm_ms": device_time_ms(lambda: torch._int_mm(cg, card.weight_q.T)),
               "quant_linear_ms": device_time_ms(lambda: card(xg)),
               "bf16_linear_ms": device_time_ms(lambda: lin(xg)),
               **bound(m * k + k * n + 4 * m * n, 2 * m * k * n, INT8_TOP_S)}
        log(f"int8 {name} ({m}, {k}) x ({k}, {n}): accumulator card == CPU {same_acc}, output "
            f"card == CPU {same_out}; _int_mm {res['int_mm_ms']:.5f} ms (bound "
            f"{res['bound_ms']:.5f}, {res['bound_by']}), QuantLinear {res['quant_linear_ms']:.5f} ms, "
            f"bf16 nn.Linear {res['bf16_linear_ms']:.5f} ms")
        if not (same_acc and same_out):
            raise AssertionError(f"QuantLinear on the card disagrees with the CPU at {name}")
        out[name] = res
    return out


def _quantized(cfg, seed: int = 0):
    """A model of ``cfg.with_quantized(True)`` from the seeded f32 init."""
    from image_to_pointcloud_tpu_torch.models.depth_anything import build_model, init_weights
    from image_to_pointcloud_tpu_torch.models.quantize import quantize_encoder_params

    sd = init_weights(build_model(cfg), torch.Generator().manual_seed(seed)).state_dict()
    model = build_model(cfg.with_quantized(True))
    model.load_state_dict(quantize_encoder_params(sd, cfg.backbone.num_layers), strict=True)
    return model


def phase_slice_int8() -> None:
    """Phase 8 over the int8 encoders of the three tiny families."""
    for family, (cfg, target) in _tiny_configs().items():
        _slice_card_vs_cpu(f"{family} int8", _quantized(cfg), _quantized(cfg).to("cuda"), target)


def _cloud_close(name: str, ours, ref, tol: float = SLICE_RMSE) -> None:
    """Two (points, colours) clouds in the same order: per-point RMSE below
    ``tol``, colours within half a level."""
    rmse = float(np.sqrt(((ours[0] - ref[0]) ** 2).sum(1).mean())) if len(ref[0]) else 0.0
    same = ours[0].shape == ref[0].shape
    col = float(np.abs(ours[1] - ref[1]).max()) if same and len(ref[1]) else 0.0
    log(f"{name}: {len(ours[0])}/{len(ref[0])} points, rmse {rmse:.3e} (< {tol:g}), colour "
        f"max diff {col}")
    if not (same and len(ref[0]) and rmse < tol and col <= 0.5):
        raise AssertionError(f"{name} on the card disagrees with the CPU")


def phase_advanced_tiny() -> None:
    """The advanced pipelines on a tiny Depth-Anything (and its metric
    head), card vs CPU, same weights, f32, TF32 off, on both transfer
    contracts; the voxel op card vs CPU on one cloud."""
    import dataclasses

    from image_to_pointcloud_tpu_torch.models.depth_anything import build_model, init_weights
    from image_to_pointcloud_tpu_torch.ops.voxel import voxel_downsample
    from image_to_pointcloud_tpu_torch.pipeline import advanced

    cfg, target = _tiny_configs()["Depth-Anything-V2"]
    mcfg = dataclasses.replace(cfg, neck=dataclasses.replace(cfg.neck, metric_depth=True, max_depth=5.0))
    rng = np.random.default_rng(5)
    img = _frame(300, 400, 5)
    clip = np.stack([_frame(200, 260, 20 + i) for i in range(3)])
    intr = advanced.CameraIntrinsics(fx=300.0, fy=310.0, cx=190.0, cy=160.0)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        runs = {}
        for dev in ("cpu", "cuda"):
            rel = init_weights(build_model(cfg), torch.Generator().manual_seed(0)).to(dev)
            met = init_weights(build_model(mcfg), torch.Generator().manual_seed(0)).to(dev)
            for q in (False, True):
                runs[dev, "metric", q] = advanced.MetricPipeline(
                    met, model_target=target, quantized_transfer=q).run(img, intr, step=2)
                runs[dev, "highres", q] = advanced.HighResPipeline(
                    rel, tile=140, overlap=28, model_target=target, quantized_transfer=q
                ).run(img, step=2, voxel_budget=None)
                runs[dev, "video", q] = advanced.VideoPipeline(
                    rel, model_target=target, quantized_transfer=q).run(clip, step=2)
        for (dev, name, q), res in runs.items():
            if dev == "cuda":
                _cloud_close(f"tiny {name} {'quantized' if q else 'f32'} transfer, card vs CPU",
                             res, runs["cpu", name, q])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    pts = torch.from_numpy(rng.normal(0.0, 2.0, (200_000, 3)).astype(np.float32))
    cols = torch.from_numpy(rng.uniform(0.0, 255.0, (200_000, 3)).astype(np.float32))
    ref = voxel_downsample(pts, cols, 0.5)  # ~30 points a voxel
    got = [t.cpu() for t in voxel_downsample(pts.cuda(), cols.cuda(), 0.5)]
    cnt = int(ref[3])
    err = max(float(((got[i][:cnt] - ref[i][:cnt]).abs() / ref[i][:cnt].abs().clamp_min(1e-3)).max())
              for i in (0, 1))
    log(f"voxel_downsample card vs CPU, 200,000 points: {int(got[3])}/{cnt} voxels, same order and "
        f"means within {err:.2e} relative (<= {VOXEL_RTOL:g})")
    if not (int(got[3]) == cnt and torch.equal(got[2], ref[2]) and err <= VOXEL_RTOL):
        raise AssertionError("voxel_downsample on the card disagrees with the CPU")


def _read_cloud(path) -> int:
    """Point count of a CLI output file, read back by its format."""
    from image_to_pointcloud_tpu_torch.io import read_las

    data = path.read_bytes()
    suffix = path.suffix
    if suffix == ".ply":
        return len(_check_ply(data))
    if suffix == ".las":
        pts = read_las(data)["points"]
        n, ok = len(pts), np.isfinite(pts).all()
    elif suffix == ".xyz":
        rows = np.loadtxt(path, ndmin=2)
        n, ok = len(rows), rows.shape[1] == 6 and np.isfinite(rows).all()
    elif suffix == ".pcd":
        head = data[: data.index(b"DATA binary\n")].decode()
        n = int(head.split("POINTS ")[1].split()[0])
        ok = len(data) == len(head) + len(b"DATA binary\n") + 16 * n
    else:  # .glb
        n = json.loads(data[20 : 20 + int.from_bytes(data[12:16], "little")])["accessors"][0]["count"]
        ok = data[:4] == b"glTF" and int.from_bytes(data[8:12], "little") == len(data)
    if not (ok and n > 0):
        raise AssertionError(f"{path.name}: bad {suffix} file ({n} points)")
    return n


# Each advanced CLI run's wall when the advanced pipelines ran eagerly (this
# script, on an NVIDIA H100 80GB HBM3 at 700 W). A run now pays one capture
# a signature, as a run of the JAX CLI pays one compile.
EAGER_CLI_WALL_S = {"highres": 0.84, "metric DA-V2-metric-small": 0.54,
                    "metric zoedepth-small": 1.67, "video": 0.42, "video --voxel": 0.52}


def phase_cli(out_dir: str) -> tuple[dict[str, int], dict[str, dict[str, float]]]:
    """The CLI's paths in this process (``cli.main``), on the card, full
    width, random init: each run read on its own (the launch counters
    zeroed just before and read just after) and held to its K1/K2/K3
    launches; each output file read back."""
    from pathlib import Path

    from image_to_pointcloud_tpu_torch import cli, cuda
    from image_to_pointcloud_tpu_torch.io.image import encode_png

    d = Path(out_dir) / "cli"
    d.mkdir()
    src = {"big": _frame(1024, 1024, 6), **{f"f{i}": _frame(518, 518, 7 + i) for i in range(4)}}
    for name, img in src.items():
        (d / f"{name}.png").write_bytes(encode_png(img))
    f = {name: str(d / f"{name}.png") for name in src}
    frames = [f[f"f{i}"] for i in range(4)]
    # (run, argv, (K1, K2, K3, depthnorm) launches). HighRes: the anchor
    # pass and the nine 518² tiles of a 1024² frame, one forward each (24
    # K1), the depth grid to the host (no K3), the blended frame normalized
    # once. Video: four frames in one forward, one normalize; --voxel
    # unprojects them on the card in one K3 launch. Metric: no normalize.
    runs = [
        ("highres", ["highres", f["big"], "-o", str(d / "highres.ply")], (24, 0, 0, 1)),
        ("metric DA-V2-metric-small", ["metric", f["f0"], "-o", str(d / "metric_da.ply"),
                                       "--model", "depth-anything-v2-metric-small"], (12, 0, 0, 0)),
        ("metric zoedepth-small", ["metric", f["f0"], "-o", str(d / "metric_zoe.ply")],
         (0, 0, 0, 0)),
        ("video", ["video", *frames, "-o", str(d / "video.ply")], (12, 0, 0, 1)),
        ("video --voxel", ["video", *frames, "-o", str(d / "video_voxel.ply"), "--voxel", "0.05"],
         (12, 0, 1, 1)),
        *[(f"convert {fmt}", ["convert", f["f1"], "-o", str(d / f"cloud.{fmt}")], (12, 1, 1, 1))
          for fmt in ("ply", "las", "xyz", "pcd", "glb")],
        ("convert --int8", ["convert", f["f1"], "-o", str(d / "cloud_int8.ply"), "--int8"],
         (12, 1, 1, 1)),
    ]
    counts: dict[str, int] = {}
    per_run: dict[str, dict[str, float]] = {}
    for name, argv, (k1, k2, k3, dn) in runs:
        for k in cuda.KERNELS:
            k.reset()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        got = {k.name: k.launches for k in cuda.KERNELS}
        n = _read_cloud(Path(argv[argv.index("-o") + 1]))
        eager = f" (eager {EAGER_CLI_WALL_S[name]:.2f} s)" if name in EAGER_CLI_WALL_S else ""
        log(f"cli {name}: rc {rc}, {n} points read back, {time.perf_counter() - t0:.2f} s"
            f"{eager}, launches {got}")
        if rc != 0 or got != {"flash_attention": k1, "grid_knn": k2, "unproject": k3,
                              "depthnorm": dn}:
            raise AssertionError(f"cli {name}: rc {rc}, launched {got}; expected "
                                 f"{(k1, k2, k3, dn)}")
        for kname, c in got.items():
            counts[kname] = counts.get(kname, 0) + c
            per_run.setdefault(kname, {})[f"cli {name}"] = c
    return counts, per_run


def _multipart(data: bytes, ctype: str, fields: dict | None = None) -> tuple[bytes, str]:
    boundary = uuid.uuid4().hex
    body = b"".join(
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n{v}\r\n".encode()
        for k, v in (fields or {}).items()
    ) + (
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


def _completed(base: str, job: str) -> dict:
    """Long-poll /status until the job ends; its final status, which must
    be ``completed``."""
    deadline = time.perf_counter() + 600
    while True:
        st = json.loads(_http(f"{base}/status/{job}?wait_ms=2000"))
        if st["status"] in ("completed", "error"):
            break
        if time.perf_counter() > deadline:
            raise TimeoutError(f"job {job} did not finish")
    if st["status"] != "completed":
        raise AssertionError(f"job failed: {st['message']}")
    return st


def _request(base: str, data: bytes, ctype: str = "image/png",
             model: str = "depth-anything-v2") -> tuple[float, dict, bytes]:
    """POST /process → poll /status → GET /download; returns (seconds from
    the upload to the downloaded PLY, final status, the PLY)."""
    body, ctype = _multipart(data, ctype)
    t0 = time.perf_counter()
    job = json.loads(_http(f"{base}/process?output_format=ply&point_density=medium"
                           f"&depth_scale=15&model={model}", body, ctype))["job_id"]
    st = _completed(base, job)
    ply = _http(f"{base}{st['results']['downloadUrl']}")
    latency = time.perf_counter() - t0
    timings = json.loads(_http(f"{base}/timings/{job}"))["timings"]
    return latency, {**st, "timings": timings}, ply


def _check_ply(data: bytes, n: int | None = None) -> np.ndarray:
    """The PLY's points: ``n`` of them (when given), finite, and not flat
    (more than one distinct z, p98 - p2 of z > 0)."""
    from image_to_pointcloud_tpu_torch.io import read_ply

    v = read_ply(data)["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1)
    ok = len(xyz) > 0 and (n is None or len(xyz) == n) and np.isfinite(xyz).all()
    if ok:
        p2, p98 = np.percentile(xyz[:, 2], [2, 98])
        ok = len(np.unique(xyz[:, 2])) > 1 and p98 - p2 > 0
    if not ok:
        raise AssertionError(f"bad PLY: {len(xyz)} points (expected {n}), finite "
                             f"{np.isfinite(xyz).all()}, z {np.unique(xyz[:, 2])[:5]}...")
    return xyz


def _png(h: int, w: int, seed: int) -> bytes:
    from image_to_pointcloud_tpu_torch.io.image import encode_png

    return encode_png(_frame(h, w, seed))


# depthnorm launches (one a normalize call, all of a batch's planes in
# it) of a 518² forward with its preview: 1 where the model's depth grid
# is the working size and the preview shares the points' normalize, 2
# where it is not (DPT-Large's 384²; DA-V2 at a 300x400 or 512² input).
DEPTHNORM_518 = {"depth-anything-v2": 1, "depth-anything-v2-metric-small": 1,
                 "dpt-large": 2, "zoedepth": 1}

# The main paths the server drives: (app: the default PNG one, the hybrid
# JPEG one, or the one over the int8 encoder; model; 518² requests after
# the cold one; K1 launches per request: one per transformer layer).
SERVED_PATHS = [
    ("png", "depth-anything-v2", 5, 12),
    ("jpeg", "depth-anything-v2", 5, 12),
    ("png", "dpt-large", 3, 24),
    # BEiT's attention carries an additive bias: plain torch ops, not K1.
    ("png", "zoedepth", 3, 0),
    # Attention is not quantized: K1 runs in every layer of the int8 model.
    ("int8", "depth-anything-v2", 3, 12),
]


def _served_requests(base: str, app: str, model: str, n: int, k1_per_request: int
                     ) -> dict[str, int]:
    """One main path through the server: the launch counters are zeroed
    just before its requests and read just after."""
    from image_to_pointcloud_tpu_torch import cuda

    kind = "jpeg" if app == "jpeg" else "png"
    path = f"{model} {app}"
    make, ctype, stage = {
        "png": (_png, "image/png", "decode"),
        "jpeg": (_jpeg, "image/jpeg", "jpeg_plan"),
    }[kind]
    # The first request of a path builds the model and the kernels: not
    # timed as serving.
    lat, st, _ = _request(base, make(518, 518, 0), ctype, model)
    log(f"server cold {path} request 518x518: {lat * 1e3:.1f} ms, timings {st['timings']}")

    for k in cuda.KERNELS:
        k.reset()
    lats = []
    extra = [(300, 400)] if (app, model) == ("png", "depth-anything-v2") else []
    for i, (h, w) in enumerate([(518, 518)] * n + extra):
        lat, st, ply = _request(base, make(h, w, 10 + i), ctype, model)
        xyz = _check_ply(ply, st["results"]["pointCloud"]["points"])
        if stage not in st["timings"]:
            raise AssertionError(f"{kind} request #{i} did not take the {stage} ingest: "
                                 f"timings {st['timings']}")
        if (h, w) == (518, 518):
            lats.append(lat)
        log(f"{path} request {w}x{h} #{i}: {lat * 1e3:.1f} ms, "
            f"{st['results']['pointCloud']['points']} points, {len(np.unique(xyz[:, 2]))} distinct "
            f"z in [{xyz[:, 2].min():.4g}, {xyz[:, 2].max():.4g}], timings {st['timings']}")
    counts = {k.name: k.launches for k in cuda.KERNELS}
    n_requests = n + len(extra)
    log(f"server p50 latency 518x518 {path} -> PLY: "
        f"{statistics.median(lats) * 1e3:.1f} ms over {len(lats)} sequential requests")
    log(f"kernel launches during the {n_requests} served {path} requests: {counts}")
    expected = {"flash_attention": k1_per_request * n_requests, "grid_knn": n_requests,
                "unproject": n_requests,
                "depthnorm": DEPTHNORM_518[model] * n + 2 * len(extra)}
    if counts != expected:
        raise AssertionError(f"the {path} path launched {counts}; expected {expected}")
    return counts


class _Server:
    """The port's v1 app (or, with ``v2``, the v2 app, its model loaded by
    its ``startup``) behind the first-party HTTP server, on a private
    event-loop thread."""

    def __init__(self, out_dir: str, models, v2: bool = False, **app_kw):
        from image_to_pointcloud_tpu_torch.serve.http import HttpServer
        from image_to_pointcloud_tpu_torch.serve.app_v1 import create_v1_app
        from image_to_pointcloud_tpu_torch.serve.app_v2 import create_v2_app

        self.loop = asyncio.new_event_loop()
        create = create_v2_app if v2 else create_v1_app
        self.app = create(output_dir=out_dir, models=models, durable_jobs=False, **app_kw)
        self.server = HttpServer(self.app.router, "127.0.0.1", 0)
        self.loop.run_until_complete(self.server.start())
        if v2:
            self.loop.run_until_complete(self.app.startup())
            if self.app.processor is None:
                raise AssertionError("the v2 app did not load its processor")
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.bound_port}"

    def stop(self) -> None:
        _stop(self.loop, self.thread, self.server, self.app)


def phase_server(out_dir: str, models, int8_models
                 ) -> tuple[dict[str, int], dict[str, dict[str, float]]]:
    """Launch counts summed over the served paths, and per request of each
    path."""
    counts: dict[str, int] = {}
    per_request: dict[str, dict[str, float]] = {}
    servers = {"png": _Server(out_dir, models)}
    try:
        servers["jpeg"] = _Server(out_dir, models, jpeg_device_decode=True)
        servers["int8"] = _Server(out_dir, int8_models)
        for app, model, n, k1_per_request in SERVED_PATHS:
            t0 = time.perf_counter()
            path_counts = _served_requests(servers[app].base, app, model, n, k1_per_request)
            n_requests = path_counts["unproject"]  # one launch a request
            for name, c in path_counts.items():
                counts[name] = counts.get(name, 0) + c
                per_request.setdefault(name, {})[f"{model} {app}"] = c / n_requests
            log(f"served path {model} {app}: {time.perf_counter() - t0:.1f} s")
        for name in ("dpt-large", "zoedepth"):
            if not models.random_weights[name]:
                raise AssertionError(f"{name} was expected to serve the random init")
        phase_triposr(servers["png"].base)
    finally:
        for srv in servers.values():
            srv.stop()
    if not models.get("depth-anything-v2").quantized_transfer:
        raise AssertionError("the server on the card did not default to the quantized bundle")
    from image_to_pointcloud_tpu_torch.models.quantize import QuantLinear

    if not any(isinstance(m, QuantLinear) for m in int8_models.get("depth-anything-v2").model.modules()):
        raise AssertionError("the int8 app did not serve the int8 encoder")
    return counts, per_request


# ---------- phase 12b: one CUDA graph per signature ----------

# The paths whose graphs are held against their eager forward at full
# width, 518²: (label, model, ModelManager kind, ingest, K1 launches a batch).
GRAPH_PATHS = [
    ("DA-V2 PNG", "depth-anything-v2", "bf16", "png", 12),
    ("DA-V2 JPEG sparse", "depth-anything-v2", "bf16", "jpeg-sparse", 12),
    ("DA-V2 JPEG dense", "depth-anything-v2", "bf16", "jpeg-dense", 12),
    ("dpt-large", "dpt-large", "bf16", "png", 24),
    ("zoedepth", "zoedepth", "bf16", "png", 0),
    ("DA-V2 int8", "depth-anything-v2", "int8", "png", 12),
    ("DA-V2 f32", "depth-anything-v2", "f32", "png", 12),
]
GRAPH_BUCKETS = (1, 4)


def _graph_signature(pipe, ingest: str, batch: int, seed: int = 0):
    """(fn, host payload) of one served signature: ``batch`` 518² frames
    through the pixel ingest or a q88 JPEG's sparse or dense payload."""
    from image_to_pointcloud_tpu_torch.pipeline.graph import PipelineOptions, plan_jpeg_input

    opts = PipelineOptions()
    scales = np.full((batch,), 15.0, np.float32)
    if ingest == "png":
        imgs = np.stack([_frame(518, 518, seed + i) for i in range(batch)])
        return pipe.compiled_graph(batch, (518, 518), opts, True), pipe.pack_payload(imgs, scales)
    jpegs = [plan_jpeg_input(_jpeg(518, 518, seed + i)) for i in range(batch)]
    host = all(j.grid_colors(2) is not None for j in jpegs)
    if ingest == "jpeg-sparse":
        caps = pipe.select_sparse_caps(jpegs)
        if caps is None:
            raise AssertionError("the q88 518² JPEG did not take the sparse payload")
        return (pipe.compiled_graph_jpeg(batch, jpegs[0].spec, opts, True, sparse_cap=caps,
                                         host_colors=host),
                pipe.pack_jpeg_sparse_payload(jpegs, scales, *caps))
    return (pipe.compiled_graph_jpeg(batch, jpegs[0].spec, opts, True, host_colors=host),
            pipe.pack_jpeg_payload(jpegs, scales))


def _graph_vs_eager(label: str, pipe, fn, payload: np.ndarray, k1: int, dn: int) -> dict:
    """One signature: its capture (timed, with the pool's growth), one
    replay against the eager body on the same payload (bytes; launches),
    each checked."""
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline

    pool0 = pipe.graph_pool_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(payload)  # capture, then the first replay
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    pool = pipe.graph_pool_bytes()
    _reset()
    out, prev = fn(payload)
    torch.cuda.synchronize()
    replay_counts, graph_bundle = _counts(), pipe.last_bundle
    _reset()
    eout, eprev = fn.run(torch.from_numpy(payload).to(pipe.device))
    torch.cuda.synchronize()
    eager_counts, eager_bundle = _counts(), pipe.last_bundle
    same = torch.equal(out, eout) and torch.equal(prev, eprev)
    rule = "bytes equal"
    if not same:
        # The stated fallback: the graph's bundle is the CPU codec on the
        # graph's own depth, and that depth is near eager's.
        dn_s, keep, pix, ycc, sent = graph_bundle
        replay = DepthPipeline._bundle(pipe, dn_s.cpu(), keep.cpu(),
                                       None if pix is None else pix.cpu(), ycc=ycc)
        depth_rmse = 15.0 * float((dn_s - eager_bundle[0]).float().pow(2).mean().sqrt())
        prev_diff = int((prev.int() - eprev.int()).abs().max())
        same = torch.equal(sent.cpu(), replay) and depth_rmse < SLICE_RMSE and prev_diff <= 1
        rule = (f"bytes DIFFER ({int((out != eout).sum())} of {out.numel()}); fallback: bundle == "
                f"CPU codec on the graph's depth {torch.equal(sent.cpu(), replay)}, depth rmse "
                f"vs eager {depth_rmse:.3e} (< {SLICE_RMSE}), preview max diff {prev_diff}")
    b = payload.shape[0]
    expected = {"flash_attention": k1, "grid_knn": 1, "unproject": 1,
                "depthnorm": dn}
    row = {"batch": b, "capture_s": fn.capture_s, "first_call_s": first_s,
           "pool_bytes": pool, "pool_growth_bytes": pool - pool0,
           "launches_replay": replay_counts, "launches_eager": eager_counts, "equal": same}
    log(f"graph {label} batch {b}: {rule}; launches a replay {replay_counts}, eager "
        f"{eager_counts}; capture {fn.capture_s:.3f} s (first call {first_s:.3f} s); "
        f"pool {pool / 2**20:.1f} MiB (+{(pool - pool0) / 2**20:.1f})")
    if not same or replay_counts != eager_counts or replay_counts != expected:
        raise AssertionError(f"the {label} graph at batch {b} disagrees with its eager forward "
                             f"(launches {replay_counts}, expected {expected})")
    return row


def _graph_in_flight(pipe) -> None:
    """Two submits before either collect equal the sequential runs; a
    400×300 signature captured on this thread while another replays 518²."""
    a, b = _frame(518, 518, 21), _frame(518, 518, 22)
    seq = [pipe.collect(pipe.submit_batch([x], depth_scales=15.0))[0] for x in (a, b)]
    handles = [pipe.submit_batch([x], depth_scales=15.0) for x in (a, b)]
    both = [pipe.collect(h)[0] for h in handles]
    intact = all(np.array_equal(s.points, r.points) and np.array_equal(s.colors, r.colors)
                 for s, r in zip(seq, both))
    errors, replays = [], []

    def replay():
        try:
            for _ in range(20):
                replays.append(pipe.collect(pipe.submit_batch([a], depth_scales=15.0))[0])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    before = len(pipe._compiled)
    thread = threading.Thread(target=replay)
    thread.start()
    t0 = time.perf_counter()
    other = pipe.collect(pipe.submit_batch([_frame(300, 400, 23)], depth_scales=15.0))[0]
    capture_wall = time.perf_counter() - t0
    thread.join(timeout=300)
    steady = all(np.array_equal(r.points, seq[0].points) for r in replays)
    log(f"graph two in flight == sequential {intact}; 400x300 captured in {capture_wall:.3f} s "
        f"while another thread replayed 518² {len(replays)} times (all equal {steady}, errors "
        f"{errors}); {other.raw_point_count} points")
    if not (intact and steady and not errors and not thread.is_alive()
            and len(pipe._compiled) == before + 1):
        raise AssertionError("graphs in flight or captured beside a replay came back wrong")


def _graph_warmup(out_dir: str, models) -> dict:
    """A v1 app at ``max_batch=4`` (the CLI's ``IPC_TPU_MAX_BATCH=4``),
    warmup size 518², ``jpeg_device_decode`` on, over a fresh pipeline of
    the served DA-V2: the warmup captures buckets 1, 2, 4 on both ingests.
    Then a drain of three queued frames (padded to bucket 4, three
    results) and three concurrent 518² PNG requests through the server:
    the drains' sizes (real, and padded to a bucket), and no capture after
    the warmup."""
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline, PipelineOptions
    from image_to_pointcloud_tpu_torch.serve import metrics
    from image_to_pointcloud_tpu_torch.serve.batching import BatchingQueue
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    served = models.get("depth-anything-v2")
    pipe = DepthPipeline(served.model, model_target=served.model_target)
    mm = ModelManager("cuda")
    mm._cache["depth-anything-v2"] = pipe
    srv = _Server(out_dir, mm, max_batch=4, warmup_sizes=[(518, 518)], jpeg_device_decode=True)
    try:
        t0 = time.perf_counter()
        srv.app.warmup()
        warm_s = time.perf_counter() - t0
        keys = sorted((k[0], k[1]) for k in pipe._compiled)
        captures = {f"{k[0]} b{k[1]}": round(fn.capture_s, 4) for k, fn in pipe._compiled.items()}
        pool = pipe.graph_pool_bytes()
        log(f"warmup at max_batch=4: {len(keys)} graphs {keys} in {warm_s:.2f} s, capture s "
            f"{captures}, shared pool {pool / 2**20:.1f} MiB")
        if keys != [(k, b) for k in ("depth", "depth-jpeg") for b in (1, 2, 4)] or not all(
                fn.graph is not None for fn in pipe._compiled.values()):
            raise AssertionError(f"the warmup captured {keys}, not 3 buckets x 2 ingests")
        drains: list[int] = []
        submit = pipe.submit_batch
        pipe.submit_batch = lambda imgs, **kw: drains.append(len(imgs)) or submit(imgs, **kw)

        async def drain_of_three():
            queue = BatchingQueue(pipe, max_batch=4, window_ms=50.0)
            try:
                return await asyncio.gather(*(queue.submit(_frame(518, 518, 30 + i), 15.0,
                                                           PipelineOptions()) for i in range(3)))
            finally:
                await queue.close()

        queued = asyncio.run(drain_of_three())
        log(f"a drain of three queued 518² frames at max_batch=4: submitted as {drains}, "
            f"{len(queued)} results of {[r.kept_point_count for r in queued]} points")
        if drains != [4] or len(queued) != 3 or not all(r.kept_point_count for r in queued):
            raise AssertionError(f"a drain of 3 went out as {drains}, not one bucket of 4")
        drains.clear()
        n0, s0 = (sum(sum(c) for c in metrics.BATCH_SIZE._counts.values()),
                  sum(metrics.BATCH_SIZE._sums.values()))
        results = [None] * 3

        def request(i):
            results[i] = _request(srv.base, _png(518, 518, 30 + i))

        threads = [threading.Thread(target=request, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for lat, st, ply in results:
            _check_ply(ply, st["results"]["pointCloud"]["points"])
        real = (sum(sum(c) for c in metrics.BATCH_SIZE._counts.values()) - n0,
                sum(metrics.BATCH_SIZE._sums.values()) - s0)
        log(f"three concurrent 518² PNG requests at max_batch=4: drains of {drains} "
            f"(bucket sizes), {real[0]} drains holding {real[1]:g} real images; graphs "
            f"after them {len(pipe._compiled)}")
        if any(d not in (1, 2, 4) for d in drains) or len(pipe._compiled) != 6:
            raise AssertionError("a drain left the buckets or a request captured a graph")
    finally:
        srv.stop()
    return {"warmup_s": warm_s, "captures_s": captures, "pool_bytes": pool, "drains": drains}


def phase_graphs(out_dir: str, models, int8_models, f32_models) -> dict:
    """Each served path's graph at full width, 518², buckets 1 and 4, on a
    fresh pipeline over the served model (its own cache and pool): the
    replay against the eager body on the same payload, byte for byte (or
    the fallback rule, logged), the launches of a replay exactly the eager
    forward's (K1 one a layer, K2 and K3 one a batch), the capture's time
    and the pool's size; two batches in flight; a capture beside a replay;
    the warmup at ``max_batch=4``."""
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline

    managers = {"bf16": models, "int8": int8_models, "f32": f32_models}
    out = {}
    for label, name, kind, ingest, k1 in GRAPH_PATHS:
        served = managers[kind].get(name)
        pipe = type("Recording", (_Recorded, DepthPipeline), {})(
            served.model, model_target=served.model_target)
        out[label] = [_graph_vs_eager(label, pipe, *_graph_signature(pipe, ingest, b), k1,
                                      DEPTHNORM_518[name])
                      for b in GRAPH_BUCKETS]
        del pipe  # its graphs and pool
        gc.collect()
        torch.cuda.empty_cache()
    served = models.get("depth-anything-v2")
    _graph_in_flight(DepthPipeline(served.model, model_target=served.model_target))
    out["warmup"] = _graph_warmup(out_dir, models)
    log(f"graph phase numbers: {json.dumps(out, default=str)}")
    return out


# ---------- phase 22: the advanced pipelines' and the matte's graphs ----------


def _on_device(inputs, dev) -> list:
    return [torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a for a in inputs]


def _same(a, b) -> bool:
    """Byte equality of two callables' outputs (tensors or tuples)."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _profiled_ms(fn, iters: int = 3) -> float:
    """Device time of one call: the CUDA kernels' time in a
    ``torch.profiler`` window of ``iters`` calls, per call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / iters


def _in_turns(modes: dict, rounds: int = 3) -> dict:
    """Median wall of each mode's call (synchronized), in turns eager,
    graph, graph, eager: ``2 * rounds`` calls each."""
    walls = {m: [] for m in modes}
    for _ in range(rounds):
        for m in ("eager", "graph", "graph", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            modes[m]()
            torch.cuda.synchronize()
            walls[m].append(time.perf_counter() - t0)
    return {m: statistics.median(w) * 1e3 for m, w in walls.items()}


def _signature_vs_eager(label: str, owner, fn, first: tuple, second: tuple, k1: int, k3: int,
                        varies: bool, dn: int = 0) -> dict:
    """One signature's graph: the capture (timed, the pool's growth), a
    replay against the eager body on the same inputs, byte for byte, and
    at a second value of its traced inputs; the launches of a replay (the
    eager body's, and ``k1``/0/``k3``/``dn``); graph and eager walls in turns and
    their device time a call."""
    dev = owner.device
    pool0 = owner.graph_pool_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*first)  # the capture, then the first replay
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    pool = owner.graph_pool_bytes()
    _reset()
    out = fn(*first)
    torch.cuda.synchronize()
    replay = _counts()
    _reset()
    eout = fn.run(*_on_device(first, dev))
    torch.cuda.synchronize()
    eager = _counts()
    out2, eout2 = fn(*second), fn.run(*_on_device(second, dev))
    torch.cuda.synchronize()
    same, same2, moved = _same(out, eout), _same(out2, eout2), not _same(out, out2)
    expected = {"flash_attention": k1, "grid_knn": 0, "unproject": k3, "depthnorm": dn}
    modes = {"graph": lambda: fn(*first), "eager": lambda: fn.run(*_on_device(first, dev))}
    wall = _in_turns(modes)
    device = {m: _profiled_ms(call) for m, call in modes.items()}
    row = {"capture_s": fn.capture_s, "first_call_s": first_s, "pool_mib": pool / 2**20,
           "pool_growth_mib": (pool - pool0) / 2**20, "launches_replay": replay,
           "launches_eager": eager, "equal": same, "equal_second": same2, "moved": moved,
           "wall_ms": wall, "device_ms": device}
    log(f"graph {label}: bytes equal {same}, at the second value {same2} (output moved "
        f"{moved}); launches a replay {replay}, eager {eager}; capture {fn.capture_s:.3f} s "
        f"(first call {first_s:.3f} s); pool {pool / 2**20:.1f} MiB "
        f"(+{(pool - pool0) / 2**20:.1f}); wall a call graph {wall['graph']:.3f} ms, eager "
        f"{wall['eager']:.3f} ms (6 each, in turns); device a call graph "
        f"{device['graph']:.3f} ms, eager {device['eager']:.3f} ms")
    if not (same and same2 and moved == varies and replay == eager == expected):
        raise AssertionError(f"the {label} graph disagrees with its eager body (launches "
                             f"{replay}, expected {expected}; moved {moved}, expected {varies})")
    return row


def _sum_order_bound(pts: torch.Tensor, cols: torch.Tensor, voxel: float) -> tuple:
    """Per voxel, in the voxel op's order: its point count, and the most by
    which two f32 sums of its points and colours in different orders can
    make the means differ (the bound beside ``VOXEL_RTOL``)."""
    from image_to_pointcloud_tpu_torch.ops.voxel import _lexsort_zyx, voxel_downsample

    _, absmean, _, c = voxel_downsample(pts, torch.cat([pts.abs(), cols.abs()], dim=1), voxel)
    # The op's grid, as it computes it (a device scalar: CUDA divides by a
    # host scalar as a multiplication by its reciprocal).
    p = pts.float()
    v = torch.full((), voxel, dtype=torch.float32, device=p.device)
    idx3 = torch.floor((p - (p.amin(dim=0) - 0.5 * v)) / v).to(torch.int32)
    rows, n = torch.unique(idx3, dim=0, return_counts=True)
    n = n[_lexsort_zyx(rows)].float()
    return n, 2.0 * (n[:, None] - 1.0) * 2.0 ** -24 * absmean[: int(c)]


def _voxel_vs_eager(label: str, pipe, pts: torch.Tensor, cols: torch.Tensor, voxel: float) -> dict:
    """The voxel downsample's graph (keyed by shapes) against the eager op
    on the same cloud: the same count and valid mask, each mean within
    ``VOXEL_RTOL`` relative or within the f32 bound of a sum taken in
    another order (the scatter-add is atomic; :func:`_sum_order_bound`),
    with two eager calls logged beside; walls in turns; then, on a
    high-resolution pipeline, the voxel quantization's graph against its
    eager body, byte for byte."""
    from image_to_pointcloud_tpu_torch.ops.voxel import voxel_downsample
    from image_to_pointcloud_tpu_torch.pipeline import advanced

    t0 = time.perf_counter()
    pipe._voxel_downsample(pts, cols, voxel)  # the capture
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    vp, vc, valid, cnt = pipe._voxel_downsample(pts, cols, voxel)
    ep, ec, evalid, ecnt = voxel_downsample(pts, cols, voxel)
    c = int(ecnt)
    n, order_bound = _sum_order_bound(pts, cols, voxel)
    ulp = 2.0 ** -23

    def errors(a, b, bound):
        """(max relative error, max error over the allowed error)."""
        d = (a[:c] - b[:c]).abs()
        rel = d / b[:c].abs().clamp_min(1e-3)
        allowed = torch.maximum(VOXEL_RTOL * b[:c].abs().clamp_min(1e-3),
                                bound + ulp * b[:c].abs())
        return float(rel.max()), float((d / allowed).max())

    bounds = order_bound[:, :3], order_bound[:, 3:]
    graph_err = [errors(a, b, o) for a, b, o in zip((vp, vc), (ep, ec), bounds)]
    err, ratio = max(e for e, _ in graph_err), max(r for _, r in graph_err)
    e2 = voxel_downsample(pts, cols, voxel)
    eager_err = max(errors(a, b, o)[0] for a, b, o in zip(e2[:2], (ep, ec), bounds))
    qsame = True
    if isinstance(pipe, advanced.HighResPipeline):
        lo, hi = pts.amin(dim=0), pts.amax(dim=0)
        q = [pipe._quantize_voxels(vp, vc, lo, hi) for _ in range(2)][1]  # capture, replay
        qsame = torch.equal(q, advanced._quantize_voxels(vp, vc, lo, hi))
    wall = _in_turns({"graph": lambda: pipe._voxel_downsample(pts, cols, voxel),
                      "eager": lambda: voxel_downsample(pts, cols, voxel)})
    row = {"points": pts.shape[0], "voxels": c, "largest_voxel": int(n.max()),
           "first_call_s": first_s, "max_rel_err": err, "of_allowed": ratio,
           "eager_vs_eager_rel_err": eager_err, "quantize_equal": qsame, "wall_ms": wall}
    log(f"graph {label} voxel downsample of {pts.shape[0]} points at {voxel:.5f}: {int(cnt)}/{c} "
        f"voxels (up to {int(n.max())} points, median {float(n.median()):g}), valid mask equal "
        f"{torch.equal(valid, evalid)}, means within {err:.2e} relative (two eager calls: "
        f"{eager_err:.2e}), {ratio:.3f} of the allowed (VOXEL_RTOL {VOXEL_RTOL:g} or the "
        f"sum-order bound); first call {first_s:.3f} s; wall a call graph {wall['graph']:.3f} ms, "
        f"eager {wall['eager']:.3f} ms; voxel quantization bytes equal {qsame}")
    if not (int(cnt) == c == len(n) > 0 and torch.equal(valid, evalid) and ratio <= 1.0
            and qsame):
        raise AssertionError(f"the {label} voxel graphs disagree with the eager ops")
    return row


def _user_run(label: str, call, k1: int, k3: int, counts: dict, per_run: dict,
              dn: int = 0) -> float:
    """One call of a pipeline's public entry point, read on its own: its
    K1/K2/K3/depthnorm launches (one replay a signature) and wall."""
    _reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    wall = time.perf_counter() - t0
    got = _counts()
    pts = out[0] if isinstance(out, tuple) else out
    log(f"{label}: {wall * 1e3:.1f} ms, launches {got}, output {np.shape(pts)}, finite "
        f"{bool(np.isfinite(pts).all())}")
    if got != {"flash_attention": k1, "grid_knn": 0, "unproject": k3, "depthnorm": dn} or not (
            np.size(pts) and np.isfinite(pts).all()):
        raise AssertionError(f"{label}: launched {got}, expected ({k1}, 0, {k3}, {dn})")
    for name, c in got.items():
        counts[name] = counts.get(name, 0) + c
        per_run.setdefault(name, {})[label] = c
    return wall


def _intrinsics(b: int, second: bool) -> tuple:
    """(fx, fy, cx, cy) of ``b`` 518² frames: a 60° camera at the centre, or
    a 75° one off it."""
    from image_to_pointcloud_tpu_torch.pipeline.advanced import CameraIntrinsics

    cam = CameraIntrinsics.from_fov(518, 518, 75.0 if second else 60.0)
    shift = 20.0 if second else 0.0
    return tuple(np.full((b,), v, np.float32)
                 for v in (cam.fx, cam.fy * (1.05 if second else 1.0), cam.cx + shift, cam.cy - shift))


def _release() -> None:
    """Frees the graphs and pools of the pipelines just dropped."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_advanced_graphs(models) -> tuple[dict, dict, dict]:
    """Each advanced signature at full width, random init, bf16, and the v2
    matte's (f32), through ``_fn`` on a fresh pipeline: the graph against
    its eager body byte for byte, at the captured and at a second depth
    scale, intrinsics or image; launches a replay; capture time and pool;
    walls and device time a call, graph against eager. ``MetricPipeline``
    with ``depth-anything-v2-metric-small`` and ``zoedepth`` on 518² frames
    at batch 1 and 4, both transfers; ``HighResPipeline`` with DA-V2-Small
    on a 1024² frame (tile 518, overlap 128: the anchor and 9 tiles), the
    depth grid and the device path with its voxel downsample to 1 M points;
    ``VideoPipeline`` with DA-V2-Small on 30 518² frames at step 2,
    quantized and fused at voxel 0.05; ``MatteModel`` (SegFormer-B0, 512²).
    Each pipeline's public entry point is then run once, read on its own.
    Returns the rows, and the entry points' launches (totals and per run)."""
    from image_to_pointcloud_tpu_torch.models.segformer import SegformerMatte, segformer_b0
    from image_to_pointcloud_tpu_torch.pipeline import advanced
    from image_to_pointcloud_tpu_torch.serve.matting import MatteModel

    rows: dict = {}
    counts: dict = {}
    per_run: dict = {}
    s1, s2 = np.asarray([15.0], np.float32), np.asarray([4.5], np.float32)
    for name, k1 in (("depth-anything-v2-metric-small", 12), ("zoedepth", 0)):
        model = models.get(name).model
        for quantized in (False, True):
            pipe = advanced.MetricPipeline(model, quantized_transfer=quantized)
            transfer = "quantized" if quantized else "f32"
            for b in (1, 4):
                imgs = np.stack([_frame(518, 518, 60 + i) for i in range(b)])
                label = f"metric {name} b{b} {transfer}"
                rows[label] = _signature_vs_eager(
                    label, pipe, pipe._fn(b, 518, 518, 1), (imgs, *_intrinsics(b, False)),
                    (imgs, *_intrinsics(b, True)), k1, 0, varies=not quantized)
                cams = [advanced.CameraIntrinsics(*(float(v[i]) for v in _intrinsics(b, True)))
                        for i in range(b)]
                rows[label]["run_s"] = _user_run(f"{label} run_batch",
                                                 lambda: pipe.run_batch(imgs, cams)[0], k1, 0,
                                                 counts, per_run)
            del pipe
            _release()

    da = models.get("depth-anything-v2").model
    big = _frame(1024, 1024, 6)
    pipe = advanced.HighResPipeline(da, quantized_transfer=True)
    rows["highres grid"] = _signature_vs_eager("highres 1024² grid", pipe,
                                               pipe._fn(1024, 1024, 1, True), (big, s1), (big, s2),
                                               24, 0, varies=False, dn=1)
    rows["highres grid"]["run_s"] = _user_run("highres 1024² run (depth grid, native voxel)",
                                              lambda: pipe.run(big), 24, 0, counts, per_run, dn=1)
    del pipe
    _release()
    pipe = advanced.HighResPipeline(da, quantized_transfer=False)
    fn = pipe._fn(1024, 1024, 1, False)
    rows["highres device"] = _signature_vs_eager("highres 1024² device", pipe, fn, (big, s1),
                                                 (big, s2), 24, 1, varies=True, dn=1)
    packed, bbox = fn(big, s1)
    lo, hi = bbox.cpu().numpy()
    voxel = (float(np.prod(np.maximum(hi - lo, 1e-6))) / 1_000_000) ** (1.0 / 3.0)
    rows["highres device"]["voxel"] = _voxel_vs_eager("highres 1024² device", pipe,
                                                      packed[:3].T, packed[3:6].T, voxel)
    rows["highres device"]["run_s"] = _user_run(
        "highres 1024² run (device voxel, budget 1M)",
        lambda: pipe.run(big, voxel_budget=1_000_000), 24, 1, counts, per_run, dn=1)
    del pipe, fn, packed, bbox
    _release()

    clip = np.stack([_frame(518, 518, 70 + i) for i in range(30)])
    pipe = advanced.VideoPipeline(da)
    rows["video quantized"] = _signature_vs_eager(
        "video 30x518² quantized", pipe, pipe._fn(30, 518, 518, 2, True), (clip, s1), (clip, s2),
        12, 0, varies=False, dn=1)
    rows["video quantized"]["run_s"] = _user_run("video 30x518² run", lambda: pipe.run(clip),
                                                 12, 0, counts, per_run, dn=1)
    fn = pipe._fn(30, 518, 518, 2)
    rows["video voxel"] = _signature_vs_eager("video 30x518² unfused", pipe, fn, (clip, s1),
                                              (clip, s2), 12, 1, varies=True, dn=1)
    packed = fn(clip, s1)
    pts = packed[:, :3, :].transpose(1, 2).reshape(-1, 3)
    cols = packed[:, 3:6, :].transpose(1, 2).reshape(-1, 3)
    rows["video voxel"]["voxel"] = _voxel_vs_eager("video 30x518²", pipe, pts, cols, 0.05)
    rows["video voxel"]["run_s"] = _user_run("video 30x518² run --voxel 0.05",
                                             lambda: pipe.run(clip, fuse_voxel=0.05), 12, 1,
                                             counts, per_run, dn=1)
    del pipe, fn, packed, pts, cols
    _release()

    torch.manual_seed(0)
    matte = MatteModel(SegformerMatte(segformer_b0(1)).state_dict(), 1, "cuda")
    ims = [_frame(512, 512, 80 + i)[None] for i in range(2)]
    rows["matte"] = _signature_vs_eager("matte SegFormer-B0 512²", matte, matte._fn(1, 512, 512),
                                        (ims[0],), (ims[1],), 0, 0, varies=True)
    rows["matte"]["run_s"] = _user_run("matte alpha 640x480",
                                       lambda: matte.alpha(_frame(480, 640, 82)), 0, 0,
                                       counts, per_run)
    del matte
    _release()
    log(f"advanced graph phase numbers: {json.dumps(rows, default=str)}")
    return rows, counts, per_run


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


# Phase 15's eager-vs-graph paths: (label, model, ModelManager kind, ingest).
TIMED_PATHS = [
    ("DA-V2 PNG", "depth-anything-v2", "bf16", "png"),
    ("DA-V2 JPEG", "depth-anything-v2", "bf16", "jpeg"),
    ("DA-V2 int8", "depth-anything-v2", "int8", "png"),
    ("DA-V2 f32", "depth-anything-v2", "f32", "png"),
    ("dpt-large", "dpt-large", "bf16", "png"),
    ("zoedepth", "zoedepth", "bf16", "png"),
]


def _timed_runs(pipe, ingest: str, batch: int) -> dict:
    """The graph's and the eager forward's submit+collect of ``batch`` 518²
    frames on ``pipe``, as the batcher collects (no packed buffer, gray
    preview)."""
    from image_to_pointcloud_tpu_torch.pipeline.graph import plan_jpeg_input

    kw = {"want_packed": False, "want_preview_rgb": False}
    if ingest == "png":
        imgs = np.stack([_frame(518, 518, 40 + i) for i in range(batch)])
        return {"graph": lambda: pipe.collect(pipe.submit_batch(imgs, depth_scales=15.0), **kw),
                "eager": lambda: pipe.collect(_eager_submit(pipe, imgs), **kw)}
    jpegs = [plan_jpeg_input(_jpeg(518, 518, 40 + i)) for i in range(batch)]
    for j in jpegs:
        j.grid_colors(2)  # the server's planner does this off the drain
    return {"graph": lambda: pipe.collect(pipe.submit_batch_jpeg(jpegs, depth_scales=15.0), **kw),
            "eager": lambda: pipe.collect(_eager_submit_jpeg(pipe, jpegs), **kw)}


def phase_timing(models, int8_models, f32_models, reps: int = 20) -> dict:
    """Submit+collect, host wall time to the collected result, as the
    batcher runs it (no packed buffer, gray preview), in turns: batch 1
    through PNG with the f32 return, PNG with the quantized bundle and
    JPEG with the bundle; then each of ``TIMED_PATHS`` at batch 1 and at
    bucket 4, its graph and its eager forward in turns (eager, graph,
    graph, eager), the median per image. Returns the runs, for the busy
    share measured last (:func:`phase_busy_share`)."""
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
        fn()  # warm-up (the capture)
    for _ in range(reps):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            walls[name].append(time.perf_counter() - t0)
    for name, w in walls.items():
        log(f"batch-1 submit+collect 518x518 {name}: median {statistics.median(w) * 1e3:.2f} ms "
            f"(min {min(w) * 1e3:.2f}, max {max(w) * 1e3:.2f}) over {reps}, in turns")

    managers = {"bf16": models, "int8": int8_models, "f32": f32_models}
    timed: dict = {}
    for label, name, kind, ingest in TIMED_PATHS:
        pipe = managers[kind].get(name)
        for batch in (1, 4):
            modes = _timed_runs(pipe, ingest, batch)
            rounds = max(4, reps // batch // 2)
            per_image = _per_image_in_turns(modes, batch, rounds)
            timed[(label, batch)] = {"runs": modes, "ms_per_image": per_image}
            log(f"submit+collect 518x518 {label} batch {batch}: per image eager "
                f"{per_image['eager']:.3f} ms, graph {per_image['graph']:.3f} ms "
                f"({2 * rounds} each, in turns)")
    return timed


def _per_image_in_turns(modes: dict, batch: int, rounds: int) -> dict:
    """The median wall per image of the ``graph`` and ``eager`` modes of
    one batch, after a warm-up call of each (the graph's capture), in
    ``rounds`` turns of eager, graph, graph, eager."""
    for fn in modes.values():
        fn()
    walls = {"eager": [], "graph": []}
    for _ in range(rounds):
        for mode in ("eager", "graph", "graph", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            modes[mode]()
            walls[mode].append(time.perf_counter() - t0)
    return {m: statistics.median(w) * 1e3 / batch for m, w in walls.items()}


def phase_busy_share(timed: dict, iters: int = 5) -> dict:
    """The device's busy share of phase 15's runs, as
    ``tools/profile_torch_pipeline.py`` measures it: the CUDA kernels'
    time in a ``torch.profiler`` window over ``iters`` runs, over the
    window's wall time, with the kernels a run. Last but /profile, so that
    no profiler session precedes the timings."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for (label, batch), entry in timed.items():
        for mode, fn in entry["runs"].items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                window = time.perf_counter() - t0
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in events) / 1e6
            kernels = sum(e.count for e in events) // iters
            out[f"{label} b{batch} {mode}"] = {"busy_share": busy / window,
                                               "device_ms_per_run": busy * 1e3 / iters,
                                               "kernels_per_run": kernels}
            log(f"busy share 518x518 {label} batch {batch} {mode}: {busy / window:.3f} "
                f"(device {busy * 1e3 / iters:.3f} ms a run, window {window * 1e3:.1f} ms over "
                f"{iters}, {kernels} device ops a run)")
    return out


# The v2 generations that are checked one by one: (form fields). Each is a
# 512² PNG; the first takes the classical matte, the second the remesher.
V2_REQUESTS = [
    {"remove_background": "true", "remesh_option": "none", "seed": "1"},
    {"remove_background": "false", "remesh_option": "triangle", "target_count": "2000",
     "seed": "2"},
]
V2_TIMED = 3  # generations for the p50 and the stage split


def _glb_counts(data: bytes) -> tuple[int, int]:
    """(vertices, faces) of a textured GLB, which must carry the glTF
    magic, its own length, and a JSON chunk with an image, a texture and
    UVs."""
    n = int.from_bytes(data[12:16], "little")
    doc = json.loads(data[20 : 20 + n])
    prim = doc["meshes"][0]["primitives"][0]
    ok = (data[:4] == b"glTF" and int.from_bytes(data[8:12], "little") == len(data)
          and data[16:20] == b"JSON" and doc.get("images") and doc.get("textures")
          and "TEXCOORD_0" in prim["attributes"])
    if not ok:
        raise AssertionError(f"bad GLB: {len(data)} bytes, keys {sorted(doc)}")
    return (doc["accessors"][prim["attributes"]["POSITION"]]["count"],
            doc["accessors"][prim["indices"]]["count"] // 3)


class _StageClock:
    """Wraps a Depth3DProcessor's stages in host clocks: preprocess and
    matte (``_preprocess``), the pipeline (``pipeline.run``: the forward,
    K1-K3 and the bundle's host unpack), the preview (``_preview``); mesh
    and GLB is the rest of ``generate``."""

    def __init__(self, proc):
        self.proc, self.times = proc, []
        self.orig = proc._preprocess, proc.pipeline, proc._preview, proc.generate
        prep, pipe, prev, gen = self.orig
        cur: dict = {}

        def clock(key, fn):
            def run(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    cur[key] = cur.get(key, 0.0) + time.perf_counter() - t0
            return run

        class _Pipe:
            run = staticmethod(clock("pipeline", pipe.run))

        def generate(*a, **k):
            cur.clear()
            out = clock("total", gen)(*a, **k)
            cur["mesh and GLB"] = cur["total"] - sum(
                cur.get(x, 0.0) for x in ("preprocess and matte", "pipeline", "preview"))
            self.times.append(dict(cur))
            return out

        proc._preprocess = clock("preprocess and matte", prep)
        proc.pipeline = _Pipe()
        proc._preview = clock("preview", prev)
        proc.generate = generate

    def restore(self) -> None:
        self.proc._preprocess, self.proc.pipeline, self.proc._preview, self.proc.generate = self.orig


def _v2_generation(base: str, fields: dict, seed: int) -> tuple[float, dict, dict]:
    """POST /process → poll /status → the three downloads, checked: the GLB
    textured with UVs and the metadata's vertex and face counts, the PLY's
    points finite and not flat. Returns (seconds, results, counts)."""
    body, ctype = _multipart(_png(512, 512, seed), "image/png",
                             {"model": "depth3d", "texture_resolution": "1024", **fields})
    t0 = time.perf_counter()
    job = json.loads(_http(f"{base}/process", body, ctype))["job_id"]
    res = _completed(base, job)["results"]
    glb = _http(f"{base}{res['downloadUrl']}")
    ply = _http(f"{base}{res['pointCloudUrl']}")
    meta = json.loads(_http(f"{base}{res['metadataUrl']}"))
    lat = time.perf_counter() - t0
    verts, faces = _glb_counts(glb)
    xyz = _check_ply(ply)
    if (verts, faces) != (meta["vertex_count"], meta["face_count"]) or verts < 1000:
        raise AssertionError(f"v2 GLB has {verts} vertices, {faces} faces; metadata "
                             f"{meta['vertex_count']}, {meta['face_count']}")
    return lat, res, {"vertices": verts, "faces": faces, "points": len(xyz),
                      "glb_bytes": len(glb), "generation_time": meta["generation_time"]}


def phase_v2(out_dir: str, models) -> dict[str, int]:
    """The v2 server on the card at full width (DA-V2-Small, random init):
    each generation read on its own (the launch counters zeroed just before
    and read just after) and held to 12 K1, 1 K2, 1 K3 and 2 depthnorm
    (the 512² conditioning image's preview is not shared); the p50 of the
    timed generations with each stage's median and the metadata's
    ``generation_time``."""
    from image_to_pointcloud_tpu_torch import cuda

    srv = _Server(out_dir, models, v2=True)
    clock = _StageClock(srv.app.processor)
    counts: dict[str, int] = {}
    lats = []
    try:
        fields = V2_REQUESTS + [V2_REQUESTS[0]] * V2_TIMED
        for i, f in enumerate(fields):
            for k in cuda.KERNELS:
                k.reset()
            lat, res, got = _v2_generation(srv.base, f, 20 + i)
            launches = {k.name: k.launches for k in cuda.KERNELS}
            log(f"v2 generation #{i} {f}: {lat * 1e3:.1f} ms to the downloads, {got}, "
                f"launches {launches}, stages {clock.times[-1]}")
            if launches != {"flash_attention": 12, "grid_knn": 1, "unproject": 1, "depthnorm": 2}:
                raise AssertionError(f"v2 generation #{i} launched {launches}")
            for name, c in launches.items():
                counts[name] = counts.get(name, 0) + c
            if i >= len(V2_REQUESTS):
                lats.append((lat, got["generation_time"]))
    finally:
        clock.restore()
        srv.stop()
    timed_stages = clock.times[len(V2_REQUESTS):]
    stages = {k: statistics.median(t[k] for t in timed_stages) * 1e3 for k in timed_stages[0]}
    log(f"v2 p50 over {len(lats)} generations (512² PNG, classical matte, no remesh): "
        f"{statistics.median(x for x, _ in lats) * 1e3:.1f} ms to the downloads, "
        f"generation_time {statistics.median(g for _, g in lats) * 1e3:.1f} ms; stage "
        f"medians (ms) {({k: round(v, 2) for k, v in stages.items()})}")
    return counts


def phase_matte(models) -> dict[str, int]:
    """The learned matte: the port's SegFormer on the golden fixture (an HF
    state dict, its input and the HF logits) on the card, TF32 off, within
    ``SEGFORMER_TOL``; then a random-init full-width SegFormer-B0
    ``MatteModel`` at 512², card against CPU (TF32 off), timed on the card
    as served (torch's TF32 defaults), and inside a ``Depth3DProcessor``
    whose ``generate`` runs on the card (12/1/1/2 launches)."""
    from pathlib import Path

    from image_to_pointcloud_tpu_torch import cuda
    from image_to_pointcloud_tpu_torch.models.convert import convert_segformer
    from image_to_pointcloud_tpu_torch.models.segformer import (
        SegformerConfig,
        SegformerMatte,
        segformer_b0,
    )
    from image_to_pointcloud_tpu_torch.serve.matting import MatteModel
    from image_to_pointcloud_tpu_torch.serve.processor3d import Depth3DProcessor

    z = np.load(Path(__file__).resolve().parent / "tests" / "fixtures" / "golden_segformer.npz")
    sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd/")}
    tiny = SegformerMatte(SegformerConfig(
        hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4),
        sr_ratios=(8, 4, 2, 1), decoder_hidden_size=16, num_labels=1))
    tiny.load_state_dict(convert_segformer(sd), strict=True)
    torch.manual_seed(0)
    b0 = SegformerMatte(segformer_b0(1)).state_dict()  # torch's default init, seeded
    frame = _frame(512, 512, 30)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            golden = tiny.cuda()(torch.from_numpy(z["input"]).cuda()).cpu().numpy()
        err = _max_norm_err(torch.from_numpy(golden.transpose(0, 3, 1, 2)),
                            torch.from_numpy(z["output"]))
        card, cpu = MatteModel(b0, 1, "cuda"), MatteModel(b0, 1, "cpu")
        p_card, p_cpu = card.prob(frame[None]), cpu.prob(frame[None])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    perr = float(np.abs(p_card - p_cpu).max())
    log(f"SegFormer golden fixture on the card: max-normalized error {err:.3e} "
        f"(tol {SEGFORMER_TOL:g}); B0 matte 512² card vs CPU: prob max abs diff {perr:.3e} "
        f"(tol {MATTE_TOL:g}), prob range [{p_card.min():.4f}, {p_card.max():.4f}]")
    if not (err <= SEGFORMER_TOL and perr <= MATTE_TOL):
        raise AssertionError("the SegFormer matte on the card disagrees")

    # The forward's device time is the kernels' sum in a torch.profiler
    # window (as tools/profile_torch_pipeline.py reads it); phase 22 runs
    # the matte's CUDA graph.
    from torch.profiler import ProfilerActivity, profile

    x = (torch.from_numpy(frame[None]).cuda().float() / 255.0 - card._mean) / card._std
    with torch.no_grad():
        ms = cuda_time_ms(lambda: card.model(x), 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                card.model(x)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in events) / 10 / 1e3
    log(f"SegFormer-B0 matte forward 512² on the card: device {dev:.4f} ms (kernel time per "
        f"forward, 10 in a profiler window, {len(events)} kernels), host-inclusive {ms:.4f} ms "
        f"(20 back to back)")
    if not dev > 0:
        raise AssertionError("the profiler saw no device time for the SegFormer forward")

    proc = Depth3DProcessor(models.get("depth-anything-v2"), matte=card)
    for k in cuda.KERNELS:
        k.reset()
    t0 = time.perf_counter()
    out = proc.generate(_frame(512, 512, 31), remove_background=True, seed=0)
    launches = {k.name: k.launches for k in cuda.KERNELS}
    verts, faces = _glb_counts(out["mesh_data"])
    _check_ply(out["point_cloud_data"])
    log(f"Depth3DProcessor with the learned matte on the card: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, {verts} vertices, {faces} faces, "
        f"launches {launches}")
    if launches != {"flash_attention": 12, "grid_knn": 1, "unproject": 1, "depthnorm": 2} or (
            verts, faces) != (out["metadata"]["vertex_count"], out["metadata"]["face_count"]):
        raise AssertionError("the processor with the learned matte on the card misbehaved")
    return launches


# Port state_dict → HF ``DepthAnythingForDepthEstimation`` names: the
# inverse of ``convert_depth_anything`` (Linear, Conv2d, ConvTranspose2d and
# LayerNorm weights share their layout with HF; the patch embedding is
# re-laid below).
_HF_NAMES = [
    (r"^backbone\.cls_token$", "backbone.embeddings.cls_token"),
    (r"^backbone\.pos_embed$", "backbone.embeddings.position_embeddings"),
    (r"^backbone\.patch_embed\.", "backbone.embeddings.patch_embeddings.projection."),
    (r"^backbone\.norm\.", "backbone.layernorm."),
    (r"^backbone\.blocks\.(\d+)\.q\.", r"backbone.encoder.layer.\1.attention.attention.query."),
    (r"^backbone\.blocks\.(\d+)\.k\.", r"backbone.encoder.layer.\1.attention.attention.key."),
    (r"^backbone\.blocks\.(\d+)\.v\.", r"backbone.encoder.layer.\1.attention.attention.value."),
    (r"^backbone\.blocks\.(\d+)\.proj\.", r"backbone.encoder.layer.\1.attention.output.dense."),
    (r"^backbone\.blocks\.(\d+)\.ls(\d)$", r"backbone.encoder.layer.\1.layer_scale\2.lambda1"),
    (r"^backbone\.blocks\.(\d+)\.", r"backbone.encoder.layer.\1."),
    (r"^neck\.proj(\d)\.", r"neck.reassemble_stage.layers.\1.projection."),
    (r"^neck\.up(\d)\.", r"neck.reassemble_stage.layers.\1.resize."),
    (r"^neck\.down3\.", "neck.reassemble_stage.layers.3.resize."),
    (r"^neck\.conv(\d)\.", r"neck.convs.\1."),
    (r"^neck\.fusion(\d)\.projection\.", r"neck.fusion_stage.layers.\1.projection."),
    (r"^neck\.fusion(\d)\.res(\d)\.conv(\d)\.",
     r"neck.fusion_stage.layers.\1.residual_layer\2.convolution\3."),
    (r"^neck\.head_conv(\d)\.", r"head.conv\1."),
]


def hf_depth_anything(sd: dict, patch: int = 14) -> dict:
    """A Depth-Anything state_dict of the port in HF's layout."""
    import re

    out = {}
    for name, t in sd.items():
        hf = next(re.sub(p, r, name) for p, r in _HF_NAMES if re.search(p, name))
        if name == "backbone.patch_embed.weight":  # (D, p·p·3), (row, col, ch) → (D, 3, p, p)
            t = t.reshape(t.shape[0], patch, patch, 3).permute(0, 3, 1, 2)
        out[hf] = t.contiguous()
    return out


def write_safetensors(path, tensors: dict) -> None:
    """f32 tensors → a ``.safetensors`` file (8-byte header length, the JSON
    header, the raw little-endian buffers)."""
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        b = t.detach().float().cpu().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    path.write_bytes(len(h).to_bytes(8, "little") + h + b"".join(blobs))


TRAIN_MODEL = "depth-anything-v2-metric-small"


def _step_clock(store: list):
    """Trainer.train_step wrapped in a host clock (the loss's ``float``
    synchronizes); keeps each step's (trainer, seconds, loss)."""
    from image_to_pointcloud_tpu_torch.train.trainer import Trainer

    real = Trainer.train_step

    def step(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(real(self, *a, **k))
        store.append((self, time.perf_counter() - t0, loss))
        return torch.tensor(loss)

    Trainer.train_step = step
    return lambda: setattr(Trainer, "train_step", real)


def _trainer_card_vs_cpu() -> None:
    """One step of a tiny metric DA-V2 (64-wide heads) on the card (its
    CUDA graph) and on the CPU from the same weights and batch, f32, TF32
    off: the loss within
    1e-4 relative, each gradient within ``TRAIN_GRAD_TOL`` of its tensor's
    max |g| (the keys' biases, zero in exact arithmetic, to 1e-6 of the
    model's), and
    each parameter within 1e-3·lr plus what the gradient difference carries
    through Adam's first step (tests/test_torch_train.py's bound)."""
    from image_to_pointcloud_tpu_torch.models.depth_anything import (
        DepthAnythingConfig,
        build_model,
        init_weights,
    )
    from image_to_pointcloud_tpu_torch.models.dinov2 import DinoV2Config
    from image_to_pointcloud_tpu_torch.models.dpt import DPTConfig
    from image_to_pointcloud_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = DepthAnythingConfig(
        backbone=DinoV2Config(hidden_size=128, num_layers=2, num_heads=2, out_layers=(0, 1, 1, 1)),
        neck=DPTConfig(hidden_size=128, neck_hidden_sizes=(32, 64, 128, 128),
                       fusion_hidden_size=32, metric_depth=True, max_depth=2.0))
    sd = init_weights(build_model(cfg), torch.Generator().manual_seed(0)).state_dict()
    r = np.random.default_rng(0)
    x = r.normal(0, 1, (2, 112, 112, 3)).astype(np.float32)
    y = (r.random((2, 112, 112)) + 0.5).astype(np.float32)
    # lr as tests/test_torch_train.py: 1e-3·lr must stay well above one
    # f32 spacing of a parameter near 1 (the LayerScales), 1.2e-7.
    lr, eps = 1e-3, 1e-8
    tcfg = TrainConfig(learning_rate=lr, loss="silog")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        card, cpu = Trainer(cfg, sd, "cuda", tcfg), Trainer(cfg, sd, "cpu", tcfg)
        lc, lg = float(cpu.train_step(x, y)), float(card.train_step(x, y))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    # The card's step is its signature's CUDA graph (captured, then replayed).
    if not (card.cuda_graphs and all(fn.graph is not None for fn in card._compiled.values())
            and len(card._compiled) == 1):
        raise AssertionError("the card's trainer step did not run its CUDA graph")
    ref = dict(cpu.model.named_parameters())
    gmax = max(float(p.grad.abs().max()) for p in ref.values())
    worst_g = worst_p = 0.0
    bad = []
    for name, p in card.model.named_parameters():
        g, rg = p.grad.cpu(), ref[name].grad
        if name.endswith(".k.bias"):
            eg = max(float(g.abs().max()), float(rg.abs().max())) / (1e-6 * gmax)
        else:
            eg = float((g - rg).abs().max()) / (TRAIN_GRAD_TOL * float(rg.abs().max()))
        m = torch.where(g * rg > 0, torch.minimum(g.abs(), rg.abs()), 0.0)
        bound = 1e-3 * lr + lr * (g - rg).abs() * eps / (m + eps) ** 2
        ep = float(((p.detach().cpu() - ref[name].detach()).abs() / bound).max())
        worst_g, worst_p = max(worst_g, eg), max(worst_p, ep)
        if eg > 1 or ep > 1:
            bad.append(name)
    log(f"trainer step card vs CPU (tiny metric DA-V2, TF32 off): loss {lg:.6f} / {lc:.6f}, "
        f"worst gradient error {worst_g:.3f} of its bound, worst parameter error "
        f"{worst_p:.3f} of its bound")
    if abs(lg - lc) > 1e-4 * abs(lc) or bad:
        raise AssertionError(f"the trainer step on the card disagrees with the CPU: {bad[:5]}")


# The full-width trainer's graph against its eager body: steps of each
# (one batch, in turns), and the profiler window's steps.
TRAIN_GRAPH_STEPS, TRAIN_PROFILED_STEPS = 8, 3


def _profiled_steps(step, n: int = TRAIN_PROFILED_STEPS) -> dict:
    """``n`` calls of ``step`` in a profiler window: the device time a
    step, the busy share (device time over the window's wall), kernels a
    step, and the ten device ops of most time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = [e for e in pr.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    return {"device_ms": busy * 1e3 / n, "busy_share": busy / window,
            "kernels": sum(e.count for e in events) // n, "window_ms": window * 1e3,
            "top_ms": {e.key[:80]: e.self_device_time_total / 1e3 / n for e in top}}


def _train_graph_vs_eager() -> dict:
    """``depth-anything-v2-metric-small`` at full width (518², batch 2, f32,
    remat, one slot), a graph trainer and an eager one (its callable runs
    the body) from one weight set and one batch, at lr 1e-3 (so that
    1e-3·lr stays above one f32 spacing of a parameter near 1). Step 1:
    the graph's loss bit for bit eager's; every parameter within the larger
    of the spread of two eager steps from the same state (the second one
    undone by ``_warm_up``) and Adam's first-step bound on the gradient
    difference, 1e-3·lr plus lr·|δg|·eps/(m + eps)² (tests/test_torch_
    train.py's). Then ``TRAIN_GRAPH_STEPS`` steps of each in turns (eager,
    graph, graph, eager), the median wall; device time a step, busy share
    and kernels a step in a profiler window of ``TRAIN_PROFILED_STEPS``;
    capture seconds, pool MiB, peak memory of a graph and of an eager
    step; the hand kernels a replay launches (none: plain attention); each
    trainer's Adam step count equal to its calls. ``depth_metrics`` on the
    card: its graph against its eager body bit for bit, with and without a
    mask."""
    from image_to_pointcloud_tpu_torch.models.depth_anything import build_model, init_weights, preset
    from image_to_pointcloud_tpu_torch.train import eval as teval
    from image_to_pointcloud_tpu_torch.train.trainer import TrainConfig, Trainer

    lr, eps = 1e-3, 1e-8
    sd = init_weights(build_model(preset(TRAIN_MODEL)), torch.Generator().manual_seed(0)).state_dict()
    r = np.random.default_rng(11)
    x = torch.from_numpy(r.normal(0, 1, (2, 518, 518, 3)).astype(np.float32)).cuda()
    y = torch.from_numpy((r.random((2, 518, 518)) + 0.5).astype(np.float32)).cuda()
    tcfg = TrainConfig(learning_rate=lr, loss="silog")
    graph = Trainer(preset(TRAIN_MODEL), sd, "cuda", tcfg)
    eager = Trainer(preset(TRAIN_MODEL), sd, "cuda", tcfg)
    eager.cuda_graphs = False
    calls = {"graph": 0, "eager": 0}
    trainers = {"graph": graph, "eager": eager}

    def step(mode: str) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(trainers[mode].train_step(x, y))
        calls[mode] += 1
        return time.perf_counter() - t0

    with eager._warm_up():  # a second eager step from the same state, undone
        eager.train_step(x, y)
        second = {n: p.detach().clone() for n, p in eager.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    le = eager.train_step(x, y)
    calls["eager"] += 1
    torch.cuda.synchronize()
    peak_eager = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    _reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg = graph.train_step(x, y)  # the capture, then the first replay
    calls["graph"] += 1
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak_graph = torch.cuda.max_memory_allocated() / 2**30
    replay = _counts()
    (fn,) = graph._compiled.values()
    pool = graph.graph_pool_bytes() / 2**20

    ref = dict(eager.model.named_parameters())
    worst, spread, gap = 0.0, 0.0, 0.0
    for name, p in graph.model.named_parameters():
        q = ref[name]
        g, rg = p.grad, q.grad
        m = torch.where(g * rg > 0, torch.minimum(g.abs(), rg.abs()), 0.0)
        adam = 1e-3 * lr + lr * (g - rg).abs() * eps / (m + eps) ** 2
        err = (p - q).abs().detach()
        eager_gap = (second[name] - q).abs().detach()
        worst = max(worst, float((err / torch.maximum(eager_gap, adam)).max()))
        spread, gap = max(spread, float(eager_gap.max())), max(gap, float(err.max()))
    loss_equal = torch.equal(lg, le)

    walls = {"graph": [], "eager": []}
    for _ in range(TRAIN_GRAPH_STEPS // 2):
        for mode in ("eager", "graph", "graph", "eager"):
            walls[mode].append(step(mode))
    prof = {}
    for mode in ("eager", "graph"):
        prof[mode] = _profiled_steps(lambda: trainers[mode].train_step(x, y))
        calls[mode] += TRAIN_PROFILED_STEPS
    counts = {mode: {float(st["step"]) for st in tr.opt.state.values()}
              for mode, tr in trainers.items()}
    wall = {m: statistics.median(w) * 1e3 for m, w in walls.items()}

    metrics_equal = []
    for masked in (False, True):
        pred = graph.predict(x[:1])
        tgt = y[:1] * 3.0
        mask = tgt > 1.6 if masked else None
        got, body = teval.depth_metrics(pred, tgt, mask), teval._metrics(pred, tgt, mask)
        metrics_equal.append(all(torch.equal(got[k], body[k]) for k in body))
    metric_graphs = sum(f.graph is not None for f in teval._owner(graph.device)._compiled.values())

    row = {"loss_equal": loss_equal, "step1_worst": worst, "eager_spread": spread,
           "graph_gap": gap, "wall_ms": wall, "first_call_s": first_s,
           "capture_s": fn.capture_s, "pool_mib": pool, "peak_gib_graph": peak_graph,
           "peak_gib_eager": peak_eager, "launches_replay": replay, "profile": prof,
           "adam_steps": {m: sorted(c) for m, c in counts.items()}, "calls": calls,
           "metrics_equal": metrics_equal}
    log(f"train graph vs eager {TRAIN_MODEL} 518² batch 2 f32 remat (one slot), lr {lr:g}: "
        f"step 1 loss graph {float(lg)!r} eager {float(le)!r} bit for bit {loss_equal}; "
        f"parameters after step 1: graph vs eager max {gap:.3e}, two eager steps max "
        f"{spread:.3e}, worst {worst:.3f} of the rule; step wall median graph "
        f"{wall['graph']:.3f} ms, eager {wall['eager']:.3f} ms ({TRAIN_GRAPH_STEPS} each, in "
        f"turns); device a step graph {prof['graph']['device_ms']:.3f} ms, eager "
        f"{prof['eager']['device_ms']:.3f} ms; busy share graph "
        f"{prof['graph']['busy_share']:.3f}, eager {prof['eager']['busy_share']:.3f} "
        f"(window of {TRAIN_PROFILED_STEPS}); kernels a step graph {prof['graph']['kernels']}, "
        f"eager {prof['eager']['kernels']}; capture {fn.capture_s:.3f} s (first call "
        f"{first_s:.3f} s); pool {pool:.1f} MiB; peak memory over the first graph call "
        f"{peak_graph:.3f} GiB, over an eager step {peak_eager:.3f} GiB; hand-kernel launches "
        f"a replay {replay}; Adam step counts {row['adam_steps']} after {calls} calls; "
        f"depth_metrics graph vs eager bit for bit (no mask, mask) {metrics_equal}, "
        f"{metric_graphs} graphs")
    log(f"train graph step, the ten device ops of most time (ms a step): "
        f"{json.dumps(prof['graph']['top_ms'])}")
    if not (loss_equal and worst <= 1 and all(counts[m] == {float(calls[m])} for m in calls)
            and not any(replay.values()) and all(metrics_equal) and metric_graphs == 2
            and graph.cuda_graphs and len(graph._compiled) == 1):
        raise AssertionError("the trainer's graph disagrees with its eager body")
    return row


def phase_train(out_dir: str, models) -> dict:
    """Fine-tuning on the card: the CLI's ``train`` on
    ``depth-anything-v2-metric-small`` at full width (518², batch 2, f32,
    remat) for 3 steps, each step timed, peak memory read; the loss finite,
    every q/k/v weight with a nonzero gradient, and no K1 launch (the
    trainer's model runs the plain attention). Its checkpoint then serves a
    v1 request through ``IPC_TPU_CHECKPOINT_DIR``, whose depth differs from
    the random init's; a tiny trainer step card vs CPU; the full-width
    step's graph against its eager body (:func:`_train_graph_vs_eager`);
    ``convert-ckpt`` on an HF-layout safetensors written from a random
    state_dict, round trip bit for bit."""
    import os
    import re
    from pathlib import Path

    from image_to_pointcloud_tpu_torch import cli, cuda
    from image_to_pointcloud_tpu_torch.models.depth_anything import build_model, init_weights, preset
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager
    from image_to_pointcloud_tpu_torch.train.checkpoint import restore_params

    root = Path(out_dir) / "ckpts"
    steps: list = []
    undo = _step_clock(steps)
    for k in cuda.KERNELS:
        k.reset()
    torch.cuda.reset_peak_memory_stats()
    try:
        # The JAX TrainConfig's fine-tuning rate: the CLI's default, 1e-4,
        # left a spatially constant map after 3 steps (all served z equal).
        rc = cli.main(["train", "--model", TRAIN_MODEL, "--steps", "3", "--batch-size", "2",
                       "--image-size", "518", "--learning-rate", "5e-6",
                       "-o", str(root / TRAIN_MODEL / "torch")])
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k.name: k.launches for k in cuda.KERNELS}
    trainer = steps[-1][0]
    qkv = {n: float(p.grad.abs().max()) for n, p in trainer.model.named_parameters()
           if re.fullmatch(r"backbone\.blocks\.\d+\.[qkv]\.weight", n)}
    times = [t for _, t, _ in steps]
    losses = [loss for _, _, loss in steps]
    log(f"train {TRAIN_MODEL} 518² batch 2 f32 remat on the card: rc {rc}, losses {losses}, "
        f"step times (ms) {[round(t * 1e3, 2) for t in times]} (median of steps 2-3 "
        f"{statistics.median(times[1:]) * 1e3:.2f}), peak memory {peak:.3f} GiB, launches "
        f"{launches}, {len(qkv)} q/k/v weights, least max |grad| {min(qkv.values()):.3e}")
    if not (rc == 0 and len(steps) == 3 and np.isfinite(losses).all() and len(qkv) == 36
            and min(qkv.values()) > 0 and not any(launches.values())):
        raise AssertionError("the fine-tuning run on the card failed its checks")
    del trainer, steps

    saved = restore_params(root / TRAIN_MODEL / "torch")
    init = init_weights(build_model(preset(TRAIN_MODEL)), torch.Generator().manual_seed(0))
    if all(torch.equal(v, init.state_dict()[k]) for k, v in saved.items()):
        raise AssertionError("the fine-tuned checkpoint equals the random init")
    # The fine-tuned checkpoint served through IPC_TPU_CHECKPOINT_DIR, one
    # v1 request read on its own; the random init serves the same frame.
    os.environ["IPC_TPU_CHECKPOINT_DIR"] = str(root)
    try:
        tuned = ModelManager("cuda")
    finally:
        del os.environ["IPC_TPU_CHECKPOINT_DIR"]
    frame = _png(518, 518, 40)
    srv, srv_init = _Server(out_dir, tuned), _Server(out_dir, models)
    try:
        for k in cuda.KERNELS:
            k.reset()
        lat, st, ply = _request(srv.base, frame, model=TRAIN_MODEL)
        served = {k.name: k.launches for k in cuda.KERNELS}
        _, _, ply_init = _request(srv_init.base, frame, model=TRAIN_MODEL)
    finally:
        srv.stop()
        srv_init.stop()
    z, z_init = _check_ply(ply)[:, 2], _check_ply(ply_init)[:, 2]
    differs = len(z) != len(z_init) or not np.array_equal(z, z_init)
    log(f"the fine-tuned checkpoint served (v1, {TRAIN_MODEL}): {lat * 1e3:.1f} ms, "
        f"{len(z)} points, {len(np.unique(z))} distinct z in [{z.min():.4g}, {z.max():.4g}] "
        f"(random init: {len(z_init)} points, {len(np.unique(z_init))} distinct z in "
        f"[{z_init.min():.4g}, {z_init.max():.4g}]), differs {differs}, launches {served}")
    if tuned.random_weights.get(TRAIN_MODEL) is not False or not differs or served != {
            "flash_attention": 12, "grid_knn": 1, "unproject": 1,
            "depthnorm": DEPTHNORM_518[TRAIN_MODEL]}:
        raise AssertionError("the fine-tuned checkpoint was not served")

    _trainer_card_vs_cpu()
    graph_row = _train_graph_vs_eager()
    _release()

    # convert-ckpt: an HF-layout safetensors written from a random
    # state_dict comes back bit for bit.
    sd = init_weights(build_model(preset("depth-anything-v2")),
                      torch.Generator().manual_seed(1)).state_dict()
    src = Path(out_dir) / "hf" / "model.safetensors"
    src.parent.mkdir()
    write_safetensors(src, hf_depth_anything(sd))
    rc = cli.main(["convert-ckpt", str(src.parent), "--model", "depth-anything-v2",
                   "-o", str(Path(out_dir) / "converted")])
    got = restore_params(Path(out_dir) / "converted" / "depth-anything-v2" / "torch")
    same = rc == 0 and set(got) == set(sd) and all(torch.equal(got[k], v) for k, v in sd.items())
    log(f"convert-ckpt depth-anything-v2 from HF safetensors: rc {rc}, {len(got)} tensors, "
        f"round trip bit for bit {same}")
    if not same:
        raise AssertionError("convert-ckpt did not give back the state_dict")
    return {"served": served, "step_ms": [t * 1e3 for t in times], "peak_gib": peak,
            "graph": graph_row}


# ---------- the mesh phase: parallel/ on one card, every slot cuda:0 ----------

# The depth normalization, TP mesh against the unsharded forward on the
# card (bf16), max abs over the normalized [0, 1] map: about twice the
# largest gap measured (0.030 DA-V2, 0.025 dpt-large on an H100 80GB
# HBM3 at 700 W), as FULL_WIDTH_TOL is set; each row-parallel partial is
# rounded to bf16 once more than the unsharded product.
MESH_NORM_TOL = 0.06
# Sequence and ring attention in bf16 against the plain attention in f32:
# K1's bound (the probabilities rounded to bf16 before P·V).
SEQ_ATTN_TOL = K1_TOL[torch.bfloat16]
# The meshed trainer's update over three steps at lr 5e-6 against the
# one device's, relative L2 over every parameter: about twice the gap
# measured (8.94e-3 on an H100 80GB HBM3 at 700 W). A trainer that drops
# one data slot's gradient, or resets Adam's moments, fails it by far.
MESH_TRAIN_UPDATE_TOL = 0.02


def _slots(n: int) -> list:
    return [torch.device("cuda", 0)] * n


def _counts() -> dict[str, int]:
    from image_to_pointcloud_tpu_torch import cuda

    return {k.name: k.launches for k in cuda.KERNELS}


def _reset() -> None:
    from image_to_pointcloud_tpu_torch import cuda

    for k in cuda.KERNELS:
        k.reset()


def _raw_run(pipe, frames: list, depth_scale: float = 15.0):
    """``pipe.run_batch(frames)``, eagerly, with each data slot's raw model
    output kept (f32): (raw depth of the whole batch, padding rows
    included; the results)."""
    caps = []
    slots = pipe._slots

    def keep(fwd):
        def run(x):
            out = fwd(x)
            caps.append(out.float())
            return out
        return run

    pipe._slots = [(dev, keep(fwd)) for dev, fwd in slots]
    try:
        res = pipe.collect(_eager_submit(pipe, np.stack(frames), depth_scale))
    finally:
        pipe._slots = slots
    return torch.cat([c.to(caps[0].device) for c in caps]), res


def _host_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _mesh_graph(label: str, pipe, frames: list, expected: dict) -> dict:
    """One meshed signature as CUDA graphs (one a data slot, on its
    device; the batch padded to the data slots): the capture of every
    slot's graph (timed; the pool after), a replay against the signature's
    eager body (``fn.run``: every data slot, then the gather) on the same
    payload, byte for byte, the launches of a replay equal to the eager
    body's and to ``expected``, and the wall of a call, graph and eager,
    in turns (6 each)."""
    from image_to_pointcloud_tpu_torch.pipeline.graph import PipelineOptions

    imgs = np.stack(frames)
    pad = pipe._data_pad(len(imgs))
    if pad:
        imgs = np.concatenate([imgs, imgs[-1:].repeat(pad, 0)])
    payload = pipe.pack_payload(imgs, np.full((len(imgs),), 15.0, np.float32))
    fn = pipe.compiled_graph(len(imgs), imgs.shape[1:3], PipelineOptions(), True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(payload)  # every data slot's capture, then a replay
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _reset()
    out, prev = fn(payload)
    torch.cuda.synchronize()
    replay = _counts()
    _reset()
    eout, eprev = fn.run(torch.from_numpy(payload))
    torch.cuda.synchronize()
    eager = _counts()
    same = torch.equal(out, eout) and torch.equal(prev, eprev)
    parts = getattr(fn, "slots", [fn])  # a meshed signature's graph of each data slot
    wall = _in_turns({"graph": lambda: fn(payload),
                      "eager": lambda: fn.run(torch.from_numpy(payload))})
    row = {"batch": len(imgs), "graphs": len(parts), "capture_s": fn.capture_s,
           "first_call_s": first_s, "pool_mib": pipe.graph_pool_bytes() / 2**20,
           "launches_replay": replay, "launches_eager": eager, "equal": same, "wall_ms": wall}
    log(f"mesh graph {label} batch {len(imgs)}: {len(parts)} graph(s), one a data slot; replay "
        f"vs eager body bytes equal {same}; launches a replay {replay}, eager {eager}; capture "
        f"{fn.capture_s:.3f} s (first call {first_s:.3f} s); pool {row['pool_mib']:.1f} MiB; wall "
        f"a call graph {wall['graph']:.3f} ms, eager {wall['eager']:.3f} ms (6 each, in turns)")
    if not (pipe.cuda_graphs and same and replay == eager == expected
            and all(part.graph is not None for part in parts)):
        raise AssertionError(f"the meshed graph {label} disagrees with its eager body "
                             f"(launches {replay}, expected {expected})")
    return row


def _mesh_tp(models, name: str, k1_blocks: int) -> dict:
    """One 518² frame through the served DepthPipeline on (data=1,
    model=2) against the unsharded one, same weights: the raw output
    within FULL_WIDTH_TOL max-normalized, the normalized depth's gap,
    exact launches (K1: blocks × 2 slots), host wall of a request each."""
    from image_to_pointcloud_tpu_torch.ops.depthnorm import normalize_depth
    from image_to_pointcloud_tpu_torch.parallel.sharding import make_mesh
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline

    plain = models.get(name)
    tp = DepthPipeline(plain.model, model_target=plain.model_target,
                       mesh=make_mesh(data=1, model=2, devices=_slots(2)))
    frame = _frame(518, 518, 5)
    raw_plain, res_plain = _raw_run(plain, [frame])
    _reset()
    raw_tp, res_tp = _raw_run(tp, [frame])
    counts = _counts()
    expected = {"flash_attention": 2 * k1_blocks, "grid_knn": 1, "unproject": 1,
                "depthnorm": DEPTHNORM_518[name]}
    graph = _mesh_graph(f"TP {name} (data=1, model=2)", tp, [frame], expected)
    err = _max_norm_err(raw_tp, raw_plain)
    gap = float((normalize_depth(raw_tp[0]) - normalize_depth(raw_plain[0])).abs().max())
    xyz = res_tp[0].points
    ms_plain = _host_ms(lambda: plain.run(frame))
    ms_tp = _host_ms(lambda: tp.run(frame))
    heads = tp.cfg.backbone.num_heads // 2
    log(f"mesh TP {name} (data=1, model=2, {heads} heads a slot): raw output max-normalized "
        f"error vs unsharded {err:.5f} (tol {FULL_WIDTH_TOL:g}); normalized depth max gap "
        f"{gap:.5f} (tol {MESH_NORM_TOL:g}); points {len(xyz)} (unsharded "
        f"{len(res_plain[0].points)}), {len(np.unique(xyz[:, 2]))} distinct z; launches "
        f"(eager) {counts}; host wall a request (graphs): TP {ms_tp:.2f} ms, unsharded "
        f"{ms_plain:.2f} ms")
    if not (err <= FULL_WIDTH_TOL and gap <= MESH_NORM_TOL and counts == expected
            and len(np.unique(xyz[:, 2])) > 1):
        raise AssertionError(f"the TP mesh path of {name} failed (expected launches {expected})")
    return {"err": err, "gap": gap, "launches": graph["launches_replay"], "ms": ms_tp,
            "plain_ms": ms_plain, "graph": graph}


def _mesh_k1_tp_times() -> dict:
    """K1 at the TP slots' shapes (the heads of one slot at model=2)
    beside the full-head ones: each held against the plain attention in
    f32 at K1's bf16 tolerance, then its device time."""
    from image_to_pointcloud_tpu_torch.models.attention import attention_plain, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(1)
    out, errs = {}, {}
    for shape in [(1, 6, 1370, 64), (1, 3, 1370, 64), (1, 16, 577, 64), (1, 8, 577, 64)]:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
        o = flash_attention(q, k, v)
        ref = attention_plain(q.float(), k.float(), v.float(), 1.0 / 8.0)
        errs[str(shape)] = float((o.float() - ref).abs().max())
        out[str(shape)] = device_time_ms(lambda: flash_attention(q, k, v))
    log(f"mesh K1 at full-head and TP-slot shapes, bf16: max abs error vs plain f32 {errs} "
        f"(tol {K1_TOL[torch.bfloat16]:g}); device time (ms) {out}")
    bad = [k for k, e in errs.items() if not e <= K1_TOL[torch.bfloat16]]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version at the TP shapes {bad}")
    return {"ms": out, "max_abs_err": errs}


def _mesh_int8(int8_models) -> dict:
    """One row-parallel QuantLinear (DA-V2's fc2, 1536 → 384, 1370 tokens)
    over two slots, and the int8 DA-V2 encoder at model=2, each against
    the unsharded int8 on the card, bit for bit; then the served int8
    DA-V2 through a (data=1, model=2) pipeline as its graph
    (:func:`_mesh_graph`), whose replay must equal the unsharded int8
    pipeline's replay on the same payload, byte for byte."""
    from image_to_pointcloud_tpu_torch.models.quantize import QuantLinear, quantize_dense_params
    from image_to_pointcloud_tpu_torch.parallel.sharding import (
        MeshedModel,
        make_mesh,
        row_parallel,
        shard_params,
    )
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline, PipelineOptions

    gen = torch.Generator().manual_seed(3)
    full = QuantLinear(1536, 384)
    full.load_state_dict(quantize_dense_params(torch.randn(384, 1536, generator=gen) * 0.03,
                                               torch.randn(384, generator=gen) * 0.1))
    full = full.cuda()
    x = torch.randn(1, 1370, 1536, generator=gen).cuda().bfloat16()
    mesh = make_mesh(data=1, model=2, devices=_slots(2))
    placed = shard_params({f"blocks.0.mlp.fc2.{k}": v for k, v in full.state_dict().items()}, mesh)
    halves = []
    for m in range(2):
        lay = QuantLinear(768, 384).cuda()
        lay.load_state_dict({k.rsplit(".", 1)[1]: s.slot(model=m) for k, s in placed.items()})
        halves.append(lay)
    with torch.inference_mode():
        same_lin = torch.equal(row_parallel(halves, list(x.chunk(2, dim=-1))), full(x))
        model = int8_models.get("depth-anything-v2").model
        px = torch.randn(1, 518, 518, 3, generator=gen).cuda()
        same_enc = torch.equal(MeshedModel(model, mesh)(px), model(px))
    served = int8_models.get("depth-anything-v2")
    tp = DepthPipeline(served.model, model_target=served.model_target, mesh=mesh)
    frame = _frame(518, 518, 6)
    graph = _mesh_graph("int8 TP DA-V2 (data=1, model=2)", tp, [frame],
                        {"flash_attention": 24, "grid_knn": 1, "unproject": 1, "depthnorm": 1})
    payload = tp.pack_payload(frame[None], np.full((1,), 15.0, np.float32))
    opts = PipelineOptions()
    got = tp.compiled_graph(1, (518, 518), opts, True)(payload)
    ref = served.compiled_graph(1, (518, 518), opts, True)(payload)
    same_pipe = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    log(f"mesh int8 TP: row-parallel QuantLinear (1, 1370, 1536) -> 384 over 2 slots bit for bit "
        f"{same_lin}; int8 DA-V2-Small encoder at model=2 bit for bit {same_enc}; the int8 TP "
        f"pipeline's replay vs the unsharded int8 pipeline's, bytes equal {same_pipe}")
    if not (same_lin and same_enc and same_pipe):
        raise AssertionError("the int8 TP path differs from the unsharded int8 on the card")
    return graph


def _mesh_dp(models) -> dict:
    """(data=2): a batch of 1 (padded) and of 3 (padded to 4), each data
    slot's rows held against the unmeshed pipeline on the same rows (the
    batch's shape sets cuBLAS's rounding): equal kept counts, points within
    2e-4. K2 and K3 run once per data slot."""
    from image_to_pointcloud_tpu_torch.parallel.sharding import make_mesh
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline

    plain = models.get("depth-anything-v2")
    dp = DepthPipeline(plain.model, model_target=plain.model_target,
                       mesh=make_mesh(data=2, devices=_slots(2)))
    frames = [_frame(518, 518, 20 + i) for i in range(3)]
    worst, out, graphs = 0.0, {}, {}
    for n, groups in [(1, [[0]]), (3, [[0, 1], [2, 2]])]:
        graphs[n] = _mesh_graph(f"DP DA-V2 (data=2) of {n}", dp, frames[:n],
                                {"flash_attention": 24, "grid_knn": 2, "unproject": 2,
                                 "depthnorm": 2})
        _reset()
        got = dp.run_batch(np.stack(frames[:n]), depth_scales=15.0)
        counts = _counts()
        ref = [r for g in groups for r in plain.run_batch(np.stack([frames[i] for i in g]),
                                                          depth_scales=15.0)][:n]
        for a, b in zip(ref, got):
            if a.kept_point_count != b.kept_point_count:
                raise AssertionError(f"DP kept {b.kept_point_count}, unmeshed {a.kept_point_count}")
            worst = max(worst, float(np.abs(a.points - b.points).max()))
        out[n] = counts
        log(f"mesh DP (data=2) batch {n}: {len(got)} results, launches {counts}")
        if counts != {"flash_attention": 24, "grid_knn": 2, "unproject": 2, "depthnorm": 2}:
            raise AssertionError(f"the DP path launched {counts}")
    ms_dp = _host_ms(lambda: dp.run(frames[0]))
    ms_plain = _host_ms(lambda: plain.run(frames[0]))
    log(f"mesh DP: worst point difference {worst:.3e} (tol 2e-4); host wall of a lone request "
        f"(graphs) DP=2 {ms_dp:.2f} ms, unmeshed {ms_plain:.2f} ms")
    if worst > 2e-4:
        raise AssertionError("the DP path's points differ from the unmeshed ones")
    return {"launches": out, "ms": ms_dp, "plain_ms": ms_plain, "worst": worst,
            "graph": graphs}


def _mesh_gpipe(models) -> dict:
    """pipe=4, M=4, batch 4 through the served DepthPipeline (DA-V2,
    dpt-large at full width) against the unmeshed forward on the same
    batch: raw output within FULL_WIDTH_TOL max-normalized, K1 a request;
    ZoeDepth at a tiny width, raw output to 1e-3 (bf16)."""
    from image_to_pointcloud_tpu_torch.models.depth_anything import build_model, init_weights
    from image_to_pointcloud_tpu_torch.parallel.pipeline_par import PipelinedModel, make_pipe_mesh
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline

    mesh = make_pipe_mesh(4, data=1, devices=_slots(4))
    out = {}
    for name, k1 in (("depth-anything-v2", 12), ("dpt-large", 24)):
        plain = models.get(name)
        pp = DepthPipeline(plain.model, model_target=plain.model_target, mesh=mesh,
                           pipe_microbatches=4)
        frames = [_frame(518, 518, 30 + i) for i in range(4)]
        raw_plain, _ = _raw_run(plain, frames)
        _reset()
        t0 = time.perf_counter()
        raw_pp, res = _raw_run(pp, frames)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        err = _max_norm_err(raw_pp, raw_plain)
        per_request = {k: c / 4 for k, c in counts.items()}
        log(f"mesh GPipe {name} (pipe=4, M=4, batch 4): raw output max-normalized error vs "
            f"unmeshed {err:.5f} (tol {FULL_WIDTH_TOL:g}); launches (eager) {counts} "
            f"({per_request} a request); eager batch wall {wall:.1f} ms; "
            f"{len(np.unique(res[0].points[:, 2]))} distinct z")
        if err > FULL_WIDTH_TOL or counts["flash_attention"] != 4 * k1 or counts["unproject"] != 1:
            raise AssertionError(f"the GPipe path of {name} failed")
        graph = _mesh_graph(f"GPipe {name} (pipe=4, M=4)", pp, frames,
                            {"flash_attention": 4 * k1, "grid_knn": 1, "unproject": 1,
                             "depthnorm": DEPTHNORM_518[name]})
        out[name] = {"err": err, "launches": graph["launches_replay"], "batch_ms": wall,
                     "graph": graph}
    import dataclasses

    zoe = _tiny_configs()["ZoeDepth"][0]  # 4 blocks, one tap a stage
    zoe = dataclasses.replace(zoe, backbone=dataclasses.replace(
        zoe.backbone, num_layers=4, out_layers=(1, 2, 3, 4)))
    model = init_weights(build_model(zoe), torch.Generator().manual_seed(0)).cuda().bfloat16()
    x = torch.randn(4, 64, 64, 3, generator=torch.Generator().manual_seed(4)).cuda()
    with torch.inference_mode():
        err = _max_norm_err(PipelinedModel(model, mesh, num_microbatches=4)(x), model(x))
    log(f"mesh GPipe zoedepth (tiny, bf16, pipe=4, M=4): raw output max-normalized error {err:.5f}")
    if err > 1e-3:
        raise AssertionError("the GPipe path of zoedepth failed")
    out["zoedepth tiny"] = {"err": err}
    return out


def _mesh_seq_attention() -> dict:
    from image_to_pointcloud_tpu_torch.models.attention import attention_plain
    from image_to_pointcloud_tpu_torch.parallel import context
    from image_to_pointcloud_tpu_torch.parallel.sharding import make_mesh

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(1, 6, 1370, 64, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    ref = attention_plain(q.float(), k.float(), v.float(), 1.0 / 8.0)
    mesh = make_mesh(data=1, seq=2, devices=_slots(2))
    out = {}
    for fn in (context.sequence_sharded_attention, context.ring_attention):
        parts = [list(t.chunk(2, dim=2)) for t in (q, k, v)]
        got = torch.cat(fn(*parts, mesh), dim=2).float()
        err = float((got - ref).abs().max())
        ms = cuda_time_ms(lambda: fn(*parts, mesh), 10)
        out[fn.__name__] = {"max_abs_err": err, "ms": ms}
        log(f"mesh {fn.__name__} (1, 6, 1370, 64) bf16 at seq=2: max abs error vs plain f32 "
            f"{err:.3e} (tol {SEQ_ATTN_TOL:g}), {ms:.3f} ms a call (host-inclusive)")
        if err > SEQ_ATTN_TOL:
            raise AssertionError(f"{fn.__name__} disagrees with the plain attention")
    return out


def _mesh_train() -> dict:
    """``depth-anything-v2-metric-small`` at full width (518², batch 2,
    f32, remat) on (data=2, model=2), four slots of one card, 3 steps at
    the fine-tuning rate 5e-6, against the one-device Trainer (its graph)
    from the same state, TF32 off. The meshed trainer replays one CUDA
    graph a step signature; an eager meshed trainer (its callable runs
    the body) steps beside it from the same state, and step 1's loss of
    the graph must be the eager one's bit for bit. The loss of the one
    device must move at every step by more than the agreement bound (a
    model that stops learning would make steps 2 and 3 check nothing);
    each meshed loss within 1e-4 relative of the one device's (phase 18's
    card-vs-CPU bound). After step 1 every parameter within Adam's
    first-step rule: 1e-3·lr plus what the gradient difference carries
    through the step (phase 18's) plus one f32 spacing of the parameter
    (the two updates round apart; at lr 5e-6 that spacing, 1.2e-7 near 1,
    exceeds 1e-3·lr). After step 3 the update over the three steps, p3 −
    p0 of every parameter, within MESH_TRAIN_UPDATE_TOL of the one
    device's in relative L2 norm (later Adam steps divide by the
    gradient's own running size, so f32 noise on a near-zero gradient
    flips an element's step: an elementwise rule, or one per small tensor,
    fails on that; the DP sum and Adam's moments act on every tensor).
    The keys' biases, whose gradient is zero in exact arithmetic and whose
    updates are Adam-normalized noise, are left out; each tensor's gap is
    printed, and the eager meshed trainer's update gap beside the
    graph's. Then the meshed step, graph against eager, on a batch already
    on the card (as phase 18's): the wall in turns (4 each), device time,
    busy share and kernels a step in a profiler window of 3, the capture
    and the pool."""
    from image_to_pointcloud_tpu_torch.models.depth_anything import build_model, init_weights, preset
    from image_to_pointcloud_tpu_torch.parallel.sharding import make_mesh
    from image_to_pointcloud_tpu_torch.train.trainer import TrainConfig, Trainer

    lr, eps = 5e-6, 1e-8
    sd = init_weights(build_model(preset(TRAIN_MODEL)), torch.Generator().manual_seed(0)).state_dict()
    # A batch of its own for each step, so that Adam's moments (not the
    # sign of one gradient alone) set the updates of steps 2 and 3.
    r = np.random.default_rng(7)
    x = r.normal(0, 1, (3, 2, 518, 518, 3)).astype(np.float32)
    y = (r.random((3, 2, 518, 518)) + 0.5).astype(np.float32)
    tcfg = TrainConfig(learning_rate=lr, loss="silog")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    res = {kind: {"losses": [], "step_ms": [], "params": []} for kind in ("one", "mesh", "eager")}
    grads = {}

    def take(kind: str, tr, step: int) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[kind]["losses"].append(tr.train_step(x[step], y[step]))
        torch.cuda.synchronize()
        res[kind]["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if step == 0 and kind != "eager":  # the elementwise rule is Adam's first step's
            grads[kind] = _named_grads(tr)
        if step in (0, 2):
            res[kind]["params"].append({k: v.detach().clone() for k, v in tr.state_dict().items()})

    try:
        torch.cuda.reset_peak_memory_stats()
        one = Trainer(preset(TRAIN_MODEL), sd, "cuda", tcfg)
        for step in range(3):
            take("one", one, step)
        res["one"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del one
        torch.cuda.reset_peak_memory_stats()
        mesh = make_mesh(data=2, model=2, devices=_slots(4))
        meshed = {"mesh": Trainer(preset(TRAIN_MODEL), sd, "cuda", tcfg, mesh=mesh),
                  "eager": Trainer(preset(TRAIN_MODEL), sd, "cuda", tcfg, mesh=mesh)}
        meshed["eager"].cuda_graphs = False
        for step in range(3):
            for kind, tr in meshed.items():
                take(kind, tr, step)
        res["mesh"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30  # both meshed
        graph, eager = meshed["mesh"], meshed["eager"]
        # The timed steps take a batch already on the card, as phase 18's
        # do: a host batch adds its pinned copy to each step.
        xd, yd = torch.from_numpy(x[0]).cuda(), torch.from_numpy(y[0]).cuda()
        (fn,) = graph._compiled.values()  # the host batch's signature: the same key
        walls = {"graph": [], "eager": []}
        for _ in range(2):
            for mode in ("eager", "graph", "graph", "eager"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                meshed["mesh" if mode == "graph" else "eager"].train_step(xd, yd)
                torch.cuda.synchronize()
                walls[mode].append((time.perf_counter() - t0) * 1e3)
        prof = {mode: _profiled_steps(lambda: tr.train_step(xd, yd))
                for mode, tr in (("graph", graph), ("eager", eager))}
        timing = {"wall_ms": {m: statistics.median(w) for m, w in walls.items()},
                  "capture_s": fn.capture_s, "pool_mib": graph.graph_pool_bytes() / 2**20,
                  "profile": {m: {k: v for k, v in p.items() if k != "top_ms"}
                              for m, p in prof.items()},
                  "graphs": len(graph._compiled), "cuda_graphs": graph.cuda_graphs}
        del meshed, graph, eager, fn
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (one1, one3), (mesh1, mesh3) = res["one"]["params"], res["mesh"]["params"]
    eager3 = res["eager"]["params"][1]
    worst1, rel3, noise, sq, sq_eager = 0.0, {}, {}, [0.0, 0.0], 0.0
    for name, p in one1.items():
        g, rg = grads["mesh"][name], grads["one"][name]
        m = torch.where(g * rg > 0, torch.minimum(g.abs(), rg.abs()), 0.0)
        spacing = torch.nextafter(p.abs(), torch.full_like(p, float("inf"))) - p.abs()
        bound = 1e-3 * lr + lr * (g - rg).abs() * eps / (m + eps) ** 2 + spacing
        worst1 = max(worst1, float(((mesh1[name] - p).abs() / bound).max()))
        moved = float((one3[name] - sd[name].to(p.device)).norm())
        gap = float((mesh3[name] - one3[name]).norm())
        (noise if name.endswith(".k.bias") else rel3)[name] = gap / moved if moved else gap
        if not name.endswith(".k.bias"):
            sq[0], sq[1] = sq[0] + gap**2, sq[1] + moved**2
            sq_eager += float((eager3[name] - one3[name]).norm()) ** 2
    gap3, gap3_eager = (sq[0] / sq[1]) ** 0.5, (sq_eager / sq[1]) ** 0.5
    worst3 = max(rel3, key=rel3.get)
    lm, lo, le = ([float(v) for v in res[k]["losses"]] for k in ("mesh", "one", "eager"))
    loss1_equal = torch.equal(res["mesh"]["losses"][0], res["eager"]["losses"][0])
    moves = [abs(b - a) / abs(a) for a, b in zip(lo, lo[1:])]
    prof = timing["profile"]
    log(f"mesh trainer {TRAIN_MODEL} 518² batch 2 f32 remat, lr {lr:g}, TF32 off: losses "
        f"(data=2, model=2) graph {lm}, eager {le} (step 1 bit for bit {loss1_equal}), one device "
        f"{lo} (relative moves {moves}); worst parameter "
        f"error after step 1 {worst1:.3f} of its bound; update p3 - p0 relative L2 gap after "
        f"step 3: {gap3:.3e} (tol {MESH_TRAIN_UPDATE_TOL:g}; the eager meshed trainer's "
        f"{gap3_eager:.3e}); per tensor, worst {worst3} "
        f"{rel3[worst3]:.3e}, median {statistics.median(rel3.values()):.3e} over "
        f"{len(rel3)} tensors, keys' biases "
        f"(left out) up to {max(noise.values(), default=0.0):.3e}; step ms mesh graph "
        f"{[round(t, 2) for t in res['mesh']['step_ms']]}, mesh eager "
        f"{[round(t, 2) for t in res['eager']['step_ms']]}, one device "
        f"{[round(t, 2) for t in res['one']['step_ms']]}; peak GiB both meshed "
        f"{res['mesh']['peak_gib']:.3f}, one device {res['one']['peak_gib']:.3f}")
    log(f"mesh trainer step, graph vs eager: wall median graph {timing['wall_ms']['graph']:.3f} ms, "
        f"eager {timing['wall_ms']['eager']:.3f} ms (4 each, in turns); device a step graph "
        f"{prof['graph']['device_ms']:.3f} ms, eager {prof['eager']['device_ms']:.3f} ms; busy "
        f"share graph {prof['graph']['busy_share']:.3f}, eager {prof['eager']['busy_share']:.3f} "
        f"(window of {TRAIN_PROFILED_STEPS}); kernels a step graph {prof['graph']['kernels']}, "
        f"eager {prof['eager']['kernels']}; capture {timing['capture_s']:.3f} s; pool "
        f"{timing['pool_mib']:.1f} MiB; {timing['graphs']} graph(s)")
    if not all(mv > 1e-4 for mv in moves):
        raise AssertionError(f"the one-device loss stopped moving: {lo}")
    if not (all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(lm, lo)) and worst1 <= 1
            and gap3 <= MESH_TRAIN_UPDATE_TOL):
        raise AssertionError("the meshed trainer disagrees with the one-device trainer")
    if not (loss1_equal and timing["cuda_graphs"] and timing["graphs"] == 1):
        raise AssertionError("the meshed trainer's graph disagrees with its eager step")
    out = {k: {kk: vv for kk, vv in v.items() if kk != "params"} for k, v in res.items()}
    for v in out.values():
        v["losses"] = [float(t) for t in v["losses"]]
    return {**out, "step1_worst": worst1, "step3_update_gap": gap3,
            "step3_update_gap_eager": gap3_eager, "step3_worst_tensor_gap": rel3[worst3],
            "graph_vs_eager": timing}


def _named_grads(tr) -> dict:
    """Each trained parameter's gradient, by its one-device name (the
    shards gathered as the state_dict gathers the parameters)."""
    saved = [p.detach().clone() for p in tr.params]
    with torch.no_grad():
        for p in tr.params:
            p.copy_(p.grad)
        out = {k: v.clone() for k, v in tr.state_dict().items()}
        for p, s in zip(tr.params, saved):
            p.copy_(s)
    return out


def _mesh_served(label: str, mm, expected: dict) -> dict:
    """The served DA-V2 of a meshed ``ModelManager``: its lone-request
    signature as graphs (:func:`_mesh_graph`), and a lone 518² request's
    submit+collect per image, graph against eager, in turns (8 each)."""
    pipe = mm.get("depth-anything-v2")
    row = _mesh_graph(label, pipe, [_frame(518, 518, 53)], expected)
    row["submit_collect_ms"] = per = _per_image_in_turns(_timed_runs(pipe, "png", 1), 1, 4)
    log(f"mesh {label}: submit+collect of a lone 518² request, per image eager "
        f"{per['eager']:.3f} ms, graph {per['graph']:.3f} ms (8 each, in turns)")
    return row


def _mesh_server(out_dir: str) -> dict:
    """The server on meshes: ``serve --mesh data=1,model=1`` in a child
    process (one slot, a non-flat PLY) and ``serve --mesh data=2`` refused
    with the slot-count error; in this process the one-slot mesh's
    pipeline (what the child serves) as its graph, and ``ModelManager(
    mesh=(data=2, model=2) over four cuda:0 slots)``: its pipeline as
    graphs, then behind the v1 app, three PNG requests with exact
    launches (K1 12 blocks x 2 model x 2 data slots, the lone request
    padded; K2 and K3 once per data slot), and each mesh's submit+collect
    of a lone request, graph against eager (:func:`_mesh_served`)."""
    import os
    import re
    import signal

    from image_to_pointcloud_tpu_torch.parallel.sharding import make_mesh
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    env = {k: v for k, v in os.environ.items() if not k.startswith("IPC_TPU_")}
    refused = subprocess.run(
        [sys.executable, "-m", "image_to_pointcloud_tpu_torch.serve", "--mesh", "data=2",
         "--port", "0", "--output-dir", f"{out_dir}/mesh_refused"],
        capture_output=True, text=True, timeout=120, env=env)
    ok_refused = refused.returncode == 2 and "more slots than devices (1 given)" in refused.stderr
    log(f"mesh serve --mesh data=2 on one card: rc {refused.returncode}, "
        f"{refused.stderr.strip().splitlines()[-1]!r}")
    child = subprocess.Popen(
        [sys.executable, "-m", "image_to_pointcloud_tpu_torch.serve", "--mesh", "data=1,model=1",
         "--port", "0", "--output-dir", f"{out_dir}/mesh_child"],
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = None
        deadline = time.time() + 180
        while port is None and time.time() < deadline:
            line = child.stderr.readline()
            if not line:
                break
            m = re.search(r"Serving v1 API on [\d.]+:(\d+) \(cuda, mesh (.*)\)", line)
            port = int(m.group(1)) if m else None
        if port is None:
            raise AssertionError("serve --mesh data=1,model=1 did not start")
        lat, st, ply = _request(f"http://127.0.0.1:{port}", _png(518, 518, 50))
        xyz = _check_ply(ply, st["results"]["pointCloud"]["points"])
        log(f"mesh serve --mesh data=1,model=1 (mesh {m.group(2)}): {lat * 1e3:.1f} ms, "
            f"{len(xyz)} points, {len(np.unique(xyz[:, 2]))} distinct z")
    finally:
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=60)
        child.stderr.close()
    one_slot = _mesh_served("serve --mesh data=1,model=1 (in process)",
                            ModelManager("cuda", mesh=make_mesh(data=1, model=1, devices=_slots(1))),
                            {"flash_attention": 12, "grid_knn": 1, "unproject": 1, "depthnorm": 1})
    expected = {"flash_attention": 48, "grid_knn": 2, "unproject": 2, "depthnorm": 2}
    meshed = ModelManager("cuda", mesh=make_mesh(data=2, model=2, devices=_slots(4)))
    served = _mesh_served("server (data=2, model=2)", meshed, expected)
    srv = _Server(out_dir, meshed)
    try:
        _request(srv.base, _png(518, 518, 51))  # builds the meshed model
        per = []
        for i in range(3):
            _reset()
            lat, st, ply = _request(srv.base, _png(518, 518, 52 + i))
            counts = _counts()
            xyz = _check_ply(ply, st["results"]["pointCloud"]["points"])
            per.append(counts)
            log(f"mesh server (data=2, model=2) request #{i}: {lat * 1e3:.1f} ms, {len(xyz)} "
                f"points, {len(np.unique(xyz[:, 2]))} distinct z, launches {counts}")
    finally:
        srv.stop()
    if not (ok_refused and rc == 0 and all(c == expected for c in per)):
        raise AssertionError(f"the meshed server failed (child rc {rc}, expected {expected})")
    return {"requests": per, "one_slot": one_slot, "data2_model2": served}


def phase_mesh(out_dir: str, models, int8_models) -> tuple[dict[str, int], dict]:
    """``parallel/`` on the one card, every slot ``cuda:0``: TP, int8 TP,
    DP, GPipe, sequence and ring attention, the meshed trainer and the
    meshed server, each against the port's unsharded card result. Slots
    sharing a card measure correctness and per-slot host cost, not a
    multi-GPU speed-up. Returns the launches of the meshed serving paths
    (each read on its own) and the phase's numbers."""
    totals: dict[str, int] = {}
    per_request: dict[str, dict[str, float]] = {}

    def add(path, counts, n):
        for k, c in counts.items():
            totals[k] = totals.get(k, 0) + c
            per_request.setdefault(k, {})[path] = c / n

    out = {"k1_tp": _mesh_k1_tp_times()}
    for name, blocks in (("depth-anything-v2", 12), ("dpt-large", 24)):
        out[f"tp {name}"] = r = _mesh_tp(models, name, blocks)
        add(f"{name} TP model=2", r["launches"], 1)
    out["int8 tp"] = r = _mesh_int8(int8_models)
    add("depth-anything-v2 int8 TP model=2", r["launches_replay"], 1)
    out["dp"] = dp = _mesh_dp(models)
    add("depth-anything-v2 DP data=2 batch 1", dp["launches"][1], 1)
    add("depth-anything-v2 DP data=2 batch 3", dp["launches"][3], 3)
    out["gpipe"] = gp = _mesh_gpipe(models)
    for name in ("depth-anything-v2", "dpt-large"):
        add(f"{name} GPipe pipe=4", gp[name]["launches"], 4)
    out["seq"] = _mesh_seq_attention()
    out["train"] = _mesh_train()
    out["server"] = srv = _mesh_server(out_dir)
    for c in srv["requests"]:
        add("depth-anything-v2 server data=2 model=2", c, 1)
    add("depth-anything-v2 serve --mesh data=1,model=1", srv["one_slot"]["launches_replay"], 1)
    log(f"mesh phase numbers: {json.dumps(out, default=str)}")
    return totals, per_request


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
    dn = timed(phase_depthnorm)
    timed(phase_codecs)
    timed(phase_jpeg_decode)
    timed(phase_slice)
    timed(phase_slice_int8)
    timed(phase_advanced_tiny)
    timed(phase_int8_linear)

    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    models = ModelManager("cuda")
    cpu_stages: dict = {}
    timed(phase_full_width, models, ModelManager("cpu"), cpu_stages)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        int8_models = ModelManager("cuda", int8=True)
        counts, per_request = timed(phase_server, out_dir, models, int8_models)
        f32_models = ModelManager("cuda", use_bf16=False)
        f32_counts, f32_runs = timed(phase_full_width_f32, out_dir, cpu_stages, f32_models)
        timed(phase_graphs, out_dir, models, int8_models, f32_models)
        cpu_stages.clear()
        for name, c in f32_counts.items():
            counts[name] += c
            per_request[name].update(f32_runs[name])
        cli_counts, cli_runs = timed(phase_cli, out_dir)
        for name, c in cli_counts.items():
            counts[name] += c
            per_request[name].update(cli_runs[name])
        timed_runs = timed(phase_timing, models, int8_models, f32_models)
        v2_counts = timed(phase_v2, out_dir, models)
        matte_counts = timed(phase_matte, models)
        train = timed(phase_train, out_dir, models)
        for path, path_counts, n in [("depth3d v2", v2_counts, v2_counts["unproject"]),
                                     ("depth3d learned matte", matte_counts, 1),
                                     (f"{TRAIN_MODEL} fine-tuned", train["served"], 1)]:
            for name, c in path_counts.items():
                counts[name] += c
                per_request[name][path] = c / n
        mesh_counts, mesh_runs = timed(phase_mesh, out_dir, models, int8_models)
        for name, c in mesh_counts.items():
            counts[name] += c
            per_request[name].update(mesh_runs[name])
        timed(phase_busy_share, timed_runs)
        _, adv_counts, adv_runs = timed(phase_advanced_graphs, models)
        for name, c in adv_counts.items():
            counts[name] += c
            per_request[name].update(adv_runs[name])
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
        {"name": "depthnorm", "route": "cuda",
         "source": "image_to_pointcloud_tpu_torch/csrc/depthnorm.cu",
         "replaces": "none (stands for image_to_pointcloud_tpu/ops/depthnorm.py order_statistics)",
         "launches": counts["depthnorm"], "launches_per_request": per_request["depthnorm"], **dn},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
