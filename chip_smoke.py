"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero, and the result lines are not printed):

1. device: CUDA must be available; the card's name and power limit.
2. build: the CUDA kernels from ``image_to_pointcloud_tpu_torch/csrc``.
3. K1 flash attention vs its plain version at the flagship shape
   (2, 6, 1370, 64) bf16 and at a ragged N=200, with CUDA-event times.
4. K2 grid-kNN vs its plain version at (2, 259, 259, 3) — 518² at
   medium density — and at the odd grid (1, 150, 200, 3).
5. the slice on the card vs the slice on the CPU: a tiny config with
   64-wide heads, same weights, f32, TF32 off.
6. the v1 server in this process with Depth-Anything-V2-Small in bf16:
   518² and 400×300 PNG → PLY requests through /process, /status and
   /download; the launch counters are zeroed just before and must rise.

It prints the per-kernel JSON line, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. It needs
the repository checkout (run it from its root) and imports no JAX.
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
# K2: the JAX Pallas test's own tolerance; the kernel is in fact
# bit-identical (same cascade, no FMA contraction).
K2_RTOL, K2_ATOL = 1e-5, 1e-7
# Slice, card vs CPU (the port's CPU parity tolerances).
SLICE_KEEP_AGREE, SLICE_RMSE = 0.995, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int) -> float:
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


def phase_k1() -> dict:
    from image_to_pointcloud_tpu_torch.models.attention import attention_plain, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for shape, dtype in [((2, 6, 1370, 64), torch.bfloat16), ((1, 6, 200, 64), torch.bfloat16),
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
        if shape == (2, 6, 1370, 64) and dtype == torch.bfloat16:
            ms = cuda_time_ms(lambda: flash_attention(q, k, v), 50)
            plain_ms = cuda_time_ms(lambda: attention_plain(q, k, v, 1.0 / 8.0), 50)
            log(f"K1 flagship bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return out


def phase_k2() -> dict:
    from image_to_pointcloud_tpu_torch.ops.outlier import (
        grid_knn_mean_distances_cuda,
        grid_knn_mean_distances_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for shape in [(2, 259, 259, 3), (1, 150, 200, 3)]:
        pts = torch.rand(shape, generator=gen, device="cuda") * 3
        o = grid_knn_mean_distances_cuda(pts)
        torch.cuda.synchronize()
        ref = grid_knn_mean_distances_plain(pts)
        torch.cuda.synchronize()
        err = (o - ref).abs().max().item()
        ok = torch.allclose(o, ref, rtol=K2_RTOL, atol=K2_ATOL)
        log(f"K2 {shape}: max_abs_err {err:.3e} (rtol {K2_RTOL:g}, atol {K2_ATOL:g}), "
            f"bit-identical {torch.equal(o, ref)}")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at {shape}")
        if shape == (2, 259, 259, 3):
            ms = cuda_time_ms(lambda: grid_knn_mean_distances_cuda(pts), 50)
            plain_ms = cuda_time_ms(lambda: grid_knn_mean_distances_plain(pts), 5)
            log(f"K2 (2, 259, 259, 3): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return out


def phase_slice() -> None:
    from image_to_pointcloud_tpu_torch.models.depth_anything import (
        DepthAnything,
        DepthAnythingConfig,
        init_weights,
    )
    from image_to_pointcloud_tpu_torch.models.dinov2 import DinoV2Config
    from image_to_pointcloud_tpu_torch.models.dpt import DPTConfig
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline

    cfg = DepthAnythingConfig(
        backbone=DinoV2Config(hidden_size=128, num_layers=2, num_heads=2, out_layers=(0, 1, 1, 1)),
        neck=DPTConfig(hidden_size=128, neck_hidden_sizes=(32, 64, 128, 128), fusion_hidden_size=32),
    )
    model = init_weights(DepthAnything(cfg), torch.Generator().manual_seed(0))
    img = np.random.default_rng(0).integers(0, 256, (200, 260, 3), dtype=np.uint8)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = DepthPipeline(model, model_target=140).run(img, depth_scale=15.0)
        gpu = DepthPipeline(model.to("cuda"), model_target=140).run(img, depth_scale=15.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    kc, kg = cpu.packed[6] > 0.5, gpu.packed[6] > 0.5
    both = kc & kg
    agree = float((kc == kg).mean())
    rmse = float(np.sqrt(((cpu.packed[:3, both] - gpu.packed[:3, both]) ** 2).sum(0).mean()))
    colors = bool(np.array_equal(cpu.packed[3:6], gpu.packed[3:6]))
    prev = int(np.abs(cpu.depth_preview_gray.astype(int) - gpu.depth_preview_gray.astype(int)).max())
    log(f"slice card vs CPU: points {gpu.raw_point_count}/{cpu.raw_point_count}, colors exact "
        f"{colors}, keep agree {agree:.5f} (>= {SLICE_KEEP_AGREE}), rmse {rmse:.3e} "
        f"(< {SLICE_RMSE}), preview max diff {prev}")
    if not (gpu.raw_point_count == cpu.raw_point_count and colors
            and agree >= SLICE_KEEP_AGREE and rmse < SLICE_RMSE and prev <= 1):
        raise AssertionError("slice on the card disagrees with the slice on the CPU")


def _multipart(png: bytes) -> tuple[bytes, str]:
    boundary = uuid.uuid4().hex
    body = (
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
        f"filename=\"img.png\"\r\nContent-Type: image/png\r\n\r\n"
    ).encode() + png + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _http(url: str, data: bytes | None = None, ctype: str | None = None) -> bytes:
    req = urllib.request.Request(url, data=data, method="POST" if data else "GET")
    if ctype:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def _request(base: str, png: bytes) -> tuple[float, dict, bytes]:
    """POST /process → poll /status → GET /download; returns (seconds from
    the upload to the downloaded PLY, final status, the PLY)."""
    body, ctype = _multipart(png)
    t0 = time.perf_counter()
    job = json.loads(_http(f"{base}/process?output_format=ply&point_density=medium"
                           f"&depth_scale=15", body, ctype))["job_id"]
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
    from image_to_pointcloud_tpu.io import read_ply

    v = read_ply(data)["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1)
    if not (len(xyz) == n > 0 and np.isfinite(xyz).all()):
        raise AssertionError(f"bad PLY: {len(xyz)} points (expected {n}), finite "
                             f"{np.isfinite(xyz).all()}")


def _png(h: int, w: int, seed: int) -> bytes:
    from image_to_pointcloud_tpu.io.image import encode_png

    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    img = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 127 // (h + w)], -1)
    img = img + rng.integers(0, 24, (h, w, 3))
    return encode_png(np.clip(img, 0, 255).astype(np.uint8))


def phase_server(out_dir: str) -> dict[str, int]:
    from image_to_pointcloud_tpu.serve.http import HttpServer
    from image_to_pointcloud_tpu_torch import cuda
    from image_to_pointcloud_tpu_torch.serve.app_v1 import create_v1_app
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    loop = asyncio.new_event_loop()
    app = create_v1_app(output_dir=out_dir, models=ModelManager("cuda"), durable_jobs=False)
    server = HttpServer(app.router, "127.0.0.1", 0)
    loop.run_until_complete(server.start())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.bound_port}"
    try:
        sq = _png(518, 518, 0)
        lat, st, ply = _request(base, sq)  # builds the model: not timed as serving
        log(f"server cold request 518x518: {lat * 1e3:.1f} ms (model build included), "
            f"timings {st['timings']}")

        for k in cuda.KERNELS:
            k.reset()
        lats = []
        for i in range(5):
            lat, st, ply = _request(base, _png(518, 518, 10 + i))
            _check_ply(ply, st["results"]["pointCloud"]["points"])
            lats.append(lat)
            log(f"request 518x518 #{i}: {lat * 1e3:.1f} ms, "
                f"{st['results']['pointCloud']['points']} points, timings {st['timings']}")
        lat, st, ply = _request(base, _png(300, 400, 20))
        _check_ply(ply, st["results"]["pointCloud"]["points"])
        log(f"request 400x300: {lat * 1e3:.1f} ms, {st['results']['pointCloud']['points']} "
            f"points, timings {st['timings']}")
        counts = {k.name: k.launches for k in cuda.KERNELS}
        log(f"server p50 latency 518x518 PNG -> PLY: {statistics.median(lats) * 1e3:.1f} ms "
            f"over {len(lats)} sequential requests")
        log(f"kernel launches during the served requests: {counts}")
        if any(n == 0 for n in counts.values()):
            raise AssertionError(f"a kernel of the main path never launched: {counts}")
        return counts
    finally:
        async def _stop():
            await server.stop()
            await app.shutdown()

        asyncio.run_coroutine_threadsafe(_stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=60)
        app.jobs.close()


def main() -> int:
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
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    k1 = phase_k1()
    k2 = phase_k2()
    phase_slice()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        counts = phase_server(out_dir)

    if any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules):
        raise AssertionError("JAX was imported")
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "image_to_pointcloud_tpu_torch/csrc/flash_attention.cu",
         "replaces": "image_to_pointcloud_tpu/models/attention.py:175",
         "launches": counts["flash_attention"], **k1},
        {"name": "grid_knn", "route": "cuda",
         "source": "image_to_pointcloud_tpu_torch/csrc/grid_knn.cu",
         "replaces": "image_to_pointcloud_tpu/ops/outlier_pallas.py:134",
         "launches": counts["grid_knn"], **k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
