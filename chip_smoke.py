"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero, and the result lines are not printed):

1. device: CUDA must be available; the card's name and power limit.
2. build: the CUDA kernels from ``image_to_pointcloud_tpu_torch/csrc``.
3. K1 flash attention vs its plain version at the flagship shape
   (2, 6, 1370, 64) bf16 and at a ragged N=200, with CUDA-event times.
4. K2 grid-kNN vs its plain version at (2, 259, 259, 3) — 518² at
   medium density — and at the odd grid (1, 150, 200, 3).
5. K3 unproject vs its plain version, bit for bit, at (2, 518, 518)
   step 2, at step 1 with a fov, and at a ragged (1, 301, 401) step 4,
   with CUDA-event times at the first shape.
6. the transfer codecs on the card vs the CPU, byte for byte.
7. the JPEG device decode of a q88 4:2:0 518² frame: sparse vs dense
   payload bit for bit, card vs CPU within 1 level, vs PIL within 3.
8. the slice on the card vs the slice on the CPU: a tiny config with
   64-wide heads, same weights, f32, TF32 off, through the f32 return
   and through the quantized bundle.
9. the v1 server in this process with Depth-Anything-V2-Small in bf16,
   each main path read on its own (the launch counters zeroed just
   before and read just after): 518² and 400×300 PNG → PLY requests
   through the default quantized bundle, then a second app with the
   hybrid JPEG ingest and five q88 518² JPEG → PLY requests, every one
   of which must take the device decode.
10. batch-1 ``submit_batch`` + ``collect`` medians, in turns: PNG with
    the f32 return, PNG with the quantized bundle, JPEG with the bundle.

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
# K3, codecs, sparse vs dense decode: bit-identical (same operations in
# the same order, no FMA contraction).
# JPEG decode: card vs CPU within 1 level (f32 GEMMs sum in another
# order); vs PIL within libjpeg's integer-IDCT tolerance.
JPEG_CPU_TOL, JPEG_PIL_TOL = 1.0, 3.0
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


def phase_k3() -> dict:
    from image_to_pointcloud_tpu_torch.ops.unproject import unproject_cuda, unproject_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for (b, h, w), step, fov in [((2, 518, 518), 2, None), ((1, 400, 300), 1, 70.0),
                                 ((1, 301, 401), 4, None)]:
        d = torch.rand((b, h, w), generator=gen, device="cuda")
        d[:, 7, ::5] = 0.0  # the z == 0 epsilon path
        img = torch.rand((b, h, w, 3), generator=gen, device="cuda").mul(255).round()
        kw = dict(depth_scale=torch.tensor([15.0, 2.5][:b], device="cuda"), step=step,
                  h=h, w=w, fov_deg=fov)
        o = unproject_cuda(d, img, **kw)
        torch.cuda.synchronize()
        ref = unproject_plain(d, img, **kw)
        err = (o - ref).abs().max().item()
        log(f"K3 ({b}, {h}, {w}) step {step} fov {fov}: max_abs_err {err:.3e}, "
            f"bit-identical {torch.equal(o, ref)}")
        if not torch.equal(o, ref):
            raise AssertionError(f"K3 disagrees with its plain version at {(b, h, w)} step {step}")
        if (b, h, w) == (2, 518, 518):
            ms = cuda_time_ms(lambda: unproject_cuda(d, img, **kw), 50)
            plain_ms = cuda_time_ms(lambda: unproject_plain(d, img, **kw), 50)
            log(f"K3 (2, 518, 518) step 2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return out


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

    from image_to_pointcloud_tpu import native
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
    cpu_model = init_weights(DepthAnything(cfg), torch.Generator().manual_seed(0))
    gpu_model = init_weights(DepthAnything(cfg), torch.Generator().manual_seed(0)).to("cuda")
    img = np.random.default_rng(0).integers(0, 256, (200, 260, 3), dtype=np.uint8)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for quantized in (False, True):
            kw = dict(model_target=140, quantized_transfer=quantized)
            cpu = DepthPipeline(cpu_model, **kw).run(img, depth_scale=15.0)
            gpu = DepthPipeline(gpu_model, **kw).run(img, depth_scale=15.0)
            kc, kg = cpu.packed[6] > 0.5, gpu.packed[6] > 0.5
            both = kc & kg
            agree = float((kc == kg).mean())
            rmse = float(np.sqrt(((cpu.packed[:3, both] - gpu.packed[:3, both]) ** 2)
                                 .sum(0).mean()))
            colors = bool(np.array_equal(cpu.packed[3:6], gpu.packed[3:6]))
            prev = int(np.abs(cpu.depth_preview_gray.astype(int)
                              - gpu.depth_preview_gray.astype(int)).max())
            log(f"slice card vs CPU, {'quantized bundle' if quantized else 'f32 return'}: "
                f"points {gpu.raw_point_count}/{cpu.raw_point_count}, colors exact {colors}, "
                f"keep agree {agree:.5f} (>= {SLICE_KEEP_AGREE}), rmse {rmse:.3e} "
                f"(< {SLICE_RMSE}), preview max diff {prev}")
            if not (gpu.raw_point_count == cpu.raw_point_count and colors
                    and agree >= SLICE_KEEP_AGREE and rmse < SLICE_RMSE and prev <= 1):
                raise AssertionError("slice on the card disagrees with the slice on the CPU")
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
    req = urllib.request.Request(url, data=data, method="POST" if data else "GET")
    if ctype:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def _request(base: str, data: bytes, ctype: str = "image/png") -> tuple[float, dict, bytes]:
    """POST /process → poll /status → GET /download; returns (seconds from
    the upload to the downloaded PLY, final status, the PLY)."""
    body, ctype = _multipart(data, ctype)
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

    return encode_png(_frame(h, w, seed))


def _served_requests(base: str, kind: str) -> dict[str, int]:
    """One main path through the server: the launch counters are zeroed
    just before its requests and read just after."""
    from image_to_pointcloud_tpu_torch import cuda

    make, ctype, stage = {
        "png": (_png, "image/png", "decode"),
        "jpeg": (_jpeg, "image/jpeg", "jpeg_plan"),
    }[kind]
    # The first request of a path builds the model and the kernels: not
    # timed as serving.
    lat, st, _ = _request(base, make(518, 518, 0), ctype)
    log(f"server cold {kind} request 518x518: {lat * 1e3:.1f} ms, timings {st['timings']}")

    for k in cuda.KERNELS:
        k.reset()
    lats = []
    sizes = [(518, 518)] * 5 + ([(300, 400)] if kind == "png" else [])
    for i, (h, w) in enumerate(sizes):
        lat, st, ply = _request(base, make(h, w, 10 + i), ctype)
        _check_ply(ply, st["results"]["pointCloud"]["points"])
        if stage not in st["timings"]:
            raise AssertionError(f"{kind} request #{i} did not take the {stage} ingest: "
                                 f"timings {st['timings']}")
        if (h, w) == (518, 518):
            lats.append(lat)
        log(f"{kind} request {w}x{h} #{i}: {lat * 1e3:.1f} ms, "
            f"{st['results']['pointCloud']['points']} points, timings {st['timings']}")
    counts = {k.name: k.launches for k in cuda.KERNELS}
    log(f"server p50 latency 518x518 {kind.upper()} -> PLY: "
        f"{statistics.median(lats) * 1e3:.1f} ms over {len(lats)} sequential requests")
    log(f"kernel launches during the served {kind} requests: {counts}")
    if any(n == 0 for n in counts.values()):
        raise AssertionError(f"a kernel of the {kind} path never launched: {counts}")
    return counts


def phase_server(out_dir: str, models) -> dict[str, int]:
    from image_to_pointcloud_tpu.serve.http import HttpServer
    from image_to_pointcloud_tpu_torch.serve.app_v1 import create_v1_app

    counts: dict[str, int] = {}
    for kind in ("png", "jpeg"):
        loop = asyncio.new_event_loop()
        app = create_v1_app(output_dir=out_dir, models=models, durable_jobs=False,
                            jpeg_device_decode=kind == "jpeg")
        server = HttpServer(app.router, "127.0.0.1", 0)
        loop.run_until_complete(server.start())
        thread = threading.Thread(target=loop.run_forever, daemon=True)
        thread.start()
        try:
            path_counts = _served_requests(f"http://127.0.0.1:{server.bound_port}", kind)
            for name, n in path_counts.items():
                counts[name] = counts.get(name, 0) + n
        finally:
            _stop(loop, thread, server, app)
    if not models.get("depth-anything-v2").quantized_transfer:
        raise AssertionError("the server on the card did not default to the quantized bundle")
    return counts


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
    k3 = phase_k3()
    phase_codecs()
    phase_jpeg_decode()
    phase_slice()

    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    models = ModelManager("cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        counts = phase_server(out_dir, models)
    phase_timing(models)

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
        {"name": "unproject", "route": "cuda",
         "source": "image_to_pointcloud_tpu_torch/csrc/unproject.cu",
         "replaces": "image_to_pointcloud_tpu/ops/unproject.py:208",
         "launches": counts["unproject"], **k3},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
