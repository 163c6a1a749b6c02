"""Where a 518² request's time goes in the PyTorch port, on one GPU.

    PYTHONPATH=. python3 tools/profile_torch_pipeline.py [--batch 1] [--iters 10]
        [--ingest png|jpeg] [--transfer quantized|f32] [--model depth-anything-v2] [--int8]

Runs ``DepthPipeline`` with a served preset (``--model``; default
Depth-Anything-V2-Small; ``--int8``: its int8 W8A8 encoder) in bf16
(random init) on 518×518 images, decoded pixels or q88 JPEGs through the hybrid
device decode, with the quantized bundle (the card's default) or the f32
return: the host wall time of submit+collect (what a request waits for),
then one ``torch.profiler`` window over ``--iters`` runs for device time
by kernel and the device's busy share. Each run replays the signature's
CUDA graph, captured in the first warm-up run. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import io
import statistics
import subprocess
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--ingest", choices=["png", "jpeg"], default="png")
    ap.add_argument("--transfer", choices=["quantized", "f32"], default="quantized")
    ap.add_argument("--model", default="depth-anything-v2", help="a preset, e.g. dpt-large, zoedepth")
    ap.add_argument("--int8", action="store_true", help="the int8 W8A8 encoder (IPC_TPU_INT8)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_pipeline: CUDA is not available")
    from torch.profiler import ProfilerActivity, profile

    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline, plan_jpeg_input
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    served = ModelManager("cuda", int8=args.int8).get(args.model)
    pipe = DepthPipeline(served.model, model_target=served.model_target, quantized_transfer=args.transfer == "quantized")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:518, 0:518]
    imgs = [
        np.clip(np.stack([xx // 3, yy // 3, (xx + yy) // 5], -1)
                + rng.integers(0, 24, (518, 518, 3)), 0, 255).astype(np.uint8)
        for _ in range(args.batch)
    ]
    if args.ingest == "jpeg":
        from PIL import Image

        jpegs = []
        for img in imgs:
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=88)
            jpegs.append(plan_jpeg_input(buf.getvalue()))
            if jpegs[-1] is None:
                raise SystemExit("profile_torch_pipeline: the JPEG planner declined the frame")
            jpegs[-1].grid_colors(2)  # the server's planner does this off the drain

    def run():
        if args.ingest == "jpeg":
            handle = pipe.submit_batch_jpeg(jpegs, depth_scales=15.0)
        else:
            handle = pipe.submit_batch(imgs, depth_scales=15.0)
        return pipe.collect(handle, want_packed=False, want_preview_rgb=False)

    for _ in range(3):
        run()
    walls = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"{args.model}{' int8' if args.int8 else ''} {args.ingest}/{args.transfer} batch {args.batch}: submit+collect median {wall * 1e3:.2f} ms "
          f"({wall * 1e3 / args.batch:.2f} ms/image) over {args.iters}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        window = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"profiled window {window * 1e3:.1f} ms, device kernel time {busy_us / 1e3:.1f} ms, "
          f"busy share {busy_us / 1e3 / (window * 1e3):.3f}")
    def row(e) -> str:
        return (f"  {e.self_device_time_total / 1e3 / args.iters:9.4f} ms/run  "
                f"{e.count // args.iters:5d}x  {e.key[:90]}")

    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(row(e))
    print("the port's own kernels:")
    for e in events:
        if any(k in e.key for k in ("flash_fwd", "grid_knn_kernel", "unproject_kernel")):
            print(row(e))
    launches = sum(e.count for e in events) // args.iters
    print(f"device kernels per run: {launches}")


if __name__ == "__main__":
    main()
