"""Service entry point: ``python -m image_to_pointcloud_tpu_torch.serve``.

Serves the v1 API (the reference's ``backend/app.py`` contract) or, with
``--generation v2``, the textured-asset API (``backend/main.py``) on the
PyTorch pipeline. Defaults come from the typed config tree
(``core/config.py``: built-in defaults ← ``IPC_TPU_CONFIG`` JSON file ←
``IPC_TPU_*`` env vars), then CLI flags. ``--checkpoint-dir`` (or
``IPC_TPU_CHECKPOINT_DIR``) points at HF-layout safetensors checkpoints or
the port's own ``<model>/torch/checkpoint.pt``. ``--mesh`` (or
``IPC_TPU_MESH``, or the config file's ``"mesh"``) serves on a grid of
device slots of ``--device``'s type, as the JAX server parses it:
``auto`` (DP over every visible device; none with one device),
``data=N,model=M[,seq=S]`` (``make_mesh``) or ``pipe=S,data=N``
(``make_pipe_mesh``, GPipe). A spec that needs more slots than there are
devices is refused.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import threading
from pathlib import Path


def parse_mesh(spec: str | None, device):
    """A ``--mesh`` spec → None, ``"auto"`` or a mesh over the visible
    devices of ``device``'s type (``ValueError`` for a bad spec, or one that
    needs more slots than there are devices)."""
    if not spec:
        return None
    if spec == "auto":
        return "auto"
    from image_to_pointcloud_tpu_torch.parallel.sharding import make_mesh, visible_devices

    try:
        axes = {k.strip(): int(v) for k, v in (kv.split("=") for kv in spec.split(","))}
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}: want e.g. data=2,model=2 or pipe=4,data=1") from None
    devices = visible_devices(device)
    if "pipe" in axes:
        from image_to_pointcloud_tpu_torch.parallel.pipeline_par import make_pipe_mesh

        return make_pipe_mesh(**axes, devices=devices)
    return make_mesh(**axes, devices=devices)


def main() -> None:
    from image_to_pointcloud_tpu_torch.core.config import load_config

    cfg = load_config(os.environ.get("IPC_TPU_CONFIG"))

    parser = argparse.ArgumentParser(
        description="image→point-cloud service on PyTorch (CUDA)"
    )
    parser.add_argument("--host", default=cfg.host)
    parser.add_argument("--port", type=int, default=cfg.port)
    parser.add_argument("--output-dir", default=cfg.output_dir)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the model: 'cuda' (bf16, the CUDA kernels) "
        "or 'cpu' (f32, the plain versions)",
    )
    parser.add_argument("--honor-fov", action="store_true", default=cfg.honor_fov)
    parser.add_argument(
        "--mesh-method", choices=["grid", "poisson", "bpa"], default=cfg.mesh_method,
        help="mesh_ply reconstruction: 'grid' = exact depth-grid "
        "triangulation (default), 'poisson'/'bpa' via the native library",
    )
    parser.add_argument(
        "--eager-export", action="store_true", default=not cfg.lazy_export,
        help="write point-cloud artifacts during the job instead of on "
        "first GET /download",
    )
    parser.add_argument(
        "--warmup", default=cfg.warmup,
        help="comma-separated HxW sizes to run once at startup, e.g. '518x518'",
    )
    parser.add_argument(
        "--ui", action="store_true", default=cfg.serve_ui,
        help="serve the first-party frontend at /ui",
    )
    parser.add_argument(
        "--jpeg-device-decode", action="store_true", default=cfg.jpeg_device_decode,
        help="hybrid JPEG ingest: the host entropy-decodes JPEG uploads and "
        "the device does dequant, IDCT, chroma upsample and colour",
    )
    parser.add_argument("--log-json", action="store_true", default=cfg.log_json)
    parser.add_argument(
        "--checkpoint-dir", default=cfg.checkpoint_dir,
        help="checkpoint root: <dir>/<model>/torch/checkpoint.pt (train or "
        "convert-ckpt), else HF-layout <dir>/<model>/model.safetensors or "
        "<dir>/<model>.safetensors; <dir>/matting/model.safetensors for the v2 "
        "matte (default: IPC_TPU_CHECKPOINT_DIR; without one, a deterministic "
        "random init)",
    )
    parser.add_argument(
        "--generation", choices=["v1", "v2"], default="v1",
        help="v1: the depth point-cloud API; v2: the textured 3D asset API",
    )
    parser.add_argument(
        "--mesh", default=cfg.mesh,
        help="device-slot mesh: 'auto' (DP over all devices), 'data=N,model=M[,seq=S]' "
        "(batches split over data, encoder blocks megatron-sharded over model), or "
        "'pipe=S,data=N' (GPipe: encoder stages over S slots)",
    )
    args = parser.parse_args()
    try:
        mesh = parse_mesh(args.mesh, args.device)
    except (ValueError, TypeError, RuntimeError) as e:
        parser.error(f"--mesh {args.mesh}: {e}")

    from image_to_pointcloud_tpu_torch.serve.http import HttpServer
    from image_to_pointcloud_tpu_torch.utils.logging import configure_logging
    from image_to_pointcloud_tpu_torch.pipeline import graph as _graph
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    configure_logging(json_lines=args.log_json)
    # The size caps are module-level parity constants; apply the config
    # before the first request.
    _graph.MAX_IMAGE_DIM = cfg.max_image_dim
    _graph.DEPTH_PREVIEW_MAX = cfg.depth_preview_max

    warmup_sizes = []
    if args.warmup:
        for tok in args.warmup.split(","):
            hh, ww = tok.lower().split("x")
            warmup_sizes.append((int(hh), int(ww)))

    async def run() -> None:
        models = ModelManager(args.device, checkpoint_dir=args.checkpoint_dir, mesh=mesh)
        if args.generation == "v1":
            from image_to_pointcloud_tpu_torch.serve.app_v1 import create_v1_app

            app = create_v1_app(
                output_dir=args.output_dir,
                models=models,
                honor_fov=args.honor_fov,
                mesh_method=args.mesh_method,
                warmup_sizes=warmup_sizes,
                batch_window_ms=cfg.batch_window_ms,
                max_batch=cfg.max_batch,
                durable_jobs=cfg.durable_jobs,
                max_jobs=cfg.max_jobs,
                defaults=cfg.defaults,
                max_file_size=cfg.max_file_size,
                max_preview_points=cfg.max_preview_points,
                mesh_preview_tris=cfg.mesh_preview_tris,
                jpeg_device_decode=args.jpeg_device_decode,
                lazy_export=not args.eager_export,
                lazy_export_max_bytes=cfg.lazy_export_max_bytes,
            )
            server = HttpServer(app.router, args.host, args.port, cors_origin=cfg.cors_origin_v1)
            if warmup_sizes:
                threading.Thread(target=app.warmup, daemon=True).start()
        else:
            if args.jpeg_device_decode:
                # v2's preprocess (matte, foreground crop, 512² resize)
                # needs host pixels, so the hybrid ingest cannot apply.
                logging.getLogger(__name__).warning(
                    "--jpeg-device-decode applies to --generation v1 only; ignored for v2"
                )
            from image_to_pointcloud_tpu_torch.serve.app_v2 import create_v2_app

            app = create_v2_app(
                output_dir=args.output_dir,
                models=models,
                durable_jobs=cfg.durable_jobs,
                max_jobs=cfg.max_jobs,
                v2_defaults=cfg.v2,
            )
            server = HttpServer(app.router, args.host, args.port, cors_origin=cfg.cors_origin_v2)
        if args.ui:
            ui_dir = Path(__file__).resolve().parents[2] / "frontend"
            app.router.mount_static("/ui", ui_dir)
        await server.start()
        logging.info("Serving %s API on %s:%d (%s, mesh %s)", args.generation, args.host,
                     server.bound_port, args.device,
                     None if models.mesh is None else models.mesh.shape)
        if args.generation == "v2":
            # Bound before the model loads: /health answers and /process
            # 503s while this awaits.
            await app.startup()

        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        serve_task = asyncio.create_task(server.serve_forever())
        stop_task = asyncio.create_task(stop.wait())
        # Exit on a signal or on a crashed accept loop.
        await asyncio.wait({serve_task, stop_task}, return_when=asyncio.FIRST_COMPLETED)
        logging.info("Shutting down...")
        stop_task.cancel()
        serve_err = serve_task.exception() if serve_task.done() else None
        if not serve_task.done():
            serve_task.cancel()
        await server.stop()
        await app.shutdown()
        app.jobs.close()
        if serve_err is not None:
            raise serve_err

    asyncio.run(run())


if __name__ == "__main__":
    main()
