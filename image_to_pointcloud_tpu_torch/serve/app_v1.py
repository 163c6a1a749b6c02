"""v1 service: the reference's "Image to Point Cloud API" contract on the
PyTorch pipeline.

Counterpart of ``image_to_pointcloud_tpu/serve/app_v1.py``, with the same
routes, job flow, progress milestones and result keys:

* ``POST /process`` — multipart file + query/form params, 50 MB cap,
  returns ``{"job_id", "status": "queued"}``
* ``GET /status/{job_id}``, ``GET /download/{job_id}``, ``GET /models``,
  ``GET /health``, ``/jobs``, ``DELETE /jobs/{id}``, ``/outputs/…``,
  ``/metrics``, ``/timings/{id}``, ``/openapi.json``, ``/docs``

The HTTP server, job registry, metrics, exporters and meshing are the
port's own copies of the JAX package's host modules. With ``jpeg_device_decode`` a JPEG upload
takes the hybrid ingest: the host only entropy-decodes it
(:func:`~image_to_pointcloud_tpu_torch.pipeline.graph.plan_jpeg_input`)
and the pixels materialize on the device; other uploads, and JPEGs the
planner declines, are decoded to pixels on the host. Every depth preset
of the model manager is served (``model=`` Depth-Anything-V2, ``dpt-large``
and the classic-DPT family, ``zoedepth``); the reference's dummy models
``triposr``/``instantmesh`` run their intensity-as-depth graphs on the
service's device. ``POST /profile/start`` and ``/profile/stop`` bracket a
``torch.profiler`` trace, written as a Chrome trace under
``<output_dir>/traces`` on stop.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from image_to_pointcloud_tpu_torch.io import (
    generate_gis_metadata,
    write_las,
    write_ply_mesh,
    write_ply_points,
    write_xyz,
)
from image_to_pointcloud_tpu_torch.io.image import decode_image_rgb, png_data_url, png_data_url_palette
from image_to_pointcloud_tpu_torch.pipeline.meshing import (
    decimate_grid_mesh,
    grid_mesh_from_packed,
    vertex_normals,
)
from image_to_pointcloud_tpu_torch.serve import metrics as m
from image_to_pointcloud_tpu_torch.serve.http import (
    HTTPError,
    Request,
    Response,
    Router,
    file_response,
    json_response,
)
from image_to_pointcloud_tpu_torch.serve.jobs import JobRegistry, JobStatus
from image_to_pointcloud_tpu_torch.serve.rawjson import (
    float_triplets as _triplets_json,
    int_list as _ints_json,
)
from image_to_pointcloud_tpu_torch.ops.colormap import PLASMA_RGB
from image_to_pointcloud_tpu_torch.ops.unproject import DENSITY_STRIDES
from image_to_pointcloud_tpu_torch.pipeline.graph import (
    PipelineOptions,
    demo_depth_map_graph,
    dummy_point_cloud_graph,
    plan_jpeg_input,
)
from image_to_pointcloud_tpu_torch.serve.batching import BatchingQueue, bucket_sizes
from image_to_pointcloud_tpu_torch.serve.models import DUMMY_MODELS, ModelManager

__all__ = ["V1Service", "create_v1_app"]

logger = logging.getLogger(__name__)

MAX_FILE_SIZE = 50 * 1024 * 1024  # reference backend/app.py:45
MAX_PREVIEW_POINTS = 20000  # reference backend/app.py:496
MESH_FORMATS = {"mesh_ply", "mesh"}

# Capability cards served by GET /models (reference backend/app.py:702-737).
MODEL_CARDS = [
    {
        "id": "depth-anything-v2",
        "name": "Depth Anything V2",
        "description": "Superior depth estimation + point cloud",
        "license": "Apache-2.0",
        "recommended": True,
        "supported": True,
        "speed": "2-3s",
        "quality": "High",
    },
    {
        "id": "triposr",
        "name": "TripoSR",
        "description": "Fast mesh generation (1-2 seconds)",
        "license": "MIT",
        "recommended": False,
        "supported": False,
        "speed": "1-2s",
        "quality": "Medium",
    },
    {
        "id": "instantmesh",
        "name": "InstantMesh",
        "description": "High quality 3D assets (~10 seconds)",
        "license": "Custom",
        "supported": False,
        "speed": "~10s",
        "quality": "Very High",
    },
]


def _parse_bool(v: str | bool, default: bool) -> bool:
    if isinstance(v, bool):
        return v
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


class V1Service:
    def __init__(
        self,
        *,
        output_dir: str = "outputs",
        models: ModelManager | None = None,
        honor_fov: bool = False,
        mesh_method: str = "grid",
        batch_window_ms: float = 5.0,
        max_batch: int = 16,
        warmup_sizes: "list[tuple[int, int]] | None" = None,
        durable_jobs: bool = True,
        max_jobs: int | None = None,
        defaults=None,
        max_file_size: int = MAX_FILE_SIZE,
        max_preview_points: int = MAX_PREVIEW_POINTS,
        mesh_preview_tris: int = 20000,
        jpeg_device_decode: bool = False,
        lazy_export: bool = True,
        lazy_export_max_bytes: int = 256 * 1024 * 1024,
    ):
        from image_to_pointcloud_tpu_torch.core.config import ProcessingDefaults

        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(exist_ok=True, parents=True)
        self.models = models or ModelManager()
        self.honor_fov = honor_fov
        self.defaults = defaults or ProcessingDefaults()
        self.max_file_size = int(max_file_size)
        self.max_preview_points = int(max_preview_points)
        self.mesh_preview_tris = int(mesh_preview_tris)
        # Hybrid JPEG ingest: eligible JPEGs ship DCT coefficients instead
        # of pixels (pipeline.graph.plan_jpeg_input).
        self.jpeg_device_decode = bool(jpeg_device_decode)
        # "grid" (exact depth-grid triangulation) | "poisson" | "bpa".
        self.mesh_method = mesh_method
        # Lazy export: point-format artifacts are written on the first
        # GET /download. Entries: job_id -> {fmt, base, points, colors,
        # nbytes, future}; a FIFO spill bounds their RAM.
        self.lazy_export = bool(lazy_export)
        self.lazy_export_max_bytes = int(lazy_export_max_bytes)
        self._pending_exports: "OrderedDict[str, dict]" = OrderedDict()
        self._pending_export_bytes = 0

        def _evict_artifacts(job):
            self._discard_pending_export(job.job_id)
            fp = ((job.results or {}).get("pointCloud") or {}).get("filepath")
            if fp and Path(fp).exists():
                Path(fp).unlink()

        self.jobs = JobRegistry(
            journal_path=self.output_dir / ".jobs.jsonl" if durable_jobs else None,
            max_jobs=max_jobs,
            on_evict=_evict_artifacts,
        )
        self.loaded_model_names: set[str] = set()
        self.executor = ThreadPoolExecutor(max_workers=4)
        self.batch_window_ms = batch_window_ms
        self.max_batch = max_batch
        self._batchers: dict[str, BatchingQueue] = {}
        self.warmup_sizes = warmup_sizes or []
        # Strong refs to in-flight job tasks (the loop holds weak ones).
        self._tasks: set = set()
        # The running torch.profiler session of /profile/start, if any;
        # started and stopped on the event loop's thread only.
        self._profiler = None
        self.router = self._build_router()

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def shutdown(self) -> None:
        """Stop the batching drains, write pending exports, stop the
        executor."""
        for batcher in self._batchers.values():
            await batcher.close()
        self._batchers.clear()
        if self._pending_exports:
            inflight = [
                e["future"]
                for e in self._pending_exports.values()
                if e["future"] is not None
            ]
            if inflight:
                await asyncio.gather(*inflight, return_exceptions=True)
            n = self.drain_pending_exports()
            logger.info("shutdown: wrote %d deferred artifacts", n)
        self.executor.shutdown(wait=False, cancel_futures=True)

    def warmup(self, model_name: str = "depth-anything-v2") -> None:
        """Build the model and capture the pipeline's graph of every batch
        bucket (``serve.batching.bucket_sizes``, the only sizes the
        batcher dispatches) at each warmup size, so that no request pays
        a capture, the kernel build or library autotuning; with
        ``jpeg_device_decode``, for the hybrid ingest too, from a
        synthesized photographic JPEG (the spec and capacities that
        ordinary uploads of the size get). A capture that fails raises.
        Blocking; call from a startup thread."""
        pipeline = self.models.get(model_name)
        self.loaded_model_names.add(model_name)
        buckets = bucket_sizes(self.max_batch)
        for h, w in self.warmup_sizes:
            plan = None
            if self.jpeg_device_decode:
                plan = plan_jpeg_input(_warmup_jpeg(h, w))
                if plan is None:
                    # A decline (no native library, or the sparse gate), not
                    # an error: say so, or the hybrid path stays cold silently.
                    logger.warning(
                        "Warmup JPEG %dx%d: plan_jpeg_input declined; the hybrid "
                        "ingest is not warmed for this size", h, w,
                    )
            for b in buckets:
                logger.info("Warmup %dx%d batch=%d (pixel)", h, w, b)
                pipeline.run_batch(np.zeros((b, h, w, 3), np.uint8), options=PipelineOptions())
                if plan is not None:
                    logger.info("Warmup %dx%d batch=%d (jpeg)", h, w, b)
                    pipeline.collect(pipeline.submit_batch_jpeg([plan] * b,
                                                                options=PipelineOptions()))
        logger.info("Warmup complete (%d sizes, buckets %s)", len(self.warmup_sizes), buckets)

    # ---------- pipeline task ----------

    async def _process_job(self, job_id: str, data: bytes, req: dict) -> None:
        jobs = self.jobs
        loop = asyncio.get_running_loop()
        timings: dict[str, float] = {}
        t_start = time.perf_counter()

        def _mark(stage, t0):
            timings[stage] = round(time.perf_counter() - t0, 4)

        try:
            await jobs.update(
                job_id, status=JobStatus.PROCESSING, progress=10,
                message="Loading AI model...",
            )
            model_name = req["model"]
            dummy = model_name in DUMMY_MODELS
            t0 = time.perf_counter()
            if not dummy:
                pipeline = await loop.run_in_executor(
                    self.executor, self.models.get, model_name
                )
            self.loaded_model_names.add(model_name)
            _mark("model_load", t0)

            await jobs.update(job_id, progress=20, message="Processing image...")
            t0 = time.perf_counter()
            image = None
            if self.jpeg_device_decode and not dummy:
                # Hybrid ingest: entropy-decode only; the pixels
                # materialize on the device. None for non-JPEGs,
                # unsupported streams and dense coefficients: those take
                # the host decode below.
                step = DENSITY_STRIDES[req["point_density"]]

                def _plan(d=data, s=step):
                    j = plan_jpeg_input(d)
                    if j is not None:
                        # Host grid colours here on the executor (cached),
                        # so the batcher's drain does not pay for them.
                        j.grid_colors(s)
                    return j

                image = await loop.run_in_executor(self.executor, _plan)
                if image is not None:
                    _mark("jpeg_plan", t0)
            if image is None:
                image = await loop.run_in_executor(self.executor, decode_image_rgb, data)
                _mark("decode", t0)

            opts = PipelineOptions(
                density=req["point_density"],
                invert_depth=req["invert_depth"],
                smooth_depth=req["smooth_depth"],
                smooth_ksize=req.get("smooth_ksize", 5),
                fov=(req.get("fov") if self.honor_fov else None),
            )

            res = None
            if dummy:
                await jobs.update(
                    job_id, progress=40, message=f"Processing with {model_name}..."
                )
                device = self.models.device
                points, colors = await loop.run_in_executor(
                    self.executor, dummy_point_cloud_graph, image,
                    req["point_density"], device,
                )
                demo = await loop.run_in_executor(
                    self.executor, demo_depth_map_graph, image, device
                )
                depth_data_url = png_data_url(demo)
            else:
                await jobs.update(
                    job_id, progress=40, message="Estimating depth with AI..."
                )
                batcher = self._batchers.get(model_name)
                if batcher is None:
                    batcher = BatchingQueue(
                        pipeline, window_ms=self.batch_window_ms, max_batch=self.max_batch
                    )
                    self._batchers[model_name] = batcher
                await jobs.update(
                    job_id, progress=60, message="Generating 3D point cloud..."
                )
                t0 = time.perf_counter()
                # Packed grids are host-assembled only for grid-mesh output.
                need_packed = (
                    req["output_format"].lower() in MESH_FORMATS
                    and self.mesh_method == "grid"
                )
                res = await batcher.submit(
                    image, req["depth_scale"], opts, want_packed=need_packed
                )
                _mark("inference_unproject_refine", t0)
                t0 = time.perf_counter()
                depth_data_url = png_data_url_palette(res.depth_preview_gray, PLASMA_RGB)
                _mark("preview_encode", t0)
                points, colors = res.points, res.colors

            await jobs.update(job_id, progress=80, message="Saving point cloud...")

            # Preview decimation (reference backend/app.py:496-506).
            if len(points) > self.max_preview_points:
                stride = max(1, len(points) // self.max_preview_points)
                pprev, cprev = points[::stride], colors[::stride]
            else:
                pprev, cprev = points, colors
            preview_points = _triplets_json(pprev)
            preview_colors = _triplets_json(cprev)

            fmt = req["output_format"].lower()
            mesh_preview = None
            base = str(self.output_dir / job_id)
            t0 = time.perf_counter()
            if fmt in MESH_FORMATS:
                filepath, mesh_preview = await loop.run_in_executor(
                    self.executor, self._export_mesh, base, res, points, colors
                )
            elif self.lazy_export:
                filepath = self._defer_export(job_id, fmt, points, colors, base)
            else:
                filepath = await loop.run_in_executor(
                    self.executor, self._export_points, base, fmt, points, colors
                )
            _mark("export", t0)
            timings["total"] = round(time.perf_counter() - t_start, 4)

            metadata = generate_gis_metadata(
                points,
                coordinate_system=req["coordinate_system"],
                model=model_name,
                output_format=req["output_format"],
                point_density=req["point_density"],
                depth_scale=req["depth_scale"],
                invert_depth=req["invert_depth"],
                smooth_depth=req["smooth_depth"],
                gps_coords=req.get("gps_coords"),
            )

            await jobs.update(
                job_id,
                status=JobStatus.COMPLETED,
                progress=100,
                message="Processing complete!",
                results={
                    "pointCloud": {
                        "filepath": filepath,
                        "points": len(points),
                        "format": req["output_format"].upper(),
                    },
                    "gisData": metadata,
                    "downloadUrl": f"/download/{job_id}",
                    "preview": {
                        "points": preview_points,
                        "colors": preview_colors,
                    },
                    "meshPreview": mesh_preview,
                    "depthMap": depth_data_url,
                },
            )
            job = jobs.get(job_id)
            if job is not None:
                job.extra["timings"] = timings
            m.JOBS_TOTAL.inc(api="v1", status="completed")
            m.JOB_DURATION.observe(timings["total"], api="v1")
            m.IMAGES_PROCESSED.inc(model=model_name)
        except Exception as e:  # noqa: BLE001 — a failed job reports, the server runs on
            logger.exception("Job %s failed", job_id)
            m.JOBS_TOTAL.inc(api="v1", status="error")
            await jobs.update(job_id, status=JobStatus.ERROR, message=f"Error: {e}")

    @staticmethod
    def _artifact_path(base: str, fmt: str) -> str:
        """Planned artifact path for a point format ('laz' writes
        uncompressed .las — bug-compatible, reference backend/app.py:319)."""
        ext = {"ply": ".ply", "las": ".las", "laz": ".las", "xyz": ".xyz"}.get(fmt)
        if ext is None:
            raise ValueError(f"Unsupported format: {fmt}")
        return base + ext

    def _defer_export(self, job_id, fmt, points, colors, base) -> str:
        """Register a pending lazy export; returns the planned filepath.
        Event-loop-only state."""
        filepath = self._artifact_path(base, fmt)  # validates fmt now
        nbytes = int(points.nbytes + colors.nbytes)
        self._pending_exports[job_id] = {
            "fmt": fmt,
            "base": base,
            "points": points,
            "colors": colors,
            "nbytes": nbytes,
            "future": None,
        }
        self._pending_export_bytes += nbytes
        # FIFO spill: write the oldest un-started entries out now.
        while self._pending_export_bytes > self.lazy_export_max_bytes:
            oldest = next(
                (jid for jid, e in self._pending_exports.items() if e["future"] is None),
                None,
            )
            if oldest is None or oldest == job_id:
                break
            self._start_export(oldest)
        return filepath

    def _start_export(self, job_id: str):
        """Start the executor export of a pending entry (idempotent);
        returns its future, or None if nothing is pending."""
        entry = self._pending_exports.get(job_id)
        if entry is None:
            return None
        if entry["future"] is None:
            fut = asyncio.get_running_loop().run_in_executor(
                self.executor,
                self._export_points,
                entry["base"],
                entry["fmt"],
                entry["points"],
                entry["colors"],
            )

            def _done(_f):
                if self._pending_exports.pop(job_id, None) is not None:
                    self._pending_export_bytes -= entry["nbytes"]

            fut.add_done_callback(_done)
            entry["future"] = fut
        return entry["future"]

    async def _ensure_exported(self, job_id: str) -> None:
        fut = self._start_export(job_id)
        if fut is not None:
            await asyncio.shield(fut)

    def _discard_pending_export(self, job_id: str) -> None:
        entry = self._pending_exports.pop(job_id, None)
        if entry is not None:
            self._pending_export_bytes -= entry["nbytes"]

    def drain_pending_exports(self) -> int:
        """Write every pending artifact now (graceful shutdown); blocking,
        returns the number written."""
        n = 0
        for job_id in list(self._pending_exports):
            entry = self._pending_exports.get(job_id)
            if entry is None or entry["future"] is not None:
                continue
            try:
                self._export_points(
                    entry["base"], entry["fmt"], entry["points"], entry["colors"]
                )
                n += 1
            except Exception:  # noqa: BLE001 — keep draining the rest
                logger.exception("drain: export for %s failed", job_id)
            self._discard_pending_export(job_id)
        return n

    def _export_points(self, base, fmt, points, colors) -> str:
        if fmt == "ply":
            return write_ply_points(base + ".ply", points, colors)
        if fmt in ("las", "laz"):
            return write_las(base + ".las", points, colors)
        if fmt == "xyz":
            return write_xyz(base + ".xyz", points, colors)
        raise ValueError(f"Unsupported format: {fmt}")

    def _export_mesh(self, base, res, points, colors):
        """mesh_ply path: surface reconstruction + decimated preview
        (reference backend/app.py:509-535)."""
        if self.mesh_method in ("poisson", "bpa"):
            from image_to_pointcloud_tpu_torch import native
            from image_to_pointcloud_tpu_torch.pipeline.meshing import reconstruct_cloud

            out = reconstruct_cloud(points, colors, method=self.mesh_method, depth=8)
            if out is None:
                if not native.available():
                    raise ValueError(
                        f"mesh_method={self.mesh_method} requires the native "
                        "reconstruction library"
                    )
                raise ValueError("Not enough points for meshing")
            verts, vcols, faces = out
            filepath = write_ply_mesh(
                base + ".ply", verts, faces, colors=vcols,
                normals=vertex_normals(verts, faces),
            )
            dv, dc, df = verts, vcols, faces
            if len(faces) > self.mesh_preview_tris:
                dec = native.decimate_mesh(verts, vcols, faces, self.mesh_preview_tris)
                if dec is not None:
                    dv, dc, df = dec
            return filepath, self._mesh_preview(dv, dc, df)

        if res is None:
            raise ValueError("Mesh output requires a depth model")
        verts, vcols, faces, _ = grid_mesh_from_packed(res.packed, res.grid_hw)
        filepath = write_ply_mesh(
            base + ".ply", verts, faces, colors=vcols,
            normals=vertex_normals(verts, faces),
        )
        dv, dc, df, _ = decimate_grid_mesh(res.packed, res.grid_hw, self.mesh_preview_tris)
        return filepath, self._mesh_preview(dv, dc, df)

    @staticmethod
    def _mesh_preview(dv, dc, df) -> dict:
        """meshPreview payload (reference app.py:518-535 shape); colors
        divided in f64, as the reference's doubles."""
        return {
            "vertices": _triplets_json(dv),
            "normals": _triplets_json(vertex_normals(dv, df)),
            "colors": _triplets_json(dc.astype(np.float64) / 255.0),
            "faces": _ints_json(df.reshape(-1)),
        }

    # ---------- routes ----------

    def _build_router(self) -> Router:
        r = Router()
        svc = self

        async def _prepare_output(rel: str) -> None:
            # Artifacts are flat "{job_id}.{ext}": write a deferred export
            # before the static handler looks for the file.
            await svc._ensure_exported(Path(rel).stem)

        r.mount_static("/outputs", self.output_dir, prepare=_prepare_output)

        @r.post("/process")
        async def process(req: Request):
            f = req.files.get("file")
            if f is None or not f.content_type.startswith("image/"):
                raise HTTPError(400, "File must be an image")
            data = f.data
            if len(data) > svc.max_file_size:
                raise HTTPError(
                    413,
                    f"File size ({len(data)/1024/1024:.1f}MB) exceeds maximum "
                    f"allowed size ({svc.max_file_size/1024/1024:.0f}MB)",
                )
            q = {**req.query, **req.form}
            d = svc.defaults
            try:
                request = {
                    "model": q.get("model", d.model),
                    "output_format": q.get("output_format", d.output_format),
                    "point_density": q.get("point_density", d.point_density),
                    "coordinate_system": q.get("coordinate_system", d.coordinate_system),
                    "invert_depth": _parse_bool(q.get("invert_depth"), d.invert_depth),
                    "depth_scale": float(q.get("depth_scale", d.depth_scale)),
                    "smooth_depth": _parse_bool(q.get("smooth_depth"), d.smooth_depth),
                    "fov": float(q.get("fov", d.fov)),
                }
            except ValueError as e:
                raise HTTPError(422, f"Invalid parameter value: {e}") from None
            job = await svc.jobs.create(message="Job queued", model=request["model"])
            svc._spawn(svc._process_job(job.job_id, data, request))
            return json_response({"job_id": job.job_id, "status": "queued"})

        @r.get("/status/{job_id}")
        async def status(req: Request):
            job = await svc.jobs.status_for(
                req.path_params["job_id"], req.query.get("wait_ms")
            )
            if job.status in (JobStatus.COMPLETED, JobStatus.ERROR):
                return Response(
                    headers={"content-type": "application/json"},
                    body=job.terminal_body(job.to_v1),
                )
            return json_response(job.to_v1())

        @r.get("/download/{job_id}")
        async def download(req: Request):
            job = svc.jobs.get(req.path_params["job_id"])
            if job is None:
                raise HTTPError(404, "Job not found")
            if job.status != JobStatus.COMPLETED:
                raise HTTPError(400, "Job not completed")
            filepath = job.results["pointCloud"]["filepath"]
            await svc._ensure_exported(job.job_id)
            if not Path(filepath).exists():
                raise HTTPError(404, "File not found")
            return await file_response(
                filepath,
                media_type="application/octet-stream",
                filename=Path(filepath).name,
            )

        @r.get("/models")
        async def models(req: Request):
            return json_response({"models": MODEL_CARDS})

        @r.get("/health")
        async def health(req: Request):
            return json_response(
                {
                    "status": "healthy",
                    "models_loaded": sorted(svc.loaded_model_names),
                    "active_jobs": len(svc.jobs),
                    "max_file_size_mb": svc.max_file_size / (1024 * 1024),
                }
            )

        @r.get("/openapi.json")
        async def openapi_doc(req: Request):
            from image_to_pointcloud_tpu_torch.serve.openapi import v1_openapi

            return json_response(v1_openapi())

        @r.get("/docs")
        async def docs_page(req: Request):
            from image_to_pointcloud_tpu_torch.serve.openapi import docs_html, v1_openapi

            return Response(
                headers={"content-type": "text/html; charset=utf-8"},
                body=docs_html(v1_openapi()).encode(),
            )

        @r.get("/timings/{job_id}")
        async def job_timings(req: Request):
            job = svc.jobs.get(req.path_params["job_id"])
            if job is None:
                raise HTTPError(404, "Job not found")
            return json_response(
                {"job_id": job.job_id, "timings": job.extra.get("timings", {})}
            )

        @r.get("/jobs")
        async def list_jobs(req: Request):
            try:
                limit = max(0, int(req.query.get("limit", 10)))
            except ValueError:
                raise HTTPError(422, "limit must be an integer")
            rows = [
                {
                    "job_id": j.job_id,
                    "status": j.status,
                    "progress": j.progress,
                    "created_at": j.created_at,
                    "model": j.model,
                }
                for j in svc.jobs.list(req.query.get("status"))
            ]
            rows.sort(key=lambda x: x["created_at"], reverse=True)
            return json_response({"jobs": rows[:limit], "total": len(rows)})

        @r.delete("/jobs/{job_id}")
        async def delete_job(req: Request):
            job_id = req.path_params["job_id"]
            job = svc.jobs.get(job_id)
            if not await svc.jobs.delete(job_id):
                raise HTTPError(404, "Job not found")
            svc._discard_pending_export(job_id)
            if job is not None and job.results:
                fp = (job.results.get("pointCloud") or {}).get("filepath")
                if fp and Path(fp).exists():
                    Path(fp).unlink()
            return json_response({"message": f"Job {job_id} deleted successfully"})

        @r.get("/metrics")
        async def metrics_route(req: Request):
            return Response(
                headers={"content-type": "text/plain; version=0.0.4"},
                body=m.REGISTRY.render().encode(),
            )

        @r.post("/profile/start")
        async def profile_start(req: Request):
            """Start a torch.profiler trace: CPU ops of this thread, and
            with CUDA every kernel on the card (CUPTI traces the device,
            whichever thread launched)."""
            trace_dir = svc.output_dir / "traces"
            if svc._profiler is not None:
                raise HTTPError(400, "A trace is already in progress")
            activities = [torch.profiler.ProfilerActivity.CPU]
            if svc.models.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            svc._profiler = torch.profiler.profile(activities=activities)
            svc._profiler.start()
            return json_response({"tracing": True, "dir": str(trace_dir)})

        @r.post("/profile/stop")
        async def profile_stop(req: Request):
            prof, svc._profiler = svc._profiler, None
            if prof is None:
                raise HTTPError(400, "No trace in progress")
            trace_dir = svc.output_dir / "traces"
            trace_dir.mkdir(parents=True, exist_ok=True)
            path = trace_dir / f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{id(prof):x}.json"

            # Stopped on the thread that started it (the event loop's):
            # the profiler is bound to its starting thread.
            prof.stop()
            await asyncio.get_running_loop().run_in_executor(
                svc.executor, prof.export_chrome_trace, str(path)
            )
            return json_response({"tracing": False, "trace": str(path)})

        return r


def _warmup_jpeg(h: int, w: int) -> bytes:
    """A q88 4:2:0 JPEG of photographic statistics (gradient fields plus
    noise), so the warmup plans the spec and capacities that ordinary
    uploads of this size get."""
    import io

    from PIL import Image

    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(0)
    frame = 96.0 + 64.0 * np.sin(xx / 37.0) + 48.0 * np.cos(yy / 23.0)
    frame = frame + rng.normal(0.0, 6.0, (h, w))
    frame = np.clip(frame, 0, 255).astype(np.uint8)[..., None].repeat(3, axis=-1)
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=88)
    return buf.getvalue()


def create_v1_app(**kwargs) -> V1Service:
    return V1Service(**kwargs)
