"""v2 service: the reference's "AI Point Cloud Generator API v2.0" contract
on the PyTorch pipeline.

Counterpart of ``image_to_pointcloud_tpu/serve/app_v2.py``, route for
route (reference backend/main.py:28-431) with :class:`Depth3DProcessor`
in the generator slot: ``GET /`` info, ``GET /models`` capability card,
``POST /process`` (Form params with the reference's clamping,
backend/main.py:258-267), ``GET /status/{job_id}``, ``GET
/download/{job_id}/{filename}`` with per-extension media types, ``GET
/jobs`` (sorted desc, limit), ``DELETE /jobs/{job_id}`` (+output dir
removal), ``/outputs`` static mount, and ``GET /health`` with the
``torch.cuda`` devices (backend/main.py:416-429).

Per-job output dirs hold ``mesh.glb`` / ``pointcloud.ply`` /
``metadata.json`` exactly like backend/main.py:166-184. :meth:`V2Service.startup`
loads the model in the executor after the server binds; until it is
loaded ``/process`` answers 503.
"""

from __future__ import annotations

import asyncio
import datetime
import json
import logging
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from image_to_pointcloud_tpu_torch.io.image import (
    decode_image_rgb,
    probe_image_size,
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
from image_to_pointcloud_tpu_torch.serve.models import ModelManager
from image_to_pointcloud_tpu_torch.serve.processor3d import Depth3DProcessor

logger = logging.getLogger(__name__)

MODEL_ID = "depth3d"

_MEDIA_TYPES = {
    ".glb": "model/gltf-binary",
    ".ply": "application/ply",
    ".json": "application/json",
    ".png": "image/png",
    ".jpg": "image/jpeg",
    ".jpeg": "image/jpeg",
}


class V2Service:
    def __init__(
        self,
        *,
        output_dir: str = "outputs",
        models: ModelManager | None = None,
        model_name: str = "depth-anything-v2",
        durable_jobs: bool = True,
        max_jobs: int | None = None,
        v2_defaults=None,
    ):
        from image_to_pointcloud_tpu_torch.core.config import V2Defaults

        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(exist_ok=True, parents=True)
        self.models = models or ModelManager()
        self.model_name = model_name
        # Form defaults + clamp ranges from the config tree
        # (core/config.py V2Defaults mirrors backend/main.py:206-267).
        self.v2cfg = v2_defaults or V2Defaults()
        self.processor: Depth3DProcessor | None = None
        # Durable registry (reference loses all jobs on restart —
        # SURVEY.md §5); per-job artifact dirs under outputs/ stay valid.
        def _evict_artifacts(job):
            out = self.output_dir / job.job_id
            if out.exists():
                shutil.rmtree(out, ignore_errors=True)

        self.jobs = JobRegistry(
            # Distinct from v1's .jobs.jsonl: both generations started
            # from one output dir must not share (and clobber) a journal.
            journal_path=(
                self.output_dir / ".jobs.v2.jsonl" if durable_jobs else None
            ),
            max_jobs=max_jobs,
            on_evict=_evict_artifacts,
        )
        self.executor = ThreadPoolExecutor(max_workers=2)
        # Strong refs to in-flight job tasks: the event loop only holds
        # weak ones, so a fire-and-forget task could be GC'd mid-job.
        self._tasks: set = set()
        self.router = self._build_router()

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def startup(self) -> None:
        """Load the generator (reference startup_event, backend/main.py:55-69);
        failure is tolerated and /process degrades to 503."""
        loop = asyncio.get_running_loop()
        try:
            pipeline = await loop.run_in_executor(
                self.executor, self.models.get, self.model_name
            )
            from image_to_pointcloud_tpu_torch.serve.matting import load_matte_model

            matte = await loop.run_in_executor(
                self.executor,
                load_matte_model,
                self.models.checkpoint_dir,
                self.models.device,
            )
            self.processor = Depth3DProcessor(pipeline, matte=matte)
            logger.info(
                "3D processor ready (%s; matte=%s)",
                self.model_name,
                "learned-segformer" if matte is not None else "classical",
            )
        except Exception as e:  # noqa: BLE001
            logger.error("Failed to initialize 3D processor: %s", e)

    async def shutdown(self) -> None:
        self.executor.shutdown(wait=True)

    async def _run_job(self, job_id: str, image: np.ndarray, settings: dict):
        jobs = self.jobs
        loop = asyncio.get_running_loop()
        try:
            await jobs.update(
                job_id, status=JobStatus.PROCESSING, progress=5,
                message="Initializing 3D generation...",
            )
            await jobs.update(
                job_id, progress=10, message="Preprocessing image...",
            )
            result = await loop.run_in_executor(
                self.executor,
                lambda: self.processor.generate(
                    image,
                    texture_resolution=settings["texture_resolution"],
                    guidance_scale=settings["guidance_scale"],
                    seed=settings["seed"],
                    remove_background=settings["remove_background"],
                    foreground_ratio=settings["foreground_ratio"],
                    remesh_option=settings["remesh_option"],
                    target_count=settings["target_count"],
                ),
            )
            await jobs.update(
                job_id, progress=70, message="Saving 3D assets...",
            )
            if jobs.get(job_id) is None:
                # DELETE /jobs/{id} raced the generation: writing the
                # artifacts now would recreate a dir no registry entry
                # references — undeletable, yet downloadable via the
                # /outputs static mount.
                logger.info("job %s deleted mid-generation; discarding", job_id)
                return
            out = self.output_dir / job_id

            def _write_artifacts():
                out.mkdir(exist_ok=True)
                (out / "mesh.glb").write_bytes(result["mesh_data"])
                p = None
                if result.get("point_cloud_data"):
                    p = out / "pointcloud.ply"
                    p.write_bytes(result["point_cloud_data"])
                (out / "metadata.json").write_text(
                    json.dumps(result["metadata"], indent=2)
                )
                return p

            # Multi-MB GLB/PLY writes off the event loop — same rule as
            # the upload decode below (1-core host, 1.5 s status polls).
            ply_path = await asyncio.get_running_loop().run_in_executor(
                self.executor, _write_artifacts
            )

            md = result["metadata"]
            results = {
                "mesh": {
                    "vertices": md["vertex_count"],
                    "faces": md["face_count"],
                    "has_textures": md["has_textures"],
                    "format": "GLB",
                    "generation_time": md["generation_time"],
                },
                "downloadUrl": f"/download/{job_id}/mesh.glb",
                "pointCloudUrl": (
                    f"/download/{job_id}/pointcloud.ply" if ply_path else None
                ),
                "metadataUrl": f"/download/{job_id}/metadata.json",
                "preview": result.get("preview_data", {}),
                "meshPreview": result.get("preview_data", {}).get("mesh", {}),
                "metadata": md,
            }
            await jobs.update(
                job_id,
                status=JobStatus.COMPLETED,
                progress=100,
                message="3D generation completed successfully!",
                results=results,
            )
            m.JOBS_TOTAL.inc(api="v2", status="completed")
            m.JOB_DURATION.observe(md["generation_time"], api="v2")
            m.IMAGES_PROCESSED.inc(model=MODEL_ID)
        except Exception as e:  # noqa: BLE001
            logger.exception("Job %s failed", job_id)
            m.JOBS_TOTAL.inc(api="v2", status="error")
            await jobs.update(job_id, status=JobStatus.ERROR, message=str(e))

    def _build_router(self) -> Router:
        r = Router()
        svc = self
        r.mount_static("/outputs", self.output_dir)

        @r.get("/")
        async def root(req: Request):
            return json_response(
                {
                    "message": "AI Point Cloud Generator API v2.0",
                    "status": "ready",
                    "models": {MODEL_ID: svc.processor is not None},
                    "features": [
                        "Professional 3D mesh generation",
                        "Textured GLB export",
                        "Point cloud generation",
                        "UV mapping",
                        "Material properties",
                        "Real-time preview",
                    ],
                    "timestamp": datetime.datetime.now().isoformat(),
                }
            )

        @r.get("/models")
        async def models(req: Request):
            cards = []
            if svc.processor is not None:
                cards.append(
                    {
                        "id": MODEL_ID,
                        "name": "Depth3D (GPU)",
                        "type": "image_to_3d",
                        "description": "Textured 3D mesh generation from single images via monocular depth on GPU",
                        "capabilities": [
                            "textured_mesh",
                            "point_cloud",
                            "uv_mapping",
                            "materials",
                            "normal_maps",
                        ],
                        "speed": "very_fast",
                        "quality": "high",
                        "available": True,
                        "outputs": ["glb", "ply"],
                        "recommended": True,
                    }
                )
            return json_response({"models": cards, "total": len(cards)})

        @r.post("/process")
        async def process(req: Request):
            form = req.form
            model = form.get("model", MODEL_ID)
            if model not in (MODEL_ID, "spar3d"):
                raise HTTPError(
                    400,
                    f"Model '{model}' not supported. Only '{MODEL_ID}' is available.",
                )
            if svc.processor is None:
                raise HTTPError(
                    503,
                    "3D processor not available. Please check server logs.",
                )
            f = req.files.get("file")
            if f is None:
                raise HTTPError(400, "Invalid image: no file uploaded")

            def _int(name, default):
                try:
                    return int(float(form.get(name, default)))
                except ValueError:
                    # FastAPI Form(int) 422s on unparsable values
                    # (backend/main.py:206-215) — silently substituting
                    # the default would run the job with settings the
                    # client never asked for.
                    raise HTTPError(
                        422, f"Invalid {name}: {form.get(name)!r}"
                    ) from None

            def _float(name, default):
                try:
                    return float(form.get(name, default))
                except ValueError:
                    raise HTTPError(
                        422, f"Invalid {name}: {form.get(name)!r}"
                    ) from None

            # Settings (incl. seed) validate BEFORE any job exists —
            # FastAPI's Form parsing 422s first (backend/main.py:206-215),
            # so a bad seed must not orphan a forever-pending job.
            seed_raw = form.get("seed")
            try:
                seed = (
                    int(float(seed_raw))
                    if seed_raw not in (None, "", "null")
                    else None
                )
            except ValueError:
                raise HTTPError(422, f"Invalid seed: {seed_raw!r}") from None
            c = svc.v2cfg  # core/config.py V2Defaults
            settings = {  # clamped like backend/main.py:258-267
                "output_format": form.get("output_format", "glb"),
                "texture_resolution": min(
                    max(
                        _int("texture_resolution", c.texture_resolution),
                        c.texture_resolution_range[0],
                    ),
                    c.texture_resolution_range[1],
                ),
                "guidance_scale": max(
                    c.guidance_scale_range[0],
                    min(
                        _float("guidance_scale", c.guidance_scale),
                        c.guidance_scale_range[1],
                    ),
                ),
                "seed": seed,
                "remove_background": form.get(
                    "remove_background", str(c.remove_background)
                ).lower() in ("1", "true", "yes", "on"),
                "foreground_ratio": max(
                    c.foreground_ratio_range[0],
                    min(
                        _float("foreground_ratio", c.foreground_ratio),
                        c.foreground_ratio_range[1],
                    ),
                ),
                "remesh_option": form.get("remesh_option", c.remesh_option),
                "target_count": max(
                    c.target_count_range[0],
                    min(
                        _int("target_count", c.target_count),
                        c.target_count_range[1],
                    ),
                ),
            }

            job = await svc.jobs.create(
                message="Starting 3D generation...", model=model
            )
            try:
                # Size check from the HEADER first: a few-MB crafted
                # 13000x13000 PNG would otherwise allocate ~500 MB in
                # the decode before being rejected (1-core host, OOM).
                ph, pw = probe_image_size(f.data)
                if ph * pw > svc.v2cfg.max_pixels:
                    raise ValueError(
                        "Image too large. Maximum resolution: 4096x4096"
                    )
                # PIL decode of a multi-MB upload takes real time on a
                # 1-core host; keep it off the event loop (v1 already
                # does, app_v1._process_job).
                image = await asyncio.get_running_loop().run_in_executor(
                    svc.executor, decode_image_rgb, f.data
                )
            except Exception as e:  # noqa: BLE001
                await svc.jobs.update(
                    job.job_id, status=JobStatus.ERROR,
                    message=f"Invalid image: {e}",
                )
                raise HTTPError(400, f"Invalid image: {e}") from None
            svc._spawn(svc._run_job(job.job_id, image, settings))
            return json_response(
                {
                    "job_id": job.job_id,
                    "status": "started",
                    "message": "3D generation started",
                    "estimated_time": "< 10 seconds",
                }
            )

        @r.get("/status/{job_id}")
        async def status(req: Request):
            # Reference contract: instant snapshot (backend/main.py:301-311).
            # Beyond-reference: ``?wait_ms=N`` long-polls the next state
            # change (jobs.JobRegistry.status_for) — same response shape.
            job = await svc.jobs.status_for(
                req.path_params["job_id"], req.query.get("wait_ms")
            )
            if job.status in (JobStatus.COMPLETED, JobStatus.ERROR):
                return Response(
                    headers={"content-type": "application/json"},
                    body=job.terminal_body(job.to_v2),
                )
            return json_response(job.to_v2())

        @r.get("/download/{job_id}/{filename}")
        async def download(req: Request):
            job_id = req.path_params["job_id"]
            filename = req.path_params["filename"]
            if job_id not in svc.jobs:
                raise HTTPError(404, "Job not found")
            path = svc.output_dir / job_id / filename
            if not path.exists():
                raise HTTPError(404, "File not found")
            media = _MEDIA_TYPES.get(path.suffix, "application/octet-stream")
            return await file_response(path, media_type=media, filename=filename)

        @r.get("/jobs")
        async def list_jobs(req: Request):
            try:
                limit = max(0, int(req.query.get("limit", 10)))
            except ValueError:
                raise HTTPError(422, "limit must be an integer")
            status_f = req.query.get("status")
            rows = [
                {
                    "job_id": j.job_id,
                    "status": j.status,
                    "progress": j.progress,
                    "created_at": j.created_at,
                    "model": j.model,
                }
                for j in svc.jobs.list(status_f)
            ]
            rows.sort(key=lambda x: x["created_at"], reverse=True)
            return json_response({"jobs": rows[:limit], "total": len(rows)})

        @r.delete("/jobs/{job_id}")
        async def delete_job(req: Request):
            job_id = req.path_params["job_id"]
            if not await svc.jobs.delete(job_id):
                raise HTTPError(404, "Job not found")
            out = svc.output_dir / job_id
            if out.exists():
                # ignore_errors like the eviction path: the registry
                # delete is already journaled; a half-failed rmtree must
                # not turn a committed deletion into a 500 + 404-on-retry.
                shutil.rmtree(out, ignore_errors=True)
            return json_response(
                {"message": f"Job {job_id} deleted successfully"}
            )

        @r.get("/metrics")
        async def metrics_route(req: Request):
            """Prometheus text exposition (framework observability)."""
            return Response(
                headers={"content-type": "text/plain; version=0.0.4"},
                body=m.REGISTRY.render().encode(),
            )

        @r.get("/openapi.json")
        async def openapi_doc(req: Request):
            """FastAPI auto-serves this on the reference app
            (serve/openapi.py mirrors backend/main.py:202-431)."""
            from image_to_pointcloud_tpu_torch.serve.openapi import v2_openapi

            return json_response(v2_openapi())

        @r.get("/docs")
        async def docs_page(req: Request):
            """Self-contained HTML API docs (the reference's FastAPI
            serves Swagger UI here; ours must work air-gapped)."""
            from image_to_pointcloud_tpu_torch.serve.openapi import (
                docs_html,
                v2_openapi,
            )

            return Response(
                headers={"content-type": "text/html; charset=utf-8"},
                body=docs_html(v2_openapi()).encode(),
            )

        @r.get("/health")
        async def health(req: Request):
            cuda = torch.cuda.is_available()
            n = torch.cuda.device_count() if cuda else 0
            return json_response(
                {
                    "status": "healthy",
                    "timestamp": datetime.datetime.now().isoformat(),
                    "services": {MODEL_ID: svc.processor is not None},
                    "system": {
                        "active_jobs": len(
                            svc.jobs.list(JobStatus.PROCESSING)
                        ),
                        "total_jobs": len(svc.jobs),
                        "output_dir_exists": svc.output_dir.exists(),
                    },
                    "accelerator": {
                        "available": cuda,
                        "platform": svc.models.device.type,
                        "device_count": n,
                        "devices": [torch.cuda.get_device_name(i) for i in range(n)],
                    },
                }
            )

        return r


def create_v2_app(**kwargs) -> V2Service:
    return V2Service(**kwargs)
