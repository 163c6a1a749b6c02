"""The port's v2 textured-asset path against the JAX package's, on the CPU.

The same tiny Depth-Anything-V2 weights (Flax init, carried by
``models/bridge.py``) in both packages' pipelines, through the f32
return. Tolerances:

* preprocessing (matte, crop, 512² LANCZOS resize): identical pixels;
* the pipeline on the processed frame: identical colours, keep bits
  agreeing on ≥ 99.5 % of points (the slice tolerance of PARITY.md: the
  outlier threshold flips a point on f32 noise), points within 1e-5 of
  the largest coordinate (f32 sums in another order);
* ``generate`` over one pipeline result: identical GLB and PLY bytes,
  vertices, faces, UVs, counts and preview (the processor is host code,
  copied). It is held over the JAX pipeline's result, because the grid
  mesh's depth-discontinuity cut (an edge longer than 3× the median edge)
  and the outlier threshold flip a triangle or a point on f32 noise: with
  each package's own pipeline the tiny model's vertex counts differ by one
  in ~51,000.
* ``estimate_background_matte``, ``foreground_crop``, ``_camera_uvs``:
  identical.

The HTTP flow mirrors tests/test_serve.py's ``TestV2`` on a live
first-party server in this process.
"""

from __future__ import annotations

import asyncio
import json
import struct
import sys
import threading
import time
from pathlib import Path

import httpx
import numpy as np
import pytest

from image_to_pointcloud_tpu_torch.io.image import encode_png

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_model import _flax_pair  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    return _flax_pair(layers=4, out_layers=(0, 1, 2, 3))


def _frame(seed: int = 3) -> np.ndarray:
    """A 96² frame: noise on a near-white border around a red block, so
    the classical matte and the foreground crop have work to do."""
    r = np.random.default_rng(seed)
    img = r.integers(225, 256, (96, 96, 3)).astype(np.uint8)
    img[30:70, 25:75] = r.integers(0, 256, (40, 50, 3)).astype(np.uint8) // 2 + [100, 0, 0]
    return img


def _processors(pair):
    from image_to_pointcloud_tpu.pipeline.graph import DepthPipeline as JPipe
    from image_to_pointcloud_tpu.serve.processor3d import Depth3DProcessor as JProc
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline
    from image_to_pointcloud_tpu_torch.serve.processor3d import Depth3DProcessor

    jcfg, params, model = pair
    return (JProc(JPipe(jcfg, params, quantized_transfer=False, model_target=56)),
            Depth3DProcessor(DepthPipeline(model, model_target=56, quantized_transfer=False)))


class _Fixed:
    """A pipeline whose ``run`` returns one given result (the JAX
    pipeline's, as the port's PipelineResult)."""

    def __init__(self, res):
        from image_to_pointcloud_tpu_torch.pipeline.graph import PipelineResult

        self.res = PipelineResult(
            points=res.points, colors=res.colors, depth_preview_rgb=res.depth_preview_rgb,
            raw_point_count=res.raw_point_count, kept_point_count=res.kept_point_count,
            packed=res.packed, grid_hw=res.grid_hw)

    def run(self, image, **_):
        return self.res


@pytest.mark.parametrize("kw", [
    dict(remove_background=True, foreground_ratio=1.3, remesh_option="none", seed=4),
    dict(remove_background=False, remesh_option="triangle", target_count=1500, seed=None,
         texture_resolution=512),
], ids=["matte-grid", "remesh"])
def test_generate_matches_jax(pair, kw):
    from image_to_pointcloud_tpu.pipeline.graph import PipelineOptions as JOpts
    from image_to_pointcloud_tpu_torch.pipeline.graph import PipelineOptions

    jproc, proc = _processors(pair)
    img = _frame()
    rb, ratio = kw["remove_background"], kw.get("foreground_ratio", 1.3)
    processed = proc._preprocess(img, rb, ratio)
    np.testing.assert_array_equal(processed, jproc._preprocess(img, rb, ratio))

    ref_res = jproc.pipeline.run(processed, depth_scale=2.2, options=JOpts(density="medium"))
    res = proc.pipeline.run(processed, depth_scale=2.2, options=PipelineOptions(density="medium"))
    assert res.grid_hw == ref_res.grid_hw == (256, 256)
    np.testing.assert_array_equal(res.packed[3:6], ref_res.packed[3:6])
    assert ((res.packed[6] > 0.5) == (ref_res.packed[6] > 0.5)).mean() >= 0.995
    scale = np.abs(ref_res.packed[:3]).max()
    np.testing.assert_allclose(res.packed[:3] / scale, ref_res.packed[:3] / scale, rtol=0,
                               atol=1e-5)

    ref = jproc.generate(img, **kw)
    proc.pipeline = _Fixed(ref_res)
    out = proc.generate(img, **kw)
    assert out["mesh_data"] == ref["mesh_data"]
    assert out["point_cloud_data"] == ref["point_cloud_data"]
    # The same sampled vertices and points, serialized alike.
    from image_to_pointcloud_tpu.serve.rawjson import dumps_raw as jdumps
    from image_to_pointcloud_tpu_torch.serve.rawjson import dumps_raw

    assert dumps_raw(out["preview_data"]) == jdumps(ref["preview_data"])
    meta = {k: v for k, v in out["metadata"].items() if k != "generation_time"}
    assert meta == {k: v for k, v in ref["metadata"].items() if k != "generation_time"}
    assert meta["vertex_count"] > 1000 and meta["face_count"] > 1000


def test_host_helpers_match_jax():
    from image_to_pointcloud_tpu.serve import processor3d as jp
    from image_to_pointcloud_tpu_torch.serve import processor3d as tp

    img = _frame(5)
    a = tp.estimate_background_matte(img)
    np.testing.assert_array_equal(a, jp.estimate_background_matte(img))
    assert 0.05 < (a > 0.5).mean() < 0.9
    for ratio in (1.0, 1.3, 2.5):
        np.testing.assert_array_equal(tp.foreground_crop(img, a, ratio),
                                      jp.foreground_crop(img, a, ratio))
    assert tp.foreground_crop(img, np.zeros_like(a), 1.3) is img
    verts = np.random.default_rng(1).normal(0, 1, (500, 3)).astype(np.float32)
    verts[:, 2] = np.abs(verts[:, 2]) + 0.5
    verts[0, 2] = 0.0  # z clamps to 1e-6
    np.testing.assert_array_equal(
        tp.Depth3DProcessor(None)._camera_uvs(verts, (512, 384)),
        jp.Depth3DProcessor(None)._camera_uvs(verts, (512, 384)),
    )


# ---------- the v2 HTTP service ----------


def _manager(pair):
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    mm = ModelManager("cpu")
    mm._cache["depth-anything-v2"] = DepthPipeline(pair[2], model_target=56)
    return mm


class _V2Server:
    """The port's v2 app behind the first-party HTTP server on a private
    event-loop thread; ``startup`` runs only when asked."""

    def __init__(self, out_dir, manager):
        from image_to_pointcloud_tpu_torch.serve.app_v2 import create_v2_app
        from image_to_pointcloud_tpu_torch.serve.http import HttpServer

        self.loop = asyncio.new_event_loop()
        self.app = create_v2_app(output_dir=str(out_dir), models=manager, durable_jobs=True)
        self.server = HttpServer(self.app.router, "127.0.0.1", 0)
        self.loop.run_until_complete(self.server.start())
        self.base = f"http://127.0.0.1:{self.server.bound_port}"
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def startup(self):
        asyncio.run_coroutine_threadsafe(self.app.startup(), self.loop).result(120)

    def stop(self):
        async def _shutdown():
            await self.server.stop()
            await self.app.shutdown()

        asyncio.run_coroutine_threadsafe(_shutdown(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        self.app.jobs.close()


@pytest.fixture(scope="module")
def v2(pair, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_v2")
    srv = _V2Server(out, _manager(pair))
    # Before startup the model is not loaded: /process answers 503 and
    # creates no job; /health already answers.
    r = httpx.post(f"{srv.base}/process", data={"model": "depth3d"},
                   files={"file": ("t.png", _png(), "image/png")}, timeout=30)
    assert r.status_code == 503, r.text
    health = httpx.get(f"{srv.base}/health", timeout=30).json()
    assert health["services"]["depth3d"] is False and health["system"]["total_jobs"] == 0
    srv.startup()
    yield srv
    srv.stop()


def _png(h=70, w=63):
    return encode_png(np.random.default_rng(7).integers(0, 256, (h, w, 3)).astype(np.uint8))


def _poll(base, job_id, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        r = httpx.get(f"{base}/status/{job_id}", timeout=30)
        assert r.status_code == 200
        data = r.json()
        if data["status"] in ("completed", "error"):
            return data
        time.sleep(0.1)
    raise TimeoutError(f"job {job_id} did not finish")


def test_v2_root_models_health(v2):
    data = httpx.get(f"{v2.base}/", timeout=30).json()
    assert data["status"] == "ready" and data["models"]["depth3d"] is True
    m = httpx.get(f"{v2.base}/models", timeout=30).json()
    assert m["total"] == 1 and m["models"][0]["id"] == "depth3d"
    h = httpx.get(f"{v2.base}/health", timeout=30).json()
    assert h["status"] == "healthy" and h["services"]["depth3d"] is True
    assert h["accelerator"]["platform"] == "cpu"
    assert h["accelerator"]["device_count"] == len(h["accelerator"]["devices"])


def test_v2_generation_flow(v2):
    data = {"model": "depth3d", "texture_resolution": "4096", "guidance_scale": "20",
            "foreground_ratio": "1.3", "remove_background": "true", "target_count": "2000",
            "remesh_option": "none", "seed": "3"}
    r = httpx.post(f"{v2.base}/process", data=data,
                   files={"file": ("t.png", _png(128, 128), "image/png")}, timeout=60)
    assert r.status_code == 200, r.text
    body = r.json()
    assert body["status"] == "started"
    final = _poll(v2.base, body["job_id"])
    assert final["status"] == "completed", final["message"]
    res = final["results"]
    assert res["mesh"]["format"] == "GLB"
    assert res["metadata"]["texture_resolution"] == 2048  # clamped
    assert res["metadata"]["guidance_scale"] == 10.0  # clamped
    assert res["metadata"]["seed"] == 3

    glb = httpx.get(f"{v2.base}{res['downloadUrl']}", timeout=30)
    assert glb.status_code == 200 and glb.headers["content-type"] == "model/gltf-binary"
    assert glb.content[:4] == b"glTF"
    doc = json.loads(glb.content[20: 20 + struct.unpack("<I", glb.content[12:16])[0]])
    prim = doc["meshes"][0]["primitives"][0]
    assert "TEXCOORD_0" in prim["attributes"] and doc.get("images")
    assert doc["accessors"][prim["attributes"]["POSITION"]]["count"] == res["mesh"]["vertices"]
    ply = httpx.get(f"{v2.base}{res['pointCloudUrl']}", timeout=30)
    assert ply.status_code == 200 and ply.headers["content-type"] == "application/ply"
    assert ply.content[:3] == b"ply"
    meta = httpx.get(f"{v2.base}{res['metadataUrl']}", timeout=30).json()
    assert meta["vertex_count"] == res["mesh"]["vertices"]
    assert meta["face_count"] == res["mesh"]["faces"]
    s = httpx.get(f"{v2.base}/outputs/{body['job_id']}/mesh.glb", timeout=30)
    assert s.status_code == 200 and s.content == glb.content
    assert httpx.get(f"{v2.base}/download/{body['job_id']}/nope.glb", timeout=30).status_code == 404

    jl = httpx.get(f"{v2.base}/jobs", timeout=30).json()
    assert body["job_id"] in [j["job_id"] for j in jl["jobs"]]
    assert (Path(v2.app.output_dir) / ".jobs.v2.jsonl").exists()
    dl = httpx.delete(f"{v2.base}/jobs/{body['job_id']}", timeout=30)
    assert "deleted successfully" in dl.json()["message"]
    assert httpx.get(f"{v2.base}/status/{body['job_id']}", timeout=30).status_code == 404
    assert not (Path(v2.app.output_dir) / body["job_id"]).exists()
    assert httpx.delete(f"{v2.base}/jobs/{body['job_id']}", timeout=30).status_code == 404


def test_v2_rejects_bad_requests(v2):
    before = httpx.get(f"{v2.base}/jobs", timeout=30).json()["total"]
    r = httpx.post(f"{v2.base}/process", data={"model": "depth3d", "seed": "abc"},
                   files={"file": ("t.png", _png(), "image/png")}, timeout=30)
    assert r.status_code == 422
    r = httpx.post(f"{v2.base}/process", data={"model": "other"},
                   files={"file": ("t.png", _png(), "image/png")}, timeout=30)
    assert r.status_code == 400
    r = httpx.post(f"{v2.base}/process", data={"model": "depth3d"}, timeout=30)
    assert r.status_code == 400
    assert httpx.get(f"{v2.base}/jobs", timeout=30).json()["total"] == before  # no orphan


def test_v2_delete_during_generation_discards_artifacts(v2):
    """A DELETE that lands while the job generates: the job's artifacts
    are never written (no undeletable output directory)."""
    started, release = threading.Event(), threading.Event()
    real = v2.app.processor.generate

    def slow(*a, **k):
        started.set()
        assert release.wait(60)
        return real(*a, **k)

    v2.app.processor.generate = slow
    try:
        r = httpx.post(f"{v2.base}/process", data={"model": "depth3d"},
                       files={"file": ("t.png", _png(), "image/png")}, timeout=30)
        job = r.json()["job_id"]
        assert started.wait(60)
        assert httpx.delete(f"{v2.base}/jobs/{job}", timeout=30).status_code == 200
        release.set()
        deadline = time.time() + 60
        while any(not t.done() for t in v2.app._tasks) and time.time() < deadline:
            time.sleep(0.05)
        assert not v2.app._tasks
    finally:
        v2.app.processor.generate = real
    assert not (Path(v2.app.output_dir) / job).exists()


def test_v2_openapi_matches_router(tmp_path):
    import re

    from image_to_pointcloud_tpu_torch.serve.app_v2 import V2Service
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager
    from image_to_pointcloud_tpu_torch.serve.openapi import v2_openapi

    svc = V2Service(output_dir=str(tmp_path), models=ModelManager("cpu"), durable_jobs=False)
    routed = {re.sub(r"\(\?P<(\w+)>\[\^/\]\+\)", r"{\1}", p.pattern.strip("^$"))
              for _m, p, _fn in svc.router._routes}
    doc = v2_openapi()
    for path in doc["paths"]:
        assert path in routed, f"{path} documented but not routed"
    form = doc["paths"]["/process"]["post"]["requestBody"]["content"][
        "multipart/form-data"]["schema"]["properties"]
    assert form["texture_resolution"]["minimum"] == 512
    assert form["target_count"]["maximum"] == 20000


def test_v2_entry_point_starts_and_stops(tmp_path):
    """``python -m image_to_pointcloud_tpu_torch.serve --generation v2
    --device cpu``: it binds, loads DA-V2-Small (random init) after binding,
    warns that ``--jpeg-device-decode`` is a v1 option, answers /health,
    and exits 0 on SIGTERM."""
    import os
    import re
    import signal
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if k not in ("IPC_TPU_MESH", "IPC_TPU_CONFIG", "IPC_TPU_CHECKPOINT_DIR")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "image_to_pointcloud_tpu_torch.serve", "--generation", "v2",
         "--device", "cpu", "--port", "0", "--output-dir", str(tmp_path / "out"),
         "--jpeg-device-decode"],
        cwd=Path(__file__).resolve().parents[1], env=env, stderr=subprocess.PIPE, text=True,
    )
    try:
        lines = []
        port = None
        deadline = time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stderr.readline()
            assert line, "".join(lines)
            lines.append(line)
            m = re.search(r"Serving v2 API on [\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port, "".join(lines)
        assert any("--jpeg-device-decode applies to --generation v1 only" in ln for ln in lines)
        while time.time() < deadline:
            h = httpx.get(f"http://127.0.0.1:{port}/health", timeout=30).json()
            if h["services"]["depth3d"]:
                break
            time.sleep(0.2)
        assert h["services"]["depth3d"] is True and h["accelerator"]["platform"] == "cpu"
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        proc.stderr.close()
    assert rc == 0
