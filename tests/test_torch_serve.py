"""The PyTorch port's v1 service on the CPU, and the port's import hygiene.

A live first-party HTTP server runs the port's V1Service over a tiny
random-init model; requests follow the reference frontend's shapes.
"""

from __future__ import annotations

import asyncio
import io
import subprocess
import sys
import threading
import time
from pathlib import Path

import httpx
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.io import read_ply
from image_to_pointcloud_tpu_torch.io.image import encode_png

REPO = Path(__file__).resolve().parents[1]


def _tiny_manager(**pipeline_kw):
    from image_to_pointcloud_tpu_torch.models.depth_anything import (
        DepthAnything,
        DepthAnythingConfig,
        init_weights,
    )
    from image_to_pointcloud_tpu_torch.models.dinov2 import DinoV2Config
    from image_to_pointcloud_tpu_torch.models.dpt import DPTConfig
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    cfg = DepthAnythingConfig(
        backbone=DinoV2Config(
            hidden_size=32, num_layers=2, num_heads=2, pos_embed_size=4,
            out_layers=(0, 1, 1, 1),
        ),
        neck=DPTConfig(
            hidden_size=32, neck_hidden_sizes=(8, 16, 32, 32),
            fusion_hidden_size=16, head_hidden_size=8,
        ),
    )
    model = init_weights(DepthAnything(cfg), torch.Generator().manual_seed(0))
    mm = ModelManager("cpu")
    mm._cache["depth-anything-v2"] = DepthPipeline(model, model_target=56, **pipeline_kw)
    return mm


class _ServerThread:
    """An HttpServer + the port's v1 app on a private event-loop thread."""

    def __init__(self, out_dir, manager=None, **app_kw):
        from image_to_pointcloud_tpu_torch.serve.http import HttpServer
        from image_to_pointcloud_tpu_torch.serve.app_v1 import create_v1_app

        self.loop = asyncio.new_event_loop()
        self.app = create_v1_app(
            output_dir=str(out_dir), models=manager or _tiny_manager(), **app_kw
        )
        self.server = HttpServer(self.app.router, "127.0.0.1", 0)
        self.loop.run_until_complete(self.server.start())
        self.port = self.server.bound_port
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

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
def base(tmp_path_factory):
    srv = _ServerThread(tmp_path_factory.mktemp("torch_v1"))
    yield f"http://127.0.0.1:{srv.port}"
    srv.stop()


@pytest.fixture(scope="module")
def jpeg_base(tmp_path_factory):
    """The hybrid JPEG ingest, with the card's default return (the
    quantized bundle) forced on the CPU."""
    srv = _ServerThread(
        tmp_path_factory.mktemp("torch_v1_jpeg"),
        _tiny_manager(quantized_transfer=True),
        jpeg_device_decode=True,
    )
    yield f"http://127.0.0.1:{srv.port}"
    srv.stop()


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


def _png(h, w, seed=7):
    rng = np.random.default_rng(seed)
    return encode_png(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))


@pytest.mark.parametrize(
    "fmt,hw", [("ply", (70, 63)), ("xyz", (40, 52)), ("mesh_ply", (48, 48))]
)
def test_process_status_download(base, fmt, hw):
    r = httpx.post(
        f"{base}/process?output_format={fmt}&point_density=medium&depth_scale=15",
        files={"file": ("t.png", _png(*hw), "image/png")},
        timeout=60,
    )
    assert r.status_code == 200, r.text
    assert r.json()["status"] == "queued"
    final = _poll(base, r.json()["job_id"])
    assert final["status"] == "completed", final["message"]
    res = final["results"]
    n = res["pointCloud"]["points"]
    assert 0 < n <= -(-hw[0] // 2) * -(-hw[1] // 2)
    assert res["depthMap"].startswith("data:image/png;base64,")
    assert len(res["preview"]["points"]) == len(res["preview"]["colors"]) == n
    dl = httpx.get(f"{base}{res['downloadUrl']}", timeout=60)
    assert dl.status_code == 200 and len(dl.content) > 0
    if fmt == "ply":
        vert = read_ply(dl.content)["vertex"]
        xyz = np.stack([vert["x"], vert["y"], vert["z"]], axis=1)
        assert xyz.shape == (n, 3) and np.isfinite(xyz).all()
    if fmt == "mesh_ply":
        assert len(res["meshPreview"]["faces"]) > 0


def _jpeg(h, w, seed=0):
    from PIL import Image

    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    img = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 127 // (h + w)], -1)
    img = np.clip(img + rng.integers(0, 24, (h, w, 3)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=88)
    return buf.getvalue()


@pytest.mark.parametrize(
    "upload,ctype,stage",
    [(lambda: _jpeg(88, 120), "image/jpeg", "jpeg_plan"),
     (lambda: _png(70, 63), "image/png", "decode")],
)
def test_jpeg_device_decode_server(jpeg_base, upload, ctype, stage):
    """A q88 JPEG takes the device decode and a PNG the host decode; both
    return a valid PLY."""
    from image_to_pointcloud_tpu_torch import native

    if ctype == "image/jpeg" and not native.available():
        pytest.skip("the native library (g++ build) is unavailable")
    r = httpx.post(
        f"{jpeg_base}/process?output_format=ply&point_density=medium&depth_scale=15",
        files={"file": ("t", upload(), ctype)},
        timeout=60,
    )
    assert r.status_code == 200, r.text
    job = r.json()["job_id"]
    final = _poll(jpeg_base, job)
    assert final["status"] == "completed", final["message"]
    timings = httpx.get(f"{jpeg_base}/timings/{job}", timeout=30).json()["timings"]
    (other,) = {"jpeg_plan", "decode"} - {stage}
    assert stage in timings and other not in timings
    n = final["results"]["pointCloud"]["points"]
    vert = read_ply(httpx.get(f"{jpeg_base}/download/{job}", timeout=60).content)["vertex"]
    xyz = np.stack([vert["x"], vert["y"], vert["z"]], axis=1)
    assert xyz.shape == (n, 3) and n > 0 and np.isfinite(xyz).all()


def test_batcher_groups_pixels_and_jpegs():
    """Pixel and hybrid-JPEG items queued together drain as separate
    groups, each through its own submit, and every waiter gets its own
    image's result."""
    from image_to_pointcloud_tpu_torch.pipeline.graph import PipelineOptions, plan_jpeg_input
    from image_to_pointcloud_tpu_torch.serve.batching import BatchingQueue

    jpeg = plan_jpeg_input(_jpeg(88, 120))
    if jpeg is None:
        pytest.skip("the native library (g++ build) is unavailable")
    pipe = _tiny_manager(quantized_transfer=True).get("depth-anything-v2")
    pixels = np.random.default_rng(0).integers(0, 256, (40, 52, 3), dtype=np.uint8)

    async def run():
        queue = BatchingQueue(pipe, window_ms=50.0)
        try:
            return await asyncio.wait_for(asyncio.gather(
                queue.submit(jpeg, 15.0, PipelineOptions()),
                queue.submit(pixels, 15.0, PipelineOptions()),
                queue.submit(jpeg, 5.0, PipelineOptions()),
            ), timeout=120)
        finally:
            await queue.close()

    a, b, c = asyncio.run(run())
    assert a.grid_hw == c.grid_hw == (44, 60) and b.grid_hw == (20, 26)
    assert len(a.points) == len(c.points) > 0 and len(b.points) > 0
    # The two JPEG items differ only by depth scale: z scales with it.
    np.testing.assert_allclose(c.points[:, 2].sum() * 3.0, a.points[:, 2].sum(), rtol=1e-3)


def test_concurrent_requests_share_batches(base):
    """Concurrent same-size uploads all complete (the batcher coalesces
    them into shared pipeline calls)."""
    ids = []
    for seed in range(4):
        r = httpx.post(
            f"{base}/process?output_format=ply",
            files={"file": ("t.png", _png(40, 40, seed), "image/png")},
            timeout=60,
        )
        ids.append(r.json()["job_id"])
    for jid in ids:
        assert _poll(base, jid)["status"] == "completed"


def _dummy_job(base, model, img):
    r = httpx.post(
        f"{base}/process?model={model}&output_format=ply&point_density=medium",
        files={"file": ("t.png", encode_png(img), "image/png")},
        timeout=30,
    )
    assert r.status_code == 200, r.text
    final = _poll(base, r.json()["job_id"])
    assert final["status"] == "completed", final["message"]
    return final


def test_unported_paths_answer_501(base):
    """The dummy models and /profile, which the port once refused with
    HTTP 501, now answer as the JAX server does."""
    img = np.random.default_rng(3).integers(0, 256, (20, 20, 3), dtype=np.uint8)
    assert _dummy_job(base, "triposr", img)["results"]["pointCloud"]["points"] == 25
    r = httpx.post(f"{base}/profile/start", timeout=30)
    assert r.status_code == 200, r.text
    assert httpx.post(f"{base}/profile/stop", timeout=60).status_code == 200


@pytest.mark.parametrize("model", ["triposr", "instantmesh"])
def test_dummy_models_match_jax(base, model):
    """The dummy graphs' points, colours and demo preview through the
    server are bit-identical to the JAX package's graphs."""
    import jax.numpy as jnp

    from image_to_pointcloud_tpu.io.image import png_data_url
    from image_to_pointcloud_tpu.pipeline import graph as jgraph

    img = np.random.default_rng(4).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    final = _dummy_job(base, model, img)
    pts, cols = jgraph.dummy_point_cloud_graph(img, "medium")
    res = final["results"]
    assert res["pointCloud"]["points"] == len(pts)
    vert = read_ply(httpx.get(f"{base}{res['downloadUrl']}", timeout=60).content)["vertex"]
    np.testing.assert_array_equal(np.stack([vert["x"], vert["y"], vert["z"]], axis=1), pts)
    np.testing.assert_array_equal(
        np.stack([vert["red"], vert["green"], vert["blue"]], axis=1), cols.astype(np.uint8)
    )
    demo = np.asarray(jgraph.demo_depth_map_graph(jnp.asarray(img)))
    assert res["depthMap"] == png_data_url(demo)


def test_profile_writes_a_trace(tmp_path):
    """/profile/start → a request → /profile/stop writes a Chrome trace
    under <output_dir>/traces."""
    import json

    srv = _ServerThread(tmp_path)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        assert httpx.post(f"{base}/profile/start", timeout=30).status_code == 200
        assert httpx.post(f"{base}/profile/start", timeout=30).status_code == 400
        r = httpx.post(
            f"{base}/process?output_format=ply",
            files={"file": ("t.png", _png(40, 40), "image/png")},
            timeout=30,
        )
        assert _poll(base, r.json()["job_id"])["status"] == "completed"
        r = httpx.post(f"{base}/profile/stop", timeout=60)
        assert r.status_code == 200, r.text
        trace = Path(r.json()["trace"])
        assert trace.parent == tmp_path / "traces" and trace.exists()
        assert "traceEvents" in json.loads(trace.read_text())
    finally:
        srv.stop()


def test_profile_stop_without_start_is_400(base):
    r = httpx.post(f"{base}/profile/stop", timeout=30)
    assert r.status_code == 400 and "No trace in progress" in r.text


def test_contract_routes(base):
    models = httpx.get(f"{base}/models", timeout=30).json()["models"]
    assert [m["id"] for m in models] == ["depth-anything-v2", "triposr", "instantmesh"]
    assert httpx.get(f"{base}/health", timeout=30).json()["status"] == "healthy"
    r = httpx.post(
        f"{base}/process", files={"file": ("t.txt", b"x", "text/plain")}, timeout=30
    )
    assert r.status_code == 400
    r = httpx.post(
        f"{base}/process?depth_scale=abc",
        files={"file": ("t.png", _png(20, 20), "image/png")},
        timeout=30,
    )
    assert r.status_code == 422
    assert httpx.get(f"{base}/download/nope", timeout=30).status_code == 404


def test_port_imports_no_jax():
    """Every module of the port, the server and CLI entry points, the int8
    encoder, the advanced pipelines, ``parallel/``, the v2 server (with
    its processor, matte and SegFormer) and ``train/`` included, imports
    without JAX, Flax, transformers or safetensors (none of them is on the
    card machine), and without any module of the JAX package. A
    subprocess, because this test process has JAX loaded
    (tests/conftest.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import image_to_pointcloud_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in ('serve.__main__', '__main__', 'cli', 'models.quantize', 'ops.voxel',\n"
        "          'parallel.tiling', 'pipeline.advanced', 'io.glb', 'io.obj', 'io.pcd',\n"
        "          'serve.app_v2', 'serve.processor3d', 'serve.matting', 'models.segformer',\n"
        "          'train.losses', 'train.eval', 'train.data', 'train.checkpoint',\n"
        "          'train.trainer'):\n"
        "    assert 'image_to_pointcloud_tpu_torch.' + m in names, (m, names)\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'transformers', 'safetensors',\n"
        "              'image_to_pointcloud_tpu'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _port_sources() -> list[str]:
    files = sorted(p.relative_to(REPO).as_posix()
                   for p in (REPO / "image_to_pointcloud_tpu_torch").rglob("*.py"))
    return ["chip_smoke.py", "tools/profile_torch_pipeline.py", *files]


@pytest.mark.parametrize("rel", _port_sources())
def test_port_source_is_standalone(rel):
    """No import of the JAX package (``image_to_pointcloud_tpu`` or any of
    its submodules, relative imports resolved), and no call of
    ``scaled_dot_product_attention`` outside ``chip_smoke.py``, whose
    timings use it as the yardstick of K1."""
    import ast

    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    pkg = rel.removesuffix(".py").replace("/", ".").rsplit(".", 1)[0]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = pkg.split(".")[: len(pkg.split(".")) - node.level + 1]
                base = ".".join([*parts, base] if base else parts)
            mods = [base]
        else:
            mods = []
        for mod in mods:
            assert mod.split(".")[0] != "image_to_pointcloud_tpu", (
                f"{rel}:{node.lineno} imports {mod}")
        if rel != "chip_smoke.py" and isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            assert name != "scaled_dot_product_attention", f"{rel}:{node.lineno} calls SDPA"


def test_server_refuses_unported_flags(tmp_path):
    """The mesh from ``--mesh``, ``IPC_TPU_MESH`` or a config file's
    ``"mesh"`` (the JAX server's sources): ``data=1`` is accepted, builds
    the mesh over the CPU and serves /health; ``data=2`` needs more slots
    than the one CPU device and is refused with that error."""
    import json
    import os
    import re
    import signal

    import httpx

    env = {k: v for k, v in os.environ.items() if k not in ("IPC_TPU_MESH", "IPC_TPU_CONFIG")}

    def sources(spec):
        cfg_file = tmp_path / f"config_{spec.replace('=', '')}.json"
        cfg_file.write_text(json.dumps({"mesh": spec}))
        return [
            (["--jpeg-device-decode", "--checkpoint-dir", "ckpt", "--mesh", spec], {}),
            (["--jpeg-device-decode"], {"IPC_TPU_MESH": spec}),
            ([], {"IPC_TPU_CONFIG": str(cfg_file)}),
        ]

    def start(i, args, extra_env):
        return subprocess.Popen(
            [sys.executable, "-m", "image_to_pointcloud_tpu_torch.serve", "--device", "cpu",
             "--port", "0", "--output-dir", str(tmp_path / f"out{i}"), *args],
            cwd=REPO, stderr=subprocess.PIPE, text=True, env={**env, **extra_env},
        )

    servers = [start(i, a, e) for i, (a, e) in enumerate(sources("data=1"))]
    refused = [start(3 + i, a, e) for i, (a, e) in enumerate(sources("data=2"))]
    try:
        for proc in servers:
            lines, port = [], None
            deadline = time.time() + 120
            while port is None and time.time() < deadline:
                line = proc.stderr.readline()
                assert line, "".join(lines)
                lines.append(line)
                m = re.search(r"Serving v1 API on [\d.]+:(\d+) \(cpu, mesh (.*)\)", line)
                port = int(m.group(1)) if m else None
            assert port, "".join(lines)
            assert m.group(2) == "{'data': 1, 'model': 1, 'seq': 1}"
            assert httpx.get(f"http://127.0.0.1:{port}/health", timeout=30).status_code == 200
    finally:
        for proc in servers:
            proc.send_signal(signal.SIGTERM)
    for proc in servers:
        assert proc.wait(timeout=60) == 0
        proc.stderr.close()
    for proc in refused:
        err = proc.communicate(timeout=120)[1]
        assert proc.returncode == 2, err
        assert "--mesh data=2: mesh (data=2, model=1, seq=1) needs 2 slots: more slots than " \
               "devices (1 given)" in err
        assert "not ported" not in err
