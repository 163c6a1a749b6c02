"""The port's spans and counters on the CPU: the span helper with and
without a profiler, a served request's stages in ``/timings``, the
program's ranges in ``/profile``'s trace, and the graph-capture and
copy-byte counters.

The v1 server is ``test_torch_serve.py``'s, over its tiny model.
"""

from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import httpx
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_serve import _png, _poll, _ServerThread, _tiny_manager  # noqa: E402

from image_to_pointcloud_tpu_torch.serve import metrics  # noqa: E402
from image_to_pointcloud_tpu_torch.utils import spans  # noqa: E402

# A depth request's leaf spans (serve/app_v1.py), in the order they run.
LEAVES = [
    "http.upload", "job.start_wait", "job.status_updates", "job.executor_wait",
    "job.model_get", "job.decode", "batch.wait", "pipeline.pack", "pipeline.replay",
    "pipeline.collect_wait", "pipeline.d2h_wait", "pipeline.unbundle", "job.resume_wait",
    "job.preview_png", "job.preview_json", "job.export", "job.metadata", "http.status_body",
    "http.download_export", "http.download_send",
]
# The batcher's stages, contiguous from the enqueue to the job's resumption.
CHAIN = LEAVES[LEAVES.index("batch.wait"):LEAVES.index("job.resume_wait") + 1]


def _user_ranges(path) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for e in json.loads(Path(path).read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append(e)
    return out


def _stage_count(name: str) -> int:
    return sum(metrics.STAGE_SECONDS._counts.get((("stage", name),), []))


def test_pipeline_layer_imports_nothing_of_serve():
    """The pipeline times and counts through utils/spans.py, and imports
    nothing of the serving layer above it."""
    import ast

    pkg = Path(__file__).resolve().parents[1] / "image_to_pointcloud_tpu_torch"
    for path in sorted((pkg / "pipeline").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [a.name for a in node.names] if isinstance(node, ast.Import) else [])
            assert not any(n.startswith("image_to_pointcloud_tpu_torch.serve") for n in names), (
                path.name, names)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    srv = _ServerThread(tmp_path_factory.mktemp("torch_spans"))
    yield srv, f"http://127.0.0.1:{srv.port}"
    srv.stop()


def _request(base) -> tuple[str, dict]:
    r = httpx.post(
        f"{base}/process?output_format=ply&point_density=medium&depth_scale=15",
        files={"file": ("t.png", _png(40, 52), "image/png")},
        timeout=60,
    )
    assert r.status_code == 200, r.text
    job = r.json()["job_id"]
    assert _poll(base, job)["status"] == "completed"
    assert httpx.get(f"{base}/download/{job}", timeout=60).status_code == 200
    return job, httpx.get(f"{base}/timings/{job}", timeout=30).json()["timings"]


def test_span_without_a_profiler_records_and_opens_no_range():
    into: dict = {}
    before = _stage_count("test.span")
    with metrics.span("test.span", into) as sp:
        assert sp._range is None
        sum(range(1000))
    assert into["test.span"] == sp.seconds > 0
    assert sp.end() == sp.seconds  # closed once
    metrics.record("test.span", 0.5, into)
    assert into["test.span"] == sp.seconds + 0.5
    assert _stage_count("test.span") == before + 2


def test_span_of_an_executor_thread_is_in_an_all_threads_trace(tmp_path):
    from torch._C._profiler import _ExperimentalConfig

    def work():
        with metrics.span("test.executor_span") as sp:
            torch.ones(8).sum()
        return sp._range is not None

    with ThreadPoolExecutor(1) as ex, torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=_ExperimentalConfig(profile_all_threads=True),
    ) as prof:
        assert ex.submit(work).result(timeout=30)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    assert "test.executor_span" in _user_ranges(tmp_path / "t.json")


def test_served_request_has_every_leaf_span(server):
    _, base = server
    _, t = _request(base)
    missing = [k for k in LEAVES if k not in t]
    assert not missing, (missing, t)
    assert all(t[k] >= 0 for k in LEAVES)
    # The existing coarse stages stay.
    assert {"model_load", "decode", "inference_unproject_refine", "preview_encode", "export",
            "total"} <= set(t)
    chain, whole = sum(t[k] for k in CHAIN), t["inference_unproject_refine"]
    assert abs(chain - whole) <= max(2e-3, 0.05 * whole), (chain, whole)
    text = httpx.get(f"{base}/metrics", timeout=30).text
    for series in ("ipc_graph_captures_total", "ipc_h2d_bytes_total", "ipc_d2h_bytes_total"):
        assert f"\n{series} " in text
    assert 'ipc_stage_seconds_count{stage="pipeline.unbundle"}' in text


def test_profile_trace_holds_the_program_spans(server):
    srv, base = server
    assert httpx.post(f"{base}/profile/start", timeout=30).status_code == 200
    _request(base)
    r = httpx.post(f"{base}/profile/stop", timeout=60)
    assert r.status_code == 200, r.text
    ranges = _user_ranges(r.json()["trace"])
    assert {"job.decode", "pipeline.unbundle", "pipeline.pack", "http.upload"} <= set(ranges)
    # Executor threads' spans: another thread than the event loop's.
    loop_tid = ranges["http.upload"][0]["tid"]
    assert ranges["job.decode"][0]["tid"] != loop_tid


def test_graph_captures_count_once_a_signature(monkeypatch):
    """A new signature captures once; its later calls replay and count
    none. The capture and the replay are stood in for on the CPU."""
    from image_to_pointcloud_tpu_torch.pipeline import graph

    def capture(self, staged):
        self.static_in, self.graph = tuple(staged), object()

    monkeypatch.setattr(graph._CompiledGraph, "_capture", capture)
    monkeypatch.setattr(graph._CompiledGraph, "_replay", lambda self, staged: self.run(*staged))
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    pipe = _tiny_manager().get("depth-anything-v2")
    pipe.cuda_graphs = True
    rng = np.random.default_rng(1)
    img, other = (rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in [(40, 52), (36, 36)])
    before = spans.total("ipc_graph_captures_total")
    counts = []
    for batch in ([img], [img], [img, img], [other], [img]):
        pipe.collect(pipe.submit_batch(batch))
        counts.append(spans.total("ipc_graph_captures_total") - before)
    assert counts == [1, 1, 2, 3, 3]
    shown = metrics.REGISTRY.render().split("\nipc_graph_captures_total ")[1].split()[0]
    assert int(shown) == spans.total("ipc_graph_captures_total")


@pytest.mark.parametrize("quantized", [True, False])
def test_copy_byte_counters_equal_the_payload_and_the_bundle(quantized):
    pipe = _tiny_manager(quantized_transfer=quantized).get("depth-anything-v2")
    imgs = [np.random.default_rng(s).integers(0, 256, (40, 52, 3), dtype=np.uint8)
            for s in range(3)]
    h2d, d2h = spans.total("ipc_h2d_bytes_total"), spans.total("ipc_d2h_bytes_total")
    handle = pipe.submit_batch(imgs, depth_scales=15.0)
    payload = pipe.pack_payload(np.stack(imgs), np.full(3, 15.0, np.float32))
    assert spans.total("ipc_h2d_bytes_total") - h2d == payload.nbytes
    results = pipe.collect(handle)
    copied = handle.out.numpy().nbytes + handle.preview.numpy().nbytes
    assert spans.total("ipc_d2h_bytes_total") - d2h == copied
    assert len(results) == 3
    assert set(handle.stages) == {"pipeline.pack", "pipeline.replay", "pipeline.d2h_wait",
                                  "pipeline.unbundle"}
