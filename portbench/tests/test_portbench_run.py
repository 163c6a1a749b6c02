"""Whole runs of the harness on the CPU at tiny sizes (the port's plain
versions): the result object's keys, ``correct`` against the reference,
``correct`` false when the timed path is broken underneath (half the
batch left out and the rest repeated in its place, or an answer altered
where it is produced), no result when the server process loaded JAX,
and the knee sweep's runs."""

import json
import os

import numpy as np
import pytest

from portbench import run, spec
from portbench.compare import load_limits
from portbench.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
SEED = 2**31 + 77


def _workload(cell: str, tmp_path, preset: str, traffic: dict) -> dict:
    w = spec.workload(cell)
    cfg = tiny.config(preset)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return {**w, "config": cfg, "config_path": path, "traffic": traffic}


@pytest.fixture
def tiny_presets():
    tiny.register_presets()


def _bulk(tmp_path, trace: bool) -> dict:
    w = _workload("dptl-bulk", tmp_path, "portbench-tiny-dpt", tiny.bulk_traffic())
    return run.execute(w, seed=SEED, seconds=0.6, trace=trace, device="cpu")


def test_bulk_run(tiny_presets, tmp_path):
    out = _bulk(tmp_path, trace=False)
    assert set(out) == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"img_s", "setup_s"}
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(load_limits(spec.HERE, "dptl-bulk"))
    json.dumps(out)


def test_bulk_traced_run_reports_its_host_metrics(tiny_presets, tmp_path):
    out = _bulk(tmp_path, trace=True)
    assert out["correct"] is True
    # No device on the CPU: the device readers find nothing and stay silent.
    assert {"pipeline.submit_ms.bulk", "pipeline.collect_ms.bulk", "mfu.bulk"} <= set(out["metrics"])
    assert "k1_roofline.bulk" not in out["metrics"]


def _break_collect(monkeypatch, fault: str):
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline

    collect = DepthPipeline.collect

    def broken(self, handle, **kw):
        res = collect(self, handle, **kw)
        if fault == "half_batch":
            half = len(res) // 2
            res = res[:half] * 2 + res[2 * half:]
        else:
            res[0].points = res[0].points * np.float32(1.25)
        return res

    monkeypatch.setattr(DepthPipeline, "collect", broken)


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_bulk_fault_is_not_correct(tiny_presets, tmp_path, monkeypatch, fault):
    _break_collect(monkeypatch, fault)
    tr = tiny.bulk_traffic()
    tr.update(sample=64)  # every collected cloud compared, so the broken ones are among them
    w = _workload("dptl-bulk", tmp_path, "portbench-tiny-dpt", tr)
    out = run.execute(w, seed=SEED, seconds=0.4, trace=False, device="cpu")
    assert out["correct"] is False


def _serve_env(tmp_path, extra_site: str = "") -> dict:
    site = tiny.site_dir(tmp_path, extra_site)
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), str(spec.ROOT)]))


def _serve(tmp_path, extra_site: str = "", trace: bool = False) -> dict:
    tr = tiny.serve_traffic()
    if extra_site:
        tr.update(sample=64)
    w = _workload("dav2s-serve", tmp_path, "portbench-tiny-da", tr)
    env = _serve_env(tmp_path, extra_site)
    return run.execute(w, seed=SEED, seconds=1.0, trace=trace, device="cpu", env=env)


def test_serve_run(tiny_presets, tmp_path):
    out = _serve(tmp_path, trace=True)
    assert set(out) == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] == 4
    assert {"http_jobs.host_ms.serve", "batching.mean_drain.serve", "pipeline.drain_ms.serve",
            "latency_p50_ms.serve"} <= set(out["metrics"])


ALTER = """
import numpy as np
from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline
_collect = DepthPipeline.collect
def _altered(self, handle, **kw):
    res = _collect(self, handle, **kw)
    res[0].points = res[0].points * np.float32(1.25)
    return res
DepthPipeline.collect = _altered
"""


def test_serve_altered_answer_is_not_correct(tiny_presets, tmp_path):
    out = _serve(tmp_path, ALTER)
    assert out["correct"] is False
    assert set(out["metrics"]) == {"within_150ms_share", "setup_s"}


LOAD_JAX = """
import sys, types
from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline
_collect = DepthPipeline.collect
def _loads_jax(self, handle, **kw):
    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return _collect(self, handle, **kw)
DepthPipeline.collect = _loads_jax
"""


def test_serve_server_that_loaded_jax_gives_no_result(tiny_presets, tmp_path):
    with pytest.raises(run.LoadedForbidden, match="jax"):
        _serve(tmp_path, LOAD_JAX)


def test_knee_sweep_runs(tiny_presets, tmp_path):
    from portbench import knee

    w = _workload("dav2s-serve", tmp_path, "portbench-tiny-da", tiny.serve_traffic())
    plan = {"runs": 2, "seconds": 1.0, "ended_within_s": 60.0}
    rows = list(knee.sweep(w, plan, [3.0], SEED, device="cpu", env=_serve_env(tmp_path)))
    assert [(r["rate_per_s"], r["seed"], r["attempted"], r["failed"]) for r in rows] == [
        (3.0, SEED, 3, 0), (3.0, SEED + 1, 3, 0)]
    assert all(r["p50_ms"] > 0 and isinstance(r["passes"], bool) for r in rows)
    json.dumps(rows)
