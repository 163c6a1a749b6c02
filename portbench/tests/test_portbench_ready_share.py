"""``pipeline.d2h_ready_share.serve``: the share of the window's collects
whose device→host copy had already completed when the collect began.
It reads nothing in the traced tiny serving run on the CPU (the CPU copies
nothing from a device) and stays silent on the records of a program that
has no such counters. Its run uses the cell's fixed run directory, as
``test_portbench_run.py``'s do: run the portbench tests in one process."""

import json

import pytest

from portbench import spec
from portbench.tests.test_portbench_run import _serve, tiny_presets  # noqa: F401

READY = "pipeline.d2h_ready_share.serve"


def test_ready_share_is_a_serving_pipeline_metric():
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == READY)
    assert entry["layer"] == "pipeline" and entry["moves"] == "within_150ms_share"
    assert entry["workloads"] == ["dav2s-serve"]


def test_ready_share_reads_the_window_change_of_its_counters():
    """Ready collects over collects of a device copy, over the window; None
    where no collect read a device copy (the CPU) or without the counters."""
    read = spec.metric_reader(READY)
    before = {"ipc_d2h_collects_total": 10.0, "ipc_d2h_ready_total": 1.0}
    after = {"ipc_d2h_collects_total": 50.0, "ipc_d2h_ready_total": 3.0}
    assert read({"server_metrics": {"before": before, "after": after}}) == pytest.approx(2 / 40)
    assert read({"server_metrics": {"before": {}, "after": after}}) == pytest.approx(3 / 50)
    assert read({"server_metrics": {"before": before, "after": before}}) is None
    assert read({"server_metrics": {"before": {}, "after": {"ipc_d2h_bytes_total": 9.0}}}) is None


def test_ready_share_silent_on_a_program_without_its_counters(tmp_path):
    """The records of a program that has none of the new counters: the
    reader returns None (and raises nothing)."""
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.collect", "ts": 0, "dur": 5.0}]}))
    series = {"ipc_inference_batch_size_sum": 4.0, "ipc_inference_batch_size_count": 4.0,
              "ipc_d2h_bytes_total": 100.0}
    rec = {"timings": {0: {"inference_unproject_refine": 0.01, "total": 0.02}},
           "client_ms": {0: 50.0},
           "server_metrics": {"before": dict(series), "after": {k: 2 * v for k, v in series.items()}},
           "trace_path": str(trace), "traffic": {"batch": 16}}
    assert spec.metric_reader(READY)(rec) is None
    assert spec.metric_reader(READY)({}) is None


def test_serve_traced_run_on_the_cpu_omits_the_ready_share(tiny_presets, tmp_path):  # noqa: F811
    """The CPU's outputs are host tensors: no collect read a device copy,
    so the traced run's line leaves the metric out."""
    out = _serve(tmp_path, trace=True)
    assert out["correct"] is True
    assert READY not in out["metrics"]
