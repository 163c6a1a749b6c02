"""The per-layer metrics that read the program's own spans and counters:
each reads a number in the traced tiny runs of both drivers on the CPU
(``pipeline.captures.serve`` reads 0: the warmup captured nothing the
window uses, and the CPU captures none), and each stays silent on the
records of a program that has no such span or counter. Its runs use the
cells' fixed run directories, as ``test_portbench_run.py``'s do: run the
portbench tests in one process."""

import json

import pytest

from portbench import spec
from portbench.program_spans import batch_range_ms_per_image, leaves_s, request_ms
from portbench.tests.test_portbench_run import _bulk, _serve, tiny_presets  # noqa: F401

BENCH = spec.benchmark()
SERVE = [m["name"] for m in BENCH["per_layer"] if m["name"] in {
    "batching.wait_ms.serve", "jobs.wait_ms.serve", "jobs.work_ms.serve",
    "http.status_body_ms.serve", "http.download_ms.serve", "http_jobs.unexplained_ms.serve",
    "pipeline.captures.serve", "pipeline.h2d_kb.serve", "pipeline.d2h_kb.serve"}]
BULK = ["pipeline.pack_ms.bulk", "pipeline.d2h_wait_ms.bulk", "pipeline.unbundle_ms.bulk"]


def test_serve_traced_run_reads_the_program_spans(tiny_presets, tmp_path):  # noqa: F811
    out = _serve(tmp_path, trace=True)
    assert out["correct"] is True
    got = {k: out["metrics"][k]["value"] for k in SERVE if k in out["metrics"]}
    assert set(got) == set(SERVE) and len(SERVE) == 9, got
    assert got["pipeline.captures.serve"] == 0
    assert all(v > 0 for k, v in got.items() if k != "pipeline.captures.serve"), got


def test_bulk_traced_run_reads_the_program_spans(tiny_presets, tmp_path):  # noqa: F811
    out = _bulk(tmp_path, trace=True)
    assert out["correct"] is True
    got = {k: out["metrics"][k]["value"] for k in BULK if k in out["metrics"]}
    assert set(got) == set(BULK) and all(v > 0 for v in got.values()), got


def test_readers_arithmetic(tmp_path):
    timings = {0: {"batch.wait": 0.002, "job.decode": 0.001, "decode": 0.0011},
               1: {"batch.wait": 0.004, "job.jpeg_plan": 0.003},
               2: {"total": 0.01}}
    rec = {"timings": timings, "client_ms": {0: 10.0, 1: 20.0, 2: 5.0}}
    assert request_ms(rec, ("batch.wait",)) == pytest.approx(3.0)
    assert request_ms(rec, ("job.decode", "job.jpeg_plan")) == pytest.approx(2.0)
    assert leaves_s(timings[0]) == pytest.approx(0.003)
    assert spec.metric_reader("http_jobs.unexplained_ms.serve")(rec) == pytest.approx(
        (10.0 - 3.0 + 20.0 - 7.0) / 2)
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "pipeline.pack", "ts": 0, "dur": 800.0},
        {"ph": "X", "cat": "user_annotation", "name": "pipeline.pack", "ts": 5, "dur": 1600.0},
        {"ph": "X", "cat": "cpu_op", "name": "pipeline.pack", "ts": 5, "dur": 9999.0}]}))
    rec = {"trace_path": str(trace), "traffic": {"batch": 4}}
    assert batch_range_ms_per_image(rec, "pipeline.pack") == pytest.approx(1.2 / 4)
    assert batch_range_ms_per_image(rec, "pipeline.unbundle") is None


@pytest.mark.parametrize("metric", SERVE + BULK)
def test_silent_on_a_program_without_spans_or_counters(metric, tmp_path):
    """The records of a program that has none of the new stages, series or
    ranges: the reader returns None (and raises nothing)."""
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.collect", "ts": 0, "dur": 5.0}]}))
    series = {"ipc_inference_batch_size_sum": 4.0, "ipc_inference_batch_size_count": 4.0}
    rec = {"timings": {0: {"inference_unproject_refine": 0.01, "total": 0.02}},
           "client_ms": {0: 50.0},
           "server_metrics": {"before": dict(series), "after": {k: 2 * v for k, v in series.items()}},
           "trace_path": str(trace), "traffic": {"batch": 16}}
    assert spec.metric_reader(metric)(rec) is None
