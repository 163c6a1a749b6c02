"""First-party metrics: counters + histograms with Prometheus exposition.

The reference's only observability is log narration and the per-job
``progress`` integer (SURVEY.md §5: no metrics, no tracing; its
``python-json-logger`` dep is declared but never imported). This module
gives the serving runtime production metrics with zero dependencies:
``GET /metrics`` renders the standard text exposition format any
Prometheus/Grafana stack scrapes.

Thread-safe via a single lock per registry — metric updates are a few
dict ops, far off the serving hot path's critical section.

The stages of a request or a batch are timed and counted where the work
runs, by :mod:`image_to_pointcloud_tpu_torch.utils.spans` (whose ``span``
and ``record`` this module re-exports for the serving code): this
registry observes every recorded stage into ``ipc_stage_seconds{stage=…}``
and renders that module's totals as the counters
``ipc_graph_captures_total``, ``ipc_h2d_bytes_total`` and
``ipc_d2h_bytes_total``.
"""

from __future__ import annotations

import threading
from typing import Iterable

from image_to_pointcloud_tpu_torch.utils import spans
from image_to_pointcloud_tpu_torch.utils.spans import record, span

__all__ = ["Counter", "Histogram", "MetricsRegistry", "REGISTRY", "record", "span"]

# Latency buckets (seconds) spanning cached-graph requests (~ms) through
# first-compile requests (minutes).
DEFAULT_BUCKETS = (
    0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0
)


def _esc(v: str) -> str:
    """Escape a label value per the exposition format."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    """Exact rendering: '%g' keeps only 6 significant digits, which
    quantizes counters past ~1e6 (rate() plateaus). Integers render
    exactly; floats use repr (shortest round-trippable form)."""
    if float(v).is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


class _Metric:
    def __init__(self, name: str, help_: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help_
        self._lock = registry._lock
        registry._metrics.append(self)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_, registry):
        super().__init__(name, help_, registry)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def render(self) -> Iterable[str]:
        for key, v in sorted(self._values.items()):
            yield f"{self.name}{_fmt_labels(dict(key))} {_fmt_value(v)}"


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, registry, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_, registry)
        self.buckets = tuple(buckets)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def render(self) -> Iterable[str]:
        for key, counts in sorted(self._counts.items()):
            labels = dict(key)
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                yield (
                    f"{self.name}_bucket"
                    f"{_fmt_labels({**labels, 'le': format(b, 'g')})} {cum}"
                )
            cum += counts[-1]
            yield f"{self.name}_bucket{_fmt_labels({**labels, 'le': '+Inf'})} {cum}"
            yield f"{self.name}_count{_fmt_labels(labels)} {cum}"
            yield f"{self.name}_sum{_fmt_labels(labels)} {_fmt_value(self._sums[key])}"


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: list[_Metric] = []

    def counter(self, name: str, help_: str = "") -> Counter:
        return Counter(name, help_, self)

    def histogram(self, name: str, help_: str = "", buckets=DEFAULT_BUCKETS) -> Histogram:
        return Histogram(name, help_, self, buckets)

    def render(self) -> str:
        lines: list[str] = []
        with self._lock:
            for m in self._metrics:
                lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
                lines.extend(m.render())
        return "\n".join(lines) + "\n"


# Process-wide default registry with the serving runtime's metrics.
REGISTRY = MetricsRegistry()
HTTP_REQUESTS = REGISTRY.counter(
    "ipc_http_requests_total", "HTTP requests by method/path-class/status"
)
HTTP_LATENCY = REGISTRY.histogram(
    "ipc_http_request_seconds", "HTTP request handling latency"
)
JOBS_TOTAL = REGISTRY.counter(
    "ipc_jobs_total", "Jobs reaching a terminal state, by api/status"
)
JOB_DURATION = REGISTRY.histogram(
    "ipc_job_seconds", "End-to-end job duration by api"
)
IMAGES_PROCESSED = REGISTRY.counter(
    "ipc_images_processed_total", "Images through the depth pipeline"
)
BATCH_SIZE = REGISTRY.histogram(
    "ipc_inference_batch_size",
    "Micro-batch sizes dispatched to the accelerator",
    buckets=(1, 2, 4, 8, 16, 32, 64),
)
DRAIN_SUBMIT = REGISTRY.histogram(
    "ipc_drain_submit_seconds",
    "Device dispatch (pack, H2D, replay) per micro-batch drain, the executor's queue included",
)
DRAIN_COLLECT = REGISTRY.histogram(
    "ipc_drain_collect_seconds",
    "Result collection (device wait, D2H, unbundle) per drain, the executor's queue included",
)
STAGE_SECONDS = REGISTRY.histogram(
    "ipc_stage_seconds",
    "Seconds of each leaf stage of a request or a batch, by stage (the spans)",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 1.0, 10.0),
)
spans.OBSERVERS.append(lambda name, seconds: STAGE_SECONDS.observe(seconds, stage=name))


class _Total(_Metric):
    """A counter whose total :mod:`utils.spans` keeps, so that the
    pipeline counts without importing the serving layer. Renders from 0."""

    kind = "counter"

    def render(self) -> Iterable[str]:
        yield f"{self.name} {_fmt_value(spans.total(self.name))}"


# Distinct series (not one counter with labels): a reader that sums label
# sets still tells them apart.
GRAPH_CAPTURES = _Total(
    "ipc_graph_captures_total", "CUDA graph captures, of any owner's signatures", REGISTRY
)
H2D_BYTES = _Total(
    "ipc_h2d_bytes_total",
    "Bytes of the payloads DepthPipeline hands to its graphs (padding rows included)",
    REGISTRY,
)
D2H_BYTES = _Total(
    "ipc_d2h_bytes_total", "Bytes that DepthPipeline.collect copies from the device", REGISTRY
)


_KNOWN_CLASSES: set[str] = set()
_MAX_PATH_CLASSES = 64  # hard cardinality cap for client-chosen paths


def path_class(path: str) -> str:
    """Collapse per-job paths so label cardinality stays bounded.

    UUID-ish/filename segments become ``{id}``; once the number of
    distinct classes hits the cap, any new path collapses to ``other``
    (a crawler probing random URLs cannot grow the registry unboundedly).
    """
    parts = path.split("/")
    out = []
    for p in parts:
        out.append("{id}" if len(p) >= 16 or "." in p else p)
    cls = "/".join(out) or "/"
    if cls in _KNOWN_CLASSES:
        return cls
    if len(_KNOWN_CLASSES) >= _MAX_PATH_CLASSES:
        return "other"
    _KNOWN_CLASSES.add(cls)
    return cls
