"""What the program itself records, as the per-layer metrics read it:
the stages of each served request (its ``/timings/{id}``, in seconds) and
the program's spans in a ``torch.profiler`` Chrome trace (its
``record_function`` ranges, ``user_annotation`` events)."""

from __future__ import annotations

import json
import statistics
from pathlib import Path


def request_ms(rec: dict, keys: "tuple[str, ...]") -> "float | None":
    """The median over the window's requests of the sum of their stages
    ``keys`` (those a request has), in ms; None where no request has any."""
    sums = [1e3 * sum(t[k] for k in keys if k in t)
            for t in rec.get("timings", {}).values() if any(k in t for k in keys)]
    return statistics.median(sums) if sums else None


def leaves_s(timings: dict) -> float:
    """The sum of a request's leaf stages: its keys named ``layer.stage``
    (the coarser stages have no dot)."""
    return sum(v for k, v in timings.items() if "." in k)


def _ranges(path: str) -> dict:
    """Chrome trace → {range name: [duration in µs, …]} of its
    ``user_annotation`` events."""
    out: dict = {}
    for e in json.loads(Path(path).read_text()).get("traceEvents", []):
        if e.get("cat") == "user_annotation" and "dur" in e:
            out.setdefault(e["name"], []).append(float(e["dur"]))
    return out


def batch_range_ms_per_image(rec: dict, name: str) -> "float | None":
    """The mean duration of the trace's ``name`` ranges, one a batch of
    the traffic's ``batch`` images, over that batch, in ms an image; None
    where the trace has no such range."""
    path, batch = rec.get("trace_path"), (rec.get("traffic") or {}).get("batch")
    if not path or not batch:
        return None
    durs = _ranges(str(path)).get(name)
    if not durs:
        return None
    return 1e-3 * sum(durs) / len(durs) / batch
