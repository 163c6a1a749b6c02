"""Records of a run: the harness's spans, the server's /metrics text, and
the reduction of a ``torch.profiler`` Chrome trace to busy time, kernel
time by name and idle gaps named by what the host was doing."""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host-clock spans around the harness's calls into the program;
    under a profiler each is also a ``record_function`` range, so the
    trace can name what the host did in a device gap."""

    def __init__(self):
        self.rows: list[dict] = []
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        rf = None
        if self.annotate:
            import torch

            rf = torch.profiler.record_function(f"portbench.{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.rows.append({"name": name, "t0": t0, "t1": t1, **attrs})

    def of(self, name: str, t0: float | None = None, t1: float | None = None) -> list[dict]:
        return [r for r in self.rows if r["name"] == name
                and (t0 is None or r["t0"] >= t0) and (t1 is None or r["t1"] <= t1)]


def parse_prometheus(text: str) -> dict[str, float]:
    """Exposition text → {series name without labels: value summed over
    label sets}."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        name = key.split("{", 1)[0]
        try:
            out[name] = out.get(name, 0.0) + float(value)
        except ValueError:
            continue
    return out


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_trace(path: "str | Path", top: int = 10) -> dict | None:
    """A Chrome trace → the device's busy and window seconds, kernel time
    by name, the top device operations, and the longest idle gaps, each
    named by the host range open over its middle (a harness span where
    one is, else the longest torch op of any host thread) and summed by
    name over the 200 longest gaps. None where
    no operation ran on the device."""
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if not dev or not xs:
        return None
    t0 = min(float(e["ts"]) for e in xs)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in xs)
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev])
    by_name: dict[str, list[float]] = {}
    for e in dev:
        by_name.setdefault(e["name"], []).append(float(e["dur"]))
    ops = sorted(((n, sum(d) * 1e-6) for n, d in by_name.items()), key=lambda x: -x[1])
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    gaps += [(t0, busy[0][0]), (busy[-1][1], t1)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:200]
    host = [e for e in xs if e.get("cat") in ("user_annotation", "cpu_op")]

    def name_of(a: float, b: float) -> str:
        mid = 0.5 * (a + b)
        cover = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        spans = [e for e in cover if e.get("cat") == "user_annotation"]
        pick = spans or cover
        if not pick:
            return "host: no span or torch op open"
        return max(pick, key=lambda e: float(e["dur"]))["name"][:120]

    gap_names: dict[str, float] = {}
    for a, b in gaps:
        n = name_of(a, b)
        gap_names[n] = gap_names.get(n, 0.0) + (b - a) * 1e-6
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernel_s": {n: sum(d) * 1e-6 for n, d in by_name.items()},
        "kernel_calls": {n: len(d) for n, d in by_name.items()},
        "device_ops": [[n[:120], s] for n, s in ops[:top]],
        "idle_gaps": sorted(([n, s] for n, s in gap_names.items()), key=lambda x: -x[1])[:top],
    }
