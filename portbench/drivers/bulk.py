"""The bulk driver: a closed loop over ``DepthPipeline.submit_batch`` and
``collect``, as the server's drain calls them at its saturated shape.

Batches of ``batch`` frames, drawn in turn from ``distinct_frames`` frames
made from the seed (in an order drawn from the seed) and packed anew by
every ``submit_batch``; ``in_flight`` batches outstanding, so the host's
collect of one overlaps the device's work on the next. The window runs
``--seconds``, then the batches still out are collected and the window
closes; the rate is every image collected over all that time. A sample of
the collected clouds, drawn from the seed as they come, is kept for the
comparison.
"""

from __future__ import annotations

import collections
import gc
import time

import numpy as np

from portbench import synth
from portbench.tracing import Spans


class _Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from ``rng``."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.items[j] = item


def run(ctx: dict) -> dict:
    import torch

    from image_to_pointcloud_tpu_torch.pipeline.graph import PipelineOptions
    from portbench.drivers import build_program
    from portbench.weights import make_state_dict, seeded_manager

    tr, seed, log, cfg = ctx["traffic"], ctx["seed"], ctx["log"], ctx["cfg"]
    cuda = ctx["device"] == "cuda"
    build_s = build_program() if cuda else 0.0
    log(f"first-run build {build_s:.3f} s (0 where the checkout had it)")
    dtype = getattr(torch, cfg["dtype"]) if cuda else torch.float32
    manager = seeded_manager(make_state_dict(cfg, seed, ctx["device"], dtype), ctx["device"],
                             model_target=cfg["preprocess"]["target"])
    pipe = manager.get(cfg["preset"])
    h, w = tr["frame_hw"]
    frames = synth.frames(seed, tr["distinct_frames"], h, w)
    order = np.random.default_rng([seed, 5]).permutation(len(frames))
    b = tr["batch"]
    opts = PipelineOptions(**tr["options"])
    scales = [float(tr["depth_scale"])] * b
    spans = Spans()
    sample = _Reservoir(tr["sample"], np.random.default_rng([seed, 6]))
    state = {"k": 0, "images": 0}

    def submit():
        idx = [int(order[(state["k"] * b + j) % len(frames)]) for j in range(b)]
        state["k"] += 1
        with spans.span("submit", images=b):
            handle = pipe.submit_batch([frames[i] for i in idx], depth_scales=scales, options=opts)
        return handle, idx

    def collect(handle, idx, keep: bool):
        with spans.span("collect", images=b):
            results = pipe.collect(handle, want_packed=False, want_preview_rgb=False)
        if keep:
            state["images"] += len(results)
            for i, r in zip(idx, results):
                sample.offer((i, r.points, r.colors))

    def profiler():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def loop(until: float, keep: bool, prof_at: float | None = None):
        inflight = collections.deque()
        prof = None
        while time.perf_counter() < until:
            if prof_at is not None and prof is None and time.perf_counter() >= prof_at:
                state["before_profile"] = (time.perf_counter(), state["images"])
                prof = profiler()
                prof.start()
                spans.annotate = True
            inflight.append(submit())
            if len(inflight) >= tr["in_flight"]:
                collect(*inflight.popleft(), keep)
        while inflight:
            collect(*inflight.popleft(), keep)
        return prof

    t_warm = time.perf_counter()
    for _ in range(tr["warmup_batches"]):
        collect(*submit(), False)
    if ctx["trace"]:
        # The profiler's first start sets up CUPTI (seconds): here, not in
        # the window.
        with profiler():
            collect(*submit(), False)
    if cuda:
        torch.cuda.synchronize()
    log(f"warm-up {time.perf_counter() - t_warm:.3f} s ({tr['warmup_batches']} batches of {b}, "
        f"the first captures the signature)")
    spans.rows.clear()
    state["k"] = 0

    seconds = ctx["seconds"]
    t_start = time.perf_counter()
    setup_s = t_start - ctx["t0"]
    end = t_start + seconds
    prof = loop(end, True, prof_at=end - tr["trace_s"] if ctx["trace"] else None)
    t_end = time.perf_counter()
    trace_path = None
    if prof is not None:
        prof.stop()
        spans.annotate = False
        trace_path = str(ctx["run_dir"] / "bulk_trace.json")
        prof.export_chrome_trace(trace_path)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"batches: submitted {state['k']}, images collected {state['images']} in {t_end - t_start:.3f} s")
    del pipe, manager
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_prof, images_before = state.get("before_profile", (t_end, state["images"]))
    return {
        "setup_s": setup_s,
        "window_s": t_end - t_start,
        "images": state["images"],
        "attempted": state["k"] * b,
        "failed": state["k"] * b - state["images"],
        "memory_peak_bytes": peak,
        "spans": spans.rows,
        "traced_images": sum(r["images"] for r in spans.of("submit") if r["t0"] >= t_prof),
        # The window's rate before the profiler started (the traced run's
        # unperturbed part).
        "unprofiled_img_s": images_before / (t_prof - t_start) if t_prof > t_start else None,
        "trace_path": trace_path,
        "build_s": build_s,
        "sample": [(frames[i], (pts, cols)) for i, pts, cols in sample.items],
    }
