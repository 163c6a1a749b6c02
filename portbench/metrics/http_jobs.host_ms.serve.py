"""HTTP and jobs: the median over requests of the client's latency less
the job's ``inference_unproject_refine`` stage (``/timings/{id}``, read
after the window): the time a request spends outside the batcher and the
pipeline (upload, decode, queueing for the event loop, status, preview,
export on download)."""

import statistics


def read(rec):
    gaps = [rec["client_ms"][i] - 1e3 * t["inference_unproject_refine"]
            for i, t in rec.get("timings", {}).items()
            if i in rec.get("client_ms", {}) and "inference_unproject_refine" in t]
    return statistics.median(gaps) if gaps else None
