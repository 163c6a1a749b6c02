"""HTTP and jobs: the median over requests of the job's own host work, in
ms (``/timings/{id}``): the model lookup, the decode (or the JPEG plan),
the preview PNG, the preview JSON, the GIS metadata, the export (or its
deferral) and the status updates."""

from portbench.program_spans import request_ms

WORK = ("job.model_get", "job.decode", "job.jpeg_plan", "job.preview_png", "job.preview_json",
        "job.metadata", "job.export", "job.status_updates")


def read(rec):
    return request_ms(rec, WORK)
