"""HTTP and jobs: the median over requests of the download route's work,
in ms (``/timings/{id}``): ``http.download_export`` (the lazy PLY write,
its executor wait included) and ``http.download_send`` (the file read
into the response)."""

from portbench.program_spans import request_ms


def read(rec):
    return request_ms(rec, ("http.download_export", "http.download_send"))
