"""Batching: the median over requests of ``batch.wait`` (``/timings/{id}``),
in ms: from the request's enqueue in the batcher until its drain's submit
starts on an executor thread (the 5 ms window, a free drain slot, the
executor's queue)."""

from portbench.program_spans import request_ms


def read(rec):
    return request_ms(rec, ("batch.wait",))
