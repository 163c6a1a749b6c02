"""HTTP and jobs: the median over requests of ``http.status_body``
(``/timings/{id}``), in ms: the first render of the terminal status body
(the inline preview's JSON), on the event loop."""

from portbench.program_spans import request_ms


def read(rec):
    return request_ms(rec, ("http.status_body",))
