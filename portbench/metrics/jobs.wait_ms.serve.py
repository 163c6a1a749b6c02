"""HTTP and jobs: the median over requests of the job's waits, in ms
(``/timings/{id}``): ``job.start_wait`` (created until its coroutine runs),
``job.executor_wait`` (queued for an executor thread and back to the event
loop, over the job's executor calls) and ``job.resume_wait`` (its batch
collected until the job runs again)."""

from portbench.program_spans import request_ms


def read(rec):
    return request_ms(rec, ("job.start_wait", "job.executor_wait", "job.resume_wait"))
