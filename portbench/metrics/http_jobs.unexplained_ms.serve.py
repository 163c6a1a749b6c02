"""HTTP and jobs: the median over requests of the client's latency less
the sum of that request's leaf stages (``/timings/{id}``), in ms: what the
program's spans cannot see yet (sockets, HTTP framing, the event loop's
lag before a long-poll wakes, the client's side)."""

import statistics

from portbench.program_spans import leaves_s


def read(rec):
    client = rec.get("client_ms", {})
    gaps = [client[i] - 1e3 * leaves_s(t) for i, t in rec.get("timings", {}).items()
            if i in client and leaves_s(t) > 0]
    return statistics.median(gaps) if gaps else None
