"""Pipeline: the mean time of a drain's submit plus its collect, in ms
(the server's ``ipc_drain_submit_seconds`` and
``ipc_drain_collect_seconds`` histograms, their change over the
window)."""


def read(rec):
    m = rec.get("server_metrics")
    if not m:
        return None

    def delta(k):
        return m["after"].get(k, 0.0) - m["before"].get(k, 0.0)

    n = delta("ipc_drain_submit_seconds_count")
    if n <= 0:
        return None
    return 1e3 * (delta("ipc_drain_submit_seconds_sum") + delta("ipc_drain_collect_seconds_sum")) / n
