"""Batching: the mean number of requests a drain dispatched in the window
(the server's ``ipc_inference_batch_size`` histogram, its change over
the window)."""


def read(rec):
    m = rec.get("server_metrics")
    if not m:
        return None
    n = m["after"].get("ipc_inference_batch_size_count", 0) - m["before"].get("ipc_inference_batch_size_count", 0)
    s = m["after"].get("ipc_inference_batch_size_sum", 0) - m["before"].get("ipc_inference_batch_size_sum", 0)
    return s / n if n > 0 else None
