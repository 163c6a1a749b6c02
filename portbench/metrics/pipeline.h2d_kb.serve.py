"""Pipeline: host→device bytes an image, in kB (1000 bytes): the window's
change of the server's ``ipc_h2d_bytes_total`` (the payloads handed to the
graphs, padding rows included) over that of the images its drains
dispatched (``ipc_inference_batch_size_sum``)."""


def read(rec):
    m = rec.get("server_metrics")
    k, n = "ipc_h2d_bytes_total", "ipc_inference_batch_size_sum"
    if not m or k not in m["after"]:
        return None
    images = m["after"].get(n, 0) - m["before"].get(n, 0)
    return (m["after"][k] - m["before"].get(k, 0)) / images / 1e3 if images > 0 else None
