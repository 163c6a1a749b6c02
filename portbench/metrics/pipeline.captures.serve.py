"""Pipeline: CUDA graph captures in the window (the server's
``ipc_graph_captures_total``, its change over the window); 0 when the
warmup captured every signature the traffic uses."""


def read(rec):
    m = rec.get("server_metrics")
    k = "ipc_graph_captures_total"
    if not m or k not in m["before"] or k not in m["after"]:
        return None
    return m["after"][k] - m["before"][k]
