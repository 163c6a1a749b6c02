"""Pipeline: the share of the window's collects whose device→host copy
had already completed when the collect began (the copy is enqueued at
submit, behind the batch's own replay): the window's change of the
server's ``ipc_d2h_ready_total`` over that of ``ipc_d2h_collects_total``.
None without those counters, or where no collect read a device copy."""


def read(rec):
    m = rec.get("server_metrics")
    ready, collects = "ipc_d2h_ready_total", "ipc_d2h_collects_total"
    if not m or ready not in m["after"] or collects not in m["after"]:
        return None
    n = m["after"][collects] - m["before"].get(collects, 0)
    return (m["after"][ready] - m["before"].get(ready, 0)) / n if n > 0 else None
