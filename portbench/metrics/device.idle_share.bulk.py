"""Device: the share of the traced window (a ``torch.profiler`` trace of
the harness's process over the window's last seconds) in which no
kernel, copy or memset ran on the card."""


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
