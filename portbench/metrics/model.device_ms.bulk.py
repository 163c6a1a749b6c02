"""Models and ops: device time an image, in ms: the kernels', copies' and
memsets' time in the trace over the images submitted while it ran."""


def read(rec):
    t = rec.get("trace")
    n = rec.get("traced_images")
    if not t or not n:
        return None
    return 1e3 * sum(t["kernel_s"].values()) / n
