"""Pipeline and transfer: host time of ``DepthPipeline.collect`` an image
(the wait for the device, the bundle's copy back, unbundle and the native
reconstruct), from the harness's span around each call in the window."""


def read(rec):
    rows = [r for r in rec.get("spans", []) if r["name"] == "collect"]
    n = sum(r["images"] for r in rows)
    return 1e3 * sum(r["t1"] - r["t0"] for r in rows) / n if n else None
