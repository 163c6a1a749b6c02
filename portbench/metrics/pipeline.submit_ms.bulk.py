"""Pipeline: host time of ``DepthPipeline.submit_batch`` an image (the
payload's pack and copy, the graph's replay launch), from the harness's
span around each call in the window."""


def read(rec):
    rows = [r for r in rec.get("spans", []) if r["name"] == "submit"]
    n = sum(r["images"] for r in rows)
    return 1e3 * sum(r["t1"] - r["t0"] for r in rows) / n if n else None
