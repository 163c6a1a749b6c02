"""The whole request: the median of the window's request latencies, from
when each was due to the last byte of its point cloud. It varies with the
host's speed from run to run by more than any bound allows, so it stands
here, beside the end-to-end share of requests within their deadline."""

import statistics


def read(rec):
    lat = rec.get("latencies_ms")
    return statistics.median(lat) if lat else None
