"""The whole request: the 95th percentile (numpy's linear rule) of the
window's request latencies, from when each was due to the last byte of
its point cloud: the tail of the population that the end-to-end
``within_150ms_share`` counts, too unsteady between runs to hold to a
bound."""


def read(rec):
    lat = sorted(rec.get("latencies_ms") or [])
    if not lat:
        return None
    pos = 0.95 * (len(lat) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(lat) - 1)
    return lat[lo] + (lat[hi] - lat[lo]) * (pos - lo)
