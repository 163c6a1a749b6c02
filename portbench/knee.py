"""The knee of a serving workload: runs of it at each arrival rate that
its sweep file (``sweeps/<workload>.json``) lists, its traffic otherwise
as it stands, and for each run one JSON line with what the test reads.

    python3 -m portbench.knee --workload dav2s-serve --seed <n> [--rates 6 10 ...]

``--rates`` picks some of the file's rates. A run passes when none of
its requests failed and every one ended within the file's
``ended_within_s`` of the window's close: a backlog that grows is still
being served then. The median latencies of the first and the last
quarter of arrivals are printed beside it, not tested: below the knee
either can be the longer. The knee is the highest rate with no failed
run at it or below. Needs the card, as ``portbench.run`` does; the
outputs are not compared.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from portbench import run, spec


def passes(rec: dict, ended_within_s: float) -> bool:
    return bool(rec["failed"] == 0 and rec["backlog"]["ended_after_s"] <= ended_within_s)


def sweep(w: dict, plan: dict, rates: list[float], seed: int, device: str = "cuda",
          env: dict | None = None):
    """Yields one summary a run: ``plan["runs"]`` runs a rate, seeds
    ``seed``, ``seed + 1``, …"""
    p95 = spec.metric_reader("latency_p95_ms.serve")
    for rate in rates:
        wr = {**w, "traffic": {**w["traffic"], "rate_per_s": rate}}
        for k in range(plan["runs"]):
            ctx = run.context(wr, seed=seed + k, seconds=plan["seconds"], trace=False, device=device,
                              env=env)
            rec = spec.driver(wr["traffic"]["driver"]).run(ctx)
            if rec.get("server_loaded"):
                raise run.LoadedForbidden(f"the server process loaded {rec['server_loaded']}")
            lat = rec["latencies_ms"]
            yield {"rate_per_s": rate, "seed": seed + k, "attempted": rec["attempted"],
                   "failed": rec["failed"], "p50_ms": statistics.median(lat) if lat else None,
                   "p95_ms": p95(rec), **rec["backlog"], "passes": passes(rec, plan["ended_within_s"])}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="*", help="some of the sweep file's rates")
    args = ap.parse_args(argv)

    env = run.cache_env(run.ROOT)
    from portbench.hw import require_cards

    w = spec.workload(args.workload)
    plan = json.loads((spec.HERE / "sweeps" / f"{args.workload}.json").read_text())
    rates = args.rates or plan["rates_per_s"]
    if not set(rates) <= set(plan["rates_per_s"]):
        ap.error(f"rates not in the sweep file: {sorted(set(rates) - set(plan['rates_per_s']))}")
    why = require_cards(w["cell"]["chips"])
    if why is not None:
        run.log(f"no sweep: {why}")
        return 3
    for row in sweep(w, plan, rates, args.seed, env=env):
        print(json.dumps(row), flush=True)
    bad = run.loaded_forbidden()
    if bad:
        run.log(f"the sweep loaded {bad}")
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
