"""The benchmark of the PyTorch + CUDA port (``image_to_pointcloud_tpu_torch``).

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Loads the workload's configuration and
traffic by name (``portbench/spec.py``), runs its driver's set-up and
measured window, compares a sample of what the window produced with the
plain reference (``portbench/reference/``), and prints one JSON line as
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``,
each compared number beside its limit (also the last lines of standard
error). Exits non-zero, printing no result, without CUDA or with fewer
cards than the workload asks for, or when ``jax``, ``jaxlib``, ``flax``
or ``image_to_pointcloud_tpu`` were loaded, in this process or in the
serving cell's server process, once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the run's set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "image_to_pointcloud_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cache_env(root: Path) -> dict:
    """Every build and kernel cache at a fixed path inside the checkout;
    nothing in the run loads JAX."""
    cache = root / "portbench_cache"
    env = {"TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
           "TRITON_CACHE_DIR": str(cache / "triton"), "USE_FLAX": "0", "USE_JAX": "0"}
    os.environ.update(env)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(root), *filter(None, [env.get("PYTHONPATH")])])
    return env


def loaded_forbidden() -> list[str]:
    """Top-level names in ``sys.modules`` that the run must not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class LoadedForbidden(RuntimeError):
    """A process of the run other than this one loaded a name of
    :data:`FORBIDDEN`: the run gives no result."""


def end_to_end(rec: dict) -> dict:
    out = {"setup_s": rec["setup_s"]}
    for ms, pct in rec.get("within_pct", {}).items():
        out[f"within_{ms}ms_share"] = pct
    if "images" in rec:
        out["img_s"] = rec["images"] / rec["window_s"]
    return out


def check_outputs(rec: dict, w: dict, seed: int, device: str) -> tuple[bool, dict]:
    """Compare the run's sample with the reference; (correct, checks)."""
    import numpy as np
    import torch

    from portbench.compare import compare_cloud, judge, load_limits, reduce_numbers
    from portbench.reference.ops import read_ply_points
    from portbench.reference.pipeline import reference_cloud
    from portbench.weights import make_state_dict

    cfg, tr = w["config"], w["traffic"]
    scale, density = scale_and_density(tr)
    dtype = getattr(torch, cfg["dtype"]) if device == "cuda" else torch.float32
    sd = {k: v.float() for k, v in make_state_dict(cfg, seed, device, dtype).items()}
    refs: dict[int, object] = {}
    per_cloud = []
    for image, served in rec["sample"]:
        key = id(image)
        if key not in refs:
            refs[key] = reference_cloud(image, sd, cfg, depth_scale=scale, density=density)
        pts, cols = read_ply_points(served) if isinstance(served, bytes) else served
        per_cloud.append(compare_cloud(pts, np.asarray(cols), refs[key], scale))
    numbers = reduce_numbers(per_cloud)
    log(f"compared {len(per_cloud)} clouds of {len(refs)} distinct uploads with the reference")
    return judge(numbers, load_limits(Path(__file__).parent, w["cell"]["name"]))


def scale_and_density(tr: dict) -> tuple[float, str]:
    if "query" in tr:
        return float(tr["query"]["depth_scale"]), tr["query"]["point_density"]
    return float(tr["depth_scale"]), tr["options"]["density"]


def per_layer(rec: dict, w: dict) -> dict:
    from portbench.spec import metric_reader

    out = {}
    for m in w["per_layer"]:
        v = metric_reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    env = cache_env(ROOT)
    from portbench import spec
    from portbench.hw import require_cards, smi

    w = spec.workload(args.workload, ROOT)
    why = require_cards(w["cell"]["chips"])
    if why is not None:
        log(f"no run: {why}")
        return 3
    card = smi()
    log(f"card: {card.get('name')} x{card.get('count')}, power limit {card.get('power_limit')}, "
        f"max SM clock {card.get('max_sm_clock')}")
    try:
        out = execute(w, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), env=env, t0=T0)
    except LoadedForbidden as e:
        log(f"no result: {e}")
        return 4
    bad = loaded_forbidden()
    if bad:
        log(f"no result: the run loaded {bad}")
        return 4
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


def context(w: dict, *, seed: int, seconds: float, trace: bool, device: str = "cuda",
            env: dict | None = None, t0: float = T0) -> dict:
    """What a driver's ``run(ctx)`` is given, with the workload's run
    directory made anew."""
    run_dir = ROOT / "portbench_runs" / w["cell"]["name"]
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    return {"seed": seed, "seconds": seconds, "trace": trace,
            "cfg": w["config"], "cfg_path": w["config_path"], "traffic": w["traffic"], "t0": t0,
            "root": ROOT, "run_dir": run_dir, "device": device, "env": env or dict(os.environ),
            "log": log}


def execute(w: dict, *, seed: int, seconds: float, trace: bool, device: str = "cuda",
            env: dict | None = None, t0: float = T0) -> dict:
    """One run of the resolved workload ``w`` (:func:`portbench.spec.workload`)
    → the result object. ``device="cpu"`` runs the port's plain versions,
    for the CPU tests at tiny sizes; the command line runs on CUDA only."""
    from portbench import spec

    rec = spec.driver(w["traffic"]["driver"]).run(
        context(w, seed=seed, seconds=seconds, trace=trace, device=device, env=env, t0=t0))
    if rec.get("server_loaded"):
        raise LoadedForbidden(f"the server process loaded {rec['server_loaded']}")
    metrics = end_to_end(rec)
    metrics = {m["name"]: {"value": metrics[m["name"]], "unit": m["unit"]} for m in w["end_to_end"]}
    for m_name, m in metrics.items():
        log(f"{m_name}: {m['value']} {m['unit']}")

    import torch

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": w["cell"]["chips"], "memory_peak_bytes": rec["memory_peak_bytes"]}
    breakdown = None
    if trace:
        from portbench.flops import flops_per_image
        from portbench.tracing import reduce_trace

        reduced = reduce_trace(rec["trace_path"]) if rec.get("trace_path") else None
        hw = w["traffic"].get("upload_hw") or w["traffic"]["frame_hw"]
        rec.update(trace=reduced, cfg=w["config"], traffic=w["traffic"], e2e=metrics,
                   flops_per_image=flops_per_image(w["config"], *hw))
        for m_name, m in metrics.items():
            log(f"traced run's {m_name}: {m['value']}")
        metrics = per_layer(rec, w)
        if reduced is not None:
            dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
            breakdown = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
    correct, checks = check_outputs(rec, w, seed, device)
    out = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


if __name__ == "__main__":
    sys.exit(main())
