"""``BENCHMARK.json`` and the files it names: a workload's configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``,
which names its driver, ``drivers/<driver>.py``), its limits
(``limits/<workload>.json``) and the readers of its per-layer metrics
(``metrics/<metric>.py``), each found by name."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(name: str, root: Path = ROOT) -> dict:
    """The workload's entry, with its configuration, traffic and metrics
    resolved: {"cell", "config", "config_path", "traffic", "end_to_end",
    "per_layer"}."""
    bench = benchmark(root)
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg_path = root / conf["file"]

    def mine(m):
        return name in m.get("workloads", [name])

    return {
        "cell": cell,
        "config": json.loads(cfg_path.read_text()),
        "config_path": cfg_path,
        "traffic": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def driver(name: str):
    """The traffic driver module ``portbench.drivers.<name>``."""
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_reader(name: str):
    """``read(rec) -> float | None`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
