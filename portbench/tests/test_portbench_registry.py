"""The harness finds every workload, configuration, traffic, driver,
limit, per-layer metric and knee sweep by name, and the configuration
files match the port's presets."""

import json
import re

import pytest

from portbench import spec
from portbench.compare import NUMBERS
from portbench.reference.model import param_specs

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_workload_resolves(cell):
    w = spec.workload(cell)
    assert w["config"]["name"] == w["cell"]["config"]
    assert spec.driver(w["traffic"]["driver"]).run
    limits = json.loads((spec.HERE / "limits" / f"{cell}.json").read_text())["numbers"]
    assert {"misplaced", "depth_mae"} <= set(limits) <= set(NUMBERS)
    names = {m["name"] for m in w["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert w["per_layer"]


@pytest.mark.parametrize("sweep", sorted(p.stem for p in (spec.HERE / "sweeps").glob("*.json")))
def test_sweep_names_a_serving_workload(sweep):
    plan = json.loads((spec.HERE / "sweeps" / f"{sweep}.json").read_text())
    w = spec.workload(sweep)
    assert w["traffic"]["driver"] == "serve"
    assert w["traffic"]["rate_per_s"] in plan["rates_per_s"]
    assert plan["runs"] >= 1 and plan["seconds"] > 0 and plan["ended_within_s"] > 0


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_and_silent_without_records(metric):
    read = spec.metric_reader(metric)
    assert read({}) is None


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {m["name"] for m in BENCH["per_layer"]}
    for m in [*BENCH["end_to_end"], *BENCH["per_layer"], *BENCH["workloads"], *BENCH["configs"]]:
        assert NAME.match(m["name"]), m["name"]
        for key in ("why", "layer", "source"):
            assert key not in m or 1 <= len(m[key]) <= 200, (m["name"], key)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for cell in m["workloads"]:
            w = spec.workload(cell)
            assert m["moves"] in {x["name"] for x in w["end_to_end"]}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(layers) == len(BENCH["per_layer"])
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_matches_the_port(config):
    """The configuration's widths are the served preset's, and its
    parameters are the served model's, name for name and shape for shape."""
    import torch

    from image_to_pointcloud_tpu_torch.models.depth_anything import build_model, preset

    c = next(x for x in BENCH["configs"] if x["name"] == config)
    cfg = json.loads((spec.ROOT / c["file"]).read_text())
    with torch.device("meta"):
        model = build_model(preset(cfg["preset"]))
    ours = {n: tuple(s) for n, s, _, _ in param_specs(cfg["arch"])}
    theirs = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert ours == theirs
    pcfg = preset(cfg["preset"])
    bb = pcfg.backbone
    a = cfg["arch"]
    assert (bb.hidden_size, bb.num_layers, bb.num_heads, bb.patch_size, bb.pos_embed_size) == (
        a["hidden_size"], a["num_hidden_layers"], a["num_attention_heads"], a["patch_size"],
        a["pos_embed_size"])
    assert bb.hidden_size * bb.mlp_ratio == a["intermediate_size"]
    assert tuple(bb.out_layers) == tuple(a["out_indices"]) and bb.layer_norm_eps == a["layer_norm_eps"]
