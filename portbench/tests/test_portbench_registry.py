"""The harness finds every workload, configuration, traffic, driver,
limit, per-layer metric and knee sweep by name, and the configuration
files match the port's presets."""

import json
import re

import pytest

from portbench import spec
from portbench.compare import NUMBERS
from portbench.port_check import port_mismatches
from portbench.reference import vit_dpt
from portbench.reference.model import family

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


def _config(name: str) -> dict:
    c = next(x for x in BENCH["configs"] if x["name"] == name)
    return json.loads((spec.ROOT / c["file"]).read_text())


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_matches_the_port(config):
    """The configuration's parameters are the served model's, name for
    name and shape for shape, and every field its family names
    (``port_fields``) is the served preset's."""
    assert port_mismatches(_config(config)) == []


# Chosen by the function a family runs, not by its name.
VIT_CONFIGS = [c["name"] for c in BENCH["configs"]
               if family(_config(c["name"])["arch"]).port_fields is vit_dpt.port_fields]


@pytest.mark.parametrize("config", VIT_CONFIGS)
def test_vit_port_fields_are_the_eight_encoder_checks(config):
    """A ViT + DPT configuration is held to the encoder's widths, depth,
    heads, patch, native position grid, MLP width, taps and norm epsilon,
    each against the value its ``arch`` gives."""
    a = _config(config)["arch"]
    assert dict(vit_dpt.port_fields(_config(config))) == {
        "backbone.hidden_size": a["hidden_size"], "backbone.num_layers": a["num_hidden_layers"],
        "backbone.num_heads": a["num_attention_heads"], "backbone.patch_size": a["patch_size"],
        "backbone.pos_embed_size": a["pos_embed_size"],
        "backbone.mlp_ratio": a["intermediate_size"] / a["hidden_size"],
        "backbone.out_layers": a["out_indices"], "backbone.layer_norm_eps": a["layer_norm_eps"]}
