"""The reference's model is found by the family a configuration names
(``portbench/reference/families/<family>.py``), and finding it so moved no
reading: each configuration's parameter list, seeded state dict,
reference cloud, FLOP count and patch grid are pinned bit for bit to what
the harness read before the families had modules of their own.

The state dicts and clouds are pinned at the tiny presets' widths on the
CPU, in one thread (the CPU's matrix products split their sums by the
thread count); the full widths pin their parameter lists, FLOPs and grids.
A family that exists only under a new name, with no shared file edited,
drives a whole tiny bulk run to ``correct``. No family module loads JAX
or the port."""

import hashlib
import json
import sys
import types

import pytest
import torch

from portbench import run, spec, synth
from portbench.flops import flops_per_image, model_grid
from portbench.reference.model import family, param_specs
from portbench.reference.pipeline import reference_cloud
from portbench.run import FORBIDDEN
from portbench.tests import tiny
from portbench.tests.test_portbench_imports import _top_level_after
from portbench.tests.test_portbench_run import _workload, tiny_presets  # noqa: F401
from portbench.weights import make_state_dict

SEED = 2**31 + 2021
INTERFACE = ("param_specs", "forward", "model_input", "model_output", "model_target", "model_grid",
             "flops_per_image", "port_fields")

# Read from the harness before the family modules (sha256, first 16 hex digits).
PARAMS = {"dav2-small-bf16": "b2a8f9a4a3efce43", "dpt-large-bf16": "01863fdfd640bbf7",
          "portbench-tiny-da": "51718784c9453a00", "portbench-tiny-dpt": "abbfbf5e13c2cbe6"}
STATE = {"portbench-tiny-da": "eb782bf3af23fea4", "portbench-tiny-dpt": "4fb0f7e90fd5f110"}
CLOUD = {"portbench-tiny-da": "22f5efc1a6afad0f", "portbench-tiny-dpt": "c27464cdae3a6874"}
# (h, w) → (FLOPs an image, patch grid).
SHAPES = {
    "dav2-small-bf16": {(518, 518): (115267534080.0, (37, 37)), (480, 640): (167465068800.0, (37, 49))},
    "dpt-large-bf16": {(518, 518): (516412243968.0, (24, 24)), (480, 640): (516412243968.0, (24, 24))},
    "portbench-tiny-da": {(48, 64): (20097280.0, (3, 4))},
    "portbench-tiny-dpt": {(48, 64): (31678720.0, (4, 4))},
}
GRIDS = {"dav2-small-bf16": {(1080, 1920): (37, 66), (48, 64): (28, 37)},
         "dpt-large-bf16": {(1080, 1920): (24, 24), (48, 64): (24, 24)}}


def _digest(*parts) -> str:
    m = hashlib.sha256()
    for p in parts:
        m.update(p if isinstance(p, bytes) else str(p).encode())
    return m.hexdigest()[:16]


def _cfg(name: str) -> dict:
    if name in tiny.PRESETS:
        return tiny.config(name)
    conf = next(c for c in spec.benchmark()["configs"] if c["name"] == name)
    return json.loads((spec.ROOT / conf["file"]).read_text())


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_parameter_list_pinned(name):
    arch = _cfg(name)["arch"]
    assert _digest(json.dumps([[n, list(s), k, f] for n, s, k, f in param_specs(arch)])) == PARAMS[name]


@pytest.mark.parametrize("name", sorted(STATE))
def test_state_dict_pinned(name):
    sd = make_state_dict(_cfg(name), SEED, "cpu", torch.float32)
    assert _digest(*[x for k, v in sd.items() for x in (k, v.numpy().tobytes())]) == STATE[name]


@pytest.mark.parametrize("name", sorted(CLOUD))
def test_reference_cloud_pinned(name, one_thread):
    cfg = _cfg(name)
    sd = make_state_dict(cfg, SEED, "cpu", torch.float32)
    c = reference_cloud(synth.frames(SEED, 1, 48, 64)[0], sd, cfg, depth_scale=15.0, density="medium")
    got = _digest(c.keep.tobytes(), c.margin.tobytes(), c.points.tobytes(), c.colors.tobytes(), c.h, c.w, c.step)
    assert got == CLOUD[name]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_flops_and_grid_pinned(name):
    cfg = _cfg(name)
    for hw, (flops, grid) in SHAPES[name].items():
        assert flops_per_image(cfg, *hw) == flops and model_grid(cfg, *hw) == grid
    for hw, grid in GRIDS.get(name, {}).items():
        assert model_grid(cfg, *hw) == grid


def _families() -> list[str]:
    return sorted(p.stem for p in (spec.HERE / "reference" / "families").glob("*.py") if p.stem != "__init__")


def test_every_configuration_names_a_family_with_the_interface():
    for c in spec.benchmark()["configs"]:
        fam = family(_cfg(c["name"])["arch"])
        assert fam.__name__.rsplit(".", 1)[1] in _families()
        assert all(callable(getattr(fam, f)) for f in INTERFACE), fam.__name__


def test_families_load_no_jax_and_none_of_the_port():
    names = _top_level_after("".join(f"import portbench.reference.families.{f}\n" for f in _families()))
    assert len(_families()) >= 2 and "portbench" in names
    assert not names & {*FORBIDDEN, "image_to_pointcloud_tpu_torch"}, names


def test_a_family_is_found_by_name_alone(tiny_presets, tmp_path, monkeypatch):  # noqa: F811
    """A family module under a name no file has, standing in for a new
    family's file: the whole tiny bulk run reaches the model only through
    it, and is ``correct``."""
    base = family({"family": "dinov2_dpt"})
    called = set()

    def recorded(name):
        def call(*args, **kwargs):
            called.add(name)
            return getattr(base, name)(*args, **kwargs)
        return call

    mod = types.ModuleType("portbench.reference.families.portbench_test_family")
    for name in INTERFACE:
        setattr(mod, name, recorded(name))
    monkeypatch.setitem(sys.modules, mod.__name__, mod)

    w = _workload("dptl-bulk", tmp_path, "portbench-tiny-da", tiny.bulk_traffic())
    w["config"]["arch"]["family"] = "portbench_test_family"
    out = run.execute(w, seed=SEED, seconds=0.6, trace=True, device="cpu")
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert {"param_specs", "forward", "model_input", "model_output", "model_target",
            "flops_per_image"} <= called, called
    assert model_grid(w["config"], 48, 64) == (3, 4) and "model_grid" in called
