"""Tiny configurations for the CPU tests: the two families at a few
channels and two layers, registered as presets of the port, small
uploads, short windows. A run of the harness on them goes through every
step a card run takes, on the port's plain (CPU) versions."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench import spec

PRESETS = {"portbench-tiny-da": "dav2-small-bf16", "portbench-tiny-dpt": "dpt-large-bf16"}
ARCH = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 128,
        "out_indices": [0, 1, 1, 1], "neck_hidden_sizes": [8, 16, 32, 32], "fusion_hidden_size": 16}


def config(preset: str) -> dict:
    """The tiny copy of a benchmark configuration."""
    bench = spec.benchmark()
    name = PRESETS[preset]
    conf = next(c for c in bench["configs"] if c["name"] == name)
    cfg = json.loads((spec.ROOT / conf["file"]).read_text())
    cfg = copy.deepcopy(cfg)
    cfg["preset"] = preset
    cfg["arch"].update(ARCH)
    cfg["preprocess"]["target"] = 56 if cfg["arch"]["family"] == "dinov2_dpt" else 64
    return cfg


def register_presets() -> None:
    """Add the tiny presets to the port's preset table (this process)."""
    from image_to_pointcloud_tpu_torch.models import depth_anything as da
    from image_to_pointcloud_tpu_torch.models.dpt_classic import DPTClassicConfig
    from image_to_pointcloud_tpu_torch.models.vit import ViTConfig

    a = ARCH
    da.PRESETS["portbench-tiny-da"] = da._cfg(a["hidden_size"], a["num_hidden_layers"],
                                             a["num_attention_heads"], a["out_indices"],
                                             a["neck_hidden_sizes"], a["fusion_hidden_size"])
    da.PRESETS["portbench-tiny-dpt"] = DPTClassicConfig(
        backbone=ViTConfig(hidden_size=a["hidden_size"], num_layers=a["num_hidden_layers"],
                           num_heads=a["num_attention_heads"], out_layers=tuple(a["out_indices"])),
        neck_hidden_sizes=tuple(a["neck_hidden_sizes"]), fusion_hidden_size=a["fusion_hidden_size"])


def site_dir(tmp: Path, extra: str = "") -> Path:
    """A directory whose ``sitecustomize.py`` registers the tiny presets
    (and runs ``extra``) in every Python process started with it on
    ``PYTHONPATH``: the serving cell's server process."""
    d = tmp / "site"
    d.mkdir(exist_ok=True)
    (d / "sitecustomize.py").write_text(
        "from portbench.tests.tiny import register_presets\nregister_presets()\n" + extra)
    return d


def serve_traffic() -> dict:
    tr = json.loads((spec.HERE / "traffic" / "serve_poisson.json").read_text())
    tr.update(rate_per_s=4.0, upload_hw=[48, 64], distinct_images=3, sample=4, trace_s=0.5, late_s=60)
    tr["server"] = {**tr["server"], "max_batch": 2, "warmup": [[48, 64]]}
    return tr


def bulk_traffic() -> dict:
    tr = json.loads((spec.HERE / "traffic" / "bulk_b16.json").read_text())
    tr.update(batch=2, frame_hw=[48, 64], distinct_frames=3, warmup_batches=1, sample=4, trace_s=0.3)
    return tr
