"""The BEiT + ZoeDepth family (``portbench/reference/families/beit_zoedepth.py``)
against HF ``ZoeDepthForDepthEstimation`` and its image processor, its
pins, its FLOPs by hand, a whole tiny bulk run through the port to
``correct``, and the port check (``port_mismatches``) on a ZoeDepth
configuration at the published widths: it passes against a preset of
those widths and fails where the window, the taps or a neck width part.

The tiny model is off its bias tables' window (window 4, a 4×6 grid), so
the tables' re-interpolation runs; the tables are drawn at unit variance,
so the bias moves the output."""

import copy
import hashlib
import json

import numpy as np
import pytest
import torch

from portbench import run, spec, synth
from portbench.flops import flops_per_image, model_grid
from portbench.port_check import port_mismatches
from portbench.reference.families import beit_zoedepth as zoe
from portbench.reference.model import family, param_specs
from portbench.reference.pipeline import reference_cloud
from portbench.tests import tiny
from portbench.weights import make_state_dict

SEED = 2**31 + 2022

# ZoeD_N (Intel/zoedepth-nyu) at its published widths: BEiT-L/16-384 and
# the MiDaS v3.1 reassemble widths of HF's conversion.
PUBLISHED = {
    "name": "zoedepth-nyu-bf16",
    "source": "https://huggingface.co/Intel/zoedepth-nyu",
    "paper": "ZoeDepth: Zero-shot Transfer by Combining Relative and Metric Depth, arXiv:2302.12288 (ZoeD_N)",
    "preset": "portbench-zoedepth-nyu",
    "dtype": "bfloat16",
    "arch": {
        "family": "beit_zoedepth", "hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16,
        "intermediate_size": 4096, "patch_size": 16, "window_size": 24, "layer_norm_eps": 1e-12,
        "layer_scale": True, "out_indices": [6, 12, 18, 24], "neck_hidden_sizes": [256, 512, 1024, 1024],
        "reassemble_factors": [4, 2, 1, 0.5], "fusion_hidden_size": 256, "bottleneck_features": 256,
        "num_relative_features": 32, "bin_embedding_dim": 128, "n_bins": 64, "min_depth": 0.001,
        "max_depth": 10.0, "num_attractors": [16, 8, 4, 1], "min_temp": 0.0212, "max_temp": 50.0,
    },
    "preprocess": {"target": [384, 512], "multiple": 32, "keep_aspect_ratio": True, "resize": "linear_ac",
                   "mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5], "pad_reflect_factor": 3},
    "reduced": [],
}
TINY_ARCH = {"hidden_size": 32, "num_hidden_layers": 4, "num_attention_heads": 2, "intermediate_size": 64,
             "window_size": 4, "out_indices": [1, 2, 3, 4], "neck_hidden_sizes": [8, 16, 24, 32],
             "fusion_hidden_size": 16, "bottleneck_features": 16, "num_relative_features": 8,
             "bin_embedding_dim": 8, "n_bins": 16, "num_attractors": [4, 3, 2, 1]}

# Pins (sha256, first 16 hex digits), read when the family was written.
PARAMS = {"tiny": "c7fa0a08c45d94bf", "published": "7130601eda0f1828"}
STATE = "7acbce5c6c4226b7"
CLOUD = "7e7623bd4a28b9ea"
# (h, w) → (FLOPs an image, patch grid).
SHAPES = {"tiny": {(48, 64): (41556480.0, (4, 6))},
          "published": {(480, 640): (716700745728.0, (24, 32)), (518, 518): (981169438720.0, (32, 32))}}


def tiny_config() -> dict:
    cfg = copy.deepcopy(PUBLISHED)
    cfg.update(name="portbench-tiny-zoe", preset="portbench-tiny-zoe")
    cfg["arch"].update(TINY_ARCH)
    cfg["preprocess"]["target"] = [64, 96]
    return cfg


def _cfg(which: str) -> dict:
    return tiny_config() if which == "tiny" else copy.deepcopy(PUBLISHED)


def preset_of(cfg: dict):
    """The port's ZoeDepth preset of a configuration's widths."""
    from image_to_pointcloud_tpu_torch.models.beit import BeitConfig
    from image_to_pointcloud_tpu_torch.models.zoedepth import ZoeDepthConfig

    a, pre = cfg["arch"], cfg["preprocess"]
    return ZoeDepthConfig(
        backbone=BeitConfig(hidden_size=a["hidden_size"], num_layers=a["num_hidden_layers"],
                            num_heads=a["num_attention_heads"], intermediate_size=a["intermediate_size"],
                            patch_size=a["patch_size"], window_size=a["window_size"],
                            layer_norm_eps=a["layer_norm_eps"], layer_scale=a["layer_scale"],
                            out_layers=tuple(a["out_indices"])),
        neck_hidden_sizes=tuple(a["neck_hidden_sizes"]), fusion_hidden_size=a["fusion_hidden_size"],
        reassemble_factors=tuple(a["reassemble_factors"]), bottleneck_features=a["bottleneck_features"],
        num_relative_features=a["num_relative_features"], bin_embedding_dim=a["bin_embedding_dim"],
        n_bins=a["n_bins"], min_depth=a["min_depth"], max_depth=a["max_depth"],
        num_attractors=tuple(a["num_attractors"]), min_temp=a["min_temp"], max_temp=a["max_temp"],
        native_target=tuple(pre["target"]), size_multiple=pre["multiple"],
        pad_reflect_factor=pre["pad_reflect_factor"])


@pytest.fixture
def zoe_presets(monkeypatch):
    """The tiny and the published ZoeDepth presets in the port's table
    (this process, for this test)."""
    from image_to_pointcloud_tpu_torch.models import depth_anything as da

    for which in ("tiny", "published"):
        cfg = _cfg(which)
        monkeypatch.setitem(da.PRESETS, cfg["preset"], preset_of(cfg))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(*parts) -> str:
    m = hashlib.sha256()
    for p in parts:
        m.update(p if isinstance(p, bytes) else str(p).encode())
    return m.hexdigest()[:16]


# ---------- against HF ----------


def _hf_model(cfg: dict, sd: dict):
    """HF's ZoeDepth of the configuration's widths, holding the served
    state dict ``sd`` under HF's names."""
    from transformers import ZoeDepthConfig, ZoeDepthForDepthEstimation
    from transformers.models.beit import BeitConfig

    a = cfg["arch"]
    n, p = a["num_hidden_layers"], a["patch_size"]
    bb = BeitConfig(hidden_size=a["hidden_size"], num_hidden_layers=n, num_attention_heads=a["num_attention_heads"],
                    intermediate_size=a["intermediate_size"], image_size=a["window_size"] * p, patch_size=p,
                    layer_norm_eps=a["layer_norm_eps"], use_relative_position_bias=True,
                    reshape_hidden_states=False, out_indices=list(a["out_indices"]),
                    out_features=[f"stage{i}" for i in a["out_indices"]])
    hf_cfg = ZoeDepthConfig(backbone_config=bb, neck_hidden_sizes=a["neck_hidden_sizes"],
                            reassemble_factors=a["reassemble_factors"], fusion_hidden_size=a["fusion_hidden_size"],
                            bottleneck_features=a["bottleneck_features"],
                            num_relative_features=a["num_relative_features"],
                            bin_embedding_dim=a["bin_embedding_dim"], num_attractors=a["num_attractors"],
                            min_temp=a["min_temp"], max_temp=a["max_temp"],
                            bin_configurations=[{"n_bins": a["n_bins"], "min_depth": a["min_depth"],
                                                 "max_depth": a["max_depth"]}])
    hf = ZoeDepthForDepthEstimation(hf_cfg).eval()
    blocks = {"ls1": "lambda_1", "ls2": "lambda_2", "norm1": "layernorm_before", "norm2": "layernorm_after",
              "attn.rel_pos_table": "attention.attention.relative_position_bias.relative_position_bias_table",
              "attn.q": "attention.attention.query", "attn.k": "attention.attention.key",
              "attn.v": "attention.attention.value", "attn.proj": "attention.output.dense",
              "fc1": "intermediate.dense", "fc2": "output.dense"}
    heads = {"rel_conv": "relative_head.conv", "mh_conv2": "metric_head.conv2",
             "seed_conv": "metric_head.seed_bin_regressor.conv", "seed_projector": "metric_head.seed_projector",
             "projector": "metric_head.projectors.", "attractor": "metric_head.attractors.",
             "cond_log_binomial.mlp1": "metric_head.conditional_log_binomial.mlp.0",
             "cond_log_binomial.mlp2": "metric_head.conditional_log_binomial.mlp.2"}
    out = {}
    for name, t in sd.items():
        parts = name.split(".")
        if name == "backbone.cls_token":
            key = "backbone.embeddings.cls_token"
        elif name.startswith("backbone.patch_embed"):
            key = "backbone.embeddings.patch_embeddings.projection." + parts[-1]
            if parts[-1] == "weight":
                t = t.reshape(-1, p, p, 3).permute(0, 3, 1, 2)
        elif name.startswith("backbone.blocks."):
            sub = ".".join(parts[3:])
            leaf = next(k for k in sorted(blocks, key=len, reverse=True) if sub == k or sub.startswith(k + "."))
            key = f"backbone.encoder.layer.{parts[2]}.{blocks[leaf]}{sub[len(leaf):]}"
        elif name.startswith("reassemble."):
            kind, i = parts[1].rstrip("0123456789"), parts[1][-1]
            key = {"readout": f"neck.reassemble_stage.readout_projects.{i}.0",
                   "proj": f"neck.reassemble_stage.layers.{i}.projection",
                   "up": f"neck.reassemble_stage.layers.{i}.resize",
                   "down": f"neck.reassemble_stage.layers.{i}.resize"}[kind] + "." + parts[-1]
        elif name.startswith("conv"):
            key = f"neck.convs.{parts[0][4:]}.{parts[-1]}"
        elif name.startswith("fusion"):
            unit = {"res1": "residual_layer1", "res2": "residual_layer2", "projection": "projection"}[parts[1]]
            conv = {"conv1": "convolution1", "conv2": "convolution2"}.get(parts[2], "")
            key = ".".join(x for x in (f"neck.fusion_stage.layers.{parts[0][6:]}", unit, conv, parts[-1]) if x)
        else:
            lead = next(k for k in sorted(heads, key=len, reverse=True) if name.startswith(k))
            key = heads[lead] + name[len(lead):]
        out[key] = t
    missing, unexpected = hf.load_state_dict(out, strict=False)
    # HF's first fusion layer holds a residual unit it never runs.
    assert not unexpected and all(k.startswith("neck.fusion_stage.layers.0.residual_layer1.") for k in missing)
    return hf


def _pair(seed: int = SEED):
    cfg = tiny_config()
    sd = make_state_dict(cfg, seed, "cpu", torch.float32)
    x = torch.from_numpy(np.random.default_rng(seed).normal(0, 1, (2, 64, 96, 3)).astype(np.float32))
    return cfg, sd, x


def _gap(ours: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest gap over the reference's largest magnitude."""
    return float((ours - ref).abs().max() / ref.abs().max())


# The family's forward agrees with HF's within TOLERANCE of HF's largest
# depth. Both are f32 on the CPU, in one thread; they differ only in where
# they round (the resampling by matrices, the patch embedding as a linear
# map, the attractors' mean in one reduction): the gap read 4.6e-7 to
# 7.3e-7 on four seeds. Dropping the bias moved the output by 0.015 to
# 0.117 on the same seeds, 1480 times the tolerance or more.
TOLERANCE = 1e-5
# The processor's input and output within INPUT_TOLERANCE (of the [-1, 1]
# pixel range, and of depth in [0, 1)): torch's interpolate places its
# source pixels in f32 (i·(in − 1)/(out − 1)), up to ~3e-5 of a pixel off
# at these sizes, where the reference's weights are built in f64; the gap
# read 1.2e-5 to 1.4e-5 at 480×640, 333×517 and 518×518.
INPUT_TOLERANCE = 1e-4


@torch.inference_mode()
def test_forward_agrees_with_hf(one_thread):
    cfg, sd, x = _pair()
    hf = _hf_model(cfg, sd)
    ref = hf(x.permute(0, 3, 1, 2)).predicted_depth
    ours = family(cfg["arch"]).forward(sd, cfg["arch"], x)
    assert ours.shape == ref.shape == (2, 64, 96)
    assert _gap(ours, ref) < TOLERANCE


@torch.inference_mode()
def test_forward_without_the_bias_fails_the_tolerance(one_thread):
    cfg, sd, x = _pair()
    with_bias = family(cfg["arch"]).forward(sd, cfg["arch"], x)
    zeroed = {k: (torch.zeros_like(v) if k.endswith("rel_pos_table") else v) for k, v in sd.items()}
    assert _gap(family(cfg["arch"]).forward(zeroed, cfg["arch"], x), with_bias) > 100 * TOLERANCE


@pytest.mark.parametrize("hw", [(480, 640), (333, 517)])
def test_model_input_matches_the_hf_processor(hw):
    from transformers import ZoeDepthImageProcessor

    image = synth.frames(SEED, 1, *hw)[0]
    theirs = ZoeDepthImageProcessor()(image, return_tensors="pt")["pixel_values"][0].permute(1, 2, 0)
    ours = zoe.model_input(torch.from_numpy(image).float(), PUBLISHED)
    assert ours.shape == theirs.shape
    if hw == (480, 640):
        assert tuple(ours.shape[:2]) == (384, 512)
    assert float((ours - theirs).abs().max()) < INPUT_TOLERANCE


def test_model_output_matches_the_hf_post_process():
    from transformers import ZoeDepthImageProcessor
    from transformers.models.zoedepth.modeling_zoedepth import ZoeDepthDepthEstimatorOutput

    depth = torch.from_numpy(np.random.default_rng(SEED).random((384, 512)).astype(np.float32))
    out = ZoeDepthDepthEstimatorOutput(predicted_depth=depth[None])
    theirs = ZoeDepthImageProcessor().post_process_depth_estimation(out, source_sizes=[(480, 640)])
    ours = zoe.model_output(depth, PUBLISHED, 480, 640)
    assert ours.shape == (480, 640)
    assert float((ours - theirs[0]["predicted_depth"]).abs().max()) < INPUT_TOLERANCE


# ---------- pins and FLOPs ----------


@pytest.mark.parametrize("which", sorted(PARAMS))
def test_parameter_list_pinned(which):
    arch = _cfg(which)["arch"]
    assert _digest(json.dumps([[n, list(s), k, f] for n, s, k, f in param_specs(arch)])) == PARAMS[which]


def test_state_dict_pinned():
    sd = make_state_dict(tiny_config(), SEED, "cpu", torch.float32)
    assert _digest(*[x for k, v in sd.items() for x in (k, v.numpy().tobytes())]) == STATE


def test_reference_cloud_pinned(one_thread):
    cfg = tiny_config()
    sd = make_state_dict(cfg, SEED, "cpu", torch.float32)
    c = reference_cloud(synth.frames(SEED, 1, 48, 64)[0], sd, cfg, depth_scale=15.0, density="medium")
    got = _digest(c.keep.tobytes(), c.margin.tobytes(), c.points.tobytes(), c.colors.tobytes(), c.h, c.w, c.step)
    assert got == CLOUD


@pytest.mark.parametrize("which", sorted(SHAPES))
def test_flops_and_grid_pinned(which):
    cfg = _cfg(which)
    for hw, (flops, grid) in SHAPES[which].items():
        assert flops_per_image(cfg, *hw) == flops and model_grid(cfg, *hw) == grid


def test_flops_by_hand_tiny():
    # 48×64 upload: reflect pad 14 / 16 a side → 76×96 → (64, 96), a 4×6
    # grid: 24 patches + CLS = 25 tokens, width 32, 4 layers, MLP 64.
    t, d, g = 25, 32, 24
    enc = 4 * (2 * t * d * d * 4 + 2 * t * d * 64 * 2 + 4 * t * t * d) + 2 * g * 768 * d
    # Reassemble (8, 16, 24, 32) at ×4, ×2, ×1, ×½ (2×3 = 6 pixels).
    neck = 4 * 2 * g * 2 * d * d + 2 * g * d * (8 + 16 + 24 + 32)
    neck += 2 * g * 8 * 8 * 16 + 2 * g * 16 * 16 * 4 + 2 * 6 * 32 * 32 * 9
    neck += 2 * 9 * 16 * (384 * 8 + 96 * 16 + 24 * 24 + 6 * 32)   # 3×3 to fusion width 16
    # Fusion from 2×3, every step ×2: units at 6, 24, 96, 384 pixels; projections ×4 after.
    neck += 2 * 16 * 16 * 9 * (2 * 6 + 4 * 24 + 4 * 96 + 4 * 384)
    neck += 2 * 16 * 16 * (24 + 96 + 384 + 1536)
    # Relative head: 16→8 at 1536 pixels, ×2, 8→8 and 8→1 at 6144.
    head = 2 * 1536 * 16 * 8 * 9 + 2 * 6144 * 8 * 8 * 9 + 2 * 6144 * 8
    # Metric head: bottleneck 1×1, seed bins (256 → 16), seed projector (128 → 8) at 6 pixels;
    # a projector and an attractor (4, 3, 2, 1 points) on each fused map; the MLP 17 → 8 → 4.
    head += 2 * 6 * (16 * 16 + 16 * 256 + 256 * 16 + 16 * 128 + 128 * 8)
    head += sum(2 * px * (16 * 128 + 128 * 8 + 8 * 8 + 8 * a) for px, a in zip((24, 96, 384, 1536), (4, 3, 2, 1)))
    head += 2 * 6144 * (17 * 8 + 8 * 4)
    assert flops_per_image(tiny_config(), 48, 64) == pytest.approx(enc + neck + head, rel=1e-12)


# ---------- through the port ----------


def test_tiny_bulk_run_is_correct(zoe_presets, tmp_path):
    cfg = tiny_config()
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    w = {**spec.workload("dptl-bulk"), "config": cfg, "config_path": path, "traffic": tiny.bulk_traffic()}
    out = run.execute(w, seed=SEED, seconds=0.6, trace=True, device="cpu")
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0, out["checks"]
    assert out["metrics"]["mfu.bulk"]["value"] > 0


def _written(tmp_path, cfg: dict) -> dict:
    """The configuration as a file would give it: written to a temporary
    site, not to ``portbench/configs/``, and read back."""
    path = tiny.site_dir(tmp_path) / f"{cfg['name']}.json"
    path.write_text(json.dumps(cfg))
    return json.loads(path.read_text())


def test_published_configuration_passes_the_port_check(zoe_presets, tmp_path):
    assert port_mismatches(_written(tmp_path, PUBLISHED)) == []


@pytest.mark.parametrize("change, shows", [
    ({"window_size": 23}, "backbone.window_size"),
    ({"out_indices": [5, 11, 17, 23]}, "backbone.out_layers"),
    ({"neck_hidden_sizes": [256, 512, 1024, 768]}, "neck_hidden_sizes"),
])
def test_port_check_fails_where_a_field_parts(zoe_presets, tmp_path, change, shows):
    cfg = copy.deepcopy(PUBLISHED)
    cfg["arch"].update(change)
    bad = port_mismatches(_written(tmp_path, cfg))
    assert any(line.startswith(f"{shows}:") for line in bad), bad

