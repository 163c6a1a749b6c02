"""Checkpoint loading in the port, on the CPU: the safetensors reader
against the ``safetensors`` package, the model manager's checkpoint
directory (argument or ``IPC_TPU_CHECKPOINT_DIR``, both file layouts),
``IPC_TPU_INT8``, and the refusal of orbax checkpoints (not ported).

HF state dicts come from the committed golden fixtures, written to
safetensors here; loaded weights must equal the converter's output
exactly.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.models import depth_anything as tda
from image_to_pointcloud_tpu_torch.models.convert import convert_checkpoint, load_safetensors
from image_to_pointcloud_tpu_torch.serve.models import CHECKPOINT_ENV, ModelManager

FIXDIR = Path(__file__).resolve().parent / "fixtures"
sys.path.insert(0, str(FIXDIR.parent))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_load_safetensors_matches_the_package(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {
        "a.weight": torch.randn(7, 5, generator=gen).to(dtype),
        "b": torch.randn(3, generator=gen).to(dtype),
        "scalar": torch.randn((), generator=gen).to(dtype),
        "empty": torch.zeros(0, 4, dtype=dtype),
        "c.conv": torch.randn(2, 3, 3, 3, generator=gen).to(dtype),
    }
    path = tmp_path / "m.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    ours = load_safetensors(str(path))
    ref = load_file(str(path))
    assert set(ours) == set(ref) == set(tensors)
    for name, t in ref.items():
        assert ours[name].dtype == t.dtype == dtype and ours[name].shape == t.shape, name
        assert torch.equal(ours[name], t), name
    # Each tensor owns its memory (writable, not a view of the file).
    ours["b"].add_(1.0)


def test_load_safetensors_rejects_unsupported_dtypes(tmp_path):
    from safetensors.torch import save_file

    path = tmp_path / "i.safetensors"
    save_file({"idx": torch.arange(4, dtype=torch.int32)}, str(path))
    with pytest.raises(ValueError, match="unsupported dtype I32"):
        load_safetensors(str(path))


def _golden_sd(family: str) -> dict[str, torch.Tensor]:
    z = np.load(FIXDIR / f"golden_{family}.npz")
    return {k[3:]: torch.from_numpy(np.ascontiguousarray(z[k])) for k in z.files if k.startswith("sd/")}


def _tiny_cfg(family: str):
    from test_torch_families import _port_cfg
    from test_torch_model import _tiny_kwargs

    if family == "depth_anything":
        from image_to_pointcloud_tpu_torch.models.dinov2 import DinoV2Config
        from image_to_pointcloud_tpu_torch.models.dpt import DPTConfig

        bb, nk = _tiny_kwargs(layers=4, out_layers=(0, 1, 2, 3))
        return tda.DepthAnythingConfig(backbone=DinoV2Config(**bb), neck=DPTConfig(**nk))
    return _port_cfg(family)


@pytest.mark.parametrize(
    "family,layout,via",
    [
        ("depth_anything", "dir", "arg"),
        ("dpt_classic", "dir", "arg"),
        ("dpt_classic", "flat", "env"),
        ("zoedepth", "dir", "env"),
        ("zoedepth", "flat", "arg"),
    ],
)
def test_manager_serves_checkpoint(tmp_path, monkeypatch, family, layout, via):
    """``<dir>/<name>/model.safetensors`` or ``<dir>/<name>.safetensors``,
    named by the argument or by the environment: the served weights are
    the converted checkpoint's, bit for bit."""
    from safetensors.torch import save_file

    name = f"tiny-{family}"
    cfg = _tiny_cfg(family)
    monkeypatch.setitem(tda.PRESETS, name, cfg)
    sd = _golden_sd(family)
    path = tmp_path / name / "model.safetensors" if layout == "dir" else tmp_path / f"{name}.safetensors"
    path.parent.mkdir(parents=True, exist_ok=True)
    save_file(sd, str(path))
    if via == "env":
        monkeypatch.setenv(CHECKPOINT_ENV, str(tmp_path))
        mm = ModelManager("cpu", model_target=64)
    else:
        monkeypatch.delenv(CHECKPOINT_ENV, raising=False)
        mm = ModelManager("cpu", checkpoint_dir=str(tmp_path), model_target=64)
    pipe = mm.get(name)
    assert mm.random_weights[name] is False
    want = convert_checkpoint(cfg, sd)
    got = pipe.model.state_dict()
    assert set(got) == set(want)
    for key, val in want.items():
        assert torch.equal(got[key], val), key
    res = pipe.run(np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8))
    assert res.kept_point_count > 0 and np.isfinite(res.points).all()


def test_manager_without_checkpoint_uses_random_init(tmp_path, monkeypatch):
    monkeypatch.setitem(tda.PRESETS, "tiny-zoe", _tiny_cfg("zoedepth"))
    monkeypatch.delenv(CHECKPOINT_ENV, raising=False)
    mm = ModelManager("cpu", checkpoint_dir=str(tmp_path))  # empty directory
    pipe = mm.get("tiny-zoe")
    assert mm.random_weights["tiny-zoe"] is True
    assert pipe.model.backbone.cls_token.abs().sum() == 0  # BEiT's init


@pytest.mark.parametrize("value", ["1", "true", "YES", "0"])
def test_int8_flag_is_refused(monkeypatch, value):
    """``IPC_TPU_INT8`` as the JAX server reads it (1, true, yes in any
    case; once refused, now served): the manager serves the int8 W8A8
    encoder, every block matmul a QuantLinear, and a request runs; "0"
    serves the float encoder."""
    from image_to_pointcloud_tpu_torch.models.quantize import QuantLinear

    monkeypatch.setitem(tda.PRESETS, "tiny-dpt", _tiny_cfg("dpt_classic"))
    monkeypatch.delenv(CHECKPOINT_ENV, raising=False)
    monkeypatch.setenv("IPC_TPU_INT8", value)
    mm = ModelManager("cpu", model_target=64)
    pipe = mm.get("tiny-dpt")
    quant = [m for m in pipe.model.modules() if isinstance(m, QuantLinear)]
    assert mm.int8 is (value != "0")
    assert len(quant) == (0 if value == "0" else 6 * 4)  # q, k, v, proj, fc1, fc2 × 4 blocks
    assert pipe.model.cfg.backbone.quantized is mm.int8
    res = pipe.run(np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8))
    assert res.kept_point_count > 0 and np.isfinite(res.points).all()


def test_orbax_checkpoint_is_refused(tmp_path, monkeypatch):
    """An orbax directory takes priority in the JAX server; the port cannot
    read it, and must neither fall back to a safetensors file beside it
    nor to the random init."""
    from safetensors.torch import save_file

    monkeypatch.setitem(tda.PRESETS, "tiny-dpt", _tiny_cfg("dpt_classic"))
    (tmp_path / "tiny-dpt" / "orbax").mkdir(parents=True)
    save_file(_golden_sd("dpt_classic"), str(tmp_path / "tiny-dpt.safetensors"))
    mm = ModelManager("cpu", checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="orbax checkpoint"):
        mm.get("tiny-dpt")
    assert "tiny-dpt" not in mm.random_weights


def test_manager_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelManager("cuda")
