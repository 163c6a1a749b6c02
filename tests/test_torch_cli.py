"""The port's CLI (``image_to_pointcloud_tpu_torch.cli``) against the JAX
package's, on the CPU.

* Writers and plumbing: both CLIs' ``convert`` with one stub pipeline that
  returns the same points: every format's output file is byte-identical
  (ply, las, laz → .las, xyz, pcd, glb), and so are the port's copies of
  the PCD, GLB and OBJ writers on the same points.
* Each subcommand end to end, both CLIs on the same tiny Depth-Anything
  weights (through the bridge) and the same PNGs: the output PLY's points
  in the same order, per-point RMSE < 1e-3 and each coordinate within
  1e-4 (the CPU runs the f32 transfer, no codec), colours within half a
  level (voxel means: 1e-3).
* ``--device`` and ``--int8`` reach the model manager (a tiny preset);
  ``train`` and ``convert-ckpt`` refuse, as do ``serve --mesh`` and a
  ``--device cuda`` run without a card.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch import cli as tcli
from image_to_pointcloud_tpu_torch.io import read_ply

sys.path.insert(0, str(Path(__file__).resolve().parent))


def _png(path: Path, h: int, w: int, seed: int) -> str:
    from PIL import Image

    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 127 // (h + w)], -1)
    img = img + np.random.default_rng(seed).integers(0, 24, (h, w, 3))
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)
    return str(path)


def _stub(result_cls, points, colors):
    class Stub:
        def run_batch(self, images, **_kw):
            return [result_cls(points=points, colors=colors, depth_preview_rgb=None,
                               raw_point_count=len(points), kept_point_count=len(points))
                    for _ in images]

    return Stub()


@pytest.mark.parametrize("fmt", ["ply", "las", "laz", "xyz", "pcd", "glb"])
def test_convert_writes_the_same_bytes(tmp_path, monkeypatch, fmt):
    from image_to_pointcloud_tpu import cli as jcli
    from image_to_pointcloud_tpu.pipeline.graph import PipelineResult as JResult
    from image_to_pointcloud_tpu_torch.pipeline.graph import PipelineResult

    rng = np.random.default_rng(0)
    pts = rng.normal(0, 3, (500, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (500, 3)).astype(np.float32)
    img = _png(tmp_path / "a.png", 20, 24, 0)
    monkeypatch.setattr(jcli, "_load_pipeline", lambda a: _stub(JResult, pts, cols))
    monkeypatch.setattr(tcli, "_load_pipeline", lambda a: _stub(PipelineResult, pts, cols))
    outs = []
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        out = tmp_path / name / f"cloud.{fmt}"
        out.parent.mkdir()
        assert main(["convert", img, "-o", str(out), "--format", fmt]) == 0
        outs.append(out.with_suffix(".las") if fmt == "laz" else out)
    assert outs[0].read_bytes() == outs[1].read_bytes() and outs[0].stat().st_size > 0


def test_new_writers_match_jax_bytes(tmp_path):
    """The port's copies of io/pcd.py, io/glb.py and io/obj.py."""
    from image_to_pointcloud_tpu import io as jio
    from image_to_pointcloud_tpu_torch import io as tio

    rng = np.random.default_rng(1)
    pts = rng.normal(0, 3, (300, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (300, 3)).astype(np.float32)
    faces = rng.integers(0, 300, (200, 3)).astype(np.int32)
    assert tio.pcd_bytes(pts, cols) == jio.pcd_bytes(pts, cols)
    assert tio.obj_bytes(pts, faces, cols) == jio.obj_bytes(pts, faces, cols)
    for f in (None, faces):
        assert (tio.glb_bytes(pts, f, colors01=cols / 255.0, name="m")
                == jio.glb_bytes(pts, f, colors01=cols / 255.0, name="m"))


@pytest.fixture(scope="module")
def pipes():
    """Both packages' DepthPipeline and metric-head weights on one tiny
    Depth-Anything model (tests/test_advanced.py's), f32 transfer."""
    from test_model_parity import _build_pair
    from test_torch_advanced import _port_model

    from image_to_pointcloud_tpu.models import DepthAnythingConfig as JCfg
    from image_to_pointcloud_tpu.pipeline.graph import DepthPipeline as JPipe
    from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline

    _, model, variables = _build_pair(image_size=56)
    params = variables["params"]
    mcfg = JCfg(backbone=model.cfg.backbone,
                neck=dataclasses.replace(model.cfg.neck, metric_depth=True, max_depth=5.0))
    return {
        "relative": (JPipe(model.cfg, params, model_target=56, quantized_transfer=False),
                     DepthPipeline(_port_model(model.cfg, params), model_target=56)),
        "metric": (JPipe(mcfg, params, model_target=56, quantized_transfer=False),
                   DepthPipeline(_port_model(mcfg, params), model_target=56)),
    }


SUBCOMMANDS = {
    "convert": ("relative", ["convert", "{a}", "-o", "{out}", "--density", "high"]),
    "convert_fov": ("relative", ["convert", "{a}", "-o", "{out}", "--fov", "70", "--no-invert-depth"]),
    "mesh": ("relative", ["mesh", "{a}", "-o", "{out}"]),
    "highres": ("relative", ["highres", "{big}", "-o", "{out}", "--tile", "56", "--overlap", "14",
                             "--voxel-budget", "1500"]),
    "metric": ("metric", ["metric", "{a}", "-o", "{out}", "--fx", "100", "--fy", "110"]),
    "metric_fov": ("metric", ["metric", "{a}", "-o", "{out}", "--fov", "70"]),
    "video": ("relative", ["video", "{a}", "{b}", "-o", "{out}"]),
    "video_voxel": ("relative", ["video", "{a}", "{b}", "-o", "{out}", "--voxel", "0.5"]),
}


@pytest.mark.parametrize("case", list(SUBCOMMANDS))
def test_subcommand_matches_jax(tmp_path, monkeypatch, pipes, case):
    from image_to_pointcloud_tpu import cli as jcli

    kind, argv = SUBCOMMANDS[case]
    files = {"a": _png(tmp_path / "a.png", 56, 70, 0), "b": _png(tmp_path / "b.png", 56, 70, 1),
             "big": _png(tmp_path / "big.png", 112, 140, 2)}
    jpipe, tpipe = pipes[kind]
    monkeypatch.setattr(jcli, "_load_pipeline", lambda a: jpipe)
    monkeypatch.setattr(tcli, "_load_pipeline", lambda a: tpipe)
    clouds = []
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        out = tmp_path / f"{name}.ply"
        assert main([a.format(out=out, **files) for a in argv]) == 0
        v = read_ply(out.read_bytes())["vertex"]
        clouds.append((np.stack([v["x"], v["y"], v["z"]], 1),
                       np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float32)))
    (ref, ref_c), (ours, ours_c) = clouds
    assert ours.shape == ref.shape and len(ours) > 0
    assert np.sqrt(((ours - ref) ** 2).sum(1).mean()) < 1e-3
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours_c, ref_c, atol=1.0)


def test_device_and_int8_reach_the_manager(tmp_path, monkeypatch):
    """``--device cpu --int8`` builds the int8 encoder on the CPU; the
    default device is the card, which this machine lacks."""
    from test_torch_checkpoint import _tiny_cfg

    from image_to_pointcloud_tpu_torch.models import depth_anything as tda
    from image_to_pointcloud_tpu_torch.models.quantize import QuantLinear
    from image_to_pointcloud_tpu_torch.serve import models as tmodels

    monkeypatch.setitem(tda.PRESETS, "tiny-da", _tiny_cfg("depth_anything"))
    monkeypatch.delenv("IPC_TPU_INT8", raising=False)
    built = []
    real = tmodels.ModelManager.get

    def spy(self, name):
        pipe = real(self, name)
        built.append((self.device.type, self.int8, pipe))
        return pipe

    monkeypatch.setattr(tmodels.ModelManager, "get", spy)
    img = _png(tmp_path / "a.png", 40, 48, 0)
    for extra in ([], ["--int8"]):
        out = tmp_path / f"out{len(extra)}.ply"
        assert tcli.main(["convert", img, "-o", str(out), "--model", "tiny-da", "--device", "cpu",
                          *extra]) == 0
        assert len(read_ply(out.read_bytes())["vertex"]) > 0
    (dev0, int8_0, p0), (dev1, int8_1, p1) = built
    assert (dev0, int8_0, dev1, int8_1) == ("cpu", False, "cpu", True)
    assert not any(isinstance(m, QuantLinear) for m in p0.model.modules())
    assert any(isinstance(m, QuantLinear) for m in p1.model.modules())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["convert", img, "-o", str(tmp_path / "x.ply"), "--model", "tiny-da"])


@pytest.mark.parametrize("argv", [["train", "--steps", "2"], ["convert-ckpt", "model.safetensors"],
                                  ["serve", "--mesh", "data=2"]])
def test_unported_commands_refuse(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        tcli.main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert ("not ported" in err) and ("train/" in err or "--mesh" in err)
