"""The port's SegFormer matte against the JAX package's, on the CPU.

Flax parameters cross to the port through ``models/bridge.py`` (the frozen
BatchNorm's running statistics drawn away from their identity init, so a
lost or misnamed ``mean``/``var`` shows); HF state dicts through the
port's own ``convert_segformer``. Tolerances:

* SegFormer forward and the golden fixture: 5e-5 max-normalized
  (PARITY.md's model tolerance);
* ``MatteModel``: the 512² foreground probability within 1e-5 (f32 sums
  in another order), and the alpha the processor uses (8-bit PIL resizes
  of it) within one level, 1/255.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax
from image_to_pointcloud_tpu_torch.models.convert import convert_segformer
from image_to_pointcloud_tpu_torch.models.segformer import SegformerConfig, SegformerMatte

FIXDIR = Path(__file__).resolve().parent / "fixtures"
# tests/test_segformer_matte.py's tiny config.
TINY = dict(hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4),
            sr_ratios=(8, 4, 2, 1), decoder_hidden_size=16)


def _assert_close_normalized(ours, ref, atol=5e-5):
    assert ours.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(ours / scale, ref / scale, atol=atol)


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX model, Flax params as numpy with drawn BN statistics, the port's
    model with the same weights)."""
    from image_to_pointcloud_tpu.models import SegformerConfig as JCfg
    from image_to_pointcloud_tpu.models import SegformerMatte as JSeg

    jmodel = JSeg(JCfg(**TINY, num_labels=1))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    r = np.random.default_rng(5)
    params["bn"] = {
        "scale": r.uniform(0.5, 1.5, 16).astype(np.float32),
        "bias": r.normal(0, 0.1, 16).astype(np.float32),
        "mean": r.normal(0, 0.5, 16).astype(np.float32),
        "var": r.uniform(0.2, 2.0, 16).astype(np.float32),
    }
    model = SegformerMatte(SegformerConfig(**TINY, num_labels=1))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jmodel, params, model


def test_bridge_carries_the_frozen_batchnorm(tiny_pair):
    _, params, model = tiny_pair
    sd = model.state_dict()
    for flax_leaf, name in (("scale", "bn.weight"), ("bias", "bn.bias"), ("mean", "bn.mean"),
                            ("var", "bn.var")):
        assert np.array_equal(sd[name].numpy(), params["bn"][flax_leaf]), name
    # The depthwise HWIO (3, 3, 1, C) kernel becomes the groups=C weight.
    dw = params["stage0_block0"]["mlp"]["dwconv"]["kernel"]
    assert sd["stage0_block0.mlp.dwconv.weight"].shape == (dw.shape[3], 1, 3, 3)


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)])
def test_segformer_forward_matches_flax(rng, tiny_pair, hw):
    jmodel, params, model = tiny_pair
    x = rng.normal(0, 1, (2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == (2, hw[0] // 4, hw[1] // 4, 1)
    _assert_close_normalized(ours, ref)


def test_segformer_golden_fixture():
    """The committed HF-oracle fixture (an HF state dict, its input and the
    HF logits) through the port's ``convert_segformer``, as
    tests/test_golden_fixtures.py replays it in Flax."""
    z = np.load(FIXDIR / "golden_segformer.npz")
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd/")}
    model = SegformerMatte(SegformerConfig(**TINY, num_labels=1))
    model.load_state_dict(convert_segformer(sd), strict=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(z["input"])).numpy().transpose(0, 3, 1, 2)
    _assert_close_normalized(ours, z["output"])


def _write_b0(root: Path, num_labels: int, seed: int) -> Path:
    """A random HF SegFormer-B0 matte checkpoint at <root>/matting/."""
    from safetensors.torch import save_file
    from transformers import SegformerConfig as HFSegConfig
    from transformers import SegformerForSemanticSegmentation

    torch.manual_seed(seed)
    hf = SegformerForSemanticSegmentation(HFSegConfig(num_labels=num_labels)).eval()
    sd = hf.state_dict()
    # Running statistics away from the identity, as a trained head has.
    c = sd["decode_head.batch_norm.running_mean"].shape[0]
    g = torch.Generator().manual_seed(seed)
    sd["decode_head.batch_norm.running_mean"] = torch.randn(c, generator=g) * 0.3
    sd["decode_head.batch_norm.running_var"] = torch.rand(c, generator=g) + 0.5
    (root / "matting").mkdir(parents=True)
    save_file({k: v.contiguous() for k, v in sd.items()}, str(root / "matting" / "model.safetensors"))
    return root


@pytest.mark.parametrize("num_labels", [1, 2])
def test_matte_model_matches_jax(tmp_path, num_labels):
    """One model.safetensors, loaded by both packages' ``load_matte_model``:
    the probability map and the alpha agree."""
    from PIL import Image

    from image_to_pointcloud_tpu.serve.matting import load_matte_model as jload
    from image_to_pointcloud_tpu_torch.serve.matting import load_matte_model

    root = _write_b0(tmp_path / "ck", num_labels, seed=num_labels)
    ours, ref = load_matte_model(root, "cpu"), jload(root)
    assert ours is not None and ref is not None
    assert ours.num_labels == ref.num_labels == num_labels

    img = np.random.default_rng(num_labels).integers(0, 256, (80, 100, 3), dtype=np.uint8)
    im512 = np.asarray(Image.fromarray(img).resize((512, 512), Image.BILINEAR))[None]
    p_ours = ours.prob(im512)
    p_ref = np.asarray(ref._fn(ref._params, im512))
    assert p_ours.shape == p_ref.shape == (1, 512, 512)
    np.testing.assert_allclose(p_ours, p_ref, atol=1e-5)
    assert p_ref.std() > 1e-3  # a varied map, not a constant

    a_ours, a_ref = ours.alpha(img), ref.alpha(img)
    assert a_ours.shape == (80, 100) and a_ours.dtype == np.float32
    assert np.abs(a_ours - a_ref).max() <= 1 / 255 + 1e-7


def test_load_matte_model_falls_back(tmp_path, caplog, monkeypatch):
    """No directory, no file: None. A broken file (not safetensors) and a
    checkpoint of another shape (the tiny config, not B0): logged, None —
    the processor then takes the classical matte."""
    from safetensors.torch import save_file

    from image_to_pointcloud_tpu_torch.serve.matting import load_matte_model

    monkeypatch.delenv("IPC_TPU_CHECKPOINT_DIR", raising=False)
    assert load_matte_model(None, "cpu") is None
    assert load_matte_model(tmp_path / "nope", "cpu") is None
    (tmp_path / "broken" / "matting").mkdir(parents=True)
    (tmp_path / "broken" / "matting" / "model.safetensors").write_bytes(b"not a checkpoint")
    assert load_matte_model(tmp_path / "broken", "cpu") is None

    z = np.load(FIXDIR / "golden_segformer.npz")
    (tmp_path / "tiny" / "matting").mkdir(parents=True)
    save_file({k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd/")},
              str(tmp_path / "tiny" / "matting" / "model.safetensors"))
    with caplog.at_level("WARNING"):
        assert load_matte_model(tmp_path / "tiny", "cpu") is None
    assert "falling back to the classical matte" in caplog.text
