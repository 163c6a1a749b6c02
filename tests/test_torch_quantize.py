"""The port's int8 W8A8 encoder (``models/quantize.py``) against the JAX
package's, on the CPU.

Tolerances:

* ``quantize_dense_params``: weight codes and scales bit-identical (both
  divide by 127 eagerly).
* ``QuantLinear`` against ``QuantDense`` under ``jax.jit``: activation
  codes, the int32 accumulator and the output bit-identical, f32 and bf16,
  on random rows and on rows built to sit where ``x / a_scale`` and
  ``x * (1 / a_scale)`` round to different codes (inside ``jax.jit`` the
  division stays a division; the scale's own ``a_max / 127`` becomes a
  multiply by f32(1/127), which the port copies).
* The tiny int8 models of the three families against JAX's int8 models,
  weights carried across by the bridge (int8 codes included): mean error
  below 0.1 % of the mean |depth| and max-normalized error below 1 %
  (measured: DA and classic DPT ~2e-6, ZoeDepth 2e-4 mean and 2.5e-3
  max). The codes are exact per layer, but the f32 parts upstream of a
  layer (layer norms, attention) agree only to ~1e-6, and a value that
  close to a code's rounding boundary flips one code step (1/127 of its
  row's max).
  JAX's own bar for int8 against f32 is 5 % of the mean
  (``tests/test_model_parity.py``); both packages' int8 models stay
  within it of their f32 models here.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from image_to_pointcloud_tpu_torch.models import depth_anything as tda
from image_to_pointcloud_tpu_torch.models import quantize as tq
from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax

sys.path.insert(0, str(Path(__file__).resolve().parent))

F32 = np.float32


def _jax_codes(x):
    """QuantDense's activation quantization as ``jax.jit`` compiles it
    (``image_to_pointcloud_tpu/models/quantize.py``, lines 88-91)."""
    xf = x.astype(jnp.float32)
    a_max = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    a_scale = jnp.maximum(a_max, 1e-8) / 127.0
    return jnp.clip(jnp.round(xf / a_scale), -127, 127).astype(jnp.int8), a_scale


def _boundary_rows(width: int = 16, n_rows: int = 24) -> np.ndarray:
    """Rows [a_max, x_1, ...] whose x_j / a_scale and x_j · f32(1 / a_scale)
    round to different integers (a_scale = a_max · f32(1/127))."""
    rng = np.random.default_rng(7)
    rows = []
    while len(rows) < n_rows:
        a = F32(rng.uniform(0.5, 8.0))
        s = F32(a * F32(1.0 / 127.0))
        r = F32(F32(1.0) / s)
        c = ((np.arange(126) + 0.5) * np.float64(s)).astype(F32)
        cand = np.concatenate([c, *(np.nextafter(c, F32(d * np.inf)) for d in (-1, 1))])
        cand = cand[cand <= a]
        split = np.round(cand / s) != np.round(cand * r)
        if split.sum() >= width - 1:
            rows.append(np.concatenate([[a], rng.permutation(cand[split])[: width - 1]]))
    return np.stack(rows).astype(F32) * np.where(np.arange(width) % 3 == 2, -1, 1).astype(F32)


def test_quantize_dense_params_bit_identical():
    from image_to_pointcloud_tpu.models.quantize import quantize_dense_params

    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.05, (48, 40)).astype(F32)  # (in, out)
    w[:, 3] = 0.0  # the 1e-8 floor of the scale
    b = rng.normal(0, 0.01, (40,)).astype(F32)
    ref = jax.tree_util.tree_map(np.asarray, quantize_dense_params({"kernel": w, "bias": b}))
    ours = tq.quantize_dense_params(torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    assert ours["weight_q"].dtype == torch.int8 and ours["weight_scale"].dtype == torch.float32
    np.testing.assert_array_equal(ours["weight_q"].numpy(), ref["kernel_q"].T)
    np.testing.assert_array_equal(ours["weight_scale"].numpy(), ref["kernel_scale"])
    np.testing.assert_array_equal(ours["bias"].numpy(), ref["bias"])
    assert "bias" not in tq.quantize_dense_params(torch.from_numpy(w.T.copy()))


class _Holder(nn.Module):
    def __init__(self, lin):
        super().__init__()
        self.lin = lin


@pytest.mark.parametrize("inputs", ["random", "rounding_boundaries"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_linear_matches_quant_dense(inputs, dtype):
    from image_to_pointcloud_tpu.models.quantize import QuantDense, quantize_dense_params

    rng = np.random.default_rng(1)
    d_in, d_out = 16, 24
    if inputs == "random":
        x = rng.normal(0, 1.0, (3, 11, d_in)).astype(F32)
    else:
        x = _boundary_rows(d_in)[None]
    w = rng.normal(0, 0.05, (d_in, d_out)).astype(F32)
    b = rng.normal(0, 0.01, (d_out,)).astype(F32)
    qp = jax.tree_util.tree_map(np.asarray, quantize_dense_params({"kernel": w, "bias": b}))
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x).astype(jdt)
    ref = np.asarray(jax.jit(QuantDense(d_out, dtype=jdt).apply)({"params": qp}, xj)).astype(F32)
    ref_codes, _ = jax.jit(_jax_codes)(xj)
    ref_acc = jax.jit(lambda c, k: jax.lax.dot_general(
        c, k, (((2,), (0,)), ((), ())), preferred_element_type=jnp.int32))(ref_codes, qp["kernel_q"])

    holder = _Holder(tq.QuantLinear(d_in, d_out))
    holder.load_state_dict(state_dict_from_flax({"lin": qp}), strict=True)
    lin = holder.lin.to(getattr(torch, dtype))
    assert lin.weight_q.dtype == torch.int8
    assert lin.weight_scale.dtype == lin.bias.dtype == torch.float32  # kept through .to(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    codes, _ = tq.quantize_activations(xt)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    acc = tq.int8_matmul(codes.reshape(-1, d_in), lin.weight_q.T).reshape(*x.shape[:2], d_out)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref_acc))
    out = lin(xt)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out.float().numpy(), ref)


def test_int8_matmul_rules():
    """``_int_mm``'s shapes and the CPU's exact fallback for the others."""
    rng = np.random.default_rng(2)
    for m, k, n in [(17, 16, 8), (5, 12, 7), (40, 384, 24)]:
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
        got = tq.int8_matmul(a, w.T)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), a.numpy().astype(np.int64) @ w.numpy().T)


def test_quantize_encoder_params_targets():
    """Every block matmul of each family is quantized (BEiT's bias-free
    key included); nothing else changes."""
    from test_torch_families import _port_cfg

    for cfg in (tda.preset("depth-anything-v2"), _port_cfg("dpt_classic"), _port_cfg("zoedepth")):
        sd = tda.build_model(cfg).state_dict()
        q = tq.quantize_encoder_params(sd, cfg.backbone.num_layers)
        qmodel = tda.build_model(cfg.with_quantized(True))
        qmodel.load_state_dict(q, strict=True)
        n_quant = sum(isinstance(m, tq.QuantLinear) for m in qmodel.modules())
        assert n_quant == 6 * cfg.backbone.num_layers
        assert all(torch.equal(q[k], v) for k, v in sd.items() if "blocks." not in k)


def _jax_int8_pair(family: str):
    """(JAX f32 model, JAX int8 model, f32 params, int8 params, port f32
    model, port int8 model): the int8 tree crosses by the bridge."""
    from image_to_pointcloud_tpu.models import build_model
    from image_to_pointcloud_tpu.models.quantize import quantize_encoder_params
    from test_torch_families import _pair, _port_cfg
    from test_torch_model import _flax_pair, _tiny_kwargs

    if family == "depth_anything":
        jcfg, params, model = _flax_pair(layers=4, out_layers=(0, 1, 2, 3))
        from image_to_pointcloud_tpu_torch.models.dinov2 import DinoV2Config
        from image_to_pointcloud_tpu_torch.models.dpt import DPTConfig

        bb, nk = _tiny_kwargs(layers=4, out_layers=(0, 1, 2, 3))
        pcfg = tda.DepthAnythingConfig(backbone=DinoV2Config(**bb), neck=DPTConfig(**nk))
    else:
        jcfg, params, model = _pair(family)
        pcfg = _port_cfg(family)
    qparams = jax.tree_util.tree_map(
        np.asarray, quantize_encoder_params(params, jcfg.backbone.num_layers))
    qmodel = tda.build_model(pcfg.with_quantized(True))
    qmodel.load_state_dict(state_dict_from_flax(qparams), strict=True)
    return (build_model(jcfg), build_model(jcfg.with_quantized(True)), params, qparams,
            model.eval(), qmodel.eval())


@pytest.mark.parametrize("family", ["depth_anything", "dpt_classic", "zoedepth"])
def test_tiny_int8_models_match_jax(family):
    jf, jq, params, qparams, model, qmodel = _jax_int8_pair(family)
    side = 56 if family == "depth_anything" else 64  # whole patches of 14 or 16
    x = np.random.default_rng(3).normal(0, 1, (2, side, side, 3)).astype(F32)
    ref = np.asarray(jax.jit(jq.apply)({"params": qparams}, jnp.asarray(x)))
    ref_f32 = np.asarray(jax.jit(jf.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        ours = qmodel(torch.from_numpy(x)).numpy()
        ours_f32 = model(torch.from_numpy(x)).numpy()
    assert np.abs(ref).max() > 1e-3
    mean_rel = np.abs(ours - ref).mean() / np.abs(ref).mean()
    max_norm = np.abs(ours - ref).max() / np.abs(ref).max()
    assert mean_rel < 1e-3 and max_norm < 1e-2, (mean_rel, max_norm)
    # Both int8 models within JAX's own bar of their f32 models.
    for q, f in ((ours, ours_f32), (ref, ref_f32)):
        assert np.abs(q - f).mean() / np.abs(f).mean() < 0.05


def test_manager_int8_argument_serves_quantized():
    """``ModelManager(int8=True)`` quantizes the f32 weights before the
    move, whatever the environment says."""
    import os

    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    assert os.environ.get("IPC_TPU_INT8") in (None, "", "0")
    mm = ModelManager("cpu", int8=True, model_target=70)
    pipe = mm.get("depth-anything-v2")
    assert sum(isinstance(m, tq.QuantLinear) for m in pipe.model.modules()) == 72
    res = pipe.run(np.random.default_rng(0).integers(0, 256, (60, 80, 3), dtype=np.uint8))
    assert res.kept_point_count > 0 and np.isfinite(res.points).all()
    ref = ModelManager("cpu", int8=False, model_target=70).get("depth-anything-v2")
    ours = pipe.model.backbone.blocks[0].q
    lin = ref.model.backbone.blocks[0].q
    q = tq.quantize_dense_params(lin.weight, lin.bias)
    assert torch.equal(ours.weight_q, q["weight_q"]) and torch.equal(ours.weight_scale, q["weight_scale"])
