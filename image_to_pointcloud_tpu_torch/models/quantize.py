"""Int8 (W8A8) quantized inference for the ViT encoders.

Counterpart of ``image_to_pointcloud_tpu/models/quantize.py``: post-training
quantization of every encoder block's matmuls (DINOv2, ViT, BEiT), the
neck, head, layer norms, patch embedding and attention staying in the
float compute dtype.

* Weights: symmetric per-output-channel int8, ``w_q = round(w / scale)``
  with ``scale = max(max|w|, 1e-8) / 127`` per output channel.
* Activations: dynamic symmetric per-token int8, computed in the forward.
* The int8 × int8 product accumulates in int32 (``torch._int_mm``:
  cuBLASLt on the card, as the JAX package leaves it to XLA's
  ``dot_general``; not a Pallas kernel there, so not a hand kernel here),
  then dequantizes with the product of the two scales, plus the bias, in
  f32.

The arithmetic is the JAX package's, rounded at the same points, so the
codes, the scales and the int32 accumulator are bit-identical to it on
the same inputs. One trap: inside ``jax.jit``, XLA turns the activation
scale's ``a_max / 127.0`` into ``a_max * f32(1/127)``, which differs by an
ulp on ~4 % of rows; the forward multiplies by that reciprocal. The weight
scale is computed eagerly in JAX, a true division, and divides here too;
``x / a_scale`` stays a division under ``jax.jit``. The dequantization
``acc · a_scale · kernel_scale + bias`` has XLA's rounding: its last
multiply and the bias add fused into one multiply-add.

``QuantLinear`` keeps ``weight_scale`` and ``bias`` in f32 whatever
``.to(dtype)`` asks (the JAX package keeps them as f32 params beside a
bf16 model), and ``weight_q`` int8, laid out (out, in) like a Linear's
weight; its output has the input's dtype.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = [
    "QUANT_TARGETS",
    "QuantLinear",
    "block_dense",
    "int8_matmul",
    "quantize_activations",
    "quantize_dense_params",
    "quantize_encoder_params",
]

# Linear submodules of each encoder block that carry the matmul FLOPs, by
# the JAX package's names: DINOv2's and ViT's layout first, then BEiT's
# (attention under attn/, the MLP at block level). Missing paths are
# skipped, so one list serves every family.
QUANT_TARGETS = (
    "q", "k", "v", "proj", "mlp/fc1", "mlp/fc2",
    "attn/q", "attn/k", "attn/v", "attn/proj", "fc1", "fc2",
)

# f32(1/127): XLA's rewrite of the jitted activation scale's division.
_INV_127 = float(np.float32(1.0 / 127.0))


def block_dense(quantized: bool, d_in: int, d_out: int, *, bias: bool = True) -> nn.Module:
    """Encoder-block matmul: ``nn.Linear``, or :class:`QuantLinear` when
    quantized; one dispatch shared by every backbone."""
    if quantized:
        return QuantLinear(d_in, d_out, bias=bias)
    return nn.Linear(d_in, d_out, bias=bias)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 × (K, N) int8 → (M, N) int32, exact.

    ``torch._int_mm`` (cuBLASLt on CUDA) needs M > 16 and K, N multiples
    of 8 on the card, and takes ``b`` column-major (a transposed (N, K)
    weight). On CUDA a shape outside those rules raises; on the CPU it
    takes an int32 matmul, exact as well (tiny test models only)."""
    m, k = a.shape
    n = b.shape[1]
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(a, b)
    if a.is_cuda:
        raise ValueError(f"int8_matmul: ({m}, {k}) x ({k}, {n}) is outside _int_mm's "
                         "rules on CUDA (rows > 16, k and n multiples of 8)")
    return torch.matmul(a.to(torch.int32), b.to(torch.int32))


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-token int8: (int8 codes, f32 (..., 1) scales);
    round half to even, then clip to ±127."""
    xf = x.float()
    a_scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * _INV_127
    return torch.round(xf / a_scale).clamp(-127, 127).to(torch.int8), a_scale


class QuantLinear(nn.Module):
    """Drop-in Linear with int8 weights and dynamic int8 activations
    (``QuantDense``). Buffers: ``weight_q`` int8 (out, in),
    ``weight_scale`` f32 (out,), ``bias`` f32 (out,) or None."""

    _F32 = ("weight_scale", "bias")

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    def _apply(self, fn, recurse=True):
        # Move the f32 buffers as int32 views: ``fn`` changes only the
        # device of a non-float tensor, so ``.to(dtype)`` leaves them f32.
        f32 = [n for n in self._F32 if self._buffers.get(n) is not None]
        for n in f32:
            self._buffers[n] = self._buffers[n].view(torch.int32)
        try:
            return super()._apply(fn, recurse)
        finally:
            for n in f32:
                self._buffers[n] = self._buffers[n].view(torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_q, a_scale = quantize_activations(x)
        acc = int8_matmul(x_q.reshape(-1, self.in_features), self.weight_q.T)
        out = acc.reshape(*x.shape[:-1], self.out_features).float() * a_scale
        if self.bias is None:
            return (out * self.weight_scale).to(x.dtype)
        # XLA contracts ``· kernel_scale + bias`` into one fused
        # multiply-add. In f64 the product is exact and the sum rounds
        # once before the f32 rounding: the FMA's result, but where that
        # sum lands on an f32 halfway point (~2^-29 of the elements).
        out = out.double() * self.weight_scale.double() + self.bias.double()
        return out.float().to(x.dtype)


def quantize_dense_params(weight: torch.Tensor, bias: torch.Tensor | None = None) -> dict:
    """A Linear's f32 ``weight`` (out, in) [and ``bias``] → ``{"weight_q",
    "weight_scale"[, "bias"]}``, :class:`QuantLinear`'s buffers."""
    w = weight.detach().float()
    scale = w.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    out = {"weight_q": torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8),
           "weight_scale": scale}
    if bias is not None:
        out["bias"] = bias.detach().float()
    return out


def quantize_encoder_params(state_dict: dict, num_layers: int) -> dict:
    """Quantize every encoder block's Linear layers in a f32 model's
    ``state_dict`` (``backbone.blocks.{i}.<target>``), for a model built
    from the config's ``with_quantized(True)``; everything else is kept."""
    out = dict(state_dict)
    for i in range(num_layers):
        for target in QUANT_TARGETS:
            pre = f"backbone.blocks.{i}.{target.replace('/', '.')}."
            if pre + "weight" not in out:
                continue
            q = quantize_dense_params(out.pop(pre + "weight"), out.pop(pre + "bias", None))
            out.update({pre + k: v for k, v in q.items()})
    return out
