"""Weights made from the seed on the device, and the port's model built
around them.

The distributions are a frozen copy of the served models' random init
(the port's ``models/depth_anything.py::init_weights``): truncated-normal
LeCun weights for matrix products and convolutions (variance 1/fan-in,
cut at ±2σ), the last head convolution's absolute value, zero biases,
unit norms and LayerScale, N(0, 0.02) class token and position
embeddings. They are drawn in two calls on the device's generator and
cast once to the served dtype, so every run of one seed on one device
gets the same numbers, and the program and the reference the same state
dict.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.model import param_specs

_TRUNC_STD = 0.87962566103423978  # σ of a unit normal cut at ±2


@torch.no_grad()
def make_state_dict(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{name: tensor} of the configuration's model, on ``device`` in
    ``dtype``, from ``seed``."""
    specs = param_specs(cfg["arch"])
    numel = [math.prod(shape) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed & 0xFFFF_FFFF_FFFF_FFFF)
    n_trunc = sum(n for n, (_, _, kind, _) in zip(numel, specs) if kind.startswith("lecun"))
    n_normal = sum(n for n, (_, _, kind, _) in zip(numel, specs) if kind == "normal")
    trunc = torch.nn.init.trunc_normal_(torch.empty(n_trunc, device=device), 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
    normal = torch.randn(n_normal, device=device, generator=gen) * 0.02
    flat = torch.empty(sum(numel), device=device, dtype=torch.float32)
    off = ot = on = 0
    for (name, shape, kind, fan_in), n in zip(specs, numel):
        dst = flat[off:off + n]
        if kind.startswith("lecun"):
            src = trunc[ot:ot + n] * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)
            dst.copy_(src.abs() if kind == "lecun_abs" else src)
            ot += n
        elif kind == "normal":
            dst.copy_(normal[on:on + n])
            on += n
        else:
            dst.fill_(1.0 if kind == "ones" else 0.0)
        off += n
    flat = flat.to(dtype)
    out, off = {}, 0
    for (name, shape, _, _), n in zip(specs, numel):
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def seeded_manager(state_dict: dict, device="cuda", **kwargs):
    """The port's ``ModelManager`` whose models take ``state_dict``, built
    on the meta device and assigned it: no init on the host, no copy."""
    from image_to_pointcloud_tpu_torch.models.depth_anything import build_model, preset
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    class SeededManager(ModelManager):
        def load_model(self, name, cfg=None):
            cfg = preset(name) if cfg is None else cfg
            with torch.device("meta"):
                model = build_model(cfg)
            model.load_state_dict(state_dict, strict=True, assign=True)
            self.random_weights[name] = True
            return model

    return SeededManager(device, **kwargs)
