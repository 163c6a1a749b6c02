"""The plain reference of the two depth models, as functions of a state
dict: Depth-Anything-V2 (DINOv2 ViT with LayerScale + the DPT neck of
Depth Anything) and classic DPT (plain ViT with readout projection +
the MiDaS 3.0 neck and monodepth head).

Follows the published architectures (arXiv:2406.09414, arXiv:2103.13413;
the HF ``modeling_dpt`` / ``modeling_depth_anything`` layouts) with the
parameter names of the served modules, so one state dict drives both.
Exact GELU, f32 throughout, attention materialized; resampling inside the
neck is the align-corners bilinear (``linear_ac``) and half-pixel
bilinear of those layouts. ``fp8=True`` is the control: every matrix
product and convolution takes its inputs and weights rounded to
float8 e4m3 (per-tensor scale), the step below the served bf16.

:func:`param_specs` lists every parameter with its initializer kind,
which ``portbench/weights.py`` draws from the seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.ops import resize_planes

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor."""
    s = x.abs().amax().clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Ops:
    def __init__(self, sd: dict, fp8: bool):
        self.sd, self.fp8 = sd, fp8

    def q(self, x):
        return _fp8(x) if self.fp8 else x

    def w(self, name):
        return self.q(self.sd[name + ".weight"])

    def b(self, name):
        return self.sd.get(name + ".bias")

    def linear(self, x, name):
        return F.linear(self.q(x), self.w(name), self.b(name))

    def conv(self, x, name, stride=1, padding=None):
        w = self.w(name)
        pad = (w.shape[-1] // 2) if padding is None else padding
        return F.conv2d(self.q(x), w, self.b(name), stride=stride, padding=pad)

    def conv_t(self, x, name, k):
        return F.conv_transpose2d(self.q(x), self.w(name), self.b(name), stride=k)

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def ln(self, x, name, eps):
        return F.layer_norm(x, x.shape[-1:], self.sd[name + ".weight"], self.sd[name + ".bias"], eps)


def param_specs(arch: dict) -> list[tuple[str, tuple, str, int]]:
    """Every parameter of the model: (name, shape, init kind, fan-in).
    Kinds: ``lecun`` (truncated normal of variance 1/fan-in), ``lecun_abs``
    (its absolute value), ``zeros``, ``ones``, ``normal`` (σ 0.02)."""
    d, p, L = arch["hidden_size"], arch["patch_size"], arch["num_hidden_layers"]
    mlp = arch["intermediate_size"]
    c, f, hh = arch["neck_hidden_sizes"], arch["fusion_hidden_size"], arch["head_hidden_size"]
    classic = arch["family"] == "vit_dpt_classic"
    out: list = []

    def dense(name, n_out, n_in):
        out.extend([(f"{name}.weight", (n_out, n_in), "lecun", n_in), (f"{name}.bias", (n_out,), "zeros", 0)])

    def conv(name, n_out, n_in, k, bias=True):
        out.append((f"{name}.weight", (n_out, n_in, k, k), "lecun", n_in * k * k))
        if bias:
            out.append((f"{name}.bias", (n_out,), "zeros", 0))

    def norm(name):
        out.extend([(f"{name}.weight", (d,), "ones", 0), (f"{name}.bias", (d,), "zeros", 0)])

    dense("backbone.patch_embed", d, p * p * 3)
    out.append(("backbone.cls_token", (1, 1, d), "normal", 0))
    out.append(("backbone.pos_embed", (1, arch["pos_embed_size"] ** 2 + 1, d), "normal", 0))
    for i in range(L):
        pre = f"backbone.blocks.{i}"
        norm(f"{pre}.norm1")
        for n in ("q", "k", "v", "proj"):
            dense(f"{pre}.{n}", d, d)
        if not classic:
            out.append((f"{pre}.ls1", (d,), "ones", 0))
        norm(f"{pre}.norm2")
        dense(f"{pre}.mlp.fc1", mlp, d)
        dense(f"{pre}.mlp.fc2", d, mlp)
        if not classic:
            out.append((f"{pre}.ls2", (d,), "ones", 0))
    if not classic:
        norm("backbone.norm")
    for i in range(4):
        if classic:
            dense(f"neck.readout{i}", d, 2 * d)
        conv(f"neck.proj{i}", c[i], d, 1)
        conv(f"neck.conv{i}", f, c[i], 3, bias=False)
    # Transposed convolutions: weight (in, out, k, k), fan-in in·k².
    out.extend([("neck.up0.weight", (c[0], c[0], 4, 4), "lecun", c[0] * 16), ("neck.up0.bias", (c[0],), "zeros", 0),
                ("neck.up1.weight", (c[1], c[1], 2, 2), "lecun", c[1] * 4), ("neck.up1.bias", (c[1],), "zeros", 0)])
    conv("neck.down3", c[3], c[3], 3)
    for j in range(4):
        for unit in (("res1", "res2") if j > 0 else ("res2",)):
            conv(f"neck.fusion{j}.{unit}.conv1", f, f, 3)
            conv(f"neck.fusion{j}.{unit}.conv2", f, f, 3)
        conv(f"neck.fusion{j}.projection", f, f, 1)
    conv("neck.head_conv1", f // 2, f, 3)
    conv("neck.head_conv2", hh, f // 2, 3)
    out.append(("neck.head_conv3.weight", (1, hh, 1, 1), "lecun_abs", hh))
    out.append(("neck.head_conv3.bias", (1,), "zeros", 0))
    return out


def _pos_embed(o: _Ops, arch: dict, ph: int, pw: int) -> torch.Tensor:
    pos = o.sd["backbone.pos_embed"]
    n = arch["pos_embed_size"]
    if (ph, pw) == (n, n):
        return pos
    method = "linear" if arch["family"] == "vit_dpt_classic" else "bicubic_torch"
    grid = pos[0, 1:].reshape(n, n, -1).permute(2, 0, 1)
    grid = resize_planes(grid, (ph, pw), method).permute(1, 2, 0).reshape(1, ph * pw, -1)
    return torch.cat([pos[:, :1], grid], dim=1)


def _attention(o: _Ops, x: torch.Tensor, pre: str, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    dh = d // heads

    def split(y):
        return y.reshape(b, t, heads, dh).transpose(1, 2)

    q, k, v = (split(o.linear(x, f"{pre}.{n}")) for n in ("q", "k", "v"))
    probs = torch.softmax(o.mm(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
    return o.linear(o.mm(probs, v).transpose(1, 2).reshape(b, t, d), f"{pre}.proj")


def _encoder(o: _Ops, arch: dict, pixels: torch.Tensor) -> list[torch.Tensor]:
    """(B, H, W, 3) normalized pixels → the tap layers' token sequences."""
    b, h, w, _ = pixels.shape
    p, eps = arch["patch_size"], arch["layer_norm_eps"]
    ph, pw = h // p, w // p
    x = pixels.reshape(b, ph, p, pw, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, ph * pw, p * p * 3)
    x = o.linear(x, "backbone.patch_embed")
    x = torch.cat([o.sd["backbone.cls_token"].expand(b, 1, -1), x], dim=1) + _pos_embed(o, arch, ph, pw)
    ls = arch["family"] != "vit_dpt_classic"
    outs = []
    for i in range(arch["num_hidden_layers"]):
        pre = f"backbone.blocks.{i}"
        y = _attention(o, o.ln(x, f"{pre}.norm1", eps), pre, arch["num_attention_heads"])
        x = x + (o.sd[f"{pre}.ls1"] * y if ls else y)
        y = o.linear(F.gelu(o.linear(o.ln(x, f"{pre}.norm2", eps), f"{pre}.mlp.fc1")), f"{pre}.mlp.fc2")
        x = x + (o.sd[f"{pre}.ls2"] * y if ls else y)
        outs.append(x)
    return [outs[i] for i in arch["out_indices"]]


def _residual_unit(o: _Ops, x, name):
    return x + o.conv(torch.relu(o.conv(torch.relu(x), f"{name}.conv1")), f"{name}.conv2")


def _fusion(o: _Ops, j: int, x, residual=None, out_hw=None):
    if residual is not None:
        if residual.shape[-2:] != x.shape[-2:]:
            residual = resize_planes(residual, tuple(x.shape[-2:]), "linear")
        x = x + _residual_unit(o, residual, f"neck.fusion{j}.res1")
    x = _residual_unit(o, x, f"neck.fusion{j}.res2")
    out_hw = out_hw or (x.shape[-2] * 2, x.shape[-1] * 2)
    return o.conv(resize_planes(x, tuple(out_hw), "linear_ac"), f"neck.fusion{j}.projection")


def _neck(o: _Ops, arch: dict, maps: list[torch.Tensor], ph: int, pw: int) -> torch.Tensor:
    """4 (B, D, ph, pw) maps, shallow → deep → (B, H, W) relative depth."""
    stages = []
    for i, x in enumerate(maps):
        x = o.conv(x, f"neck.proj{i}")
        if i == 0:
            x = o.conv_t(x, "neck.up0", 4)
        elif i == 1:
            x = o.conv_t(x, "neck.up1", 2)
        elif i == 3:
            x = o.conv(x, "neck.down3", stride=2, padding=1)
        stages.append(o.conv(x, f"neck.conv{i}"))
    classic = arch["family"] == "vit_dpt_classic"
    rev = stages[::-1]
    fused = None
    for j, hs in enumerate(rev):
        nxt = None if classic or j == len(rev) - 1 else tuple(rev[j + 1].shape[-2:])
        fused = _fusion(o, j, hs, out_hw=nxt) if fused is None else _fusion(o, j, fused, hs, out_hw=nxt)
    x = o.conv(fused, "neck.head_conv1")
    size = (x.shape[-2] * 2, x.shape[-1] * 2) if classic else (ph * arch["patch_size"], pw * arch["patch_size"])
    x = o.conv(torch.relu(o.conv(resize_planes(x, size, "linear_ac"), "neck.head_conv2")), "neck.head_conv3")
    return torch.relu(x)[:, 0]


def forward(sd: dict, arch: dict, pixels: torch.Tensor, *, fp8: bool = False) -> torch.Tensor:
    """(B, H, W, 3) normalized f32 pixels → (B, H, W) f32 relative depth."""
    o = _Ops(sd, fp8)
    b, h, w, _ = pixels.shape
    p, d = arch["patch_size"], arch["hidden_size"]
    ph, pw = h // p, w // p
    taps = _encoder(o, arch, pixels)
    maps = []
    for i, t in enumerate(taps):
        if arch["family"] == "vit_dpt_classic":
            tok = t[:, 1:]
            x = F.gelu(o.linear(torch.cat([tok, t[:, :1].expand_as(tok)], dim=-1), f"neck.readout{i}"))
        else:
            x = o.ln(t, "backbone.norm", arch["layer_norm_eps"])[:, 1:]
        maps.append(x.transpose(1, 2).reshape(b, d, ph, pw))
    return _neck(o, arch, maps, ph, pw)
