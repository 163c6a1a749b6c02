"""ZoeDepth (ZoeD_N, arXiv:2302.12288): a BEiT encoder with a relative-
position bias in every layer (MiDaS v3.1's BEiT-L/16-384), the readout-
project reassemble and DPT fusion, the relative-depth head and the
metric-bins head (seed bins, unnormed attractors, a conditional
log-binomial over the bins), at the ZoeDepth processor's input: a reflect
pad, a keep-aspect resize toward (384, 512) in multiples of 32, and the
prediction resized back and cropped.

Written from HF ``modeling_beit`` (``BeitSelfAttention``,
``BeitRelativePositionBias``, ``BeitLayer``, ``BeitBackbone``),
``modeling_zoedepth`` (``ZoeDepthForDepthEstimation`` with one bin
configuration) and ``image_processing_zoedepth`` (transformers 4.57), with
the parameter names of the served modules. Plain torch, f32, exact GELU,
attention materialized; ``fp8=True`` is the control (every matrix product
and convolution in float8 e4m3, :class:`portbench.reference.vit_dpt.Ops`;
the bias, the softmax and the bins stay f32).

``arch`` keys: ``hidden_size``, ``num_hidden_layers``,
``num_attention_heads``, ``intermediate_size``, ``patch_size``,
``window_size`` (the side of the patch grid the bias tables are drawn
for), ``layer_norm_eps``, ``layer_scale`` (LayerScale in every block),
``out_indices`` (the tapped layers, 1-indexed, as the port's
``out_layers``), ``neck_hidden_sizes``, ``reassemble_factors``,
``fusion_hidden_size``, ``bottleneck_features``, ``num_relative_features``,
``bin_embedding_dim``, ``n_bins``, ``min_depth``, ``max_depth``,
``num_attractors``, ``min_temp``, ``max_temp``. ``preprocess`` keys:
``target`` ((h, w)), ``multiple``, ``keep_aspect_ratio``, ``resize``,
``mean``, ``std``, ``pad_reflect_factor``.

Departures from HF, none of which changes a value beyond rounding:

* The patch embedding is a linear map over (row, column, channel)
  ordered patch pixels, weight (D, p·p·3), in place of HF's (D, 3, p, p)
  convolution: the same product on a permuted weight, as the port holds it.
* Resampling is by separable weight matrices (``ops.resize_planes``): the
  bias table's bilinear re-interpolation off its window (HF's (width,
  height) reshape kept: the flat table is read as (2w−1, 2h−1) and
  resampled to (2gh−1, 2gw−1)), the align-corners bilinear of the neck
  and the heads, the half-pixel bilinear of a fusion residual, the
  processor's align-corners bilinear and the output's bicubic (a = −0.75).
* The attractors average over their points in one reduction where HF
  sums in a loop and divides; HF's effective ``inv_attractor`` constants
  (alpha 300, gamma 2: the defaults, which its forward calls with; the
  configuration's ``attractor_alpha`` is stored and never used).
* Only what ZoeD_N runs: one bin configuration, softplus (unnormed) bin
  centres, ``attractor_kind`` mean, readout ``project``, no batch norm in
  the fusion, no patch-transformer router (ZoeD_NK), no dropout.
* The metric head's bottleneck 1×1 convolution is (bottleneck_features,
  fusion_hidden_size) as the port has it; HF's is square and so needs
  the two equal, as ZoeD_N has them.
* The processor pads before it rescales, as the port does (HF rescales
  first: both are linear).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from portbench.reference.ops import processor_size, resize_planes
from portbench.reference.vit_dpt import Ops, fusion

SEED_MLP = 256  # HF ZoeDepthSeedBinRegressor's mlp_dim
PROJECTOR_MLP = 128  # HF ZoeDepthProjector's mlp_dim
ATTRACTOR_ALPHA, ATTRACTOR_GAMMA = 300.0, 2  # HF inv_attractor's defaults, the ones it runs with
BIN_EPS = 1e-4  # HF ZoeDepthConditionalLogBinomialSoftmax's p_eps


# ---------- parameters ----------


def param_specs(arch: dict) -> list[tuple[str, tuple, str, int]]:
    """Every parameter of the served model: (name, shape, init kind, fan-in).
    The relative-position tables are ``lecun`` of fan-in 1 (unit variance,
    cut at ±2σ, the logits' own scale at these inits: the served init's
    zero tables would leave the bias out of every comparison), the class
    token ``normal``, the seed bin centres ordered (``seed_conv2``: with
    LeCun's init the centres are unordered along the bin index, and where
    a seed's head sets a low temperature the encoder's bf16 rounding moves
    depth by 5–7 %, as much on some seeds as fp8 moves it on others)."""
    d, p, L = arch["hidden_size"], arch["patch_size"], arch["num_hidden_layers"]
    mlp, heads, win = arch["intermediate_size"], arch["num_attention_heads"], arch["window_size"]
    c, f = arch["neck_hidden_sizes"], arch["fusion_hidden_size"]
    nrel, bf, e = arch["num_relative_features"], arch["bottleneck_features"], arch["bin_embedding_dim"]
    out: list = []

    def dense(name, n_out, n_in, bias=True):
        out.append((f"{name}.weight", (n_out, n_in), "lecun", n_in))
        if bias:
            out.append((f"{name}.bias", (n_out,), "zeros", 0))

    def conv(name, n_out, n_in, k, bias=True, kind="lecun"):
        out.append((f"{name}.weight", (n_out, n_in, k, k), kind, n_in * k * k))
        if bias:
            out.append((f"{name}.bias", (n_out,), "zeros", 0))

    def norm(name):
        out.extend([(f"{name}.weight", (d,), "ones", 0), (f"{name}.bias", (d,), "zeros", 0)])

    out.append(("backbone.cls_token", (1, 1, d), "normal", 0))
    dense("backbone.patch_embed", d, p * p * 3)
    for i in range(L):
        pre = f"backbone.blocks.{i}"
        if arch["layer_scale"]:
            out.extend([(f"{pre}.ls1", (d,), "ones", 0), (f"{pre}.ls2", (d,), "ones", 0)])
        norm(f"{pre}.norm1")
        out.append((f"{pre}.attn.rel_pos_table", ((2 * win - 1) ** 2 + 3, heads), "lecun", 1))
        dense(f"{pre}.attn.q", d, d)
        dense(f"{pre}.attn.k", d, d, bias=False)
        dense(f"{pre}.attn.v", d, d)
        dense(f"{pre}.attn.proj", d, d)
        norm(f"{pre}.norm2")
        dense(f"{pre}.fc1", mlp, d)
        dense(f"{pre}.fc2", d, mlp)
    for i, (ci, fac) in enumerate(zip(c, arch["reassemble_factors"])):
        dense(f"reassemble.readout{i}", d, 2 * d)
        conv(f"reassemble.proj{i}", ci, d, 1)
        if fac > 1:  # transposed: weight (in, out, k, k), fan-in in·k²
            k = int(fac)
            out.extend([(f"reassemble.up{i}.weight", (ci, ci, k, k), "lecun", ci * k * k),
                        (f"reassemble.up{i}.bias", (ci,), "zeros", 0)])
        elif fac < 1:
            conv(f"reassemble.down{i}", ci, ci, 3)
    for i, ci in enumerate(c):
        conv(f"conv{i}", f, ci, 3, bias=False)
    for j in range(4):
        for unit in (("res1", "res2") if j > 0 else ("res2",)):
            conv(f"fusion{j}.{unit}.conv1", f, f, 3)
            conv(f"fusion{j}.{unit}.conv2", f, f, 3)
        conv(f"fusion{j}.projection", f, f, 1)
    conv("rel_conv1", f // 2, f, 3)
    conv("rel_conv2", nrel, f // 2, 3)
    conv("rel_conv3", 1, nrel, 1, kind="lecun_abs")
    conv("mh_conv2", bf, f, 1)
    conv("seed_conv1", SEED_MLP, bf, 1)
    # Seed bin centres ordered along the bin index, as the log-binomial
    # over the bins assumes: a tenth of LeCun's σ on the weight, and a
    # bias whose softplus is an even ramp over the depth range.
    out.extend([("seed_conv2.weight", (arch["n_bins"], SEED_MLP, 1, 1), "lecun", SEED_MLP * 100),
                ("seed_conv2.bias", (arch["n_bins"],), "softplus_ramp", (arch["min_depth"], arch["max_depth"]))])
    conv("seed_projector.conv1", PROJECTOR_MLP, bf, 1)
    conv("seed_projector.conv2", e, PROJECTOR_MLP, 1)
    for i, n_att in enumerate(arch["num_attractors"]):
        conv(f"projector{i}.conv1", PROJECTOR_MLP, f, 1)
        conv(f"projector{i}.conv2", e, PROJECTOR_MLP, 1)
        conv(f"attractor{i}.conv1", e, e, 1)
        conv(f"attractor{i}.conv2", n_att, e, 1)
    cond = nrel + 1 + e
    conv("cond_log_binomial.mlp1", cond // 2, cond, 1)
    conv("cond_log_binomial.mlp2", 4, cond // 2, 1)
    return out


# ---------- the encoder ----------


@functools.lru_cache(maxsize=8)
def relative_position_index(gh: int, gw: int, device) -> torch.Tensor:
    """(gh·gw+1)² bucket of each token pair (HF
    ``generate_relative_position_index``): the offset's bucket between
    patches, then cls→token, token→cls and cls→cls in the last three.
    Made once a grid and device: every layer gathers by it."""
    n_rel = (2 * gh - 1) * (2 * gw - 1) + 3
    coords = torch.stack(torch.meshgrid(torch.arange(gh), torch.arange(gw), indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    idx = torch.zeros(gh * gw + 1, gh * gw + 1, dtype=torch.long)
    idx[1:, 1:] = (rel[:, :, 0] + gh - 1) * (2 * gw - 1) + rel[:, :, 1] + gw - 1
    idx[0, :] = n_rel - 3
    idx[:, 0] = n_rel - 2
    idx[0, 0] = n_rel - 1
    return idx.to(device)


def relative_bias(table: torch.Tensor, window: int, gh: int, gw: int) -> torch.Tensor:
    """A layer's (buckets, heads) table → its (heads, N, N) bias on a
    (gh, gw) grid, the table resampled off its window as HF does."""
    old, new_h, new_w = 2 * window - 1, 2 * gh - 1, 2 * gw - 1
    heads = table.shape[-1]
    # HF reads the flat table as (width, height) and resizes that to
    # (height, width); square here, as every window is. On the window
    # itself the resize is the identity.
    grid = table[: old * old].float().reshape(old, old, heads).permute(2, 0, 1)
    spatial = resize_planes(grid, (new_h, new_w), "linear").permute(1, 2, 0).reshape(new_h * new_w, heads)
    full = torch.cat([spatial, table[old * old:].float()])
    return full[relative_position_index(gh, gw, table.device)].permute(2, 0, 1)


def _attention(o: Ops, x: torch.Tensor, pre: str, heads: int, bias: torch.Tensor) -> torch.Tensor:
    b, t, d = x.shape
    dh = d // heads

    def split(y):
        return y.reshape(b, t, heads, dh).transpose(1, 2)

    q, k, v = (split(o.linear(x, f"{pre}.attn.{n}")) for n in ("q", "k", "v"))
    probs = torch.softmax(o.mm(q, k.transpose(-1, -2)) / math.sqrt(dh) + bias, dim=-1)
    return o.linear(o.mm(probs, v).transpose(1, 2).reshape(b, t, d), f"{pre}.attn.proj")


def _encoder(o: Ops, arch: dict, pixels: torch.Tensor) -> list[torch.Tensor]:
    """(B, H, W, 3) normalized pixels → the tapped layers' (B, 1+N, D) tokens."""
    b, h, w, _ = pixels.shape
    p, eps = arch["patch_size"], arch["layer_norm_eps"]
    gh, gw = h // p, w // p
    x = pixels.reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3)
    x = o.linear(x, "backbone.patch_embed")
    x = torch.cat([o.sd["backbone.cls_token"].expand(b, 1, -1), x], dim=1)
    outs = []
    for i in range(arch["num_hidden_layers"]):
        pre = f"backbone.blocks.{i}"
        bias = relative_bias(o.sd[f"{pre}.attn.rel_pos_table"], arch["window_size"], gh, gw)
        y = _attention(o, o.ln(x, f"{pre}.norm1", eps), pre, arch["num_attention_heads"], bias)
        x = x + (o.sd[f"{pre}.ls1"] * y if arch["layer_scale"] else y)
        y = o.linear(F.gelu(o.linear(o.ln(x, f"{pre}.norm2", eps), f"{pre}.fc1")), f"{pre}.fc2")
        x = x + (o.sd[f"{pre}.ls2"] * y if arch["layer_scale"] else y)
        outs.append(x)
    return [outs[i - 1] for i in arch["out_indices"]]


# ---------- the neck and the heads ----------


def _up(x: torch.Tensor, hw) -> torch.Tensor:
    """HF's ``interpolate(mode="bilinear", align_corners=True)``."""
    return resize_planes(x, tuple(hw), "linear_ac")


def _mlp(o: Ops, x: torch.Tensor, name: str) -> torch.Tensor:
    """Two 1×1 convolutions with a ReLU between (the projectors, the
    attractors' point MLP)."""
    return o.conv(torch.relu(o.conv(x, f"{name}.conv1")), f"{name}.conv2")


def _reassemble(o: Ops, arch: dict, taps: list[torch.Tensor], gh: int, gw: int) -> list[torch.Tensor]:
    """Tapped tokens → four NCHW maps at the reassemble factors' scales."""
    out = []
    for i, (t, fac) in enumerate(zip(taps, arch["reassemble_factors"])):
        tok = t[:, 1:]
        x = F.gelu(o.linear(torch.cat([tok, t[:, :1].expand_as(tok)], dim=-1), f"reassemble.readout{i}"))
        x = o.conv(x.transpose(1, 2).reshape(t.shape[0], -1, gh, gw), f"reassemble.proj{i}")
        if fac > 1:
            x = o.conv_t(x, f"reassemble.up{i}", int(fac))
        elif fac < 1:
            x = o.conv(x, f"reassemble.down{i}", stride=int(1 / fac), padding=1)
        out.append(x)
    return out


def _log_binomial(n_bins: int, device) -> torch.Tensor:
    """HF ``log_binom(k - 1, i)`` in f32: Stirling's log C(k−1, i)."""
    eps = 1e-7
    n = torch.tensor(float(n_bins - 1), device=device) + eps
    k = torch.arange(n_bins, dtype=torch.float32, device=device) + eps
    return n * torch.log(n) - k * torch.log(k) - (n - k) * torch.log(n - k + eps)


def _conditional_log_binomial(o: Ops, arch: dict, main, condition) -> torch.Tensor:
    """(B, k, H, W) probabilities over the bins."""
    x = o.conv(F.gelu(o.conv(torch.cat([main, condition], dim=1), "cond_log_binomial.mlp1")),
               "cond_log_binomial.mlp2")
    x = F.softplus(x)
    pt = x[:, :2] + BIN_EPS
    prob = pt[:, 0] / (pt[:, 0] + pt[:, 1])
    tt = x[:, 2:] + BIN_EPS
    temp = tt[:, 0] / (tt[:, 0] + tt[:, 1])
    temp = ((arch["max_temp"] - arch["min_temp"]) * temp + arch["min_temp"])[:, None]
    k = arch["n_bins"]
    idx = torch.arange(k, dtype=torch.float32, device=x.device).reshape(1, k, 1, 1)
    p = prob[:, None]
    y = (_log_binomial(k, x.device).reshape(1, k, 1, 1) + idx * torch.log(p.clamp(BIN_EPS, 1))
         + (k - 1 - idx) * torch.log((1 - p).clamp(BIN_EPS, 1)))
    return torch.softmax(y / temp, dim=1)


def forward(sd: dict, arch: dict, pixels: torch.Tensor, *, fp8: bool = False) -> torch.Tensor:
    """(B, H, W, 3) normalized f32 pixels → (B, oh, ow) f32 metric depth."""
    o = Ops(sd, fp8)
    p = arch["patch_size"]
    gh, gw = pixels.shape[1] // p, pixels.shape[2] // p
    maps = _reassemble(o, arch, _encoder(o, arch, pixels), gh, gw)
    feats = [o.conv(x, f"conv{i}") for i, x in enumerate(maps)]
    fused_list, fused = [], None
    for j, hs in enumerate(feats[::-1]):  # deep → shallow, every step ×2
        fused = fusion(o, j, hs, prefix="") if fused is None else fusion(o, j, fused, hs, prefix="")
        fused_list.append(fused)

    # The relative head on the shallowest fused map.
    x = o.conv(fused_list[-1], "rel_conv1")
    rel_features = torch.relu(o.conv(_up(x, (x.shape[-2] * 2, x.shape[-1] * 2)), "rel_conv2"))
    relative = torch.relu(o.conv(rel_features, "rel_conv3"))

    # The metric bins: seed bins on the bottleneck, then an attractor a fused map.
    xb = o.conv(feats[-1], "mh_conv2")
    prev_bin = F.softplus(o.conv(torch.relu(o.conv(xb, "seed_conv1")), "seed_conv2"))
    prev_emb = _mlp(o, xb, "seed_projector")
    for i, feat in enumerate(fused_list):
        emb = _mlp(o, feat, f"projector{i}")
        hw = emb.shape[-2:]
        points = F.softplus(_mlp(o, emb + _up(prev_emb, hw), f"attractor{i}"))  # (B, A, H, W)
        centers = _up(prev_bin, hw)  # (B, k, H, W)
        dx = points[:, :, None] - centers[:, None]
        prev_bin = centers + (dx / (1 + ATTRACTOR_ALPHA * dx.pow(ATTRACTOR_GAMMA))).mean(dim=1)
        prev_emb = emb
    hw = rel_features.shape[-2:]
    last = torch.cat([rel_features, _up(relative, hw)], dim=1)
    probs = _conditional_log_binomial(o, arch, last, _up(prev_emb, hw))
    return (probs * _up(prev_bin, hw)).sum(dim=1)


# ---------- input and output handling: the ZoeDepth processor ----------


def _pads(cfg: dict, h: int, w: int) -> tuple[int, int]:
    """The reflect pad a side: int(sqrt(dim / 2) · factor)."""
    f = cfg["preprocess"]["pad_reflect_factor"]
    return int(math.sqrt(h / 2) * f), int(math.sqrt(w / 2) * f)


def _model_size(cfg: dict, h: int, w: int) -> tuple[int, int]:
    pre = cfg["preprocess"]
    ph, pw = _pads(cfg, h, w)
    return processor_size(h + 2 * ph, w + 2 * pw, tuple(pre["target"]), pre["multiple"],
                          pre["keep_aspect_ratio"])


def model_target(cfg: dict) -> tuple[int, int]:
    """The (h, w) target the port's ``ModelManager(model_target=…)`` takes."""
    return tuple(cfg["preprocess"]["target"])


def model_input(image: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(H, W, 3) f32 RGB in [0, 255] → (mh, mw, 3) normalized pixels:
    reflect-padded, resized toward the target keeping the aspect in
    multiples of ``multiple``, rescaled and normalized."""
    pre = cfg["preprocess"]
    ph, pw = _pads(cfg, *image.shape[:2])
    x = F.pad(image.permute(2, 0, 1)[None], (pw, pw, ph, ph), mode="reflect")[0]
    x = resize_planes(x, _model_size(cfg, *image.shape[:2]), pre["resize"]).permute(1, 2, 0)
    mean = torch.tensor(pre["mean"], dtype=torch.float32, device=image.device)
    std = torch.tensor(pre["std"], dtype=torch.float32, device=image.device)
    return (x * (1.0 / 255.0) - mean) / std


def model_output(depth: torch.Tensor, cfg: dict, h: int, w: int) -> torch.Tensor:
    """The model's depth, bicubic (align_corners False) to the padded
    size, then the pad cropped: (h, w)."""
    ph, pw = _pads(cfg, h, w)
    d = resize_planes(depth, (h + 2 * ph, w + 2 * pw), "bicubic_torch")
    return d[ph:ph + h, pw:pw + w]


def model_grid(cfg: dict, h: int, w: int) -> tuple[int, int]:
    """The patch grid an (h, w) upload reaches the encoder at."""
    p = cfg["arch"]["patch_size"]
    mh, mw = _model_size(cfg, h, w)
    return mh // p, mw // p


# ---------- FLOPs (the conventions of portbench/flops.py) ----------


def flops_per_image(cfg: dict, h: int, w: int) -> float:
    """Matrix products and convolutions at 2 a multiply-add, the
    attention's two products included; not the bias gather and add, the
    attractors' arithmetic or the final sum over the bins (elementwise)."""
    a = cfg["arch"]
    d, p, mlp = a["hidden_size"], a["patch_size"], a["intermediate_size"]
    c, f = a["neck_hidden_sizes"], a["fusion_hidden_size"]
    nrel, bf, e, k = a["num_relative_features"], a["bottleneck_features"], a["bin_embedding_dim"], a["n_bins"]
    gh, gw = model_grid(cfg, h, w)
    g = gh * gw
    t = g + 1

    def conv(pixels, cin, cout, kk):
        return 2.0 * pixels * cin * cout * kk * kk

    total = 2.0 * g * (p * p * 3) * d  # patch embedding
    total += a["num_hidden_layers"] * (2.0 * t * d * d * 4 + 2.0 * t * d * mlp * 2 + 2.0 * 2 * t * t * d)
    sizes = []
    for ci, fac in zip(c, a["reassemble_factors"]):
        total += 2.0 * g * (2 * d) * d + conv(g, d, ci, 1)  # readout projection, 1×1 projection
        if fac > 1:  # transposed convolution: per input pixel
            total += conv(g, ci, ci, int(fac))
            sizes.append(g * int(fac) ** 2)
        elif fac < 1:
            s = int(1 / fac)
            down = (-(-gh // s)) * (-(-gw // s))
            total += conv(down, ci, ci, 3)
            sizes.append(down)
        else:
            sizes.append(g)
    total += sum(conv(s, ci, f, 3) for s, ci in zip(sizes, c))
    # Fusion, deep → shallow: every step at the running map's size (the
    # deepest stage's, ×2 a step), its 1×1 projection after the ×2.
    px = sizes[-1]
    for j in range(4):
        total += (1 if j == 0 else 2) * 2 * conv(px, f, f, 3) + conv(4 * px, f, f, 1)
        px *= 4
    fused = [sizes[-1] * 4 ** (j + 1) for j in range(4)]  # each fusion's output, shallow last
    total += conv(fused[-1], f, f // 2, 3) + conv(4 * fused[-1], f // 2, nrel, 3) + conv(4 * fused[-1], nrel, 1, 1)
    bott = sizes[-1]
    total += conv(bott, f, bf, 1) + conv(bott, bf, SEED_MLP, 1) + conv(bott, SEED_MLP, k, 1)
    total += conv(bott, bf, PROJECTOR_MLP, 1) + conv(bott, PROJECTOR_MLP, e, 1)
    for px, n_att in zip(fused, a["num_attractors"]):
        total += conv(px, f, PROJECTOR_MLP, 1) + conv(px, PROJECTOR_MLP, e, 1)
        total += conv(px, e, e, 1) + conv(px, e, n_att, 1)
    cond = nrel + 1 + e
    total += conv(4 * fused[-1], cond, cond // 2, 1) + conv(4 * fused[-1], cond // 2, 4, 1)
    return total


# ---------- the port's preset ----------


def port_fields(cfg: dict) -> list[tuple[str, object]]:
    """What the state dict's shapes do not show, on the port's
    ``ZoeDepthConfig``: the encoder's settings and taps, the neck's widths
    and factors, the bin settings and the processor's constants."""
    a, pre = cfg["arch"], cfg["preprocess"]
    bb = [("hidden_size", "hidden_size"), ("num_layers", "num_hidden_layers"),
          ("num_heads", "num_attention_heads"), ("intermediate_size", "intermediate_size"),
          ("patch_size", "patch_size"), ("window_size", "window_size"), ("layer_norm_eps", "layer_norm_eps"),
          ("layer_scale", "layer_scale"), ("out_layers", "out_indices")]
    top = ("neck_hidden_sizes", "reassemble_factors", "fusion_hidden_size", "bottleneck_features",
           "num_relative_features", "bin_embedding_dim", "n_bins", "min_depth", "max_depth", "num_attractors",
           "min_temp", "max_temp")
    return ([(f"backbone.{port}", a[key]) for port, key in bb] + [(key, a[key]) for key in top]
            + [("native_target", pre["target"]), ("size_multiple", pre["multiple"]), ("pixel_mean", pre["mean"]),
               ("pixel_std", pre["std"]), ("pad_reflect_factor", pre["pad_reflect_factor"]),
               ("resize_method", pre["resize"])])
