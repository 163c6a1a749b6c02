"""Plain operations of the reference: resampling weights, the robust depth
normalization, the pinhole unprojection, the windowed kNN outlier rule,
the 8×8-tiled depth codec with its host decode, and the binary PLY
reader.

Written from the semantics the served pipeline states (cv2 / PIL / torch
resampling, numpy-style percentiles, Open3D's statistical outlier rule,
the bundle layout of the quantized transfer), in plain torch and numpy.
The resampling weight builders are frozen copies of the port's
``ops/resize.py`` (themselves copies of the JAX package's). Nothing here
imports the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ---------- resampling weights (frozen copies) ----------


def _weights_linear(in_size: int, out_size: int) -> np.ndarray:
    """cv2.INTER_LINEAR: half-pixel centres, clamped borders."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        j = int(math.floor(src))
        f = src - j
        w[i, min(max(j, 0), in_size - 1)] += 1.0 - f
        w[i, min(max(j + 1, 0), in_size - 1)] += f
    return w.astype(np.float32)


def _weights_linear_ac(in_size: int, out_size: int) -> np.ndarray:
    """torch bilinear with align_corners=True."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
    for i in range(out_size):
        src = i * scale
        j = int(math.floor(src))
        f = src - j
        w[i, min(max(j, 0), in_size - 1)] += 1.0 - f
        w[i, min(max(j + 1, 0), in_size - 1)] += f
    return w.astype(np.float32)


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


def _weights_bicubic_pil(in_size: int, out_size: int) -> np.ndarray:
    """PIL BICUBIC (a = -0.5, support widened by the scale on a downscale,
    normalized per output pixel)."""
    scale = in_size / out_size
    fs = max(scale, 1.0)
    support = 2.0 * fs
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        c = (i + 0.5) * scale
        j0 = max(int(c - support + 0.5), 0)
        j1 = min(int(c + support + 0.5), in_size)
        ww = _cubic((np.arange(j0, j1) - c + 0.5) / fs, -0.5)
        tot = ww.sum()
        w[i, j0:j1] = ww / tot if tot != 0 else ww
    return w.astype(np.float32)


def _weights_bicubic_torch(in_size: int, out_size: int) -> np.ndarray:
    """torch bicubic, align_corners=False, no antialias (a = -0.75)."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        j = int(math.floor(src))
        offs = np.array([-1, 0, 1, 2])
        for o, wt in zip(offs, _cubic(offs - (src - j), -0.75)):
            w[i, min(max(j + o, 0), in_size - 1)] += wt
    return w.astype(np.float32)


_FILTERS = {"linear": _weights_linear, "linear_ac": _weights_linear_ac,
            "bicubic_pil": _weights_bicubic_pil, "bicubic_torch": _weights_bicubic_torch}


def resize_planes(x: torch.Tensor, out_hw, method: str) -> torch.Tensor:
    """(..., H, W) → (..., oh, ow) in f32; a same-size resize is the
    identity."""
    x = x.float()
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    wr = torch.from_numpy(_FILTERS[method](x.shape[-2], out_hw[0])).to(x.device)
    wc = torch.from_numpy(_FILTERS[method](x.shape[-1], out_hw[1])).to(x.device)
    return wr @ x @ wc.T


def processor_size(h: int, w: int, target, multiple: int, keep_aspect: bool):
    """The DPT and ZoeDepth processors' resize target (keep-aspect,
    multiple-of-N) toward ``target``, a side or an (h, w) pair."""
    th, tw = (target, target) if isinstance(target, int) else target
    sh, sw = th / h, tw / w
    if keep_aspect:
        if abs(1 - sw) < abs(1 - sh):
            sh = sw
        else:
            sw = sh

    def fit(v):
        x = round(v / multiple) * multiple
        return int(x if x >= 0 else -(-v // multiple) * multiple)

    return fit(sh * h), fit(sw * w)


# ---------- depth post-processing ----------


def normalize_depth(d: torch.Tensor, invert: bool = True) -> torch.Tensor:
    """Robust normalization to [0, 1]: non-finite values → the finite
    median; numpy-'linear' p2/p98 (min/max where p98 <= p2); clip, scale
    by (p98 - p2 + 1e-6); all zeros where the range is degenerate; then
    1 - d when ``invert``."""
    flat = d.float().reshape(-1)
    fin = torch.isfinite(flat)
    if not bool(fin.all()):
        flat = torch.where(fin, flat, flat[fin].median() if bool(fin.any()) else flat.new_zeros(()))
    srt = torch.sort(flat).values
    n = flat.numel()

    def pct(q):
        pos = q / 100.0 * (n - 1)
        lo, hi = math.floor(pos), math.ceil(pos)
        fr = torch.tensor(pos - lo, dtype=torch.float32, device=flat.device)
        return srt[lo] * (1 - fr) + srt[hi] * fr

    lo, hi = pct(2.0), pct(98.0)
    if bool(hi <= lo):
        lo, hi = srt[0], srt[-1]
    out = (flat.clamp(lo, hi) - lo) / (hi - lo + 1e-6)
    if not bool(hi > lo):
        out = torch.zeros_like(out)
    if invert:
        out = 1.0 - out
    return out.reshape(d.shape)


def focal(h: int, w: int) -> float:
    """The served intrinsics without a field of view: f = 1.2·max(h, w)."""
    return max(h, w) * 1.2


def unproject_grid(dn_s: torch.Tensor, scale: float, step: int, h: int, w: int) -> torch.Tensor:
    """(hh, ww) strided normalized depth → (hh, ww, 3) camera points:
    z = d·scale, x = (u - w/2)·z/f, y = (v - h/2)·z/f, with z's 1e-6
    stand-in in x and y where z is 0."""
    hh, ww = dn_s.shape
    dev = dn_s.device
    f = torch.tensor(focal(h, w), dtype=torch.float32, device=dev)
    z = dn_s.float() * torch.tensor(scale, dtype=torch.float32, device=dev)
    zs = torch.where(z != 0, z, torch.full_like(z, 1e-6))
    u = torch.arange(ww, dtype=torch.float32, device=dev) * step - w / 2.0
    v = torch.arange(hh, dtype=torch.float32, device=dev)[:, None] * step - h / 2.0
    return torch.stack([u * zs / f, v * zs / f, z], dim=-1)


def outlier_keep(grid: torch.Tensor, k: int = 20, window: int = 4, std_ratio: float = 2.0,
                 rows: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Open3D's statistical outlier rule over a windowed neighbour search
    on the depth grid: each point's mean distance to its k nearest points
    inside the (2·window+1)² grid window (itself included at 0, points
    outside the grid none), then keep = mean > 0 and mean < μ + ratio·σ
    over the points with mean > 0 (σ with Bessel's correction). Computed
    in blocks of ``rows`` grid rows. Returns (keep, margin): each point's
    distance from the threshold as a share of it (infinite where
    mean = 0, a decision no rounding moves)."""
    hh, ww, _ = grid.shape
    r = window
    big = 1e30
    pad = torch.full((hh + 2 * r, ww + 2 * r, 3), float("nan"), device=grid.device)
    pad[r:r + hh, r:r + ww] = grid.float()
    means = torch.empty(hh, ww, device=grid.device)
    for y0 in range(0, hh, rows):
        y1 = min(hh, y0 + rows)
        centre = grid[y0:y1].float()
        d2 = []
        for dy in range(2 * r + 1):
            for dx in range(2 * r + 1):
                nb = pad[y0 + dy:y1 + dy, dx:dx + ww]
                dd = ((nb - centre) ** 2).sum(-1)
                d2.append(torch.where(torch.isnan(nb[..., 0]), torch.full_like(dd, big), dd))
        best = torch.sort(torch.stack(d2, -1), dim=-1).values[..., :k]
        found = best < big * 0.5
        s = torch.where(found, best.clamp_min(0).sqrt(), torch.zeros_like(best)).sum(-1)
        means[y0:y1] = s / found.sum(-1).clamp_min(1)
    m = means.reshape(-1)
    pos = m > 0
    npos = pos.sum().float()
    mu = torch.where(pos, m, torch.zeros_like(m)).sum() / npos.clamp_min(1)
    var = torch.where(pos, (m - mu) ** 2, torch.zeros_like(m)).sum() / (npos - 1).clamp_min(1)
    thr = mu + std_ratio * var.sqrt()
    margin = torch.where(pos, (m - thr).abs() / thr.clamp_min(1e-30), torch.full_like(m, float("inf")))
    return (pos & (m < thr)).reshape(hh, ww), margin.reshape(hh, ww)


# ---------- the quantized depth transfer ----------


def _tile_geometry(hh: int, ww: int):
    th, tw = -(-hh // 8), -(-ww // 8)
    t = th * tw
    return th, tw, t, -(-t // 8)


def quantize_depth(dn_s: torch.Tensor) -> np.ndarray:
    """The bundle's depth after its round trip, as (hh, ww) integers on
    the 12-bit grid (divide by 4095): the 8×8-tiled sub-byte codec where
    its section is smaller than the flat 12-bit pack, else the 12-bit
    values themselves. Tiles are edge-padded; each carries its min and
    range and one code a point, round((d - min)·255/max(range, 1)), decoded
    as min + round(code·max(range, 1)/255); the ceil(tiles/8) tiles of
    largest range (ties: lower index first) ship exact values."""
    hh, ww = dn_s.shape
    th, tw, t, k = _tile_geometry(hh, ww)
    d12 = torch.round(dn_s.float().clamp(0, 1) * 4095.0).to(torch.int32)
    if 4 * t + 64 * t + 98 * k >= 3 * (-(-(hh * ww) // 2)):
        return d12.cpu().numpy().astype(np.uint16)
    rows = torch.arange(th * 8, device=d12.device).clamp_max(hh - 1)
    cols = torch.arange(tw * 8, device=d12.device).clamp_max(ww - 1)
    tiles = d12[rows][:, cols].reshape(th, 8, tw, 8).permute(0, 2, 1, 3).reshape(t, 64)
    tiles = tiles.cpu().numpy()
    mn = tiles.min(-1)
    rng = np.maximum(tiles.max(-1) - mn, 1).astype(np.float32)
    ratio = np.float32(255.0) / rng
    codes = np.round((tiles - mn[:, None]).astype(np.float32) * ratio[:, None])
    dec = (mn[:, None].astype(np.float32) + np.round(codes * (rng[:, None] / np.float32(255.0))))
    dec = dec.astype(np.uint16)
    exact = np.argsort(-(tiles.max(-1) - mn), kind="stable")[:k]
    dec[exact] = tiles[exact]
    d = dec.reshape(th, tw, 8, 8).transpose(0, 2, 1, 3).reshape(th * 8, tw * 8)
    return np.ascontiguousarray(d[:hh, :ww])


def dequantized_points(d12: np.ndarray, scale: float, step: int, h: int, w: int) -> np.ndarray:
    """(hh, ww) 12-bit depth → (hh, ww, 3) f32 points by the unprojection's
    arithmetic (the host's reconstruction)."""
    dn = d12.astype(np.float32) * np.float32(1.0 / 4095.0)
    z = dn * np.float32(scale)
    zs = np.where(z != 0, z, np.float32(1e-6))
    f = np.float32(focal(h, w))
    u = (np.arange(d12.shape[1], dtype=np.float32) * step - np.float32(w / 2.0))[None, :]
    v = (np.arange(d12.shape[0], dtype=np.float32) * step - np.float32(h / 2.0))[:, None]
    return np.stack([u * zs / f, v * zs / f, z], axis=-1)


# ---------- PLY ----------


def read_ply_points(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """A binary little-endian point PLY (double x, y, z; uchar r, g, b) →
    ((N, 3) f64 points, (N, 3) u8 colours)."""
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    if header[1] != "format binary_little_endian 1.0":
        raise ValueError(f"not a binary little-endian PLY: {header[1]!r}")
    n = next(int(ln.split()[2]) for ln in header if ln.startswith("element vertex"))
    props = [ln.split()[1:] for ln in header if ln.startswith("property")]
    want = [["double", "x"], ["double", "y"], ["double", "z"],
            ["uchar", "red"], ["uchar", "green"], ["uchar", "blue"]]
    if props != want:
        raise ValueError(f"unexpected PLY properties {props}")
    rec = np.frombuffer(data, dtype=np.dtype([("p", "<f8", 3), ("c", "u1", 3)]), count=n,
                        offset=end)
    return rec["p"].copy(), rec["c"].copy()
