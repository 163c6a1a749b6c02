"""Device times of the served kernel instances, for an A/B of two checkouts
on one card.

Times K1 (``flash_attention``) at DA-V2-Small's (1, 6, 1370, 64) and
classic DPT-Large's (1, 16, 577, 64) in bf16 and in f32 (the served f32
path, ``ModelManager(use_bf16=False)``), and K2 (the grid kNN at k =
20, window = 4) on the 259² random cube, as ``chip_smoke.py`` times them
(a CUDA graph of 20 calls, the median of 5 replays, per call), and prints
one JSON line with the card's name and power limit. The port is imported
from ``PYTHONPATH`` first, so one copy of this script times any checkout:

    PYTHONPATH=/path/to/checkout python3 tools/kernel_times.py [--wide]

``--wide`` adds paths that no preset serves: K1 above D = 128 at
``chip_smoke.K1_WIDE_SHAPES`` in both dtypes, K2's sorted kernels at
(k, window) = (100, 5), (300, 8) and (500, 12) on the same cube, and the
served (20, 4) and every general pair (k_eff <= 64) on the cube and on the
synthetic depth surface (``chip_smoke.knn_surface``). Without it the set
is the served one, so earlier A/Bs stay comparable. Run two checkouts in
turns (A, B, B, A) in one run on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

# After PYTHONPATH, so that the checkout under test supplies the port.
sys.path.append(str(Path(__file__).resolve().parents[1]))

from chip_smoke import K1_WIDE_SHAPES, device_time_ms, knn_cube, knn_surface  # noqa: E402

K2_SORTED_PAIRS = [(100, 5), (300, 8), (500, 12)]
# The served pair and chip_smoke.K2_GENERAL_PAIRS, listed here because an
# older checkout's chip_smoke.py may not have them.
K2_WIDE_PAIRS = [(20, 4), (10, 7), (64, 8), (1, 1), (40, 2), (16, 3), (20, 12), (64, 16),
                 (9, 2), (24, 3), (33, 4), (63, 5), (8, 50), (8, 51)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wide", action="store_true",
                    help="also K1 above D = 128 and K2's sorted and general kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: CUDA is not available")
    import image_to_pointcloud_tpu_torch as port
    from image_to_pointcloud_tpu_torch.models.attention import flash_attention
    from image_to_pointcloud_tpu_torch.ops.outlier import grid_knn_mean_distances_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"port": str(Path(port.__file__).parent)}
    k1_shapes = [(1, 6, 1370, 64), (1, 16, 577, 64)] + (K1_WIDE_SHAPES if args.wide else [])
    for dtype in (torch.bfloat16, torch.float32):
        for shape in k1_shapes:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            out[f"K1 {shape} {str(dtype)[6:]} ms"] = device_time_ms(
                lambda: flash_attention(q, k, v))
    pts = knn_cube(gen, (1, 259, 259, 3))
    out["K2 cube (1, 259, 259, 3) ms"] = device_time_ms(lambda: grid_knn_mean_distances_cuda(pts))
    for k, r in K2_SORTED_PAIRS if args.wide else []:
        out[f"K2 cube (1, 259, 259, 3) k={k} window={r} ms"] = device_time_ms(
            lambda: grid_knn_mean_distances_cuda(pts, k=k, window=r))
    if args.wide:
        surface = knn_surface(gen)
        for k, r in K2_WIDE_PAIRS:
            for name, grid in [("cube", pts), ("surface", surface)]:
                out[f"K2 {name} (1, 259, 259, 3) k={k} window={r} ms"] = device_time_ms(
                    lambda: grid_knn_mean_distances_cuda(grid, k=k, window=r))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
