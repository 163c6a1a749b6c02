"""The model's FLOPs an image, from the configuration's widths: matrix
products and convolutions at 2 per multiply-add (the attention's two
products included), counted for the real image only (no padded batch
rows) and without the resampling inside the neck, norms, activations or
elementwise work. ``mfu.bulk`` rests on it; ``portbench/tests`` pins it
against a hand count.
"""

from __future__ import annotations

from portbench.reference.ops import processor_size


def model_grid(cfg: dict, h: int, w: int) -> tuple[int, int]:
    """The patch grid an (h, w) upload reaches the encoder at."""
    pre, p = cfg["preprocess"], cfg["arch"]["patch_size"]
    mh, mw = processor_size(h, w, pre["target"], pre["multiple"], pre["keep_aspect_ratio"])
    return mh // p, mw // p


def flops_per_image(cfg: dict, h: int, w: int) -> float:
    a = cfg["arch"]
    d, p, mlp = a["hidden_size"], a["patch_size"], a["intermediate_size"]
    c, f, hh = a["neck_hidden_sizes"], a["fusion_hidden_size"], a["head_hidden_size"]
    ph, pw = model_grid(cfg, h, w)
    g = ph * pw
    t = g + 1
    classic = a["family"] == "vit_dpt_classic"

    def conv(pixels, cin, cout, k):
        return 2.0 * pixels * cin * cout * k * k

    total = 2.0 * g * (p * p * 3) * d  # patch embedding
    per_layer = 2.0 * t * d * d * 4 + 2.0 * t * d * mlp * 2 + 2.0 * 2 * t * t * d
    total += a["num_hidden_layers"] * per_layer
    if classic:
        total += 4 * 2.0 * g * (2 * d) * d  # readout projections
    total += sum(conv(g, d, ci, 1) for ci in c)  # per-stage 1×1 projections
    total += conv(g, c[0], c[0], 4) + conv(g, c[1], c[1], 2)  # transposed convs: per input pixel
    down = (-(-ph // 2)) * (-(-pw // 2))
    total += conv(down, c[3], c[3], 3)
    sizes = [16 * g, 4 * g, g, down]  # stage maps, shallow → deep
    total += sum(conv(s, ci, f, 3) for s, ci in zip(sizes, c))
    # Fusion, deep → shallow: residual units at the stage size, the 1×1
    # projection after the upsampling (to the next stage, or ×2 at the end
    # and always ×2 in classic DPT).
    for j, s in enumerate(sizes[::-1]):
        units = 1 if j == 0 else 2
        total += units * 2 * conv(s, f, f, 3)
        nxt = 4 * s if (classic or j == 3) else sizes[::-1][j + 1]
        total += conv(nxt, f, f, 1)
    head_in = 4 * sizes[0]  # the last fusion's ×2 output
    total += conv(head_in, f, f // 2, 3)
    out_px = (ph * p) * (pw * p) if not classic else 4 * head_in
    total += conv(out_px, f // 2, hh, 3) + conv(out_px, hh, 1, 1)
    return total
