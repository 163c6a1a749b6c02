"""The model's FLOPs an image, from the configuration's widths: matrix
products and convolutions at 2 per multiply-add (the attention's two
products included), counted for the real image only (no padded batch
rows) and without the resampling inside the neck, norms, activations or
elementwise work. Each family counts its own model
(``portbench/reference/families/<family>.py``); ``mfu.bulk`` and
``k1_roofline.bulk`` rest on these two names; ``portbench/tests`` pins
them against a hand count.
"""

from __future__ import annotations

from portbench.reference.model import family


def model_grid(cfg: dict, h: int, w: int) -> tuple[int, int]:
    """The patch grid an (h, w) upload reaches the encoder at."""
    return family(cfg["arch"]).model_grid(cfg, h, w)


def flops_per_image(cfg: dict, h: int, w: int) -> float:
    return family(cfg["arch"]).flops_per_image(cfg, h, w)
