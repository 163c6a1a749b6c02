"""Planes for the port's depthnorm tests, in numpy alone.

``depth_planes`` makes the special planes that the CPU tests
(``test_torch_ops.py``), the card tests (``test_torch_cuda.py``) and
``chip_smoke.py`` hold the port's normalize to, all through
``from torch_depth_cases import ...`` with this directory on the path:
pytest puts it there, ``chip_smoke.py`` adds it.
"""

from __future__ import annotations

import numpy as np


def depth_planes(rng, case: str, shape: tuple) -> np.ndarray:
    """(B, *shape) f32 planes for one case of the port's depthnorm tests
    (``NORMALIZE_CASES``): non-finites, signed zeros at the percentile
    ranks, ties that the median falls between, constant, all-non-finite
    and smooth planes; B = 3 for ``"batch3"``, else 1. ``rng`` is a numpy
    Generator."""
    n = shape[0] * shape[1]
    x = (rng.normal(size=n) * 3 + 1).astype(np.float32)
    if case == "nonfinite":
        x[[0, shape[1] + 1, 2 * shape[1] + 2]] = np.nan, np.inf, -np.inf
    elif case == "constant":
        x[:] = 2.0
    elif case == "all_nonfinite":
        x[:] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), n)
    elif case == "signed_zeros":
        # Zeros of both signs fill the 2 % ranks (p2 is a zero) and the
        # tail; NaNs shift the ranks.
        x = np.abs(x) + 1
        k = rng.permutation(n)
        x[k[: n // 25]] = 0.0
        x[k[n // 25 : n // 25 + n // 50]] = -0.0
        x[k[n // 10 : n // 10 + 30]] = np.nan
        x[-3:] = -0.0
    elif case == "median_ties":
        # Four tied values; 40 % non-finites leave an even finite count
        # split between 2 and 3, so their copies of 2.5 sit between ties.
        x = np.repeat(np.float32([1, 2, 3, 4]), -(-n // 4))[:n]
        k = rng.permutation(n)
        x[k[: 2 * n // 5]] = np.nan
        fin = np.flatnonzero(~np.isnan(x))
        x[fin] = np.sort(x[fin])
        x[fin[: len(fin) // 2]] = np.minimum(x[fin[: len(fin) // 2]], 2)
        x[fin[len(fin) // 2 + len(fin) % 2 :]] = np.maximum(x[fin[len(fin) // 2 + len(fin) % 2 :]], 3)
        if len(fin) % 2:
            x[fin[len(fin) // 2]] = np.inf
    elif case == "smooth":
        # A model's kind of output: positive, smooth, a step edge, no
        # non-finites (the served case).
        yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]] / max(shape)
        x = (2 + np.sin(6 * xx) * np.cos(4 * yy) + 3 * (xx > 0.6)).astype(np.float32).ravel()
        x += rng.normal(scale=0.01, size=n).astype(np.float32)
    elif case == "mostly_nonfinite":
        # The median's copies hold the 2 % and 98 % ranks: the (min, max)
        # fallback.
        x[rng.permutation(n)[: n * 97 // 100]] = np.inf
    if case != "batch3":
        return x.reshape(1, *shape)
    return np.stack([depth_planes(rng, c, shape)[0]
                     for c in ("signed_zeros", "nonfinite", "median_ties")])


NORMALIZE_CASES = ["nonfinite", "constant", "all_nonfinite", "signed_zeros", "median_ties",
                   "mostly_nonfinite", "smooth", "batch3"]
