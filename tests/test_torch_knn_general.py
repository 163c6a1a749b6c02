"""K2's general kernel (k_eff = min(k, (2·window+1)²) <= 64, any window)
replayed on the CPU, step for step, against the plain version and the JAX
scan form.

``csrc/grid_knn.cu``'s ``grid_knn_general_kernel`` cannot run here (no
card, no ``nvcc``). This file replays its algorithm in torch, vectorized
over the points: the taps by Chebyshev rings from the centre out (ring ρ
in order of |m|, as ``ring_taps`` lists them), the list of kCap entries
(the smallest multiple of the list step that holds k_eff) with its
kCap - k_eff lowest entries at -inf, the fill with the first k_eff taps,
the bitonic network that sorts it (``sort_list``, fmin / fmax as fminf /
fmaxf), the reject of every later tap against the list's last entry (the
k_eff-th value), the depth-2 insert with blocks below the insertion point
skipped (``insert_blocked``), the NaN flag and the mean of the found
entries (d² in [0, 1e17]). The list step and the blocks are the
kernel's constants (``kListStep``, ``block_of``).

Tolerances: the replay equals ``grid_knn_mean_distances_plain`` bit for
bit (torch.equal). Against the JAX scan form the repo's rule for it
holds (``test_torch_ops.py``): the same zero means, and rtol 1e-5, atol
1e-7 elsewhere, because XLA's CPU backend sums d² and the roots in
another order than the list order. Inputs: a tie-rich lattice, a
back-projected surface with outliers, a cube with NaN and ±inf
coordinates and one whose distances lie below 2^-101; list sizes on both
sides of each step (k_eff = 1, 8, 9, 24, 25, 33, 63, 64), and windows far
wider than the grid.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.ops.outlier import grid_knn_mean_distances_plain

LIST_STEP = 8  # kListStep: list sizes are multiples of it up to 64


def block_of(cap: int) -> int:
    """The insertion's block at list size cap (block_of<kCap>()): 8
    entries up to 16, halves above."""
    return 8 if cap <= 16 else cap // 2


def ring_order(r: int) -> list[tuple[int, int]]:
    """The kernel's tap order: ring 0, then ring ρ = 1 .. r, each in
    ascending |m| (ring_table() and ring_taps())."""
    taps = [(0, 0)]
    for rho in range(1, r + 1):
        for m in range(rho + 1):
            taps += [(rho, m), (-rho, -m), (-m, rho), (m, -rho)]
            if 0 < m < rho:
                taps += [(rho, -m), (-rho, m), (m, rho), (-m, -rho)]
    return taps


def bitonic_pairs(n: int) -> list[tuple[int, int]]:
    """sort_list<n>'s compare-exchanges in order: P = 2^⌈log2 n⌉, a flip
    and then half-cleaners a stage, compares past n dropped."""
    log_p = max(3, math.ceil(math.log2(n)))
    pairs = []
    for s in range(log_p):
        k = 2 << s
        pairs += [(e, e ^ (k - 1)) for e in range(n) if not e & (k // 2) and e ^ (k - 1) < n]
        for step in range(s):
            j = k >> (2 + step)
            pairs += [(e, e | j) for e in range(n) if not e & j and e | j < n]
    return pairs


def _network(v: list, pairs) -> list:
    v = list(v)
    for i, j in pairs:
        v[i], v[j] = torch.fmin(v[i], v[j]), torch.fmax(v[i], v[j])
    return v


def _insert_blocked(best: list, v: torch.Tensor, take: torch.Tensor, block: int) -> list:
    """insert_blocked where ``take``: v below the last entry, the blocks
    above the insertion point updated at depth 2."""
    cap = len(best)
    nblocks = -(-cap // block)
    first = sum((~(v < best[(i + 1) * block - 1])).long() for i in range(nblocks - 1))
    new = list(best)
    for blk in range(nblocks):
        upd = take & (first <= blk)
        for t in range(blk * block, min((blk + 1) * block, cap)):
            low = torch.fmin(best[t], v)
            new[t] = torch.where(upd, low if t == 0 else torch.fmax(best[t - 1], low), best[t])
    return new


def _insert_each(best: list, values, block: int, inserts: torch.Tensor, poisoned: torch.Tensor):
    """The later taps one at a time: a reject against the last entry, else
    the blocked insert."""
    for v in values:
        poisoned |= torch.isnan(v)
        take = v < best[-1]
        if take.any():
            inserts += take
            best = _insert_blocked(best, v, take, block)
    return best


def replay_general(pts: torch.Tensor, k: int, window: int) -> tuple[torch.Tensor, dict]:
    """The general kernel's result, (B, hh, ww, 3) → (B, hh·ww), and what
    it did: the list size and, per point, the taps inserted."""
    p = pts.float()
    b, hh, ww, _ = p.shape
    r = window
    k_eff = min(k, (2 * r + 1) ** 2)
    cap = -(-k_eff // LIST_STEP) * LIST_STEP
    pad = cap - k_eff
    grid = torch.full((b, hh + 2 * r, ww + 2 * r, 3), 1e9)
    grid[:, r:r + hh, r:r + ww] = p

    def dist(dy: int, dx: int) -> torch.Tensor:
        e = grid[:, r + dy:r + dy + hh, r + dx:r + dx + ww] - p
        return (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) + e[..., 2] * e[..., 2]

    taps = ring_order(r)
    poisoned = ~torch.isfinite(p).all(-1)
    ninf = torch.full((b, hh, ww), -math.inf)
    fill = [dist(*o) for o in taps[:k_eff]]
    for d2 in fill:
        poisoned |= torch.isnan(d2)
    best = _network([ninf] * pad + fill, bitonic_pairs(cap))
    inserts = torch.zeros((b, hh, ww), dtype=torch.int64)
    later = (dist(*o) for o in taps[k_eff:])
    best = _insert_each(best, later, block_of(cap), inserts, poisoned)
    assert all(torch.equal(best[t], ninf) for t in range(pad)), "the -inf entries never move"
    acc = torch.zeros((b, hh, ww))
    cnt = torch.zeros_like(acc)
    for s in best:
        found = (s >= 0) & (s <= 1e17)
        acc = acc + torch.where(found, torch.sqrt(s.clamp_min(0.0)), 0.0)
        cnt = cnt + found.float()
    mean = torch.where(poisoned, 0.0, acc / cnt.clamp_min(1.0))
    return mean.reshape(b, hh * ww), {"cap": cap, "inserts": inserts}


def _surface(rng: np.random.Generator, hh: int, ww: int) -> np.ndarray:
    """Points back-projected from a smooth depth map with a step edge and a
    few outliers (pinhole, fov 60°), as K3 lays them out."""
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float32)
    d = 2.0 + 0.5 * np.sin(xx / 3.0) * np.cos(yy / 4.0) + 1.5 * (xx > ww * 0.6)
    d[rng.random((hh, ww)) < 0.05] = rng.random() * 8.0
    f = 0.5 * ww / np.tan(np.radians(30.0))
    return np.stack([(xx - ww / 2) * d / f, (yy - hh / 2) * d / f, d], -1).astype(np.float32)


# One shape for every input, so that the JAX scan compiles once a pair.
SHAPE = (2, 12, 13, 3)


def _input(case: str) -> np.ndarray:
    rng = np.random.default_rng(12)
    if case == "ties":
        # A quarter lattice: many equal distances in every window.
        return (rng.integers(0, 6, SHAPE) * 0.25).astype(np.float32)
    if case == "surface":
        return np.stack([_surface(rng, *SHAPE[1:3]), _surface(rng, *SHAPE[1:3])[::-1]])
    if case == "tiny":
        # Distances below 2^-101, where the card's square root takes its
        # slow path.
        return (rng.random(SHAPE) * 1e-15).astype(np.float32)
    pts = (rng.random(SHAPE) * 3).astype(np.float32)
    pts[0, 3, 4, 1] = np.nan  # poisons every window that holds it
    pts[0, 8, 10, 0] = np.inf  # poisons its own point
    pts[1, 11, 0, 2] = -np.inf
    return pts


@functools.cache
def _jax_scan_fn(k: int, window: int):
    """The JAX scan form over a batch, compiled once a pair."""
    from image_to_pointcloud_tpu.ops.outlier import grid_knn_mean_distances as jscan

    return jax.jit(jax.vmap(lambda g: jscan(g, k=k, window=window)))


def _jax_scan(pts: np.ndarray, k: int, window: int) -> np.ndarray:
    return np.asarray(_jax_scan_fn(k, window)(jnp.asarray(pts)))


# k_eff on both sides of each list size (1, 8 | 9, 24 | 25, 33, 63, 64),
# the JAX tests' (10, 7), and k above the window's taps (k_eff = 9, 25).
PAIRS = [(1, 1), (8, 2), (9, 2), (24, 3), (25, 3), (33, 4), (63, 5), (64, 5), (10, 7), (30, 1),
         (40, 2)]


@pytest.mark.parametrize("k,window", PAIRS)
@pytest.mark.parametrize("case", ["ties", "surface", "naninf", "tiny"])
def test_replay_matches_plain_and_jax(case, k, window):
    pts = _input(case)
    ours, info = replay_general(torch.from_numpy(pts), k, window)
    k_eff = min(k, (2 * window + 1) ** 2)
    assert info["cap"] % LIST_STEP == 0 and info["cap"] - LIST_STEP < k_eff <= info["cap"]
    plain = grid_knn_mean_distances_plain(torch.from_numpy(pts), k=k, window=window)
    assert torch.equal(ours, plain)
    ref = _jax_scan(pts, k, window).reshape(ours.shape)
    ours = ours.numpy()
    np.testing.assert_array_equal(ours == 0, ref == 0)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)
    if case == "naninf":
        assert (ours == 0).sum() >= 3
    assert (ours > 0).any() or k_eff == 1


@pytest.mark.parametrize("window", [50, 51])
def test_replay_rings_past_the_grid(window):
    """Windows far wider than the 6×7 grid: the ring loop runs to ρ =
    window, and the rings past the grid's edge read the sentinel. (The
    card takes window 50 from its halo tile and 51 from global memory; the
    replay has one path, so only the card tests tell the two apart.)"""
    pts = _input("naninf")[:, :6, :7]
    ours, _ = replay_general(torch.from_numpy(pts), 8, window)
    assert torch.equal(ours, grid_knn_mean_distances_plain(torch.from_numpy(pts), k=8,
                                                           window=window))
    ref = _jax_scan(pts, 8, window).reshape(ours.shape)
    np.testing.assert_array_equal(ours.numpy() == 0, ref == 0)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-7)


def test_ring_order_covers_each_window_once():
    for r in (1, 4, 5, 9):
        taps = ring_order(r)
        assert len(taps) == len(set(taps)) == (2 * r + 1) ** 2
        assert taps[:(2 * (r - 1) + 1) ** 2] == ring_order(r - 1)  # a prefix: rings
        rings = [max(abs(dy), abs(dx)) for dy, dx in taps]
        assert rings == sorted(rings)
        for rho in range(1, r + 1):
            ring = [dy * dy + dx * dx for dy, dx in taps if max(abs(dy), abs(dx)) == rho]
            assert ring == sorted(ring)


@pytest.mark.parametrize("n", [8, 16, 24, 40, 56, 64])
def test_bitonic_pairs_sort(n):
    """sort_list's network sorts n values: random ones with many ties, and
    the reversed run."""
    rng = np.random.default_rng(n)
    for v in [*rng.integers(0, 6, (200, n)), np.arange(n)[::-1]]:
        v = list(v)
        for i, j in bitonic_pairs(n):
            v[i], v[j] = min(v[i], v[j]), max(v[i], v[j])
        assert v == sorted(v)
