"""Inputs, arrivals and weights are deterministic in the seed, and a seed
changes their content but not the amount of work."""

import numpy as np
import torch

from portbench import synth
from portbench.drivers.serve import arrivals
from portbench.tests import tiny
from portbench.weights import make_state_dict

BIG = 2**31 + 12345  # seeds past 32 signed bits are valid too


def test_frames_and_jpegs_deterministic():
    a, b = synth.frames(BIG, 3, 48, 64), synth.frames(BIG, 3, 48, 64)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert synth.jpeg(a[0], 88) == synth.jpeg(b[0], 88)
    c = synth.frames(BIG + 1, 3, 48, 64)
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])


def test_photo_is_the_frozen_copy():
    img = synth.photo(64, 48, 7)
    assert img.shape == (48, 64, 3) and img.dtype == np.uint8
    assert np.array_equal(img, synth.photo(64, 48, 7))


def test_arrivals_same_work_other_order():
    a, b = arrivals(20.0, 30.0, BIG), arrivals(20.0, 30.0, BIG + 1)
    assert len(a) == len(b) == 600
    assert not np.array_equal(a, b)
    assert np.array_equal(arrivals(20.0, 30.0, BIG), a)
    # The same gaps in another order: the same last send but for the one gap left out.
    assert abs(a[-1] - 30.0) < 2.0 and abs(b[-1] - 30.0) < 2.0


def test_weights_deterministic_in_seed():
    cfg = tiny.config("portbench-tiny-da")
    a = make_state_dict(cfg, BIG, "cpu", torch.float32)
    b = make_state_dict(cfg, BIG, "cpu", torch.float32)
    c = make_state_dict(cfg, BIG + 1, "cpu", torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "backbone.blocks.0.q.weight"
    assert not torch.equal(a[w], c[w])
    assert torch.all(a["neck.head_conv3.weight"] >= 0)
    assert torch.all(a["backbone.blocks.0.norm1.weight"] == 1) and torch.all(a["backbone.patch_embed.bias"] == 0)
    # LeCun: variance 1/fan-in, cut at 2σ.
    wide = make_state_dict(tiny.config("portbench-tiny-dpt"), BIG, "cpu", torch.float32)["neck.readout0.weight"]
    fan_in = wide.shape[1]
    assert abs(wide.float().var().item() * fan_in - 1.0) < 0.15
    assert wide.abs().max().item() <= 2.0 / 0.87962566103423978 / fan_in**0.5 + 1e-6
