"""The port's fine-tuning (``train/``) against the JAX package's, on the CPU.

Same numpy inputs in both packages; the model's Flax init carried across
by ``models/bridge.py``. Tolerances:

* losses and ``depth_metrics``: 1e-6 relative (f32 sums in another order);
  the trimmed affine-invariant loss keeps exactly the JAX count,
  ``floor((1 − trim)·nvalid)`` in f32;
* ``synthetic_depth_batches``: byte-identical;
* one ``Trainer`` step against JAX's ``Trainer`` on a one-device mesh, at
  the DA-V2 test config of tests/test_parallel.py with the metric head:
  the loss to 1e-5 relative, each clipped gradient to 1e-4 of its tensor's
  largest |g| (the keys' biases, whose gradient is zero in exact
  arithmetic, to f32 noise: 1e-6 of the largest |g| of the model), and each updated parameter to 1e-3·lr plus what the
  gradient difference carries through Adam's first step. That step moves
  a parameter by lr·g/(|g| + eps): where |g| is within a few eps (1e-8)
  it is steep, and f32 noise of 1e-9 in a g of 4e-8 moves it by 6e-3·lr
  (the test model has such elements), a sign flip of a g near 0 by up to
  2·lr. So each element's bound adds lr·|δg|·eps/(m + eps)², m the least
  |g| between the two gradients (0 across a sign change), the mean-value
  bound of that step;
* remat against no remat, and a resumed run against an uninterrupted one:
  equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax
from image_to_pointcloud_tpu_torch.train import losses as tl
from image_to_pointcloud_tpu_torch.train.eval import depth_metrics

LR = 1e-3
# Below the test model's first gradient norm (~0.6), so the step clips.
CLIP = 0.25
ADAM_EPS = 1e-8


def _maps(seed: int, b: int = 3, h: int = 33, w: int = 40):
    r = np.random.default_rng(seed)
    pred = (r.random((b, h, w)) * 3 + 0.1).astype(np.float32)
    target = (pred * r.uniform(0.7, 1.3, (b, h, w)) + r.normal(0, 0.05, (b, h, w))).astype(
        np.float32)
    target[0, :3] = 0.0  # invalid targets for the metrics
    mask = r.random((b, h, w)) > 0.2
    mask[2] = False  # an image with no valid pixel
    return pred, target, mask


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,kw", [
    ("silog_loss", {}), ("silog_loss", {"lam": 0.5}),
    ("affine_invariant_loss", {"trim": 0.0}), ("affine_invariant_loss", {"trim": 0.2}),
    ("gradient_matching_loss", {}), ("gradient_matching_loss", {"scales": 2}),
])
def test_losses_match_jax(name, kw, masked):
    from image_to_pointcloud_tpu.train import losses as jl

    pred, target, mask = _maps(1)
    m = mask if masked else None
    ref = float(getattr(jl, name)(jnp.asarray(pred), jnp.asarray(target),
                                  None if m is None else jnp.asarray(m), **kw))
    ours = float(getattr(tl, name)(_t(pred), _t(target), None if m is None else _t(m), **kw))
    assert ours == pytest.approx(ref, rel=1e-6, abs=1e-7)


def test_trim_keeps_the_jax_count():
    """``keep_n = floor((1 − trim)·nvalid)`` in f32: with 10 valid residuals
    and trim 0.3, f32(0.7)·10 rounds to 7 and 7 are kept (the 3 largest
    dropped), as in the JAX package."""
    from image_to_pointcloud_tpu.train import losses as jl

    pred = np.zeros((1, 2, 5), np.float32)
    target = np.zeros((1, 2, 5), np.float32)
    target[0, 0, 0] = 1.0  # the alignment leaves 0.9 and nine 0.1 residuals
    ref = float(jl.affine_invariant_loss(jnp.asarray(pred), jnp.asarray(target), trim=0.3))
    ours = float(tl.affine_invariant_loss(_t(pred), _t(target), trim=0.3))
    assert ours == pytest.approx(ref, rel=1e-6)
    assert ours == pytest.approx(0.1, rel=1e-5)  # the 0.9 residual is trimmed


@pytest.mark.parametrize("masked", [False, True])
def test_depth_metrics_match_jax(masked):
    from image_to_pointcloud_tpu.train.eval import depth_metrics as jmetrics

    pred, target, mask = _maps(2)
    m = mask if masked else None
    ref = jmetrics(jnp.asarray(pred), jnp.asarray(target), None if m is None else jnp.asarray(m))
    ours = depth_metrics(_t(pred), _t(target), None if m is None else _t(m))
    assert set(ours) == set(ref) and len(ours) == 8
    for k in ref:
        assert float(ours[k]) == pytest.approx(float(ref[k]), rel=1e-6, abs=1e-7), k


def test_synthetic_batches_are_byte_identical():
    from image_to_pointcloud_tpu.train.data import synthetic_depth_batches as jbatches
    from image_to_pointcloud_tpu_torch.train.data import synthetic_depth_batches

    kw = dict(batch_size=3, image_hw=(20, 28), steps=3, seed=7)
    for (a, b), (c, d) in zip(synthetic_depth_batches(**kw), jbatches(**kw), strict=True):
        assert a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()
        assert a.dtype == np.float32 and b.dtype == np.float32


def test_prefetch_keeps_order_stops_and_raises():
    from image_to_pointcloud_tpu_torch.train.data import prefetch_to_device

    batches = [(np.full((2, 3), i, np.float32), {"d": np.arange(i + 1)}) for i in range(5)]
    got = list(prefetch_to_device(iter(batches), device="cpu"))
    assert len(got) == 5
    for i, (x, tree) in enumerate(got):
        assert isinstance(x, torch.Tensor) and torch.equal(x, torch.full((2, 3), float(i)))
        assert torch.equal(tree["d"], torch.arange(i + 1))

    def endless():
        i = 0
        while True:
            yield (np.full(2, i, np.float32),)
            i += 1

    it = prefetch_to_device(endless(), size=2, device="cpu")
    assert float(next(it)[0][0]) == 0.0
    it.close()  # the worker stops instead of blocking on a full queue

    def broken():
        yield (np.zeros(2, np.float32),)
        raise ValueError("bad batch")

    it = prefetch_to_device(broken(), device="cpu")
    next(it)
    with pytest.raises(ValueError, match="bad batch"):
        next(it)


# ---------- the trainer ----------


def _cfgs():
    """(JAX config, the port's config): tests/test_parallel.py's DA-V2
    trainer config (hidden 32, 4 layers, 2 heads) with the metric head."""
    from image_to_pointcloud_tpu.models import DepthAnythingConfig as JCfg
    from image_to_pointcloud_tpu.models.dinov2 import DinoV2Config as JB
    from image_to_pointcloud_tpu.models.dpt import DPTConfig as JN
    from image_to_pointcloud_tpu_torch.models.depth_anything import DepthAnythingConfig
    from image_to_pointcloud_tpu_torch.models.dinov2 import DinoV2Config
    from image_to_pointcloud_tpu_torch.models.dpt import DPTConfig

    bb = dict(hidden_size=32, num_layers=4, num_heads=2, pos_embed_size=4,
              out_layers=(0, 1, 2, 3))
    nk = dict(hidden_size=32, neck_hidden_sizes=(8, 16, 32, 32), fusion_hidden_size=16,
              head_hidden_size=8, metric_depth=True, max_depth=2.0)
    return (JCfg(backbone=JB(**bb), neck=JN(**nk)),
            DepthAnythingConfig(backbone=DinoV2Config(**bb), neck=DPTConfig(**nk)))


@pytest.fixture(scope="module")
def setup():
    from image_to_pointcloud_tpu.models import DepthAnything as JDA

    jcfg, cfg = _cfgs()
    params = jax.jit(JDA(jcfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    r = np.random.default_rng(3)
    x = r.normal(0, 1, (2, 56, 56, 3)).astype(np.float32)
    y = (r.random((2, 56, 56)) + 0.5).astype(np.float32)
    return jcfg, cfg, params, x, y


def _trainer(cfg, params, **kw):
    from image_to_pointcloud_tpu_torch.train.trainer import TrainConfig, Trainer

    tcfg = TrainConfig(learning_rate=LR, loss="silog", **kw)
    return Trainer(cfg, state_dict_from_flax(params), "cpu", tcfg)


def test_train_step_matches_jax(setup):
    from image_to_pointcloud_tpu.parallel.sharding import make_mesh
    from image_to_pointcloud_tpu.train.trainer import TrainConfig as JTrainConfig
    from image_to_pointcloud_tpu.train.trainer import Trainer as JTrainer

    jcfg, cfg, params, x, y = setup
    jtr = JTrainer(jcfg, params, make_mesh(data=1, devices=jax.devices()[:1]),
                   JTrainConfig(learning_rate=LR, loss="silog", grad_clip=CLIP))
    ref_loss = float(jtr.train_step(jnp.asarray(x), jnp.asarray(y)))
    ref_params = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jtr.params))
    # optax's clipped gradients, read back from Adam's first moment after
    # its first step: mu = (1 − b1)·g.
    adam = jtr.opt_state[1][0]
    assert int(adam.count) == 1
    ref_grads = state_dict_from_flax(
        jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(0.1), adam.mu))

    tr = _trainer(cfg, params, grad_clip=CLIP)
    loss = float(tr.train_step(x, y))
    norm = float(torch.sqrt(sum((p.grad**2).sum() for p in tr.model.parameters())))
    assert norm == pytest.approx(CLIP, rel=1e-5)  # the clip was applied
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    named = dict(tr.model.named_parameters())
    assert set(named) == set(ref_grads)
    gmax = max(float(v.abs().max()) for v in ref_grads.values())
    for name, p in named.items():
        g, rg = p.grad, ref_grads[name]
        if name.endswith(".k.bias"):
            # Zero in exact arithmetic (the softmax over keys ignores the
            # q·b_k it adds to a whole row): f32 noise in both packages.
            assert max(float(g.abs().max()), float(rg.abs().max())) <= 1e-6 * gmax, name
        else:
            assert float((g - rg).abs().max()) <= 1e-4 * float(rg.abs().max()), name
        # Adam's first step moves a parameter by lr·g/(|g| + eps) (+ the
        # decay): the gradient difference just checked moves it by at most
        # lr·|δg|·eps/(m + eps)², m the least |g| between the two gradients
        # (0 if their signs differ).
        m = torch.where(g * rg > 0, torch.minimum(g.abs(), rg.abs()), 0.0)
        carried = LR * (g - rg).abs() * ADAM_EPS / (m + ADAM_EPS) ** 2
        err = (p.detach() - ref_params[name]).abs()
        assert bool((err <= 1e-3 * LR + carried).all()), name


def test_remat_and_resume(setup, tmp_path):
    """remat=True and remat=False take the same step; a run saved after
    one step (params and optimizer state), restored and resumed takes the
    same second step as an uninterrupted run."""
    from image_to_pointcloud_tpu_torch.train.checkpoint import (
        restore_checkpoint,
        restore_params,
        save_checkpoint,
    )
    from image_to_pointcloud_tpu_torch.train.trainer import TrainConfig, Trainer

    _, cfg, params, x, y = setup
    a, b = _trainer(cfg, params, remat=True), _trainer(cfg, params, remat=False)
    assert a.model.backbone.cfg.remat_blocks and not b.model.backbone.cfg.remat_blocks
    assert not a.model.backbone.cfg.use_flash_attention
    la, lb = float(a.train_step(x, y)), float(b.train_step(x, y))
    assert la == lb
    for (n, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), n

    save_checkpoint(tmp_path / "ck", a.state_dict(), opt_state=a.opt.state_dict(), step=1)
    assert not list((tmp_path / "ck").glob("*.tmp"))
    ck = restore_checkpoint(tmp_path / "ck")
    assert ck["step"] == 1
    resumed = Trainer(cfg, ck["params"], "cpu", TrainConfig(learning_rate=LR, loss="silog"),
                      opt_state=ck["opt_state"])
    l2, l2_ref = float(resumed.train_step(x, y)), float(a.train_step(x, y))
    assert l2 == l2_ref and l2 < la
    for (n, p), q in zip(resumed.model.named_parameters(), a.model.parameters()):
        assert torch.equal(p, q), n
    assert set(restore_params(tmp_path / "ck")) == set(a.state_dict())


def test_flash_attention_refuses_grad_before_any_launch():
    """The K1 wrapper's guard comes first: a tensor that requires grad under
    grad mode is refused on any device, so a trainer can never take an
    output without a gradient (the card's own case is in
    tests/test_torch_cuda.py); the trainer's models use the plain
    attention, which carries the gradient."""
    from image_to_pointcloud_tpu_torch.models.attention import flash_attention, multi_head_attention

    q = torch.randn(1, 2, 9, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, q, q)
    x = torch.randn(1, 9, 128, requires_grad=True)
    multi_head_attention(x, x, x, num_heads=2, use_flash=False).sum().backward()
    assert x.grad is not None and x.grad.abs().max() > 0
