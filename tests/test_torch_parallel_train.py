"""The port's meshed fine-tuning against the JAX package's, on the CPU.

``Trainer`` on a (data=2, model=2) mesh of ``["cpu"] * 4`` slots against
JAX's ``Trainer`` on ``make_mesh(data=2, model=2)`` over the fake CPU
devices, from the same weights and batch, held as tests/test_torch_train.py
holds the one-device step: the loss to 1e-5 relative, each clipped
gradient (read back from Adam's first moment) to 1e-4 of its tensor's
largest |g|, each parameter to 1e-3·lr plus what the gradient difference
carries through Adam's step; then the second step's loss to 1e-5 relative
and every parameter against the port's one-device trainer after the same
two steps (1e-3·lr plus that carry, twice). The meshed loss equals the
one-device loss on one batch; ``restore_params(mesh=)`` and
``prefetch_to_device(sharding=)`` place on the slots.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax
from image_to_pointcloud_tpu_torch.parallel import sharding as ts
from test_torch_parallel import CPU, cpu_mesh
from test_torch_train import ADAM_EPS, CLIP, LR, _cfgs


@pytest.fixture(scope="module")
def setup():
    from image_to_pointcloud_tpu.models import DepthAnything as JDA
    from test_torch_families import _randomize

    jcfg, cfg = _cfgs()
    params = jax.jit(JDA(jcfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)))["params"]
    params = _randomize(jax.tree_util.tree_map(np.asarray, params), np.random.default_rng(1))
    r = np.random.default_rng(3)
    x = r.normal(0, 1, (2, 56, 56, 3)).astype(np.float32)
    y = (r.random((2, 56, 56)) + 0.5).astype(np.float32)
    return jcfg, cfg, params, x, y


def _trainer(cfg, params, mesh=None):
    from image_to_pointcloud_tpu_torch.train.trainer import TrainConfig, Trainer

    tcfg = TrainConfig(learning_rate=LR, loss="silog", grad_clip=CLIP)
    return Trainer(cfg, state_dict_from_flax(params), "cpu", tcfg, mesh=mesh)


def _carry(g, rg):
    """lr·|δg|·eps/(m + eps)²: what a gradient difference moves an Adam
    step by (tests/test_torch_train.py)."""
    m = torch.where(g * rg > 0, torch.minimum(g.abs(), rg.abs()), 0.0)
    return LR * (g - rg).abs() * ADAM_EPS / (m + ADAM_EPS) ** 2


def _grads(tr) -> dict:
    """Each parameter's clipped gradient, by its one-device name."""
    saved = {id(p): p.detach().clone() for p in tr.params}
    for p in tr.params:
        p.data.copy_(p.grad)
    out = {k: v.clone() for k, v in tr.state_dict().items()}
    for p in tr.params:
        p.data.copy_(saved[id(p)])
    return out


def test_meshed_trainer_matches_jax(setup):
    from image_to_pointcloud_tpu.parallel.sharding import make_mesh
    from image_to_pointcloud_tpu.train.trainer import TrainConfig as JTrainConfig
    from image_to_pointcloud_tpu.train.trainer import Trainer as JTrainer

    jcfg, cfg, params, x, y = setup
    jtr = JTrainer(jcfg, params, make_mesh(data=2, model=2, devices=jax.devices()[:4]),
                   JTrainConfig(learning_rate=LR, loss="silog", grad_clip=CLIP))
    ref_loss = float(jtr.train_step(jnp.asarray(x), jnp.asarray(y)))
    ref_params = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jtr.params))
    ref_grads = state_dict_from_flax(
        jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(0.1), jtr.opt_state[1][0].mu))

    tr, one = _trainer(cfg, params, cpu_mesh(data=2, model=2)), _trainer(cfg, params)
    assert {p.device for p in tr.params} == {CPU} and tr.model is None
    # Each parameter trained once: as many elements as the one-device model.
    assert sum(p.numel() for p in tr.params) == sum(p.numel() for p in one.model.parameters())
    loss = float(tr.train_step(x, y))
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    grads, sd = _grads(tr), tr.state_dict()
    assert set(grads) == set(ref_grads) and set(sd) == set(ref_params)
    gmax = max(float(v.abs().max()) for v in ref_grads.values())
    for name, rg in ref_grads.items():
        g = grads[name]
        if name.endswith(".k.bias"):
            assert max(float(g.abs().max()), float(rg.abs().max())) <= 1e-6 * gmax, name
        else:
            assert float((g - rg).abs().max()) <= 1e-4 * float(rg.abs().max()), name
        err = (sd[name] - ref_params[name]).abs()
        assert bool((err <= 1e-3 * LR + _carry(g, rg)).all()), name

    # The second step: its loss against JAX's, every parameter against the
    # port's one-device trainer after the same two steps.
    ref_loss2 = float(jtr.train_step(jnp.asarray(x), jnp.asarray(y)))
    one.train_step(x, y)
    g1 = {n: p.grad.clone() for n, p in one.model.named_parameters()}
    loss2, loss2_one = float(tr.train_step(x, y)), float(one.train_step(x, y))
    assert loss2 == pytest.approx(ref_loss2, rel=1e-5)
    assert loss2 == pytest.approx(loss2_one, rel=1e-5)
    grads2, sd = _grads(tr), tr.state_dict()
    for name, p in one.model.named_parameters():
        bound = 2e-3 * LR + _carry(grads[name], g1[name]) + _carry(grads2[name], p.grad)
        assert bool(((sd[name] - p.detach()).abs() <= bound).all()), name


def test_meshed_loss_is_the_global_loss(setup):
    """The meshed loss, taken on the predictions gathered on the first
    slot, equals the one-device loss on one batch, with a mask, for silog
    and the affine-invariant loss."""
    from image_to_pointcloud_tpu_torch.train.trainer import TrainConfig, Trainer

    _, cfg, params, x, y = setup
    x4 = np.concatenate([x, x[::-1] * 0.5])
    y4 = np.concatenate([y, y[:, ::-1] ** 2])
    mask = np.random.default_rng(5).random(y4.shape) > 0.3
    for loss_name in ("silog", "affine_invariant"):
        tcfg = TrainConfig(learning_rate=LR, loss=loss_name)
        sd = state_dict_from_flax(params)
        one = Trainer(cfg, sd, "cpu", tcfg)
        meshed = Trainer(cfg, sd, "cpu", tcfg, mesh=cpu_mesh(data=4, model=2))
        a = float(one.train_step(x4, y4, mask))
        b = float(meshed.train_step(x4, y4, mask))
        assert b == pytest.approx(a, rel=1e-6)


def test_restore_params_onto_mesh(setup, tmp_path):
    from image_to_pointcloud_tpu_torch.train.checkpoint import restore_params, save_checkpoint

    _, cfg, params, x, y = setup
    sd = state_dict_from_flax(params)
    save_checkpoint(tmp_path / "ck", sd, step=3)
    mesh = cpu_mesh(data=2, model=2)
    placed = restore_params(tmp_path / "ck", mesh=mesh)
    assert set(placed) == set(sd)
    q = placed["backbone.blocks.0.q.weight"]
    assert isinstance(q, ts.Sharded) and q.slot(model=1).shape == (16, 32)
    assert torch.equal(q.slot(data=1, model=1), sd["backbone.blocks.0.q.weight"][16:])
    assert placed["backbone.blocks.0.proj.weight"].slot(model=0).shape == (32, 16)
    assert placed["backbone.pos_embed"].slot(data=1, model=1).shape == sd["backbone.pos_embed"].shape
    assert all(torch.equal(v, sd[k]) for k, v in ts.gather_params(placed).items())
    from image_to_pointcloud_tpu_torch.train.trainer import TrainConfig, Trainer

    tr = Trainer(cfg, placed, "cpu", TrainConfig(learning_rate=LR, loss="silog"), mesh=mesh)
    assert all(torch.equal(v, sd[k]) for k, v in tr.state_dict().items())


def test_prefetch_places_batches_on_the_data_slots():
    from image_to_pointcloud_tpu_torch.train.data import prefetch_to_device

    mesh = cpu_mesh(data=4, model=2)
    batches = [(np.full((8, 4), i, np.float32), np.arange(8 * 3).reshape(8, 3) + i)
               for i in range(5)]
    out = list(prefetch_to_device(iter(batches), size=2,
                                  sharding=lambda a: ts.batch_sharding(mesh, a.ndim)))
    assert len(out) == 5
    for i, (x, lab) in enumerate(out):
        assert isinstance(x, ts.Sharded) and x.sharding.spec == ("data", None)
        rows = x.data_shards()
        assert len(rows) == 4 and all(r.shape == (2, 4) for r in rows)
        assert x.slot(data=2, model=1) is x.slot(data=2, model=0)  # replicated over model
        np.testing.assert_array_equal(x.gather().numpy(), batches[i][0])
        np.testing.assert_array_equal(lab.data_shards()[3].numpy(), batches[i][1][6:])
    one = ts.replicated(mesh)
    (got,) = list(prefetch_to_device(iter([(np.ones(3, np.float32),)]), sharding=one))
    assert got[0].sharding.spec == () and torch.equal(got[0].slot(data=3, model=1),
                                                      torch.ones(3))
