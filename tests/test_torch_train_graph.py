"""The trainer's compiled step and ``depth_metrics``'s signatures, on the CPU.

On CUDA (a one-slot mesh) ``Trainer.train_step`` and ``depth_metrics``
replay one CUDA graph per signature (``tests/test_torch_cuda.py`` holds
the graphs against their eager bodies on the card); on the CPU and on
meshes of more slots the same callables run eagerly. Checked here:

* the signature keys follow the JAX jit's retrace rule (pixels' shape and
  dtype, the target's and the mask's shapes; no mask is the all-valid
  mask, not a signature of its own; ``depth_metrics``: the shapes, and
  whether a mask is given);
* the split step body takes the step of the trainer before the split (its
  loop, rebuilt here from the same weights), bit for bit over 3 steps, on
  a model whose last blocks the loss does not reach (zero gradients);
* ``n`` calls take exactly ``n`` steps, and a capture's warm-up pass
  (:meth:`Trainer._warm_up` around a step) is undone bit for bit, from a
  fresh optimizer state and from a running one;
* a trainer on the CPU or on a mesh of 2 data slots runs eagerly;
* 3 steps against the JAX ``Trainer`` (``tests/test_torch_train.py``'s
  config): the loss within 1e-5 relative at each step (f32 sums in
  another order; that file's one-step bound).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax
from image_to_pointcloud_tpu_torch.models.depth_anything import build_model, init_weights
from image_to_pointcloud_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    _loss_fn_for,
    train_model_config,
)
from test_torch_parallel import cpu_mesh
from test_torch_train import CLIP, LR, _cfgs

TCFG = TrainConfig(learning_rate=LR, loss="silog", grad_clip=CLIP)


def _batches(n: int, b: int = 2, hw: int = 56, seed: int = 3) -> list:
    r = np.random.default_rng(seed)
    return [(r.normal(0, 1, (b, hw, hw, 3)).astype(np.float32),
             (r.random((b, hw, hw)) + 0.5).astype(np.float32)) for _ in range(n)]


def _unreached_cfg():
    """``_cfgs``'s port config with taps at blocks 0 and 1 only: the loss
    does not reach blocks 2 and 3, whose gradients are zero."""
    cfg = _cfgs()[1]
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, out_layers=(0, 1, 1, 1)))


@pytest.fixture(scope="module")
def weights():
    cfg = _unreached_cfg()
    return cfg, init_weights(build_model(cfg), torch.Generator().manual_seed(0)).state_dict()


def _reference_steps(cfg, sd, tcfg: TrainConfig, batches: list) -> list:
    """The trainer's step before the split into a body, as its own loop:
    zero the gradients, forward on the one-slot mesh, loss and backward,
    a zero gradient for each parameter the loss does not reach, optax's
    clip, AdamW. (loss, parameters) after each step."""
    from image_to_pointcloud_tpu_torch.parallel.sharding import MeshedModel, make_mesh

    model = build_model(train_model_config(cfg, tcfg.remat))
    model.load_state_dict(sd, strict=True)
    net = MeshedModel(model.float(), make_mesh(data=1, devices=[torch.device("cpu")]), live=True)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=tcfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=tcfg.weight_decay)
    loss_fn = _loss_fn_for(tcfg)
    out = []
    for x, y in batches:
        target = torch.as_tensor(y, dtype=torch.float32)
        mask = torch.ones(target.shape, dtype=torch.bool)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(torch.cat([net.forward_slot(0, torch.as_tensor(x).float())]), target, mask)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < tcfg.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm) * tcfg.grad_clip))
        opt.step()
        out.append((loss.detach(), [p.detach().clone() for p in params]))
    return out


def test_train_signature_keys_follow_the_jit(weights):
    """Two batch shapes give two keys, a repeated shape none new; a given
    all-valid mask is the default mask's signature, another mask shape or
    pixels of another dtype a new one."""
    cfg, sd = weights
    tr = Trainer(cfg, sd, "cpu", TCFG)
    (x, y), (x2, y2) = _batches(1)[0], _batches(1, b=1, hw=42, seed=4)[0]
    tr.train_step(x, y)
    tr.train_step(x, y)
    assert list(tr._compiled) == [("train", x.shape, torch.float32, y.shape, y.shape)]
    tr.train_step(x2, y2)
    assert len(tr._compiled) == 2
    tr.train_step(x, y, np.ones(y.shape, bool))
    assert len(tr._compiled) == 2
    tr.train_step(x.astype(np.float64), y)
    assert len(tr._compiled) == 3 and ("train", x.shape, torch.float64, y.shape,
                                       y.shape) in tr._compiled
    assert all(fn.graph is None for fn in tr._compiled.values())


def test_depth_metrics_signature_keys():
    """``depth_metrics``: with and without a mask are two signatures; the
    same shapes again add none; another shape adds one; the outputs are
    the body's."""
    from image_to_pointcloud_tpu_torch.train import eval as teval

    r = np.random.default_rng(0)
    pred = torch.from_numpy(r.random((2, 9, 11)).astype(np.float32) + 0.1)
    target = torch.from_numpy(r.random((2, 9, 11)).astype(np.float32) + 0.1)
    mask = torch.from_numpy(r.random((2, 9, 11)) > 0.3)
    owner = teval._owner(torch.device("cpu"))
    before = set(owner._compiled)
    a, b = teval.depth_metrics(pred, target), teval.depth_metrics(pred, target, mask)
    teval.depth_metrics(pred, target)
    new = set(owner._compiled) - before
    assert {k[-1] for k in new} == {False, True} and len(new) == 2
    teval.depth_metrics(pred[:1], target[:1])
    assert len(set(owner._compiled) - before) == 3
    assert not owner.cuda_graphs
    for got, body in ((a, teval._metrics(pred, target)), (b, teval._metrics(pred, target, mask))):
        assert set(got) == set(body) and len(got) == 8
        assert all(torch.equal(got[k], body[k]) for k in got)


def test_split_body_equals_the_unsplit_step(weights):
    """Three steps of the trainer, each through its signature's callable
    (eager on the CPU), against the loop of the step before the split:
    the loss and every parameter bit for bit after each step; the blocks
    the loss does not reach keep one zero gradient tensor."""
    cfg, sd = weights
    batches = _batches(3)
    ref = _reference_steps(cfg, sd, TCFG, batches)
    tr = Trainer(cfg, sd, "cpu", TCFG)
    unreached = [p for n, p in tr.model.named_parameters()
                 if n.startswith(("backbone.blocks.2.", "backbone.blocks.3."))]
    assert unreached
    zeros = None
    for (x, y), (ref_loss, ref_params) in zip(batches, ref):
        loss = tr.train_step(x, y)
        assert torch.equal(loss, ref_loss)
        for p, rp in zip(tr.params, ref_params):
            assert torch.equal(p.detach(), rp)
        assert all(not p.grad.any() for p in unreached)
        grads = [p.grad for p in unreached]
        assert zeros is None or all(g is z for g, z in zip(grads, zeros))
        zeros = grads
    assert len(tr._compiled) == 1


def test_n_calls_take_n_steps_and_the_warm_up_is_undone(weights):
    """After ``n`` calls AdamW's step count is ``n`` on every parameter. A
    capture's warm-up pass, a whole step inside :meth:`Trainer._warm_up`,
    leaves the parameters and the optimizer state as they were (from a
    fresh state: AdamW's zeros, step 0) and every gradient None; the steps
    after it are those of a trainer that never warmed up, bit for bit."""
    cfg, sd = weights
    batches = _batches(3)
    plain, warmed = Trainer(cfg, sd, "cpu", TCFG), Trainer(cfg, sd, "cpu", TCFG)
    x, y = (torch.from_numpy(a) for a in batches[0])
    mask = torch.ones(y.shape, dtype=torch.bool)
    before = [p.detach().clone() for p in warmed.params]
    with warmed._warm_up():
        warmed._step(x, y, mask)
    assert all(torch.equal(p, b) for p, b in zip(warmed.params, before))
    assert all(p.grad is None for p in warmed.params)
    states = list(warmed.opt.state.values())
    assert len(states) == len(warmed.params)
    assert all(not v.any() for st in states for v in st.values())
    for n, (bx, by) in enumerate(batches, 1):
        for tr in (plain, warmed):
            tr.train_step(bx, by)
            assert [int(st["step"]) for st in tr.opt.state.values()] == [n] * len(tr.params)
        if n == 2:  # a warm-up from a running state
            saved = [p.detach().clone() for p in warmed.params]
            moments = [v.clone() for st in warmed.opt.state.values() for v in st.values()]
            with warmed._warm_up():
                warmed._step(x, y, mask)
            assert all(torch.equal(p, s) for p, s in zip(warmed.params, saved))
            assert all(torch.equal(v, m) for v, m in zip(
                (v for st in warmed.opt.state.values() for v in st.values()), moments))
    for p, q in zip(plain.params, warmed.params):
        assert torch.equal(p, q)


@pytest.mark.parametrize("mesh", [None, "data=2"])
def test_cpu_and_meshed_trainers_run_eagerly(weights, mesh):
    """On the CPU, and on a mesh of 2 data slots, ``cuda_graphs`` is off:
    the step's callable runs its body eagerly (no graph), one a
    signature, and the step counts."""
    cfg, sd = weights
    tr = Trainer(cfg, sd, "cpu", TCFG, mesh=cpu_mesh(data=2) if mesh else None)
    assert not tr.cuda_graphs and tr.graph_pool_bytes() == 0
    for x, y in _batches(2):
        assert np.isfinite(float(tr.train_step(x, y)))
    assert len(tr._compiled) == 1
    assert all(fn.graph is None for fn in tr._compiled.values())
    assert {int(st["step"]) for st in tr.opt.state.values()} == {2}


def test_three_steps_match_jax():
    """Three steps on three batches, the port's trainer against the JAX
    ``Trainer`` from the same Flax init: the loss within 1e-5 relative at
    every step."""
    import jax
    import jax.numpy as jnp

    from image_to_pointcloud_tpu.models import DepthAnything as JDA
    from image_to_pointcloud_tpu.parallel.sharding import make_mesh
    from image_to_pointcloud_tpu.train.trainer import TrainConfig as JTrainConfig
    from image_to_pointcloud_tpu.train.trainer import Trainer as JTrainer

    jcfg, cfg = _cfgs()
    params = jax.jit(JDA(jcfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    jtr = JTrainer(jcfg, params, make_mesh(data=1, devices=jax.devices()[:1]),
                   JTrainConfig(learning_rate=LR, loss="silog", grad_clip=CLIP))
    tr = Trainer(cfg, state_dict_from_flax(params), "cpu", TCFG)
    for x, y in _batches(3):
        ref = float(jtr.train_step(jnp.asarray(x), jnp.asarray(y)))
        assert float(tr.train_step(x, y)) == pytest.approx(ref, rel=1e-5)
