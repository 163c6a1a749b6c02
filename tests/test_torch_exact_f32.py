"""Every f32 forward of the port on CUDA runs inside ``exact_f32`` (TF32
off for cuDNN convolutions and CUDA matmuls), on the CPU.

The three paths besides ``DepthPipeline``: the advanced pipelines'
``_ModelPipeline._predict``, the v2 matte's ``MatteModel.prob``, and the
trainer's forward, loss and backward (``Trainer.train_step``). Each
module's ``exact_f32`` is replaced by a recorder around the real scope,
and hooks on the model read, while the forward (and the backward) runs,
whether the scope is open and what the TF32 flags are. The models run on
the CPU, so the device check is faked where the case says "cuda": the
module's ``wants_exact_f32`` sees a CUDA device, its dtype test stays
real. On the CPU, and for a bf16 model, the scope is entered with
``on=False`` and the flags are left alone.

The outputs, with the scope on, agree with the JAX package on the CPU at
the tolerances of the paths' own tests (one tiny metric DA-V2 with
64-wide heads serves the pipeline and the trainer): the metric cloud as
``test_torch_advanced.py`` (RMSE < 1e-3, every coordinate within 1e-4,
colours equal), a SegFormer-B0 matte's probability at 64² within 1e-5 as
``test_torch_segformer.py``, the trainer's first loss within rel 1e-5 as
``test_torch_train.py``.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax
from image_to_pointcloud_tpu_torch.pipeline import advanced as tadv
from image_to_pointcloud_tpu_torch.pipeline import graph
from image_to_pointcloud_tpu_torch.serve import matting as tmatting
from image_to_pointcloud_tpu_torch.train import trainer as ttrainer

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_advanced import INTR, _assert_cloud, _port_model  # noqa: E402
from test_torch_train import CLIP, LR  # noqa: E402

# "cuda": an f32 model with the device check faked to CUDA; "cpu": f32,
# the real check; "bf16": a bf16 model with the device faked to CUDA.
MODES = ["cuda", "cpu", "bf16"]


class _Scopes:
    """Records each ``exact_f32(on)`` a path enters and keeps the real
    scope's effect; ``depth`` counts the open scopes with ``on``."""

    def __init__(self):
        self.entered: list[bool] = []
        self.depth = 0
        self.seen: list[tuple[int, bool, bool]] = []  # (depth, matmul, cudnn) in a hook

    @contextlib.contextmanager
    def __call__(self, on: bool = True):
        self.entered.append(on)
        with graph.exact_f32(on):
            self.depth += on
            try:
                yield
            finally:
                self.depth -= on

    def look(self, *_):
        self.seen.append((self.depth, torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32))


@pytest.fixture
def scopes(monkeypatch):
    """The recorder in every module of the three paths, with both TF32
    flags on before and checked after: the scope restores them."""
    rec = _Scopes()
    for mod in (tadv, tmatting, ttrainer):
        monkeypatch.setattr(mod, "exact_f32", rec)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield rec
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _fake_device(monkeypatch, mode: str) -> None:
    """In modes "cuda" and "bf16" each module's device check sees CUDA."""
    if mode == "cpu":
        return

    def on_cuda(device, dtype):
        return graph.wants_exact_f32(torch.device("cuda"), dtype)

    for mod in (tadv, tmatting, ttrainer):
        monkeypatch.setattr(mod, "wants_exact_f32", on_cuda)


def _assert_scoped(rec: _Scopes, mode: str) -> None:
    """The scope was entered with on = (mode == "cuda"), and every hook
    ran inside it with both flags off; or outside it, the flags as set."""
    on = mode == "cuda"
    assert rec.entered and set(rec.entered) == {on}
    assert rec.seen
    for depth, matmul, cudnn in rec.seen:
        assert (depth > 0, matmul, cudnn) == ((True, False, False) if on else (False, True, True))


def _draw(module, shape: tuple, seed: int) -> dict:
    """Flax params of ``module`` at input ``shape`` drawn with numpy (the
    tree from ``eval_shape``, no compile): weights N(0, 0.05), norm scales
    1 + N(0, 0.1), batch-norm variances U(0.5, 1.5)."""
    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(shape))["params"]
    r = np.random.default_rng(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", "")
        if name == "var":
            v = r.uniform(0.5, 1.5, x.shape)
        elif name == "scale":
            v = 1.0 + r.normal(0, 0.1, x.shape)
        else:
            v = r.normal(0, 0.05, x.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


# ---------- the advanced pipelines: _ModelPipeline._predict ----------


@pytest.fixture(scope="module")
def metric64():
    """(JAX config, params, port model): a tiny metric DA-V2 whose two
    heads are 64 wide (hidden 128, 2 layers, max depth 5)."""
    from image_to_pointcloud_tpu.models import DepthAnything as JDA
    from image_to_pointcloud_tpu.models import DepthAnythingConfig as JCfg
    from image_to_pointcloud_tpu.models.dinov2 import DinoV2Config as JB
    from image_to_pointcloud_tpu.models.dpt import DPTConfig as JN

    jcfg = JCfg(
        backbone=JB(hidden_size=128, num_layers=2, num_heads=2, pos_embed_size=4,
                    out_layers=(0, 1, 1, 1)),
        neck=JN(hidden_size=128, neck_hidden_sizes=(8, 16, 32, 32), fusion_hidden_size=16,
                head_hidden_size=8, metric_depth=True, max_depth=5.0))
    params = _draw(JDA(jcfg), (1, 56, 56, 3), seed=0)
    return jcfg, params, _port_model(jcfg, params)


@pytest.mark.parametrize("mode", MODES)
def test_advanced_predict_runs_exact_f32(metric64, scopes, monkeypatch, mode):
    from image_to_pointcloud_tpu.pipeline.advanced import CameraIntrinsics, MetricPipeline

    jcfg, params, model = metric64
    _fake_device(monkeypatch, mode)
    if mode == "bf16":
        model = _port_model(jcfg, params).to(torch.bfloat16)
    hook = model.register_forward_hook(scopes.look)
    try:
        pipe = tadv.MetricPipeline(model, model_target=56, quantized_transfer=False)
        assert pipe.exact_f32 == (mode == "cuda")
        img = np.random.default_rng(0).integers(0, 256, (70, 84, 3), dtype=np.uint8)
        ours = pipe.run(img, tadv.CameraIntrinsics(**INTR), step=2)
    finally:
        hook.remove()
    _assert_scoped(scopes, mode)
    if mode != "bf16":
        ref = MetricPipeline(jcfg, params, model_target=56, quantized_transfer=False).run(
            img, CameraIntrinsics(**INTR), step=2)
        _assert_cloud(ours, ref)


# ---------- the v2 matte: MatteModel.prob ----------


@pytest.fixture(scope="module")
def matte_pair():
    """A random SegFormer-B0 matte (sigmoid head), as the JAX package's
    ``MatteModel`` and the port's state dict."""
    from image_to_pointcloud_tpu.models import SegformerMatte, segformer_b0
    from image_to_pointcloud_tpu.serve.matting import MatteModel as JMatte

    params = _draw(SegformerMatte(segformer_b0(num_labels=1)), (1, 64, 64, 3), seed=1)
    return JMatte(params, 1), state_dict_from_flax(params)


@pytest.mark.parametrize("mode", ["cuda", "cpu"])
def test_matte_prob_runs_exact_f32(matte_pair, scopes, monkeypatch, mode):
    """The matte is f32 on every device: on CUDA the scope, on the CPU not
    (no bf16 matte exists)."""
    ref, sd = matte_pair
    _fake_device(monkeypatch, mode)
    matte = tmatting.MatteModel(sd, 1, "cpu")
    assert matte.exact_f32 == (mode == "cuda")
    hook = matte.model.register_forward_hook(scopes.look)
    try:
        im = np.random.default_rng(1).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
        ours = matte.prob(im)
    finally:
        hook.remove()
    _assert_scoped(scopes, mode)
    assert ours.shape == (1, 512, 512) and ours.std() > 1e-3  # a varied map
    np.testing.assert_allclose(ours, np.asarray(ref._fn(ref._params, im)), atol=1e-5)


# ---------- the trainer: forward, loss and backward ----------


@pytest.fixture(scope="module")
def train_ref(metric64):
    """The metric model above as a trainer's, one batch, and the JAX
    trainer's loss on it at the initial weights (what its first
    ``train_step`` returns)."""
    from image_to_pointcloud_tpu.models import DepthAnything as JDA
    from image_to_pointcloud_tpu.train.trainer import TrainConfig as JTrainConfig
    from image_to_pointcloud_tpu.train.trainer import _loss_fn_for

    jcfg, params, model = metric64
    r = np.random.default_rng(3)
    x = r.normal(0, 1, (2, 56, 56, 3)).astype(np.float32)
    y = (r.random((2, 56, 56)) * 4 + 0.5).astype(np.float32)
    pred = jax.jit(JDA(jcfg).apply)({"params": params}, jnp.asarray(x))
    loss = _loss_fn_for(JTrainConfig(learning_rate=LR, loss="silog", grad_clip=CLIP))(
        pred, jnp.asarray(y), jnp.ones(y.shape, bool))
    return model.cfg, params, x, y, float(loss)


@pytest.mark.parametrize("mode", ["cuda", "cpu"])
def test_train_step_runs_exact_f32(train_ref, scopes, monkeypatch, mode):
    """The trainer's model is f32 on every device. Forward hooks on its
    modules (the mesh runs them slot by slot) and gradient hooks (the
    backward) all run inside the scope on CUDA."""
    cfg, params, x, y, ref_loss = train_ref
    _fake_device(monkeypatch, mode)
    tr = ttrainer.Trainer(cfg, state_dict_from_flax(params), "cpu",
                          ttrainer.TrainConfig(learning_rate=LR, loss="silog", grad_clip=CLIP))
    assert tr.exact_f32 == (mode == "cuda")
    for m in tr.model.modules():
        m.register_forward_hook(scopes.look)
    for p in tr.params:
        p.register_hook(lambda g: scopes.look() or g)
    loss = float(tr.train_step(x, y))
    assert len(scopes.seen) > len(tr.params)  # module forwards and every reached gradient
    _assert_scoped(scopes, mode)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    # predict (no grad) enters it too.
    scopes.entered.clear()
    scopes.seen.clear()
    depth = tr.predict(x)
    assert depth.shape == (2, 56, 56)
    _assert_scoped(scopes, mode)


def test_wants_exact_f32_is_f32_on_cuda():
    assert graph.wants_exact_f32(torch.device("cuda"), torch.float32)
    assert graph.wants_exact_f32("cuda:1", torch.float32)
    assert not graph.wants_exact_f32(torch.device("cuda"), torch.bfloat16)
    assert not graph.wants_exact_f32(torch.device("cpu"), torch.float32)
