"""The meshed pipeline's and the meshed trainer's CUDA graphs, on the CPU.

On CUDA a meshed ``DepthPipeline`` captures one graph per signature and
data slot, each on its slot's device, wherever every data slot's slots
are one device, and a meshed ``Trainer`` one graph a step wherever every
slot is one device (``tests/test_torch_cuda.py`` holds the replays
against their eager bodies on the card). On the CPU the same callables
run eagerly. Checked here:

* the rule (``parallel.sharding.captures_graphs``) from the mesh alone,
  on meshes of ``torch.device`` slots: one-card CUDA meshes capture, DP
  over two cards captures per data slot but keeps the trainer eager, TP
  and GPipe across cards inside a data slot stay eager, the CPU never
  captures;
* on a (data=2, model=2) and a (data=2) CPU mesh: the signature keys
  equal the JAX meshed pipeline's after the same calls (a lone request
  padded to the data slots shares batch 2's key; 3 pads to 4), and the results of the
  same payload agree with JAX's within PARITY.md's slice tolerance
  (``tests/test_torch_graph.py``'s rule);
* the per-slot callables (each taking its slot's rows of the payload, cut
  on the host) gathered equal ``_run_slots`` on the same rows and the
  signature's eager body, byte for byte, on both ingests; a one-slot mesh
  keeps one callable a signature;
* the trainer on a (data=2, model=2) mesh: a capture's warm-up pass is
  undone bit for bit on every parameter of every model slot, and a placed
  batch gathered for the graph splits back into the rows it came in.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from image_to_pointcloud_tpu.pipeline import graph as jgraph
from image_to_pointcloud_tpu_torch.parallel import sharding as ts
from image_to_pointcloud_tpu_torch.parallel.pipeline_par import make_pipe_mesh
from image_to_pointcloud_tpu_torch.pipeline import graph
from test_torch_graph import _assert_slice_agrees, _images, _jpeg, _normal_key, _plans
from test_torch_parallel import CPU, cpu_mesh

CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)

# (mesh, captures per data slot, captures as one graph: the trainer's rule).
RULE_CASES = {
    "one slot": (lambda: ts.make_mesh(data=1, devices=[CUDA0]), True, True),
    "data=2,model=2 on one card": (
        lambda: ts.make_mesh(data=2, model=2, devices=[CUDA0] * 4), True, True),
    "pipe=4 on one card": (lambda: make_pipe_mesh(4, data=1, devices=[CUDA0] * 4), True, True),
    "DP over two cards": (lambda: ts.make_mesh(data=2, devices=[CUDA0, CUDA1]), True, False),
    "TP on each card, DP over two": (
        lambda: ts.make_mesh(data=2, model=2, devices=[CUDA0, CUDA0, CUDA1, CUDA1]), True, False),
    "TP across cards": (lambda: ts.make_mesh(data=1, model=2, devices=[CUDA0, CUDA1]), False, False),
    "GPipe across cards": (
        lambda: make_pipe_mesh(4, data=1, devices=[CUDA0, CUDA1] * 2), False, False),
    "CPU": (lambda: cpu_mesh(data=2, model=2), False, False),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_capture_rule_from_the_mesh(case):
    build, per_slot, whole = RULE_CASES[case]
    mesh = build()
    assert ts.captures_graphs(mesh) is per_slot
    assert ts.captures_graphs(mesh, one_device=True) is whole


@pytest.fixture(scope="module")
def da_pair():
    from test_torch_graph import _bridged
    from test_torch_model import _tiny_kwargs

    from image_to_pointcloud_tpu import models as jm
    from image_to_pointcloud_tpu.models.dinov2 import DinoV2Config as JBackbone
    from image_to_pointcloud_tpu.models.dpt import DPTConfig as JNeck
    from image_to_pointcloud_tpu_torch.models.depth_anything import DepthAnythingConfig
    from image_to_pointcloud_tpu_torch.models.dinov2 import DinoV2Config
    from image_to_pointcloud_tpu_torch.models.dpt import DPTConfig

    bb, nk = _tiny_kwargs(layers=2, out_layers=(0, 1, 1, 1))
    return _bridged(jm.DepthAnythingConfig(backbone=JBackbone(**bb), neck=JNeck(**nk)),
                    DepthAnythingConfig(backbone=DinoV2Config(**bb), neck=DPTConfig(**nk)),
                    (56, 56))


MESHES = {"data=2,model=2": 2, "data=2": 1}  # model slots
# The batches each mesh's check submits, and the batches of the keys they
# leave (one JAX compile a key: the CPU suite's time).
CALLS = {"data=2,model=2": ((1, 2), [2]), "data=2": ((3,), [4])}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_meshed_signatures_match_jax(da_pair, mesh):
    """Batches through both meshed pipelines (a lone request and a pair;
    three): the keys after the calls are JAX's (1 and 2 share batch 2's,
    3 pads to 4), and each result agrees with JAX's within the slice
    tolerance."""
    import jax

    from image_to_pointcloud_tpu.parallel.sharding import make_mesh as jmake_mesh

    jcfg, params, model = da_pair
    m = MESHES[mesh]
    jpipe = jgraph.DepthPipeline(jcfg, params, model_target=56,
                                 mesh=jmake_mesh(data=2, model=m, devices=jax.devices()[:2 * m]))
    pipe = graph.DepthPipeline(model, model_target=56, mesh=cpu_mesh(data=2, model=m))
    assert not pipe.cuda_graphs and pipe.device == CPU
    imgs, scales = _images(6, 3), np.array([15.0, 4.0, 9.5], np.float32)
    batches, key_batches = CALLS[mesh]
    for n in batches:
        ref = jpipe.run_batch(imgs[:n], depth_scales=scales[:n], options=jgraph.PipelineOptions())
        got = pipe.run_batch(imgs[:n], depth_scales=scales[:n], options=graph.PipelineOptions())
        assert len(got) == len(ref) == n
        for a, b in zip(ref, got):
            _assert_slice_agrees(a, b)
    keys = {_normal_key(k) for k in pipe._compiled}
    assert keys == {_normal_key(k) for k in jpipe._compiled}
    assert sorted(k[1] for k in keys) == key_batches


@pytest.mark.parametrize("mesh", list(MESHES))
def test_slot_callables_equal_run_slots(da_pair, mesh):
    """A signature of two data slots is one callable a slot: each takes
    its rows of the payload (cut on the host), and the gathered outputs
    equal ``_run_slots`` on the same rows and the signature's eager body,
    byte for byte; the JPEG ingest's sparse payload the same."""
    model = da_pair[2]
    pipe = graph.DepthPipeline(model, model_target=56, mesh=cpu_mesh(data=2, model=MESHES[mesh]),
                               quantized_transfer=True)
    imgs, scales = _images(7, 4), np.array([15.0, 4.0, 9.5, 2.0], np.float32)
    opts = graph.PipelineOptions(density="high")
    fn = pipe.compiled_graph(4, (37, 29), opts, True)
    assert isinstance(fn, graph._SlotGraphs) and [s.device for s in fn.slots] == [CPU, CPU]
    payload = pipe.pack_payload(imgs, scales)
    out, prev = fn(payload)
    ref, ref_prev = pipe._run_slots(
        lambda d, dev: (torch.from_numpy(imgs[2 * d : 2 * d + 2]).float(),
                        torch.from_numpy(scales[2 * d : 2 * d + 2])),
        (37, 29), opts, True)
    body, body_prev = fn.run(torch.from_numpy(payload))
    assert out.dtype == torch.uint8 and out.shape[0] == 4
    assert torch.equal(out, ref) and torch.equal(prev, ref_prev)
    assert torch.equal(out, body) and torch.equal(prev, body_prev)

    jpeg = _plans(_jpeg(8))[1]
    caps = pipe.select_sparse_caps([jpeg, jpeg])
    assert caps is not None
    fnj = pipe.compiled_graph_jpeg(2, jpeg.spec, graph.PipelineOptions(), True, sparse_cap=caps)
    payload = pipe.pack_jpeg_sparse_payload([jpeg, jpeg], np.array([15.0, 7.0], np.float32), *caps)
    got, body = fnj(payload), fnj.run(torch.from_numpy(payload))
    assert isinstance(fnj, graph._SlotGraphs)
    assert torch.equal(got[0], body[0]) and torch.equal(got[1], body[1])


def test_one_data_slot_keeps_one_callable(da_pair):
    """A mesh of one data slot (TP over two model slots) keeps one callable
    a signature, as a pipeline without a mesh does."""
    pipe = graph.DepthPipeline(da_pair[2], model_target=56, mesh=cpu_mesh(data=1, model=2))
    fn = pipe.compiled_graph(1, (37, 29), graph.PipelineOptions(), True)
    assert isinstance(fn, graph._CompiledGraph) and fn.device == CPU


@pytest.fixture(scope="module")
def tp_trainer(da_pair):
    from image_to_pointcloud_tpu_torch.train.trainer import TrainConfig, Trainer

    model = da_pair[2]
    return Trainer(model.cfg, model.state_dict(), "cpu", TrainConfig(learning_rate=1e-3),
                   mesh=cpu_mesh(data=2, model=2))


def _batch(seed: int = 4):
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.normal(0, 1, (2, 56, 56, 3)).astype(np.float32)),
            torch.from_numpy((r.random((2, 56, 56)) + 0.5).astype(np.float32)))


def test_meshed_warm_up_is_undone_on_every_model_slot(tp_trainer):
    """A capture's warm-up pass (a real step) on a (data=2, model=2) mesh
    leaves every parameter of every model slot (the sharded blocks, the
    model slots' copies of the replicated ones) and AdamW's state as they
    were, bit for bit; from a running state too."""
    tr = tp_trainer
    assert not tr.cuda_graphs and tr.model is None
    x, y = _batch()
    mask = torch.ones(y.shape, dtype=torch.bool)
    tr.train_step(x, y)
    for _ in range(2):
        params = [p.detach().clone() for p in tr.net.parameters()]
        moments = [v.clone() for st in tr.opt.state.values() for v in st.values()]
        with tr._warm_up():
            tr._step(x, y, mask)
        assert all(torch.equal(p, s) for p, s in zip(tr.net.parameters(), params))
        assert all(torch.equal(v, m) for v, m in zip(
            (v for st in tr.opt.state.values() for v in st.values()), moments))
        assert all(p.grad is None for p in tr.params)


def test_gathered_batch_splits_into_its_rows(tp_trainer):
    """A placed batch gathered into the graph's one input (as
    ``train_step`` gathers it under graphs) gives each data slot the rows
    it was placed with: the prediction equals the placed batch's, bit for
    bit."""
    tr = tp_trainer
    x, _ = _batch(5)
    placed = ts.device_put(x, ts.batch_sharding(tr.mesh, 4))
    assert torch.equal(tr.predict(placed.gather(tr.device)), tr.predict(placed))
