"""Device mesh, the megatron TP rules, placement and the collectives: the
port's parallelism backbone.

Counterpart of ``image_to_pointcloud_tpu/parallel/sharding.py``. As there,
one process drives a grid of device slots (``jax.sharding.Mesh`` is one
process driving every local chip): a :class:`Mesh` is an array of
``torch.device`` slots with named axes, and the collectives are plain
functions over one tensor per slot. A slot may repeat a device, so one
GPU (or the CPU) runs every sharded path: ``make_mesh(data=2, model=2,
devices=[torch.device("cuda", 0)] * 4)``. ``torch.distributed`` is only
for what crosses processes (:func:`init_distributed`,
:func:`broadcast_json_from_host0`), where the JAX package uses
``jax.distributed``.

* **DP**: the batch's leading dim split over the ``data`` slots
  (:func:`batch_sharding`); each data slot runs the whole model on its rows.
* **TP**: megatron-style sharding of every encoder block over the
  ``model`` slots (:data:`_TP_RULES`, the JAX package's rules on the port's
  ``state_dict`` names; a torch ``Linear.weight`` is (out, in), so Flax's
  column-parallel ``P(None, "model")`` kernel is a split of the weight on
  dim 0 here and the row-parallel ``P("model", None)`` one on dim 1).
  :class:`MeshedModel` runs each block shard's heads and MLP columns on its
  slot and sums the row-parallel ``proj`` and ``fc2`` partials over the
  slots (:func:`row_parallel`) before the bias, the LayerScale and the
  residual: what GSPMD computes for those rules. The int8 layers reduce
  as XLA does: the activation scale's max over the whole row, then the
  int32 accumulators summed, then one epilogue, so the sharded int8 encoder
  equals the unsharded one bit for bit.
* ``seq`` slots replicate the model (the serving rules name no ``seq``
  dim); ``parallel/context.py`` shards attention over them.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import logging
import math
import re
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from image_to_pointcloud_tpu_torch.models.dinov2 import residual
from image_to_pointcloud_tpu_torch.models.quantize import (
    QuantLinear,
    activation_scale,
    quantize_with_scale,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "MeshedModel",
    "NamedSharding",
    "Sharded",
    "all_gather",
    "batch_sharding",
    "broadcast",
    "broadcast_json_from_host0",
    "captures_graphs",
    "device_put",
    "gather_params",
    "init_distributed",
    "make_mesh",
    "param_sharding_rules",
    "pmax",
    "ppermute",
    "psum",
    "replicate",
    "replicated",
    "row_parallel",
    "shard_params",
    "visible_devices",
]

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


class Mesh:
    """An array of device slots with named axes; ``shape`` maps each axis
    name to its size, in order, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d slot array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def index(self, **at: int) -> tuple[int, ...]:
        """The slot index with the named axes at ``at`` and the others at 0."""
        return tuple(at.get(a, 0) for a in self.axis_names)

    def device(self, **at: int) -> torch.device:
        return self.devices[self.index(**at)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def visible_devices(device: "str | torch.device" = "cuda") -> list[torch.device]:
    """Every visible device of ``device``'s type: each CUDA device, or the
    CPU (or the one device asked for by index, e.g. ``cuda:1``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        if dev.index is not None:
            return [dev]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` → ``cuda:<current>``: a slot names one device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def slot_grid(devices: Sequence, sizes: Mapping[str, int]) -> Mesh:
    """The first prod(sizes) of ``devices`` as a mesh with axes ``sizes``.
    More slots than devices raises (JAX's reshape fails there); fewer
    warns, as an explicit mesh that idles devices is almost always a
    misconfiguration."""
    devs = [_indexed(torch.device(d)) for d in devices]
    need = math.prod(sizes.values())
    spec = ", ".join(f"{k}={v}" for k, v in sizes.items())
    if need > len(devs):
        raise ValueError(
            f"mesh ({spec}) needs {need} slots: more slots than devices "
            f"({len(devs)} given)"
        )
    if need < len(devs):
        logger.warning("mesh (%s) uses %d of %d devices; %d idle", spec, need, len(devs),
                       len(devs) - need)
    arr = np.empty(need, dtype=object)
    arr[:] = devs[:need]
    return Mesh(arr.reshape(tuple(sizes.values())), tuple(sizes))


def captures_graphs(mesh: Mesh, *, one_device: bool = False) -> bool:
    """Whether a program over ``mesh`` replays CUDA graphs, from the mesh
    alone: every slot on CUDA, and the slots of each data slot (its
    ``model``, ``seq`` or ``pipe`` slots) on one device, so that a data
    slot's share of the work is one single-device graph (the meshed
    :class:`~..pipeline.graph.DepthPipeline`); with ``one_device``, every
    slot of the mesh on one device, so that the whole program is one graph
    (the meshed trainer, whose gradient sum over the data slots is inside
    its step). TP or GPipe across cards inside a data slot, and a trainer
    over several devices, keep their eager bodies; the CPU never captures."""
    if not all(d.type == "cuda" for d in mesh.devices.flat):
        return False
    if one_device or DATA_AXIS not in mesh.shape:
        return len(set(mesh.devices.flat)) == 1
    rows = np.moveaxis(mesh.devices, mesh.axis_names.index(DATA_AXIS), 0)
    return all(len(set(row.flat)) == 1 for row in rows)


def make_mesh(
    data: int | None = None,
    model: int = 1,
    seq: int = 1,
    *,
    devices: Sequence | None = None,
) -> Mesh:
    """A (data, model, seq) mesh; ``data`` fills the remaining devices.
    ``devices`` defaults to every visible CUDA device (raises without
    CUDA); a CPU caller passes its slots, e.g. ``[torch.device("cpu")] * n``."""
    if devices is None:
        devices = visible_devices("cuda")
    if data is None:
        if len(devices) % (model * seq):
            raise ValueError(f"{len(devices)} devices do not split into model={model} x seq={seq}")
        data = len(devices) // (model * seq)
    return slot_grid(devices, {DATA_AXIS: data, MODEL_AXIS: model, SEQ_AXIS: seq})


# (regex over a state_dict name) -> spec, one mesh axis (or None) per dim
# of the torch tensor. First match wins. The JAX package's rules, through
# models/bridge.py's names: a Linear's weight is the transposed kernel, so
# its spec is the kernel's reversed; weight_q / weight_scale (the int8
# layout, models/quantize.py) shard exactly as their float counterparts.
_TP_RULES: list[tuple[str, tuple]] = [
    # Attention q/k/v: column-parallel (shard heads on the output dim).
    (r"blocks\.\d+\.(q|k|v)\.weight(_q)?$", (MODEL_AXIS, None)),
    (r"blocks\.\d+\.(q|k|v)\.(bias|weight_scale)$", (MODEL_AXIS,)),
    # Attention output projection: row-parallel (shard the input dim).
    (r"blocks\.\d+\.proj\.weight(_q)?$", (None, MODEL_AXIS)),
    (r"blocks\.\d+\.proj\.(bias|weight_scale)$", (None,)),
    # MLP: column then row parallel.
    (r"blocks\.\d+\.mlp\.fc1\.weight(_q)?$", (MODEL_AXIS, None)),
    (r"blocks\.\d+\.mlp\.fc1\.(bias|weight_scale)$", (MODEL_AXIS,)),
    (r"blocks\.\d+\.mlp\.fc2\.weight(_q)?$", (None, MODEL_AXIS)),
    (r"blocks\.\d+\.mlp\.fc2\.(bias|weight_scale)$", (None,)),
    # BEiT (ZoeDepth's encoder): attention under .attn, the MLP at block
    # level; the (num_rel, heads) relative-position table splits on its
    # head dim with the head-sharded q/k/v, so each slot's bias is local.
    (r"blocks\.\d+\.attn\.(q|k|v)\.weight(_q)?$", (MODEL_AXIS, None)),
    (r"blocks\.\d+\.attn\.(q|k|v)\.(bias|weight_scale)$", (MODEL_AXIS,)),
    (r"blocks\.\d+\.attn\.proj\.weight(_q)?$", (None, MODEL_AXIS)),
    (r"blocks\.\d+\.attn\.proj\.(bias|weight_scale)$", (None,)),
    (r"blocks\.\d+\.attn\.rel_pos_table$", (None, MODEL_AXIS)),
    (r"blocks\.\d+\.fc1\.weight(_q)?$", (MODEL_AXIS, None)),
    (r"blocks\.\d+\.fc1\.(bias|weight_scale)$", (MODEL_AXIS,)),
    (r"blocks\.\d+\.fc2\.weight(_q)?$", (None, MODEL_AXIS)),
    (r"blocks\.\d+\.fc2\.(bias|weight_scale)$", (None,)),
]


def param_sharding_rules(name: str) -> tuple:
    """The spec of one ``state_dict`` entry (``backbone.blocks.0.q.weight``):
    a mesh axis or None per dim; ``()`` is replicated."""
    for pattern, spec in _TP_RULES:
        if re.search(pattern, name):
            return spec
    return ()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor goes on a mesh: ``spec`` names the mesh axis (or
    None) that splits each leading dim; the other axes replicate."""

    mesh: Mesh
    spec: tuple = ()


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """The leading (batch) dim split over ``data``, the rest replicated."""
    return NamedSharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


class Sharded:
    """A tensor placed on a mesh: ``shards`` holds each slot's tensor (an
    object array of the mesh's shape). Slots that hold the same piece on
    the same device share one tensor."""

    def __init__(self, sharding: NamedSharding, shards: np.ndarray):
        self.sharding = sharding
        self.shards = shards

    def slot(self, **at: int) -> torch.Tensor:
        return self.shards[self.sharding.mesh.index(**at)]

    def data_shards(self) -> list[torch.Tensor]:
        """The tensor of each ``data`` slot (the other axes at 0)."""
        mesh = self.sharding.mesh
        return [self.slot(**{DATA_AXIS: d}) for d in range(mesh.shape.get(DATA_AXIS, 1))]

    def gather(self, device: "torch.device | None" = None) -> torch.Tensor:
        """The whole tensor, assembled on ``device`` (default: the first
        slot's)."""
        mesh = self.sharding.mesh
        dev = device if device is not None else mesh.devices.flat[0]
        split = [(k, a) for k, a in enumerate(self.sharding.spec) if a is not None]

        def build(at: dict, rest: list) -> torch.Tensor:
            if not rest:
                return self.slot(**at).to(dev)
            dim, axis = rest[0]
            return torch.cat(
                [build({**at, axis: i}, rest[1:]) for i in range(mesh.shape[axis])], dim
            )

        return build({}, split)


def device_put(x: torch.Tensor, sharding: NamedSharding, *, non_blocking: bool = False) -> Sharded:
    """Place ``x`` on every slot of the sharding's mesh, each slot getting
    its piece of every split dim."""
    mesh, spec = sharding.mesh, sharding.spec
    for k, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in mesh.shape:
            raise ValueError(f"spec {spec} names axis {axis!r}, not in the mesh {mesh.shape}")
        if x.shape[k] % mesh.shape[axis]:
            raise ValueError(f"dim {k} of {tuple(x.shape)} does not split over "
                             f"{axis}={mesh.shape[axis]}")
    shards = np.empty(mesh.devices.shape, dtype=object)
    memo: dict = {}
    for idx in itertools.product(*(range(n) for n in mesh.devices.shape)):
        at = dict(zip(mesh.axis_names, idx))
        key = (mesh.devices[idx], tuple(at[a] if a else 0 for a in spec))
        if key not in memo:
            piece = x
            for k, axis in enumerate(spec):
                if axis is not None:
                    n = x.shape[k] // mesh.shape[axis]
                    piece = piece.narrow(k, at[axis] * n, n)
            piece = piece.to(mesh.devices[idx], non_blocking=non_blocking).contiguous()
            if piece.untyped_storage().nbytes() > piece.numel() * piece.element_size():
                piece = piece.clone()  # a view would keep all of ``x`` on the slot
            memo[key] = piece
        shards[idx] = memo[key]
    return Sharded(sharding, shards)


def shard_params(state_dict: Mapping[str, torch.Tensor], mesh: Mesh) -> dict[str, Sharded]:
    """Place a ``state_dict`` on the mesh by the TP rules."""
    return {
        name: device_put(t, NamedSharding(mesh, param_sharding_rules(name)))
        for name, t in state_dict.items()
    }


def gather_params(sharded: Mapping[str, Sharded], device=None) -> dict[str, torch.Tensor]:
    """The one-device ``state_dict`` of a placed one."""
    return {name: s.gather(device) for name, s in sharded.items()}


# ---------- collectives over one tensor per slot ----------


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]) -> list[torch.Tensor]:
    return [x.to(d, non_blocking=True) for d in devices]


def psum(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """All-reduce sum: the sum over the slots, on every slot. Summed once,
    in slot order, on the first slot, so every slot holds the same bits."""
    return broadcast(reduce_sum(xs, xs[0].device), [x.device for x in xs])


def reduce_sum(xs: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum over the slots, on ``device``, in slot order."""
    total = xs[0].to(device, non_blocking=True)
    for x in xs[1:]:
        total = total + x.to(device, non_blocking=True)
    return total


def pmax(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """All-reduce max."""
    top = xs[0]
    for x in xs[1:]:
        top = torch.maximum(top, x.to(top.device, non_blocking=True))
    return broadcast(top, [x.device for x in xs])


def all_gather(xs: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """Every slot's tensor concatenated along ``dim``, on every slot."""
    whole = torch.cat([x.to(xs[0].device, non_blocking=True) for x in xs], dim)
    return broadcast(whole, [x.device for x in xs])


def ppermute(xs: Sequence[torch.Tensor], shift: int = 1) -> list[torch.Tensor]:
    """Ring shift: slot i receives slot (i − shift)'s tensor."""
    n = len(xs)
    return [xs[(i - shift) % n].to(xs[i].device, non_blocking=True) for i in range(n)]


# ---------- modules on slots ----------


def replicate(module: nn.Module, device: torch.device, *, detach: bool) -> nn.Module:
    """``module`` on ``device``: the module itself if it is there already,
    else a shallow replica whose parameters and buffers are copies
    (``torch.nn.parallel.replicate``'s scheme). With ``detach=False`` the
    copies are differentiable, so gradients of a replica's forward sum into
    the original parameters."""
    first = next(itertools.chain(module.parameters(), module.buffers()), None)
    if first is None or first.device == torch.device(device):
        return module
    mods = list(module.modules())
    reps = {id(m): m._replicate_for_data_parallel() for m in mods}
    for m in mods:
        r = reps[id(m)]
        for name, child in m._modules.items():
            r._modules[name] = None if child is None else reps[id(child)]
        for name, p in m._parameters.items():
            if p is not None:
                t = p.to(device)
                setattr(r, name, t.detach() if detach else t)
        for name, b in m._buffers.items():
            r._buffers[name] = None if b is None else b.to(device)
    return reps[id(module)]


def without_blocks(model: nn.Module) -> nn.Module:
    """A shallow copy of ``model`` whose backbone has no blocks (the same
    parameter objects otherwise): the part that the meshed runners
    replicate, the blocks being placed by them."""
    trunk = copy.copy(model)
    trunk._modules = dict(model._modules)
    bb = copy.copy(model.backbone)
    bb._modules = dict(bb._modules)
    bb._modules["blocks"] = nn.ModuleList()
    trunk._modules["backbone"] = bb
    return trunk


def row_parallel(layers: Sequence[nn.Module], xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """A row-parallel product: slot m holds ``layers[m]`` (its columns of
    the weight) and ``xs[m]`` (its features of the input); the output, on
    the first slot, is the unsharded layer's. Float: the partial products
    summed in f32, then the bias, one rounding to the input dtype. int8:
    the activation scale from the max over every slot's features, the
    int32 accumulators summed, then one epilogue (bit for bit the
    unsharded :class:`QuantLinear`)."""
    first = layers[0]
    dev = xs[0].device
    if isinstance(first, QuantLinear):
        scales = [activation_scale(m)
                  for m in pmax([x.float().abs().amax(dim=-1, keepdim=True) for x in xs])]
        acc = reduce_sum([lay.accumulate(quantize_with_scale(x, s))
                          for lay, x, s in zip(layers, xs, scales)], dev)
        return first.epilogue(acc, scales[0], xs[0].dtype)
    part = reduce_sum([F.linear(x, lay.weight).float() for lay, x in zip(layers, xs)], dev)
    return (part if first.bias is None else part + first.bias.float()).to(xs[0].dtype)


def tp_block(blocks: Sequence[nn.Module], x: torch.Tensor, args: Sequence[tuple]) -> torch.Tensor:
    """One encoder block over the model slots: ``blocks[m]`` is slot m's
    shard and ``args[m]`` the block's extra arguments there (BEiT's grid
    and index); ``x`` lives on the first slot. The norms, the bias, the
    LayerScale and the residual (the replicated parameters) run there,
    on slot 0's copies; the column-parallel halves on every slot, on the
    broadcast norm output; the row-parallel products reduce to the first
    slot. A lone slot runs the block's own forward."""
    b0 = blocks[0]
    if len(blocks) == 1:
        return b0(x, *args[0])
    devs = [b.norm1.weight.device for b in blocks]
    hs = broadcast(b0.norm1(x), devs)
    a = [b.attend(h, *arg) for b, h, arg in zip(blocks, hs, args)]
    x = residual(x, row_parallel([b.attn_out for b in blocks], a), b0.ls1)
    hs = broadcast(b0.norm2(x), devs)
    h = [b.mlp_hidden(hm) for b, hm in zip(blocks, hs)]
    return residual(x, row_parallel([b.mlp_out for b in blocks], h), b0.ls2)


def tp_shards(model: nn.Module, mesh: Mesh) -> list[nn.ModuleList]:
    """The encoder blocks of ``model`` as one :class:`~torch.nn.ModuleList`
    per model slot of data slot 0: each block built with ``tp=model``
    (local heads and MLP width) and holding that slot's pieces, placed by
    :func:`shard_params`."""
    tp = mesh.shape[MODEL_AXIS]
    blocks = model.backbone.blocks
    sd = {f"backbone.blocks.{k}": v for k, v in blocks.state_dict().items()}
    placed = shard_params(sd, Mesh(mesh.devices[:1, :, :1], mesh.axis_names))
    out = []
    for m in range(tp):
        shard = nn.ModuleList()
        for i, blk in enumerate(blocks):
            with torch.device("meta"):
                local = type(blk)(model.backbone.cfg, tp=tp)
            pre = f"backbone.blocks.{i}."
            local.load_state_dict(
                {n[len(pre):]: s.slot(**{MODEL_AXIS: m})
                 for n, s in placed.items() if n.startswith(pre)},
                strict=True, assign=True,
            )
            if m:  # slot 0's copies of the replicated parameters are the ones used
                for n, p in local.named_parameters():
                    if MODEL_AXIS not in param_sharding_rules(pre + n):
                        p.requires_grad_(False)
            shard.append(local.train(blk.training))
        out.append(shard)
    return out


class MeshedModel(nn.Module):
    """A depth model of any family on a (data, model, seq) mesh.

    The encoder blocks are megatron-sharded over the ``model`` slots
    (:func:`tp_shards`; with ``model=1`` the model's own blocks), the rest
    (embedding, neck, head) is replicated; each ``data`` slot runs the
    whole model on its rows (:meth:`forward_slot`), on its slots. The
    parameters exist once per model slot, on data slot 0's slots: the other
    data slots read them through copies (:func:`replicate`), made once
    (``live=False``, inference) or at each forward and differentiable
    (``live=True``, the trainer: gradients sum into the one tensor).

    ``model`` is taken over, best from the CPU: its trunk (and, with
    ``model=1``, its blocks) moves to the first slot in place, as
    ``Module.to`` moves it; with ``model`` > 1 each slot gets a copy of its
    own pieces of the blocks only, so no slot holds the whole encoder once
    the caller drops ``model``.

    Under CUDA graphs (:func:`captures_graphs`): a meshed pipeline captures
    :meth:`forward_slot` once per data slot, on that slot's one device,
    where every data slot's slots are one device; the trainer captures its
    whole step where every slot is one device. Data slot d's replicas
    (``live=False``) are built by its first forward, which is the capture's
    eager warm-up pass, never the capture itself. A data slot over several
    devices runs eagerly."""

    def __init__(self, model: nn.Module, mesh: Mesh, *, live: bool = False):
        super().__init__()
        if MODEL_AXIS not in mesh.shape or DATA_AXIS not in mesh.shape:
            raise ValueError(f"MeshedModel needs a (data, model, seq) mesh, got {mesh.shape}")
        self.cfg = model.cfg
        self.mesh = mesh
        self.live = live
        first = mesh.device()
        if mesh.shape[MODEL_AXIS] == 1:
            self.shards = nn.ModuleList([model.to(first).backbone.blocks])
        else:
            self.shards = nn.ModuleList(tp_shards(model, mesh))
        self.trunk = without_blocks(model).to(first)
        self._replicas: dict[int, tuple] = {}

    def _slot_modules(self, d: int) -> tuple[nn.Module, list[nn.Module]]:
        if d == 0:
            return self.trunk, list(self.shards)
        if d in self._replicas:
            return self._replicas[d]
        mesh = self.mesh
        trunk = replicate(self.trunk, mesh.device(data=d), detach=not self.live)
        shards = [replicate(s, mesh.device(data=d, model=m), detach=not self.live)
                  for m, s in enumerate(self.shards)]
        if not self.live:
            self._replicas[d] = (trunk, shards)
        return trunk, shards

    def forward_slot(self, d: int, pixels: torch.Tensor) -> torch.Tensor:
        """Data slot ``d``'s rows (on its first slot's device) → depth."""
        trunk, shards = self._slot_modules(d)
        bb = trunk.backbone
        devs = [self.mesh.device(data=d, model=m) for m in range(len(shards))]
        x, grid = trunk.embed(pixels)
        args = [bb.block_args(grid, dev) for dev in devs]
        remat = getattr(bb.cfg, "remat_blocks", False) and torch.is_grad_enabled()
        want = set(bb.tap_blocks)
        taps = {}
        for i in range(len(shards[0])):
            blocks = [s[i] for s in shards]
            if remat:
                x = checkpoint(tp_block, blocks, x, args, use_reentrant=False)
            else:
                x = tp_block(blocks, x, args)
            if i in want:
                taps[i] = x
        return trunk.finish([taps[i] for i in bb.tap_blocks], grid)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """The whole batch: its rows split over the data slots, the depth
        gathered on the first slot."""
        rows = split_rows(pixels, self.mesh)
        first = self.mesh.device()
        return torch.cat([self.forward_slot(d, r).to(first) for d, r in enumerate(rows)])

    def gathered_state_dict(self) -> dict[str, torch.Tensor]:
        """The one-device ``state_dict`` (the model's names and layout):
        each block's shards concatenated back along their split dims."""
        out = {k: v for k, v in self.trunk.state_dict().items()}
        for i in range(len(self.shards[0])):
            pieces = [s[i].state_dict() for s in self.shards]
            for n in pieces[0]:
                name = f"backbone.blocks.{i}.{n}"
                spec = param_sharding_rules(name) if len(pieces) > 1 else ()
                if MODEL_AXIS in spec:
                    dim = spec.index(MODEL_AXIS)
                    out[name] = torch.cat([p[n].to(pieces[0][n].device) for p in pieces], dim)
                else:
                    out[name] = pieces[0][n]
        return out


def split_rows(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """``x``'s rows split over the data slots, each on its slot's device."""
    return device_put(x, batch_sharding(mesh, x.dim())).data_shards()


# ---------- across processes ----------


def init_distributed(*, device: "str | torch.device" = "cuda", **kwargs) -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group``
    with NCCL for CUDA (the default ``device``, which raises where CUDA is
    not available) and gloo only when the caller asks for the CPU
    (``device="cpu"``). Nothing tells a process of its cluster: pass
    ``init_method`` (``tcp://<host>:<port>``), ``world_size`` and
    ``rank``."""
    import torch.distributed as dist

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_distributed: device 'cuda' requested but CUDA is not available "
            "(pass device='cpu' for gloo on the CPU)"
        )
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend=kwargs.pop("backend", backend), **kwargs)


def broadcast_json_from_host0(obj: Any = None, *, max_bytes: int = 65536) -> Any:
    """Replicate a JSON-serializable value from process 0 to every process.

    The multi-host serving design keeps the job registry authoritative on
    process 0 and broadcasts updates as fixed-size frames: a 4-byte
    little-endian length, then the UTF-8 JSON, padded to ``max_bytes`` so
    every process contributes an identically shaped u8 tensor to
    ``dist.broadcast``. Other processes pass ``obj=None``."""
    import torch.distributed as dist

    buf = torch.zeros(max_bytes, dtype=torch.uint8)
    if dist.get_rank() == 0:
        raw = json.dumps(obj).encode()
        if len(raw) > max_bytes - 4:
            raise ValueError(f"payload {len(raw)}B exceeds frame {max_bytes}B")
        frame = len(raw).to_bytes(4, "little") + raw
        buf[: len(frame)] = torch.frombuffer(bytearray(frame), dtype=torch.uint8)
    if dist.get_backend() == "nccl":
        buf = buf.cuda()
    dist.broadcast(buf, src=0)
    out = buf.cpu().numpy()
    n = int.from_bytes(out[:4].tobytes(), "little")
    return json.loads(out[4 : 4 + n].tobytes().decode())
