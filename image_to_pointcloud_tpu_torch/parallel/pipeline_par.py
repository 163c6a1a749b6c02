"""Pipeline parallelism (PP): GPipe microbatching over a ``pipe`` mesh axis.

Counterpart of ``image_to_pointcloud_tpu/parallel/pipeline_par.py``. The
encoder's blocks are split into S contiguous stages, one per ``pipe``
slot, and M microbatches stream through the GPipe schedule: at tick t
(M + S − 1 ticks) stage s works on microbatch t − s, and its output moves
to slot s + 1 (``Tensor.to``: an asynchronous peer copy between GPUs, so
no stage waits on the host for another slot's result; the host enqueues
a whole tick before the next). The bubble ticks, where JAX computes and
masks, compute nothing here. Bubble fraction (S − 1)/(M + S − 1).

The DPT neck's tap layers are one per stage (``pipe`` must equal the
model's number of taps, 4): the last block of each quarter for DA-S/B and
BEiT (a stage's output is its tap), mid-stage for DA-Large's (4, 11, 17,
23) of 24 (:func:`make_tapped_stage_fn`). Embedding and neck run on each
data slot's first pipe slot; ``data`` composes as in JAX: each data slot
runs its own pipeline on its share of every microbatch.

Stage parameters are lists of the model's block modules (``tap``: the
block-local tap index), each stage placed on its pipe slot only
(:func:`build_stage_params`), so no slot holds the whole encoder.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch import nn

from image_to_pointcloud_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    Mesh,
    replicate,
    slot_grid,
    split_rows,
    visible_devices,
    without_blocks,
)

__all__ = [
    "PIPE_AXIS",
    "PipelinedModel",
    "build_beit_stage_params",
    "build_stage_params",
    "gpipe_apply",
    "make_pipe_mesh",
    "make_stage_fn",
    "make_stage_fn_apply",
    "make_tapped_stage_fn",
    "pipelined_depth_apply",
    "pipelined_dpt_classic_apply",
    "pipelined_zoedepth_apply",
    "stack_block_params",
    "stage_tap_indices",
]

PIPE_AXIS = "pipe"


def make_pipe_mesh(pipe: int, data: int | None = None, *, devices: Sequence | None = None) -> Mesh:
    """A (data, pipe) mesh; ``data`` fills the remaining devices.
    ``devices`` as :func:`~.sharding.make_mesh` takes them."""
    if devices is None:
        devices = visible_devices("cuda")
    if data is None:
        if len(devices) % pipe:
            raise ValueError(f"{len(devices)} devices do not split into pipe={pipe}")
        data = len(devices) // pipe
    return slot_grid(devices, {DATA_AXIS: data, PIPE_AXIS: pipe})


def stack_block_params(
    blocks: Sequence[nn.Module], num_layers: int, num_stages: int
) -> list[nn.ModuleList]:
    """The first ``num_layers`` blocks as ``num_stages`` contiguous stages."""
    if num_layers % num_stages:
        raise ValueError(f"{num_layers} layers do not split into {num_stages} stages")
    per = num_layers // num_stages
    return [nn.ModuleList(blocks[s * per : (s + 1) * per]) for s in range(num_stages)]


def make_stage_fn_apply(apply_fn: Callable) -> Callable:
    """Stage = ``apply_fn(block, h)`` over the stage's blocks; returns
    ``(y, y)``: the boundary activation doubles as the tap (DA-S/B, and
    BEiT, whose apply passes the patch grid)."""

    def stage_fn(stage, x):
        for blk in stage:
            x = apply_fn(blk, x)
        return x, x

    return stage_fn


def make_stage_fn() -> Callable:
    """:func:`make_stage_fn_apply` over blocks that take the tokens alone."""
    return make_stage_fn_apply(lambda blk, h: blk(h))


def stage_tap_indices(num_layers: int, num_stages: int, out_layers: Sequence[int]) -> list[int]:
    """Block-local tap offset within each equal stage. Requires exactly
    one tap layer per stage, ascending: stage s emits tap s, so sorting
    here would silently permute the neck's shallow→deep feature order."""
    per = num_layers // num_stages
    assert per * num_stages == num_layers, (num_layers, num_stages)
    assert len(out_layers) == num_stages, (out_layers, num_stages)
    assert tuple(out_layers) == tuple(sorted(out_layers)), (
        f"pipelined taps require ascending out_layers, got {out_layers}"
    )
    locals_ = []
    for s, layer in enumerate(out_layers):
        assert s * per <= layer < (s + 1) * per, (
            f"tap layer {layer} outside stage {s} of {num_stages}"
        )
        locals_.append(layer - s * per)
    return locals_


def make_tapped_stage_fn(apply_fn: Callable | None = None) -> Callable:
    """Stage over ``{"blocks": [...], "tap": i}``: runs the blocks and
    captures the activation after block-local index ``tap`` as its tap."""
    apply_fn = apply_fn or (lambda blk, h: blk(h))

    def stage_fn(stage, x):
        tap = None
        for i, blk in enumerate(stage["blocks"]):
            x = apply_fn(blk, x)
            if i == stage["tap"]:
                tap = x
        return x, tap

    return stage_fn


def _place_stage(stage: Any, device: torch.device) -> Any:
    detach = not torch.is_grad_enabled()
    if isinstance(stage, dict):
        return {**stage, "blocks": replicate(stage["blocks"], device, detach=detach)}
    return replicate(stage, device, detach=detach)


def gpipe_apply(
    mesh: Mesh,
    stage_fn: Callable,
    stacked_params: Sequence[Any],
    x: torch.Tensor,
    *,
    num_microbatches: int,
    axis: str = PIPE_AXIS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``x`` (B, ...) through S pipelined stages with M microbatches.

    ``stage_fn(stage_params, (mb, ...)) -> (boundary activation, tap)``;
    ``stacked_params`` holds one stage's params per ``axis`` slot.
    Returns ``(y, taps)`` on the mesh's first slot: y (B, ...) the last
    stage's output, taps (S, B, ...) every stage's tap (the neck's inputs,
    shallow→deep). With a ``data`` axis each microbatch's rows are split
    over the data slots, each running its own pipeline."""
    m = num_microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    n_stages = mesh.shape[axis]
    if len(stacked_params) != n_stages:
        raise ValueError(f"stage count {len(stacked_params)} != mesh {axis!r} size {n_stages}")
    dp = mesh.shape.get(DATA_AXIS, 1)
    mb = b // m
    if mb % dp:
        raise ValueError(f"microbatch of {mb} rows does not split over data={dp}")
    rows = mb // dp
    first = mesh.device()
    devs = [[mesh.device(**{DATA_AXIS: d, axis: s}) for s in range(n_stages)] for d in range(dp)]
    stages = [[_place_stage(p, dev) for p, dev in zip(stacked_params, row)] for row in devs]
    # Microbatch j's rows of data slot d: x[j·mb + d·rows : + rows].
    acts: dict = {}  # (d, j) -> the activation handed to the next stage
    outs, taps = {}, {}
    for t in range(m + n_stages - 1):
        for d in range(dp):
            for s in range(n_stages):
                j = t - s
                if not 0 <= j < m:
                    continue
                if s == 0:
                    inp = x[j * mb + d * rows : j * mb + (d + 1) * rows]
                else:
                    inp = acts.pop((d, j))
                out, tap = stage_fn(stages[d][s], inp.to(devs[d][s], non_blocking=True))
                taps[(s, j, d)] = tap
                if s == n_stages - 1:
                    outs[(j, d)] = out
                else:
                    acts[(d, j)] = out
    order = [(j, d) for j in range(m) for d in range(dp)]
    y = torch.cat([outs[k].to(first) for k in order])
    tap_all = torch.stack(
        [torch.cat([taps[(s, j, d)].to(first) for j, d in order]) for s in range(n_stages)]
    )
    return y, tap_all


# ---------- full-model pipelined forwards ----------


def _stack_blocks(blocks: Sequence[nn.Module], num_layers: int, s: int, mesh: Mesh | None):
    stacked = stack_block_params(blocks, num_layers, s)
    if mesh is None:
        return stacked
    return [replicate(st, mesh.device(**{PIPE_AXIS: i}), detach=True)
            for i, st in enumerate(stacked)]


def build_stage_params(cfg, model: nn.Module, *, mesh: Mesh | None = None) -> list[dict]:
    """A DepthAnything's or classic DPT's encoder blocks as per-stage GPipe
    params ``{"blocks": [...], "tap": i}``, built once at pipeline
    construction. With ``mesh``, stage s is placed on the first data
    slot's pipe slot s only."""
    s = len(cfg.backbone.out_layers)
    taps = stage_tap_indices(cfg.backbone.num_layers, s, cfg.backbone.out_layers)
    stacked = _stack_blocks(model.backbone.blocks, cfg.backbone.num_layers, s, mesh)
    return [{"blocks": b, "tap": t} for b, t in zip(stacked, taps)]


def build_beit_stage_params(cfg, model: nn.Module, *, mesh: Mesh | None = None) -> list:
    """ZoeDepth's BEiT blocks as GPipe stages. BEiT's taps are the stage
    boundaries (out_layers (6, 12, 18, 24) of 24), so no tap indices."""
    s = len(cfg.backbone.out_layers)
    num_layers = cfg.backbone.num_layers
    per = num_layers // s
    assert per * s == num_layers, (num_layers, s)
    expect = tuple((i + 1) * per for i in range(s))
    assert tuple(cfg.backbone.out_layers) == expect, (
        f"BEiT pipelining needs boundary taps {expect}, got {tuple(cfg.backbone.out_layers)}"
    )
    return _stack_blocks(model.backbone.blocks, num_layers, s, mesh)


def _pipelined(model, stage_fn, stage_params, pixels, mesh, num_microbatches):
    """Embed on the first slot, the encoder through :func:`gpipe_apply`,
    then the rest of the model (``model``'s blocks are not used: they may
    be pruned, see :func:`~.sharding.without_blocks`)."""
    x, grid = model.embed(pixels)
    _, taps = gpipe_apply(mesh, stage_fn(grid), stage_params, x,
                          num_microbatches=num_microbatches)
    return model.finish(list(taps), grid)


def pipelined_depth_apply(model, stage_params, pixels, mesh, *, num_microbatches: int):
    """DepthAnything forward with the encoder GPipe-pipelined over the
    mesh's ``pipe`` slots; ``stage_params`` from :func:`build_stage_params`;
    ``pixels`` (B, H, W, 3) normalized, on the mesh's first slot."""
    return _pipelined(model, lambda grid: make_tapped_stage_fn(), stage_params, pixels, mesh,
                      num_microbatches)


def pipelined_dpt_classic_apply(model, stage_params, pixels, mesh, *, num_microbatches: int):
    """Classic-DPT forward, the ViT encoder pipelined (the taps keep their
    CLS token for the readout projection); as :func:`pipelined_depth_apply`."""
    return _pipelined(model, lambda grid: make_tapped_stage_fn(), stage_params, pixels, mesh,
                      num_microbatches)


def pipelined_zoedepth_apply(model, stage_params, pixels, mesh, *, num_microbatches: int):
    """ZoeDepth forward, the BEiT encoder pipelined (each block given the
    patch grid and its slot's relative-position index); ``stage_params``
    from :func:`build_beit_stage_params`."""
    bb = model.backbone

    def stage_fn(grid):
        return make_stage_fn_apply(lambda blk, h: blk(h, *bb.block_args(grid, h.device)))

    return _pipelined(model, stage_fn, stage_params, pixels, mesh, num_microbatches)


class PipelinedModel(nn.Module):
    """A depth model of any family on a (data, pipe) mesh: each data slot
    runs the GPipe-pipelined forward on its rows (:meth:`forward_slot`),
    its stages on its pipe slots, the embedding and neck (the model without
    its blocks) on its first pipe slot. ``pipe`` must equal the model's
    number of taps."""

    def __init__(self, model: nn.Module, mesh: Mesh, *, num_microbatches: int = 4):
        super().__init__()
        from image_to_pointcloud_tpu_torch.models.dpt_classic import DPTClassicConfig
        from image_to_pointcloud_tpu_torch.models.zoedepth import ZoeDepthConfig

        cfg = model.cfg
        self.cfg = cfg
        self.mesh = mesh
        self.num_microbatches = int(num_microbatches)
        n_stages = len(cfg.backbone.out_layers)
        if mesh.shape[PIPE_AXIS] != n_stages:
            raise ValueError(
                f"pipe axis ({mesh.shape[PIPE_AXIS]}) must equal the model's stage count "
                f"({n_stages} DPT tap layers)"
            )
        if isinstance(cfg, ZoeDepthConfig):
            build, self._apply = build_beit_stage_params, pipelined_zoedepth_apply
        elif isinstance(cfg, DPTClassicConfig):
            build, self._apply = build_stage_params, pipelined_dpt_classic_apply
        else:
            build, self._apply = build_stage_params, pipelined_depth_apply
        trunk = without_blocks(model)
        self._rows = []
        for d in range(mesh.shape[DATA_AXIS]):
            row = Mesh(mesh.devices[d : d + 1], mesh.axis_names)
            self._rows.append((row, replicate(trunk, row.device(), detach=True),
                               build(cfg, model, mesh=row)))

    def forward_slot(self, d: int, pixels: torch.Tensor) -> torch.Tensor:
        """Data slot ``d``'s rows (on its first slot) → depth; the most
        microbatches up to ``num_microbatches`` that divide the rows."""
        row, trunk, stages = self._rows[d]
        b = pixels.shape[0]
        m = max(1, min(self.num_microbatches, b))
        while b % m:
            m -= 1
        return self._apply(trunk, stages, pixels, row, num_microbatches=m)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        first = self.mesh.device()
        return torch.cat([self.forward_slot(d, r).to(first)
                          for d, r in enumerate(split_rows(pixels, self.mesh))])
