"""Sequence (context) parallelism for long ViT patch sequences.

Counterpart of ``image_to_pointcloud_tpu/parallel/context.py``, whose
functions are ``jnp`` under ``shard_map`` (no Pallas kernel); here they
are torch ops over the ``seq`` slots of a mesh (``parallel/sharding.py``).
Queries, keys and values come in as one (B, H, N/seq, D) tensor per
``seq`` slot, the sequence split in slot order, and go out the same way:

* :func:`sequence_sharded_attention`: K and V all-gathered over the slots,
  then each slot attends with its own queries (exact; memory for the whole
  K/V, compute and activations ∝ 1/seq);
* :func:`ring_attention`: an f32 online softmax over ``seq`` steps, K and
  V shifted one slot around the ring each step (memory and traffic per
  step ∝ 1/seq).

The JAX package calls neither from a serving path: they are library
functions, as here.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from image_to_pointcloud_tpu_torch.parallel.sharding import (
    SEQ_AXIS,
    Mesh,
    all_gather,
    ppermute,
)

__all__ = ["ring_attention", "sequence_sharded_attention"]


def _check(mesh: Mesh, axis: str, qs: Sequence[torch.Tensor]) -> None:
    devs = [mesh.device(**{axis: i}) for i in range(mesh.shape[axis])]
    if len(qs) != len(devs) or any(q.device != d for q, d in zip(qs, devs)):
        raise ValueError(f"one tensor per {axis!r} slot, on its device: "
                         f"{[str(q.device) for q in qs]} for {[str(d) for d in devs]}")


def _local_attention(q, k, v, scale):
    """``_local_attention``'s math: f32 logits, an f32 softmax, the
    probabilities rounded to V's dtype, P·V accumulated in f32."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits * scale, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float())


def sequence_sharded_attention(
    qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
    mesh: Mesh, axis: str = SEQ_AXIS,
) -> list[torch.Tensor]:
    """(B, H, N/seq, D) per ``axis`` slot → the same, attention over the
    whole sequence."""
    _check(mesh, axis, qs)
    scale = 1.0 / math.sqrt(qs[0].shape[-1])
    kg, vg = all_gather(ks, dim=2), all_gather(vs, dim=2)
    return [_local_attention(q, k, v, scale).to(q.dtype) for q, k, v in zip(qs, kg, vg)]


def ring_attention(
    qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
    mesh: Mesh, axis: str = SEQ_AXIS,
) -> list[torch.Tensor]:
    """Ring-rotated exact attention with an online softmax: each step every
    slot attends its queries to the K/V block it holds, then the blocks
    move one slot around the ring. All slots' work of a step is enqueued
    before the shift, so slots on distinct GPUs compute together."""
    _check(mesh, axis, qs)
    scale = 1.0 / math.sqrt(qs[0].shape[-1])
    qf = [q.float() * scale for q in qs]
    m = [torch.full((*q.shape[:-1], 1), -torch.inf, device=q.device) for q in qs]
    l = [torch.zeros((*q.shape[:-1], 1), device=q.device) for q in qs]
    acc = [torch.zeros(q.shape, device=q.device) for q in qs]
    kc, vc = list(ks), list(vs)
    for step in range(len(qs)):
        for i in range(len(qs)):
            s = torch.matmul(qf[i], kc[i].float().transpose(-1, -2))
            m_new = torch.maximum(m[i], s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m[i] - m_new)
            l[i] = l[i] * corr + p.sum(dim=-1, keepdim=True)
            acc[i] = acc[i] * corr + torch.matmul(p, vc[i].float())
            m[i] = m_new
        if step < len(qs) - 1:
            kc, vc = ppermute(kc), ppermute(vc)
    return [(a / li).to(q.dtype) for a, li, q in zip(acc, l, qs)]
