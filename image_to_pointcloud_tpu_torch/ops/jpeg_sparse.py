"""Sparse packing of entropy-decoded JPEG coefficients for the hybrid
ingest's host→device payload, and its device-side scatter.

Counterpart of ``image_to_pointcloud_tpu/ops/jpeg_sparse.py``. The host
half (layout, buckets, :func:`block_pack`) is a numpy copy; the pack's
hot loop is ``native.jpeg_sparse_pack``, reused. The device half,
:func:`scatter_from_blocks`, is torch.

Quantized DCT coefficients are mostly zero. The payload ships, per
image:

- one uint8 **count** per 8x8 block (AC nonzeros in that block),
- one int16 **DC** per block, dense,
- one uint8 **position** (row-major index within the k x k truncated
  block, 1..k^2-1) and one int8 **value** per AC nonzero,
- an **exception** side channel ((int32 slot, int16 value) pairs) for the
  rare AC values outside int8 range.

The JAX package's alternative gather formulation (``gather_from_blocks``)
was measured and rejected on the TPU and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "block_pack",
    "capacity_bucket",
    "coeff_layout",
    "exception_bucket",
    "scatter_from_blocks",
    "sparse_payload_bytes",
    "sparse_row_sections",
]

_MIN_CAPACITY = 1024
_MIN_EXC_CAPACITY = 16

# Section alignment of the sparse payload row (bytes): every section
# starts aligned, so every multi-byte view of it is width-aligned.
_ROW_ALIGN = 512


def sparse_row_sections(
    spec, cap: int, exc_cap: int
) -> tuple[dict[str, tuple[int, int]], int]:
    """Byte layout of one split-sparse payload row: name → (offset,
    size), plus the total row size. The one definition that the host
    writer (``DepthPipeline.pack_jpeg_sparse_payload``) and the device
    reader (``pipeline.graph._unpack_jpeg_sparse_fields``) share. Wide
    fields ship as separate byte planes (``dc_lo``/``dc_hi``)."""
    k2 = spec.k * spec.k
    _, total = coeff_layout(spec)
    nblocks = total // k2
    order = [
        ("counts", nblocks),  # u8 AC count per block
        ("dc_lo", nblocks),  # low byte of the dense i16 DC plane
        ("dc_hi", nblocks),  # high (signed) byte of the DC plane
        ("pos", cap),  # u8 in-block AC position per slot
        ("val", cap),  # i8 AC value per slot
        ("exc_idx", 4 * exc_cap),  # i32 LE exception slots
        ("exc_val", 2 * exc_cap),  # i16 LE exception values
        ("qt", spec.ncomp * 64 * 4),  # f32 natural-order quant tables
        ("scale", 4),  # f32 per-image depth scale
    ]
    sections: dict[str, tuple[int, int]] = {}
    off = 0
    for name, size in order:
        off = -(-off // _ROW_ALIGN) * _ROW_ALIGN
        sections[name] = (off, size)
        off += size
    return sections, off


def coeff_layout(spec) -> tuple[tuple[int, ...], int]:
    """Per-component flattened coefficient counts (BH*BW*k*k) and their
    sum: the shared flat index space of the sparse encoding."""
    k = spec.k
    sizes = []
    for c in range(spec.ncomp):
        bh, bw = spec.block_grid(c)
        sizes.append(bh * bw * k * k)
    return tuple(sizes), int(sum(sizes))


def block_pack(
    coeffs: "list[np.ndarray]",
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Truncated host coefficients (per-component (BH, BW, k, k) int16) →
    (counts u8, dc i16, pos u8, val i8, exc_idx i32, exc_val i16).

    Blocks number consecutively across components; DC ships dense in
    ``dc``; AC positions are row-major within each k x k block; AC
    nonzeros appear in flat-index order. ``val`` holds the wrapped int8
    image of each AC value; entries outside int8 range are listed in
    (exc_idx, exc_val) and overwrite the wrapped byte on the device. The
    native one-pass pack runs when the library is available, else
    :func:`_block_pack_numpy`."""
    from image_to_pointcloud_tpu_torch import native

    packed = native.jpeg_sparse_pack(coeffs)
    if packed is not None:
        return packed
    return _block_pack_numpy(coeffs)


def _block_pack_numpy(
    coeffs: "list[np.ndarray]",
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pure-numpy implementation of :func:`block_pack`."""
    counts = []
    dcs = []
    poss = []
    vals = []
    for c in coeffs:
        k2 = c.shape[2] * c.shape[3]
        flat = np.ascontiguousarray(c, np.int16).reshape(-1, k2)
        dcs.append(flat[:, 0])
        if k2 == 1:  # k=1 blocks are DC-only
            counts.append(np.zeros(flat.shape[0], np.uint8))
            continue
        ac = flat[:, 1:]
        nz = np.flatnonzero(ac)
        counts.append(np.count_nonzero(ac, axis=1).astype(np.uint8))
        poss.append((nz % (k2 - 1) + 1).astype(np.uint8))
        vals.append(ac.reshape(-1)[nz])
    val = (np.concatenate(vals) if vals else np.zeros(0, np.int16)).astype(np.int16, copy=False)
    wide = np.flatnonzero((val < -128) | (val > 127))
    return (
        np.concatenate(counts),
        np.concatenate(dcs).astype(np.int16, copy=False),
        (np.concatenate(poss) if poss else np.zeros(0, np.uint8)),
        val.astype(np.int8),  # wraps wide entries; exceptions overwrite
        wide.astype(np.int32),
        val[wide],
    )


def capacity_bucket(nnz: int, total: int) -> int:
    """Padding bucket for an AC nonzero count: powers of two with a
    midpoint step up to 16384, then the next multiple of 8192; capped at
    the dense size."""
    if nnz > 16384:
        return min(-(-nnz // 8192) * 8192, total)
    cap = _MIN_CAPACITY
    while cap < nnz:
        if cap + cap // 2 >= nnz:
            cap += cap // 2
            break
        cap *= 2
    return min(cap, total)


def exception_bucket(nexc: int) -> int:
    """Padding bucket for the exception side channel: x4 steps from a
    16-entry floor."""
    cap = _MIN_EXC_CAPACITY
    while cap < nexc:
        cap *= 4
    return cap


def sparse_payload_bytes(nnz_ac: int, nexc: int, total: int, block: int = 64) -> int:
    """Payload bytes per image for a split sparse row at the given
    buckets: u8 position + i8 value per AC slot, u8 count + i16 DC per
    block, 6 bytes per exception slot (quant tables and scale excluded;
    the dense layout ships them too). ``block`` is k*k."""
    return (
        2 * capacity_bucket(nnz_ac, total)
        + 3 * (total // block)
        + 6 * exception_bucket(nexc)
        # Worst-case section-alignment padding (sparse_row_sections).
        + 8 * _ROW_ALIGN
    )


def scatter_from_blocks(counts, dc, pos, val, exc_idx, exc_val, spec):
    """Device half: ((..., nblocks) int AC counts, (..., nblocks) int16
    DC, (..., cap) int in-block positions, (..., cap) int8 AC values,
    (..., ecap) int32 exception slots, (..., ecap) int16 exception values)
    → per-component (..., BH, BW, k, k) int16 grids, bit-identical to the
    dense payload's. Any leading batch dims.

    Slot → block: block starts (exclusive cumsum of counts) add +1 into a
    per-slot indicator whose inclusive cumsum, minus one, is the block
    owning each slot (empty blocks share their successor's start and
    never capture a slot). The indicator has one slot more than ``cap``:
    trailing empty blocks start at ``cap`` and land there, where the JAX
    scatter dropped them. The int8 stream widens to int16 and the
    exception pairs overwrite their wrapped slots through a sacrificial
    tail slot (pad exceptions point at index ``cap``). Padding AC slots
    route to a sacrificial dense slot at ``total``; DC lands last, in
    position 0 of every block."""
    sizes, total = coeff_layout(spec)
    k2 = spec.k * spec.k
    lead = counts.shape[:-1]
    cap = pos.shape[-1]
    dev = counts.device
    counts = counts.to(torch.int32)
    nnz = counts.sum(dim=-1, keepdim=True)
    starts = (torch.cumsum(counts, dim=-1) - counts).long()
    indicator = torch.zeros((*lead, cap + 1), dtype=torch.int32, device=dev)
    indicator.scatter_add_(-1, starts, torch.ones_like(counts))
    block = torch.cumsum(indicator[..., :cap], dim=-1) - 1
    flat = block * k2 + pos.to(torch.int32)
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    flat = torch.where(slot < nnz, flat, total).long()
    val16 = torch.cat(
        [val.to(torch.int16), torch.zeros((*lead, 1), dtype=torch.int16, device=dev)], dim=-1
    )
    val16.scatter_(-1, exc_idx.long(), exc_val.to(torch.int16))
    dense = torch.zeros((*lead, total + 1), dtype=torch.int16, device=dev)
    dense.scatter_(-1, flat, val16[..., :cap])
    grids = dense[..., :total].reshape(*lead, total // k2, k2)
    grids[..., 0] = dc.to(torch.int16)
    grids = grids.reshape(*lead, total)
    out = []
    off = 0
    for c in range(spec.ncomp):
        bh, bw = spec.block_grid(c)
        n = sizes[c]
        out.append(grids[..., off : off + n].reshape(*lead, bh, bw, spec.k, spec.k))
        off += n
    return tuple(out)
