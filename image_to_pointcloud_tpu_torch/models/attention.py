"""Multi-head attention: the hand-written CUDA flash kernel and its plain
PyTorch version.

Counterpart of ``image_to_pointcloud_tpu/models/attention.py``. The
kernels (``csrc/flash_attention.cu``, on the tensor cores with ``wgmma``:
bf16 directly, f32 in 3xTF32) replace the Pallas TPU kernel
``flash_attention``; :func:`attention_plain` is ``_attention_xla``'s
math. Any head dim, as the Pallas kernel takes any: above 128 a kernel
for wide heads writes O in 128-column panels, one a warpgroup, and
computes the logits once a key tile for a group of panels (up to 384
columns in bf16, the warpgroups of one CTA; up to 1024 in f32, the CTAs
of a thread-block cluster). The only limits are the launch grid's
(:data:`MAX_BATCH_HEADS` batch × heads, :data:`MAX_HEAD_DIM_PANELS`
panels). The choice follows the tensor's
device: a CUDA tensor launches the kernel (or raises), a CPU tensor
takes the plain version; a caller that
asks for no flash (``use_flash=False``, the backbones'
``use_flash_attention``, as the trainer builds them) gets the plain
version on any device. Unlike the JAX package there is no minimum
sequence length for the kernel: the TPU's ``flash_min_seq`` gate was a
TPU measurement. The kernel has no backward: :func:`flash_attention`
refuses inputs that require grad while grad mode is on, rather than
return an output that silently cuts the gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from image_to_pointcloud_tpu_torch import cuda

__all__ = [
    "MAX_BATCH_HEADS",
    "MAX_HEAD_DIM_PANELS",
    "attention_plain",
    "flash_attention",
    "multi_head_attention",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The entry point's limits (csrc/flash_attention.cu): B·H is the launch
# grid's y dimension, and the 128-column O panels (D > 128) bound its z.
MAX_BATCH_HEADS = 65535
MAX_HEAD_DIM_PANELS = 65535
# Elements of a 16-byte chunk: the kernels read rows 16 bytes at a time.
_PER_16B = {torch.float32: 4, torch.bfloat16: 8}


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """Materialized attention over (B, H, N, D); returns f32.

    ``_attention_xla``'s math: f32 dots of the input values, logits
    rounded to the input dtype, softmax statistics in f32, probabilities
    rounded to the value dtype before the f32-accumulated P·V product.
    """
    logits = (
        torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    ).to(q.dtype).float()
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    probs = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(probs.float(), v.float())


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Flash attention over (B, H, N, D) CUDA tensors, f32 or bf16, any D.

    The head dim must be contiguous; batch, head and sequence strides are
    free, so head-split views of (B, N, H·D) projections are read in
    place. The kernels read rows 16 bytes at a time: a head dim that is
    not a multiple of 16 bytes (8 bf16, 4 f32) is zero-padded into
    contiguous copies first, the scale staying 1/√D of the true D;
    pointers and strides that are not multiples of 16 bytes raise. The output has the input dtype and shape, laid out as (B, N,
    H, D) underneath so merging the heads back is free. bf16 runs on the
    bf16 tensor cores, f32 in 3xTF32 on the TF32 ones; above D = 128 each
    dtype has its kernel for wide heads. B·H
    above :data:`MAX_BATCH_HEADS` or more than :data:`MAX_HEAD_DIM_PANELS`
    O panels raise. Forward only: under grad mode, inputs that require
    grad raise.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: call it under torch.no_grad() or "
            "torch.inference_mode(), or build the model with use_flash_attention=False"
        )
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: shapes {q.shape}, {k.shape}, {v.shape}")
    b, h, n, d = q.shape
    if d < 1 or n < 1 or b * h > MAX_BATCH_HEADS or -(-d // 128) > MAX_HEAD_DIM_PANELS:
        raise ValueError(
            f"flash_attention: shape {tuple(q.shape)} is outside the launch grid's limits "
            f"D >= 1, N >= 1, B·H <= {MAX_BATCH_HEADS}, ceil(D / 128) <= {MAX_HEAD_DIM_PANELS}"
        )
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    per = _PER_16B[q.dtype]
    dp = -(-d // per) * per
    if dp != d:
        q, k, v = (F.pad(t, (0, dp - d)) for t in (q, k, v))

    def aligned(t):
        return t.data_ptr() % 16 == 0 and all(s % per == 0 for s in t.stride()[:3])

    if not all(aligned(t) for t in (q, k, v)):
        raise ValueError("flash_attention: needs 16-byte aligned pointers and strides")
    out = torch.empty((b, n, h, dp), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3))
    )
    lib = cuda.library()
    with torch.cuda.device(q.device):
        err = lib.ipc_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, n, dp, strides, 1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    cuda.check(err, cuda.FLASH_ATTENTION)
    cuda.FLASH_ATTENTION.count()
    return out if dp == d else out[..., :d]


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int, use_flash: bool = True
) -> torch.Tensor:
    """(B, N, D) projected q/k/v → attention output (B, N, D): K1 on a CUDA
    tensor when ``use_flash``, else the plain version."""
    b, n, dm = q.shape
    dh = dm // num_heads

    def split(x):
        return x.reshape(b, n, num_heads, dh).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    if use_flash and q.device.type == "cuda":
        o = flash_attention(qh, kh, vh)
    elif q.device.type in ("cpu", "cuda"):
        o = attention_plain(qh, kh, vh, 1.0 / math.sqrt(dh))
    else:
        raise ValueError(f"multi_head_attention: unsupported device {q.device}")
    return o.transpose(1, 2).reshape(b, n, dm).to(q.dtype)
