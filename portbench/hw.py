"""The card: presence, name, power limit; the H100's published peaks and
the roofline arithmetic.

The peaks, :func:`bound` and :func:`k1_bound` are frozen copies of
``chip_smoke.py``'s ``HBM_BYTES_S``/``BF16_TC_FLOP_S``/``F32_FLOP_S``,
``bound`` and ``_k1_bound`` (NVIDIA's data sheet, H100 SXM, dense rates,
at the 700 W limit).
"""

from __future__ import annotations

import subprocess

HBM_BYTES_S, BF16_TC_FLOP_S, F32_FLOP_S = 3.35e12, 989e12, 67e12
TF32_TC_FLOP_S = 494.7e12


def bound(nbytes: float, ops: float, rate: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak for their type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def k1_bound(dtype: str, nbytes: float, flops: float) -> dict:
    """K1's bound for the design that runs: bf16 on the bf16 tensor cores;
    f32 in 3xTF32 (3·flops on the TF32 tensor cores)."""
    if dtype == "float32":
        return {**bound(nbytes, 3 * flops, TF32_TC_FLOP_S), "bound_design": "3xTF32",
                "fp32_core_bound_ms": bound(nbytes, flops, F32_FLOP_S)["bound_ms"]}
    return {**bound(nbytes, flops, BF16_TC_FLOP_S), "bound_design": "bf16 tensor cores"}


def k1_work(b: int, h: int, n: int, d: int, itemsize: int) -> tuple[float, float]:
    """(bytes, FLOPs) of one attention call over (B, H, N, D): Q, K, V read
    and O written once; Q·Kᵀ and P·V at 2 per multiply-add."""
    return 4.0 * b * h * n * d * itemsize, 4.0 * b * h * n * n * d


def require_cards(n: int) -> str | None:
    """None when CUDA sees at least ``n`` cards, else why not. Creates no
    CUDA context."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < n:
        return f"torch.cuda.device_count() is {torch.cuda.device_count()}, the cell needs {n}"
    return None


def smi() -> dict:
    """The first card's name, power limit and clocks from nvidia-smi (empty
    where it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,count",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        name, limit, clock, count = (s.strip() for s in out.stdout.splitlines()[0].split(","))
        return {"name": name, "power_limit": limit, "max_sm_clock": clock, "count": count}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {}
