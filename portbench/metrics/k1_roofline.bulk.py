"""Kernels: K1's (``csrc/flash_attention.cu``) share of its roofline, in %:
the least time of one call at the model's shapes (batch × heads × tokens
× head dim, bf16; ``portbench/hw.py``'s bound) over the mean device time
of the K1 kernels in the trace."""

from portbench.flops import model_grid
from portbench.hw import k1_bound, k1_work


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    calls = [(t["kernel_s"][n], c) for n, c in t["kernel_calls"].items() if "flash_fwd" in n]
    n_calls = sum(c for _, c in calls)
    if not n_calls:
        return None
    a = rec["cfg"]["arch"]
    ph, pw = model_grid(rec["cfg"], *rec["traffic"]["frame_hw"])
    heads = a["num_attention_heads"]
    nbytes, flops = k1_work(rec["traffic"]["batch"], heads, ph * pw + 1, a["hidden_size"] // heads, 2)
    mean_s = sum(s for s, _ in calls) / n_calls
    return 100.0 * k1_bound(rec["cfg"]["dtype"], nbytes, flops)["bound_ms"] * 1e-3 / mean_s
