"""Whole step: the model's FLOPs an image (``portbench/flops.py``) times
the images collected a second in the traced run's window before its
profiler started, as a share of the H100's dense bf16 peak (989 TFLOP/s
at 700 W), in %."""

from portbench.hw import BF16_TC_FLOP_S


def read(rec):
    rate = rec.get("unprofiled_img_s")
    if not rate:
        return None
    return 100.0 * rec["flops_per_image"] * rate / BF16_TC_FLOP_S
