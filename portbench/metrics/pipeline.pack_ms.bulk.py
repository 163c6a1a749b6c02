"""Pipeline: the program's ``pipeline.pack`` span an image, in ms: from
``submit_batch``'s entry to its graph's replay (stack, payload pack,
signature lookup, pinned staging), the mean of its ranges in the traced
window's trace over the batch."""

from portbench.program_spans import batch_range_ms_per_image


def read(rec):
    return batch_range_ms_per_image(rec, "pipeline.pack")
