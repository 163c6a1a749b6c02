"""Pipeline: the program's ``pipeline.unbundle`` span an image, in ms: in
``collect``, the bundle's unpack and the native reconstruct of each
image's cloud, the mean of its ranges in the traced window's trace over
the batch."""

from portbench.program_spans import batch_range_ms_per_image


def read(rec):
    return batch_range_ms_per_image(rec, "pipeline.unbundle")
