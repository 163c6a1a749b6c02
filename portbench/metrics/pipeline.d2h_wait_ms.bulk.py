"""Pipeline: the program's ``pipeline.d2h_wait`` span an image, in ms: in
``collect``, the wait for the device and the bundle's copy to the host,
the mean of its ranges in the traced window's trace over the batch."""

from portbench.program_spans import batch_range_ms_per_image


def read(rec):
    return batch_range_ms_per_image(rec, "pipeline.d2h_wait")
