"""Host time per training step to build the device batch, in ms: the mean
``train.device_batch`` span (``data/pipeline.device_batch``: upload, colour
jitter, normalisation) over the traced steps."""

from portbench import spans as program


def read(ctx):
    return program.mean_ms(program.recorded(), "train.device_batch")
