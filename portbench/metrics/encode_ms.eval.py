"""Host time to enqueue the eager encoder per batch in ``eval_model``, in
ms: the mean ``decode.encode`` span (backbone, encoder, the cast for the
decode) over the profiled pass's batches of 512 rows."""

from portbench import spans as program


def read(ctx):
    return program.mean_ms(program.recorded(), "decode.encode")
