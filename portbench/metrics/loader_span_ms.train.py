"""Host time ``train_one_epoch`` spends blocked on the loader per training
step, in ms, timed inside the program: the mean ``train.loader_wait`` span
over the traced steps (``loader_wait_ms.train`` times the same wait from
the harness, around the loader it passes in)."""

from portbench import spans as program


def read(ctx):
    return program.mean_ms(program.recorded(), "train.loader_wait")
