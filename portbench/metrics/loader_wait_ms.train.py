"""Host time ``train_one_epoch`` spends blocked on the ``DataLoader`` per
training batch, in ms: the mean over the window, timed by the harness around
each batch the loader it passes to ``engine.train_one_epoch`` hands over."""


def read(ctx):
    waits = ctx["spans"].get("loader_wait")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
