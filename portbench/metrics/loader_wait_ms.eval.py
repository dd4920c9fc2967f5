"""Host time ``eval_model`` spends blocked on the ``DataLoader`` per batch, in ms:
the mean of its PhaseTimer's ``host_wait`` phase over the window's passes."""


def read(ctx):
    waits = ctx["spans"].get("host_wait")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
