"""Share of the traced slice of the window (one pass over the split) in which
no operation ran on the card, in percent: 100 * (1 - busy / span) of the
torch.profiler CUDA intervals' union (portbench/profiler.py)."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
