"""The whole evaluation step's share of the card's peak, in percent: the
operations of one greedy caption from shapes (backbone, encoder, the cross
K/V, 127 KV-cached decoder steps and the head; portbench/work.py) times the
run's captions per second, over the published peak of the configuration's
arithmetic (989 TFLOP/s in bfloat16)."""

from portbench import work


def read(ctx):
    rate = ctx["e2e"].get("captions_per_s")
    if not rate:
        return None
    cfg = ctx["cfg"]
    return 100.0 * work.caption_flops(cfg, ctx["steps"]) * rate / work.PEAK_FLOPS[cfg["compute_dtype"]]
