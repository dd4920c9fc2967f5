"""The whole beam-search evaluation step's share of the card's peak, in
percent: the operations one caption needs from shapes (backbone, encoder,
the cross K/V once, 127 KV-cached decoder steps of ``Config.beam_size``
rows' layers and whole head; portbench/beam_work.py) times the run's
captions per second, over the published peak of the configuration's
arithmetic (989 TFLOP/s in bfloat16)."""

from portbench import beam_work, work


def read(ctx):
    rate = ctx["e2e"].get("captions_per_s")
    if not rate or ctx["traffic"].get("decoder") != "beam":
        return None
    cfg = ctx["cfg"]
    return 100.0 * beam_work.beam_caption_flops(cfg, ctx["beams"], ctx["steps"]) * rate / \
        work.PEAK_FLOPS[cfg["compute_dtype"]]
