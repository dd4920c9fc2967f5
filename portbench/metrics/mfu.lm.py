"""The LM-decoder evaluation's share of the card's peak, in percent: the
operations one greedy caption requires (the RE:TR encoder, the prefix's
prefill, 31 decode steps with the head; routed experts only;
``lm_work.caption_flops``) times the run's captions per second, on the host
clock, over the published peak of the configuration's arithmetic (989
TFLOP/s in bfloat16)."""

from portbench import lm_work


def read(ctx):
    rate = ctx["e2e"].get("captions_per_s")
    if not rate or ctx["cfg"].get("decoder_kind") != "lm":
        return None
    c = ctx["cfg"]
    return 100.0 * lm_work.caption_flops(c, ctx["steps"]) * rate / lm_work.PEAK_FLOPS[c["compute_dtype"]]
