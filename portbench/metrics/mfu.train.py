"""The training step's share of the card's peak, in percent: forward and
backward operations of one sample from shapes (portbench/work.py: trained
parts three times their forward, the frozen stem and layer1 forward only)
times the run's samples per second, over the peak of the fastest arithmetic
the configuration allows: 67 TFLOP/s in float32 with TF32 off, 989 in
bfloat16."""

from portbench import work


def read(ctx):
    rate = ctx["e2e"].get("train_samples_per_s")
    if not rate:
        return None
    cfg = ctx["cfg"]
    return 100.0 * work.train_sample_flops(cfg) * rate / work.PEAK_FLOPS[cfg["compute_dtype"]]
