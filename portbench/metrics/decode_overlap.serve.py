"""The share of the traced serving window's batches that the dispatcher began
while the card still had the previous batch to decode, in percent: 100 x the
batches whose ``serve.coalesce`` span (from the batch's first request taken
off the queue) started before the previous batch's ``serve.decode`` span (the
decode loop) ended, over every batch after the window's first. Batches are
matched by their ``batch`` attribute and taken in its order. None where the
program records no ``serve.decode`` span, as a program whose dispatcher runs
the decode itself records none."""

from portbench import spans as program


def read(ctx):
    spans = program.recorded() or []
    decode_end = {s["attrs"].get("batch"): s["end_ns"] for s in program.named(spans, "serve.decode")}
    begun = {s["attrs"].get("batch"): s["start_ns"] for s in program.named(spans, "serve.coalesce")}
    order = sorted(b for b in decode_end if b in begun)
    pairs = list(zip(order, order[1:]))
    if not pairs:
        return None
    return 100.0 * sum(begun[b] < decode_end[prev] for prev, b in pairs) / len(pairs)
