"""The serving dispatcher's own host time per batch, in ms: the batch's
``serve.preprocess`` span plus its ``serve.dispatch`` span (collate, upload,
the eager encoder's and the decode's enqueue) less the ``decode.stop_check``
spans inside it (the host blocked on the card), the mean over the traced
window's dispatched batches."""

from portbench import spans as program


def read(ctx):
    spans = program.recorded() or []
    pre = {s["attrs"].get("batch"): program.ms(s) for s in program.named(spans, "serve.preprocess")}
    per_batch = [pre.get(s["attrs"].get("batch"), 0.0) + program.self_ms(spans, s, "decode.stop_check")
                 for s in program.named(spans, "serve.dispatch")]
    if not per_batch:
        return None
    return sum(per_batch) / len(per_batch)
