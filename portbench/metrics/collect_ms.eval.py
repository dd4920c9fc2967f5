"""``eval_model``'s post-processing per batch, in ms: the ``eval.collect``
span less the ``eval.fetch`` inside it (the ids' copy to the host), which
leaves pruning, detokenizing and the references' re-tokenizing; the mean
over the profiled pass's batches."""

from portbench import spans as program


def read(ctx):
    spans = program.recorded() or []
    own = [program.self_ms(spans, s, "eval.fetch") for s in program.named(spans, "eval.collect")]
    if not own:
        return None
    return sum(own) / len(own)
