"""The p95 (``inverted_cdf``) of the time a request waits in
``ServingQueue``, in ms: its ``serve.queue_wait`` span, from ``submit`` to
the moment its batch closes, over the traced window's requests."""

import numpy as np

from portbench import spans as program


def read(ctx):
    waits = [program.ms(s) for s in program.named(program.recorded() or [], "serve.queue_wait")]
    if not waits:
        return None
    return float(np.percentile(waits, 95, method="inverted_cdf"))
