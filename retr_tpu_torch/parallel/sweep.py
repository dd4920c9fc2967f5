"""The sharded evaluation sweep: each dp rank decodes its rows of every
batch (retr_tpu/parallel/sweep.py).

The work is ``engine.eval_model(mesh=)``: a host batch is padded to a
dp-divisible size (``pad_host_batch``), each dp rank uploads and decodes its
rows with greedy, beam or sampling through the decode kernels, and the token
ids come back to every rank (``all_gather_object`` over the dp group), so
every rank scores the whole split and returns the same metrics.

Under mp > 1 each rank decodes on its own slices of the tree, as
``parallel.mesh.shard_params`` cut them, never gathered: the encoder and the
decode step run on its heads, FF columns and vocabulary columns (the caches
hold H/mp heads), with an all-reduce over the mp group where JAX's specs put
a psum (``models/transformer.decode_step``, ``decode``); the ranks of one mp
group decode the same rows together.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from retr_tpu_torch import engine
from retr_tpu_torch.config import Config
from retr_tpu_torch.data.dataset import DataLoader
from retr_tpu_torch.parallel import mesh as pmesh


def eval_model_sharded(params, cfg: Config, loader: DataLoader, tokenizer, mesh: Optional[pmesh.Mesh], *,
                       metrics_to_omit: Optional[List[str]] = None, return_hypotheses: bool = False,
                       decoder: str = "greedy", specs: Optional[dict] = None):
    """``engine.eval_model`` under ``mesh`` (None: a world of one) with JAX's
    signature: the metric dict, or ``(metrics, hypotheses)`` (strings, in the
    loader's order) with ``return_hypotheses``. ``params`` and ``specs`` as
    ``engine.eval_model``'s."""
    metrics, hyps = engine.eval_model(params, cfg, loader, tokenizer, metrics_to_omit=metrics_to_omit,
                                      decoder=decoder, mesh=mesh, specs=specs)
    return (metrics, [h["expression"] for h in hyps]) if return_hypotheses else metrics


def full_eval_sweep(params, base_cfg: Config, tokenizer, mesh: Optional[pmesh.Mesh], *,
                    datasets: Dict[str, DataLoader], decoder: str = "greedy", return_hypotheses: bool = False,
                    specs: Optional[dict] = None):
    """:func:`eval_model_sharded` of ``params`` (the whole tree, or this
    rank's slices with their ``specs``) over every loader of ``datasets``
    (label, e.g. "refcoco/val", -> loader); returns ``{label: metrics}``, or
    ``({label: metrics}, {label: hypotheses})`` with ``return_hypotheses``."""
    metrics: Dict[str, Dict[str, float]] = {}
    hyps: Dict[str, list] = {}
    for label, loader in datasets.items():
        out = eval_model_sharded(params, base_cfg, loader, tokenizer, mesh, decoder=decoder,
                                 return_hypotheses=return_hypotheses, specs=specs)
        if return_hypotheses:
            metrics[label], hyps[label] = out
        else:
            metrics[label] = out
    return (metrics, hyps) if return_hypotheses else metrics
