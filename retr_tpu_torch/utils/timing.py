"""Device timing by serial chains with one barrier (retr_tpu/utils/timing.py).

A function's time per application is ``(T(2k) - T(k)) / k``: one chain of k
serial applications and one of 2k, each ended by a single scalar fetch, the
only barrier. What every chain pays once (its first dispatch, the fetch)
cancels in the difference. Each application depends on the one before, so
the chain is serial on the device as it is in a decode or training loop.

On a CUDA device the fetch synchronises with the card; on the CPU the same
code runs and the fetch waits for nothing, the calls being synchronous.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List

import numpy as np
import torch


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts (keys sorted, as ``jax.tree.leaves``
    walks them), lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _tap(y) -> torch.Tensor:
    """The f32 sum of the first element of every leaf of ``y``: a tap of one
    leaf alone would let a step whose other outputs are unread go unchecked."""
    return sum(leaf.reshape(-1)[0].float() for leaf in _leaves(y))


def chain_apply(fn: Callable[[Any], Any], *, thread: bool = False) -> Callable:
    """Return ``run(x, iters)``: apply ``fn`` to ``x`` ``iters`` times
    serially and return a 0-d f32 tensor (the last application's tap) on
    the device of ``x``'s first leaf.

    ``thread=False``: ``fn``'s output may have any structure; each
    application takes the input with a 1e-30 tap of the previous output
    added to the first element of its first floating leaf (a copy of that
    leaf, made once per run: ``x`` itself is not written), so each
    application depends on the last while the measured arithmetic stays
    the same (1e-30 underflows in bf16 and is far below f32's epsilon at
    O(1) values). For stateless functions whose output differs from the
    input: encode, a decode step.

    ``thread=True``: ``fn`` maps a tree to one of the same structure (a
    train step, state -> state) and each output is the next input."""

    def run(x0, iters: int) -> torch.Tensor:
        leaves = _leaves(x0)
        s = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        if thread:
            x = x0
            for _ in range(iters):
                x = fn(x)
                s = _tap(x)
            return s
        first = next(i for i, leaf in enumerate(leaves) if leaf.is_floating_point())
        bumped = leaves[first].clone()
        x = _replace_leaf(x0, leaves[first], bumped)
        flat = bumped.view(-1)
        for _ in range(iters):
            flat[0] += (s * 1e-30).to(bumped.dtype)
            s = _tap(fn(x))
        return s

    return run


def _replace_leaf(tree, old: torch.Tensor, new: torch.Tensor):
    """``tree`` with the leaf ``old`` (by identity) replaced by ``new``."""
    if isinstance(tree, dict):
        return {k: _replace_leaf(v, old, new) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_replace_leaf(v, old, new) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)   # a NamedTuple
    return new if tree is old else tree


def time_chained(fn: Callable[[Any], Any], x, *, k: int = 32, rounds: int = 3, thread: bool = False) -> float:
    """Median over ``rounds`` of ``(T(2k) - T(k)) / k``, seconds per
    application of ``fn(x)`` (:func:`chain_apply`), after one warm-up chain
    of each length."""
    run = chain_apply(fn, thread=thread)
    float(run(x, k))
    float(run(x, 2 * k))
    deltas = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        float(run(x, k))
        t1 = time.perf_counter()
        float(run(x, 2 * k))
        t2 = time.perf_counter()
        deltas.append(((t2 - t1) - (t1 - t0)) / k)
    return float(np.median(deltas))
