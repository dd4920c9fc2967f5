"""Bytes and operations of beam search's decode step, and of a beam-searched
caption, from shapes: the yardstick of ``beam_step_roofline`` and
``mfu.beam``. The peaks, the roofline and the encoder's count are
``portbench/work.py``'s."""

from __future__ import annotations

from portbench.work import MLP_HIDDEN, _encode_flops, memory_tokens, roofline_s


def beam_block_work(kind: str, rows: int, step: int, s: int, *, beams: int = 5, required: bool = False,
                    c: int = 256, heads: int = 8, f: int = 2048, t: int = 128, vocab: int = 30522,
                    esize: int = 2) -> tuple:
    """(bytes, operations) of one block of a beam-search decode step for
    ``rows`` rows (elements x ``beams``) at position ``step`` against ``s``
    memory tokens. ``kind``: "cross_attn_block", "ff_block",
    "self_attn_block_beam" or "mlp_head_topk".

    By default, what the port's kernels are handed (``chip_smoke.py``'s
    ``kernel_work``): each block reads its input and writes its output; every
    row reads its own copy of the cross K/V (tiled across the beams) and its
    f32 key bias, and its own self-cache prefix through the [rows, t] int32
    ancestry; the top-k head is its last layer (the 512-wide trunk runs
    before it). ``required``: the least any implementation of the step
    needs: no block's input or output (a fused step keeps them on chip), the
    cross K/V and key bias of each element once for its group of beams (the
    beams share their element's memory), the self-cache prefix once a group
    (the least: beams that share every ancestor read one prefix), no
    ancestry (an addressing scheme), and the whole head, trunk included."""
    d = c // heads
    kv_rows = rows // beams if required else rows
    io = 0 if required else 2 * rows * c * esize
    if kind == "cross_attn_block":
        w = 2 * c * c + c + c + 3 * c
        return (io + w * esize + 2 * kv_rows * heads * s * d * esize + kv_rows * s * 4,
                2 * rows * 2 * c * c + 2 * 2 * rows * heads * s * d)
    if kind == "ff_block":
        return io + (2 * c * f + f + c + 2 * c) * esize, 2 * rows * 2 * c * f
    if kind == "self_attn_block_beam":
        w = 4 * c * c + 3 * c + c + 2 * c
        cache = 2 * kv_rows * heads * step * d * esize + 2 * rows * heads * d * esize   # read prefix, write slot
        return (io + w * esize + cache + 4 + (0 if required else rows * t * 4),
                2 * rows * 4 * c * c + 2 * 2 * rows * heads * (step + 1) * d)
    if kind == "mlp_head_topk":
        out = rows * beams * 8                                                   # f32 scores, int32 ids
        if required:
            w = c * MLP_HIDDEN + MLP_HIDDEN * MLP_HIDDEN + MLP_HIDDEN * vocab + 2 * MLP_HIDDEN + vocab
            return w * esize + out, 2 * rows * (c * MLP_HIDDEN + MLP_HIDDEN * MLP_HIDDEN + MLP_HIDDEN * vocab)
        return rows * MLP_HIDDEN * esize + (MLP_HIDDEN * vocab + vocab) * esize + out, 2 * rows * MLP_HIDDEN * vocab
    raise ValueError(f"unknown block {kind!r}")


def beam_step_bound_s(rows: int, s: int, *, beams: int = 5, steps: int = 127, dtype: str = "bfloat16",
                      layers: int = 6, c: int = 256, **kw) -> float:
    """The mean roofline time of one beam-search step's required work over
    steps 0..steps-1: ``layers`` x (self-attention, cross-attention, FF) and
    the top-k head (``beam_block_work(..., required=True)``), plus the step's
    input (the rows' token embeddings), bytes and operations summed over the
    step (the least time of any implementation, fused or not)."""
    esize = 2 if dtype == "bfloat16" else 4
    total = 0.0
    for t in range(steps):
        nbytes, ops = rows * c * esize, 0
        for kind, n in (("self_attn_block_beam", layers), ("cross_attn_block", layers), ("ff_block", layers),
                        ("mlp_head_topk", 1)):
            b, o = beam_block_work(kind, rows, t, s, beams=beams, required=True, c=c, esize=esize, **kw)
            nbytes, ops = nbytes + n * b, ops + n * o
        total += roofline_s(nbytes, ops, dtype)
    return total / steps


def beam_caption_flops(cfg: dict, beams: int, steps: int = 127) -> int:
    """Operations one caption needs from beam search at ``beams`` beams:
    encode once, the cross K/V of the memory once per layer (the beams share
    it), and at each of ``steps`` steps the required work of ``beams`` rows
    (``beam_block_work(..., required=True)``: the decoder layers and the
    whole head). At one beam it is ``work.caption_flops``."""
    c, s, layers = cfg["hidden_dim"], memory_tokens(cfg), cfg["dec_layers"]
    kw = dict(beams=beams, required=True, c=c, heads=cfg["nheads"], f=cfg["dim_feedforward"],
              t=cfg["max_position_embeddings"], vocab=cfg["vocab_size"])
    dec = 0
    for t in range(steps):
        dec += layers * sum(beam_block_work(kind, beams, t, s, **kw)[1]
                            for kind in ("self_attn_block_beam", "cross_attn_block", "ff_block"))
        dec += beam_block_work("mlp_head_topk", beams, t, s, **kw)[1]
    return _encode_flops(cfg) + layers * 2 * 2 * s * c * c + dec
