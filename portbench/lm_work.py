"""The yardstick of the LM-decoder cells: parameters, bytes and operations of
the language model from its widths (``Config.lm_*``), the least work that a
prefill, a decode step and a caption require. The peaks, the roofline and
the encoder's operations are ``portbench/work.py``'s.

Operations count multiply-adds as two and only what is required: the routed
(token, expert) pairs, never every expert on every token; attention over the
causal half of the prefix; a decode step in the absorbed form (scores in the
latent space: fewer operations than decompressing every cached position).
Bytes count each weight once, each row's cached latents once, and each
output written once.
"""

from __future__ import annotations

from portbench.work import PEAK_FLOPS, _encode_flops, memory_tokens, roofline_s  # noqa: F401

ESIZE = {"bfloat16": 2, "float32": 4}


def _mla_params(c: dict) -> int:
    d, h = c["lm_hidden_size"], c["lm_heads"]
    nope, r, dv, rank = c["lm_qk_nope_head_dim"], c["lm_qk_rope_head_dim"], c["lm_v_head_dim"], c["lm_kv_lora_rank"]
    return d * h * (nope + r) + d * (rank + r) + rank + rank * h * (nope + dv) + h * dv * d


def param_counts(c: dict) -> dict:
    """Parameters by part: the embedding, the head, one dense layer and one
    MoE layer (with their MLA and norms), the experts, shared experts and
    router of one MoE layer, and the total."""
    d, v = c["lm_hidden_size"], c["vocab_size"]
    mla, norms = _mla_params(c), 2 * d
    experts = c["lm_n_routed_experts"] * 3 * d * c["lm_moe_intermediate_size"]
    shared = 3 * d * c["lm_moe_intermediate_size"] * c["lm_n_shared_experts"]
    router = c["lm_n_routed_experts"] * (d + 1)
    dense = mla + norms + 3 * d * c["lm_intermediate_size"]
    moe = mla + norms + experts + shared + router
    n_dense = c["lm_first_k_dense_replace"]
    total = 2 * v * d + d + n_dense * dense + (c["lm_layers"] - n_dense) * moe
    return {"embed": v * d, "head": v * d, "mla": mla, "dense_layer": dense, "moe_layer": moe, "experts": experts,
            "shared": shared, "router": router, "total": total}


def cache_bytes(c: dict, esize: int = 2) -> int:
    """The latent cache's bytes per position and layer."""
    return (c["lm_kv_lora_rank"] + c["lm_qk_rope_head_dim"]) * esize


def _token_ops(c: dict, dense: bool) -> int:
    """Operations of one token through a layer's products (no attention
    scores): the MLA projections (with ``kv_b``'s), and the dense FF or the
    router, the k chosen experts and the shared experts."""
    d = c["lm_hidden_size"]
    if dense:
        ff = 3 * d * c["lm_intermediate_size"]
    else:
        f = c["lm_moe_intermediate_size"]
        ff = c["lm_n_routed_experts"] * d + 3 * d * f * (c["lm_num_experts_per_tok"] + c["lm_n_shared_experts"])
    return 2 * (_mla_params(c) + ff)


def _layers(c: dict):
    for i in range(c["lm_layers"]):
        yield i < c["lm_first_k_dense_replace"]


def prefill_work(c: dict, rows: int, s: int) -> tuple:
    """(bytes, operations) the prefill of ``rows`` prefixes of ``s`` tokens
    requires: the projector, every layer but the last over each token (its
    products, causal attention in the plain form), the last layer's latents
    alone; bytes: the encoder memory read, every weight of the projector and
    the layers read once, the latents written."""
    esize = ESIZE[c["compute_dtype"]]
    d, cin, h = c["lm_hidden_size"], c["hidden_dim"], c["lm_heads"]
    nope, r, dv, rank = c["lm_qk_nope_head_dim"], c["lm_qk_rope_head_dim"], c["lm_v_head_dim"], c["lm_kv_lora_rank"]
    tokens, pairs = rows * s, rows * s * (s + 1) // 2
    ops = 2 * tokens * (cin * d + d * d)
    dense = list(_layers(c))
    for is_dense in dense[:-1]:
        ops += tokens * _token_ops(c, is_dense) + 2 * pairs * h * (nope + r + dv)
    ops += 2 * tokens * d * (rank + r)
    counts = param_counts(c)
    weights = cin * d + d * d + 2 * cin + 2 * d + counts["total"] - counts["embed"] - counts["head"] - d
    nbytes = tokens * cin * esize + weights * esize + c["lm_layers"] * tokens * cache_bytes(c, esize)
    return nbytes, ops


def decode_step_work(c: dict, rows: int, s: int, t: int) -> tuple:
    """(bytes, operations) of decode step ``t`` (position ``s + t``) for
    ``rows`` rows: every layer's products for each row, attention in the
    absorbed form over the ``s + t + 1`` cached positions, the final norm and
    the head. Bytes: every weight of the layers, the final norm and the head
    once, the rows' embedding rows, each row's cached latents once and its new
    slot written, the [rows] token ids."""
    esize = ESIZE[c["compute_dtype"]]
    d, h, v = c["lm_hidden_size"], c["lm_heads"], c["vocab_size"]
    rank, r = c["lm_kv_lora_rank"], c["lm_qk_rope_head_dim"]
    keys = s + t + 1
    ops = 2 * rows * d * v
    for is_dense in _layers(c):
        ops += rows * _token_ops(c, is_dense) + 2 * rows * h * keys * (2 * rank + r)
    counts = param_counts(c)
    weights = counts["total"] - counts["embed"]
    nbytes = (weights + rows * d) * esize + rows * c["lm_layers"] * (keys + 1) * cache_bytes(c, esize) + rows * 8
    return nbytes, ops


def prefill_bound_s(c: dict, rows: int, s: int) -> float:
    return roofline_s(*prefill_work(c, rows, s), c["compute_dtype"])


def decode_step_bound_s(c: dict, rows: int, s: int, steps: int) -> float:
    """The mean roofline time of decode steps 0..steps-1."""
    return sum(roofline_s(*decode_step_work(c, rows, s, t), c["compute_dtype"]) for t in range(steps)) / steps


def caption_flops(c: dict, steps: int) -> int:
    """Operations one greedy caption requires: the encoder (backbones,
    projections, location tokens, RE:TR's encoder), its prefix's prefill and
    ``steps`` decode steps (with the head at each)."""
    s = memory_tokens(c)
    return (_encode_flops(c) + prefill_work(c, 1, s)[1]
            + sum(decode_step_work(c, 1, s, t)[1] for t in range(steps)))
