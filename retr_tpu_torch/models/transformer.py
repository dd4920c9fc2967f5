"""ConcatTransformer encoder and the KV-cached decode step (retr_tpu/models/transformer.py).

Pre-norm residual blocks; self-attention adds the positional encoding to Q and K
only; the decoder's query position is the learned position table; residual
LayerNorms use eps 1e-5 and the embedding LayerNorm ``cfg.layer_norm_eps``.

The decode step runs the decoder layers through ops/decoder_kernels.py: one
``fused_stack_step`` launch per position when ``LAYER_GRID`` is on, else one
``fused_layer_step`` per layer when ``MERGED_LAYER`` is on, else the per-layer
``self_attn_block`` / ``cross_attn_block`` / ``ff_block`` trio. The beam step
runs ``self_attn_block_beam`` / ``cross_attn_block`` / ``ff_block`` per layer.
The teacher-forced ``decode_full`` and ``forward`` belong to the training slice
and are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from retr_tpu_torch.config import Config
from retr_tpu_torch.masking import key_padding_bias
from retr_tpu_torch.models import layers
from retr_tpu_torch.models.positional import positional_encoding
from retr_tpu_torch.ops import decoder_kernels as dk

Params = Dict[str, Any]


def _with_pos(x, pos):
    return x if pos is None else x + pos


def _self_att_block(p, x, pos, bias, cfg):
    """SelfAttResidual: LN, positions on Q/K only, value = normed input."""
    nx = layers.layer_norm(p["norm"], x)
    qk = _with_pos(nx, pos)
    return x + layers.multi_head_attention(p["mha"], qk, qk, nx, num_heads=cfg.nheads, bias=bias)


def _ff_block(p, x):
    """FFResidual: Linear-ReLU-Linear, pre-norm."""
    nx = layers.layer_norm(p["norm"], x)
    return x + layers.linear(p["lin2"], torch.relu(layers.linear(p["lin1"], nx)))


def decoder_embed(p, ids: torch.Tensor, cfg: Config, position: torch.Tensor) -> torch.Tensor:
    """DecoderEmbeddings for one position: word[ids] + pos[position], LayerNorm
    with ``cfg.layer_norm_eps``. ids [B]; position a 0-d int tensor on the
    device (read there, so the loop does not wait for the host)."""
    word = p["word"]["table"].index_select(0, ids)
    pos = p["pos"]["table"].index_select(0, position.reshape(1))
    return layers.layer_norm(p["norm"], word + pos, eps=cfg.layer_norm_eps)


def encode(params: Params, src: torch.Tensor, src_pad_mask: torch.Tensor, cfg: Config):
    """Run the encoder; returns (memory [B, S, C], pos [S, C])."""
    pos = positional_encoding(cfg.position_embedding, src.shape[1], cfg.hidden_dim,
                              device=src.device)
    bias = key_padding_bias(src_pad_mask)
    x = src
    for lp in params["encoder"]["layers"]:
        x = _self_att_block(lp["self_attn"], x, pos[None, :, :], bias, cfg)
        x = _ff_block(lp["ff"], x)
    if "norm" in params["encoder"]:
        x = layers.layer_norm(params["encoder"]["norm"], x)
    return x, pos


# ---------------------------------------------------------------------------------
# Incremental (KV-cached) decoding — encode once, one position per step.
# ---------------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    """Self-attention caches, stacked over layers: [L, B, H, T_max, D] each.
    Layer ``l`` is the contiguous view ``self_k[l]``. Updated in place."""

    self_k: torch.Tensor
    self_v: torch.Tensor


class CrossContext(NamedTuple):
    """Per-layer cross-attention K/V from the encoder memory, stacked
    [L, B, H, S, D], and the memory key-padding bias [B, S] (0 / -inf, f32)."""

    cross_k: torch.Tensor
    cross_v: torch.Tensor
    mem_bias: torch.Tensor


def prepare_decoder(params: Params) -> Params:
    """Decoder parameters in the layout the decode kernels read: the layers
    stacked leaf-wise into contiguous [L, ...] tensors (``stacked``) and
    ``layers`` as per-layer views into them. Done once per decode call."""
    dec = params["decoder"]
    stacked = dk.stack_layer_params(dec["layers"])
    views = [dk.layer_params(stacked, li) for li in range(len(dec["layers"]))]
    return {**params, "decoder": {**dec, "layers": views, "stacked": stacked}}


def init_decode_state(params: Params, memory: torch.Tensor, mem_pad_mask: torch.Tensor,
                      pos: torch.Tensor, cfg: Config, max_len: int) -> Tuple[DecodeCache, CrossContext]:
    """Precompute the cross-attention K (from memory + pos) and V (from memory)
    of every decoder layer once, and allocate zeroed self caches."""
    b = memory.shape[0]
    h, dh = cfg.nheads, cfg.head_dim
    kp = _with_pos(memory, pos[None, :, :])
    cross_k, cross_v = [], []
    for lp in params["decoder"]["layers"]:
        mha = lp["cross_attn"]["mha"]
        cross_k.append(layers.split_heads(layers.linear(mha["k"], kp), h))
        cross_v.append(layers.split_heads(layers.linear(mha["v"], memory), h))
    shape = (cfg.dec_layers, b, h, max_len, dh)
    cache = DecodeCache(torch.zeros(shape, dtype=memory.dtype, device=memory.device),
                        torch.zeros(shape, dtype=memory.dtype, device=memory.device))
    cross = CrossContext(torch.stack(cross_k).contiguous(), torch.stack(cross_v).contiguous(),
                         key_padding_bias(mem_pad_mask)[:, 0, 0, :].contiguous())
    return cache, cross


def decode_step(params: Params, state: DecodeCache, cross: CrossContext,
                token_ids: torch.Tensor, step: torch.Tensor, cfg: Config):
    """One autoregressive step: embed position ``step`` (0-d int32 tensor on the
    device), run all decoder layers against the KV caches (written in place at
    ``step``), return the final-normed hidden state [B, C]. ``params`` come from
    :func:`prepare_decoder`."""
    emb = params["embeddings"]
    x = decoder_embed(emb, token_ids, cfg, step)
    qpos = emb["pos"]["table"].index_select(0, step.reshape(1))[0]
    dec = params["decoder"]
    if dk.LAYER_GRID:
        x, _, _ = dk.fused_stack_step(
            dec["stacked"], x, qpos, state.self_k, state.self_v, cross.cross_k, cross.cross_v,
            cross.mem_bias, step, num_heads=cfg.nheads,
        )
    elif dk.MERGED_LAYER:
        for li, lp in enumerate(dec["layers"]):
            x, _, _ = dk.fused_layer_step(lp, x, qpos, state.self_k[li], state.self_v[li],
                                          cross.cross_k[li], cross.cross_v[li], cross.mem_bias, step,
                                          num_heads=cfg.nheads)
    else:
        for li, lp in enumerate(dec["layers"]):
            x, _, _ = dk.self_attn_block(lp["self_attn"], x, qpos, state.self_k[li],
                                         state.self_v[li], step, num_heads=cfg.nheads)
            x = dk.cross_attn_block(lp["cross_attn"], x, qpos, cross.cross_k[li],
                                    cross.cross_v[li], cross.mem_bias, num_heads=cfg.nheads)
            x = dk.ff_block(lp["ff"], x)
    return layers.layer_norm(dec["norm"], x), state


def decode_step_beam(params: Params, state: DecodeCache, cross: CrossContext,
                     token_ids: torch.Tensor, step: torch.Tensor, cfg: Config,
                     anc: torch.Tensor, num_beams: int):
    """Beam-search step with ancestry-addressed self-attention.

    token_ids [B*K], beam-major within each batch element; anc [B, K, T] int32,
    the beam row of the group that wrote each position. Each row writes its own
    cache slot at ``step`` and reads position t from row ``anc[b, k, t]`` of its
    group, so beam reorders never move the caches ([L, B*K, H, T, D], written in
    place). Cross K/V are tiled over the beams and FF is per row, so both run
    the greedy blocks. Returns (final-normed hidden [B*K, C], state).
    """
    emb = params["embeddings"]
    x = decoder_embed(emb, token_ids, cfg, step)
    qpos = emb["pos"]["table"].index_select(0, step.reshape(1))[0]
    anc_rows = anc.reshape(token_ids.shape[0], -1)
    dec = params["decoder"]
    for li, lp in enumerate(dec["layers"]):
        x, _, _ = dk.self_attn_block_beam(lp["self_attn"], x, anc_rows, qpos, state.self_k[li],
                                          state.self_v[li], step, num_heads=cfg.nheads,
                                          num_beams=num_beams)
        x = dk.cross_attn_block(lp["cross_attn"], x, qpos, cross.cross_k[li], cross.cross_v[li],
                                cross.mem_bias, num_heads=cfg.nheads)
        x = dk.ff_block(lp["ff"], x)
    return layers.layer_norm(dec["norm"], x), state
