"""ConcatTransformer: the full-sequence encoder and decoder, and the KV-cached
decode step (retr_tpu/models/transformer.py).

Pre-norm residual blocks; self-attention adds the positional encoding to Q and K
only; the decoder's query position is the learned position table; residual
LayerNorms use eps 1e-5 and the embedding LayerNorm ``cfg.layer_norm_eps``.

The full-sequence half (``encode``, ``decode_full``, ``forward``) serves
training, evaluation and the attention maps (``need_weights`` /
``return_attention``): dropout when ``train`` is on, drawn from generators
made per layer from an integer ``seed`` (``layers.fold_in``) as the JAX package
folds its keys; ``cfg.remat`` checkpoints each layer; ``cfg.use_pallas_attention``
sends every attention core without attention dropout to the fused kernel
(ops/attention.py). Serving's encoder runs ``encode`` too.

The decode step runs the decoder layers through ops/decoder_kernels.py: one
``fused_stack_step`` launch per position when ``LAYER_GRID`` is on, else one
``fused_layer_step`` per layer when ``MERGED_LAYER`` is on, else the per-layer
``self_attn_block`` / ``cross_attn_block`` / ``ff_block`` trio. The beam step
runs ``self_attn_block_beam`` / ``cross_attn_block`` / ``ff_block`` per layer.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from retr_tpu_torch.config import Config
from retr_tpu_torch.masking import causal_mask, key_padding_bias
from retr_tpu_torch.models import layers
from retr_tpu_torch.models.positional import learned_init, positional_encoding
from retr_tpu_torch.ops import decoder_kernels as dk
from retr_tpu_torch.parallel import mesh as pmesh
from retr_tpu_torch.precision import matmul_precision

Params = Dict[str, Any]


def _enc_layer_init(gen: torch.Generator, d: int, dff: int) -> Params:
    return {
        "self_attn": {"norm": layers.layer_norm_init(d), "mha": layers.mha_init(gen, d)},
        "ff": {"norm": layers.layer_norm_init(d), "lin1": layers.xavier_linear_init(gen, d, dff),
               "lin2": layers.xavier_linear_init(gen, dff, d)},
    }


def _dec_layer_init(gen: torch.Generator, d: int, dff: int) -> Params:
    return {
        "self_attn": {"norm": layers.layer_norm_init(d), "mha": layers.mha_init(gen, d)},
        "cross_attn": {"norm": layers.layer_norm_init(d), "mha": layers.mha_init(gen, d)},
        "ff": {"norm": layers.layer_norm_init(d), "lin1": layers.xavier_linear_init(gen, d, dff),
               "lin2": layers.xavier_linear_init(gen, dff, d)},
    }


def init(gen: torch.Generator, cfg: Config) -> Params:
    """Fresh transformer parameters on the host (retr_tpu/models/transformer.py:74):
    the encoder's final LayerNorm under ``pre_norm``, the learned source
    positions (``src_pos``) under ``position_embedding`` "learned"/"v3"."""
    d, dff = cfg.hidden_dim, cfg.dim_feedforward
    params: Params = {
        "encoder": {"layers": [_enc_layer_init(gen, d, dff) for _ in range(cfg.enc_layers)]},
        "decoder": {"layers": [_dec_layer_init(gen, d, dff) for _ in range(cfg.dec_layers)],
                    "norm": layers.layer_norm_init(d)},
        "embeddings": {"word": layers.embedding_init(gen, cfg.vocab_size, d),
                       "pos": layers.embedding_init(gen, cfg.max_position_embeddings, d),
                       "norm": layers.layer_norm_init(d)},
    }
    if cfg.pre_norm:
        params["encoder"]["norm"] = layers.layer_norm_init(d)
    if cfg.position_embedding in ("v3", "learned"):
        params["src_pos"] = learned_init(gen, d, max_len=1024)
    return params


def _with_pos(x, pos):
    return x if pos is None else x + pos


def _seed(seed: Optional[int], data: int) -> Optional[int]:
    return None if seed is None else layers.fold_in(seed, data)


def _self_att_block(p, x, pos, bias, cfg, *, gen=None, train=False, causal=False,
                    key_pad_bias=None, need_weights=False):
    """SelfAttResidual: LN, positions on Q/K only, value = normed input.
    Returns (x, head-averaged weights or None)."""
    nx = layers.layer_norm(p["norm"], x)
    qk = _with_pos(nx, pos)
    out, w = layers.multi_head_attention(
        p["mha"], qk, qk, nx, num_heads=cfg.nheads, bias=bias, need_weights=need_weights,
        dropout_rate=cfg.dropout, generator=gen, train=train, use_pallas=cfg.use_pallas_attention,
        causal=causal, key_pad_bias=key_pad_bias)
    return x + layers.dropout(out, cfg.dropout, gen, train), w


def _cross_att_block(p, q, kv, q_pos, k_pos, bias, cfg, *, gen=None, train=False,
                     key_pad_bias=None, need_weights=False):
    """CrossAttResidual: only the query is normed; keys get positions, keys and
    values are the unnormed memory. Returns (x, weights or None)."""
    nq = layers.layer_norm(p["norm"], q)
    out, w = layers.multi_head_attention(
        p["mha"], _with_pos(nq, q_pos), _with_pos(kv, k_pos), kv, num_heads=cfg.nheads, bias=bias,
        need_weights=need_weights, dropout_rate=cfg.dropout, generator=gen, train=train,
        use_pallas=cfg.use_pallas_attention, key_pad_bias=key_pad_bias)
    return q + layers.dropout(out, cfg.dropout, gen, train), w


def _ff_block(p, x, cfg, *, gen=None, train=False):
    """FFResidual: Linear-ReLU-Linear, pre-norm. Where lin1 is column-sharded
    over the active mesh's mp (narrower than ``cfg.dim_feedforward``), its
    input goes through ``copy_to_mp`` and lin2's partial sums through
    ``reduce_from_mp`` before its bias."""
    nx = layers.layer_norm(p["norm"], x)
    if p["lin1"]["w"].shape[1] == cfg.dim_feedforward:
        h = layers.linear(p["lin2"], torch.relu(layers.linear(p["lin1"], nx)))
    else:
        h = torch.relu(layers.linear(p["lin1"], pmesh.copy_to_mp(nx)))
        h = pmesh.reduce_from_mp(h @ p["lin2"]["w"]) + p["lin2"]["b"]
    return x + layers.dropout(h, cfg.dropout, gen, train)


def decoder_embed(p, ids: torch.Tensor, cfg: Config, position: Optional[torch.Tensor] = None, *,
                  gen=None, train=False) -> torch.Tensor:
    """DecoderEmbeddings: word[ids] + pos, LayerNorm with ``cfg.layer_norm_eps``,
    dropout. With ``position`` (a 0-d int tensor on the device, read there so
    the loop does not wait for the host) ids are [B] and embed that one
    position; without it ids are [B, T] at positions 0..T-1."""
    table = p["word"]["table"]
    if position is None:
        word = table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, -1)
        pos = p["pos"]["table"][: ids.shape[-1]]
    else:
        word = table.index_select(0, ids)
        pos = p["pos"]["table"].index_select(0, position.reshape(1))
    emb = layers.layer_norm(p["norm"], word + pos, eps=cfg.layer_norm_eps)
    return layers.dropout(emb, cfg.dropout, gen, train)


def encode(params: Params, src: torch.Tensor, src_pad_mask: torch.Tensor, cfg: Config, *,
           need_weights: bool = False, train: bool = False, seed: Optional[int] = None):
    """Run the encoder; returns (memory [B, S, C], pos [S, C], atts or None).
    With ``need_weights`` atts is ``{"enc_tc_self_att": [L, B, S, S]}``, the
    head-averaged maps of the plain attention core (the fused kernel is not
    used for that call), and no layer is rematerialised."""
    pos = positional_encoding(cfg.position_embedding, src.shape[1], cfg.hidden_dim, params.get("src_pos"),
                              dropout_rate=cfg.dropout, train=train, device=src.device,
                              generator=layers.make_generator(_seed(seed, 999), src.device))
    bias = key_padding_bias(src_pad_mask)
    kp_bias = bias[:, 0, 0, :]  # [B, S] form for the fused kernel

    def enc_layer(lp, x, layer_seed):
        gen = layers.make_generator(layer_seed, x.device)
        x, w = _self_att_block(lp["self_attn"], x, pos[None, :, :], bias, cfg, gen=gen, train=train,
                               key_pad_bias=kp_bias, need_weights=need_weights)
        return _ff_block(lp["ff"], x, cfg, gen=gen, train=train), w

    x = src
    enc_ws = []
    for li, lp in enumerate(params["encoder"]["layers"]):
        x, w = layers.maybe_checkpoint(enc_layer, cfg.remat and not need_weights, lp, x, _seed(seed, li))
        enc_ws.append(w)
    if "norm" in params["encoder"]:
        x = layers.layer_norm(params["encoder"]["norm"], x)
    return x, pos, ({"enc_tc_self_att": torch.stack(enc_ws)} if need_weights else None)


def decode_full(params: Params, memory: torch.Tensor, mem_pad_mask: torch.Tensor, pos: torch.Tensor,
                tgt_ids: torch.Tensor, tgt_pad_mask: torch.Tensor, cfg: Config, *,
                need_weights: bool = False, train: bool = False, seed: Optional[int] = None):
    """Teacher-forced decoder over the full target buffer; returns (the
    final-normed hidden states [B, T, C], atts or None). The plain path masks
    self-attention with the causal mask plus the target key-padding bias; the
    fused kernel takes ``causal=True`` and the [B, T] key-padding bias. With
    ``need_weights`` atts holds ``dec_exp_self_att`` [L, B, T, T] and
    ``dec_exp_tc_cross_att`` [L, B, T, S]."""
    t = tgt_ids.shape[1]
    emb = params["embeddings"]
    x = decoder_embed(emb, tgt_ids, cfg, gen=layers.make_generator(_seed(seed, 777), memory.device),
                      train=train)
    query_pos = emb["pos"]["table"][:t][None, :, :]
    tgt_bias = key_padding_bias(tgt_pad_mask)
    self_bias = causal_mask(t, device=memory.device)[None, None, :, :] + tgt_bias
    mem_bias = key_padding_bias(mem_pad_mask)
    tgt_kp, mem_kp = tgt_bias[:, 0, 0, :], mem_bias[:, 0, 0, :]

    def dec_layer(lp, x, layer_seed):
        gen = layers.make_generator(layer_seed, x.device)
        x, sw = _self_att_block(lp["self_attn"], x, query_pos, self_bias, cfg, gen=gen, train=train,
                                causal=True, key_pad_bias=tgt_kp, need_weights=need_weights)
        x, cw = _cross_att_block(lp["cross_attn"], x, memory, query_pos, pos[None, :, :], mem_bias, cfg,
                                 gen=gen, train=train, key_pad_bias=mem_kp, need_weights=need_weights)
        return _ff_block(lp["ff"], x, cfg, gen=gen, train=train), sw, cw

    sws, cws = [], []
    for li, lp in enumerate(params["decoder"]["layers"]):
        x, sw, cw = layers.maybe_checkpoint(dec_layer, cfg.remat and not need_weights, lp, x,
                                            _seed(seed, 100 + li))
        sws.append(sw)
        cws.append(cw)
    atts = ({"dec_exp_self_att": torch.stack(sws), "dec_exp_tc_cross_att": torch.stack(cws)}
            if need_weights else None)
    return layers.layer_norm(params["decoder"]["norm"], x), atts


def forward(params: Params, src_t: torch.Tensor, mask_t: torch.Tensor, src_c: Optional[torch.Tensor],
            mask_c: Optional[torch.Tensor], tgt_ids: torch.Tensor, tgt_pad_mask: torch.Tensor,
            cfg: Config, *, return_attention: bool = False, train: bool = False,
            seed: Optional[int] = None):
    """ConcatTransformer.forward: concatenate the context stream (channel-first
    [B, C, S]) after the target stream, encode, and decode the teacher-forced
    buffer; returns ([B, T, C], the encoder's and decoder's maps merged into
    one dict when ``return_attention``, else None)."""
    if src_c is not None:
        src, mask = torch.cat([src_t, src_c], dim=2), torch.cat([mask_t, mask_c], dim=1)
    else:
        src, mask = src_t, mask_t
    src = src.transpose(1, 2)
    with matmul_precision(src.dtype):
        memory, pos, enc_atts = encode(params, src, mask, cfg, need_weights=return_attention, train=train,
                                       seed=_seed(seed, 0))
        out, dec_atts = decode_full(params, memory, mask, pos, tgt_ids, tgt_pad_mask, cfg,
                                    need_weights=return_attention, train=train, seed=_seed(seed, 1))
    return out, ({**enc_atts, **dec_atts} if return_attention else None)


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
