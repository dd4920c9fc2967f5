"""Greedy, prefix-forced, sampled and beam decoding, sequence scores and
attention maps: encode once, then the KV-cached loop (retr_tpu/decode.py).

Greedy token semantics are the reference's, exactly: BOS in slot 0; the logits
of position i are argmaxed into slot i+1; rows that produced EOS keep receiving
(ignored) tokens; when every row has finished the pending write is skipped and
the loop stops; at most ``max_len - 1`` steps. The buffer, post-EOS junk
included, equals retr_tpu.decode.greedy's. ``greedy_with_prefix`` and ``sample``
run the same loop (``_token_loop``) and differ only in how a step's token is
chosen.

Beam search is retr_tpu.decode.beam_search's: memory tiled across the beams,
caches never reordered (ancestry addressing), the two-stage top-k on raw
logits, frozen finished beams, ``early_stop`` and the length-normalised final
ranking. Every top-k and sort breaks ties to the lowest index, as
``jax.lax.top_k`` and the stable ``jnp.argsort`` do (``ops.decoder_kernels.topk_first``).

On the GPU neither loop waits for the host each step: the stop condition stays
on the device, the step index the kernels read is a device int32, and the host
looks at it only every ``CHECK_EVERY`` steps. Greedy steps run after every row
finished are no-ops (the write is skipped). A beam step is not a no-op, so each
beam step's carry update is gated by the device bool ``running`` (the JAX
loop's condition, which stays false once false). Unlike the JAX package, no
rows are padded: the CUDA kernels take any batch. Under the head flags the
head is packed once per call, as the head kernels read it
(``ops.decoder_kernels.pack_head``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from retr_tpu_torch.config import Config
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import caption, transformer
from retr_tpu_torch.ops import decoder_kernels as dk
from retr_tpu_torch.parallel import mesh as pmesh
from retr_tpu_torch.precision import dtype_of, matmul_precision

Params = Dict[str, Any]

CHECK_EVERY = 16  # steps between host checks of the loop's stop condition


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _cast_for_decode(params: Params, memory, pos, compute_dtype):
    """Storage type of the decode loop: in bf16 mode the transformer and head
    weights, the encoder memory and (allocated from it) the cross K/V and self
    caches are bf16; f32 parity mode returns everything unchanged. LayerNorm and
    softmax still compute in f32 inside the kernels."""
    dt = dtype_of(compute_dtype)
    if dt == torch.float32:
        return params, memory, pos
    params = {**params, "transformer": _cast_tree(params["transformer"], dt),
              "mlp": _cast_tree(params["mlp"], dt)}
    return params, memory.to(dt), pos.to(dt)


def _token_loop(params: Params, cfg: Config, memory, mem_mask, pos, choose, *, max_len: int,
                bos_token: int, eos_token: int, captions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The KV-cached loop of greedy, prefix completion and sampling: each step
    decodes position i, ``choose(i, hs, captions)`` gives the [B] int32 tokens
    of slot i+1, and the reference's write and stop rules apply to them.
    ``captions``: a preset [B, max_len] buffer (forced tokens); slot 0 is set to
    BOS here."""
    b = memory.shape[0]
    dev = memory.device
    tparams = transformer.prepare_decoder(params["transformer"])
    cache, cross = transformer.init_decode_state(tparams, memory, mem_mask, pos, cfg, max_len)
    if captions is None:
        captions = torch.zeros((b, max_len), dtype=torch.int32, device=dev)
    captions[:, 0] = bos_token
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    with matmul_precision(memory.dtype):
        for i in range(max_len - 1):
            if i and i % CHECK_EVERY == 0 and bool(finished.all()):
                break
            hs, cache = transformer.decode_step(tparams, cache, cross, captions[:, i], step, cfg)
            tok = choose(i, hs, captions)
            finished |= tok == eos_token
            write = ~finished.all()  # all just finished: the reference skips this write
            captions[:, i + 1] = torch.where(write, tok, captions[:, i + 1])
            step += 1
    return captions


def _argmax_head(mlp: Params, hs) -> torch.Tensor:
    return caption.mlp_head(mlp, hs).argmax(dim=-1).to(torch.int32)


def greedy_from_memory(params: Params, cfg: Config, memory, mem_mask, pos, *,
                       max_len: int, bos_token: int, eos_token: int) -> torch.Tensor:
    """Greedy decode given the encoder output; returns the [B, max_len] int32
    token buffer (on memory's device)."""
    head_p = dk.pack_head(params["mlp"]) if dk.HEAD_KERNEL else None

    def choose(i, hs, captions):
        return dk.mlp_head_argmax(head_p, hs) if head_p is not None else _argmax_head(params["mlp"], hs)

    return _token_loop(params, cfg, memory, mem_mask, pos, choose, max_len=max_len, bos_token=bos_token,
                       eos_token=eos_token)


def _encode_for_decode(params, cfg, samples, global_samples, loc_feats, compute_dtype, filler_idx):
    memory, mem_mask, pos = caption.encode(
        params, cfg, samples, global_samples=global_samples, loc_feats=loc_feats,
        compute_dtype=compute_dtype, filler_idx=filler_idx,
    )
    params, memory, pos = _cast_for_decode(params, memory, pos, compute_dtype)
    return params, memory, mem_mask, pos


def greedy(params: Params, cfg: Config, samples: Masked, *,
           global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
           max_len: int = 128, bos_token: int = 101, eos_token: int = 102,
           compute_dtype=torch.float32, filler_idx=None) -> torch.Tensor:
    """Batched greedy decoding: encode once, then the KV-cached loop. Runs on the
    device the samples are on."""
    params, memory, mem_mask, pos = _encode_for_decode(params, cfg, samples, global_samples, loc_feats,
                                                       compute_dtype, filler_idx)
    return greedy_from_memory(params, cfg, memory, mem_mask, pos, max_len=max_len,
                              bos_token=bos_token, eos_token=eos_token)


def greedy_with_prefix(params: Params, cfg: Config, samples: Masked, prefix: torch.Tensor,
                       prefix_lens: torch.Tensor, *, global_samples: Optional[Masked] = None,
                       loc_feats: Optional[torch.Tensor] = None, max_len: int = 128, bos_token: int = 101,
                       eos_token: int = 102, compute_dtype=torch.float32, filler_idx=None) -> torch.Tensor:
    """Greedy completion of per-row forced prefixes (retr_tpu.decode.greedy_with_prefix).

    prefix [B, P] int32 (0-padded) and prefix_lens [B] int32, on the samples'
    device: positions 1..prefix_lens[b] hold the forced tokens, the rest decodes
    greedily. The forced tokens still go through the decode step (they fill the
    caches); only the argmax is overridden. A forced EOS finishes its row;
    ``prefix_lens`` of zero is exactly ``greedy``. The head is ``mlp_head`` and
    argmax, as in the JAX package (no head kernel)."""
    params, memory, mem_mask, pos = _encode_for_decode(params, cfg, samples, global_samples, loc_feats,
                                                       compute_dtype, filler_idx)
    b, p = prefix.shape
    captions = torch.zeros((b, max_len), dtype=torch.int32, device=memory.device)
    cols = torch.arange(p, device=memory.device)[None, :]
    captions[:, 1:p + 1] = torch.where(cols < prefix_lens[:, None], prefix.to(torch.int32), 0)

    def choose(i, hs, captions):
        forced = i + 1 <= prefix_lens                 # position i+1 is in the prefix
        return torch.where(forced, captions[:, i + 1], _argmax_head(params["mlp"], hs))

    return _token_loop(params, cfg, memory, mem_mask, pos, choose, max_len=max_len, bos_token=bos_token,
                       eos_token=eos_token, captions=captions)


def gumbel_argmax(logits: torch.Tensor, generator: torch.Generator,
                  noise_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One categorical draw per row of ``logits`` [B, N] (f32) by the Gumbel-max
    trick, as ``jax.random.categorical`` draws: argmax(logits - log(-log(u))),
    u uniform on (tiny, 1) from ``generator`` (on the logits' device).

    ``noise_rows=(start, frame)``: these rows are rows start.. of a batch of
    ``frame`` rows; the noise of the whole frame is drawn and these rows'
    kept (rows past the frame, padding, take its last), so a row draws the
    same wherever the batch is split."""
    if noise_rows is None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    else:
        start, frame = noise_rows
        u = torch.rand((frame, logits.shape[1]), generator=generator, device=logits.device, dtype=torch.float32)
        rows = (torch.arange(logits.shape[0], device=logits.device) + start).clamp_(max=frame - 1)
        u = u.index_select(0, rows)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


def _nucleus_keep(sorted_vals: torch.Tensor, top_p: float) -> torch.Tensor:
    """On values sorted largest first: the smallest prefix whose softmax mass
    reaches ``top_p``, and always at least one entry."""
    cum = torch.cumsum(torch.softmax(sorted_vals, dim=-1), dim=-1)
    first = torch.ones_like(cum[:, :1], dtype=torch.bool)
    return torch.cat([first, cum[:, :-1] < top_p], dim=-1)


def sample_tokens(logits: torch.Tensor, generator: torch.Generator, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0,
                  noise_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One token per row of f32 logits [B, V] under temperature, top-k and
    top-p, composed as retr_tpu.decode.sample composes them: argmax exactly when
    ``temperature <= 0`` or ``top_k == 1``; with ``0 < top_k < V`` the draw runs
    on the top-k shortlist (``topk_first``, ``lax.top_k``'s order), cut to its
    nucleus when ``top_p < 1``; otherwise on the full vocabulary, where a
    ``top_p < 1`` cut removes every logit below the nucleus's smallest.
    ``noise_rows``: as :func:`gumbel_argmax`'s."""
    if temperature <= 0.0 or top_k == 1:
        return logits.argmax(dim=-1).to(torch.int32)
    neg_inf = -1e30
    z = logits / temperature
    if 0 < top_k < logits.shape[-1]:
        vals, idx = dk.topk_first(z, top_k)
        if top_p < 1.0:
            vals = torch.where(_nucleus_keep(vals, top_p), vals, neg_inf)
        choice = gumbel_argmax(vals, generator, noise_rows)
        return idx.gather(1, choice[:, None])[:, 0].to(torch.int32)
    if top_p < 1.0:
        sorted_z = z.sort(dim=-1, descending=True).values
        cutoff = torch.where(_nucleus_keep(sorted_z, top_p), sorted_z, float("inf")).amin(dim=-1, keepdim=True)
        z = torch.where(z < cutoff, neg_inf, z)
    return gumbel_argmax(z, generator, noise_rows).to(torch.int32)


def sample(params: Params, cfg: Config, samples: Masked, generator: torch.Generator, *,
           global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
           max_len: int = 128, bos_token: int = 101, eos_token: int = 102, temperature: float = 1.0,
           top_k: int = 0, top_p: float = 1.0, compute_dtype=torch.float32, filler_idx=None,
           noise_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Ancestral sampling with temperature, top-k and nucleus (top-p) filtering
    (retr_tpu.decode.sample; :func:`sample_tokens` composes the filters).

    The greedy loop's write and stop rules; ``generator`` is a ``torch.Generator``
    on the samples' device (the counterpart of the JAX key), and the draws
    stay on the device, so a step does not wait for the host. torch cannot
    reproduce ``jax.random``: the draws match the JAX package's in
    distribution, and exactly where sampling reduces to argmax.
    ``noise_rows=(start, frame)``: the samples are rows start.. of a batch
    of ``frame`` rows, which each step's noise is drawn for (the sharded
    sweep's dp ranks; :func:`gumbel_argmax`)."""
    params, memory, mem_mask, pos = _encode_for_decode(params, cfg, samples, global_samples, loc_feats,
                                                       compute_dtype, filler_idx)

    def choose(i, hs, captions):
        logits = caption.mlp_head(params["mlp"], hs).float()
        return sample_tokens(logits, generator, temperature=temperature, top_k=top_k, top_p=top_p,
                             noise_rows=noise_rows)

    return _token_loop(params, cfg, memory, mem_mask, pos, choose, max_len=max_len, bos_token=bos_token,
                       eos_token=eos_token)


def sequence_scores(params: Params, cfg: Config, samples: Masked, caps: torch.Tensor, cap_masks: torch.Tensor,
                    *, global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
                    compute_dtype=torch.float32, filler_idx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token log-probabilities of given captions (retr_tpu.decode.sequence_scores).

    caps [B, T] int32 (BOS first, 0-padded), cap_masks [B, T] bool (True = pad).
    One teacher-forced forward (input caps[:, :-1], targets caps[:, 1:]),
    log_softmax in f32, gathered at the targets. Returns (logprobs [B, T-1],
    valid [B, T-1]), valid marking real target positions. Under
    ``cfg.use_pallas_attention`` the forward's attention cores run in the
    fused attention kernel."""
    logits = caption.forward(params, cfg, samples, caps[:, :-1], cap_masks[:, :-1],
                             global_samples=global_samples, loc_feats=loc_feats, train=False,
                             compute_dtype=compute_dtype, filler_idx=filler_idx)
    logits = torch.log_softmax(logits.float(), dim=-1)   # [B, T-1, V]; the logits are dropped
    tok_lp = logits.gather(-1, caps[:, 1:, None].long())[..., 0]
    return tok_lp, ~cap_masks[:, 1:]


def greedy_with_attention(params: Params, cfg: Config, samples: Masked, *,
                          global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
                          max_len: int = 128, bos_token: int = 101, eos_token: int = 102,
                          compute_dtype=torch.float32, filler_idx=None):
    """Greedy decode and its attention maps (retr_tpu.decode.greedy_with_attention):
    one teacher-forced forward over the decoded buffer gives every step's
    maps. Returns (ids [B, max_len], atts) with atts keyed ``enc_tc_self_att``,
    ``dec_exp_self_att`` and ``dec_exp_tc_cross_att``, [layers, B, T, S] each.
    The whole call runs with ``use_pallas_attention`` off: the maps come from
    the plain attention core, and the encoder of the greedy half uses it too,
    so the ids and the maps come from one computation and the fused attention
    kernel is never launched."""
    cfg = cfg.replace(use_pallas_attention=False)
    ids = greedy(params, cfg, samples, global_samples=global_samples, loc_feats=loc_feats,
                 max_len=max_len, bos_token=bos_token, eos_token=eos_token, compute_dtype=compute_dtype,
                 filler_idx=filler_idx)
    _, atts = caption.forward(params, cfg, samples, ids, ids == 0, global_samples=global_samples,
                              loc_feats=loc_feats, return_attention=True, compute_dtype=compute_dtype,
                              filler_idx=filler_idx)
    return ids, atts


def _beam_active(scores, finished, fin_len, step: int, *, length_penalty: float,
                 early_stop: bool) -> torch.Tensor:
    """The JAX beam loop's condition on the state after ``step`` steps, as a
    device bool (retr_tpu/decode.py beam_search_from_memory ``cond``; the
    bound ``step < max_len - 1`` is the caller's loop range)."""
    if not early_stop:
        return ~finished.all()
    inf = float("inf")
    all_fin, any_fin = finished.all(dim=-1), finished.any(dim=-1)
    # finished beams' final normalised scores, and the raw score they hold
    fin_norm = scores / fin_len.clamp_min(1.0) ** length_penalty
    worst_fin = torch.where(finished, fin_norm, inf).min(dim=-1, keepdim=True).values
    fin_raw_min = torch.where(finished, scores, inf).min(dim=-1, keepdim=True).values
    # a live beam's best case: finish now (raw log-prob only decreases), in f32
    live = ~finished
    len_lo = torch.tensor(float(step) + 1.0, dtype=torch.float32) ** length_penalty
    can_win = torch.where(live, scores / len_lo, -inf).ge(worst_fin).any(dim=-1)
    can_evict = torch.where(live, scores, -inf).ge(fin_raw_min).any(dim=-1)
    return (~all_fin & (~any_fin | can_win | can_evict)).any()


def beam_search_from_memory(params: Params, cfg: Config, memory, mem_mask, pos, *, max_len: int,
                            bos_token: int, eos_token: int, beam_size: int,
                            length_penalty: float = 1.0, early_stop: bool = True,
                            margins: Optional[list] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search with length normalisation score / length**length_penalty.

    Returns (tokens [B, K, max_len] int32 best first, normalised scores [B, K]).
    Finished beams are frozen (they re-emit EOS at no cost). The self caches are
    never reordered: each beam row writes its own slot, and the [B, K, T]
    ancestry matrix says which row of the group wrote each position
    (transformer.decode_step_beam). ``early_stop`` ends the loop, per batch
    element, once no live beam can outrank the worst finished one (finishing
    now) or evict a finished one under the raw score, as in the JAX package.
    The loop's condition is the whole batch's: under an active mesh it is
    OR-ed over the dp group each step, as the JAX loop's condition is
    all-reduced over a dp-sharded batch, so a dp rank's rows decode as in
    the whole batch.

    ``margins``: if a list, each step appends the [B] gap between the k-th and
    (k+1)-th candidate of the k*k shortlist (a diagnostic for parity checks).
    """
    b = memory.shape[0]
    k = beam_size
    dev = memory.device
    neg_inf = -1e9
    # beams share their element's memory, so the cross K/V are tiled and never
    # reordered; the self caches use ancestry addressing instead of reordering
    mem_t = memory.repeat_interleave(k, dim=0)
    mask_t = mem_mask.repeat_interleave(k, dim=0)
    tparams = transformer.prepare_decoder(params["transformer"])
    cache, cross = transformer.init_decode_state(tparams, mem_t, mask_t, pos, cfg, max_len)

    tokens = torch.zeros((b, k, max_len), dtype=torch.int32, device=dev)
    tokens[:, :, 0] = bos_token
    beams = torch.arange(k, dtype=torch.int32, device=dev)
    scores = torch.where(beams == 0, 0.0, neg_inf).float().expand(b, k).contiguous()
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    fin_len = torch.zeros((b, k), dtype=torch.float32, device=dev)
    anc = torch.zeros((b, k, max_len), dtype=torch.int32, device=dev)
    first_slot = beams == 0
    step = torch.zeros((), dtype=torch.int32, device=dev)
    running = pmesh.any_over_dp(_beam_active(scores, finished, fin_len, 0, length_penalty=length_penalty,
                                             early_stop=early_stop))
    head_p = dk.pack_head(params["mlp"]) if dk.BEAM_TOPK_KERNEL else None
    with matmul_precision(memory.dtype):
        for i in range(max_len - 1):
            if i % CHECK_EVERY == 0 and not bool(running):
                break
            # Steps past the JAX loop's stop still run until the next host check:
            # their carry updates are gated off below, and the cache slots they
            # write (at positions no kept token reaches) are never read by a step
            # whose result is kept.
            anc_i = anc.clone()
            anc_i[:, :, i] = beams          # position i is written by each beam's own row
            hs, cache = transformer.decode_step_beam(tparams, cache, cross, tokens[:, :, i].reshape(b * k),
                                                     step, cfg, anc_i, k)
            if dk.BEAM_TOPK_KERNEL:
                row_scores, row_tokens = dk.mlp_head_topk(head_p, hs, k)
            else:
                row_scores, row_tokens = dk.topk_log_softmax(caption.mlp_head(params["mlp"], hs).float(), k)
            row_scores, row_tokens = row_scores.view(b, k, k), row_tokens.view(b, k, k)

            # finished beams: one EOS continuation at no cost
            fin = finished[:, :, None]
            row_scores = torch.where(fin, torch.where(first_slot, 0.0, neg_inf), row_scores)
            row_tokens = torch.where(fin, eos_token, row_tokens)

            cand = (scores[:, :, None] + row_scores).view(b, k * k)
            if margins is not None:
                top = dk.topk_first(cand, min(k + 1, k * k))[0]
                margins.append(top[:, k - 1] - top[:, -1])
            top_scores, top_idx = dk.topk_first(cand, k)
            beam_idx = top_idx // k
            tok = row_tokens.view(b, k * k).gather(1, top_idx)
            rows = beam_idx[:, :, None].expand(b, k, max_len)
            new_tokens = tokens.gather(1, rows)
            new_tokens[:, :, i + 1] = tok
            prev_fin = finished.gather(1, beam_idx)
            ends = tok == eos_token
            new_fin_len = torch.where(~prev_fin & ends, float(i + 1), fin_len.gather(1, beam_idx))

            tokens = torch.where(running, new_tokens, tokens)
            scores = torch.where(running, top_scores, scores)
            finished = torch.where(running, prev_fin | ends, finished)
            fin_len = torch.where(running, new_fin_len, fin_len)
            anc = torch.where(running, anc_i.gather(1, rows), anc)
            running = running & pmesh.any_over_dp(_beam_active(scores, finished, fin_len, i + 1,
                                                               length_penalty=length_penalty,
                                                               early_stop=early_stop))
            step += 1

    # length-normalised ranking: tokens after BOS up to and including the first EOS
    is_eos = tokens == eos_token
    length = torch.where(is_eos.any(dim=-1), is_eos.int().argmax(dim=-1), max_len - 1).float()
    norm = scores / length.clamp_min(1.0) ** length_penalty
    norm, order = dk.topk_first(norm, k)
    return tokens.gather(1, order[:, :, None].expand(b, k, max_len)), norm


def beam_search(params: Params, cfg: Config, samples: Masked, *,
                global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
                max_len: int = 128, bos_token: int = 101, eos_token: int = 102, beam_size: int = 5,
                length_penalty: float = 1.0, compute_dtype=torch.float32, early_stop: bool = True,
                filler_idx=None):
    """Batched beam search: encode once, then the KV-cached beam loop. Runs on
    the device the samples are on."""
    params, memory, mem_mask, pos = _encode_for_decode(params, cfg, samples, global_samples, loc_feats,
                                                       compute_dtype, filler_idx)
    return beam_search_from_memory(params, cfg, memory, mem_mask, pos, max_len=max_len,
                                   bos_token=bos_token, eos_token=eos_token, beam_size=beam_size,
                                   length_penalty=length_penalty, early_stop=early_stop)


def prune_token_ids(idx_seqs: Sequence[Sequence[int]], clean: bool = True, pad_token: int = 0,
                    bos_token: int = 101, eos_token: int = 102) -> List[List[int]]:
    """Cut each sequence at its first EOS; optionally strip PAD/BOS/EOS."""
    results = []
    for seq in idx_seqs:
        pruned = []
        for idx in seq:
            pruned.append(int(idx))
            if idx == eos_token:
                break
        if clean:
            pruned = [i for i in pruned if i not in (pad_token, bos_token, eos_token)]
        results.append(pruned)
    return results


def greedy_decoding(samples: Masked, params: Params, cfg: Config, tokenizer, *,
                    global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
                    max_len: int = 128, clean: bool = True, pad_token: int = 0, bos_token: int = 101,
                    eos_token: int = 102, compute_dtype=torch.float32) -> List[str]:
    """Decode, prune and detokenize (retr_tpu.decode.greedy_decoding)."""
    ids = greedy(params, cfg, samples, global_samples=global_samples, loc_feats=loc_feats,
                 max_len=max_len, bos_token=bos_token, eos_token=eos_token, compute_dtype=compute_dtype)
    pruned = prune_token_ids(ids.cpu().tolist(), clean=clean, pad_token=pad_token,
                             bos_token=bos_token, eos_token=eos_token)
    return [tokenizer.decode(seq, skip_special_tokens=True) for seq in pruned]


def greedy_single(params: Params, cfg: Config, samples: Masked, tokenizer, **kwargs) -> str:
    """One image's greedy expression (retr_tpu.decode.greedy_single): the
    batched path at batch 1."""
    return greedy_decoding(samples, params, cfg, tokenizer, **kwargs)[0]
