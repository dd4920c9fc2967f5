"""A language model of DeepSeek-V3's block as the referring-expression decoder
(``Config.decoder_kind == "lm"``; the widths are ``Config.lm_*``, by default
Kimi-VL-A3B-Instruct's language model).

The sequence is the image prefix, then BOS, then the expression. The prefix is
RE:TR's encoder memory (``caption.encode``, 397 tokens for CaptionGlobalLoc)
through Kimi-VL's MLP projector, ``LayerNorm(C) -> Linear(C, D) -> GELU ->
Linear(D, D)``; positions run 0.. along it, and its padding mask is a key mask
for every later query. Each layer is pre-norm (RMSNorm):

- multi-head latent attention with no query low-rank: ``q = W_q x``, ``[c_kv,
  k_pe] = W_kv_a x``, ``c_kv = RMSNorm(c_kv)``, RoPE on ``q_pe`` and on
  ``k_pe`` (one per position, shared by the heads), ``[k_nope, v] = W_kv_b
  c_kv``, scores ``q_nope . k_nope + q_pe . k_pe`` over sqrt(nope + rope),
  causal, ``o_proj``. RoPE rotates interleaved pairs ``(x[2i], x[2i+1])``;
  DeepSeek-V3's modeling de-interleaves both sides first, which permutes the
  rotated vectors alike and leaves every score as it is;
- the first ``lm_first_k_dense_replace`` layers end in a SiLU-gated MLP, the
  others in the MoE layer: the router's sigmoid scores ``s``; the top
  ``lm_num_experts_per_tok`` of ``s + e_score_correction_bias`` are chosen
  (the bias selects only); the weights are the chosen ``s`` normalised to sum
  1, times ``lm_routed_scaling_factor``; SiLU-gated experts, plus the shared
  experts (one SiLU-gated MLP of ``n_shared x expert`` width) on every token.

The decode state is the latent cache alone (:class:`LatentState`): per layer
and position the normed ``c_kv`` and the roped ``k_pe``, ``(kv_lora_rank +
qk_rope_head_dim) x itemsize`` bytes. :func:`prefill` writes the prefix's
slots (a row chunk at a time, so its transients stay small) and
:func:`decode_step` runs one token per row in the absorbed form: the query's
no-RoPE part is taken into the latent space through ``W_kv_b``'s key half,
scores are read against the cached latents, and the weighted latent goes out
through the value half. The MoE layer computes only the routed (token,
expert) pairs: they are sorted by expert on the device and run as grouped
products over the experts' offsets (``torch._grouped_mm``), so no step reads
anything on the host and a step can be captured as a CUDA graph. The
experts' tokens are tallied on the device into ``LatentState.tally``
([MoE layers, experts]), which ``decode.py`` reads once a batch after the
loop, where the tracer records.

Parameters keep the state dict's layouts (``nn.Linear``'s [out, in]; routed
experts stacked [experts, out, in]) and storage: :func:`params_from_state`
makes no copy of a leaf already on the device and in the compute type, so a
state dict of 16 B parameters is held once.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from retr_tpu_torch.config import Config

Params = Dict[str, Any]

STATE_PREFIXES = ("projector.", "language_model.")
PREFILL_ROWS = 128          # rows a prefill chunk runs at once
_NEG = -1e30                # a score's bias where a key is hidden (finite: a padded query stays finite)


# ---------------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------------


def params_from_state(sd, cfg: Config, device=None) -> Params:
    """The LM's and the projector's leaves of a state dict, as they are (moved
    to ``device`` only where they are elsewhere)."""

    def w(name):
        t = sd[name]
        return t if device is None else t.to(device)

    def gated(base, stacked=False):
        sfx = "" if stacked else ".weight"
        return {"gate": w(f"{base}.gate_proj{sfx}"), "up": w(f"{base}.up_proj{sfx}"),
                "down": w(f"{base}.down_proj{sfx}")}

    m = "language_model.model."
    layers = []
    for i in range(cfg.lm_layers):
        b = f"{m}layers.{i}."
        a = f"{b}self_attn."
        lp = {"in_norm": w(f"{b}input_layernorm.weight"), "post_norm": w(f"{b}post_attention_layernorm.weight"),
              "q": w(f"{a}q_proj.weight"), "kv_a": w(f"{a}kv_a_proj_with_mqa.weight"),
              "kv_norm": w(f"{a}kv_a_layernorm.weight"), "kv_b": w(f"{a}kv_b_proj.weight"),
              "o": w(f"{a}o_proj.weight")}
        if i < cfg.lm_first_k_dense_replace:
            lp["mlp"] = gated(f"{b}mlp")
        else:
            lp["moe"] = {"router": w(f"{b}mlp.gate.weight"), "bias": w(f"{b}mlp.gate.e_score_correction_bias"),
                         **gated(f"{b}mlp.experts", stacked=True)}
            if cfg.lm_n_shared_experts:
                lp["moe"]["shared"] = gated(f"{b}mlp.shared_experts")
        layers.append(lp)
    pj = "projector."
    return {"projector": {"norm_w": w(f"{pj}pre_norm.weight"), "norm_b": w(f"{pj}pre_norm.bias"),
                          "w1": w(f"{pj}linear_1.weight"), "b1": w(f"{pj}linear_1.bias"),
                          "w2": w(f"{pj}linear_2.weight"), "b2": w(f"{pj}linear_2.bias")},
            "embed": w(f"{m}embed_tokens.weight"), "layers": layers, "norm": w(f"{m}norm.weight"),
            "head": w("language_model.lm_head.weight")}


def moe_layers(cfg: Config) -> int:
    return cfg.lm_layers - cfg.lm_first_k_dense_replace


# ---------------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------------


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """DeepSeek-V3's RMSNorm: normalised in f32, cast back, then scaled."""
    xf = x.float()
    return w * (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype)


def rope_table(cfg: Config, n: int, device) -> tuple:
    """(cos, sin) [n, rope/2] f32 of positions 0..n-1."""
    d = cfg.lm_qk_rope_head_dim
    inv = 1.0 / cfg.lm_rope_theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None]
    return torch.cos(ang).float().to(device), torch.sin(ang).float().to(device)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved pairs of ``x`` [..., rope] by the angles whose
    cos and sin broadcast against [..., rope/2]; in f32, cast back."""
    xf = x.float().unflatten(-1, (-1, 2))
    a, b = xf[..., 0], xf[..., 1]
    return torch.stack((a * cos - b * sin, a * sin + b * cos), -1).flatten(-2).to(x.dtype)


def project(p: Params, memory: torch.Tensor) -> torch.Tensor:
    """Kimi-VL's MLP projector: [..., C] encoder memory -> [..., D]."""
    x = F.layer_norm(memory, memory.shape[-1:], p["norm_w"], p["norm_b"], eps=1e-5)
    return F.linear(F.gelu(F.linear(x, p["w1"], p["b1"])), p["w2"], p["b2"])


def gated_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return F.linear(F.silu(F.linear(x, p["gate"])) * F.linear(x, p["up"]), p["down"])


def _grouped(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` [P, K] grouped by expert (``offs``: each group's end)
    through their expert's ``w`` [E, N, K] -> [P, N]."""
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)


def route(p: Params, x: torch.Tensor, cfg: Config) -> tuple:
    """(chosen experts [N, k], their weights [N, k] f32) of tokens ``x`` [N, D]."""
    s = F.linear(x.float(), p["router"].float()).sigmoid()
    idx = (s + p["bias"].float()).topk(cfg.lm_num_experts_per_tok, dim=-1).indices
    wts = s.gather(1, idx)
    return idx, wts / (wts.sum(-1, keepdim=True) + 1e-20) * cfg.lm_routed_scaling_factor


def moe(p: Params, x: torch.Tensor, cfg: Config, tally=None) -> torch.Tensor:
    """The MoE layer on tokens ``x`` [N, D]: the routed pairs, sorted by expert,
    through grouped products, weighted and summed per token in f32, plus the
    shared experts. ``tally`` ([experts] int64) gains each expert's pairs."""
    n, d = x.shape
    k = cfg.lm_num_experts_per_tok
    idx, wts = route(p, x, cfg)
    flat = idx.flatten()
    order = flat.argsort(stable=True)
    counts = torch.zeros(cfg.lm_n_routed_experts, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    if tally is not None:
        tally += counts
    offs = counts.cumsum(0).to(torch.int32)
    xs = x.index_select(0, order // k)
    y = _grouped(F.silu(_grouped(xs, p["gate"], offs)) * _grouped(xs, p["up"], offs), p["down"], offs)
    y = torch.empty_like(y).index_copy_(0, order, y)      # back to (token, choice) order
    out = (y.view(n, k, d).float() * wts[..., None]).sum(1)
    if "shared" in p:
        out = out + gated_mlp(p["shared"], x).float()
    return out.to(x.dtype)


def _ffn(lp: Params, h: torch.Tensor, cfg: Config, tally) -> torch.Tensor:
    if "mlp" in lp:
        return gated_mlp(lp["mlp"], h)
    return moe(lp["moe"], h.reshape(-1, h.shape[-1]), cfg, tally).view_as(h)


def _latent(lp: Params, h: torch.Tensor, cos, sin, cfg: Config) -> torch.Tensor:
    """The cache's entry of tokens ``h`` [..., D]: [normed c_kv, roped k_pe]."""
    c, k_pe = F.linear(h, lp["kv_a"]).split([cfg.lm_kv_lora_rank, cfg.lm_qk_rope_head_dim], -1)
    return torch.cat([rms_norm(lp["kv_norm"], c, cfg.lm_rms_norm_eps), rope(k_pe, cos, sin)], -1)


def _queries(lp: Params, h: torch.Tensor, cos, sin, cfg: Config) -> tuple:
    """(q_nope [..., H, nope], roped q_pe [..., H, rope]) of tokens ``h`` [..., D];
    cos and sin broadcast against [..., 1, rope/2]."""
    nope, r = cfg.lm_qk_nope_head_dim, cfg.lm_qk_rope_head_dim
    q = F.linear(h, lp["q"]).unflatten(-1, (cfg.lm_heads, nope + r))
    q_nope, q_pe = q.split([nope, r], -1)
    return q_nope, rope(q_pe, cos[..., None, :], sin[..., None, :])


def _scale(cfg: Config) -> float:
    return 1.0 / math.sqrt(cfg.lm_qk_nope_head_dim + cfg.lm_qk_rope_head_dim)


def attend_full(lp: Params, h: torch.Tensor, cos, sin, bias: torch.Tensor, cfg: Config) -> tuple:
    """Attention of a whole sequence in the plain form: ``h`` [b, n, D] normed,
    ``bias`` [b, n, n] f32 (0 or hidden) -> (output [b, n, D], latents [b, n,
    kv_lora + rope])."""
    b, n, _ = h.shape
    heads, nope, dv = cfg.lm_heads, cfg.lm_qk_nope_head_dim, cfg.lm_v_head_dim
    q_nope, q_pe = _queries(lp, h, cos, sin, cfg)
    lat = _latent(lp, h, cos, sin, cfg)
    k_nope, v = F.linear(lat[..., :cfg.lm_kv_lora_rank], lp["kv_b"]).unflatten(-1, (heads, nope + dv)).split(
        [nope, dv], -1)
    s = q_nope.transpose(1, 2) @ k_nope.permute(0, 2, 3, 1)              # [b, H, n, n]
    s = s + q_pe.transpose(1, 2) @ lat[:, None, :, cfg.lm_kv_lora_rank:].transpose(-1, -2)
    pr = (s.float() * _scale(cfg) + bias[:, None]).softmax(-1).to(h.dtype)
    o = (pr @ v.transpose(1, 2)).transpose(1, 2).reshape(b, n, heads * dv)
    return F.linear(o, lp["o"]), lat


def attend_cached(lp: Params, h: torch.Tensor, cache: torch.Tensor, pos: torch.Tensor, cos, sin,
                  bias: torch.Tensor, cfg: Config) -> torch.Tensor:
    """One token per row in the absorbed form: ``h`` [B, D] normed at
    position ``pos`` (a device int), whose latent is written into ``cache``
    [B, T, kv_lora + rope] first; ``bias`` [B, T] f32 hides the slots past
    ``pos`` and the prefix's padding."""
    bsz = h.shape[0]
    heads, nope, dv, r = cfg.lm_heads, cfg.lm_qk_nope_head_dim, cfg.lm_v_head_dim, cfg.lm_kv_lora_rank
    q_nope, q_pe = _queries(lp, h, cos, sin, cfg)                       # [B, H, nope], [B, H, rope]
    cache.index_copy_(1, pos.view(1).long(), _latent(lp, h, cos, sin, cfg)[:, None])
    wkv = lp["kv_b"].view(heads, nope + dv, r)
    q_lat = torch.bmm(q_nope.transpose(0, 1), wkv[:, :nope]).transpose(0, 1)   # [B, H, r]
    s = torch.bmm(torch.cat([q_lat, q_pe], -1), cache.transpose(1, 2))         # [B, H, T]
    pr = (s.float() * _scale(cfg) + bias[:, None]).softmax(-1).to(h.dtype)
    o_lat = torch.bmm(pr, cache[..., :r])                                      # [B, H, r]
    o = torch.bmm(o_lat.transpose(0, 1), wkv[:, nope:].transpose(1, 2))        # [H, B, dv]
    return F.linear(o.transpose(0, 1).reshape(bsz, heads * dv), lp["o"])


def logits(p: Params, hs: torch.Tensor) -> torch.Tensor:
    """The head over the final norm's output: [..., vocab] in the compute type."""
    return F.linear(hs, p["head"])


# ---------------------------------------------------------------------------------
# The teacher-forced forward, held against the plain reference by the tests
# ---------------------------------------------------------------------------------


def _key_bias(mem_mask: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] f32: hidden at the prefix's padding, 0 elsewhere."""
    bias = torch.zeros((mem_mask.shape[0], n), dtype=torch.float32, device=mem_mask.device)
    bias[:, :mem_mask.shape[1]].masked_fill_(mem_mask, _NEG)
    return bias


def _causal(n: int, device) -> torch.Tensor:
    return torch.full((n, n), _NEG, device=device).triu(1)


def forward(p: Params, memory: torch.Tensor, mem_mask: torch.Tensor, tokens: torch.Tensor,
            cfg: Config) -> torch.Tensor:
    """Logits [B, T, vocab] (f32) at the positions of ``tokens`` [B, T] (BOS
    first) after the projected prefix ``memory`` [B, S, C]."""
    s = memory.shape[1]
    x = torch.cat([project(p["projector"], memory), F.embedding(tokens.long(), p["embed"])], 1)
    n = x.shape[1]
    cos, sin = rope_table(cfg, n, x.device)
    bias = _key_bias(mem_mask, n)[:, None, :] + _causal(n, x.device)
    for lp in p["layers"]:
        o, _ = attend_full(lp, rms_norm(lp["in_norm"], x, cfg.lm_rms_norm_eps), cos, sin, bias, cfg)
        x = x + o
        x = x + _ffn(lp, rms_norm(lp["post_norm"], x, cfg.lm_rms_norm_eps), cfg, None)
    return logits(p, rms_norm(p["norm"], x[:, s:], cfg.lm_rms_norm_eps)).float()


# ---------------------------------------------------------------------------------
# The cached decode
# ---------------------------------------------------------------------------------


class LatentState(NamedTuple):
    """The decode loop's carries of the LM: ``cache`` [layers, B, T, kv_lora +
    rope] in the compute type, T the first multiple of 8 from S + max_len;
    ``key_bias`` [B, T] f32
    (the prefix's padding); ``tally`` [MoE layers, experts] int64, the pairs
    routed to each expert since the prologue; the RoPE table (cos, sin)."""
    cache: torch.Tensor
    key_bias: torch.Tensor
    tally: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor


def alloc_state(cfg: Config, rows: int, mem_len: int, max_len: int, dtype, device) -> LatentState:
    """The carries for ``mem_len`` prefix positions and ``max_len`` tokens. The
    cache's length is rounded up to a multiple of 8, so that the step's
    products over it take aligned operands (at 397 + 32 = 429 slots cuBLAS
    ran them in its unaligned kernels); the slots past the last position are
    hidden like any later slot, and stay zero."""
    t = -(-(mem_len + max_len) // 8) * 8
    cos, sin = rope_table(cfg, t, device)
    return LatentState(
        torch.zeros((cfg.lm_layers, rows, t, cfg.lm_kv_lora_rank + cfg.lm_qk_rope_head_dim), dtype=dtype,
                    device=device),
        torch.zeros((rows, t), dtype=torch.float32, device=device),
        torch.zeros((moe_layers(cfg), cfg.lm_n_routed_experts), dtype=torch.int64, device=device),
        cos, sin)


def _tally_of(state: LatentState, cfg: Config, layer: int):
    j = layer - cfg.lm_first_k_dense_replace
    return state.tally[j] if j >= 0 else None


def prefill(p: Params, memory: torch.Tensor, mem_mask: torch.Tensor, cfg: Config, state: LatentState) -> None:
    """The prologue: the projected prefix through every layer, ``PREFILL_ROWS``
    rows at a time, its latents written to cache slots 0..S-1 of each layer.
    The last layer's output at the prefix feeds nothing (the first step's
    input is BOS), so that layer computes the latents alone."""
    b, s = mem_mask.shape
    state.key_bias.copy_(_key_bias(mem_mask, state.key_bias.shape[1]))
    state.tally.zero_()
    cos, sin = state.cos[:s], state.sin[:s]
    causal = _causal(s, memory.device)
    last = len(p["layers"]) - 1
    for r0 in range(0, b, PREFILL_ROWS):
        rows = slice(r0, min(r0 + PREFILL_ROWS, b))
        x = project(p["projector"], memory[rows])
        bias = state.key_bias[rows, None, :s] + causal
        for li, lp in enumerate(p["layers"]):
            h = rms_norm(lp["in_norm"], x, cfg.lm_rms_norm_eps)
            if li == last:
                state.cache[li, rows, :s] = _latent(lp, h, cos, sin, cfg)
                break
            o, lat = attend_full(lp, h, cos, sin, bias, cfg)
            state.cache[li, rows, :s] = lat
            x = x + o
            x = x + _ffn(lp, rms_norm(lp["post_norm"], x, cfg.lm_rms_norm_eps), cfg, _tally_of(state, cfg, li))


def decode_step(p: Params, state: LatentState, tokens: torch.Tensor, step: torch.Tensor, mem_len: int,
                cfg: Config) -> torch.Tensor:
    """One token per row (``tokens`` [B], at position ``mem_len + step``, a
    device int32): every layer writes its latent slot and attends over the
    cache. Returns the final norm's output [B, D]."""
    pos = step + mem_len
    cos, sin = state.cos.index_select(0, pos.view(1)), state.sin.index_select(0, pos.view(1))
    slots = torch.arange(state.key_bias.shape[1], device=tokens.device)
    bias = state.key_bias + torch.where(slots <= pos, 0.0, _NEG)
    x = F.embedding(tokens.long(), p["embed"])
    for li, lp in enumerate(p["layers"]):
        x = x + attend_cached(lp, rms_norm(lp["in_norm"], x, cfg.lm_rms_norm_eps), state.cache[li], pos, cos, sin,
                              bias, cfg)
        x = x + _ffn(lp, rms_norm(lp["post_norm"], x, cfg.lm_rms_norm_eps), cfg, _tally_of(state, cfg, li))
    return rms_norm(p["norm"], x, cfg.lm_rms_norm_eps)
