"""Test-only plain reference of the LM decoder (``Config.decoder_kind == "lm"``):
DeepSeek-V3's language-model block, as Kimi-VL-A3B-Instruct configures it,
after RE:TR's encoder memory and Kimi-VL's MLP projector.

Plain float32 ``torch``: no cache, no batching trick, every expert a step of a
loop over the experts, TF32 off. It imports neither package nor JAX; the
encoder memory comes from ``tests/torch_oracle.py``'s RE:TR modules. The module
names are the state dict's, so a state dict loads strictly.

Written from DeepSeek-V3's published modeling (``modeling_deepseek.py``) and
Kimi-VL's projector; each departure is noted where it is made:

- the routed experts are stacked per layer (``mlp.experts.{gate,up,down}_proj``,
  [experts, out, in]) where the published checkpoint names each expert apart;
  expert ``e`` is row ``e`` of each stack;
- RoPE rotates interleaved pairs in place, where the published code
  de-interleaves q_pe and k_pe first: the same rotation, and the same scores;
- ``n_group`` = ``topk_group`` = 1 (Kimi-VL's values), so the group-limited
  selection of ``noaux_tc`` is the plain top-k;
- a hidden key takes a bias of -1e30, not -inf, so a query whose keys are all
  padding (a padded prefix position, whose output no other position reads)
  stays finite.

    model = LMOracle(cfg_dict)            # the Config's keys (lm_*, hidden_dim, vocab_size)
    model.load_state_dict(sd_subset)      # projector.* and language_model.*
    logits = model(memory, mem_mask, tokens)   # [B, T, vocab]
"""

from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F
from torch import nn

NEG = -1e30


class RMSNorm(nn.Module):
    def __init__(self, d, eps):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        return self.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))


class Gated(nn.Module):
    """A SiLU-gated MLP (the dense layers and the shared experts)."""

    def __init__(self, d, f):
        super().__init__()
        self.gate_proj = nn.Linear(d, f, bias=False)
        self.up_proj = nn.Linear(d, f, bias=False)
        self.down_proj = nn.Linear(f, d, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Experts(nn.Module):
    """The routed experts, stacked (departure: the published names split them)."""

    def __init__(self, n, d, f):
        super().__init__()
        self.gate_proj = nn.Parameter(torch.empty(n, f, d))
        self.up_proj = nn.Parameter(torch.empty(n, f, d))
        self.down_proj = nn.Parameter(torch.empty(n, d, f))

    def expert(self, e, x):
        return F.linear(F.silu(F.linear(x, self.gate_proj[e])) * F.linear(x, self.up_proj[e]), self.down_proj[e])


class Gate(nn.Module):
    def __init__(self, n, d):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, d))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(n))


class MoE(nn.Module):
    def __init__(self, c):
        super().__init__()
        d, f = c["lm_hidden_size"], c["lm_moe_intermediate_size"]
        self.k, self.scale = c["lm_num_experts_per_tok"], c["lm_routed_scaling_factor"]
        self.gate = Gate(c["lm_n_routed_experts"], d)
        self.experts = Experts(c["lm_n_routed_experts"], d, f)
        self.shared_experts = Gated(d, f * c["lm_n_shared_experts"]) if c["lm_n_shared_experts"] else None

    def route(self, x):
        """noaux_tc with one group: sigmoid scores, top-k of scores + bias,
        weights the chosen scores normalised (norm_topk_prob), scaled."""
        s = F.linear(x, self.gate.weight).sigmoid()
        idx = (s + self.gate.e_score_correction_bias).topk(self.k, dim=-1).indices
        w = s.gather(-1, idx)
        return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * self.scale

    def routed(self, x):
        """(the routed experts' weighted sum of tokens ``x`` [N, D], the chosen
        experts [N, k]): a step of a loop for each expert."""
        idx, w = self.route(x)
        out = torch.zeros_like(x)
        for e in range(self.experts.gate_proj.shape[0]):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if len(tok):
                out.index_add_(0, tok, self.experts.expert(e, x[tok]) * w[tok, slot, None])
        return out, idx

    def forward(self, x):
        shape = x.shape
        self.inp = x = x.reshape(-1, shape[-1])
        out, idx = self.routed(x)
        self.chosen = idx.view(*shape[:-1], self.k)
        if self.shared_experts is not None:
            out = out + self.shared_experts(x)
        return out.view(shape)


def rope(x, pos, dim, theta):
    """Interleaved pairs (x[2i], x[2i+1]) of ``x`` [..., n, (H,) dim] rotated
    by pos * theta^(-2i/dim) (departure: in place, not de-interleaved)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64, device=x.device) / dim)
    ang = pos.double()[:, None] * inv[None]
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    if x.dim() == 4:                                    # [B, n, H, dim]
        cos, sin = cos[:, None], sin[:, None]
    a, b = x.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack((a * cos - b * sin, a * sin + b * cos), -1).flatten(-2)


class MLA(nn.Module):
    def __init__(self, c):
        super().__init__()
        d, h = c["lm_hidden_size"], c["lm_heads"]
        self.h, self.nope, self.r = h, c["lm_qk_nope_head_dim"], c["lm_qk_rope_head_dim"]
        self.rank, self.dv, self.theta = c["lm_kv_lora_rank"], c["lm_v_head_dim"], c["lm_rope_theta"]
        self.q_proj = nn.Linear(d, h * (self.nope + self.r), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, self.rank + self.r, bias=False)
        self.kv_a_layernorm = RMSNorm(self.rank, c["lm_rms_norm_eps"])
        self.kv_b_proj = nn.Linear(self.rank, h * (self.nope + self.dv), bias=False)
        self.o_proj = nn.Linear(h * self.dv, d, bias=False)

    def forward(self, x, bias):
        b, n, _ = x.shape
        pos = torch.arange(n, device=x.device)
        q = self.q_proj(x).view(b, n, self.h, self.nope + self.r)
        q_nope, q_pe = q.split([self.nope, self.r], -1)
        q_pe = rope(q_pe, pos, self.r, self.theta)
        c, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, self.r], -1)
        k_pe = rope(k_pe, pos, self.r, self.theta)
        k_nope, v = self.kv_b_proj(self.kv_a_layernorm(c)).view(b, n, self.h, self.nope + self.dv).split(
            [self.nope, self.dv], -1)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(b, n, self.h, self.r)], -1)
        q = torch.cat([q_nope, q_pe], -1)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.nope + self.r) + bias[:, None]
        o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1).to(v.dtype), v)
        return self.o_proj(o.reshape(b, n, self.h * self.dv))


class Layer(nn.Module):
    def __init__(self, c, dense):
        super().__init__()
        d, eps = c["lm_hidden_size"], c["lm_rms_norm_eps"]
        self.input_layernorm = RMSNorm(d, eps)
        self.self_attn = MLA(c)
        self.post_attention_layernorm = RMSNorm(d, eps)
        self.mlp = Gated(d, c["lm_intermediate_size"]) if dense else MoE(c)

    def forward(self, x, bias):
        x = x + self.self_attn(self.input_layernorm(x), bias)
        return x + self.mlp(self.post_attention_layernorm(x))


class Projector(nn.Module):
    """Kimi-VL's MLP projector with RE:TR's memory width in."""

    def __init__(self, c_in, d):
        super().__init__()
        self.pre_norm = nn.LayerNorm(c_in, eps=1e-5)
        self.linear_1 = nn.Linear(c_in, d)
        self.linear_2 = nn.Linear(d, d)

    def forward(self, x):
        return self.linear_2(F.gelu(self.linear_1(self.pre_norm(x))))


class Model(nn.Module):
    def __init__(self, c):
        super().__init__()
        d = c["lm_hidden_size"]
        self.embed_tokens = nn.Embedding(c["vocab_size"], d)
        self.layers = nn.ModuleList(Layer(c, i < c["lm_first_k_dense_replace"]) for i in range(c["lm_layers"]))
        self.norm = RMSNorm(d, c["lm_rms_norm_eps"])


class LanguageModel(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.model = Model(c)
        self.lm_head = nn.Linear(c["lm_hidden_size"], c["vocab_size"], bias=False)


class LMOracle(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.projector = Projector(c["hidden_dim"], c["lm_hidden_size"])
        self.language_model = LanguageModel(c)

    @torch.no_grad()
    def forward(self, memory, mem_mask, tokens):
        """memory [B, S, C] (RE:TR's encoder output), mem_mask [B, S] (True =
        pad), tokens [B, T] (BOS first) -> logits [B, T, vocab] at the tokens'
        positions; the prefix is positions 0..S-1, causal throughout."""
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            lm = self.language_model.model
            s = memory.shape[1]
            x = torch.cat([self.projector(memory.float()), lm.embed_tokens(tokens.long())], 1)
            n = x.shape[1]
            hidden = torch.zeros(memory.shape[0], n)
            hidden[:, :s] = torch.where(mem_mask, NEG, 0.0)
            bias = hidden[:, None, :] + torch.full((n, n), NEG).triu(1)
            for layer in lm.layers:
                x = layer(x, bias.to(x.device))
            return self.language_model.lm_head(lm.norm(x[:, s:]))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def encoder_memory(oracle_caption_model, img, img_mask, g_img=None, g_mask=None, loc=None):
    """RE:TR's encoder memory [B, S, C] and mask [B, S] from a
    ``tests.torch_oracle.CaptionModel`` (the encoder half of its forward:
    CaptionGlobalLoc when ``g_img`` is given, else Caption)."""
    m = oracle_caption_model
    src, mask = m._features(img, img_mask)
    if g_img is not None:
        loc_src = m.loc_proj(loc.unsqueeze(2)).permute(0, 2, 1)
        src = torch.cat([src, loc_src], 2)
        mask = torch.cat([mask, torch.zeros(loc.shape, dtype=torch.bool)], 1)
        g_src, g_m = m._features(g_img, g_mask)
        src, mask = torch.cat([src, g_src], 2), torch.cat([mask, g_m], 1)
    t = m.transformer
    bs, _, s = src.shape
    sine_table = sys.modules[type(t).__module__].sine_table      # the oracle's own table
    pos = sine_table(t.d)[:s][:, None, :].expand(s, bs, t.d)
    out = src.permute(2, 0, 1)
    for layer in t.encoder.layers:
        out, _ = layer(out, pos, mask)
    if t.encoder.norm is not None:
        out = t.encoder.norm(out)
    return out.permute(1, 0, 2), mask
