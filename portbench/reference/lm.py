"""The plain reference of the LM decoder, for the card: DeepSeek-V3's
language-model block at the configuration's widths after RE:TR's encoder
memory and Kimi-VL's MLP projector, in float32 with TF32 off.

The LM's modules are ``tests/lm_oracle.py``'s, copied (that file holds them
against the program on the CPU, and notes each departure from the published
description: stacked expert leaves, in-place interleaved RoPE, one expert
group, a finite bias for hidden keys). Here the weights of the whole model
do not fit twice in float32, so :func:`lm_logits` runs the LM a layer at a
time over every judged row: the layer's leaves of the (bfloat16) state dict
are cast to the reference's type, the layer runs, and its copy is dropped.
No cache and no batching trick: each position attends over the whole
sequence, every expert is a step of a loop. The encoder memory is RE:TR's,
computed by ``portbench/reference/model.py``'s modules. Imports nothing of the
measured program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import model as ref_model

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


ENCODER_PREFIXES = ("backbone.", "input_proj.", "loc_proj.", "transformer.encoder.")


def encoder(model_cfg: dict, state_dict: dict, device, dtype=torch.float32) -> ref_model.CaptionModel:
    """RE:TR's encoder modules (``ref_model.CaptionModel``, the decoder and head
    left unloaded and tiny) holding the state dict's encoder leaves."""
    with torch.device("meta"):
        model = ref_model.CaptionModel({**model_cfg, "vocab_size": 1, "dec_layers": 0})
    model = model.to_empty(device=device)
    enc = {k: v for k, v in state_dict.items() if k.startswith(ENCODER_PREFIXES)}
    missing, unexpected = model.load_state_dict(enc, strict=False)
    assert not unexpected and all(k.startswith(("transformer.decoder", "transformer.embeddings", "mlp.")) for k in
                                  missing), missing
    return model.to(dtype).eval()


@torch.no_grad()
def memory(enc: ref_model.CaptionModel, inp: dict) -> tuple:
    """The encoder memory [B, S, C] and its pad mask [B, S] of a
    ``preprocess.batch``."""
    dt = enc.input_proj.weight.dtype
    g = inp.get("g_img")
    src, mask = enc.memory_inputs(inp["img"].to(dt), inp["mask"], None if g is None else g.to(dt),
                                  inp.get("g_mask"), inp.get("loc"))
    t = enc.transformer
    s, bs = src.shape[2], src.shape[0]
    pos = ref_model.sine_table(t.d, s, src.device)[:, None, :].expand(s, bs, t.d).to(dt)
    out = src.permute(2, 0, 1)
    for layer in t.encoder.layers:
        out = layer.ff(layer.self_attn(out, pos, key_padding_mask=mask))
    return t.encoder.norm(out).permute(1, 0, 2), mask


def _module(cls, args, leaves: dict, prefix: str, device, dtype, transform):
    """``cls(*args)`` on ``device`` holding the state dict's leaves under
    ``prefix``, each through ``transform`` and cast to ``dtype``."""
    with torch.device("meta"):
        m = cls(*args).to(dtype)
    m = m.to_empty(device=device)
    m.load_state_dict({k[len(prefix):]: transform(k, v).to(device=device, dtype=dtype) for k, v in leaves.items()
                       if k.startswith(prefix)}, strict=True)
    return m.eval()


@torch.no_grad()
def lm_logits(c: dict, state_dict: dict, mem: torch.Tensor, mem_mask: torch.Tensor, tokens: torch.Tensor, *,
              dtype=torch.float32, transform=lambda name, v: v, routes: list = None, probe=None) -> torch.Tensor:
    """Logits [B, T, vocab] (f32) at the positions of ``tokens`` [B, T] (BOS
    first) after the prefix ``mem`` [B, S, C] (``mem_mask`` True = pad),
    computed in ``dtype`` a layer at a time. ``transform(name, leaf)`` maps
    each leaf first (the control's float8 rounding). ``routes``, a list, gets
    each MoE layer's chosen experts [B, S + T, k]. ``probe(i, moe)`` is
    called after each MoE layer ``i`` with its module, which holds the
    layer's input tokens [B (S + T), D] as ``moe.inp``."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        device = mem.device
        lm = "language_model.model."
        proj = _module(Projector, (mem.shape[-1], c["lm_hidden_size"]), state_dict, "projector.", device, dtype,
                       transform)
        embed = transform(f"{lm}embed_tokens.weight", state_dict[f"{lm}embed_tokens.weight"])
        s = mem.shape[1]
        x = torch.cat([proj(mem.to(dtype)), embed[tokens.long()].to(dtype)], 1)
        n = x.shape[1]
        hidden = torch.zeros(mem.shape[0], n, device=device)
        hidden[:, :s] = torch.where(mem_mask, NEG, 0.0)
        bias = hidden[:, None, :] + torch.full((n, n), NEG, device=device).triu(1)
        for i in range(c["lm_layers"]):
            dense = i < c["lm_first_k_dense_replace"]
            layer = _module(Layer, (c, dense), state_dict, f"{lm}layers.{i}.", device, dtype, transform)
            x = layer(x, bias)
            if routes is not None and not dense:
                routes.append(layer.mlp.chosen)
            if probe is not None and not dense:
                probe(i, layer.mlp)
            del layer
        norm = _module(RMSNorm, (c["lm_hidden_size"], c["lm_rms_norm_eps"]), state_dict, f"{lm}norm.", device,
                       dtype, transform)
        head = transform("language_model.lm_head.weight", state_dict["language_model.lm_head.weight"])
        return F.linear(norm(x[:, s:]), head.to(dtype)).float()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def moe_module(c: dict, state_dict: dict, i: int, device, dtype=torch.float32,
               transform=lambda name, v: v) -> MoE:
    """Layer ``i``'s MoE module, its leaves through ``transform``, in ``dtype``."""
    return _module(MoE, (c,), state_dict, f"language_model.model.layers.{i}.mlp.", device, dtype, transform)


def float8_leaf(name: str, v: torch.Tensor) -> torch.Tensor:
    """The control's rounding: a leaf of two or more dimensions to float8 e4m3
    with a scale per output channel (per row of its last dimension's vectors,
    so per expert and channel for the stacked experts), in bfloat16; other
    leaves in bfloat16."""
    v = v.float()
    if v.dim() >= 2:
        amax = v.abs().amax(-1, keepdim=True).clamp_min(1e-12)
        scale = amax / torch.finfo(torch.float8_e4m3fn).max
        v = (v / scale).to(torch.float8_e4m3fn).float() * scale
    return v.to(torch.bfloat16)
