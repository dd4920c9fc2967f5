"""The plain reference model: RE:TR's caption model in plain PyTorch.

A frozen copy of the repository's test oracle (a FrozenBatchNorm ResNet with
torchvision semantics, the pre-norm ConcatTransformer on
``nn.MultiheadAttention``, ``DecoderEmbeddings`` and the MLP head), made
device-aware and given the full variant matrix of RE:TR's ``models/caption.py``:
``Caption`` (target patches only), ``CaptionLoc`` (one token of the five
location features) and ``CaptionGlobalLoc`` (one token per location scalar and
a separately computed context stream, ``caption.py:98-158``).

It follows the published description in float32 with no kernels, caches or
batching tricks; the state dict uses the reference model's module names, so the
benchmark's weights load into it strictly. Departures from the published code:
the MLP head's hidden width is RE:TR's 512 at every model width; CaptionLoc's
``Linear(7, d)`` is ``Linear(5, d)`` (the reference computes five features and
its own ``Linear(7, ...)`` crashes on them). Dropout draws come from the caller:
see :mod:`portbench.reference.train`.

Imports nothing of the measured program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
MLP_HIDDEN = 512


class FrozenBatchNorm2d(nn.Module):
    """Affine-only BN with eps added before rsqrt (RE:TR models/backbone.py:41-51)."""

    def __init__(self, n):
        super().__init__()
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        scale = self.weight * (self.running_var + BN_EPS).rsqrt()
        bias = self.bias - self.running_mean * scale
        return x * scale.reshape(1, -1, 1, 1).to(x.dtype) + bias.reshape(1, -1, 1, 1).to(x.dtype)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, dilation=1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, dilation=1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=dilation, dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + identity)


SPECS = {
    "ResNet18": (BasicBlock, [2, 2, 2, 2]),
    "ResNet34": (BasicBlock, [3, 4, 6, 3]),
    "ResNet50": (Bottleneck, [3, 4, 6, 3]),
    "ResNet101": (Bottleneck, [3, 4, 23, 3]),
}

# the backbone leaves RE:TR trains (models/backbone.py: layer2-4 with lr_backbone;
# the stem, layer1 and every frozen BatchNorm buffer stay fixed)
TRAINED_BACKBONE_STAGES = ("layer2", "layer3", "layer4")


class ResNet(nn.Module):
    """torchvision-semantics ResNet trunk through layer4 (no pooling head)."""

    def __init__(self, name="ResNet101", dilation=True):
        super().__init__()
        block, layers = SPECS[name]
        self.inplanes, self.dilation = 64, 1
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2, dilate=dilation)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        downsample = None
        previous_dilation = self.dilation
        if dilate:
            self.dilation *= stride
            stride = 1
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * block.expansion, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample, previous_dilation)]
        self.inplanes = planes * block.expansion
        layers += [block(self.inplanes, planes, dilation=self.dilation) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def with_pos(t, pos):
    return t if pos is None else t + pos


class Drops:
    """Where dropout masks come from: ``None`` for every site at evaluation;
    in training, an object whose ``mask(site, shape, device)`` returns the
    keep-mask of that site (see :mod:`portbench.reference.train`)."""


def _drop(x, drops, site, rate):
    if drops is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(drops.mask(site, x.shape, x.device), x / keep, 0.0).to(x.dtype)


def attention(mha: nn.MultiheadAttention, q, k, v, *, key_padding_mask=None, attn_mask=None,
              drops=None, site=None, rate=0.0):
    """``nn.MultiheadAttention``'s arithmetic on [S, B, E] inputs, written out so
    that attention dropout can take the caller's mask: project, scale q, add the
    masks as -inf, softmax, drop, weight, merge, out-project."""
    sq, b, e = q.shape
    h = mha.num_heads
    d = e // h
    w, bias = mha.in_proj_weight, mha.in_proj_bias
    qp = F.linear(q, w[:e], bias[:e])
    kp = F.linear(k, w[e:2 * e], bias[e:2 * e])
    vp = F.linear(v, w[2 * e:], bias[2 * e:])

    def heads(x):  # [S, B, E] -> [B, H, S, D]
        return x.reshape(x.shape[0], b, h, d).permute(1, 2, 0, 3)

    scores = (heads(qp) * d ** -0.5) @ heads(kp).transpose(-2, -1)
    if attn_mask is not None:
        scores = scores + attn_mask
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    probs = _drop(torch.softmax(scores, dim=-1), drops, site, rate)
    out = (probs @ heads(vp)).permute(2, 0, 1, 3).reshape(sq, b, e)
    return F.linear(out, mha.out_proj.weight, mha.out_proj.bias)


class SelfAttRes(nn.Module):
    def __init__(self, d, h):
        super().__init__()
        self.sublayer = nn.MultiheadAttention(d, h)
        self.norm = nn.LayerNorm(d)

    def forward(self, x, pos, key_padding_mask=None, attn_mask=None, drops=None, site="", rate=0.0):
        nx = self.norm(x)
        q = k = with_pos(nx, pos)
        out = attention(self.sublayer, q, k, nx, key_padding_mask=key_padding_mask, attn_mask=attn_mask,
                        drops=drops, site=site + ".probs", rate=rate)
        return x + _drop(out, drops, site + ".out", rate)


class CrossAttRes(nn.Module):
    def __init__(self, d, h):
        super().__init__()
        self.sublayer = nn.MultiheadAttention(d, h)
        self.norm = nn.LayerNorm(d)

    def forward(self, q, kv, q_pos, k_pos, key_padding_mask=None, drops=None, site="", rate=0.0):
        nq = self.norm(q)
        out = attention(self.sublayer, with_pos(nq, q_pos), with_pos(kv, k_pos), kv,
                        key_padding_mask=key_padding_mask, drops=drops, site=site + ".probs", rate=rate)
        return q + _drop(out, drops, site + ".out", rate)


class FFRes(nn.Module):
    def __init__(self, d, dff):
        super().__init__()
        self.sublayer = nn.Sequential(nn.Linear(d, dff), nn.ReLU(), nn.Linear(dff, d))
        self.norm = nn.LayerNorm(d)

    def forward(self, x, drops=None, site="", rate=0.0):
        return x + _drop(self.sublayer(self.norm(x)), drops, site + ".out", rate)


class EncLayer(nn.Module):
    def __init__(self, d, h, dff):
        super().__init__()
        self.self_attn = SelfAttRes(d, h)
        self.ff = FFRes(d, dff)


class DecLayer(nn.Module):
    def __init__(self, d, h, dff):
        super().__init__()
        self.tgt_self_attn = SelfAttRes(d, h)
        self.tgt_src_cross_attn = CrossAttRes(d, h)
        self.ff = FFRes(d, dff)


class Stack(nn.Module):
    def __init__(self, layers, d):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(d)


class DecoderEmbeddings(nn.Module):
    def __init__(self, vocab, d, max_pos, ln_eps):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, d)
        self.position_embeddings = nn.Embedding(max_pos, d)
        self.LayerNorm = nn.LayerNorm(d, eps=ln_eps)

    def forward(self, x):
        ids = torch.arange(x.shape[1], device=x.device).unsqueeze(0).expand(x.shape)
        return self.LayerNorm(self.word_embeddings(x) + self.position_embeddings(ids))


def sine_table(d_model, n, device):
    """The first ``n`` rows of the sine position table (max_len 1024)."""
    position = torch.arange(n, device=device, dtype=torch.float32).unsqueeze(1)
    div = torch.exp(torch.arange(0, d_model, 2, device=device, dtype=torch.float32)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros(n, d_model, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def causal_mask(sz, device):
    return torch.zeros(sz, sz, device=device).masked_fill(
        torch.triu(torch.ones(sz, sz, device=device, dtype=torch.bool), diagonal=1), float("-inf"))


class ConcatTransformer(nn.Module):
    def __init__(self, vocab, d, h, nenc, ndec, dff, max_pos, ln_eps, dropout):
        super().__init__()
        self.encoder = Stack([EncLayer(d, h, dff) for _ in range(nenc)], d)
        self.decoder = Stack([DecLayer(d, h, dff) for _ in range(ndec)], d)
        self.embeddings = DecoderEmbeddings(vocab, d, max_pos, ln_eps)
        self.d, self.rate = d, dropout

    def forward(self, src, mask, tgt, tgt_mask, drops=None):
        """src [B, C, S] features, mask [B, S] (True = pad), tgt [B, T] ids,
        tgt_mask [B, T] (True = pad) -> [T, B, C]."""
        bs, _, s = src.shape
        rate = self.rate if drops is not None else 0.0
        pos = sine_table(self.d, s, src.device)[:, None, :].expand(s, bs, self.d).to(src.dtype)
        out = src.permute(2, 0, 1)
        for i, layer in enumerate(self.encoder.layers):
            out = layer.self_attn(out, pos, key_padding_mask=mask, drops=drops, site=f"enc{i}.self", rate=rate)
            out = layer.ff(out, drops=drops, site=f"enc{i}.ff", rate=rate)
        memory = self.encoder.norm(out)

        x = _drop(self.embeddings(tgt), drops, "embed", rate).permute(1, 0, 2)
        t = x.shape[0]
        query_pos = self.embeddings.position_embeddings.weight[:t].unsqueeze(1).expand(t, bs, self.d)
        causal = causal_mask(t, src.device).to(src.dtype)
        for i, layer in enumerate(self.decoder.layers):
            x = layer.tgt_self_attn(x, query_pos, key_padding_mask=tgt_mask, attn_mask=causal,
                                    drops=drops, site=f"dec{i}.self", rate=rate)
            x = layer.tgt_src_cross_attn(x, memory, query_pos, pos, key_padding_mask=mask,
                                         drops=drops, site=f"dec{i}.cross", rate=rate)
            x = layer.ff(x, drops=drops, site=f"dec{i}.ff", rate=rate)
        return self.decoder.norm(x)


class MLP(nn.Module):
    def __init__(self, d_in, d_h, d_out):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(d_in, d_h), nn.Linear(d_h, d_h), nn.Linear(d_h, d_out)])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = F.relu(layer(x)) if i < len(self.layers) - 1 else layer(x)
        return x


class Body(nn.Module):
    """RE:TR's BackboneBase nesting: state-dict keys ``backbone.body.*``."""

    def __init__(self, name, dilation):
        super().__init__()
        self.body = ResNet(name, dilation)


class CaptionModel(nn.Module):
    """RE:TR's Caption / CaptionLoc / CaptionGlobalLoc by ``(use_global, use_loc)``."""

    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["hidden_dim"]
        self.backbone = Body(cfg["backbone"], cfg["dilation"])
        nc = 512 if cfg["backbone"] in ("ResNet18", "ResNet34") else 2048
        self.input_proj = nn.Conv2d(nc, d, kernel_size=1)
        self.transformer = ConcatTransformer(cfg["vocab_size"], d, cfg["nheads"], cfg["enc_layers"],
                                             cfg["dec_layers"], cfg["dim_feedforward"],
                                             cfg["max_position_embeddings"], cfg["layer_norm_eps"],
                                             cfg["dropout"])
        self.mlp = MLP(d, MLP_HIDDEN, cfg["vocab_size"])
        self.use_global, self.use_loc = cfg["use_global_features"], cfg["use_location_features"]
        if self.use_global and not self.use_loc:
            raise NotImplementedError("global features without location features (as in RE:TR)")
        if self.use_loc:
            self.loc_proj = nn.Linear(1 if self.use_global else cfg["num_location_features"], d)

    def features(self, img, img_mask):
        """Backbone, 1x1 projection and the pixel mask resized (nearest) to the
        feature map: ([B, d, h*w], [B, h*w])."""
        feats = self.backbone.body(img)
        src = self.input_proj(feats.to(self.input_proj.weight.dtype)).flatten(2)
        fmask = F.interpolate(img_mask[None].float(), size=feats.shape[-2:]).to(torch.bool)[0]
        return src, fmask.flatten(1)

    def memory_inputs(self, img, img_mask, g_img=None, g_mask=None, loc=None):
        """The encoder's input sequence and its pad mask for this variant."""
        src, mask = self.features(img, img_mask)
        if self.use_loc:
            loc = loc.to(self.loc_proj.weight.dtype)
            if self.use_global:
                loc_src = self.loc_proj(loc.unsqueeze(2)).permute(0, 2, 1)      # one token per scalar
            else:
                loc_src = self.loc_proj(loc).unsqueeze(-1)
            src = torch.cat([src, loc_src], 2)
            mask = torch.cat([mask, torch.zeros(loc_src.shape[0], loc_src.shape[2], dtype=torch.bool,
                                                device=mask.device)], 1)
        if self.use_global:
            g_src, g_m = self.features(g_img, g_mask)
            src, mask = torch.cat([src, g_src], 2), torch.cat([mask, g_m], 1)
        return src, mask

    def forward(self, img, img_mask, caps, cap_mask, *, g_img=None, g_mask=None, loc=None, drops=None):
        """Teacher-forced logits [B, T, vocab] in float32 (computed in the
        dtype the model is held in)."""
        dt = self.input_proj.weight.dtype
        img = img.to(dt)
        g_img = None if g_img is None else g_img.to(dt)
        src, mask = self.memory_inputs(img, img_mask, g_img, g_mask, loc)
        hs = self.transformer(src, mask, caps, cap_mask, drops=drops)
        return self.mlp(hs.permute(1, 0, 2)).float()


def build(cfg: dict, state_dict, device, dtype=torch.float32) -> CaptionModel:
    """The reference model on ``device`` holding ``state_dict`` (strict: every
    name and shape must match), its leaves in ``dtype``."""
    with torch.device("meta"):
        model = CaptionModel(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.to(dtype).eval()
