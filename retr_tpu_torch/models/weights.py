"""Weight bridge: reference-named state dicts <-> the port's parameter tree.

The state dict uses the reference model's module names (``backbone.body.*``,
``input_proj.*``, ``transformer.*``, ``mlp.layers.N.*``, ``loc_proj.*``), the same
names retr_tpu/models/torch_export.py writes. :func:`reference_module` builds an
``nn.Module`` with exactly those names and torch layouts, which a state dict
loads into strictly.

- :func:`to_state_dict` takes a parameter tree, the port's or the JAX
  package's with numpy leaves (``jax.tree.map(np.asarray, params)``), and
  returns the state dict. Folded BatchNorm is written as ``weight=scale, bias=bias,
  running_mean=0, running_var=1-eps``, which folds back to the same (scale,
  bias) exactly.
- :func:`to_params` turns a state dict into the tree the port computes with:
  linear weights ``[in, out]``, conv weights OIHW, BatchNorm folded;
  ``to_params(to_state_dict(p)) == p`` bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from retr_tpu_torch.config import Config
from retr_tpu_torch.models.layers import tree_to
from retr_tpu_torch.models.resnet import BN_EPS, fold_bn, resnet_structure

Params = Dict[str, Any]
StateDict = Dict[str, torch.Tensor]

# the learned source positions (Config.position_embedding "learned"/"v3"): the
# reference's PositionalEmbedding, ConcatTransformer.positional_encoding
# (a [1024, d] table and a LayerNorm)
SRC_POS = "transformer.positional_encoding"


# ---------------------------------------------------------------------------------
# Parameter tree (the port's, or the JAX package's with numpy leaves) ->
# reference-named state dict
# ---------------------------------------------------------------------------------


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32))


def _put_lin(out: StateDict, name: str, p) -> None:
    out[f"{name}.weight"] = _t(p["w"]).t().contiguous()
    out[f"{name}.bias"] = _t(p["b"])


def _put_norm(out: StateDict, name: str, p) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _put_att(out: StateDict, name: str, p) -> None:
    _put_norm(out, f"{name}.norm", p["norm"])
    m = p["mha"]
    out[f"{name}.sublayer.in_proj_weight"] = torch.cat([_t(m[k]["w"]).t() for k in ("q", "k", "v")], dim=0)
    out[f"{name}.sublayer.in_proj_bias"] = torch.cat([_t(m[k]["b"]) for k in ("q", "k", "v")], dim=0)
    _put_lin(out, f"{name}.sublayer.out_proj", m["out"])


def _put_ff(out: StateDict, name: str, p) -> None:
    _put_norm(out, f"{name}.norm", p["norm"])
    _put_lin(out, f"{name}.sublayer.0", p["lin1"])
    _put_lin(out, f"{name}.sublayer.2", p["lin2"])


def _put_bn(out: StateDict, name: str, p) -> None:
    scale = _t(p["scale"])
    out[f"{name}.weight"] = scale
    out[f"{name}.bias"] = _t(p["bias"])
    out[f"{name}.running_mean"] = torch.zeros_like(scale)
    out[f"{name}.running_var"] = torch.full_like(scale, 1.0 - BN_EPS)


def to_state_dict(params: Mapping, cfg: Config) -> StateDict:
    """Parameter tree (any variant; torch or numpy leaves) -> reference-named
    state dict of f32 CPU tensors, the inverse of :func:`to_params`
    (retr_tpu/models/torch_export.py). Each folded BatchNorm is written as
    ``weight=scale, bias=bias, running_mean=0, running_var=1-eps``, which
    :func:`to_params` folds back to the same bits."""
    out: StateDict = {}
    bb = params["backbone"]
    out["backbone.body.conv1.weight"] = _t(bb["conv1"]["w"])
    _put_bn(out, "backbone.body.bn1", bb["bn1"])
    block_type, plan = resnet_structure(cfg.backbone, cfg.dilation)
    n_convs = 3 if block_type == "bottleneck" else 2
    for stage in range(4):
        for bi, (_, _, has_ds) in enumerate(plan[stage]):
            base = f"backbone.body.layer{stage + 1}.{bi}"
            bp = bb[f"layer{stage + 1}"][bi]
            for ci in range(1, n_convs + 1):
                out[f"{base}.conv{ci}.weight"] = _t(bp[f"conv{ci}"]["w"])
                _put_bn(out, f"{base}.bn{ci}", bp[f"bn{ci}"])
            if has_ds:
                out[f"{base}.downsample.0.weight"] = _t(bp["downsample"]["conv"]["w"])
                _put_bn(out, f"{base}.downsample.1", bp["downsample"]["bn"])

    out["input_proj.weight"] = _t(params["input_proj"]["w"]).t()[:, :, None, None].contiguous()
    out["input_proj.bias"] = _t(params["input_proj"]["b"])

    tp = params["transformer"]
    if "src_pos" in tp:
        out[f"{SRC_POS}.embedding.weight"] = _t(tp["src_pos"]["table"])
        _put_norm(out, f"{SRC_POS}.norm", tp["src_pos"]["norm"])
    for i, layer in enumerate(tp["encoder"]["layers"]):
        _put_att(out, f"transformer.encoder.layers.{i}.self_attn", layer["self_attn"])
        _put_ff(out, f"transformer.encoder.layers.{i}.ff", layer["ff"])
    if "norm" in tp["encoder"]:
        _put_norm(out, "transformer.encoder.norm", tp["encoder"]["norm"])
    for i, layer in enumerate(tp["decoder"]["layers"]):
        _put_att(out, f"transformer.decoder.layers.{i}.tgt_self_attn", layer["self_attn"])
        _put_att(out, f"transformer.decoder.layers.{i}.tgt_src_cross_attn", layer["cross_attn"])
        _put_ff(out, f"transformer.decoder.layers.{i}.ff", layer["ff"])
    _put_norm(out, "transformer.decoder.norm", tp["decoder"]["norm"])
    emb = tp["embeddings"]
    out["transformer.embeddings.word_embeddings.weight"] = _t(emb["word"]["table"])
    out["transformer.embeddings.position_embeddings.weight"] = _t(emb["pos"]["table"])
    _put_norm(out, "transformer.embeddings.LayerNorm", emb["norm"])

    for i, layer in enumerate(params["mlp"]["layers"]):
        _put_lin(out, f"mlp.layers.{i}", layer)
    if "loc_proj" in params:
        _put_lin(out, "loc_proj", params["loc_proj"])
    return out


# ---------------------------------------------------------------------------------
# State dict -> the port's parameter tree
# ---------------------------------------------------------------------------------


def _lin(sd, name) -> Params:
    return {"w": sd[f"{name}.weight"].t().contiguous(), "b": sd[f"{name}.bias"]}


def _norm(sd, name) -> Params:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _mha(sd, name) -> Params:
    w = sd[f"{name}.in_proj_weight"]
    b = sd[f"{name}.in_proj_bias"]
    e = w.shape[1]
    return {
        "q": {"w": w[:e].t().contiguous(), "b": b[:e]},
        "k": {"w": w[e:2 * e].t().contiguous(), "b": b[e:2 * e]},
        "v": {"w": w[2 * e:].t().contiguous(), "b": b[2 * e:]},
        "out": _lin(sd, f"{name}.out_proj"),
    }


def _att(sd, name) -> Params:
    return {"norm": _norm(sd, f"{name}.norm"), "mha": _mha(sd, f"{name}.sublayer")}


def _ff(sd, name) -> Params:
    return {"norm": _norm(sd, f"{name}.norm"), "lin1": _lin(sd, f"{name}.sublayer.0"),
            "lin2": _lin(sd, f"{name}.sublayer.2")}


def _bn(sd, name) -> Params:
    return fold_bn(sd[f"{name}.weight"], sd[f"{name}.bias"], sd[f"{name}.running_mean"],
                   sd[f"{name}.running_var"])


def to_params(state_dict: Mapping[str, torch.Tensor], cfg: Config, device=None) -> Params:
    """Reference-named state dict -> parameter tree (f32) on ``device``. The
    BatchNorm folds run on the host, so the tree has the same bits on every
    device."""
    sd = {k: v.detach().to(device="cpu", dtype=torch.float32) for k, v in state_dict.items()}
    block_type, plan = resnet_structure(cfg.backbone, cfg.dilation)
    n_convs = 3 if block_type == "bottleneck" else 2
    pre = "backbone.body."
    backbone: Params = {"conv1": {"w": sd[f"{pre}conv1.weight"]}, "bn1": _bn(sd, f"{pre}bn1")}
    for stage in range(4):
        blocks = []
        for bi, (_, _, has_ds) in enumerate(plan[stage]):
            base = f"{pre}layer{stage + 1}.{bi}"
            bp: Params = {}
            for ci in range(1, n_convs + 1):
                bp[f"conv{ci}"] = {"w": sd[f"{base}.conv{ci}.weight"]}
                bp[f"bn{ci}"] = _bn(sd, f"{base}.bn{ci}")
            if has_ds:
                bp["downsample"] = {"conv": {"w": sd[f"{base}.downsample.0.weight"]},
                                    "bn": _bn(sd, f"{base}.downsample.1")}
            blocks.append(bp)
        backbone[f"layer{stage + 1}"] = blocks

    t = "transformer."
    transformer: Params = {
        "encoder": {"layers": [
            {"self_attn": _att(sd, f"{t}encoder.layers.{i}.self_attn"),
             "ff": _ff(sd, f"{t}encoder.layers.{i}.ff")}
            for i in range(cfg.enc_layers)]},
        "decoder": {"layers": [
            {"self_attn": _att(sd, f"{t}decoder.layers.{i}.tgt_self_attn"),
             "cross_attn": _att(sd, f"{t}decoder.layers.{i}.tgt_src_cross_attn"),
             "ff": _ff(sd, f"{t}decoder.layers.{i}.ff")}
            for i in range(cfg.dec_layers)],
            "norm": _norm(sd, f"{t}decoder.norm")},
        "embeddings": {
            "word": {"table": sd[f"{t}embeddings.word_embeddings.weight"]},
            "pos": {"table": sd[f"{t}embeddings.position_embeddings.weight"]},
            "norm": _norm(sd, f"{t}embeddings.LayerNorm"),
        },
    }
    if f"{t}encoder.norm.weight" in sd:
        transformer["encoder"]["norm"] = _norm(sd, f"{t}encoder.norm")
    if f"{SRC_POS}.embedding.weight" in sd:
        transformer["src_pos"] = {"table": sd[f"{SRC_POS}.embedding.weight"],
                                  "norm": _norm(sd, f"{SRC_POS}.norm")}
    conv_w = sd["input_proj.weight"]
    params: Params = {
        "backbone": backbone,
        "input_proj": {"w": conv_w[:, :, 0, 0].t().contiguous(), "b": sd["input_proj.bias"]},
        "transformer": transformer,
        "mlp": {"layers": [_lin(sd, f"mlp.layers.{i}") for i in range(3)]},
    }
    if "loc_proj.weight" in sd:
        params["loc_proj"] = _lin(sd, "loc_proj")
    return tree_to(params, device=device)


# ---------------------------------------------------------------------------------
# The reference module tree (names and torch layouts only; compute is functional)
# ---------------------------------------------------------------------------------


class FrozenBatchNorm2d(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))


def _conv(i, o, k):
    return nn.Conv2d(i, o, k, bias=False)


class _Block(nn.Module):
    def __init__(self, kind: str, inplanes: int, planes: int, has_ds: bool):
        super().__init__()
        exp = 4 if kind == "bottleneck" else 1
        if kind == "bottleneck":
            self.conv1, self.bn1 = _conv(inplanes, planes, 1), FrozenBatchNorm2d(planes)
            self.conv2, self.bn2 = _conv(planes, planes, 3), FrozenBatchNorm2d(planes)
            self.conv3, self.bn3 = _conv(planes, planes * exp, 1), FrozenBatchNorm2d(planes * exp)
        else:
            self.conv1, self.bn1 = _conv(inplanes, planes, 3), FrozenBatchNorm2d(planes)
            self.conv2, self.bn2 = _conv(planes, planes, 3), FrozenBatchNorm2d(planes)
        if has_ds:
            self.downsample = nn.Sequential(_conv(inplanes, planes * exp, 1),
                                            FrozenBatchNorm2d(planes * exp))


class _Body(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        kind, plan = resnet_structure(cfg.backbone, cfg.dilation)
        exp = 4 if kind == "bottleneck" else 1
        self.conv1, self.bn1 = nn.Conv2d(3, 64, 7, bias=False), FrozenBatchNorm2d(64)
        inplanes = 64
        for stage, planes in enumerate([64, 128, 256, 512]):
            blocks = []
            for bi, (_, _, has_ds) in enumerate(plan[stage]):
                blocks.append(_Block(kind, inplanes, planes, has_ds))
                inplanes = planes * exp
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))


class _Att(nn.Module):
    def __init__(self, d: int, h: int):
        super().__init__()
        self.norm = nn.LayerNorm(d)
        self.sublayer = nn.MultiheadAttention(d, h)


class _FF(nn.Module):
    def __init__(self, d: int, dff: int):
        super().__init__()
        self.norm = nn.LayerNorm(d)
        self.sublayer = nn.Sequential(nn.Linear(d, dff), nn.ReLU(), nn.Linear(dff, d))


class _EncLayer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.self_attn = _Att(cfg.hidden_dim, cfg.nheads)
        self.ff = _FF(cfg.hidden_dim, cfg.dim_feedforward)


class _DecLayer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.tgt_self_attn = _Att(cfg.hidden_dim, cfg.nheads)
        self.tgt_src_cross_attn = _Att(cfg.hidden_dim, cfg.nheads)
        self.ff = _FF(cfg.hidden_dim, cfg.dim_feedforward)


class _Stack(nn.Module):
    def __init__(self, layer_list, norm):
        super().__init__()
        self.layers = nn.ModuleList(layer_list)
        if norm is not None:
            self.norm = norm


class _Embeddings(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_dim)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_dim)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_dim, eps=cfg.layer_norm_eps)


class _LearnedPositions(nn.Module):
    def __init__(self, d: int, max_len: int = 1024):
        super().__init__()
        self.embedding = nn.Embedding(max_len, d)
        self.norm = nn.LayerNorm(d)


class _Transformer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.hidden_dim
        self.encoder = _Stack([_EncLayer(cfg) for _ in range(cfg.enc_layers)],
                              nn.LayerNorm(d) if cfg.pre_norm else None)
        self.decoder = _Stack([_DecLayer(cfg) for _ in range(cfg.dec_layers)], nn.LayerNorm(d))
        self.embeddings = _Embeddings(cfg)
        if cfg.position_embedding in ("v3", "learned"):
            self.positional_encoding = _LearnedPositions(d)


class _MLP(nn.Module):
    def __init__(self, d: int, vocab: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(d, 512), nn.Linear(512, 512), nn.Linear(512, vocab)])


def reference_module(cfg: Config) -> nn.Module:
    """The reference caption model's module tree for ``cfg``: parameter and
    buffer names and shapes a reference-named state dict loads into strictly."""
    m = nn.Module()
    m.backbone = nn.Module()
    m.backbone.body = _Body(cfg)
    m.input_proj = nn.Conv2d(cfg.backbone_num_channels, cfg.hidden_dim, 1)
    m.transformer = _Transformer(cfg)
    m.mlp = _MLP(cfg.hidden_dim, cfg.vocab_size)
    if cfg.use_global_features and cfg.use_location_features:
        m.loc_proj = nn.Linear(1, cfg.hidden_dim)
    elif cfg.use_location_features:
        m.loc_proj = nn.Linear(cfg.num_location_features, cfg.hidden_dim)
    return m
