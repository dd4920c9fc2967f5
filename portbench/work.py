"""The yardstick: operations and bytes from shapes, and the card's peaks.

Operations count multiply-adds as two. Bytes count each input read once and
each output written once, whatever a kernel reads again. Every function takes
the sizes it depends on, so a cell at another memory length or row count is
counted right.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense peaks at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

MLP_HIDDEN = 512
BLOCKS = {"ResNet18": ("basic", (2, 2, 2, 2)), "ResNet34": ("basic", (3, 4, 6, 3)),
          "ResNet50": ("bottleneck", (3, 4, 6, 3)), "ResNet101": ("bottleneck", (3, 4, 23, 3))}


def stack_step_work(rows: int, step: int, s: int, *, c: int = 256, heads: int = 8, f: int = 2048,
                    layers: int = 6, esize: int = 2) -> tuple:
    """(bytes, operations) of ``fused_stack_step`` (``rt_stack_step``): one decode
    step of all ``layers`` decoder layers for ``rows`` rows at position ``step``
    against ``s`` memory tokens. Reads x, every layer's weights, the self
    caches before ``step`` and the cross K/V; writes the cache slot at
    ``step`` and y; the f32 [rows, s] key bias is read once."""
    d = c // heads
    attn_w = 4 * c * c + 3 * c + c + 2 * c          # q/k/v/out weights and biases, LN
    cross_w = 2 * c * c + c + c + 3 * c             # q/out weights and biases, LN (+ the final norm's)
    ff_w = 2 * c * f + f + c + 2 * c
    io = 2 * rows * c * esize
    self_cache = 2 * rows * heads * step * d * esize + 2 * rows * heads * d * esize
    cross_kv = 2 * rows * heads * s * d * esize
    self_ops = 2 * rows * 4 * c * c + 2 * 2 * rows * heads * (step + 1) * d
    cross_ops = 2 * rows * 2 * c * c + 2 * 2 * rows * heads * s * d
    ff_ops = 2 * rows * 2 * c * f
    nbytes = io + layers * ((attn_w + cross_w + ff_w) * esize + self_cache + cross_kv) + rows * s * 4 + 4
    return nbytes, layers * (self_ops + cross_ops + ff_ops)


def roofline_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the byte and operation bounds."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def stack_step_bound_s(rows: int, s: int, steps: int = 127, dtype: str = "bfloat16", **kw) -> float:
    """The mean roofline time of one ``rt_stack_step`` launch over steps 0..steps-1."""
    esize = 2 if dtype == "bfloat16" else 4
    return sum(roofline_s(*stack_step_work(rows, t, s, esize=esize, **kw), dtype) for t in range(steps)) / steps


# ---------------------------------------------------------------------------------
# Model operations
# ---------------------------------------------------------------------------------


def _convs(name: str, dilation: bool, side: int):
    """(cin, cout, k, out_side, stage) of every convolution of the ResNet trunk
    through layer4 (torchvision semantics: stride on the 3x3, layer4 dilated)."""
    kind, plan = BLOCKS[name]
    out = []
    h = (side + 2 * 3 - 7) // 2 + 1
    out.append((3, 64, 7, h, "stem"))
    h = (h + 2 - 3) // 2 + 1                        # max pool
    inplanes = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), plan)):
        stride = 1 if stage == 0 or (stage == 3 and dilation) else 2
        exp = 4 if kind == "bottleneck" else 1
        for b in range(n):
            s = stride if b == 0 else 1
            h_out = (h - 1) // s + 1
            label = f"layer{stage + 1}.{b}"
            if kind == "bottleneck":
                out += [(inplanes, planes, 1, h, label), (planes, planes, 3, h_out, label),
                        (planes, planes * exp, 1, h_out, label)]
            else:
                out += [(inplanes, planes, 3, h_out, label), (planes, planes, 3, h_out, label)]
            if b == 0 and (s != 1 or inplanes != planes * exp):
                out.append((inplanes, planes * exp, 1, h_out, label + ".downsample"))
            inplanes, h = planes * exp, h_out
    return out


def conv_flops(cin, cout, k, side):
    return 2 * cin * cout * k * k * side * side


def backbone_flops(name: str = "ResNet101", dilation: bool = True, side: int = 224) -> int:
    return sum(conv_flops(ci, co, k, h) for ci, co, k, h, _ in _convs(name, dilation, side))


def memory_tokens(cfg: dict) -> int:
    """Encoder sequence length: 196 patches at 224 px, + 5 location tokens
    and 196 context patches for CaptionGlobalLoc (397)."""
    p = (cfg["image_size"] // (16 if cfg["dilation"] else 32)) ** 2
    if cfg["use_global_features"]:
        return 2 * p + cfg["num_location_features"]
    return p + (1 if cfg["use_location_features"] else 0)


def _encoder_flops(cfg, s):
    c, f = cfg["hidden_dim"], cfg["dim_feedforward"]
    per_layer = 2 * s * 4 * c * c + 2 * 2 * s * s * c + 2 * 2 * s * c * f
    return cfg["enc_layers"] * per_layer


def _loc_flops(cfg):
    """The location projection: five scalars to d (one product either way)."""
    return 2 * cfg["num_location_features"] * cfg["hidden_dim"]


def _encode_flops(cfg):
    """Backbone(s), the 1x1 projection(s), the location tokens and the encoder, one sample."""
    c = cfg["hidden_dim"]
    nc = 512 if cfg["backbone"] in ("ResNet18", "ResNet34") else 2048
    p = (cfg["image_size"] // (16 if cfg["dilation"] else 32)) ** 2
    streams = 2 if cfg["use_global_features"] else 1
    out = streams * (backbone_flops(cfg["backbone"], cfg["dilation"], cfg["image_size"]) + 2 * nc * c * p)
    if cfg["use_location_features"]:
        out += _loc_flops(cfg)
    return out + _encoder_flops(cfg, memory_tokens(cfg))


def _head_flops(cfg, tokens):
    c, v = cfg["hidden_dim"], cfg["vocab_size"]
    return 2 * tokens * (c * MLP_HIDDEN + MLP_HIDDEN * MLP_HIDDEN + MLP_HIDDEN * v)


def caption_flops(cfg: dict, steps: int = 127) -> int:
    """Operations of one greedy caption: encode once, the cross K/V of the
    memory once per layer, ``steps`` KV-cached decoder steps (self-attention
    over the step + 1 cached positions) and the head at each step."""
    c, f, s = cfg["hidden_dim"], cfg["dim_feedforward"], memory_tokens(cfg)
    cross_kv = cfg["dec_layers"] * 2 * 2 * s * c * c
    dec = 0
    for t in range(steps):
        dec += cfg["dec_layers"] * (2 * 4 * c * c + 2 * 2 * (t + 1) * c
                                    + 2 * 2 * c * c + 2 * 2 * s * c + 2 * 2 * c * f)
    return _encode_flops(cfg) + cross_kv + dec + _head_flops(cfg, steps)


def _decoder_full_flops(cfg, t):
    """Teacher-forced decoder over ``t`` positions (causal: full t x t products)."""
    c, f, s = cfg["hidden_dim"], cfg["dim_feedforward"], memory_tokens(cfg)
    per_layer = (2 * t * 4 * c * c + 2 * 2 * t * t * c            # self: projections, scores, weighting
                 + 2 * t * 2 * c * c + 2 * 2 * s * c * c + 2 * 2 * t * s * c   # cross
                 + 2 * 2 * t * c * f)
    return cfg["dec_layers"] * per_layer


def train_sample_flops(cfg: dict) -> int:
    """Forward and backward operations of one training sample (teacher forcing
    over max_position_embeddings positions). Trained parts cost three times
    their forward (forward, input gradient, weight gradient). The frozen
    prefix (stem and layer1) runs forward only, its output detached, so
    neither gradient is computed there; the two convolutions that read that
    detached output, and the location projection, whose input is data, need
    no input gradient."""
    t = cfg["max_position_embeddings"]
    convs = _convs(cfg["backbone"], cfg["dilation"], cfg["image_size"])
    prefix = sum(conv_flops(ci, co, k, h) for ci, co, k, h, lab in convs
                 if lab == "stem" or lab.startswith("layer1."))
    first = [conv_flops(ci, co, k, h) for ci, co, k, h, lab in convs if lab.startswith("layer2.0")]
    no_dgrad = first[0] + first[-1]             # layer2.0's conv1 and downsample read the prefix
    streams = 2 if cfg["use_global_features"] else 1
    trained_fwd = _encode_flops(cfg) - streams * prefix + _decoder_full_flops(cfg, t) + _head_flops(cfg, t)
    loc = _loc_flops(cfg) if cfg["use_location_features"] else 0
    return 3 * trained_fwd + streams * (prefix - no_dgrad) - loc
