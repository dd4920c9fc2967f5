"""Weights from the seed for the LM-decoder configurations: one state dict
made on the device, read by the program and by the plain reference alike.

The encoder's leaves (ResNet, projection, location tokens, RE:TR's 6-layer
encoder) are ``portbench/weights.py``'s, in float32. The projector's and the
language model's are drawn leaf by leaf in the configuration's compute type
(bfloat16: 16 B parameters take 31.9 GB once, and the program's parameters
are views of these same tensors): matrices at 1/sqrt(fan-in), so the
router's logits and the blocks' inputs keep unit scale, except the blocks'
output projections: ``o_proj`` and the dense and shared ``down_proj`` at 0.2
of that, the routed experts' ``down_proj`` at 0.05; the embedding at a
spread of 2, so a position's own token, the image prefix and the layers
all move its logits. Random weights at full scale are chaotic over 27
layers: bfloat16's rounding moves 9-20 % of the experts chosen, and a moved
choice swaps in an unrelated random expert, so at 1/sqrt(fan-in) the served
tokens lay 1.7 logits below the float32 reference's best (the float8
control 2.8), at a tenth everywhere 0.24 (0.51); with larger output
projections and a unit embedding the attention's average over the 397
nearly parallel prefix tokens pulls every position's logits alike, and on
2 seeds of 12 neither bfloat16 nor the float8 control moved one judged
token (both gaps 0). At these scales a CPU study at 27 layers read
0.014 against the control's 0.148, 0.26 with the routed experts dropped and
2.5 with the image prefix dropped, 120 distinct tokens in 124 positions;
norm weights
near 1; each MoE layer's correction bias at 0.05 spread,
about the spread of the sigmoid scores between the 6th and the 7th choice, so
the bias moves the selection and not the weights; the head's PAD, BOS and EOS
rows zero, so those logits are exactly 0 and never the largest of 163,840
random ones: every row decodes all its steps.
"""

from __future__ import annotations

import torch

from portbench import weights
from portbench.reference import lm as ref_lm

SPECIAL_ROWS = (0, 101, 102)        # PAD, BOS ([CLS]), EOS ([SEP])
BIAS_SPREAD = 0.05
OUTPUT_SCALE = 0.2                  # o_proj and the dense and shared down_proj, against 1/sqrt(fan-in)
EXPERT_OUTPUT_SCALE = 0.05          # the routed experts' down_proj
EMBED_SPREAD = 2.0


def lm_shapes(c: dict) -> dict:
    """Name -> shape of the projector's and the language model's leaves."""
    with torch.device("meta"):
        proj = ref_lm.Projector(c["hidden_dim"], c["lm_hidden_size"])
        out = {f"projector.{k}": tuple(v.shape) for k, v in proj.state_dict().items()}
        d, v = c["lm_hidden_size"], c["vocab_size"]
        out["language_model.model.embed_tokens.weight"] = (v, d)
        for i in range(c["lm_layers"]):
            layer = ref_lm.Layer(c, i < c["lm_first_k_dense_replace"])
            out.update({f"language_model.model.layers.{i}.{k}": tuple(t.shape)
                        for k, t in layer.state_dict().items()})
        out["language_model.model.norm.weight"] = (d,)
        out["language_model.lm_head.weight"] = (v, d)
    return out


def _draw(name: str, shape, gen, device, dtype) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if name.endswith("e_score_correction_bias"):
        return t.mul_(BIAS_SPREAD)
    if name.endswith("embed_tokens.weight"):
        return t.mul_(EMBED_SPREAD)
    if len(shape) >= 2:
        if name.endswith("experts.down_proj"):
            return t.mul_(EXPERT_OUTPUT_SCALE * shape[-1] ** -0.5)
        out = name.endswith(("o_proj.weight", "down_proj.weight"))
        return t.mul_((OUTPUT_SCALE if out else 1.0) * shape[-1] ** -0.5)
    if "norm" in name and name.endswith("weight"):
        return t.mul_(0.05).add_(1.0)
    return t.mul_(0.02)


def state_dict(model_cfg: dict, seed: int, device, *, decode: bool = True) -> dict:
    """The state dict of ``model_cfg``'s encoder (f32) and LM (its compute
    type) drawn from ``seed`` on ``device``."""
    enc = weights.state_dict({**model_cfg, "vocab_size": 8}, seed, device)
    out = {k: v for k, v in enc.items() if k.startswith(ref_lm.ENCODER_PREFIXES)}
    dtype = torch.bfloat16 if model_cfg["compute_dtype"] == "bfloat16" else torch.float32
    gen = torch.Generator(device=device).manual_seed((int(seed) + 17) % (1 << 63))
    for name, shape in lm_shapes(model_cfg).items():
        out[name] = _draw(name, shape, gen, device, dtype)
    if decode:
        out["language_model.lm_head.weight"][list(SPECIAL_ROWS)] = 0.0
    return out
