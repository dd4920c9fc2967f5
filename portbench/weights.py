"""Weights from the seed: one reference-named state dict, made on the device.

Every tensor of RE:TR's state dict (the names ``retr_tpu_torch/models/weights.py``
reads) is a slice of one ``torch.randn`` buffer drawn on the device from the
run's seed, scaled per kind of leaf. The same dict goes to the program and to
the plain reference. The frozen BatchNorm statistics are drawn so that the
activations keep their scale through ResNet-101's 33 bottlenecks: the last
BatchNorm of each residual branch scales it by about 0.2, so the residual
stream grows by a few percent a block instead of doubling.
"""

from __future__ import annotations

import torch

from portbench.reference import model as ref_model

# ids whose head bias is set far below every other logit in the decode cells:
# PAD, BOS ([CLS]) and EOS ([SEP]) are then never chosen, so every row decodes
# all 127 steps (EOS unreachable, as in bench.py's protocol) and the string of
# every caption keeps each token it was served
UNREACHABLE_IDS = (0, 101, 102)
UNREACHABLE_BIAS = -1000.0


def _scale(name: str, shape, last_bn: str) -> tuple:
    """(std, mean) of the normal draw behind one leaf; ``last_bn`` names the
    BatchNorm that closes a residual branch (bn3 in a bottleneck)."""
    if name.startswith("backbone."):
        if len(shape) == 4:                       # kaiming normal, fan_out, relu (torchvision)
            return (2.0 / (shape[0] * shape[2] * shape[3])) ** 0.5, 0.0
        last = ".layer" in name and name.rsplit(".", 2)[-2] == last_bn
        kind = name.rsplit(".", 1)[-1]
        if kind == "weight":
            return (0.02, 0.2) if last else (0.05, 1.0)
        if kind == "running_var":
            return 0.1, 1.0
        return 0.05, 0.0                           # bias, running_mean
    if name.endswith("LayerNorm.weight") or name.endswith("norm.weight"):
        return 0.05, 1.0
    if len(shape) >= 2:
        fan_out, fan_in = shape[0], shape[1] * (shape[2] * shape[3] if len(shape) == 4 else 1)
        if name.startswith("mlp.") or name.startswith("input_proj") or name.startswith("loc_proj"):
            return fan_in ** -0.5, 0.0            # nn.Linear / nn.Conv2d's scale
        return (2.0 / (fan_in + fan_out)) ** 0.5, 0.0   # xavier (ConcatTransformer re-inits dim > 1)
    return 0.02, 0.0                               # biases and the LayerNorm shifts


def state_dict(cfg: dict, seed: int, device, *, unreachable=()) -> dict:
    """The state dict of ``cfg``'s model drawn from ``seed`` on ``device`` (f32)."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in ref_model.CaptionModel(cfg).state_dict().items()}
    last_bn = "bn3" if ref_model.SPECS[cfg["backbone"]][0] is ref_model.Bottleneck else "bn2"
    total = sum(torch.Size(s).numel() for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    buf = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = torch.Size(shape).numel()
        std, mean = _scale(name, shape, last_bn)
        t = buf[at:at + n].view(shape).mul_(std).add_(mean)
        if name.endswith("running_var"):
            t.abs_()
        out[name] = t
        at += n
    if unreachable:
        bias = out["mlp.layers.2.bias"]
        bias[list(unreachable)] = UNREACHABLE_BIAS
    return out
