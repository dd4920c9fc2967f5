"""ResNet backbone with frozen BatchNorm folded to an affine (retr_tpu/models/resnet.py).

Torchvision semantics: with ``dilation`` on, layer4's stride moves into dilation
(output stride 16, a 14x14 map for 224x224 inputs). Convolutions go through
``torch.nn.functional.conv2d`` (cuDNN on the GPU), as the JAX package leaves
them to XLA. Parameters are the JAX package's tree: conv weights OIHW, each BN
as its folded ``{scale, bias}``. The folded BN affines are constants in
training (the train state gives them no gradient), as the reference's
FrozenBatchNorm buffers are.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from retr_tpu_torch.masking import Masked, downsample_mask_nearest
from retr_tpu_torch.models.layers import maybe_checkpoint, tree_to
from retr_tpu_torch.precision import matmul_precision

Params = Dict[str, Any]

RESNET_SPECS = {
    "ResNet18": ("basic", [2, 2, 2, 2]),
    "ResNet34": ("basic", [3, 4, 6, 3]),
    "ResNet50": ("bottleneck", [3, 4, 6, 3]),
    "ResNet101": ("bottleneck", [3, 4, 23, 3]),
}

BN_EPS = 1e-5  # added before rsqrt (reference models/backbone.py:48-49)


def fold_bn(weight, bias, running_mean, running_var) -> Params:
    """FrozenBatchNorm2d buffers -> (scale, bias) with y = x*scale + bias."""
    weight, bias, running_mean, running_var = (
        torch.as_tensor(t, dtype=torch.float32) for t in (weight, bias, running_mean, running_var)
    )
    scale = weight * torch.rsqrt(running_var + BN_EPS)
    return {"scale": scale, "bias": bias - running_mean * scale}


def resnet_structure(name: str, dilation: bool):
    """Static (stride, dilation, has_downsample) plan per block, torchvision semantics."""
    block_type, blocks = RESNET_SPECS[name]
    expansion = 4 if block_type == "bottleneck" else 1
    plan: List[List[Tuple[int, int, bool]]] = []
    inplanes = 64
    cur_dilation = 1
    for stage, (planes, nblocks) in enumerate(zip([64, 128, 256, 512], blocks)):
        stride = 1 if stage == 0 else 2
        dilate = dilation and stage == 3  # replace_stride_with_dilation=[F, F, dilation]
        previous_dilation = cur_dilation
        if dilate:
            cur_dilation *= stride
            stride = 1
        stage_plan = []
        has_ds = stride != 1 or inplanes != planes * expansion
        stage_plan.append((stride, previous_dilation, has_ds))
        inplanes = planes * expansion
        for _ in range(1, nblocks):
            stage_plan.append((1, cur_dilation, False))
        plan.append(stage_plan)
    return block_type, plan


def _kaiming_normal_conv(gen: torch.Generator, shape) -> torch.Tensor:
    """torchvision's conv init, kaiming_normal_(mode='fan_out', nonlinearity='relu'),
    on an OIHW weight: N(0, 2 / (O * kh * kw))."""
    o, _, kh, kw = shape
    return torch.randn(shape, generator=gen) * math.sqrt(2.0 / (o * kh * kw))


def _frozen_bn_identity(n: int) -> Params:
    """A fresh FrozenBatchNorm2d (w=1, b=0, rm=0, rv=1), folded."""
    return {"scale": torch.full((n,), 1.0 / math.sqrt(1.0 + BN_EPS)), "bias": torch.zeros(n)}


def _block_init(gen: torch.Generator, block_type: str, inplanes: int, planes: int, has_ds: bool) -> Params:
    if block_type == "bottleneck":
        shapes = [(planes, inplanes, 1, 1), (planes, planes, 3, 3), (planes * 4, planes, 1, 1)]
    else:
        shapes = [(planes, inplanes, 3, 3), (planes, planes, 3, 3)]
    p: Params = {}
    for i, shape in enumerate(shapes, 1):
        p[f"conv{i}"] = {"w": _kaiming_normal_conv(gen, shape)}
        p[f"bn{i}"] = _frozen_bn_identity(shape[0])
    if has_ds:
        out = shapes[-1][0]
        p["downsample"] = {"conv": {"w": _kaiming_normal_conv(gen, (out, inplanes, 1, 1))},
                           "bn": _frozen_bn_identity(out)}
    return p


def init(gen: torch.Generator, name: str = "ResNet101", dilation: bool = True) -> Params:
    """Fresh backbone parameters on the host (retr_tpu/models/resnet.py:138):
    kaiming-normal convolutions, every BatchNorm the folded identity."""
    block_type, plan = resnet_structure(name, dilation)
    expansion = 4 if block_type == "bottleneck" else 1
    params: Params = {"conv1": {"w": _kaiming_normal_conv(gen, (64, 3, 7, 7))}, "bn1": _frozen_bn_identity(64)}
    inplanes = 64
    for stage, (planes, stage_plan) in enumerate(zip([64, 128, 256, 512], plan)):
        blocks = []
        for _, _, has_ds in stage_plan:
            blocks.append(_block_init(gen, block_type, inplanes, planes, has_ds))
            inplanes = planes * expansion
        params[f"layer{stage + 1}"] = blocks
    return params


def _conv(w, x, stride=1, padding=0, dilation=1):
    return F.conv2d(x, w, stride=stride, padding=padding, dilation=dilation)


def _bn(p, x):
    return x * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]


def _max_pool_3x3s2(x):
    """MaxPool2d(kernel=3, stride=2, padding=1): implicit -inf padding, like the
    reference package's reduce_window with -inf. No custom backward (the JAX
    package needed one for the TPU): the pool sits below the layer1 detach of
    a train step, so no step differentiates it."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def _bottleneck_apply(p, x, stride, dilation):
    out = torch.relu(_bn(p["bn1"], _conv(p["conv1"]["w"], x)))
    out = torch.relu(
        _bn(p["bn2"], _conv(p["conv2"]["w"], out, stride=stride, padding=dilation, dilation=dilation))
    )
    out = _bn(p["bn3"], _conv(p["conv3"]["w"], out))
    identity = x
    if "downsample" in p:
        identity = _bn(p["downsample"]["bn"], _conv(p["downsample"]["conv"]["w"], x, stride=stride))
    return torch.relu(out + identity)


def _basic_apply(p, x, stride, dilation):
    out = torch.relu(
        _bn(p["bn1"], _conv(p["conv1"]["w"], x, stride=stride, padding=dilation, dilation=dilation))
    )
    out = _bn(p["bn2"], _conv(p["conv2"]["w"], out, padding=dilation, dilation=dilation))
    identity = x
    if "downsample" in p:
        identity = _bn(p["downsample"]["bn"], _conv(p["downsample"]["conv"]["w"], x, stride=stride))
    return torch.relu(out + identity)


def apply(params: Params, x: torch.Tensor, *, name: str = "ResNet101", dilation: bool = True,
          compute_dtype=torch.float32, stop_prefix_gradient: bool = False,
          remat: bool = False) -> torch.Tensor:
    """[B, 3, H, W] image -> [B, C, H/s, W/s] layer4 features (C=2048 for 50/101).
    Runs in ``compute_dtype`` (parameters cast to it), with TF32 off in f32.

    ``stop_prefix_gradient`` detaches the layer1 output: the reference freezes
    conv1/bn1/layer1, so a train step neither keeps nor walks their backward.
    ``remat`` (Config.remat) runs each residual block under
    ``torch.utils.checkpoint`` when autograd records."""
    block_type, plan = resnet_structure(name, dilation)
    block_apply = _bottleneck_apply if block_type == "bottleneck" else _basic_apply
    if compute_dtype != torch.float32:
        params = tree_to(params, dtype=compute_dtype)
    with matmul_precision(compute_dtype):
        x = x.to(compute_dtype)
        x = torch.relu(_bn(params["bn1"], _conv(params["conv1"]["w"], x, stride=2, padding=3)))
        x = _max_pool_3x3s2(x)
        for stage in range(4):
            for block_p, (stride, dil, _) in zip(params[f"layer{stage + 1}"], plan[stage]):
                x = maybe_checkpoint(block_apply, remat, block_p, x, stride, dil)
            if stage == 0 and stop_prefix_gradient:
                x = x.detach()
    return x


def backbone_forward(params: Params, samples: Masked, *, name: str = "ResNet101",
                     dilation: bool = True, compute_dtype=torch.float32,
                     stop_prefix_gradient: bool = False, remat: bool = False) -> Masked:
    """Features plus the pixel mask downsampled (nearest) to the feature map."""
    feats = apply(params, samples.tensors, name=name, dilation=dilation,
                  compute_dtype=compute_dtype, stop_prefix_gradient=stop_prefix_gradient,
                  remat=remat)
    mask = downsample_mask_nearest(samples.mask, feats.shape[-2], feats.shape[-1])
    return Masked(feats, mask)
