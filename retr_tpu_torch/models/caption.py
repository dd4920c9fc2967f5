"""Caption model: backbone -> 1x1 projection -> ConcatTransformer encoder, plus
the MLP head (retr_tpu/models/caption.py).

Variants by ``(use_global_features, use_location_features)``:
(F, F) target patches only; (F, T) plus one projected token of the 5 location
features; (T, T) plus one token per location scalar and a separately encoded
context stream; (T, F) raises NotImplementedError, as in the reference.

The 1x1 ``input_proj`` convolution is one [C_backbone -> hidden] product over
the flattened patches. The MLP head is 256 -> 512 -> 512 -> vocab with ReLU.
:func:`forward` is the teacher-forced model of training and evaluation,
:func:`encode` the encode-once half of decoding.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from retr_tpu_torch import device as device_mod
from retr_tpu_torch.config import Config
from retr_tpu_torch.masking import Masked, ensure_unmasked_values, filler_indices
from retr_tpu_torch.models import layers, resnet, transformer
from retr_tpu_torch.parallel import mesh as pmesh
from retr_tpu_torch.precision import matmul_precision

Params = Dict[str, Any]


def init(gen: torch.Generator, cfg: Config) -> Params:
    """Fresh parameters on the host (retr_tpu/models/caption.py:37): input_proj,
    the MLP head and loc_proj at nn.Linear's (and nn.Conv2d's) default init."""
    if cfg.decoder_kind == "lm":
        raise NotImplementedError("training with the LM decoder (ROADMAP L2: LM training)")
    if cfg.use_global_features and not cfg.use_location_features:
        raise NotImplementedError()  # raised before anything is built
    nc, d = cfg.backbone_num_channels, cfg.hidden_dim
    params: Params = {
        "backbone": resnet.init(gen, cfg.backbone, cfg.dilation),
        "input_proj": layers.torch_linear_init(gen, nc, d),   # Conv2d(nc, d, 1) as a linear
        "transformer": transformer.init(gen, cfg),
        "mlp": {"layers": [layers.torch_linear_init(gen, d, 512), layers.torch_linear_init(gen, 512, 512),
                           layers.torch_linear_init(gen, 512, cfg.vocab_size)]},
    }
    if cfg.use_location_features:
        # one token per location scalar with global features, else one token of all of them
        n_loc = 1 if cfg.use_global_features else cfg.num_location_features
        params["loc_proj"] = layers.torch_linear_init(gen, n_loc, d)
    return params


def build_model(cfg: Config, seed: Optional[int] = None, device=None):
    """(params, criterion), the reference's factory (retr_tpu/models/caption.py:224):
    :func:`init` from a CPU generator seeded with ``seed`` (default ``cfg.seed``),
    the tree then moved to ``device`` (``cuda`` unless told otherwise). The
    criterion is the training loss's cross-entropy, averaged over every
    position, PAD included."""
    from retr_tpu_torch.train.state import cross_entropy  # train/state imports this module

    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    params = init(gen, cfg)
    return layers.tree_to(params, device=device_mod.resolve(device)), cross_entropy


def mlp_head(p: Params, x: torch.Tensor, vocab_size: Optional[int] = None) -> torch.Tensor:
    """3-layer MLP with ReLU between layers. Where the last layer is
    column-sharded over the active mesh's mp (narrower than ``vocab_size``),
    its input goes through ``copy_to_mp`` and the logits are this rank's
    vocabulary slice."""
    n = len(p["layers"])
    for i, lp in enumerate(p["layers"]):
        if i == n - 1 and vocab_size is not None and lp["w"].shape[1] != vocab_size:
            x = pmesh.copy_to_mp(x)
        x = layers.linear(lp, x)
        if i < n - 1:
            x = torch.relu(x)
    return x


def _project(params: Params, feats: torch.Tensor) -> torch.Tensor:
    """[B, C_bb, h, w] backbone features -> [B, hidden, h*w] through input_proj
    (kept in the parameters' f32, as the reference package promotes)."""
    b, c, h, w = feats.shape
    x = feats.reshape(b, c, h * w).transpose(1, 2).float()
    return layers.linear(params["input_proj"], x).transpose(1, 2)


# (positions, seed, device) -> filler_indices on that device, uploaded once: a
# forward then copies nothing from the host (a captured train step cannot)
_FILLERS: Dict[tuple, torch.Tensor] = {}


def _guarded(mask: torch.Tensor, filler_idx, cfg: Config) -> torch.Tensor:
    n = mask.shape[-2] * mask.shape[-1]
    if filler_idx is None:
        key = (n, cfg.seed, str(mask.device))
        filler_idx = _FILLERS.get(key)
        if filler_idx is None:
            filler_idx = _FILLERS[key] = torch.as_tensor(filler_indices(n, cfg.seed), device=mask.device)
    return ensure_unmasked_values(mask, filler_idx)


class EncoderInput(NamedTuple):
    """Assembled encoder streams, channel-first like the reference."""

    src_t: torch.Tensor
    mask_t: torch.Tensor
    src_c: Optional[torch.Tensor]
    mask_c: Optional[torch.Tensor]


def build_encoder_input(params: Params, cfg: Config, samples: Masked,
                        global_samples: Optional[Masked] = None,
                        loc_feats: Optional[torch.Tensor] = None, *,
                        compute_dtype=torch.float32, filler_idx=None,
                        stop_prefix_gradient: bool = False) -> EncoderInput:
    """Run the backbone(s) and location projections for the variant cfg selects.

    ``filler_idx``: the flat positions ensure_unmasked_values unmasks in a fully
    masked feature map (default: masking.filler_indices with ``cfg.seed``).
    ``stop_prefix_gradient`` (train steps) and ``cfg.remat`` go to the backbone."""
    if cfg.use_global_features and not cfg.use_location_features:
        raise NotImplementedError()
    bb = dict(name=cfg.backbone, dilation=cfg.dilation, compute_dtype=compute_dtype,
              stop_prefix_gradient=stop_prefix_gradient, remat=cfg.remat)
    feats = resnet.backbone_forward(params["backbone"], samples, **bb)
    mask = feats.mask
    if cfg.guard_all_masked_target:
        mask = _guarded(mask, filler_idx, cfg)
    b = mask.shape[0]
    with matmul_precision(compute_dtype):
        src_t = _project(params, feats.tensors)
        mask_t = mask.reshape(b, -1)

        if cfg.use_global_features:
            # one token per location scalar, then the separately encoded context
            loc_src = layers.linear(params["loc_proj"], loc_feats[:, :, None].to(compute_dtype).float())
            src_t = torch.cat([src_t, loc_src.transpose(1, 2)], dim=2)
            mask_t = torch.cat([mask_t, torch.zeros(loc_feats.shape, dtype=torch.bool,
                                                    device=mask_t.device)], dim=1)
            g = resnet.backbone_forward(params["backbone"], global_samples, **bb)
            g_mask = _guarded(g.mask, filler_idx, cfg)
            return EncoderInput(src_t, mask_t, _project(params, g.tensors), g_mask.reshape(b, -1))

        if cfg.use_location_features:
            loc_src = layers.linear(params["loc_proj"], loc_feats.to(compute_dtype).float())
            src_t = torch.cat([src_t, loc_src[:, :, None]], dim=2)
            mask_t = torch.cat([mask_t, torch.zeros((b, 1), dtype=torch.bool,
                                                    device=mask_t.device)], dim=1)
    return EncoderInput(src_t, mask_t, None, None)


def forward(params: Params, cfg: Config, samples: Masked, target_exp: torch.Tensor,
            target_exp_mask: torch.Tensor, *, global_samples: Optional[Masked] = None,
            loc_feats: Optional[torch.Tensor] = None, return_attention: bool = False,
            train: bool = False, seed: Optional[int] = None, compute_dtype=torch.float32,
            filler_idx=None):
    """Teacher-forced forward: token ids [B, T] (True = pad in the mask) ->
    logits [B, T, vocab] in f32 (this rank's vocabulary slice where the head
    is mp-sharded), or (logits, attention maps) with
    ``return_attention`` (keys ``enc_tc_self_att``, ``dec_exp_self_att``,
    ``dec_exp_tc_cross_att``, each [layers, B, T, S]). ``train`` turns on
    dropout (generators from ``seed``) and detaches the frozen backbone prefix."""
    if "lm" in params:
        raise NotImplementedError("the teacher-forced forward of the LM decoder (ROADMAP L2: LM training)")
    enc = build_encoder_input(params, cfg, samples, global_samples, loc_feats,
                              compute_dtype=compute_dtype, filler_idx=filler_idx,
                              stop_prefix_gradient=train)
    hs, atts = transformer.forward(params["transformer"], enc.src_t, enc.mask_t, enc.src_c, enc.mask_c,
                                   target_exp, target_exp_mask, cfg, return_attention=return_attention,
                                   train=train, seed=seed)
    with matmul_precision(compute_dtype):
        out = mlp_head(params["mlp"], hs, cfg.vocab_size)
    return (out, atts) if return_attention else out


def encode(params: Params, cfg: Config, samples: Masked, *,
           global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
           compute_dtype=torch.float32, filler_idx=None):
    """Encode once for autoregressive decoding: (memory [B, S, C], mask [B, S], pos [S, C])."""
    enc = build_encoder_input(params, cfg, samples, global_samples, loc_feats,
                              compute_dtype=compute_dtype, filler_idx=filler_idx)
    if enc.src_c is not None:
        src = torch.cat([enc.src_t, enc.src_c], dim=2)
        mask = torch.cat([enc.mask_t, enc.mask_c], dim=1)
    else:
        src, mask = enc.src_t, enc.mask_t
    with matmul_precision(compute_dtype):
        memory, pos, _ = transformer.encode(params["transformer"], src.transpose(1, 2), mask, cfg)
    return memory, mask, pos
