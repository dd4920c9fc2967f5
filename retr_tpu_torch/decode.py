"""Greedy decoding: encode once, then the KV-cached loop (retr_tpu/decode.py).

Token semantics are the reference's, exactly: BOS in slot 0; the logits of
position i are argmaxed into slot i+1; rows that produced EOS keep receiving
(ignored) tokens; when every row has finished the pending write is skipped and
the loop stops; at most ``max_len - 1`` steps. The buffer, post-EOS junk
included, equals retr_tpu.decode.greedy's.

On the GPU the loop does not wait for the host each step: ``finished`` and the
write decision stay on the device, the step index the kernels read is a device
int32, and the host looks at "all finished" only every ``CHECK_EVERY`` steps.
Steps run after every row finished are no-ops (the write is skipped), so the
buffer is unchanged by them. Unlike the JAX package, no rows are padded: the
CUDA kernels take any batch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from retr_tpu_torch.config import Config
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import caption, transformer
from retr_tpu_torch.precision import dtype_of, matmul_precision

Params = Dict[str, Any]

CHECK_EVERY = 16  # steps between host checks of "all rows finished"


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _cast_for_decode(params: Params, memory, pos, compute_dtype):
    """Storage type of the decode loop: in bf16 mode the transformer and head
    weights, the encoder memory and (allocated from it) the cross K/V and self
    caches are bf16; f32 parity mode returns everything unchanged. LayerNorm and
    softmax still compute in f32 inside the kernels."""
    dt = dtype_of(compute_dtype)
    if dt == torch.float32:
        return params, memory, pos
    params = {**params, "transformer": _cast_tree(params["transformer"], dt),
              "mlp": _cast_tree(params["mlp"], dt)}
    return params, memory.to(dt), pos.to(dt)


def greedy_from_memory(params: Params, cfg: Config, memory, mem_mask, pos, *,
                       max_len: int, bos_token: int, eos_token: int) -> torch.Tensor:
    """Greedy decode given the encoder output; returns the [B, max_len] int32
    token buffer (on memory's device)."""
    b = memory.shape[0]
    dev = memory.device
    tparams = transformer.prepare_decoder(params["transformer"])
    cache, cross = transformer.init_decode_state(tparams, memory, mem_mask, pos, cfg, max_len)
    captions = torch.zeros((b, max_len), dtype=torch.int32, device=dev)
    captions[:, 0] = bos_token
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    with matmul_precision(memory.dtype):
        for i in range(max_len - 1):
            if i and i % CHECK_EVERY == 0 and bool(finished.all()):
                break
            hs, cache = transformer.decode_step(tparams, cache, cross, captions[:, i], step, cfg)
            pred = caption.mlp_head(params["mlp"], hs).argmax(dim=-1).to(torch.int32)
            finished |= pred == eos_token
            write = ~finished.all()  # all just finished: the reference skips this write
            captions[:, i + 1] = torch.where(write, pred, captions[:, i + 1])
            step += 1
    return captions


def greedy(params: Params, cfg: Config, samples: Masked, *,
           global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
           max_len: int = 128, bos_token: int = 101, eos_token: int = 102,
           compute_dtype=torch.float32, filler_idx=None) -> torch.Tensor:
    """Batched greedy decoding: encode once, then the KV-cached loop. Runs on the
    device the samples are on."""
    memory, mem_mask, pos = caption.encode(
        params, cfg, samples, global_samples=global_samples, loc_feats=loc_feats,
        compute_dtype=compute_dtype, filler_idx=filler_idx,
    )
    params, memory, pos = _cast_for_decode(params, memory, pos, compute_dtype)
    return greedy_from_memory(params, cfg, memory, mem_mask, pos, max_len=max_len,
                              bos_token=bos_token, eos_token=eos_token)


def prune_token_ids(idx_seqs: Sequence[Sequence[int]], clean: bool = True, pad_token: int = 0,
                    bos_token: int = 101, eos_token: int = 102) -> List[List[int]]:
    """Cut each sequence at its first EOS; optionally strip PAD/BOS/EOS."""
    results = []
    for seq in idx_seqs:
        pruned = []
        for idx in seq:
            pruned.append(int(idx))
            if idx == eos_token:
                break
        if clean:
            pruned = [i for i in pruned if i not in (pad_token, bos_token, eos_token)]
        results.append(pruned)
    return results
