"""Typed configuration for retr_tpu_torch.

A copy of the reference package's ``Config`` dataclass (same knob names and
defaults, so one config JSON drives both packages). The port imports nothing of
``retr_tpu``; fields that only the JAX package reads (mesh sizes, Pallas flags,
compile-cache knobs) are kept so a config round-trips unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from os.path import join
from typing import Any


@dataclass(frozen=True)
class Config:
    """Frozen and hashable, like the reference package's Config."""

    # Dataset identity ("refcoco" | "refcoco+" | "refcocog").
    prefix: str = "refcoco"

    # Learning rates (reference: configuration_template.py:10-11, main.py:30-39 —
    # two AdamW param groups: backbone vs rest).
    lr_backbone: float = 1e-5
    lr: float = 1e-4

    # Epochs / schedule (reference: configuration_template.py:14-17).
    epochs: int = 30
    lr_drop: int = 20          # StepLR period (epochs); gamma fixed at 0.1 like torch default
    start_epoch: int = 0
    weight_decay: float = 1e-4

    # Backbone (reference: configuration_template.py:20-22).
    backbone: str = "ResNet101"          # ResNet18 | ResNet34 | ResNet50 | ResNet101
    position_embedding: str = "sine"     # "sine"/"v2" | "learned"/"v3"
    dilation: bool = True                # replace layer4 stride with dilation (output stride 16)

    # Basic (reference: configuration_template.py:25-36).
    device: str = "cuda"                 # the port's entry points run on CUDA unless told "cpu"
    seed: int = 42
    batch_size: int = 32
    num_workers: int = 8
    project_data_path: str = "./data"
    clip_max_norm: float = 0.1
    early_stopping: bool = True
    use_global_features: bool = False
    use_location_features: bool = False
    verbose: bool = True

    # Transformer (reference: configuration_template.py:39-51).
    transformer_type: str = "Concat"
    hidden_dim: int = 256
    pad_token_id: int = 0
    max_position_embeddings: int = 128
    layer_norm_eps: float = 1e-12        # DecoderEmbeddings LayerNorm only; residual norms use 1e-5
    dropout: float = 0.1
    vocab_size: int = 30522
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    nheads: int = 8
    pre_norm: bool = True

    # Dataset paths (reference: configuration_template.py:54-57).
    dir: str = "PATH_TO_COCO"
    ref_base: str = "PATH_TO_REF_BASE"
    ref_dir: str = ""                    # derived from ref_base/prefix when empty
    limit: int = -1                      # declared-but-unread in the reference; honored here

    # --- retr_tpu-only knobs (no reference equivalent) -------------------------------
    # Image side length fed to the backbone. The reference derives 224 from torchvision
    # weight metadata (data_utils/refcoco.py:14-25); we pin it explicitly.
    image_size: int = 224
    # Number of bbox location features. The reference computes 5
    # (data_utils/utils.py:198-228) but CaptionLoc declares Linear(7, ...) and crashes
    # (models/caption.py:60) — we use 5 consistently. Documented deviation.
    num_location_features: int = 5
    # Compute dtype for matmul-heavy paths: "float32" for parity, "bfloat16" for speed.
    compute_dtype: str = "float32"
    # Matmul/conv precision for the f32 backbone: "highest" (6-pass, the parity
    # default) or "high" (bf16x3, ~2x faster convs; verify token parity on your
    # checkpoint with tools/parity_check.py before enabling).
    backbone_precision: str = "highest"
    # Use the fused Pallas attention kernel where eligible (no attention-map output,
    # no attention dropout, TPU backend). Default False = the XLA path, which is the
    # bit-parity configuration; benchmarks enable it explicitly.
    use_pallas_attention: bool = False
    # Use fused Pallas residual-block kernels inside the KV-cached decode step
    # (ops/decoder_kernels.py). Off by default = XLA parity path.
    use_pallas_decode: bool = False
    # Beam search (north-star extension; the reference is greedy-only).
    beam_size: int = 5
    length_penalty: float = 1.0          # score / length**length_penalty
    # Stochastic sampling decoder (extension; decode.sample). temperature=0 or
    # top_k=1 reduce exactly to greedy; top_k=0 / top_p=1.0 disable the filters.
    sample_temperature: float = 1.0
    sample_top_k: int = 0
    sample_top_p: float = 1.0
    # Learning-rate schedule: "step" = the reference's StepLR (lr x0.1 every
    # lr_drop epochs, main.py:40 — the parity default) or "cosine" = cosine decay
    # to 0 over epochs*steps_per_epoch. warmup_steps > 0 prepends a linear ramp
    # 0 -> base lr over that many steps to either schedule (0 = reference behavior).
    lr_schedule: str = "step"
    warmup_steps: int = 0
    # Write per-epoch checkpoints on a background thread (train.checkpoints.AsyncSaver)
    # so serialization/disk IO overlaps the next epoch; main.py joins pending saves
    # at exit. Off by default = the strictly serial reference-shaped loop.
    async_checkpoints: bool = False
    # Gradient accumulation: micro-batches per optimizer update (train.state).
    # >1 shrinks the activation footprint by the factor; the update equals the
    # full-batch step (loss is a mean over rows). batch_size must be divisible.
    grad_accum_steps: int = 1
    # Rematerialization (jax.checkpoint) on every backbone residual block and
    # every encoder/decoder transformer layer: the backward pass recomputes
    # layer activations instead of keeping them resident, trading FLOPs for HBM
    # — the standard escape hatch for train batches whose activations OOM
    # (grad_accum_steps changes the step's micro-batching; remat does not).
    # Loss/gradients are identical math (tested); see docs/PERF.md for the
    # measured memory/throughput trade.
    remat: bool = False
    # Path to a BERT-style WordPiece vocab file; empty → synthetic test vocab.
    vocab_file: str = ""
    # Mesh axes for the multi-chip path: data-parallel x model-parallel.
    dp_size: int = 1
    mp_size: int = 1
    # Apply the deterministic all-masked guard to the TARGET stream as well as the
    # context stream. The reference guards only the context (caption.py:144) and
    # NaN-crashes if a target map is fully padded (possible at tiny feature maps);
    # the guard is a no-op whenever at least one target patch is visible, so it
    # never affects parity on valid data.
    guard_all_masked_target: bool = True

    checkpoint_path: str = ""
    # single-file checkpoint name knob kept for parity (configuration_template.py:29;
    # the reference declares it but its training loop writes per-epoch files instead)
    checkpoint: str = ""

    # --- the decoder (port-only knobs) -----------------------------------------------
    # "retr": RE:TR's 6-layer transformer decoder and MLP head. "lm": a DeepSeek-V3
    # block language model (models/lm.py) decodes after the encoder's memory,
    # projected to lm_hidden_size, as its prefix. The lm_* widths default to
    # Kimi-VL-A3B-Instruct's language model; only decoder_kind "lm" reads them,
    # and RE:TR configs serialize without them (to_dict), as the JAX package's do.
    decoder_kind: str = "retr"
    lm_hidden_size: int = 2048
    lm_layers: int = 27
    lm_heads: int = 16
    lm_kv_lora_rank: int = 512
    lm_qk_nope_head_dim: int = 128
    lm_qk_rope_head_dim: int = 64
    lm_v_head_dim: int = 128
    lm_intermediate_size: int = 11264        # the leading dense layers' SiLU-gated width
    lm_moe_intermediate_size: int = 1408     # one routed expert's width
    lm_n_routed_experts: int = 64
    lm_n_shared_experts: int = 2
    lm_num_experts_per_tok: int = 6
    lm_first_k_dense_replace: int = 1        # how many leading layers are dense
    lm_routed_scaling_factor: float = 2.446
    lm_rms_norm_eps: float = 1e-5
    lm_rope_theta: float = 800000.0

    def __post_init__(self) -> None:
        if not self.ref_dir:
            object.__setattr__(self, "ref_dir", join(self.ref_base, self.prefix))
        if not self.checkpoint_path:
            object.__setattr__(
                self, "checkpoint_path", join(self.project_data_path, "models", self.prefix)
            )
        if not self.checkpoint:
            object.__setattr__(self, "checkpoint", f"./{self.prefix}_checkpoint.pth")
        if self.backbone not in ("ResNet18", "ResNet34", "ResNet50", "ResNet101"):
            raise ValueError(f"unsupported backbone {self.backbone!r}")
        if self.position_embedding not in ("v2", "sine", "v3", "learned"):
            raise ValueError(f"not supported {self.position_embedding}")
        if self.hidden_dim % self.nheads != 0:
            raise ValueError("hidden_dim must be divisible by nheads")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported compute_dtype {self.compute_dtype!r}")
        if self.lr_schedule not in ("step", "cosine"):
            raise ValueError(f"unsupported lr_schedule {self.lr_schedule!r}")
        if self.warmup_steps < 0:
            raise ValueError("warmup_steps must be >= 0")
        if self.decoder_kind not in ("retr", "lm"):
            raise ValueError(f"unsupported decoder_kind {self.decoder_kind!r}")
        if self.decoder_kind == "lm":
            sizes = {f: getattr(self, f) for f in LM_FIELDS
                     if f.endswith(("_size", "_dim", "_rank", "layers", "heads", "_tok")) or f == "lm_n_routed_experts"}
            if min(sizes.values()) <= 0:
                raise ValueError(f"lm sizes must be positive: {sizes}")
            if self.lm_qk_rope_head_dim % 2:
                raise ValueError("lm_qk_rope_head_dim must be even (RoPE rotates pairs)")
            if self.lm_num_experts_per_tok > self.lm_n_routed_experts:
                raise ValueError("lm_num_experts_per_tok exceeds lm_n_routed_experts")
            if not 0 <= self.lm_first_k_dense_replace <= self.lm_layers:
                raise ValueError("lm_first_k_dense_replace must lie in [0, lm_layers]")

    # -- serialization (checkpoints embed the config instead of the reference's
    #    filename-substring sniffing, eval_model.py:49-82) --------------------------
    def to_dict(self) -> dict[str, Any]:
        """Every field; a RE:TR config leaves out the decoder's keys (all at
        their defaults), so its JSON is the JAX package's."""
        d = dataclasses.asdict(self)
        if self.decoder_kind == "retr":
            for k in ("decoder_kind", *LM_FIELDS):
                del d[k]
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    # Derived quantities ------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.nheads

    @property
    def backbone_num_channels(self) -> int:
        return 512 if self.backbone in ("ResNet18", "ResNet34") else 2048

    @property
    def feature_hw(self) -> int:
        """Backbone output side length: output stride 32, halved to 16 by dilation."""
        stride = 16 if self.dilation else 32
        return self.image_size // stride

    @property
    def num_patches(self) -> int:
        return self.feature_hw * self.feature_hw


LM_FIELDS = tuple(f.name for f in dataclasses.fields(Config) if f.name.startswith("lm_"))
