#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (retr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from retr_tpu_torch/csrc with nvcc, one process per
     source, all at once;
  3. hold each kernel against its plain PyTorch version at full width
     (C=256, 8 heads, F=2048, T=128, S=196, L=6, MLP 256-512-512-30522) in f32
     and bf16, and time kernel, plain version and a library yardstick (CUDA
     events): the stacked step, fused_layer_step and self_attn_block at batch
     32 and 512 (the stacked step's lines carry its grid: blocks, blocks per
     SM, grid barriers; self_attn_block's its cluster plan and profiled
     device time), ff_block and cross_attn_block at 32, 160, 512 and
     2560 rows (their lines carry the cluster launch's plan and the
     profiled device time), the
     stacked step (L=6) and fused_layer_step (L=1) also unclocked at batch 1,
     5, 32, 33 and 512 and step 0, 63 and 127 (a row seeing one memory
     position; a second launch must give the same bits and only the cache slot
     at `step` may change), ff_block and cross_attn_block unclocked at rows
     1, 5, 17 and 33, F 256 and 2048, S 1, 196 and 397, random padding or one
     unmasked key per row (a second launch bit-equal, x unwritten), the beam block and
     the top-k head at 160 and 2560 rows (batch 32 and 512 x beam 5), the
     argmax head at 32 and 512 rows (both heads with their profiled device
     time: the hand-written kernels alone, every kernel of the wrapper, and
     every kernel of the library yardstick), both heads unclocked at rows 1,
     5, 19, 33 and 129, vocab 5000 and 30522, k 1, 5, 8 and 256, with ties
     across 128-wide slab boundaries and in the ragged last slab (a second
     launch bit-equal), fused_attention at batch 32 for the
     encoder (196x196, key padding), the causal decoder (128x128, ~15 real
     tokens), the cross attention (128x196) and the (T,T) encoder (397x397),
     with its plan and device time, its yardstick scaled_dot_product_attention
     with the same additive mask (CUDA events and device time);
     attention_edges: fused_attention unclocked at head dims 16, 32 and 64,
     f32 and bf16, one query, 1, 15, 17, 397 and 1718 keys (the last past the
     tensor-core kernel: the untiled one), causal tiles the diagonal crosses,
     padding from a tile boundary, all-masked rows (a second launch
     bit-equal); beam_edges: self_attn_block_beam unclocked at beams 1, 2,
     3, 5 and 8, 1 and 33 groups, step 0, 63 and 127, ancestry on one row, a
     permutation, crossing at step (a second launch bit-equal, only the slot
     at step written); the beam block's records carry its cluster plan and
     device time; self_edges: self_attn_block unclocked at rows 1, 5, 17,
     32, 33 and 512, step 0, 63, 127 and T-1, T 128 and the longest the
     kernel takes, every row tile of its rule and its own choice (a second
     launch bit-equal, the same bits at every tile, only the slot at step
     written, x unwritten);
  4. serve requests through Predictor at the served width (ResNet-50 dilated,
     6+6 layers, d=256, vocab 30522, bf16, random weights from a seed): greedy
     with the one-launch stacked kernel, with the per-layer trio, with
     HEAD_KERNEL, and with MERGED_LAYER (LAYER_GRID off); beam search (beam 5)
     with BEAM_TOPK_KERNEL off and on; the launch counts are reset before and
     read after each run, and each kernel a run lists must have launched.
     Then time greedy at batch 32 and 512 and beam at batch 32 x 5 and 512 x 5
     (top-k head kernel off and on) for all 127 steps with EOS out of range,
     and trace 32 steps of greedy at 32 and 512 and beam at 32 x 5 and 512 x 5
     with torch.profiler (device time by kernel, idle share); then greedy with
     use_pallas_attention on, whose encoder launches fused_attention (6
     launches per batch);
  4b. serve_apis, the rest of the serving surface at the served width in bf16:
     the native host core must load, and its host seconds per request are
     logged beside the numpy spec's (outputs bit-equal); sampling at batch 32
     for all 127 steps (EOS out of range) with cfg's defaults (the
     full-vocabulary draw) and with top_k=50, top_p=0.9, beside greedy on the
     same images (captions/s, fused_stack_step launches), the sampling step's
     parts by CUDA events (topk_first, the top-p sort, the draw) and 32 steps
     of each under torch.profiler; Predictor.complete on 8 requests (the
     prefix words come first); Predictor.score on 8 requests with
     use_pallas_attention (finite, 18 fused_attention launches) and
     predict_with_attention (rows sum to 1 within 1e-3, no fused_attention
     launch); 256 requests from 8 threads through a ServingQueue (captions
     equal to predict_batch's; requests/s beside sequential predict_batch,
     p50/p99 latency); the HTTP server on an ephemeral port (/predict,
     /healthz naming the card, 503 with Retry-After under a forced
     overload); `python -m retr_tpu_torch.serve --checkpoint X.pth` on a
     reference .pth of Config()'s model, one request, then SIGTERM (exit 0);
  5. decoding at a width the tuned kernels do not take (hidden 64, 4 heads,
     2 layers, f32, head kernels on): greedy and beam 3 on the GPU, through
     csrc/width_kernels.cu, equal to the CPU's tokens;
     f32 on the GPU and on the CPU (plain path): a greedy batch of 4 has equal
     token buffers except where the CPU logits' top-2 margin is below 1e-4; a
     beam batch of 2 has equal top hypotheses except where the CPU search had
     a near-tie (gap below 1e-4 between its k-th and (k+1)-th candidate, or
     between its two best final scores);
  6. training at full width (random seeded weights, dropout 0.1): 3 train
     steps at batch 32 in bf16 and 3 in f32 (ms per step, losses finite) and
     a fourth under torch.profiler (device time by kernel, idle share); the
     bf16 validation loss at batch 32 with use_pallas_attention off and on
     (equal within 1e-4 relative; fused_attention launched 18 times per eval
     step: 6 encoder, 6 causal decoder, 6 cross); one f32 step at batch 2,
     dropout 0, on the GPU and on the CPU (loss within 1e-4 and pre-clip
     gradient norm within 1e-3 relative);
  6b. train_epoch, the training and evaluation loop (retr_tpu_torch.engine) at
     the served width in bf16, dropout 0.1, on a synthetic RefCOCO written to a
     temporary directory (128 images of 240-640 px saved by np.save under
     COCO's .jpg names, which preprocess.load_image reads without Pillow,
     100 training and 40 validation annotations with 1-3 expressions each): build_dataset and a
     shuffled DataLoader at batch 32 (an epoch of the loader alone first),
     two epochs of train_one_epoch (staged uploads off, then on; seconds,
     steps/s, samples/s, loss, peak memory) and four more with the two in
     turns, the batches of staged and inline uploads bit-equal, an epoch
     under torch.profiler; the scorer on the references themselves (BLEU-1
     and ROUGE-L 1); evaluate on the validation split with
     use_pallas_attention (18 fused_attention launches a batch); eval_model
     greedy (fused_stack_step) and beam 5 (self_attn_block_beam,
     cross_attn_block, ff_block) on the 40 unique validation annotations (a
     batch of 32 and a ragged 8): expressions/s, the PhaseTimer phases, every
     metric finite;
  6c. main, the training entry point end to end at the served width in bf16
     (dropout 0.1, use_pallas_attention, async checkpoints) on 6b's synthetic
     RefCOCO and a 30522-word vocab file: build_model on the card (parameter
     count, per-leaf bound, variance and identity-BN checks), main.main for 2
     epochs then resume=True to 3 (resume logged at epoch 2, epoch 2 trained
     alone; fused_stack_step and fused_attention launched), the latest
     checkpoint loaded and saved inline and through AsyncSaver (seconds, bytes),
     eval_model's main_val_set with --override_config (every metric equal to
     the last epoch_end's) and with --decoder beam (the beam kernels); on an
     untrained checkpoint, whose captions are not empty, the CLI's hypotheses
     equal to engine.eval_model's on the same parameters, greedy and beam;
     export_pth, Predictor.from_checkpoint of each directory against its .pth
     (parameters bit-equal, 8 captions and 8 scores equal); one ``main`` line;
  6d. parallel, the (dp, mp) mesh at the served width on 6b's synthetic
     RefCOCO: worlds of processes on the one card, (c) mp=2 and (b) dp=2 over
     gloo (NCCL refuses two ranks on one device), then (a) a world of one over
     NCCL; in each, 3 f32 train steps at dropout 0 on a global batch of 16
     (losses within 1e-4 relative of (a)'s), 3 bf16 steps at dropout 0.1
     (ms/step), evaluate with use_pallas_attention (local heads under mp),
     eval_model_sharded greedy and beam 5 on the 40 validation expressions
     of build_model(seed=1) in f32 (hypotheses equal to engine.eval_model's
     on one process except at the reference's near-ties, top-2 margin or
     beam candidate gap under 1e-4) and bf16 (equal ones counted); (a)
     restores (c)'s checkpoint and takes its next step within 1e-4, and
     drives main.main for an epoch through its 1x1 mesh; fused_stack_step,
     the beam trio and fused_attention launched on every rank; one
     ``parallel`` line per world;
  7. every kernel's launch count from its path's run must be > 0.

The card's line, then a line {"kernels": [...]} with one entry per kernel,
come before the last line, {"ok": true, "device": {...}}. It needs the rest of
the repository beside it and a CUDA device.

    python3 chip_smoke.py --compare PARENT_TREE CHANGE_TREE

compares two checkouts on one card: in turns (parent, change, change, parent,
parent, change), a process per turn profiles fused_attention,
self_attn_block_beam and self_attn_block (`--kernel-times TREE`: device time
per launch, fused_attention beside SDPA's) and another times the decode loops of the
retr_tpu_torch package under that tree (`--loop-times TREE`: greedy stacked
and trio at batch 32 and 512, beam 5 at batch 32 and 512 (top-k head kernel
off and on) where the tree has it, 127 steps, EOS out of range, encode outside the
timing, median of 5 runs after one warm-up) with this file's measuring code,
and prints a digest of the tree's stacked step on seeded inputs
(`stack_digest`: equal digests, equal bits).

    python3 chip_smoke.py --block-rows

times ff_block and cross_attn_block (bf16, device time) at every row tile
they are built for, and at their own choice, at 32, 160, 512 and 2560 rows,
and self_attn_block (f32 and bf16) at every row tile of its rule and its own
choice at 32 and 512 rows.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

C, H, D, F, T, S, L, V = 256, 8, 32, 2048, 128, 196, 6, 30522
MLP = 512                                         # the MLP head's hidden width
BEAM = 5                                          # Config.beam_size
HBM_BYTES_PER_S = 3.35e12                         # H100 SXM data sheet
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
CHECK_STEP = 63                                   # mid-decode position for the kernel checks
HEAD_SRC, ATT_SRC = "retr_tpu_torch/csrc/head_kernels.cu", "retr_tpu_torch/csrc/attention_kernels.cu"
STACK_SRC, BLOCK_SRC = "retr_tpu_torch/csrc/stack_kernels.cu", "retr_tpu_torch/csrc/block_kernels.cu"
KERNELS = {  # wrapper -> (the Pallas kernel it replaces, CUDA source, the main path's case (dtype, rows or shape))
    "fused_stack_step": ("retr_tpu/ops/decoder_kernels.py:1026", STACK_SRC, ("bfloat16", 32)),
    "self_attn_block": ("retr_tpu/ops/decoder_kernels.py:228", BLOCK_SRC, ("bfloat16", 32)),
    # the default beam path's shape: batch 32 x beam 5
    "cross_attn_block": ("retr_tpu/ops/decoder_kernels.py:450", BLOCK_SRC, ("bfloat16", 32 * BEAM)),
    "ff_block": ("retr_tpu/ops/decoder_kernels.py:96", BLOCK_SRC, ("bfloat16", 32 * BEAM)),
    "self_attn_block_beam": ("retr_tpu/ops/decoder_kernels.py:380", BLOCK_SRC, ("bfloat16", 32 * BEAM)),
    "mlp_head_argmax": ("retr_tpu/ops/decoder_kernels.py:525", HEAD_SRC, ("bfloat16", 32)),
    "mlp_head_topk": ("retr_tpu/ops/decoder_kernels.py:615", HEAD_SRC, ("bfloat16", 32 * BEAM)),
    "fused_layer_step": ("retr_tpu/ops/decoder_kernels.py:774", STACK_SRC, ("bfloat16", 32)),
    # the transformer computes in f32 in both compute types (input_proj promotes)
    "fused_attention": ("retr_tpu/ops/attention.py:80", ATT_SRC, ("float32", "encoder")),
}
# fused_attention cases: label -> (Sq, Sk, causal, key padding), batch 32
ATTN_SHAPES = {"encoder": (S, S, False, "image"), "decoder": (T, T, True, "caption"),
               "cross": (T, S, False, "image"), "encoder (T,T)": (2 * S + 5, 2 * S + 5, False, "image")}
TRAIN_BATCH = 32                                  # Config.batch_size
EVAL_STEPS = 2
# Tolerance of kernel vs plain version, as a fraction of max(1, max|plain|).
TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps=20, rounds=5):
    """Median over rounds of the mean CUDA-event time of ``reps`` calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return sorted(times)[len(times) // 2]


# ---------------------------------------------------------------------------------
# Phase 3: kernels against their plain versions at full width
# ---------------------------------------------------------------------------------


def random_decoder(gen, dev, dtype):
    """Leaf-stacked decoder layer params with xavier-like scales."""
    import torch

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype).contiguous()

    def lin(i, o):
        return {"w": rn(L, i, o, scale=(2.0 / (i + o)) ** 0.5), "b": rn(L, o, scale=0.02)}

    def norm():
        return {"scale": (1 + rn(L, C, scale=0.1).float()).to(dtype), "bias": rn(L, C, scale=0.1)}

    def mha():
        return {k: lin(C, C) for k in ("q", "k", "v", "out")}

    return {"self_attn": {"norm": norm(), "mha": mha()}, "cross_attn": {"norm": norm(), "mha": mha()},
            "ff": {"norm": norm(), "lin1": lin(C, F), "lin2": lin(F, C)}}


def kernel_work(name, b, esize, step):
    """(bytes, operations) the function needs for ``b`` rows: each input read
    once, each output written once; self caches read at the positions before
    ``step``. The heads count their weights and products (the top-k head's
    trunk runs outside the kernel, as on the TPU)."""
    attn_w = 4 * C * C + 6 * C          # q/k/v/out weights and biases, LN, qpos share
    cross_w = 2 * C * C + 5 * C
    ff_w = 2 * C * F + F + 3 * C
    io = 2 * b * C * esize              # x in, y out
    self_cache = 2 * b * H * step * D * esize + 2 * b * H * D * esize   # read prefix, write slot
    cross_kv = 2 * b * H * S * D * esize
    self_ops = 2 * b * (4 * C * C) + 2 * 2 * b * H * (step + 1) * D
    cross_ops = 2 * b * (2 * C * C) + 2 * 2 * b * H * S * D
    ff_ops = 2 * b * (2 * C * F)
    if name == "ff_block":
        return io + ff_w * esize, ff_ops
    if name == "cross_attn_block":
        return io + cross_w * esize + cross_kv + b * S * 4, cross_ops
    if name == "self_attn_block":
        return io + attn_w * esize + self_cache + 4, self_ops
    if name == "self_attn_block_beam":                  # + the [rows, T] int32 ancestry
        return io + attn_w * esize + self_cache + 4 + b * T * 4, self_ops
    if name == "mlp_head_argmax":
        w = C * MLP + MLP * MLP + MLP * V + 2 * MLP + V
        return b * C * esize + w * esize + b * 4, 2 * b * (C * MLP + MLP * MLP + MLP * V)
    if name == "mlp_head_topk":
        return b * MLP * esize + (MLP * V + V) * esize + b * BEAM * 8, 2 * b * MLP * V
    nl = 1 if name == "fused_layer_step" else L
    return (io + nl * ((attn_w + cross_w + ff_w) * esize + self_cache + cross_kv) + b * S * 4 + 4,
            nl * (self_ops + cross_ops + ff_ops))


def _tensor_err(got, want, dname):
    """Largest difference over the outputs, and its tolerance as a fraction of
    max(1, max|plain|): f32 differs only by summation order; bf16 rounds at
    the same points on both sides, but an f32 order difference can flip one
    rounding and propagate."""
    import torch

    got = [g.float() for g in (got if isinstance(got, tuple) else (got,))]
    want = [w.float() for w in (want if isinstance(want, tuple) else (want,))]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    return (err if finite else float("inf")), TOL[dname] * max(1.0, float(want[0].abs().max()))


def measure(name, dname, rows, kern, plain, lib, nl, err_fn=None, extra=None):
    """Hold kern(0) against plain(0), then time kernel, plain version and library
    yardstick (each a function of the layer index, cycled over ``nl`` layers as
    the decode loop does). ``extra`` joins the record; where it holds a
    profiled ``device_ms``, that is the record's ``ms`` and the events' time
    (host-bound when the wrapper is slower than the kernel) is ``ms_events``.
    Returns the record; raises if they disagree."""
    import torch

    from retr_tpu_torch.precision import matmul_precision

    with matmul_precision(torch.float32):   # plain versions in full f32
        got, want = kern(0), plain(0)
        torch.cuda.synchronize()
        err, tol = (err_fn or _tensor_err)(got, want, dname)
        cyc = lambda fn: (lambda: [fn(li) for li in range(nl)])  # noqa: E731
        ms = time_ms(cyc(kern)) / nl
        plain_ms = time_ms(cyc(plain), reps=5, rounds=3) / nl
        lib_ms = None if lib is None else time_ms(cyc(lib)) / nl
    nbytes, ops = kernel_work(name, rows, 4 if dname == "float32" else 2, CHECK_STEP)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dname] * 1e3
    rec = dict(name=name, dtype=dname, batch=rows, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", **(extra or {}))
    if isinstance(rec.get("device_ms"), float):   # the kernel alone, not the host's wrapper
        rec["ms_events"], rec["ms"] = ms, rec["device_ms"]
    log("kernel", json.dumps(rec))
    if not err <= tol:
        raise AssertionError(f"{name} {dname} rows={rows}: max_abs_err {err} > {tol}")
    return rec


SELF_KERNEL = "self_beam_kernel"   # the CUDA function behind self_attn_block and self_attn_block_beam


def check_kernels(dev):
    """The stacked step, fused_layer_step and self_attn_block at batch 32 and
    512 (self_attn_block with its cluster plan and profiled device time; the
    six layers' caches it cycles, 25 MB at 32 rows in bf16, stay in the 50 MB
    L2, 403 MB at 512 rows come from HBM). Returns {(name, dtype, rows): record}."""
    import torch
    import torch.nn.functional as Fn

    from retr_tpu_torch.ops import decoder_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        slp = random_decoder(gen, dev, dtype)
        layers_ = [dk.layer_params(slp, li) for li in range(L)]
        for b in (32, 512):
            rn = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)  # noqa: E731
            x, qpos = rn(b, C), rn(C, s=0.5)
            kc, vc = rn(L, b, H, T, D), rn(L, b, H, T, D)
            ck, cv = rn(L, b, H, S, D), rn(L, b, H, S, D)
            pad = torch.rand(b, S, generator=gen, device=dev) < 0.2
            pad[:, 0] = False
            kb = torch.where(pad, float("-inf"), 0.0)
            step = torch.tensor(CHECK_STEP, dtype=torch.int32, device=dev)
            kc_k, vc_k, kc_p, vc_p = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            cases = {
                "fused_stack_step": (
                    lambda li: dk.fused_stack_step(slp, x, qpos, kc_k, vc_k, ck, cv, kb, step, num_heads=H),
                    lambda li: dk.fused_stack_step_plain(slp, x, qpos, kc_p, vc_p, ck, cv, kb, step, num_heads=H),
                    None),
                "self_attn_block": (
                    lambda li: dk.self_attn_block(layers_[li]["self_attn"], x, qpos, kc_k[li], vc_k[li], step, num_heads=H),
                    lambda li: dk.self_attn_block_plain(layers_[li]["self_attn"], x, qpos, kc_p[li], vc_p[li], step, num_heads=H),
                    # yardstick: PyTorch's attention over the cache prefix alone
                    lambda li: Fn.scaled_dot_product_attention(
                        x.view(b, H, 1, D), kc[li, :, :, :CHECK_STEP + 1], vc[li, :, :, :CHECK_STEP + 1])),
                "fused_layer_step": (
                    lambda li: dk.fused_layer_step(layers_[li], x, qpos, kc_k[li], vc_k[li], ck[li], cv[li], kb, step,
                                                   num_heads=H),
                    lambda li: dk.fused_layer_step_plain(layers_[li], x, qpos, kc_p[li], vc_p[li], ck[li], cv[li], kb,
                                                         step, num_heads=H),
                    None),
            }
            for name, (kern, plain, lib) in cases.items():
                # split kernels cycle over the 6 layers' weights and K/V, as
                # the decode loop does; the stacked one covers them per launch
                nl = 1 if name == "fused_stack_step" else L
                extra = None
                if name in STACKED:
                    layers = L if name == "fused_stack_step" else 1
                    grid = dk.stack_grid(dtype, b, T, S, F, layers)
                    extra = {"grid": grid, **stack_detail(lambda: kern(0), grid)}
                elif name == "self_attn_block":
                    extra = {"plan": dk.block_plan(name, dtype, b, t=T),
                             "device_ms": device_ms(lambda: [kern(li) for li in range(L)], SELF_KERNEL),
                             "library": "SDPA over the cache prefix: the attention core alone, not the same function"}
                out[(name, dname, b)] = measure(name, dname, b, kern, plain, lib, nl, extra=extra)
    return out


STACKED = ("fused_stack_step", "fused_layer_step")   # rt_stack_step with L = 6 and L = 1
STACK_PHASES = ("ln1_qkv", "self_attn", "self_out_proj", "ln2_cross_q", "cross_attn", "cross_out_proj",
                "ln3_ff1", "ff2", "ff2_chunk_sum")   # the last only where FF2 is split


def stack_detail(call, grid):
    """rt_stack_step's device time per launch (torch.profiler over 20
    launches, the kernel alone: the events of ``measure`` include the host's
    wrapper when it is slower than the kernel) and its phase times from the
    kernel's own trace of one launch (block 0's clock at each grid barrier),
    in microseconds per phase kind summed over the layers."""
    import torch

    from retr_tpu_torch.ops import decoder_kernels as dk

    dms = device_ms(call, "stack_kernel")
    dk._stack_trace = torch.zeros(grid["grid_barriers"] + 2, dtype=torch.int64, device="cuda")
    try:
        call()
        torch.cuda.synchronize()
        stamps = dk._stack_trace.tolist()
    finally:
        dk._stack_trace = None
    dur = [(b - a) / 1e3 for a, b in zip(stamps, stamps[1:])]
    names = STACK_PHASES if grid["ff2_chunks"] > 1 else STACK_PHASES[:-1]
    return {"device_ms": dms, "traced_launch_us": (stamps[-1] - stamps[0]) / 1e3,
            "phase_us": {n: sum(dur[i::len(names)]) for i, n in enumerate(names)}}


def device_ms(call, kernel, calls=20, per_call=False):
    """Mean device time of the launches of the kernels whose name holds
    ``kernel`` (a string, or a tuple of strings any of which may match) over
    ``calls`` calls of ``call`` after a warm-up call (torch.profiler, which
    may drop an event of a long trace): the kernel alone, where CUDA events
    over back-to-back calls also hold the host's wrapper when it is the
    slower. ``per_call``: their summed time per call, for a wrapper that makes
    several launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)]
    if not spans:
        return "not measured (no CUDA events traced)"
    return sum(spans) / (calls if per_call else len(spans)) / 1e3


BLOCK_ROWS = (32, 160, 512, 2560)     # greedy 32 / 512, beam 32 x 5 / 512 x 5
BLOCK_KERNEL = {"ff_block": "ff_kernel", "cross_attn_block": "cross_kernel"}   # CUDA function names


def check_blocks(dev):
    """ff_block and cross_attn_block at 32, 160, 512 and 2560 rows, f32 and
    bf16, with their launch plan and profiled device time. Yardsticks: ff,
    F.layer_norm + F.linear + relu + F.linear + the add (cuBLAS, several
    calls); cross, SDPA over the memory K/V alone (the attention core, not
    the same function). Returns {(name, dtype, rows): record}."""
    import torch
    import torch.nn.functional as Fn

    from retr_tpu_torch.ops import decoder_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        layers_ = [dk.layer_params(random_decoder(gen, dev, dtype), li) for li in range(L)]
        ffw = [{k: lp["ff"][k]["w"].t().contiguous() for k in ("lin1", "lin2")} for lp in layers_]
        for b in BLOCK_ROWS:
            rn = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)  # noqa: E731
            x, qpos = rn(b, C), rn(C, s=0.5)
            ck, cv = rn(L, b, H, S, D), rn(L, b, H, S, D)
            pad = torch.rand(b, S, generator=gen, device=dev) < 0.2
            pad[:, 0] = False
            kb = torch.where(pad, float("-inf"), 0.0)
            mask = kb.clamp_min(-1e30).to(dtype)[:, None, None, :]

            def ff_lib(li):
                fp = layers_[li]["ff"]
                h = Fn.layer_norm(x, (C,), fp["norm"]["scale"], fp["norm"]["bias"])
                h = torch.relu(Fn.linear(h, ffw[li]["lin1"], fp["lin1"]["b"]))
                return x + Fn.linear(h, ffw[li]["lin2"], fp["lin2"]["b"])

            cases = {
                "cross_attn_block": (
                    lambda li: dk.cross_attn_block(layers_[li]["cross_attn"], x, qpos, ck[li], cv[li], kb, num_heads=H),
                    lambda li: dk.cross_attn_block_plain(layers_[li]["cross_attn"], x, qpos, ck[li], cv[li], kb,
                                                         num_heads=H),
                    lambda li: Fn.scaled_dot_product_attention(x.view(b, H, 1, D), ck[li], cv[li], attn_mask=mask)),
                "ff_block": (lambda li: dk.ff_block(layers_[li]["ff"], x),
                             lambda li: dk.ff_block_plain(layers_[li]["ff"], x), ff_lib),
            }
            for name, (kern, plain, lib) in cases.items():
                extra = {"plan": dk.block_plan(name, dtype, b, S, F),
                         "device_ms": device_ms(lambda: [kern(li) for li in range(L)], BLOCK_KERNEL[name])}
                out[(name, dname, b)] = measure(name, dname, b, kern, plain, lib, L, extra=extra)
            del ck, cv
            torch.cuda.empty_cache()
    return out


BLOCK_TILES = {"ff_block": (16, 32, 64), "cross_attn_block": (4, 8, 16, 32)}   # the row tiles each is built for


def block_rows(dev, card):
    """--block-rows: ff_block and cross_attn_block device time (bf16,
    torch.profiler) at every row tile they are built for and at their own
    choice, at BLOCK_ROWS rows, and self_attn_block's (f32 and bf16, step 63)
    at every tile of SELF_TILES and its own choice at 32 and 512 rows, the six
    layers' weights and K/V or caches cycled as the decode loop cycles them.
    One line per (kernel, dtype, rows, tile)."""
    import torch

    from retr_tpu_torch.ops import decoder_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(6)
    dtype = torch.bfloat16
    layers_ = [dk.layer_params(random_decoder(gen, dev, dtype), li) for li in range(L)]
    for b in BLOCK_ROWS:
        rn = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)  # noqa: E731
        x, qpos, ck, cv = rn(b, C), rn(C, s=0.5), rn(L, b, H, S, D), rn(L, b, H, S, D)
        kb = torch.where(torch.rand(b, S, generator=gen, device=dev) < 0.2, float("-inf"), 0.0)
        kb[:, 0] = 0.0
        calls = {"ff_block": lambda: [dk.ff_block(layers_[li]["ff"], x) for li in range(L)],
                 "cross_attn_block": lambda: [dk.cross_attn_block(layers_[li]["cross_attn"], x, qpos, ck[li], cv[li],
                                                                  kb, num_heads=H) for li in range(L)]}
        for name, call in calls.items():
            for tile in BLOCK_TILES[name] + (0,):
                dk._block_rows = tile
                try:
                    ms = device_ms(call, BLOCK_KERNEL[name])
                    plan = dk.block_plan(name, dtype, b, S, F)
                finally:
                    dk._block_rows = 0
                log("block_rows", json.dumps({"kernel": name, "dtype": "bfloat16", "rows": b,
                                              "tile": tile or f"own choice ({plan['rows']})", "device_ms": ms,
                                              "plan": plan, "card": card}))
        del ck, cv
        torch.cuda.empty_cache()
    step = torch.tensor(CHECK_STEP, dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        layers_ = [dk.layer_params(random_decoder(gen, dev, dtype), li)["self_attn"] for li in range(L)]
        for b in (32, 512):
            rn = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)  # noqa: E731
            x, qpos, kc, vc = rn(b, C), rn(C, s=0.5), rn(L, b, H, T, D), rn(L, b, H, T, D)
            call = lambda: [dk.self_attn_block(layers_[li], x, qpos, kc[li], vc[li], step,  # noqa: E731
                                               num_heads=H) for li in range(L)]
            for tile in SELF_TILES + (0,):
                dk._beam_rows = tile
                try:
                    ms = device_ms(call, SELF_KERNEL)
                    plan = dk.block_plan("self_attn_block", dtype, b, t=T)
                finally:
                    dk._beam_rows = 0
                log("block_rows", json.dumps({"kernel": "self_attn_block", "dtype": str(dtype)[6:], "rows": b,
                                              "tile": tile or f"own choice ({plan['rows']})", "device_ms": ms,
                                              "plan": plan, "card": card}))
            del kc, vc
            torch.cuda.empty_cache()


def check_block_edges(dev):
    """ff_block at rows 1, 5, 17 and 33 and F 256 and 2048, cross_attn_block
    at those rows and S 1, 196 and 397, with the memory padded at random or
    every row left one unmasked key; f32 and bf16, against the plain
    versions. A second launch must give the same bits and x must be left
    unwritten. Prints one line; raises on a miss."""
    import torch

    from retr_tpu_torch.ops import decoder_kernels as dk
    from retr_tpu_torch.precision import matmul_precision

    gen = torch.Generator(device=dev).manual_seed(9)
    worst, cases = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        rn = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)  # noqa: E731
        lp = dk.layer_params(random_decoder(gen, dev, dtype), 0)
        small = {"norm": lp["ff"]["norm"], "lin1": {"w": lp["ff"]["lin1"]["w"][:, :256].contiguous(),
                                                    "b": lp["ff"]["lin1"]["b"][:256].contiguous()},
                 "lin2": {"w": lp["ff"]["lin2"]["w"][:256].contiguous(), "b": lp["ff"]["lin2"]["b"]}}
        for b in (1, 5, 17, 33):
            x, qpos = rn(b, C), rn(C, s=0.5)
            runs = [(f"ff F={fp['lin1']['w'].shape[1]}", lambda fn, fp=fp: fn(fp, x)) for fp in (small, lp["ff"])]
            for s_ in (1, S, 2 * S + 5):
                ck, cv = rn(b, H, s_, D), rn(b, H, s_, D)
                for masking in ("random", "one key"):
                    if masking == "random":
                        pad = torch.rand(b, s_, generator=gen, device=dev) < 0.3
                        pad[:, 0] = False
                    else:
                        keep = torch.randint(0, s_, (b, 1), generator=gen, device=dev)
                        pad = torch.arange(s_, device=dev)[None, :] != keep
                    kb = torch.where(pad, float("-inf"), 0.0)
                    runs.append((f"cross S={s_} {masking}",
                                 lambda fn, ck=ck, cv=cv, kb=kb: fn(lp["cross_attn"], x, qpos, ck, cv, kb, num_heads=H)))
            for label, call in runs:
                name = "ff_block" if label.startswith("ff") else "cross_attn_block"
                x0 = x.clone()
                got, again = call(getattr(dk, name)), call(getattr(dk, name))
                with matmul_precision(torch.float32):
                    want = call(getattr(dk, name + "_plain"))
                torch.cuda.synchronize()
                err, tol = _tensor_err(got, want, dname)
                same = torch.equal(_bits(got), _bits(again)) and torch.equal(_bits(x), _bits(x0))
                key = f"{label.split(' ')[0]} {dname}"
                worst[key] = max(worst.get(key, 0.0), err / tol)
                cases += 1
                if not (err <= tol and same):
                    raise AssertionError(f"{label} {dname} rows {b}: err {err} (tol {tol}), "
                                         f"same bits and x unwritten {same}")
    log("block_edges", json.dumps({"cases": cases, "worst_err_over_tol": worst}))


def _bits(t):
    """The tensor's bits, for byte-for-byte comparison."""
    import torch

    return t.contiguous().view(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_stack_edges(dev):
    """The stacked step (L=6) and fused_layer_step (L=1) against their plain
    versions at batch 1, 5, 32, 33 and 512 and step 0, 63 and T-1, f32 and bf16;
    row 0's key bias leaves it one memory position. A second launch on the same
    inputs must give the same bits, and the caches may change only at the slot
    ``step`` of the launched layers. Prints one line; raises on a miss."""
    import torch

    from retr_tpu_torch.ops import decoder_kernels as dk
    from retr_tpu_torch.precision import matmul_precision

    gen = torch.Generator(device=dev).manual_seed(4)
    worst, cases = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        slp = random_decoder(gen, dev, dtype)
        for b in (1, 5, 32, 33, 512):
            rn = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)  # noqa: E731
            x, qpos = rn(b, C), rn(C, s=0.5)
            kc, vc = rn(L, b, H, T, D), rn(L, b, H, T, D)
            ck, cv = rn(L, b, H, S, D), rn(L, b, H, S, D)
            pad = torch.rand(b, S, generator=gen, device=dev) < 0.2
            pad[:, 0] = False
            pad[0, 1:] = True
            kb = torch.where(pad, float("-inf"), 0.0)
            for step_v in (0, CHECK_STEP, T - 1):
                step = torch.tensor(step_v, dtype=torch.int32, device=dev)
                keep = torch.arange(T, device=dev) != step_v
                for name in STACKED:
                    nl = L if name == "fused_stack_step" else 1

                    def call(fn, k, v):
                        if nl == L:
                            return fn(slp, x, qpos, k, v, ck, cv, kb, step, num_heads=H)[0]
                        return fn(dk.layer_params(slp, 0), x, qpos, k[0], v[0], ck[0], cv[0], kb, step,
                                  num_heads=H)[0]

                    runs = [(kc.clone(), vc.clone()) for _ in range(3)]
                    got, again = call(getattr(dk, name), *runs[0]), call(getattr(dk, name), *runs[1])
                    with matmul_precision(torch.float32):
                        want = call(getattr(dk, name + "_plain"), *runs[2])
                    torch.cuda.synchronize()
                    err, tol = _tensor_err((got, runs[0][0][:nl, :, :, step_v], runs[0][1][:nl, :, :, step_v]),
                                           (want, runs[2][0][:nl, :, :, step_v], runs[2][1][:nl, :, :, step_v]),
                                           dname)
                    same = torch.equal(_bits(got), _bits(again)) and all(
                        torch.equal(_bits(runs[0][i]), _bits(runs[1][i])) for i in (0, 1))
                    untouched = all(
                        torch.equal(_bits(runs[0][i][:nl, :, :, keep]), _bits(orig[:nl, :, :, keep]))
                        and torch.equal(_bits(runs[0][i][nl:]), _bits(orig[nl:])) for i, orig in enumerate((kc, vc)))
                    key = f"{name} {dname}"
                    worst[key] = max(worst.get(key, 0.0), err / tol)
                    cases += 1
                    if not (err <= tol and same and untouched):
                        raise AssertionError(f"{name} {dname} batch {b} step {step_v}: err {err} (tol {tol}), "
                                             f"same bits {same}, other slots untouched {untouched}")
            del kc, vc, ck, cv
        torch.cuda.empty_cache()
    log("stack_edges", json.dumps({"cases": cases, "worst_err_over_tol": worst}))


def random_head(gen, dev, dtype):
    """The MLP head 256 -> 512 -> 512 -> 30522 with PyTorch's default Linear scales."""
    import torch

    def lin(i, o):
        bound = i ** -0.5
        return {"w": ((torch.rand(i, o, generator=gen, device=dev) * 2 - 1) * bound).to(dtype),
                "b": ((torch.rand(o, generator=gen, device=dev) * 2 - 1) * bound).to(dtype)}

    return {"layers": [lin(C, MLP), lin(MLP, MLP), lin(MLP, V)]}


# csrc/head_kernels.cu's CUDA functions: mlp_head_argmax launches both,
# mlp_head_topk the vocab kernel alone (its trunk runs in torch)
HEAD_KERNEL_NAMES = {"mlp_head_argmax": ("trunk_kernel", "vocab_kernel"), "mlp_head_topk": ("vocab_kernel",)}


def head_device_times(kernel_call, library_call, name):
    """Profiled device time per call of a head: its hand-written kernels alone
    (``device_ms``), every kernel its wrapper launches, the torch trunk and
    the combine across slabs included (``wrapper_device_ms``), and every
    kernel of the library yardstick (``library_device_ms``): the last two
    compare like with like."""
    return {"device_ms": device_ms(kernel_call, HEAD_KERNEL_NAMES[name], per_call=True),
            "wrapper_device_ms": device_ms(kernel_call, "", per_call=True),
            "library_device_ms": device_ms(library_call, "", per_call=True)}


def head_ties(vocab):
    """Equal best columns: an early one, both sides of the first two 128-wide
    slab boundaries, the first and last column of the ragged last slab."""
    last = (vocab - 1) // 128 * 128
    return (3, 127, 128, 256, last, vocab - 1)


def head_case(head, packed, x, k, ties=()):
    """Both head kernels on ``packed`` (pack_head of ``head``) against their
    plain versions on ``head``, for rows ``x`` and ``k`` tokens: ``err``, the
    f32 logit the argmax kernel's pick gives up against the plain pick and the
    top-k scores' distance from the plain ones and from the plain
    log-softmax of the tokens the kernel chose, within ``tol`` (1e-4 of
    max(1, max|logit|)); ``same``, a second launch of each gives the same bits;
    ``lowest``, where ``ties`` lists tied best columns, the lowest come out
    first. Launches each kernel twice."""
    import torch

    from retr_tpu_torch.ops import decoder_kernels as dk
    from retr_tpu_torch.precision import matmul_precision

    ids, again = dk.mlp_head_argmax(packed, x), dk.mlp_head_argmax(packed, x)
    (sc, tok), (sc2, tok2) = dk.mlp_head_topk(packed, x, k), dk.mlp_head_topk(packed, x, k)
    with matmul_precision(torch.float32):
        want_ids = dk.mlp_head_argmax_plain(head, x)
        want_sc, _ = dk.mlp_head_topk_plain(head, x, k)
        l3 = head["layers"][2]
        lg = dk._dot(dk._head_trunk(head, x), l3["w"]) + l3["b"].float()      # the argmax head's logits
        lg_k = dk._dot(dk._torch_trunk(head, x), l3["w"]) + l3["b"].float()   # the top-k head's
    torch.cuda.synchronize()
    assert ids.dtype == tok.dtype == torch.int32 and tuple(tok.shape) == (x.shape[0], k)
    gap = float((lg.gather(1, want_ids.long()[:, None]) - lg.gather(1, ids.long()[:, None])).abs().max())
    own = torch.log_softmax(lg_k, dim=1).gather(1, tok.long())
    err = max(gap, float((sc - own).abs().max()), float((sc - want_sc).abs().max()))
    same = torch.equal(ids, again) and torch.equal(tok, tok2) and torch.equal(_bits(sc), _bits(sc2))
    n = min(k, len(ties))
    lowest = not ties or (bool((ids == ties[0]).all()) and tok[:, :n].tolist() == [list(ties[:n])] * x.shape[0])
    return {"err": err, "tol": TOL["float32"] * max(1.0, float(lg.abs().max())), "same": same, "lowest": lowest}


def check_beam_and_heads(dev):
    """The beam block and the top-k head at 160 and 2560 rows (batch 32 and 512
    x beam 5), the argmax head at 32 and 512 rows; the heads with their
    profiled device time per call. Returns {(name, dtype, rows): record}."""
    import torch
    import torch.nn.functional as Fn

    from retr_tpu_torch.models import caption
    from retr_tpu_torch.ops import decoder_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        layers_ = [dk.layer_params(random_decoder(gen, dev, dtype), li) for li in range(L)]
        head = random_head(gen, dev, dtype)
        packed = dk.pack_head(head)                       # what the decode loop hands the kernels
        l3 = head["layers"][2]

        def argmax_err(got, want, dname):
            """f32 logit the kernel's pick gives up against the plain pick."""
            lg = dk._dot(dk._head_trunk(head, xh), l3["w"]) + l3["b"].float()
            lost = lg.gather(1, want.long()[:, None]) - lg.gather(1, got.long()[:, None])
            return float(lost.abs().max()), TOL[dname] * max(1.0, float(lg.abs().max()))

        def topk_err(got, want, dname):
            """Kernel scores against the plain ones, and against the plain
            log-softmax of the tokens the kernel chose."""
            lg = dk._dot(dk._torch_trunk(head, xk), l3["w"]) + l3["b"].float()
            own = torch.log_softmax(lg, dim=1).gather(1, got[1].long())
            err = max(float((got[0] - want[0]).abs().max()), float((got[0] - own).abs().max()))
            return err, TOL[dname] * max(1.0, float(want[0].abs().max()))

        for b in (32, 512):
            bk = b * BEAM
            rn = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)  # noqa: E731
            x, qpos = rn(bk, C), rn(C, s=0.5)
            kc, vc = rn(L, bk, H, T, D), rn(L, bk, H, T, D)
            # an ancestry that crosses rows in every group, at `step` too
            anc = torch.randint(0, BEAM, (bk, T), generator=gen, device=dev, dtype=torch.int32)
            step = torch.tensor(CHECK_STEP, dtype=torch.int32, device=dev)
            kc_k, vc_k, kc_p, vc_p = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            src = (torch.arange(bk, device=dev) // BEAM * BEAM)[:, None] + anc[:, :CHECK_STEP + 1].long()
            pos = torch.arange(CHECK_STEP + 1, device=dev)
            # yardstick: PyTorch's attention over the ancestry-gathered prefix
            # (the gather done once, outside the timing)
            kg = kc.transpose(2, 3)[:, src, pos].transpose(2, 3).contiguous()   # [L, rows, H, step+1, D]
            vg = vc.transpose(2, 3)[:, src, pos].transpose(2, 3).contiguous()
            beam_kern = lambda li: dk.self_attn_block_beam(  # noqa: E731
                layers_[li]["self_attn"], x, anc, qpos, kc_k[li], vc_k[li], step, num_heads=H, num_beams=BEAM)
            extra = {"plan": dk.block_plan("self_attn_block_beam", dtype, bk, t=T, num_beams=BEAM),
                     "device_ms": device_ms(lambda: [beam_kern(li) for li in range(L)], SELF_KERNEL)}
            out[("self_attn_block_beam", dname, bk)] = measure(
                "self_attn_block_beam", dname, bk, beam_kern,
                lambda li: dk.self_attn_block_beam_plain(layers_[li]["self_attn"], x, anc, qpos, kc_p[li], vc_p[li],
                                                         step, num_heads=H, num_beams=BEAM),
                lambda li: Fn.scaled_dot_product_attention(x.view(bk, H, 1, D), kg[li], vg[li]), L, extra=extra)
            del kg, vg, kc, vc, kc_k, vc_k, kc_p, vc_p

            xk = rn(bk, C)
            topk_call = lambda: dk.mlp_head_topk(packed, xk, BEAM)  # noqa: E731
            # yardstick (several calls): cuBLAS head, topk, logsumexp
            topk_lib = lambda: (lambda lg: (lg.topk(BEAM, dim=-1), lg.logsumexp(dim=-1)))(  # noqa: E731
                caption.mlp_head(head, xk).float())
            out[("mlp_head_topk", dname, bk)] = measure(
                "mlp_head_topk", dname, bk, lambda li: topk_call(),
                lambda li: dk.mlp_head_topk_plain(head, xk, BEAM), lambda li: topk_lib(), 1, topk_err,
                head_device_times(topk_call, topk_lib, "mlp_head_topk"))
            xh = rn(b, C)
            argmax_call = lambda: dk.mlp_head_argmax(packed, xh)  # noqa: E731
            argmax_lib = lambda: caption.mlp_head(head, xh).argmax(dim=-1)  # noqa: E731   cuBLAS head, argmax
            out[("mlp_head_argmax", dname, b)] = measure(
                "mlp_head_argmax", dname, b, lambda li: argmax_call(),
                lambda li: dk.mlp_head_argmax_plain(head, xh), lambda li: argmax_lib(), 1, argmax_err,
                head_device_times(argmax_call, argmax_lib, "mlp_head_argmax"))
            torch.cuda.empty_cache()
    return out


BEAM_EDGE_ANCESTRY = ("one row", "permutation", "crossing at step")


def beam_case(dev, gen, lp, beams, groups, step, ancestry, rows=0):
    """self_attn_block_beam twice (``rows``: dk._beam_rows for the launch) and
    self_attn_block_beam_plain on seeded inputs, caches of T positions:
    ``err`` and ``tol`` over the output and the written slot, ``same`` (the
    two launches bit-equal, output and caches), ``untouched`` (no other cache
    slot changed). Ancestry: every row of a group reads one random row
    ("one row"), each position a random permutation of the group
    ("permutation"), or rows read another row, at ``step`` too ("crossing at
    step"). Launches the kernel twice."""
    import torch

    from retr_tpu_torch.ops import decoder_kernels as dk
    from retr_tpu_torch.precision import matmul_precision

    dtype = lp["mha"]["q"]["w"].dtype
    bk = beams * groups
    x = torch.randn(bk, C, generator=gen, device=dev).to(dtype)
    qpos = (torch.randn(C, generator=gen, device=dev) * 0.5).to(dtype)
    kc, vc = (torch.randn(bk, H, T, D, generator=gen, device=dev).to(dtype) for _ in range(2))
    if ancestry == "one row":
        anc = torch.randint(0, beams, (groups, 1, 1), generator=gen, device=dev).expand(groups, beams, T)
    elif ancestry == "permutation":
        anc = torch.rand(groups, T, beams, generator=gen, device=dev).argsort(dim=2).transpose(1, 2)
    else:
        anc = (torch.arange(beams, device=dev)[None, :, None] + 1 +
               torch.randint(0, max(beams - 1, 1), (groups, beams, T), generator=gen, device=dev)) % beams
    anc = anc.reshape(bk, T).to(torch.int32).contiguous()
    stept = torch.tensor(step, dtype=torch.int32, device=dev)
    runs = [(kc.clone(), vc.clone()) for _ in range(3)]
    old = dk._beam_rows
    dk._beam_rows = rows
    try:
        got, again = (dk.self_attn_block_beam(lp, x, anc, qpos, *runs[i], stept, num_heads=H, num_beams=beams)[0]
                      for i in (0, 1))
    finally:
        dk._beam_rows = old
    with matmul_precision(torch.float32):
        want = dk.self_attn_block_beam_plain(lp, x, anc, qpos, *runs[2], stept, num_heads=H, num_beams=beams)[0]
    torch.cuda.synchronize()
    err, tol = _tensor_err((got, runs[0][0][:, :, step], runs[0][1][:, :, step]),
                           (want, runs[2][0][:, :, step], runs[2][1][:, :, step]), str(dtype)[6:])
    keep = torch.arange(T, device=dev) != step
    same = torch.equal(_bits(got), _bits(again)) and all(torch.equal(_bits(runs[0][i]), _bits(runs[1][i]))
                                                         for i in (0, 1))
    untouched = all(torch.equal(_bits(runs[0][i][:, :, keep]), _bits(orig[:, :, keep]))
                    for i, orig in enumerate((kc, vc)))
    return {"err": err, "tol": tol, "same": same, "untouched": untouched, "out": got}


def check_beam_edges(dev):
    """self_attn_block_beam, untimed, against its plain version (beam_case) at
    beams 1, 2, 3, 5 and 8, 1 and 33 groups, step 0, 63 and T-1, the three
    ancestries, f32 and bf16. Prints one line; raises on a miss."""
    import torch

    from retr_tpu_torch.ops import decoder_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(13)
    worst, cases, tiles = {}, 0, set()
    for dtype in (torch.float32, torch.bfloat16):
        lp = dk.layer_params(random_decoder(gen, dev, dtype), 0)["self_attn"]
        for beams in (1, 2, 3, 5, 8):
            for groups in (1, 33):
                tiles.add(dk.block_plan("self_attn_block_beam", dtype, beams * groups, t=T, num_beams=beams)["rows"])
                for step in (0, CHECK_STEP, T - 1):
                    for ancestry in BEAM_EDGE_ANCESTRY:
                        got = beam_case(dev, gen, lp, beams, groups, step, ancestry)
                        key = f"{str(dtype)[6:]} beam {beams}"
                        worst[key] = max(worst.get(key, 0.0), got["err"] / got["tol"])
                        cases += 1
                        if not (got["err"] <= got["tol"] and got["same"] and got["untouched"]):
                            raise AssertionError(f"self_attn_block_beam {key} groups {groups} step {step} "
                                                 f"{ancestry}: {({k: v for k, v in got.items() if k != 'out'})}")
    log("beam_edges", json.dumps({"cases": cases, "row_tiles": sorted(tiles), "worst_err_over_tol": worst}))


SELF_EDGE_ROWS = (1, 5, 17, 32, 33, 512)
SELF_TILES = (1, 2, 4, 8, 16, 32)     # the row tiles self_attn_block's rule picks from


def self_max_t(dtype):
    """The longest cache self_attn_block's cluster kernel takes on this card:
    the largest T for which block_plan is not refused and a cluster fits
    (binary search; the shared scores grow with T)."""
    from retr_tpu_torch.ops import decoder_kernels as dk

    def fits(t):
        try:
            return dk.block_plan("self_attn_block", dtype, 32, t=t)["resident_clusters"] >= 1
        except RuntimeError:
            return False

    lo, hi = T, 1 << 16
    if not fits(lo) or fits(hi):
        raise AssertionError(f"self_attn_block {dtype}: takes T = {T}: {fits(lo)}, T = {hi}: {fits(hi)}")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def self_case(dev, seed, lp, rows, step, t, tile=0):
    """self_attn_block twice (``tile``: dk._beam_rows for the launch) and
    self_attn_block_plain on inputs made from ``seed``, caches of ``t``
    positions: ``err`` and ``tol`` over the output and the written slot,
    ``same`` (the two launches bit-equal, output and caches), ``untouched``
    (no other cache slot changed, x unwritten), ``out`` and ``plan``.
    Launches the kernel twice."""
    import torch

    from retr_tpu_torch.ops import decoder_kernels as dk
    from retr_tpu_torch.precision import matmul_precision

    dtype = lp["mha"]["q"]["w"].dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, C, generator=gen, device=dev).to(dtype)
    qpos = (torch.randn(C, generator=gen, device=dev) * 0.5).to(dtype)
    kc, vc = (torch.randn(rows, H, t, D, generator=gen, device=dev).to(dtype) for _ in range(2))
    x0, stept = x.clone(), torch.tensor(step, dtype=torch.int32, device=dev)
    runs = [(kc.clone(), vc.clone()) for _ in range(3)]
    old = dk._beam_rows
    dk._beam_rows = tile
    try:
        got, again = (dk.self_attn_block(lp, x, qpos, *runs[i], stept, num_heads=H)[0] for i in (0, 1))
        plan = dk.block_plan("self_attn_block", dtype, rows, t=t)
    finally:
        dk._beam_rows = old
    with matmul_precision(torch.float32):
        want = dk.self_attn_block_plain(lp, x, qpos, *runs[2], stept, num_heads=H)[0]
    torch.cuda.synchronize()
    err, tol = _tensor_err((got, runs[0][0][:, :, step], runs[0][1][:, :, step]),
                           (want, runs[2][0][:, :, step], runs[2][1][:, :, step]), str(dtype)[6:])
    keep = torch.arange(t, device=dev) != step
    same = torch.equal(_bits(got), _bits(again)) and all(torch.equal(_bits(runs[0][i]), _bits(runs[1][i]))
                                                         for i in (0, 1))
    untouched = torch.equal(_bits(x), _bits(x0)) and all(
        torch.equal(_bits(runs[0][i][:, :, keep]), _bits(orig[:, :, keep])) for i, orig in enumerate((kc, vc)))
    return {"err": err, "tol": tol, "same": same, "untouched": untouched, "out": got, "plan": plan}


def check_self_edges(dev):
    """self_attn_block, untimed, against its plain version (self_case) at
    SELF_EDGE_ROWS rows, steps 0, 63, 127 and T-1, T = 128 and the longest T
    the kernel takes (self_max_t), f32 and bf16, at every tile of SELF_TILES
    and the kernel's own choice on the same inputs: each within TOL, a second
    launch bit-equal, only slot ``step`` written, x unwritten, and the same
    output bits at every tile. Prints one line; raises on a miss."""
    import torch

    from retr_tpu_torch.ops import decoder_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(14)
    worst, cases, longest, own = {}, 0, {}, set()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        lp = dk.layer_params(random_decoder(gen, dev, dtype), 0)["self_attn"]
        longest[dname] = self_max_t(dtype)
        for t in (T, longest[dname]):
            for rows in SELF_EDGE_ROWS:
                for step in sorted({0, CHECK_STEP, T - 1, t - 1}):
                    first = None
                    for tile in (0,) + SELF_TILES:
                        got = self_case(dev, 100 + rows + step, lp, rows, step, t, tile)
                        first = got["out"] if first is None else first
                        bits = torch.equal(_bits(got["out"]), _bits(first))
                        key = f"{dname} T={'longest' if t > T else t}"
                        worst[key] = max(worst.get(key, 0.0), got["err"] / got["tol"])
                        cases += 1
                        if tile == 0:
                            own.add(got["plan"]["rows"])
                        if not (got["err"] <= got["tol"] and got["same"] and got["untouched"] and bits):
                            raise AssertionError(f"self_attn_block {key} rows {rows} step {step} tile {tile}: "
                                                 f"{({k: v for k, v in got.items() if k != 'out'})}, "
                                                 f"bits of the own-choice tile {bits}")
                        del got
                    del first
                torch.cuda.empty_cache()
    log("self_edges", json.dumps({"cases": cases, "longest_t": longest, "own_row_tiles": sorted(own),
                                  "worst_err_over_tol": worst}))


def check_head_edges(dev):
    """Both heads, untimed, against their plain versions (head_case): rows 1,
    5, 19, 33 and 129 (ragged row tiles of 32, 64 and 128), vocab 5000 and
    30522 (ragged last slabs of 8 and 58 columns), k 1, 5, 8 and 256, f32 and
    bf16, random weights and weights whose best columns tie across 128-wide
    slab boundaries and in the last slab. Prints one line; raises on a miss."""
    import torch

    from retr_tpu_torch.ops import decoder_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(10)
    worst, cases = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for vocab in (5000, V):
            ties = head_ties(vocab)
            for tied in (False, True):
                head = {"layers": [{"w": (torch.randn(i, o, generator=gen, device=dev) * i ** -0.5).to(dtype),
                                    "b": (torch.randn(o, generator=gen, device=dev) * 0.1).to(dtype)}
                                   for i, o in ((C, MLP), (MLP, MLP), (MLP, vocab))]}
                if tied:
                    head["layers"][2]["w"][:, list(ties)] = 1.0
                    head["layers"][2]["b"][list(ties)] = 5.0
                packed = dk.pack_head(head)
                for b in (1, 5, 19, 33, 129):
                    x = torch.randn(b, C, generator=gen, device=dev).to(dtype)
                    for k in (1, 5, 8, 256):
                        got = head_case(head, packed, x, k, ties if tied else ())
                        key = f"{dname} vocab {vocab}"
                        worst[key] = max(worst.get(key, 0.0), got["err"] / got["tol"])
                        cases += 1
                        if not (got["err"] <= got["tol"] and got["same"] and got["lowest"]):
                            raise AssertionError(f"heads {dname} vocab {vocab} rows {b} k {k} ties {tied}: {got}")
    log("head_edges", json.dumps({"cases": cases, "worst_err_over_tol": worst}))


ATTN_KERNEL_NAMES = ("mma_kernel", "any_kernel")   # csrc/attention_kernels.cu's CUDA functions
# attention_edges cases: label -> (batch, heads, Sq, Sk, causal, key masking)
ATTN_EDGES = {
    "one query": (2, 3, 1, 53, False, "random"),
    "one key": (2, 3, 20, 1, False, "none"),
    "15 keys (below one 16-key mma step)": (2, 3, 33, 15, False, "random"),
    "17 keys, causal": (2, 3, 33, 17, True, "random"),
    "129 x 129 causal (the diagonal crosses 32- and 64-row tiles)": (2, 3, 129, 129, True, "random"),
    "causal 100 x 130": (2, 2, 100, 130, True, "random"),
    "397 keys": (2, 3, 70, 397, False, "random"),
    "1718 keys (the untiled kernel)": (1, 2, 40, 1718, False, "random"),
    "padding from key 128 (a tile boundary)": (2, 3, 65, 192, False, "from 128"),
    "an all-masked row (mean of V)": (3, 2, 70, 100, False, "row 1 masked"),
    "an all-masked row, causal (every key tile)": (3, 2, 100, 100, True, "row 1 masked"),
    "causal, the first 10 keys masked (rows 0-9 see none)": (2, 2, 100, 100, True, "first 10"),
}


def attention_case(dev, gen, dtype, d, b, h, sq, sk, causal, masking):
    """fused_attention twice and fused_attention_plain on seeded inputs:
    ``err`` and its ``tol`` (TOL of max(1, max|plain|)), ``same`` (the two
    launches bit-equal), ``plan``; launches the kernel twice."""
    import torch

    from retr_tpu_torch.ops import attention as fa
    from retr_tpu_torch.precision import matmul_precision

    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev).to(dtype) for s in (sq, sk, sk))
    if masking == "none":
        kb = None
    else:
        pad = torch.rand(b, sk, generator=gen, device=dev) < 0.3
        pad[:, 0] = False
        if masking == "from 128":
            pad[:, 128:] = True
        elif masking == "row 1 masked":
            pad[1] = True
        elif masking == "first 10":
            pad[:, :10] = True
        kb = torch.where(pad, float("-inf"), 0.0)
    got, again = (fa.fused_attention(q, k, v, kb, causal=causal) for _ in range(2))
    with matmul_precision(torch.float32):
        want = fa.fused_attention_plain(q, k, v, kb, causal=causal)
    torch.cuda.synchronize()
    err, tol = _tensor_err(got, want, str(dtype)[6:])
    return {"err": err, "tol": tol, "same": torch.equal(_bits(got), _bits(again)),
            "plan": fa.attention_plan(dtype, d, sq, sk)}


def check_attention_edges(dev):
    """fused_attention, untimed, against its plain version at ATTN_EDGES, head
    dims 16, 32 and 64, f32 and bf16 (attention_case). Prints one line;
    raises on a miss."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(11)
    worst, cases, paths = {}, 0, set()
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 32, 64):
            for label, shape in ATTN_EDGES.items():
                got = attention_case(dev, gen, dtype, d, *shape)
                key = f"{str(dtype)[6:]} D={d}"
                worst[key] = max(worst.get(key, 0.0), got["err"] / got["tol"])
                paths.add(f"{got['plan']['path']} {got['plan']['rows']}")
                cases += 1
                if not (got["err"] <= got["tol"] and got["same"]):
                    raise AssertionError(f"fused_attention {key} {label}: {got}")
    log("attention_edges", json.dumps({"cases": cases, "paths": sorted(paths), "worst_err_over_tol": worst}))


def attention_work(b, sq, sk, causal, esize):
    """(bytes, operations) of fused_attention: q, k, v read and the output
    written once, the [B, Sk] f32 bias read once; QK and PV products, the
    causal ones counted at half."""
    nbytes = 2 * b * H * (sq + sk) * D * esize + b * sk * 4
    return nbytes, 4 * b * H * sq * sk * D * (0.5 if causal else 1.0)


def check_attention(dev):
    """fused_attention at batch 32 in f32 and bf16 for ATTN_SHAPES, with its
    plan (attention_plan) and the device time per call by torch.profiler of
    the kernel (``device_ms``) and of SDPA (``library_device_ms``) beside the
    CUDA events' times. Returns {(name, dtype, label): record}."""
    import torch
    import torch.nn.functional as Fn

    from retr_tpu_torch.ops import attention as fa
    from retr_tpu_torch.precision import matmul_precision

    gen = torch.Generator(device=dev).manual_seed(7)
    b, out = TRAIN_BATCH, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, (sq, sk, causal, padding) in ATTN_SHAPES.items():
            q = torch.randn(b, H, sq, D, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(b, H, sk, D, generator=gen, device=dev).to(dtype) for _ in range(2))
            if padding == "caption":                      # 8..22 real tokens, the rest PAD
                lens = torch.randint(8, 23, (b, 1), generator=gen, device=dev)
                pad = torch.arange(sk, device=dev)[None, :] >= lens
            else:                                         # padded image bands on every other row
                pad = torch.rand(b, sk, generator=gen, device=dev) < 0.3
                pad[::2] = False
                pad[:, 0] = False
            kb = torch.where(pad, float("-inf"), 0.0)
            mask = kb.clamp_min(-1e30)[:, None, None, :]
            if causal:
                mask = mask + torch.full((sq, sk), -1e30, device=dev).triu(1)
            mask = mask.to(dtype)
            kern = lambda: fa.fused_attention(q, k, v, kb, causal=causal)  # noqa: E731
            plain = lambda: fa.fused_attention_plain(q, k, v, kb, causal=causal)  # noqa: E731
            with matmul_precision(torch.float32):   # plain version in full f32
                got, want = kern(), plain()
                torch.cuda.synchronize()
                err, tol = _tensor_err(got, want, dname)
                lib = lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=mask)  # noqa: E731
                ms = time_ms(kern)
                plain_ms = time_ms(plain, reps=5, rounds=3)
                lib_ms = time_ms(lib)
                dev_ms = device_ms(kern, ATTN_KERNEL_NAMES, per_call=True)
                lib_dev_ms = device_ms(lib, "", per_call=True)
            nbytes, ops = attention_work(b, sq, sk, causal, 4 if dname == "float32" else 2)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dname] * 1e3
            rec = dict(name="fused_attention", dtype=dname, batch=b,
                       shape=f"{dname}, batch {b}, {label} {sq}x{sk}" + (", causal" if causal else ""),
                       max_abs_err=err, tol=tol, ms=dev_ms if isinstance(dev_ms, float) else ms, device_ms=dev_ms,
                       ms_events=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       library_device_ms=lib_dev_ms, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       plan=fa.attention_plan(dtype, D, sq, sk))
            log("kernel", json.dumps(rec))
            if not err <= tol:
                raise AssertionError(f"fused_attention {dname} {label}: max_abs_err {err} > {tol}")
            out[("fused_attention", dname, label)] = rec
            del q, k, v, got, want, mask
    return out


# ---------------------------------------------------------------------------------
# Phases 4-5: the served model
# ---------------------------------------------------------------------------------


def served_config(dtype: str):
    from retr_tpu_torch.config import Config

    return Config(backbone="ResNet50", dilation=True, hidden_dim=256, nheads=8, enc_layers=6, dec_layers=6,
                  dim_feedforward=2048, vocab_size=V, max_position_embeddings=128, dropout=0.0,
                  image_size=224, compute_dtype=dtype)


def random_state(cfg, seed=0):
    """Reference-named state dict with PyTorch's default initialisation, seeded."""
    import torch

    from retr_tpu_torch.models import weights

    torch.manual_seed(seed)
    return weights.reference_module(cfg).state_dict()


def synthetic_tokenizer():
    from retr_tpu_torch.data.tokenizer import DEFAULT_TEST_WORDS, WordPieceTokenizer

    return WordPieceTokenizer.synthetic(DEFAULT_TEST_WORDS, vocab_size=V)


def requests(n, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    imgs, boxes = [], []
    for i in range(n):
        h, w = int(rng.integers(240, 640)), int(rng.integers(240, 640))
        imgs.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        x0, y0 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
        boxes.append([x0, y0, int(rng.integers(16, w - x0)), int(rng.integers(16, h - y0))])
    return imgs, boxes


# Predictor runs: (label, decoder, flags of ops/decoder_kernels.py, the kernels
# whose launches that run shows)
SERVE_RUNS = [
    ("greedy, stacked kernel", "greedy", {}, ["fused_stack_step"]),
    ("greedy, per-layer trio", "greedy", {"LAYER_GRID": False}, ["self_attn_block", "cross_attn_block", "ff_block"]),
    ("greedy, HEAD_KERNEL", "greedy", {"HEAD_KERNEL": True}, ["mlp_head_argmax"]),
    ("greedy, MERGED_LAYER", "greedy", {"LAYER_GRID": False, "MERGED_LAYER": True}, ["fused_layer_step"]),
    ("beam 5", "beam", {}, ["self_attn_block_beam", "cross_attn_block", "ff_block"]),
    ("beam 5, BEAM_TOPK_KERNEL", "beam", {"BEAM_TOPK_KERNEL": True}, ["mlp_head_topk"]),
]


class flags:
    """Set flags of ops/decoder_kernels.py for a block, restoring them after."""

    def __init__(self, **values):
        from retr_tpu_torch.ops import decoder_kernels as dk

        self.dk, self.values = dk, values
        self.old = {k: getattr(dk, k) for k in values}

    def __enter__(self):
        for k, v in self.values.items():
            setattr(self.dk, k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(self.dk, k, v)


def serve(dev, state, tok):
    """Predictor runs with each kernel dispatch. Returns the params, each
    kernel's launches on the last run that lists it (the main path's: the
    SERVE_RUNS order puts it last) and its launches on every such run."""
    import torch

    from retr_tpu_torch.ops import decoder_kernels as dk
    from retr_tpu_torch.predictor import Predictor

    cfg = served_config("bfloat16")
    pred = Predictor(state, cfg, tok, max_batch=32, device=dev)
    imgs, boxes = requests(40)
    pred.predict_batch(imgs[:2], boxes[:2])                       # warm-up (cuDNN plans)
    t0 = time.perf_counter()
    for im, bb in zip(imgs, boxes):                               # host preprocessing alone
        pred._preprocess_one(im, bb)
    log("preprocess", json.dumps({"requests": len(imgs), "host_seconds": time.perf_counter() - t0}))
    launches, by_run = {}, {}
    for label, decoder, fl, path in SERVE_RUNS:
        with flags(**fl):
            dk.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            texts = pred.predict_batch(imgs, boxes, beam=decoder == "beam")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        counts = dict(dk.LAUNCHES)
        for k in path:
            launches[k] = counts[k]
            by_run.setdefault(k, {})[label] = counts[k]
            if counts[k] <= 0:
                raise AssertionError(f"{k} was never launched on the run {label!r}: {counts}")
        log("serve", json.dumps({"run": label, "requests": len(imgs), "seconds": dt,
                                 "requests_per_s": len(imgs) / dt, "launches": counts,
                                 "first_captions": [t[:60] for t in texts[:3]]}))
        if len(texts) != len(imgs) or not all(isinstance(t, str) for t in texts):
            raise AssertionError(f"Predictor returned malformed captions ({label})")
        if label == SERVE_RUNS[0][0]:
            stacked_texts = texts
    # the serving encoder through fused_attention: 6 launches per batch of 32
    pred.cfg = cfg.replace(use_pallas_attention=True)
    dk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = pred.predict_batch(imgs, boxes)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pred.cfg = cfg
    counts = dict(dk.LAUNCHES)
    batches = -(-len(imgs) // pred.max_batch)
    log("serve", json.dumps({"run": "greedy, use_pallas_attention", "requests": len(imgs), "seconds": dt,
                             "requests_per_s": len(imgs) / dt, "launches": counts,
                             "captions_equal_to_stacked_run": sum(a == b for a, b in zip(texts, stacked_texts)),
                             "first_captions": [t[:60] for t in texts[:3]]}))
    if len(texts) != len(imgs) or counts["fused_attention"] != cfg.enc_layers * batches:
        raise AssertionError(f"flagged greedy run: {len(texts)} captions, launches {counts}")
    launches["fused_attention (serving encoder)"] = counts["fused_attention"]
    return pred.params, launches, by_run


# ---------------------------------------------------------------------------------
# Phase 4b: the rest of the serving surface
# ---------------------------------------------------------------------------------

SAMPLE_RUNS = {"cfg defaults (full-vocabulary draw)": {}, "top_k=50, top_p=0.9": {"top_k": 50, "top_p": 0.9}}


def counted(label, by_run, fn, expect):
    """Run ``fn`` with the launch counts set to 0 just before and read just
    after; each kernel in ``expect`` (name -> count, or None for "at least
    one") must have launched so. Returns (fn's result, seconds, counts)."""
    import torch

    from retr_tpu_torch.ops import decoder_kernels as dk

    torch.cuda.synchronize()
    dk.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.LAUNCHES)
    for k, want in expect.items():
        if (counts[k] <= 0) if want is None else (counts[k] != want):
            raise AssertionError(f"{label}: {k} launched {counts[k]} times, expected {want or '> 0'}: {counts}")
        by_run.setdefault(k, {})[label] = counts[k]
    return out, dt, counts


def host_preprocess(pred, imgs, boxes):
    """Host seconds per request, the native core against the numpy spec, on
    the same requests; the outputs must be bit-equal."""
    import numpy as np

    from retr_tpu_torch import native

    if not (native.available() and native.available("tokenizer")):
        raise AssertionError("the native host core did not load: " + str(native._failed))
    spec_n = 16
    t0 = time.perf_counter()
    nat = [pred._preprocess_one(im, bb) for im, bb in zip(imgs, boxes)]
    native_s = (time.perf_counter() - t0) / len(imgs)
    avail = native.available
    native.available = lambda name="preprocess": False
    try:
        t0 = time.perf_counter()
        spec = [pred._preprocess_one(im, bb) for im, bb in zip(imgs[:spec_n], boxes[:spec_n])]
        spec_s = (time.perf_counter() - t0) / spec_n
    finally:
        native.available = avail
    equal = all(np.array_equal(a.target_image, b.target_image) and np.array_equal(a.target_mask, b.target_mask)
                for a, b in zip(nat, spec))
    log("preprocess_native", json.dumps({"requests_native": len(imgs), "requests_spec": spec_n,
                                         "native_s_per_request": native_s, "spec_s_per_request": spec_s,
                                         "spec_over_native": spec_s / native_s, "bit_equal": equal}))
    if not equal:
        raise AssertionError("the native core and the numpy spec disagree")


def sample_throughput(dev, params, card, by_run):
    """Sampling at batch 32 for all 127 steps (EOS out of range) in both
    configurations beside greedy on the same images, encode included (median
    of 3 runs after a warm-up); the sampling step's parts by CUDA events; 32
    steps of each under torch.profiler."""
    import torch

    from retr_tpu_torch import decode
    from retr_tpu_torch.ops import decoder_kernels as dk

    cfg = served_config("bfloat16")
    samples = random_samples(32, torch.Generator(device=dev).manual_seed(4), dev)
    kw = dict(max_len=128, bos_token=101, eos_token=V, compute_dtype=torch.bfloat16)
    runs = {"greedy": lambda n: decode.greedy(params, cfg, samples, **kw)}
    for label, fl in SAMPLE_RUNS.items():
        runs[f"sample, {label}"] = (lambda fl: lambda n: decode.sample(
            params, cfg, samples, torch.Generator(device=dev).manual_seed(n), **fl, **kw))(fl)
    for label, run in runs.items():
        times = []
        for n in range(4):
            ids, dt, counts = counted(f"{label}, batch 32", by_run, lambda: run(n), {"fused_stack_step": 127})
            times.append(dt)
        if tuple(ids.shape) != (32, 128) or int(ids.min()) < 0 or int(ids.max()) >= V:
            raise AssertionError(f"{label} returned a malformed buffer {tuple(ids.shape)}")
        total = sorted(times[1:])[1]
        log("sample_throughput", json.dumps({"decoder": label, "batch": 32, "steps": 127, "seconds": total,
                                             "captions_per_s": 32 / total, "ms_per_step": total / 127 * 1e3,
                                             "distinct_tokens": int(ids[:, 1:].unique().numel()),
                                             "launches": {k: v for k, v in counts.items() if v}, "card": card}))
    gen = torch.Generator(device=dev).manual_seed(5)
    logits = torch.randn(32, V, generator=gen, device=dev) * 3
    parts = {"topk_first k=50": lambda: dk.topk_first(logits, 50),
             "sort descending (top-p without top-k)": lambda: logits.sort(dim=-1, descending=True),
             "gumbel_argmax": lambda: decode.gumbel_argmax(logits, gen)}
    for label, fl in SAMPLE_RUNS.items():
        parts[f"sample_tokens, {label}"] = (lambda fl: lambda: decode.sample_tokens(logits, gen, **fl))(fl)
    log("sample_step_parts", json.dumps({"rows": 32, "vocab": V, "ms": {k: time_ms(f) for k, f in parts.items()},
                                         "card": card}))
    p, memory, mask, pos = encode_for_decode(params, cfg, samples)
    for label, fl in SAMPLE_RUNS.items():
        def loop(fl=fl):
            return decode._token_loop(p, cfg, memory, mask, pos, lambda i, hs, c: decode.sample_tokens(
                decode.caption.mlp_head(p["mlp"], hs).float(), gen, **fl), max_len=33, bos_token=101, eos_token=V)

        loop()
        torch.cuda.synchronize()
        log("profile", json.dumps({"decoder": f"sample, {label}", "batch": 32, "steps": 32,
                                   **device_profile(loop, 32)}))


def serving_queue(pred, imgs, boxes, card, by_run):
    """256 requests from 8 client threads through a ServingQueue (max_batch 32,
    admission sized for the burst): the captions must equal predict_batch's.
    Requests/s and latency percentiles beside sequential predict_batch."""
    import threading

    import torch

    from retr_tpu_torch.predictor import ServingQueue

    want, seq_s, _ = counted("predict_batch, 256 requests", by_run, lambda: pred.predict_batch(imgs, boxes),
                             {"fused_stack_step": None})
    got, lat = [None] * len(imgs), [0.0] * len(imgs)

    def client(c):
        futs = []
        for i in range(c, len(imgs), 8):
            futs.append((i, time.perf_counter(), q.submit(imgs[i], boxes[i])))
        for i, t0, f in futs:
            got[i] = f.result(timeout=600)
            lat[i] = time.perf_counter() - t0

    q = ServingQueue(pred, max_wait_s=0.05, max_queued=len(imgs))

    def burst():
        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a ServingQueue client did not finish")

    try:
        _, q_s, _ = counted("ServingQueue, 256 requests, 8 threads", by_run, burst, {"fused_stack_step": None})
    finally:
        q.close()
    torch.cuda.synchronize()
    lat_sorted = sorted(lat)
    rec = {"requests": len(imgs), "threads": 8, "max_batch": pred.max_batch,
           "queue_requests_per_s": len(imgs) / q_s, "sequential_predict_batch_requests_per_s": len(imgs) / seq_s,
           "queue_over_sequential": seq_s / q_s, "p50_s": lat_sorted[len(lat) // 2],
           "p99_s": lat_sorted[int(0.99 * (len(lat) - 1))], "stats": q.stats(),
           "captions_equal": sum(a == b for a, b in zip(got, want)), "card": card}
    log("serving_queue", json.dumps(rec))
    if rec["captions_equal"] != len(imgs) or q.stats()["rejected"]:
        raise AssertionError(f"ServingQueue captions differ from predict_batch's: {rec}")


def http_server(pred, imgs, boxes):
    """The HTTP front end on an ephemeral port: /predict equals predict,
    /healthz names the card, and a queue that admits nothing answers 503 with
    Retry-After."""
    import base64
    import io
    import urllib.error
    import urllib.request

    import torch
    from PIL import Image

    from retr_tpu_torch.predictor import ServingQueue
    from retr_tpu_torch.serve import run_in_thread

    buf = io.BytesIO()
    Image.fromarray(imgs[0]).save(buf, format="PNG")
    body = json.dumps({"image": base64.b64encode(buf.getvalue()).decode(), "bbox": boxes[0]}).encode()

    def post(base):
        req = urllib.request.Request(base + "/predict", data=body, headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read()), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), dict(e.headers)

    want = pred.predict(imgs[0], boxes[0])
    out = {}
    for label, max_queued in (("serving", None), ("forced overload", 0)):
        q = ServingQueue(pred, max_wait_s=0.02, max_queued=max_queued)
        server, base = run_in_thread(q)
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
            code, reply, headers = post(base)
        finally:
            server.shutdown()
            server.server_close()
            q.close()
        out[label] = {"code": code, "reply": reply, "retry_after": headers.get("Retry-After"),
                      "healthz_device": health["device"]}
    log("http", json.dumps({k: {**v, "reply": {a: str(b)[:60] for a, b in v["reply"].items()}}
                            for k, v in out.items()}))
    name = torch.cuda.get_device_name(0)
    ok = (out["serving"]["code"] == 200 and out["serving"]["reply"] == {"expression": want}
          and name in out["serving"]["healthz_device"] and out["forced overload"]["code"] == 503
          and int(out["forced overload"]["retry_after"]) >= 1)
    if not ok:
        raise AssertionError(f"HTTP server: {out}")


def serve_main_drains(imgs, boxes):
    """``python -m retr_tpu_torch.serve --checkpoint X.pth`` on the card: a
    reference .pth of ``Config()``'s model (random weights from a seed), one
    request answered, then SIGTERM: the process must drain and exit 0."""
    import base64
    import io
    import select
    import signal
    import tempfile
    import urllib.request

    import torch
    from PIL import Image

    from retr_tpu_torch.config import Config
    from retr_tpu_torch.models import weights

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "Concat_refcoco_checkpoint_0.pth")
        torch.manual_seed(7)
        torch.save({"model_state_dict": weights.reference_module(Config()).state_dict(), "epoch": 0}, path)
        proc = subprocess.Popen([sys.executable, "-m", "retr_tpu_torch.serve", "--checkpoint", path, "--port", "0",
                                 "--max-batch", "8"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        try:
            line = proc.stdout.readline() if select.select([proc.stdout], [], [], 300)[0] else ""
            if not line.startswith("serving on "):
                proc.kill()
                raise AssertionError(f"serve did not start: {line!r} {proc.communicate()[1][-2000:]}")
            base = line.split()[2]
            buf = io.BytesIO()
            Image.fromarray(imgs[1]).save(buf, format="PNG")
            req = urllib.request.Request(base + "/predict", headers={"Content-Type": "application/json"}, data=json.dumps(
                {"image": base64.b64encode(buf.getvalue()).decode(), "bbox": boxes[1]}).encode())
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                reply = json.loads(r.read())
            first_s = time.perf_counter() - t0
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log("serve_main", json.dumps({"started": line.strip(), "reply": reply, "first_request_s": first_s,
                                  "exit_code_after_sigterm": rc}))
    if rc != 0 or not isinstance(reply.get("expression"), str):
        raise AssertionError(f"python -m retr_tpu_torch.serve: rc {rc}, reply {reply}")


def serve_apis(dev, state, tok, card, by_run):
    """Phase 4b at the served width in bf16: the native core; sampling at batch
    32; complete, score (use_pallas_attention on: 18 fused_attention launches a
    call) and predict_with_attention (none); a ServingQueue against sequential
    predict_batch; the HTTP server; ``python -m retr_tpu_torch.serve`` and
    its SIGTERM drain."""
    import numpy as np
    import torch

    from retr_tpu_torch.predictor import Predictor

    cfg = served_config("bfloat16")
    pred = Predictor(state, cfg, tok, max_batch=32, device=dev)
    imgs, boxes = requests(256, seed=3)
    host_preprocess(pred, imgs[:64], boxes[:64])
    sample_throughput(dev, pred.params, card, by_run)

    prefix = "the man on the left"
    done, dt, _ = counted("complete, 8 requests", by_run,
                          lambda: [pred.complete(im, bb, prefix) for im, bb in zip(imgs[:8], boxes[:8])],
                          {"fused_stack_step": None})
    log("complete", json.dumps({"requests": 8, "s_per_request": dt / 8, "prefix": prefix,
                                "first": [t[:80] for t in done[:3]]}))
    if not all(t.startswith(prefix) for t in done):
        raise AssertionError(f"complete did not keep the prefix: {done}")

    texts = ["the man on the left", "red car", "a small dog next to the table", "white shirt"] * 2
    pred.cfg = cfg.replace(use_pallas_attention=True)
    try:
        scores, dt, _ = counted("score, 8 requests, use_pallas_attention", by_run,
                                lambda: pred.score(imgs[:8], boxes[:8], texts), {"fused_attention": 18})
        (text, atts), att_s, _ = counted("predict_with_attention, use_pallas_attention", by_run,
                                         lambda: pred.predict_with_attention(imgs[0], boxes[0]),
                                         {"fused_attention": 0})
    finally:
        pred.cfg = cfg
    plain = pred.score(imgs[:8], boxes[:8], texts)
    lp_diff = max(abs(a["logprob"] - b["logprob"]) for a, b in zip(scores, plain))
    row_err = max(float(np.abs(a.sum(-1) - 1.0).max()) for a in atts.values())
    log("score", json.dumps({"requests": 8, "seconds": dt, "logprobs": [r["logprob"] for r in scores],
                             "n_tokens": [r["n_tokens"] for r in scores],
                             "max_logprob_diff_to_plain_attention": lp_diff}))
    log("predict_with_attention", json.dumps({"seconds": att_s, "text": text[:80],
                                              "shapes": {k: list(v.shape) for k, v in atts.items()},
                                              "max_row_sum_err": row_err}))
    if not all(np.isfinite(r["logprob"]) and r["n_tokens"] > 0 for r in scores) or row_err > 1e-3:
        raise AssertionError(f"score or attention maps malformed: {scores}, row error {row_err}")
    if set(atts) != {"enc_tc_self_att", "dec_exp_self_att", "dec_exp_tc_cross_att"}:
        raise AssertionError(f"attention map keys {sorted(atts)}")

    serving_queue(pred, imgs, boxes, card, by_run)
    http_server(pred, imgs, boxes)
    del pred
    torch.cuda.empty_cache()
    serve_main_drains(imgs, boxes)


def random_samples(b, gen, dev):
    import torch

    from retr_tpu_torch.masking import Masked

    return Masked(torch.randn(b, 3, 224, 224, generator=gen, device=dev),
                  torch.zeros(b, 224, 224, dtype=torch.bool, device=dev))


def encode_for_decode(params, cfg, samples):
    """bf16 encode and the decode loop's cast: (params, memory, mask, pos)."""
    import torch

    from retr_tpu_torch import decode
    from retr_tpu_torch.models import caption

    memory, mask, pos = caption.encode(params, cfg, samples, compute_dtype=torch.bfloat16)
    p, memory, pos = decode._cast_for_decode(params, memory, pos, torch.bfloat16)
    return p, memory, mask, pos


def throughput(dev, params, card):
    """Greedy at batch 32 and 512 with the stacked kernel and with the per-layer
    trio, beam at batch 32 x 5 and 512 x 5 with the top-k head kernel off and on
    (offline evaluation, other flags at their defaults): all 127 steps (EOS out
    of range), encode and loop timed apart."""
    import torch

    from retr_tpu_torch import decode

    cfg = served_config("bfloat16")
    gen = torch.Generator(device=dev).manual_seed(1)
    runs = [(32, "greedy", {"LAYER_GRID": True}), (32, "greedy", {"LAYER_GRID": False}),
            (512, "greedy", {"LAYER_GRID": True}), (512, "greedy", {"LAYER_GRID": False}),
            (32, "beam", {"BEAM_TOPK_KERNEL": False}), (32, "beam", {"BEAM_TOPK_KERNEL": True}),
            (512, "beam", {"BEAM_TOPK_KERNEL": False}), (512, "beam", {"BEAM_TOPK_KERNEL": True})]
    samples = {b: random_samples(b, gen, dev) for b in (32, 512)}
    for b, decoder, fl in runs:
        times = []
        for _ in range(4):                                  # first run warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, memory, mask, pos = encode_for_decode(params, cfg, samples[b])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with flags(**fl):
                if decoder == "greedy":
                    ids = decode.greedy_from_memory(p, cfg, memory, mask, pos, max_len=128, bos_token=101,
                                                    eos_token=V)
                else:
                    ids, _ = decode.beam_search_from_memory(p, cfg, memory, mask, pos, max_len=128, bos_token=101,
                                                            eos_token=V, beam_size=BEAM)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            times.append((t2 - t0, t1 - t0, t2 - t1))
        want = (b, 128) if decoder == "greedy" else (b, BEAM, 128)
        if tuple(ids.shape) != want or int(ids.min()) < 0 or int(ids.max()) >= V:
            raise AssertionError(f"{decoder} returned a malformed buffer {tuple(ids.shape)}")
        total, enc, loop = sorted(times[1:])[1]
        log("throughput", json.dumps({"decoder": decoder, "batch": b, **fl, "steps": 127, "seconds": total,
                                      "encode_s": enc, "decode_loop_s": loop, "ms_per_step": loop / 127 * 1e3,
                                      "captions_per_s": b / total, "card": card}))


def step_profile(dev, params, steps=32):
    """Where a decode loop's device time goes: torch.profiler over ``steps``
    steps of greedy (stacked kernel) at batch 32 and 512 and of beam at batch
    32 x 5 and 512 x 5. Prints device time by kernel name and the device's idle
    share over the loop's span (first kernel start to last kernel end)."""
    import torch

    from retr_tpu_torch import decode

    cfg = served_config("bfloat16")
    gen = torch.Generator(device=dev).manual_seed(3)
    for b, decoder in ((32, "greedy"), (512, "greedy"), (32, "beam"), (512, "beam")):
        p, memory, mask, pos = encode_for_decode(params, cfg, random_samples(b, gen, dev))

        def loop():
            kw = dict(max_len=steps + 1, bos_token=101, eos_token=V)
            if decoder == "greedy":
                return decode.greedy_from_memory(p, cfg, memory, mask, pos, **kw)
            return decode.beam_search_from_memory(p, cfg, memory, mask, pos, beam_size=BEAM, **kw)

        loop()
        torch.cuda.synchronize()
        log("profile", json.dumps({"decoder": decoder, "batch": b, "steps": steps,
                                   **device_profile(loop, steps)}))


def device_profile(fn, steps, top_n=8):
    """torch.profiler over ``fn()``: the device's busy time and idle share over
    its span (first kernel start to last kernel end) and the device time of the
    top kernels per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    if not spans:
        return {"device_time": "not measured (no CUDA events traced)"}
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    return {"span_ms": span / 1e3, "device_busy_ms": busy / 1e3, "idle_share": 1 - busy / span,
            "top_kernels_ms_per_step": {n[:80]: t / 1e3 / steps for n, t in top}}


def greedy_with_margins(params, cfg, samples, eos):
    """The greedy loop (on the samples' device), also returning each step's
    top-2 logit margin."""
    import torch

    from retr_tpu_torch.models import caption, transformer

    memory, mask, pos = caption.encode(params, cfg, samples)
    tp = transformer.prepare_decoder(params["transformer"])
    cache, cross = transformer.init_decode_state(tp, memory, mask, pos, cfg, 128)
    b, dev = memory.shape[0], memory.device
    ids = torch.zeros((b, 128), dtype=torch.int32, device=dev)
    ids[:, 0] = 101
    margins = torch.full((b, 128), float("inf"), device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(127):
        hs, cache = transformer.decode_step(tp, cache, cross, ids[:, i], step, cfg)
        logits = caption.mlp_head(params["mlp"], hs)
        top2 = logits.topk(2, dim=-1).values
        margins[:, i + 1] = top2[:, 0] - top2[:, 1]
        pred = logits.argmax(-1).to(torch.int32)
        finished |= pred == eos
        if bool(finished.all()):
            break
        ids[:, i + 1] = pred
        step += 1
    return ids, margins


def parity_images(n):
    import torch

    gen = torch.Generator().manual_seed(2)
    img = torch.randn(n, 3, 224, 224, generator=gen)
    mask = torch.zeros(n, 224, 224, dtype=torch.bool)
    mask[1, :, 150:] = True
    return img, mask


def other_width(dev):
    """Greedy (the stacked step) and beam 3 at hidden 64 with 4 heads, FF 128,
    2 layers, vocab 96, f32, head kernels on: the tuned decoder-layer kernels
    do not take this width, so the wrappers launch csrc/width_kernels.cu. The
    tokens must equal the CPU's, and each decoder wrapper must have launched."""
    import torch

    from retr_tpu_torch import decode
    from retr_tpu_torch.config import Config
    from retr_tpu_torch.masking import Masked
    from retr_tpu_torch.models import weights
    from retr_tpu_torch.ops import decoder_kernels as dk

    cfg = Config(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=2,
                 dim_feedforward=128, vocab_size=96, max_position_embeddings=16, dropout=0.0, image_size=32)
    state = random_state(cfg)
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(3, 3, 32, 32, generator=gen)
    mask = torch.zeros(3, 32, 32, dtype=torch.bool)
    mask[1, :, 20:] = True
    out = {}
    with flags(HEAD_KERNEL=True, BEAM_TOPK_KERNEL=True):
        for name, run, kw in (("greedy", decode.greedy, {}), ("beam", decode.beam_search, {"beam_size": 3})):
            kw = dict(max_len=16, bos_token=1, eos_token=6, **kw)
            cpu = run(weights.to_params(state, cfg, device="cpu"), cfg, Masked(img, mask), **kw)
            dk.reset_launches()
            gpu = run(weights.to_params(state, cfg, device=dev), cfg, Masked(img.to(dev), mask.to(dev)), **kw)
            torch.cuda.synchronize()
            launched = {k: v for k, v in dk.LAUNCHES.items() if v}
            want = (("fused_stack_step", "mlp_head_argmax") if name == "greedy"
                    else ("self_attn_block_beam", "cross_attn_block", "ff_block", "mlp_head_topk"))
            equal = torch.equal(gpu.cpu(), cpu) if name == "greedy" else torch.equal(gpu[0].cpu(), cpu[0])
            out[name] = {"launches": launched, "tokens_equal_cpu": equal}
            if not equal or set(launched) != set(want):
                raise AssertionError(f"other width {name}: {out[name]}")
    log("other_width", json.dumps(out))


def f32_parity(dev, state):
    from retr_tpu_torch import decode
    from retr_tpu_torch.masking import Masked
    from retr_tpu_torch.models import weights

    cfg = served_config("float32")
    img, mask = parity_images(4)
    gpu_params = weights.to_params(state, cfg, device=dev)
    gpu_ids = decode.greedy(gpu_params, cfg, Masked(img.to(dev), mask.to(dev)), max_len=128,
                            bos_token=101, eos_token=102).cpu()
    t0 = time.perf_counter()
    cpu_ids, margins = greedy_with_margins(weights.to_params(state, cfg, device="cpu"), cfg,
                                           Masked(img, mask), 102)
    cpu_s = time.perf_counter() - t0
    diffs = []
    for r in range(4):
        bad = (gpu_ids[r] != cpu_ids[r]).nonzero().flatten().tolist()
        if bad:
            j = bad[0]
            diffs.append({"row": r, "slot": j, "cpu_top2_margin": float(margins[r, j])})
    log("f32_parity", json.dumps({"rows": 4, "equal_rows": 4 - len(diffs), "first_differences": diffs,
                                  "cpu_seconds": cpu_s}))
    for d in diffs:
        if not d["cpu_top2_margin"] < 1e-4:
            raise AssertionError(f"f32 GPU and CPU tokens differ at a clear argmax: {d}")


def f32_beam_parity(dev, state):
    """Beam 5 over a batch of 2 in f32 on the GPU and on the CPU. Where the top
    hypotheses differ, the CPU search must have had a near-tie: a gap below
    1e-4 between its k-th and (k+1)-th candidate at some step (a flip at any
    step, not only at the first differing slot, can change which hypothesis
    ranks first), or between its two best final scores."""
    import torch

    from retr_tpu_torch import decode
    from retr_tpu_torch.masking import Masked
    from retr_tpu_torch.models import caption, weights

    cfg = served_config("float32")
    img, mask = parity_images(2)
    kw = dict(max_len=128, bos_token=101, eos_token=102, beam_size=BEAM)
    gpu_t, gpu_s = decode.beam_search(weights.to_params(state, cfg, device=dev), cfg,
                                      Masked(img.to(dev), mask.to(dev)), **kw)
    t0 = time.perf_counter()
    cpu_params = weights.to_params(state, cfg, device="cpu")
    memory, mem_mask, pos = caption.encode(cpu_params, cfg, Masked(img, mask))
    margins = []
    cpu_t, cpu_s = decode.beam_search_from_memory(cpu_params, cfg, memory, mem_mask, pos, margins=margins, **kw)
    cpu_sec = time.perf_counter() - t0
    gaps = torch.stack(margins, dim=1)                      # [B, steps]
    diffs = []
    for r in range(2):
        bad = (gpu_t[r, 0].cpu() != cpu_t[r, 0]).nonzero().flatten().tolist()
        if bad:
            j = bad[0]
            diffs.append({"row": r, "first_differing_step": j - 1,
                          "cpu_gap_kth_k1th_there": float(gaps[r, j - 1]) if j - 1 < gaps.shape[1] else None,
                          "cpu_min_gap": min(float(gaps[r].min()), float(cpu_s[r, 0] - cpu_s[r, 1]))})
    log("f32_beam_parity", json.dumps({
        "rows": 2, "beam": BEAM, "equal_top_rows": 2 - len(diffs), "first_differences": diffs,
        "steps": gaps.shape[1], "max_score_diff_where_equal": max(
            [float((gpu_s[r].cpu() - cpu_s[r]).abs().max()) for r in range(2) if r not in [d["row"] for d in diffs]],
            default=None),
        "cpu_seconds": cpu_sec}))
    for d in diffs:
        if not d["cpu_min_gap"] < 1e-4:
            raise AssertionError(f"f32 GPU and CPU beam hypotheses differ without a near-tie: {d}")


# ---------------------------------------------------------------------------------
# Phase 6: training at full width
# ---------------------------------------------------------------------------------


def train_batch(b, gen, dev):
    """A caption-like batch: 224 px images (every other one with a padded
    band), BOS, 7..21 random tokens, EOS, then PAD up to 129 slots."""
    import torch

    from retr_tpu_torch.data.pipeline import Batch

    images = torch.randn(b, 3, 224, 224, generator=gen, device=dev)
    masks = torch.zeros(b, 224, 224, dtype=torch.bool, device=dev)
    masks[1::2, :, 160:] = True
    caps = torch.randint(1000, V, (b, T + 1), generator=gen, device=dev, dtype=torch.int32)
    lens = torch.randint(8, 23, (b, 1), generator=gen, device=dev)
    pos = torch.arange(T + 1, device=dev)[None, :]
    caps = torch.where(pos == lens, 102, torch.where(pos > lens, 0, caps)).to(torch.int32)
    caps[:, 0] = 101
    return Batch(images, masks, caps, caps == 0)


def _synced(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train(dev, state, card):
    """Train and eval steps at full width. Returns fused_attention's launches
    on the eval path (reset just before it, read just after)."""
    import math

    import torch

    from retr_tpu_torch.models import weights
    from retr_tpu_torch.ops import decoder_kernels as dk
    from retr_tpu_torch.train import state as tstate

    gen = torch.Generator(device=dev).manual_seed(8)
    batch = train_batch(TRAIN_BATCH, gen, dev)
    for dname in ("bfloat16", "float32"):
        cfg = served_config(dname).replace(dropout=0.1)
        st = tstate.create_train_state(cfg, weights.to_params(state, cfg, device=dev), device=dev)
        step = tstate.make_train_step(cfg)
        torch.cuda.reset_peak_memory_stats()
        runs = [_synced(lambda: step(st, batch, 0)) for _ in range(3)]
        losses = [float(out[1]) for out, _ in runs]
        log("train", json.dumps({"dtype": dname, "batch": TRAIN_BATCH, "steps": 3,
                                 "ms_per_step": [dt * 1e3 for _, dt in runs], "losses": losses,
                                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card}))
        log("profile", json.dumps({"train_step": dname, "batch": TRAIN_BATCH, "steps": 1,
                                   **device_profile(lambda: step(st, batch, 0), 1, top_n=12)}))
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{dname} train losses not finite: {losses}")
        del st, step, runs
        torch.cuda.empty_cache()

    cfg = served_config("bfloat16").replace(dropout=0.1)
    params = weights.to_params(state, cfg, device=dev)
    plain_eval = tstate.make_eval_step(cfg)
    fused_eval = tstate.make_eval_step(cfg.replace(use_pallas_attention=True))
    plain, plain_s = _synced(lambda: [plain_eval(params, batch) for _ in range(EVAL_STEPS)])
    dk.reset_launches()
    fused, fused_s = _synced(lambda: [fused_eval(params, batch) for _ in range(EVAL_STEPS)])
    launches = dk.LAUNCHES["fused_attention"]
    plain, fused = float(plain[-1]), float(fused[-1])
    log("eval", json.dumps({"dtype": "bfloat16", "batch": TRAIN_BATCH, "eval_steps": EVAL_STEPS,
                            "loss_plain": plain, "loss_fused": fused, "ms_per_step_plain": plain_s / EVAL_STEPS * 1e3,
                            "ms_per_step_fused": fused_s / EVAL_STEPS * 1e3, "fused_attention_launches": launches,
                            "card": card}))
    if launches != (cfg.enc_layers + 2 * cfg.dec_layers) * EVAL_STEPS or not abs(fused - plain) <= 1e-4 * abs(plain):
        raise AssertionError(f"eval step: losses {plain} / {fused}, fused_attention launches {launches}")
    del params
    torch.cuda.empty_cache()

    # one f32 step at batch 2 on the GPU and on the CPU; dropout 0 (the CPU and
    # CUDA generators draw different streams from one seed)
    cfg = served_config("float32")
    small = train_batch(2, torch.Generator(device=dev).manual_seed(9), dev)
    res = []
    for where in (dev, torch.device("cpu")):
        st = tstate.create_train_state(cfg, weights.to_params(state, cfg, device=where), device=where)
        b = type(small)(*(None if x is None else x.to(where) for x in small))
        (st, loss), dt = _synced(lambda: tstate.make_train_step(cfg)(st, b, 0))
        res.append((float(loss), float(st.grad_norm), dt))
        del st
    (gl, gn, gs), (cl, cn, cs) = res
    log("train_parity", json.dumps({"dtype": "float32", "batch": 2, "loss_gpu": gl, "loss_cpu": cl,
                                    "grad_norm_gpu": gn, "grad_norm_cpu": cn, "gpu_seconds": gs,
                                    "cpu_seconds": cs}))
    if not (abs(gl - cl) <= 1e-4 * abs(cl) and abs(gn - cn) <= 1e-3 * abs(cn)):
        raise AssertionError(f"f32 GPU and CPU train steps differ: loss {gl} / {cl}, grad norm {gn} / {cn}")
    return launches


# ---------------------------------------------------------------------------------
# Phase 6b: train_epoch, the training and evaluation loop on a synthetic RefCOCO
# ---------------------------------------------------------------------------------

REFCOCO_IMAGES, REFCOCO_TRAIN, REFCOCO_VAL = 128, 100, 40   # images, training / validation annotations
EPOCH_BATCH = 32                                            # Config.batch_size


def write_refcoco(root, n_images=REFCOCO_IMAGES, n_train=REFCOCO_TRAIN, n_val=REFCOCO_VAL, seed=0, words=None):
    """A synthetic RefCOCO in the reference's on-disk formats, without Pillow:
    ``<root>/refs/refcoco/{instances.json, refs(unc).p}`` and, for each image,
    ``<root>/coco/train2014/COCO_train2014_<id>.jpg``, which holds a uint8 HWC
    array of 240-640 px saved by ``np.save`` (``preprocess.load_image`` reads
    it by its magic bytes). Annotations are spread over the images
    (some hold two), each with 1-3 sentences of 3-8 words drawn from
    ``words``; the first ``n_train`` are "train", the next ``n_val`` "val".
    Returns (coco_dir, ref_dir)."""
    import pickle

    import numpy as np

    from retr_tpu_torch.data.tokenizer import DEFAULT_TEST_WORDS

    words = list(words or DEFAULT_TEST_WORDS)
    rng = np.random.default_rng(seed)
    coco_dir, ref_dir = os.path.join(root, "coco"), os.path.join(root, "refs", "refcoco")
    os.makedirs(os.path.join(coco_dir, "train2014"), exist_ok=True)
    os.makedirs(ref_dir, exist_ok=True)
    sizes = []
    for i in range(n_images):
        h, w = int(rng.integers(240, 641)), int(rng.integers(240, 641))
        with open(os.path.join(coco_dir, "train2014", f"COCO_train2014_{1000 + i:012d}.jpg"), "wb") as f:
            np.save(f, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        sizes.append((h, w))
    annotations, refs, sent_id = [], [], 0
    for a in range(n_train + n_val):
        i = a % n_images
        h, w = sizes[i]
        x, y = float(rng.uniform(0, w * 0.6)), float(rng.uniform(0, h * 0.6))
        box = [x, y, float(rng.uniform(16, w - x)), float(rng.uniform(16, h - y))]
        annotations.append({"id": a, "image_id": 1000 + i, "bbox": box, "category_id": 1})
        sents = []
        for _ in range(int(rng.integers(1, 4))):
            sents.append({"sent_id": sent_id, "sent": " ".join(rng.choice(words, int(rng.integers(3, 9))))})
            sent_id += 1
        refs.append({"ann_id": a, "ref_id": a, "image_id": 1000 + i, "split": "train" if a < n_train else "val",
                     "file_name": f"COCO_train2014_{1000 + i:012d}_{a}.jpg", "sentences": sents})
    with open(os.path.join(ref_dir, "instances.json"), "w") as f:
        json.dump({"annotations": annotations}, f)
    with open(os.path.join(ref_dir, "refs(unc).p"), "wb") as f:
        pickle.dump(refs, f)
    return coco_dir, ref_dir


def train_epoch(dev, state, card, by_run):
    """Phase 6b at the served width (bf16, dropout 0.1) on a synthetic RefCOCO:
    six epochs of engine.train_one_epoch through build_dataset and a shuffled
    DataLoader at batch 32 (staged uploads off, on, then the two in turns),
    a seventh under torch.profiler; engine.evaluate on the validation split with
    use_pallas_attention (18 fused_attention launches a batch); engine.eval_model
    greedy and beam 5 on the unique validation annotations (32 + a ragged 8)."""
    import math
    import shutil
    import tempfile

    import torch

    from retr_tpu_torch import engine
    from retr_tpu_torch.data.dataset import DataLoader, build_dataset
    from retr_tpu_torch.metrics import NLGEval
    from retr_tpu_torch.models import weights
    from retr_tpu_torch.train import state as tstate
    from retr_tpu_torch.utils.profiling import PhaseTimer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_refcoco_")
    try:
        t0 = time.perf_counter()
        coco_dir, ref_dir = write_refcoco(tmp)
        tok = synthetic_tokenizer()
        cfg = served_config("bfloat16").replace(dropout=0.1, dir=coco_dir, ref_dir=ref_dir,
                                                batch_size=EPOCH_BATCH)

        def loader(mode, unique=False, **kw):
            ds = build_dataset(cfg, mode, tokenizer=tok, return_unique=unique)
            return DataLoader(ds, EPOCH_BATCH, num_workers=4, **kw)

        train_loader = loader("train", shuffle=True, drop_last=True)
        log("refcoco_fixture", json.dumps({"images": REFCOCO_IMAGES, "train_annotations": REFCOCO_TRAIN,
                                           "val_annotations": REFCOCO_VAL,
                                           "train_expressions": len(train_loader.dataset),
                                           "steps_per_epoch": len(train_loader),
                                           "seconds": time.perf_counter() - t0, "card": card}))
        st = tstate.create_train_state(cfg, weights.to_params(state, cfg, device=dev), device=dev,
                                       steps_per_epoch=len(train_loader))
        step = tstate.make_train_step(cfg)
        t0 = time.perf_counter()
        n_host = sum(1 for _ in train_loader)     # the loader alone: host preprocessing of an epoch
        dt = time.perf_counter() - t0
        log("train_loader", json.dumps({"batches": n_host, "seconds": dt, "samples_per_s": n_host * EPOCH_BATCH / dt,
                                        "num_workers": train_loader.num_workers, "card": card}))
        losses = []
        # epochs 0-1: inline then staged uploads; 2-5 the two in turns (epoch 0 pays the set-up)
        for epoch, staged in enumerate((False, True, False, True, True, False)):
            torch.cuda.reset_peak_memory_stats()
            (st, loss), dt = _synced(lambda: engine.train_one_epoch(st, step, train_loader, 0, epoch=epoch,
                                                                    stage_uploads=staged))
            losses.append(loss)
            steps = len(train_loader)
            log("train_epoch", json.dumps({"epoch": epoch, "stage_uploads": staged, "batch": EPOCH_BATCH,
                                           "steps": steps, "seconds": dt, "steps_per_s": steps / dt,
                                           "samples_per_s": steps * EPOCH_BATCH / dt, "loss": loss,
                                           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                                           "card": card}))
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"epoch losses not finite: {losses}")

        def recorded(staged):   # the batches a step receives, built inline or on the staging thread
            store = []
            engine.train_one_epoch(st, lambda state, batch, seed: (store.append(batch), (state, 0.0))[1],
                                   train_loader, 0, epoch=3, stage_uploads=staged)
            torch.cuda.synchronize()
            return store

        inline, staged = recorded(False), recorded(True)
        equal = len(inline) == len(staged) and all(
            (x is None and y is None) or torch.equal(x, y) for a, b in zip(inline, staged) for x, y in zip(a, b))
        log("staged_uploads", json.dumps({"batches": len(inline), "bit_equal_to_inline": equal, "card": card}))
        if not equal:
            raise AssertionError("batches built on the staging thread differ from those built inline")
        del inline, staged
        prof = device_profile(lambda: engine.train_one_epoch(st, step, train_loader, 0, epoch=6, stage_uploads=True),
                              len(train_loader), top_n=8)
        log("profile", json.dumps({"train_epoch": 6, "stage_uploads": True, "steps": len(train_loader), **prof,
                                   "card": card}))

        val_loader = loader("val")
        eval_cfg = cfg.replace(use_pallas_attention=True)
        want = (cfg.enc_layers + 2 * cfg.dec_layers) * len(val_loader)
        val_loss, dt, _ = counted("evaluate, use_pallas_attention", by_run,
                                  lambda: engine.evaluate(st.params, eval_cfg, val_loader), {"fused_attention": want})
        log("evaluate", json.dumps({"batches": len(val_loader), "expressions": len(val_loader.dataset),
                                    "seconds": dt, "loss": val_loss, "fused_attention_launches": want,
                                    "card": card}))
        if not math.isfinite(val_loss):
            raise AssertionError(f"validation loss {val_loss}")

        unique = loader("val", unique=True)
        # the scorer on known input: each annotation's first reference as its hypothesis
        refs = {}
        for ann_id, _, caption, _ in unique.dataset.annot:
            refs.setdefault(ann_id, []).append(engine.normalize_with_tokenizer(caption, tok))
        per_ann = [refs[a[0]] for a in unique.dataset.annot_select]
        own = NLGEval().compute_metrics(list(map(list, zip(*per_ann))), [r[0] for r in per_ann])
        log("metrics_on_references", json.dumps({**own, "card": card}))
        if not all(abs(own[k] - 1.0) < 1e-6 for k in ("Bleu_1", "ROUGE_L")) or not own["CIDEr"] > 0:
            raise AssertionError(f"the scorer on its own references: {own}")
        runs = (("eval_model greedy", "greedy", ["fused_stack_step"]),
                ("eval_model beam 5", "beam", ["self_attn_block_beam", "cross_attn_block", "ff_block"]))
        for label, decoder, kernels in runs:
            timer = PhaseTimer()
            (metrics, hyps), dt, counts = counted(
                label, by_run, lambda: engine.eval_model(st.params, cfg, unique, tok, decoder=decoder, timer=timer),
                {k: None for k in kernels})
            log("eval_model", json.dumps({"decoder": decoder, "expressions": len(hyps),
                                          "batches": len(unique), "seconds": dt, "expressions_per_s": len(hyps) / dt,
                                          "metrics": metrics, "phases": timer.summary(),
                                          "launches": {k: counts[k] for k in kernels},
                                          "first": [h["expression"][:60] for h in hyps[:2]], "card": card}))
            keys = {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}
            if len(hyps) != len(unique.dataset) or set(metrics) != keys or \
                    not all(math.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"{label}: {len(hyps)} hypotheses for {len(unique.dataset)}, metrics {metrics}")
        del st, step
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------------
# Phase 6c: main, the training entry point end to end, and the command lines
# ---------------------------------------------------------------------------------


def write_vocab(path):
    """The synthetic tokenizer's vocabulary (V entries, ids 0..V-1) as a vocab
    file, so ``Config.vocab_file`` gives main() and the CLIs a 30522-word tokenizer."""
    tok = synthetic_tokenizer()
    by_id = sorted(tok.vocab.items(), key=lambda kv: kv[1])
    if [i for _, i in by_id] != list(range(V)):
        raise AssertionError("the synthetic vocabulary does not cover ids 0..V-1")
    with open(path, "w") as f:
        f.writelines(t + "\n" for t, _ in by_id)
    return path


def init_checks(params, cfg):
    """Per-leaf checks of a fresh build_model tree against the reference's
    initialisers: a xavier table and an MHA projection (max|x| within the bound
    and above 0.9 of it, variance within 10% of b^2/3), a kaiming-normal
    convolution (variance within 10% of 2/fan_out), a folded identity
    BatchNorm (scale 1/sqrt(1 + 1e-5), bias 0, exact)."""
    import math

    import torch

    d = cfg.hidden_dim
    uniform = {"transformer.embeddings.word": (params["transformer"]["embeddings"]["word"]["table"],
                                               math.sqrt(6.0 / (V + d))),
               "transformer.encoder.layers.0.self_attn.mha.q": (
                   params["transformer"]["encoder"]["layers"][0]["self_attn"]["mha"]["q"]["w"], math.sqrt(6.0 / (4 * d)))}
    out = {}
    for name, (x, b) in uniform.items():
        x = x.double()
        top, var = float(x.abs().max()), float(x.var())
        out[name] = {"bound": b, "max_abs": top, "var_over_expected": var / (b * b / 3)}
        if not (0.9 * b < top <= b and abs(var / (b * b / 3) - 1) <= 0.1):
            raise AssertionError(f"{name}: {out[name]}")
    w = params["backbone"]["layer2"][0]["conv2"]["w"].double()
    want = 2.0 / (w.shape[0] * w.shape[2] * w.shape[3])
    out["backbone.layer2.0.conv2"] = {"var_over_expected": float(w.var()) / want, "mean": float(w.mean())}
    if abs(float(w.var()) / want - 1) > 0.1:
        raise AssertionError(f"kaiming conv: {out['backbone.layer2.0.conv2']}")
    bn = params["backbone"]["layer3"][0]["bn1"]
    if not (torch.equal(bn["scale"], torch.full_like(bn["scale"], 1.0 / math.sqrt(1.0 + 1e-5)))
            and not bn["bias"].any()):
        raise AssertionError("a fresh folded BatchNorm is not the identity")
    out["backbone.layer3.0.bn1"] = "identity, exact"
    return out


def train_main(dev, card, by_run):
    """Phase 6c at the served width (bf16, dropout 0.1, use_pallas_attention,
    async checkpoints) on phase 6b's synthetic RefCOCO: build_model on the card
    and its per-leaf init checks; main.main for 2 epochs, then resume=True to 3
    (resume logged at epoch 2, epoch 2 trained alone); a checkpoint loaded and
    saved inline and through AsyncSaver (seconds, bytes); eval_model's
    main_val_set on the latest checkpoint with --override_config (CIDEr and
    every metric equal to the last epoch_end) and with --decoder beam. The
    trained model decodes only PAD after 18 steps, so the decode is checked
    on an untrained checkpoint too: the CLI's hypotheses, all non-empty,
    equal engine.eval_model's on the parameters built anew, greedy and beam.
    export_pth of each checkpoint; the Predictors of each directory and of
    its .pth hold the same parameters, caption 8 requests alike (the
    untrained ones non-empty) and score 8 texts to the same bits. One
    ``main`` line."""
    import math
    import shutil
    import tempfile

    import torch

    from retr_tpu_torch import engine
    from retr_tpu_torch import eval_model as em
    from retr_tpu_torch import export_pth
    from retr_tpu_torch import main as tmain
    from retr_tpu_torch.config import Config
    from retr_tpu_torch.data.tokenizer import DEFAULT_TEST_WORDS, prepare_tokenizer
    from retr_tpu_torch.models import caption
    from retr_tpu_torch.predictor import Predictor
    from retr_tpu_torch.train import checkpoints as ckpt
    from retr_tpu_torch.train import state as tstate

    tmp = tempfile.mkdtemp(prefix="chip_smoke_main_")
    try:
        coco_dir, ref_dir = write_refcoco(os.path.join(tmp, "refcoco"))
        cfg = served_config("bfloat16").replace(
            dropout=0.1, dir=coco_dir, ref_dir=ref_dir, batch_size=EPOCH_BATCH, num_workers=4, epochs=2,
            use_pallas_attention=True, async_checkpoints=True, vocab_file=write_vocab(os.path.join(tmp, "vocab.txt")),
            project_data_path=os.path.join(tmp, "run"), checkpoint_path="")
        t0 = time.perf_counter()
        params, _ = caption.build_model(cfg, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_params = sum(x.numel() for _, x in tstate.tree_leaves_with_path(params))
        checks = init_checks(params, cfg)
        del params

        def events():
            with open(os.path.join(cfg.checkpoint_path, "metrics.jsonl")) as f:
                return [json.loads(line) for line in f]

        path_kernels = {"fused_stack_step": None, "fused_attention": None}
        _, train_s, train_counts = counted("main, 2 epochs", by_run,
                                           lambda: tmain.main(cfg), path_kernels)
        first = events()
        _, resume_run_s, resume_counts = counted("main, resume to 3 epochs", by_run,
                                                 lambda: tmain.main(cfg.replace(epochs=3), resume=True), path_kernels)
        ev = events()
        resumed = ev[len(first):]
        names = [e["event"] for e in resumed]
        if "resume" not in names or resumed[names.index("resume")]["epoch"] != 2 or \
                [e["epoch"] for e in resumed if e["event"] == "epoch_start"] != [2]:
            raise AssertionError(f"the resumed run: {names}")
        starts = {e["epoch"]: e["t"] for e in ev if e["event"] == "epoch_start"}
        ends = [e for e in ev if e["event"] == "epoch_end"]
        epochs = [{"epoch": e["epoch"], "seconds": e["t"] - starts[e["epoch"]], "train_loss": e["train_loss"],
                   "val_loss": e["val_loss"], "cider": e["cider"]} for e in ends]
        if [e["epoch"] for e in epochs] != [0, 1, 2] or not all(
                math.isfinite(e["train_loss"]) and math.isfinite(e["val_loss"]) for e in epochs):
            raise AssertionError(f"epochs: {epochs}")
        resume_s = resumed[names.index("resume")]["t"] - resumed[0]["t"]   # the resumed run's start to its resume

        latest = ckpt.latest_checkpoint(cfg.checkpoint_path, cfg)
        ckpt_bytes = sum(os.path.getsize(os.path.join(latest, f)) for f in os.listdir(latest))
        template = tstate.create_train_state(cfg, caption.build_model(cfg, seed=1, device=dev)[0], device=dev,
                                             steps_per_epoch=1)
        # the untrained model's checkpoint: after 18 steps the trained one
        # decodes only PAD, so this one's non-empty captions carry the decode checks
        fresh = ckpt.save_checkpoint(os.path.join(tmp, "fresh"), template, cfg, epoch=0)
        (st, meta), load_s = _synced(lambda: ckpt.load_checkpoint(latest, template))
        if st.step != meta["step"]:
            raise AssertionError(f"loaded step {st.step}, metadata {meta['step']}")
        _, save_sync_s = _synced(lambda: ckpt.save_checkpoint(os.path.join(tmp, "sync"), st, cfg, epoch=meta["epoch"]))
        saver = ckpt.AsyncSaver()
        _, submit_s = _synced(lambda: saver.submit(os.path.join(tmp, "async"), st, cfg, epoch=meta["epoch"]))
        t0 = time.perf_counter()
        saver.wait()
        wait_s = time.perf_counter() - t0
        del st, template
        torch.cuda.empty_cache()

        tok = prepare_tokenizer(cfg.vocab_file)[0]
        fresh_params = caption.build_model(cfg, seed=1, device=dev)[0]   # built anew, not read back
        evals = {}
        for decoder, kernels in (("greedy", path_kernels),
                                 ("beam", {k: None for k in ("self_attn_block_beam", "cross_attn_block", "ff_block")})):
            def run_cli(path):
                args = em.build_argparser().parse_args(["--checkpoint", path, "--override_config", "--decoder",
                                                        decoder, "--device", dev.type])
                return em.main_val_set(args, Config())

            (metrics, hyps), dt, counts = counted(f"eval_model CLI {decoder}", by_run, lambda: run_cli(latest), kernels)
            if len(hyps) != REFCOCO_VAL or len(metrics) != 7 or not all(math.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"eval_model --decoder {decoder}: {len(hyps)} hypotheses, {metrics}")
            # the CLI on the untrained checkpoint against engine.eval_model in
            # this process on the parameters built anew: the same hypotheses
            fresh_metrics, fresh_hyps = run_cli(fresh)
            want_metrics, want_hyps = engine.eval_model(fresh_params, cfg.replace(device=dev.type),
                                                        em.setup_val_dataloader(cfg, "val", tok), tok, decoder=decoder)
            if fresh_hyps != want_hyps or fresh_metrics != want_metrics:
                raise AssertionError(f"eval_model CLI --decoder {decoder} on a checkpoint against eval_model on its "
                                     f"parameters: {fresh_hyps[:2]} / {want_hyps[:2]}")
            if len(fresh_hyps) != REFCOCO_VAL or not all(h["expression"] for h in fresh_hyps):
                raise AssertionError(f"eval_model CLI --decoder {decoder}: empty hypotheses {fresh_hyps[:4]}")
            evals[decoder] = {"seconds": dt, "metrics": metrics, "launches": {k: counts[k] for k in kernels},
                              "untrained_hypotheses_equal_in_process": len(fresh_hyps),
                              "untrained_first_hypotheses": [h["expression"][:60] for h in fresh_hyps[:2]]}
        if evals["greedy"]["metrics"] != ends[-1]["metrics"]:
            raise AssertionError(f"eval CLI {evals['greedy']['metrics']} against epoch_end {ends[-1]['metrics']}")
        del fresh_params

        imgs, boxes = requests(8, seed=3)
        words = list(DEFAULT_TEST_WORDS)
        texts = [" ".join(words[3 * i:3 * i + 3 + i % 4]) for i in range(8)]
        predictor_checks = {}
        for label, path in (("trained", latest), ("untrained", fresh)):
            pth = export_pth.main(["--checkpoint", path])
            # from_checkpoint(.pth) would take the rest of the config from Config(), ResNet-101
            preds = [Predictor.from_checkpoint(path, max_batch=8, device=dev),
                     Predictor(ckpt.load_reference_state(pth)[0], cfg, max_batch=8, device=dev)]
            leaves = [list(tstate.tree_leaves_with_path(p.params)) for p in preds]
            if not all(a == b and torch.equal(x, y) for (a, x), (b, y) in zip(*leaves)):
                raise AssertionError(f"the {label} Predictor's parameters from the directory and its .pth differ")
            captions = [p.predict_batch(imgs, boxes) for p in preds]
            scores = [p.score(imgs, boxes, texts) for p in preds]
            if captions[0] != captions[1] or scores[0] != scores[1]:
                raise AssertionError(f"{label}: the directory's and its .pth's Predictors differ: {captions} {scores}")
            if not all(math.isfinite(r["logprob"]) and r["n_tokens"] > 0 for r in scores[0]):
                raise AssertionError(f"{label}: scores {scores[0]}")
            if label == "untrained" and not all(captions[0]):
                raise AssertionError(f"the untrained model's captions are empty: {captions[0]}")
            predictor_checks[label] = {"captions_equal": len(captions[0]), "scores_equal": len(scores[0]),
                                       "first_captions": [c[:60] for c in captions[0][:2]],
                                       "first_logprobs": [r["logprob"] for r in scores[0][:2]]}
            del preds, leaves
            os.remove(pth)
        log("main", json.dumps({
            "n_parameters": n_params, "build_model_s": build_s, "init_checks": checks, "epochs": epochs,
            "main_2_epochs_s": train_s, "main_resume_s": resume_run_s, "resume_s": resume_s, "load_s": load_s,
            "save_sync_s": save_sync_s, "save_async_submit_s": submit_s, "save_async_wait_s": wait_s,
            "checkpoint_bytes": ckpt_bytes, "eval_cli": evals,
            "launches": {"main, 2 epochs": {k: train_counts[k] for k in path_kernels},
                         "main, resume": {k: resume_counts[k] for k in path_kernels}},
            "predictor_dir_vs_pth": predictor_checks, "card": card}))
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------------
# Phase 6d: parallel, the (dp, mp) mesh: worlds of processes on the card
# ---------------------------------------------------------------------------------

PAR_BATCH = 16                                              # the global batch of the train steps
# world -> (dp, mp, backend): NCCL refuses two ranks on one device; gloo carries
# the port's collectives (all_reduce alone on tensors) on CUDA tensors
PAR_WORLDS = {"mp2": (1, 2, "gloo"), "dp2": (2, 1, "gloo"), "one": (1, 1, "nccl")}
PAR_KERNELS = ("fused_stack_step", "cross_attn_block", "ff_block", "self_attn_block_beam", "fused_attention")


def _row_min_margins(params, cfg, loader, decoder):
    """Per row of the loader, the reference's least top-2 logit margin over
    its greedy steps, or (beam) its least gap between the k-th and (k+1)-th
    candidate and between its two best final scores: the near-tie rule."""
    import torch

    from retr_tpu_torch import decode
    from retr_tpu_torch.data.pipeline import device_batch
    from retr_tpu_torch.masking import Masked
    from retr_tpu_torch.models import caption

    dev = next(iter(params["mlp"]["layers"][0].values())).device
    out = []
    with torch.no_grad():
        for host in loader:
            b = device_batch(host, dev)
            samples = Masked(b.images, b.image_masks)
            if decoder == "greedy":
                _, margins = greedy_with_margins(params, cfg, samples, 102)
                out += margins.min(dim=1).values.tolist()
            else:
                memory, mem_mask, pos = caption.encode(params, cfg, samples)
                gaps = []
                _, scores = decode.beam_search_from_memory(params, cfg, memory, mem_mask, pos, max_len=128,
                                                           bos_token=101, eos_token=102, beam_size=BEAM,
                                                           margins=gaps)
                least = torch.stack(gaps, dim=1).min(dim=1).values
                out += torch.minimum(least, scores[:, 0] - scores[:, 1]).tolist()
    return out


DIGEST_STAGES = ("backbone", "memory", "decode_step", "head_logits")


def _stage_digests(params, cfgs, batch):
    """Digests of one batch of 32 at each stage of the sweep's first greedy
    step, per compute type: the backbone features, the encoder memory, the
    decode step's hidden state (``fused_stack_step``) and the head's logits
    (cuBLAS). Where hypotheses differ between worlds, they say which stage's
    bits differ first."""
    import hashlib

    import torch

    from retr_tpu_torch import decode
    from retr_tpu_torch.masking import Masked
    from retr_tpu_torch.models import caption, resnet, transformer
    from retr_tpu_torch.precision import dtype_of, matmul_precision

    def digest(t):
        return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()).hexdigest()[:16]

    samples = Masked(batch.images, batch.image_masks)
    out = {}
    with torch.no_grad():
        for dt, cfg in cfgs.items():
            cfg, cdt = cfg.replace(use_pallas_attention=True), dtype_of(cfg.compute_dtype)
            feats = resnet.backbone_forward(params[dt]["backbone"], samples, name=cfg.backbone,
                                            dilation=cfg.dilation, compute_dtype=cdt)
            p, memory, mem_mask, pos = decode._encode_for_decode(params[dt], cfg, samples, None, None, cdt, None)
            tp = transformer.prepare_decoder(p["transformer"])
            cache, cross = transformer.init_decode_state(tp, memory, mem_mask, pos, cfg, cfg.max_position_embeddings)
            bos = torch.full((memory.shape[0],), 101, dtype=torch.int32, device=memory.device)
            with matmul_precision(memory.dtype):
                hs, _ = transformer.decode_step(tp, cache, cross, bos, torch.zeros((), dtype=torch.int32,
                                                                               device=memory.device), cfg)
                logits = caption.mlp_head(p["mlp"], hs)
            out[dt] = dict(zip(DIGEST_STAGES, map(digest, (feats.tensors, memory, hs, logits))))
    return out


def parallel_rank(kind, rank, world, store, workdir) -> int:
    """One rank of a phase 6d world (a process of its own; ``--parallel-rank``):
    3 f32 train steps at dropout 0 on a global batch of PAR_BATCH and evaluate
    on their parameters, 3 bf16 steps at dropout 0.1 (timed) and evaluate;
    each evaluate with use_pallas_attention on (fused_attention on this
    rank's rows and, under mp, its local heads) and off (the plain version);
    eval_model_sharded greedy and beam on the 40 validation expressions of
    build_model(seed=1) in f32 and bf16; mp2 saves its f32 state, the world
    of one loads it, and drives main.main for an epoch through its 1x1 mesh;
    the world of one also runs engine.eval_model with no mesh (the
    reference, before the counts are set to 0) at the loader's batch and at
    half of it (dp=2's rows), and the near-tie margins. After the counts are
    read: the stage digests (:func:`_stage_digests`) of one batch and of this
    rank's rows of it (the world of one: of each half), and
    engine.eval_model's bf16 greedy with the ranks at once and each alone.
    Writes ``<workdir>/<kind>.r<rank>.json``."""
    import math

    import torch
    import torch.distributed as dist

    from retr_tpu_torch import engine
    from retr_tpu_torch import main as tmain
    from retr_tpu_torch.config import Config
    from retr_tpu_torch.data import dataset
    from retr_tpu_torch.data.pipeline import device_batch
    from retr_tpu_torch.data.tokenizer import prepare_tokenizer
    from retr_tpu_torch.models import caption
    from retr_tpu_torch.ops import decoder_kernels as dk
    from retr_tpu_torch.parallel import mesh as pmesh
    from retr_tpu_torch.parallel.sweep import eval_model_sharded
    from retr_tpu_torch.train import checkpoints as ckpt
    from retr_tpu_torch.train import state as tstate

    dp, mp, backend = PAR_WORLDS[kind]
    dev = torch.device("cuda", 0)
    with open(os.path.join(workdir, "setup.json")) as f:
        data = json.load(f)
    pmesh.init_distributed(backend, dev, file_store=store, rank=rank, world_size=world)
    out = {"world": kind, "rank": rank, "backend": dist.get_backend(), "dp": dp, "mp": mp}
    try:
        mesh = pmesh.make_mesh(dp, mp, device=dev)
        cfgs = {dt: served_config(dt).replace(**data, device="cuda") for dt in ("float32", "bfloat16")}
        tok = prepare_tokenizer(cfgs["float32"].vocab_file)[0]
        train_set = dataset.build_dataset(cfgs["float32"], "training", tokenizer=tok)
        batch = device_batch(next(iter(dataset.DataLoader(train_set, PAR_BATCH, num_workers=4))), dev)
        unique_val = dataset.build_dataset(cfgs["float32"], "validation", tokenizer=tok, return_unique=True)
        val = dataset.build_dataset(cfgs["float32"], "validation", tokenizer=tok)

        def loader(ds):
            return dataset.DataLoader(ds, EPOCH_BATCH, num_workers=4)

        fresh = {dt: caption.build_model(cfg, seed=1, device=dev)[0] for dt, cfg in cfgs.items()}
        if kind == "one":   # the references, on one process and no mesh, before the counts
            for dt, cfg in cfgs.items():
                for decoder in ("greedy", "beam"):
                    _, hyps = engine.eval_model(fresh[dt], cfg.replace(use_pallas_attention=True), loader(unique_val),
                                                tok, decoder=decoder)
                    out[f"ref_{dt}_{decoder}"] = [h["expression"] for h in hyps]
                    # the same rows in batches of half the loader's: dp=2's halves, decoded alone
                    _, hyps = engine.eval_model(fresh[dt], cfg.replace(use_pallas_attention=True),
                                                dataset.DataLoader(unique_val, EPOCH_BATCH // 2, num_workers=4),
                                                tok, decoder=decoder)
                    out[f"ref_half_{dt}_{decoder}"] = [h["expression"] for h in hyps]
                    if dt == "float32":
                        out[f"margins_{decoder}"] = _row_min_margins(fresh[dt], cfg, loader(unique_val), decoder)
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        dk.reset_launches()
        t_start = time.perf_counter()

        cfg = cfgs["float32"]
        st = tstate.create_train_state(cfg, caption.build_model(cfg, seed=0, device=dev)[0], device=dev,
                                       steps_per_epoch=4, mesh=mesh)
        step = tstate.make_train_step(cfg)
        local = pmesh.shard_batch(mesh, batch)
        out["f32_losses"] = [float(step(st, local, 7)[1]) for _ in range(3)]
        # the kernel on this rank's rows and local heads, and its plain version, on the same parameters
        for pallas in (True, False):
            out[f"f32_val_loss_{'kernel' if pallas else 'plain'}"] = engine.evaluate(
                st.params, cfg.replace(use_pallas_attention=pallas), loader(val), mesh=mesh)
        ckpt_dir = os.path.join(workdir, "ckpt_mp2")
        if kind == "mp2":
            out["checkpoint"] = ckpt.save_checkpoint(ckpt_dir, st, cfg, epoch=0)
            out["f32_step4_loss"] = float(step(st, local, 7)[1])
        elif kind == "one":   # mp2's checkpoint, restored into this world's mesh shape
            path = ckpt.latest_checkpoint(ckpt_dir, cfg)
            template = tstate.create_train_state(cfg, caption.build_model(cfg, seed=2, device=dev)[0], device=dev,
                                                 steps_per_epoch=4, mesh=mesh)
            restored, meta = ckpt.load_checkpoint(path, template)
            out["restored_step"] = restored.step
            out["f32_step4_loss_restored"] = float(step(restored, local, 7)[1])
            del restored, template
        del st

        cfg = cfgs["bfloat16"].replace(dropout=0.1)
        st = tstate.create_train_state(cfg, caption.build_model(cfg, seed=0, device=dev)[0], device=dev,
                                       steps_per_epoch=4, mesh=mesh)
        step = tstate.make_train_step(cfg)
        step(st, local, 8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["bf16_losses"] = [float(step(st, local, 8)[1]) for _ in range(3)]
        torch.cuda.synchronize()
        out["bf16_ms_per_step"] = (time.perf_counter() - t0) / 3 * 1e3
        t0 = time.perf_counter()
        out["val_loss"] = engine.evaluate(st.params, cfg.replace(use_pallas_attention=True), loader(val), mesh=mesh)
        out["evaluate_s"] = time.perf_counter() - t0
        out["val_loss_plain"] = engine.evaluate(st.params, cfg.replace(use_pallas_attention=False), loader(val),
                                                mesh=mesh)
        del st

        for dt, cfg in cfgs.items():
            # this rank's slices: the sweep gathers them (an all_reduce over mp) and decodes the whole tree
            specs = pmesh.param_shardings(fresh[dt], mesh, cfg.nheads)
            local = pmesh.shard_params(fresh[dt], mesh, specs)
            for decoder in ("greedy", "beam"):
                t0 = time.perf_counter()
                metrics, hyps = eval_model_sharded(local, cfg.replace(use_pallas_attention=True),
                                                   loader(unique_val), tok, mesh, decoder=decoder,
                                                   return_hypotheses=True, specs=specs)
                out[f"sweep_{dt}_{decoder}"] = hyps
                out[f"sweep_{dt}_{decoder}_s"] = time.perf_counter() - t0
                if not all(math.isfinite(v) for v in metrics.values()):
                    raise AssertionError(f"{kind}: metrics {metrics}")
        if kind == "one":   # main through an explicit 1x1 mesh: its collectives run over NCCL
            mcfg = Config(**{**served_config("bfloat16").to_dict(), **data, "device": "cuda", "dropout": 0.1,
                             "epochs": 1, "dp_size": 1, "mp_size": 1, "async_checkpoints": False,
                             "project_data_path": os.path.join(workdir, "main_one")})
            t0 = time.perf_counter()
            tmain.main(mcfg)
            out["main_s"] = time.perf_counter() - t0
            with open(os.path.join(mcfg.checkpoint_path, "metrics.jsonl")) as f:
                events = [json.loads(line) for line in f]
            out["main_events"] = [e["event"] for e in events if e["event"] != "train_step"]
            out["main_epoch_end"] = {k: v for e in events if e["event"] == "epoch_end"
                                     for k, v in e.items() if k in ("train_loss", "val_loss", "cider")}
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t_start
        out["launches"] = {k: dk.LAUNCHES[k] for k in PAR_KERNELS}
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        host = next(iter(loader(unique_val)))
        out["digests"] = _stage_digests(fresh, cfgs, device_batch(host, dev))
        # this rank's rows as the sweep uploads them; the world of one: each half alone
        out["digests_local"] = _stage_digests(fresh, cfgs, device_batch(pmesh.shard_batch(mesh, host), dev))
        if kind == "one":
            half = EPOCH_BATCH // 2
            out["digests_halves"] = [_stage_digests(fresh, cfgs, device_batch(
                type(host)(*(None if x is None else x[h * half:(h + 1) * half] for x in host)), dev))
                for h in (0, 1)]
        # bf16 greedy through engine.eval_model (no mesh, the whole split) with
        # every rank at once, then with each rank alone on the card in turn
        cfg16 = cfgs["bfloat16"].replace(use_pallas_attention=True)

        def greedy16():
            torch.cuda.synchronize()
            hyps = engine.eval_model(fresh["bfloat16"], cfg16, loader(unique_val), tok)[1]
            torch.cuda.synchronize()
            return [h["expression"] for h in hyps]

        dist.barrier()
        out["bf16_greedy_together"] = greedy16()
        for r in range(world):
            dist.barrier()
            if r == rank:
                out["bf16_greedy_alone"] = greedy16()
        dist.barrier()
    except BaseException:
        import traceback

        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(workdir, f"{kind}.r{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()
    return 0


def _run_world(kind, workdir, timeout=420):
    """Start the world's ranks at once; wait for all, killing any left at the
    deadline; raise with each rank's last output if one failed."""
    dp, mp, _ = PAR_WORLDS[kind]
    world = dp * mp
    store = os.path.join(workdir, f"{kind}.store")
    logs = [os.path.join(workdir, f"{kind}.r{r}.log") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank", kind,
                                               str(r), str(world), store, workdir], stdout=log,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        text = "".join(f"--- rank {r} (exit {p.returncode}) ---\n" + open(logs[r]).read()[-3000:]
                       for r, p in enumerate(procs))
        raise AssertionError(f"parallel world {kind} failed:\n{text}")
    ranks = []
    for r in range(world):
        with open(os.path.join(workdir, f"{kind}.r{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def parallel(dev, card, by_run):
    """Phase 6d at the served width on a synthetic RefCOCO (phase 6b's
    writer): (c) mp=2 and (b) dp=2, two processes each on the one card over
    gloo, then (a) a world of one over NCCL. Every world's f32 losses within
    1e-4 relative of (a)'s at the same global batch, and so its f32
    evaluate on their parameters; each evaluate through fused_attention (on
    dp's halves and mp's local heads) within TOL of the plain version on the
    same parameters, f32 and bf16; its f32 hypotheses equal to (a)'s
    engine.eval_model on one process except where the reference had a
    near-tie (top-2 margin, or beam candidate gap, under 1e-4); its bf16
    hypotheses counted, against (a)'s at the loader's batch and at half of
    it, and the stage digests of its own rows against (a)'s of the same rows
    alone; (a) restores (c)'s checkpoint and takes (c)'s fourth step within
    1e-4; every kernel of PAR_KERNELS launched on every rank. One
    ``parallel`` line per world."""
    import math
    import shutil
    import tempfile

    import torch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        coco_dir, ref_dir = write_refcoco(os.path.join(tmp, "refcoco"))
        with open(os.path.join(tmp, "setup.json"), "w") as f:
            json.dump({"dir": coco_dir, "ref_dir": ref_dir, "vocab_file": write_vocab(os.path.join(tmp, "vocab.txt")),
                       "batch_size": EPOCH_BATCH, "num_workers": 4}, f)
        worlds = {kind: _run_world(kind, tmp) for kind in PAR_WORLDS}
        one = worlds["one"][0]
        note = (f"{torch.cuda.device_count()} card(s): the worlds of two share cuda:0 over gloo; "
                "no NCCL world across cards was run")
        for kind, ranks in worlds.items():
            checks = {}
            for r in ranks:
                diff = max(abs(a - b) / abs(b) for a, b in zip(r["f32_losses"], one["f32_losses"]))
                if not diff <= 1e-4:
                    raise AssertionError(f"{kind} rank {r['rank']}: f32 losses {r['f32_losses']} against "
                                         f"{one['f32_losses']}")
                for k in PAR_KERNELS:
                    if r["launches"][k] <= 0:
                        raise AssertionError(f"{kind} rank {r['rank']}: {k} never launched: {r['launches']}")
                for decoder in ("greedy", "beam"):
                    want, got = one[f"ref_float32_{decoder}"], r[f"sweep_float32_{decoder}"]
                    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
                    if len(got) != REFCOCO_VAL or any(not one[f"margins_{decoder}"][i] < 1e-4 for i in bad):
                        raise AssertionError(f"{kind} rank {r['rank']}: f32 {decoder} hypotheses differ from "
                                             f"engine.eval_model's without a near-tie at rows {bad}")
                    equal16 = sum(a == b for a, b in zip(r[f"sweep_bfloat16_{decoder}"],
                                                         one[f"ref_bfloat16_{decoder}"]))
                    checks.setdefault(f"f32_{decoder}_equal", []).append(REFCOCO_VAL - len(bad))
                    checks.setdefault(f"bf16_{decoder}_equal", []).append(equal16)
                checks.setdefault("f32_loss_max_rel_diff", []).append(diff)
                got, want = r["f32_val_loss_kernel"], one["f32_val_loss_kernel"]
                if not abs(got - want) <= 1e-4 * abs(want):
                    raise AssertionError(f"{kind} rank {r['rank']}: f32 evaluate {got} against (a)'s {want}")
                checks.setdefault("f32_val_loss_rel_diff", []).append(abs(got - want) / abs(want))
                for dname, on, off in (("float32", r["f32_val_loss_kernel"], r["f32_val_loss_plain"]),
                                       ("bfloat16", r["val_loss"], r["val_loss_plain"])):
                    if not abs(on - off) <= TOL[dname] * max(1.0, abs(off)):
                        raise AssertionError(f"{kind} rank {r['rank']}: {dname} evaluate through fused_attention "
                                             f"{on} against the plain version's {off}")
                    checks.setdefault(f"{dname}_evaluate_kernel_minus_plain", []).append(on - off)
                for decoder in ("greedy", "beam"):
                    checks.setdefault(f"bf16_{decoder}_equal_at_half_batch", []).append(
                        sum(a == b for a, b in zip(r[f"sweep_bfloat16_{decoder}"], one[f"ref_half_bfloat16_{decoder}"])))
                same_rows = one["digests_halves"][r["rank"] // r["mp"]] if r["dp"] == 2 else one["digests"]
                checks.setdefault("stage_bits_differing_on_same_rows", []).append(
                    {dt: [stage for stage in DIGEST_STAGES if r["digests_local"][dt][stage] != same_rows[dt][stage]]
                     for dt in ("float32", "bfloat16")})
            for k in PAR_KERNELS:
                counts = by_run.setdefault(k, {})
                counts["parallel"] = counts.get("parallel", 0) + sum(r["launches"][k] for r in ranks)
            line = {"world": kind, "ranks": len(ranks), "dp": ranks[0]["dp"], "mp": ranks[0]["mp"],
                    "backend": ranks[0]["backend"], "device": "cuda:0",
                    "bf16_ms_per_step": [r["bf16_ms_per_step"] for r in ranks],
                    "f32_losses": ranks[0]["f32_losses"], "bf16_losses": ranks[0]["bf16_losses"],
                    "val_loss": ranks[0]["val_loss"], "val_loss_plain": ranks[0]["val_loss_plain"],
                    "f32_val_loss": ranks[0]["f32_val_loss_kernel"], "evaluate_s": [r["evaluate_s"] for r in ranks],
                    "sweep_s": {k: [r[f"sweep_{k}_s"] for r in ranks] for k in
                                ("float32_greedy", "float32_beam", "bfloat16_greedy", "bfloat16_beam")},
                    "expressions": REFCOCO_VAL, **checks,
                    "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
                    "launches": [r["launches"] for r in ranks], "seconds": [r["seconds"] for r in ranks],
                    # engine.eval_model's bf16 greedy, equal to (a)'s reference: ranks at once, each alone
                    "bf16_greedy_equal_together": [sum(a == b for a, b in zip(r["bf16_greedy_together"],
                                                                             one["ref_bfloat16_greedy"])) for r in ranks],
                    "bf16_greedy_equal_alone": [sum(a == b for a, b in zip(r["bf16_greedy_alone"],
                                                                          one["ref_bfloat16_greedy"])) for r in ranks],
                    # the first validation batch's stages, bit-equal to (a)'s per rank and type
                    "stage_bits_equal_to_one": {dt: {stage: [r["digests"][dt][stage] == one["digests"][dt][stage]
                                                             for r in ranks] for stage in DIGEST_STAGES}
                                                for dt in ("float32", "bfloat16")},
                    "note": note, "card": card}
            if kind == "one":
                if one["restored_step"] != 3 or not abs(one["f32_step4_loss_restored"] - worlds["mp2"][0][
                        "f32_step4_loss"]) <= 1e-4 * abs(worlds["mp2"][0]["f32_step4_loss"]):
                    raise AssertionError(f"mp2's checkpoint in the world of one: step {one['restored_step']}, loss "
                                         f"{one['f32_step4_loss_restored']} against {worlds['mp2'][0]['f32_step4_loss']}")
                if "mesh" not in one["main_events"] or not math.isfinite(one["main_epoch_end"].get("cider", math.nan)):
                    raise AssertionError(f"main through the 1x1 mesh: {one['main_events']} {one['main_epoch_end']}")
                line.update(checkpoint_from_mp2={"step": one["restored_step"],
                                                 "step4_loss": one["f32_step4_loss_restored"],
                                                 "mp2_step4_loss": worlds["mp2"][0]["f32_step4_loss"]},
                            main_s=one["main_s"], main_epoch_end=one["main_epoch_end"])
            log("parallel", json.dumps(line))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def loop_times(tree) -> int:
    """One turn of --compare: the decode-loop times of the package under ``tree``."""
    import statistics

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from retr_tpu_torch import decode
    from retr_tpu_torch.models import weights
    from retr_tpu_torch.ops import decoder_kernels as dk

    card = gpu_line()
    cfg = served_config("bfloat16")
    params = weights.to_params(random_state(cfg), cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    runs = [(32, "greedy", "LAYER_GRID", True), (32, "greedy", "LAYER_GRID", False),
            (512, "greedy", "LAYER_GRID", True), (512, "greedy", "LAYER_GRID", False)]
    if hasattr(decode, "beam_search_from_memory"):
        runs += [(32, "beam", "BEAM_TOPK_KERNEL", False), (32, "beam", "BEAM_TOPK_KERNEL", True),
                 (512, "beam", "BEAM_TOPK_KERNEL", False), (512, "beam", "BEAM_TOPK_KERNEL", True)]
    memory = {b: encode_for_decode(params, cfg, random_samples(b, gen, "cuda")) for b in (32, 512)}
    for b, decoder, flag, value in runs:
        p, mem, mask, pos = memory[b]
        setattr(dk, flag, value)
        times = []
        for _ in range(6):                                  # first run warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if decoder == "greedy":
                decode.greedy_from_memory(p, cfg, mem, mask, pos, max_len=128, bos_token=101, eos_token=V)
            else:
                decode.beam_search_from_memory(p, cfg, mem, mask, pos, max_len=128, bos_token=101, eos_token=V,
                                               beam_size=BEAM)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / 127 * 1e3)
        log("loop_times", json.dumps({"tree": tree, "package": os.path.dirname(decode.__file__), "decoder": decoder, "batch": b, flag: value,
                                      "ms_per_step_median": statistics.median(times[1:]), "ms_per_step": times[1:],
                                      "card": card}))
    log("stack_digest", json.dumps({"tree": tree, **stack_digest("cuda")}))
    return 0


def stack_digest(dev) -> dict:
    """sha256 of rt_stack_step's output and cache slots at batch 32 and 512, f32
    and bf16, step 63, on inputs made from a seed: --compare prints it for
    each tree, so equal digests show the two trees' stacked kernels agree bit
    for bit."""
    import hashlib

    import torch

    from retr_tpu_torch.ops import decoder_kernels as dk

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(12)
        slp = random_decoder(gen, dev, dtype)
        for b in (32, 512):
            rn = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
            x, qpos, kc, vc = rn(b, C), rn(C), rn(L, b, H, T, D), rn(L, b, H, T, D)
            ck, cv = rn(L, b, H, S, D), rn(L, b, H, S, D)
            kb = torch.where(torch.rand(b, S, generator=gen, device=dev) < 0.2, float("-inf"), 0.0)
            kb[:, 0] = 0.0
            step = torch.tensor(CHECK_STEP, dtype=torch.int32, device=dev)
            y, kc, vc = dk.fused_stack_step(slp, x, qpos, kc, vc, ck, cv, kb, step, num_heads=H)
            h = hashlib.sha256()
            for t in (y, kc[:, :, :, CHECK_STEP], vc[:, :, :, CHECK_STEP]):
                h.update(_bits(t).cpu().numpy().tobytes())
            out[f"{str(dtype)[6:]} batch {b}"] = h.hexdigest()[:16]
    return out


def kernel_times(tree) -> int:
    """Device time per launch (torch.profiler) and CUDA-event time per call of
    fused_attention at batch 32 (ATTN_SHAPES, f32 and bf16, beside SDPA's),
    of self_attn_block_beam at 160 and 2560 rows and of self_attn_block at
    32 and 512 rows (step 63, the six layers' weights and caches cycled) in
    the retr_tpu_torch package under ``tree``: the same seeded inputs for
    every tree."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as Fn

    from retr_tpu_torch.ops import attention as fa
    from retr_tpu_torch.ops import decoder_kernels as dk

    card, dev = gpu_line(), torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        gen = torch.Generator(device=dev).manual_seed(7)
        for label, (sq, sk, causal, _) in ATTN_SHAPES.items():
            q, k, v = (torch.randn(TRAIN_BATCH, H, s_, D, generator=gen, device=dev).to(dtype) for s_ in (sq, sk, sk))
            pad = torch.rand(TRAIN_BATCH, sk, generator=gen, device=dev) < 0.3
            pad[:, 0] = False
            kb = torch.where(pad, float("-inf"), 0.0)
            mask = kb.clamp_min(-1e30)[:, None, None, :]
            if causal:
                mask = mask + torch.full((sq, sk), -1e30, device=dev).triu(1)
            mask = mask.to(dtype)
            kern = lambda: fa.fused_attention(q, k, v, kb, causal=causal)  # noqa: E731
            lib = lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=mask)  # noqa: E731
            rec = {"tree": tree, "kernel": "fused_attention", "dtype": dname, "shape": f"{label} {sq}x{sk}",
                   "device_ms": device_ms(kern, "", per_call=True), "ms_events": time_ms(kern),
                   "library_device_ms": device_ms(lib, "", per_call=True), "library_ms_events": time_ms(lib),
                   "card": card}
            if hasattr(fa, "attention_plan"):
                rec["plan"] = fa.attention_plan(dtype, D, sq, sk)
            log("kernel_times", json.dumps(rec))
        gen = torch.Generator(device=dev).manual_seed(5)
        layers_ = [dk.layer_params(random_decoder(gen, dev, dtype), li)["self_attn"] for li in range(L)]
        for bk in (32 * BEAM, 512 * BEAM):
            x, qpos = torch.randn(bk, C, generator=gen, device=dev).to(dtype), torch.zeros(C, device=dev).to(dtype)
            kc, vc = (torch.randn(L, bk, H, T, D, generator=gen, device=dev).to(dtype) for _ in range(2))
            anc = torch.randint(0, BEAM, (bk, T), generator=gen, device=dev, dtype=torch.int32)
            step = torch.tensor(CHECK_STEP, dtype=torch.int32, device=dev)
            call = lambda: [dk.self_attn_block_beam(layers_[li], x, anc, qpos, kc[li], vc[li], step,  # noqa: E731
                                                    num_heads=H, num_beams=BEAM) for li in range(L)]
            rec = {"tree": tree, "kernel": "self_attn_block_beam", "dtype": dname, "rows": bk,
                   "device_ms": device_ms(call, ""), "ms_events": time_ms(call) / L, "card": card}
            if "self_attn_block_beam" in getattr(dk, "_PLAN_KIND", {}):
                rec["plan"] = dk.block_plan("self_attn_block_beam", dtype, bk, t=T, num_beams=BEAM)
            log("kernel_times", json.dumps(rec))
            del kc, vc
            torch.cuda.empty_cache()
        for b in (32, 512):
            x, qpos = torch.randn(b, C, generator=gen, device=dev).to(dtype), torch.zeros(C, device=dev).to(dtype)
            kc, vc = (torch.randn(L, b, H, T, D, generator=gen, device=dev).to(dtype) for _ in range(2))
            step = torch.tensor(CHECK_STEP, dtype=torch.int32, device=dev)
            call = lambda: [dk.self_attn_block(layers_[li], x, qpos, kc[li], vc[li], step,  # noqa: E731
                                               num_heads=H) for li in range(L)]
            rec = {"tree": tree, "kernel": "self_attn_block", "dtype": dname, "rows": b,
                   "device_ms": device_ms(call, ""), "ms_events": time_ms(call) / L,
                   "cycled_cache_mb": 2 * kc.numel() * kc.element_size() / 1e6, "card": card}
            if "self_attn_block" in getattr(dk, "_PLAN_KIND", {}):
                rec["plan"] = dk.block_plan("self_attn_block", dtype, b, t=T)
            log("kernel_times", json.dumps(rec))
            del kc, vc
            torch.cuda.empty_cache()
    return 0


def compare(parent, change) -> int:
    for tree in (parent, change, change, parent, parent, change):
        for mode in ("--kernel-times", "--loop-times"):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), mode, tree])
            if proc.returncode != 0:
                return proc.returncode
    return 0


def main(mode=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from retr_tpu_torch.ops import decoder_kernels as dk
    except ImportError as exc:
        print(f"chip_smoke: the retr_tpu_torch package is not beside this script ({exc})", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    card = gpu_line()
    if mode == "--block-rows":
        block_rows(dev, card)
        return 0
    log("card", card)                                                      # phase 1

    t0 = time.perf_counter()
    dk.build()                                                             # phase 2
    log("build", json.dumps({"seconds": time.perf_counter() - t0}))

    checks = {**check_kernels(dev), **check_blocks(dev), **check_beam_and_heads(dev),   # phase 3
              **check_attention(dev)}
    check_stack_edges(dev)
    check_block_edges(dev)
    check_head_edges(dev)
    check_attention_edges(dev)
    check_beam_edges(dev)
    check_self_edges(dev)
    torch.cuda.empty_cache()

    state = random_state(served_config("bfloat16"))                        # phase 4
    params, launches, by_run = serve(dev, state, synthetic_tokenizer())
    throughput(dev, params, card)
    step_profile(dev, params)
    del params
    torch.cuda.empty_cache()
    serve_apis(dev, state, synthetic_tokenizer(), card, by_run)         # phase 4b
    torch.cuda.empty_cache()

    other_width(dev)                                                       # phase 5
    f32_parity(dev, state)
    f32_beam_parity(dev, state)
    torch.cuda.empty_cache()

    launches["fused_attention"] = train(dev, state, card)                 # phase 6
    train_epoch(dev, state, card, by_run)                                  # phase 6b
    train_main(dev, card, by_run)                                          # phase 6c
    parallel(dev, card, by_run)                                            # phase 6d

    entries = []                                                           # phase 7
    for name, (replaces, source, case) in KERNELS.items():
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was never launched on its path: {launches}")
        main_rec = checks[(name, *case)]                                   # the main path's shape
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": main_rec["max_abs_err"], "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "shape": main_rec.get("shape", f"bf16, {case[1]} rows, step {CHECK_STEP}"),
            "cases": [{k: r[k] for k in ("dtype", "batch", "shape", "max_abs_err", "ms", "ms_events", "plain_ms",
                                          "bound_ms", "library_ms", "library_device_ms", "plan") if k in r}
                      for (n, _, _), r in checks.items() if n == name],
        }
        for key in ("grid", "plan", "device_ms", "ms_events", "library_device_ms", "phase_us"):   # the kernel's own lines
            if key in main_rec:
                entry[key] = main_rec[key]
        if by_run.get(name):
            entry["launches_by_run"] = by_run[name]
        if name == "fused_attention":   # launches: eval steps; the serving encoder's beside them
            entry["launches_serving_encoder"] = launches["fused_attention (serving encoder)"]
        entries.append(entry)
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.path.insert(0, REPO)
        sys.exit(parallel_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6]))
    if sys.argv[1:2] == ["--loop-times"]:
        sys.exit(loop_times(sys.argv[2]))
    if sys.argv[1:2] == ["--kernel-times"]:
        sys.exit(kernel_times(sys.argv[2]))
    if sys.argv[1:2] == ["--compare"]:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    sys.exit(main(*sys.argv[1:2]))
