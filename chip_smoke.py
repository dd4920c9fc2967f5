#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (retr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA decode kernels from retr_tpu_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version at full width
     (C=256, 8 heads, F=2048, T=128, S=196, L=6) at batch 32 and 512, in f32 and
     bf16, and time kernel, plain version and a library yardstick (CUDA events);
  4. serve requests through Predictor at the served width (ResNet-50 dilated,
     6+6 layers, d=256, vocab 30522, bf16, random weights from a seed), once with
     the one-launch stacked kernel and once with the per-layer kernel trio, with
     the launch counts reset before and read after each; then time greedy at
     batch 32 and 512 for all 127 steps with EOS out of range, and trace 32
     steps with torch.profiler (device time by kernel, idle share);
  5. one f32 batch of 4 on the GPU and on the CPU (plain path): equal token
     buffers, except where the CPU logits' top-2 margin is below 1e-4;
  6. every kernel's launch count from its path's run must be > 0.

The line before the last holds {"kernels": [...]}, one entry per kernel; the
last line is {"ok": true, "device": {...}}. It needs the rest of the repository
beside it and a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

C, H, D, F, T, S, L, V = 256, 8, 32, 2048, 128, 196, 6, 30522
HBM_BYTES_PER_S = 3.35e12                         # H100 SXM data sheet
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
CHECK_STEP = 63                                   # mid-decode position for the kernel checks
KERNELS = {  # wrapper -> the Pallas kernel it replaces
    "fused_stack_step": "retr_tpu/ops/decoder_kernels.py:1026",
    "self_attn_block": "retr_tpu/ops/decoder_kernels.py:228",
    "cross_attn_block": "retr_tpu/ops/decoder_kernels.py:450",
    "ff_block": "retr_tpu/ops/decoder_kernels.py:96",
}
# Tolerance of kernel vs plain version, as a fraction of max(1, max|plain|):
# f32 differs only by summation order; bf16 rounds at the same points on both
# sides, but an f32 order difference can flip one rounding and propagate.
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
    """(bytes, operations) the function needs: each input read once, each output
    written once; self caches read at the positions before ``step``."""
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
    return (io + L * ((attn_w + cross_w + ff_w) * esize + self_cache + cross_kv) + b * S * 4 + 4,
            L * (self_ops + cross_ops + ff_ops))


def check_kernels(dev):
    """Returns {(name, dtype, batch): record}."""
    import torch
    import torch.nn.functional as Fn

    from retr_tpu_torch.ops import decoder_kernels as dk
    from retr_tpu_torch.precision import matmul_precision

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
                "cross_attn_block": (
                    lambda li: dk.cross_attn_block(layers_[li]["cross_attn"], x, qpos, ck[li], cv[li], kb, num_heads=H),
                    lambda li: dk.cross_attn_block_plain(layers_[li]["cross_attn"], x, qpos, ck[li], cv[li], kb, num_heads=H),
                    # yardstick: PyTorch's attention over the memory K/V alone
                    lambda li: Fn.scaled_dot_product_attention(
                        x.view(b, H, 1, D), ck[li], cv[li], attn_mask=kb.clamp_min(-1e30).to(dtype)[:, None, None, :])),
                "ff_block": (lambda li: dk.ff_block(layers_[li]["ff"], x),
                             lambda li: dk.ff_block_plain(layers_[li]["ff"], x), None),
            }
            with matmul_precision(torch.float32):   # plain versions in full f32
                for name, (kern, plain, lib) in cases.items():
                    got, want = kern(0), plain(0)
                    torch.cuda.synchronize()
                    got = [g.float() for g in (got if isinstance(got, tuple) else (got,))]
                    want = [w.float() for w in (want if isinstance(want, tuple) else (want,))]
                    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                    scale = max(1.0, float(want[0].abs().max()))
                    finite = all(bool(torch.isfinite(g).all()) for g in got)
                    ok = finite and err <= TOL[dname] * scale
                    # split kernels cycle over the 6 layers' weights and K/V, as
                    # the decode loop does; the stacked one covers them per launch
                    nl = 1 if name == "fused_stack_step" else L
                    cyc = lambda fn: (lambda: [fn(li) for li in range(nl)])  # noqa: E731
                    ms = time_ms(cyc(kern)) / nl
                    plain_ms = time_ms(cyc(plain), reps=5, rounds=3) / nl
                    lib_ms = None if lib is None else time_ms(cyc(lib)) / nl
                    nbytes, ops = kernel_work(name, b, torch.finfo(dtype).bits // 8, CHECK_STEP)
                    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dname] * 1e3
                    rec = dict(name=name, dtype=dname, batch=b, max_abs_err=err, tol=TOL[dname] * scale,
                               ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
                    log("kernel", json.dumps(rec))
                    if not ok:
                        raise AssertionError(f"{name} {dname} b={b}: max_abs_err {err} > {TOL[dname] * scale}"
                                             f" (finite={finite})")
                    out[(name, dname, b)] = rec
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


def serve(dev, state, tok):
    """Predictor runs with each kernel dispatch; returns launch counts per path."""
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
    launches = {}
    for grid in (True, False):
        dk.LAYER_GRID = grid
        dk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        texts = pred.predict_batch(imgs, boxes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(dk.LAUNCHES)
        path = ["fused_stack_step"] if grid else ["self_attn_block", "cross_attn_block", "ff_block"]
        for k in path:
            launches[k] = counts[k]
        log("serve", json.dumps({"layer_grid": grid, "requests": len(imgs), "seconds": dt,
                                 "requests_per_s": len(imgs) / dt, "launches": counts,
                                 "first_captions": [t[:60] for t in texts[:3]]}))
        if len(texts) != len(imgs) or not all(isinstance(t, str) for t in texts):
            raise AssertionError("Predictor returned malformed captions")
    dk.LAYER_GRID = True
    return pred.params, launches


def throughput(dev, params, card):
    """Greedy at batch 32 and 512, all 127 steps (EOS out of range), with the
    stacked kernel and with the per-layer trio."""
    import torch

    from retr_tpu_torch import decode
    from retr_tpu_torch.masking import Masked
    from retr_tpu_torch.models import caption
    from retr_tpu_torch.ops import decoder_kernels as dk

    cfg = served_config("bfloat16")
    gen = torch.Generator(device=dev).manual_seed(1)
    for b in (32, 512):
        samples = Masked(torch.randn(b, 3, 224, 224, generator=gen, device=dev),
                         torch.zeros(b, 224, 224, dtype=torch.bool, device=dev))
        for grid in (True, False):
            dk.LAYER_GRID = grid
            runs = []
            for _ in range(4):                                  # first run warms up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                memory, mask, pos = caption.encode(params, cfg, samples, compute_dtype=torch.bfloat16)
                p, memory, pos = decode._cast_for_decode(params, memory, pos, torch.bfloat16)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ids = decode.greedy_from_memory(p, cfg, memory, mask, pos, max_len=128, bos_token=101,
                                                eos_token=V)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                runs.append((t2 - t0, t1 - t0, t2 - t1))
            if tuple(ids.shape) != (b, 128) or int(ids.min()) < 0 or int(ids.max()) >= V:
                raise AssertionError(f"greedy returned a malformed buffer {tuple(ids.shape)}")
            total, enc, loop = sorted(runs[1:])[1]
            log("throughput", json.dumps({"batch": b, "layer_grid": grid, "steps": 127, "seconds": total,
                                          "encode_s": enc, "decode_loop_s": loop,
                                          "ms_per_step": loop / 127 * 1e3, "captions_per_s": b / total,
                                          "card": card}))
    dk.LAYER_GRID = True


def step_profile(dev, params, steps=32):
    """Where a decode loop's device time goes: torch.profiler over ``steps``
    greedy steps with the stacked kernel, at batch 32 and 512. Prints device
    time by kernel name and the device's idle share over the loop's span (first
    kernel start to last kernel end)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from retr_tpu_torch import decode
    from retr_tpu_torch.masking import Masked
    from retr_tpu_torch.models import caption

    cfg = served_config("bfloat16")
    gen = torch.Generator(device=dev).manual_seed(3)
    for b in (32, 512):
        samples = Masked(torch.randn(b, 3, 224, 224, generator=gen, device=dev),
                         torch.zeros(b, 224, 224, dtype=torch.bool, device=dev))
        memory, mask, pos = caption.encode(params, cfg, samples, compute_dtype=torch.bfloat16)
        p, memory, pos = decode._cast_for_decode(params, memory, pos, torch.bfloat16)

        def loop():
            return decode.greedy_from_memory(p, cfg, memory, mask, pos, max_len=steps + 1, bos_token=101,
                                             eos_token=V)

        loop()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loop()
            torch.cuda.synchronize()
        spans, by_name = [], {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end))
                by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        if not spans:
            log("profile", json.dumps({"batch": b, "device_time": "not measured (no CUDA events traced)"}))
            continue
        spans.sort()
        busy, cur_s, cur_e = 0.0, *spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy, cur_s, cur_e = busy + cur_e - cur_s, s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        span = spans[-1][1] - spans[0][0]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log("profile", json.dumps({
            "batch": b, "steps": steps, "span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / span,
            "top_kernels_ms_per_step": {n[:80]: t / 1e3 / steps for n, t in top}}))


def greedy_with_margins(params, cfg, samples, eos):
    """The greedy loop on the CPU, also returning each step's top-2 logit margin."""
    import torch

    from retr_tpu_torch.models import caption, transformer

    memory, mask, pos = caption.encode(params, cfg, samples)
    tp = transformer.prepare_decoder(params["transformer"])
    cache, cross = transformer.init_decode_state(tp, memory, mask, pos, cfg, 128)
    b = memory.shape[0]
    ids = torch.zeros((b, 128), dtype=torch.int32)
    ids[:, 0] = 101
    margins = torch.full((b, 128), float("inf"))
    finished = torch.zeros(b, dtype=torch.bool)
    step = torch.zeros((), dtype=torch.int32)
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


def f32_parity(dev, state):
    import torch

    from retr_tpu_torch import decode
    from retr_tpu_torch.masking import Masked
    from retr_tpu_torch.models import weights

    cfg = served_config("float32")
    gen = torch.Generator().manual_seed(2)
    img = torch.randn(4, 3, 224, 224, generator=gen)
    mask = torch.zeros(4, 224, 224, dtype=torch.bool)
    mask[1, :, 150:] = True
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


def main() -> int:
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
    log("card", card)                                                      # phase 1

    t0 = time.perf_counter()
    dk.build()                                                             # phase 2
    log("build", json.dumps({"seconds": time.perf_counter() - t0}))

    checks = check_kernels(dev)                                            # phase 3

    state = random_state(served_config("bfloat16"))                        # phase 4
    params, launches = serve(dev, state, synthetic_tokenizer())
    throughput(dev, params, card)
    step_profile(dev, params)
    del params
    torch.cuda.empty_cache()

    f32_parity(dev, state)                                                 # phase 5

    entries = []                                                           # phase 6
    for name, replaces in KERNELS.items():
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was never launched on its serving path: {launches}")
        main_rec = checks[(name, "bfloat16", 32)]                          # the serving shape
        entries.append({
            "name": name, "route": "cuda", "source": "retr_tpu_torch/csrc/decoder_kernels.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": main_rec["max_abs_err"], "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "shape": "bf16, batch 32, step 63",
            "cases": [{k: r[k] for k in ("dtype", "batch", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "library_ms")}
                      for (n, _, _), r in checks.items() if n == name],
        })
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
