"""The port's serving slice as a whole, held against retr_tpu on the CPU.

- greedy token buffers equal retr_tpu.decode.greedy's in f32, post-EOS junk and
  the skipped final write included, with the stacked-kernel dispatch on and off;
- in bf16 storage, decode-step logits within a stated tolerance of retr_tpu's
  kernel path (Pallas in interpret mode): argmax near-ties of random weights
  flip under bf16, so tokens are not compared there;
- Predictor strings equal retr_tpu.predictor.Predictor's;
- the package imports without jax and without any retr_tpu module;
- an entry point asked for CUDA where there is none raises.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retr_tpu import decode as jdecode
from retr_tpu.config import Config as JaxConfig
from retr_tpu.data.tokenizer import prepare_tokenizer as jax_prepare_tokenizer
from retr_tpu.masking import Masked as JMasked
from retr_tpu.models import caption as jcaption
from retr_tpu.models import transformer as jtransformer
from retr_tpu.ops import decoder_kernels as dk
from retr_tpu.predictor import Predictor as JaxPredictor
from retr_tpu_torch import decode
from retr_tpu_torch.config import Config
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import caption, transformer, weights
from retr_tpu_torch.ops import decoder_kernels as tk
from retr_tpu_torch.predictor import Predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=2,
            dim_feedforward=128, vocab_size=96, max_position_embeddings=16, dropout=0.0, image_size=32)
BOS = 1


@pytest.fixture(scope="module")
def model():
    """Seeded tiny model and batch, the eos-free JAX buffer, and an EOS that rows
    reach at different steps (6 under seed 1: rows finish at 3, 3, 6, 8, 8, 8)."""
    jcfg, cfg = JaxConfig(**TINY), Config(**TINY)
    params, _ = jcaption.build_model(jcfg, jax.random.key(1))
    rng = np.random.default_rng(1)
    img = rng.standard_normal((6, 3, 32, 32)).astype(np.float32)
    mask = np.zeros((6, 32, 32), bool)
    mask[1, :, 20:] = True
    mask[2, 24:, :] = True
    samples = JMasked(jnp.asarray(img), jnp.asarray(mask))
    free = np.asarray(jdecode.greedy(params, jcfg, samples, max_len=16, bos_token=BOS, eos_token=-1))
    eos = 6
    ref = np.asarray(jdecode.greedy(params, jcfg, samples, max_len=16, bos_token=BOS, eos_token=eos))
    tp = weights.to_params(weights.from_jax_params(jax.tree.map(np.asarray, params), cfg), cfg, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, params=params, tp=tp, img=img, mask=mask, free=free, eos=eos, ref=ref)


@pytest.mark.parametrize("layer_grid", [True, False])
@pytest.mark.parametrize("check_every", [4, 16])
def test_greedy_tokens_equal_reference(model, layer_grid, check_every):
    ref, free, eos = model["ref"], model["free"], model["eos"]
    # the chosen EOS exercises junk after EOS, the skipped write and the stop
    first = [int(np.nonzero(row[1:] == eos)[0][0]) + 1 for row in free]
    assert min(first) < max(first) < 15
    assert (ref[:, max(first)] == 0).all() and (ref[:, max(first):] == 0).all()
    assert (ref[np.argmin(first), min(first) + 1:max(first)] != 0).all()

    old = tk.LAYER_GRID, decode.CHECK_EVERY
    tk.LAYER_GRID, decode.CHECK_EVERY = layer_grid, check_every
    try:
        got = decode.greedy(model["tp"], model["cfg"],
                            Masked(torch.from_numpy(model["img"]), torch.from_numpy(model["mask"])),
                            max_len=16, bos_token=BOS, eos_token=eos)
    finally:
        tk.LAYER_GRID, decode.CHECK_EVERY = old
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)

    free_got = decode.greedy(model["tp"], model["cfg"],
                             Masked(torch.from_numpy(model["img"]), torch.from_numpy(model["mask"])),
                             max_len=16, bos_token=BOS, eos_token=-1)
    np.testing.assert_array_equal(free_got.numpy(), free)


@pytest.mark.parametrize("layer_grid", [True, False])
def test_bf16_decode_step_logits_match_kernel_path(model, layer_grid):
    """bf16 storage: 5 teacher-forced steps of the port's decode step against
    retr_tpu's Pallas decode step (interpret mode, same dispatch). Tolerance
    0.05 on logits of magnitude ~1: both round at the same points; f32 summation
    order may flip single bf16 roundings that then propagate."""
    jcfg = model["jcfg"].replace(use_pallas_decode=True)
    cfg = model["cfg"]
    b, s, t = 8, 7, 10
    rng = np.random.default_rng(2)
    memory = rng.standard_normal((b, s, 64)).astype(np.float32)
    mem_mask = np.zeros((b, s), bool)
    mem_mask[:, -2:] = True
    pos = rng.standard_normal((s, 64)).astype(np.float32)
    tokens = rng.integers(0, 96, (b, t)).astype(np.int32)

    jp, jmem, jpos = jdecode._cast_for_decode(model["params"], jnp.asarray(memory), jnp.asarray(pos), jnp.bfloat16)
    old_grid, old_int = dk.LAYER_GRID, dk.FORCE_INTERPRET
    dk.LAYER_GRID, dk.FORCE_INTERPRET = layer_grid, True
    try:
        cache, cross = jtransformer.init_decode_state(jp["transformer"], jmem, jnp.asarray(mem_mask), jpos, jcfg, t)
        ref = []
        for i in range(5):
            hs, cache = jtransformer.decode_step(jp["transformer"], cache, cross, jnp.asarray(tokens[:, i]),
                                                 jnp.int32(i), jcfg)
            ref.append(np.asarray(jcaption.mlp_head(jp["mlp"], hs).astype(jnp.float32)))
    finally:
        dk.LAYER_GRID, dk.FORCE_INTERPRET = old_grid, old_int

    tp, tmem, tpos = decode._cast_for_decode(model["tp"], torch.from_numpy(memory), torch.from_numpy(pos),
                                             torch.bfloat16)
    tparams = transformer.prepare_decoder(tp["transformer"])
    old = tk.LAYER_GRID
    tk.LAYER_GRID = layer_grid
    try:
        cache, cross = transformer.init_decode_state(tparams, tmem, torch.from_numpy(mem_mask), tpos, cfg, t)
        assert cache.self_k.dtype == cross.cross_k.dtype == torch.bfloat16
        step = torch.zeros((), dtype=torch.int32)
        for i in range(5):
            hs, cache = transformer.decode_step(tparams, cache, cross, torch.from_numpy(tokens[:, i]), step, cfg)
            got = caption.mlp_head(tp["mlp"], hs).float().numpy()
            np.testing.assert_allclose(got, ref[i], atol=0.05, rtol=0, err_msg=f"step {i}")
            step += 1
    finally:
        tk.LAYER_GRID = old


@pytest.mark.parametrize("use_global,use_location", [(False, False), (True, True)])
def test_predictor_strings_equal_reference(use_global, use_location):
    cfg_kw = dict(TINY, max_position_embeddings=12, image_size=64, use_global_features=use_global,
                  use_location_features=use_location)
    jtok, _, _ = jax_prepare_tokenizer()
    tok, _, _ = prepare_tokenizer()
    assert tok.vocab == jtok.vocab
    jcfg = JaxConfig(**{**cfg_kw, "vocab_size": jtok.vocab_size})
    cfg = Config(**{**cfg_kw, "vocab_size": tok.vocab_size})
    params, _ = jcaption.build_model(jcfg, jax.random.key(0))
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (60 + 10 * i, 80, 3), dtype=np.uint8) for i in range(3)]
    boxes = [[5, 5, 30 + i, 25] for i in range(3)]
    want = JaxPredictor(params, jcfg, jtok, max_batch=2).predict_batch(imgs, boxes)
    sd = weights.from_jax_params(jax.tree.map(np.asarray, params), cfg)
    pred = Predictor(sd, cfg, tok, max_batch=2, device="cpu")
    assert pred.predict_batch(imgs, boxes) == want
    assert pred.predict(imgs[1], boxes[1]) == want[1]


def test_entry_point_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(**TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor({}, cfg, prepare_tokenizer()[0])


def test_package_imports_without_jax_or_retr_tpu():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import retr_tpu_torch\n"
        "for m in pkgutil.walk_packages(retr_tpu_torch.__path__, 'retr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'retr_tpu' or m.startswith('retr_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'retr_tpu_torch.predictor' in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_prune_token_ids_matches_reference():
    seqs = [[101, 5, 6, 102, 7, 0], [101, 0, 9, 9], [101, 102]]
    for clean in (True, False):
        assert decode.prune_token_ids(seqs, clean=clean) == jdecode.prune_token_ids(seqs, clean=clean)
