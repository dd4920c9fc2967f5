"""The port's beam-search slice and the flag-gated greedy paths, held against
retr_tpu on the CPU (the kernels' plain versions run here).

- decode_step_beam hidden states and caches against
  retr_tpu.models.transformer.decode_step_beam (XLA path), with an ancestry
  that crosses rows of each beam group;
- beam_search token buffers equal retr_tpu.decode.beam_search's in f32 and
  normalised scores within 1e-5, for beams 2 and 3, early_stop on and off,
  length penalty 1.0 and 0.7; the host-check interval does not change them;
- BEAM_TOPK_KERNEL on gives the flag-off tokens and scores (the head itself is
  held against the Pallas kernel in test_torch_kernels.py);
- greedy with HEAD_KERNEL on, and with MERGED_LAYER on (LAYER_GRID off), equal
  to retr_tpu.decode.greedy in f32;
- Predictor(beam=True) strings equal retr_tpu's Predictor's.
"""

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
from retr_tpu.predictor import Predictor as JaxPredictor
from retr_tpu_torch import decode
from retr_tpu_torch.config import Config
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import transformer, weights
from retr_tpu_torch.ops import decoder_kernels as tk
from retr_tpu_torch.predictor import Predictor

TINY = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=2,
            dim_feedforward=128, vocab_size=96, max_position_embeddings=16, dropout=0.0, image_size=32)
BOS = 1
# Under seed 1 some beams end with EOS 56 and others do not, and with length
# penalty 0.7 early_stop changes the buffers for beams 2 and 3.
EOS = 56


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JaxConfig(**TINY), Config(**TINY)
    params, _ = jcaption.build_model(jcfg, jax.random.key(1))
    rng = np.random.default_rng(1)
    img = rng.standard_normal((3, 3, 32, 32)).astype(np.float32)
    mask = np.zeros((3, 32, 32), bool)
    mask[1, :, 20:] = True
    tp = weights.to_params(weights.to_state_dict(jax.tree.map(np.asarray, params), cfg), cfg, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, params=params, tp=tp, img=img, mask=mask)


def _port_beam(model, **kw):
    return decode.beam_search(model["tp"], model["cfg"],
                              Masked(torch.from_numpy(model["img"]), torch.from_numpy(model["mask"])),
                              max_len=16, bos_token=BOS, eos_token=EOS, **kw)


def _jax_beam(model, **kw):
    t, s = jdecode.beam_search(model["params"], model["jcfg"],
                               JMasked(jnp.asarray(model["img"]), jnp.asarray(model["mask"])),
                               max_len=16, bos_token=BOS, eos_token=EOS, **kw)
    return np.asarray(t), np.asarray(s)


@pytest.mark.parametrize("beam_size", [2, 3])
@pytest.mark.parametrize("early_stop", [True, False])
def test_beam_search_equals_reference(model, beam_size, early_stop):
    for length_penalty in (1.0, 0.7):
        kw = dict(beam_size=beam_size, length_penalty=length_penalty, early_stop=early_stop)
        want_t, want_s = _jax_beam(model, **kw)
        got_t, got_s = _port_beam(model, **kw)
        assert got_t.dtype == torch.int32 and tuple(got_t.shape) == (3, beam_size, 16)
        np.testing.assert_array_equal(got_t.numpy(), want_t)
        np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-5, rtol=0)
        finished = (want_t == EOS).any(-1)
        assert finished.any() and not finished.all()


@pytest.mark.parametrize("beam_size", [2, 3])
def test_early_stop_changes_the_search_as_in_reference(model, beam_size):
    """The seeded case stops early and ends with other buffers than the
    exhaustive run: the device-side stop gate is exercised, and its steps after
    the stop (until the next host check) change nothing."""
    on = _port_beam(model, beam_size=beam_size, length_penalty=0.7, early_stop=True)[0]
    off = _port_beam(model, beam_size=beam_size, length_penalty=0.7, early_stop=False)[0]
    assert not torch.equal(on, off)
    old = decode.CHECK_EVERY
    try:
        for every in (4, 16):
            decode.CHECK_EVERY = every
            assert torch.equal(_port_beam(model, beam_size=beam_size, length_penalty=0.7)[0], on)
    finally:
        decode.CHECK_EVERY = old


def test_beam_topk_kernel_flag_keeps_tokens_and_scores(model):
    want_t, want_s = _port_beam(model, beam_size=3, length_penalty=0.7)
    old = tk.BEAM_TOPK_KERNEL
    tk.BEAM_TOPK_KERNEL = True
    try:
        got_t, got_s = _port_beam(model, beam_size=3, length_penalty=0.7)
    finally:
        tk.BEAM_TOPK_KERNEL = old
    assert torch.equal(got_t, want_t)
    torch.testing.assert_close(got_s, want_s, atol=1e-5, rtol=0)


def test_decode_step_beam_matches_reference(model):
    """Four beam steps against retr_tpu's XLA beam step; the ancestry of each
    step crosses rows inside every group of 3."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    b, k, s, t = 2, 3, 7, 10
    rng = np.random.default_rng(4)
    memory = rng.standard_normal((b * k, s, 64)).astype(np.float32)
    mem_mask = np.zeros((b * k, s), bool)
    mem_mask[:, -2:] = True
    pos = rng.standard_normal((s, 64)).astype(np.float32)
    tokens = rng.integers(0, 96, (b * k, t)).astype(np.int32)
    anc = rng.integers(0, k, (b, k, t)).astype(np.int32)

    jp = model["params"]["transformer"]
    cache, cross = jtransformer.init_decode_state(jp, jnp.asarray(memory), jnp.asarray(mem_mask),
                                                  jnp.asarray(pos), jcfg, t, allow_layer_grid=False)
    tparams = transformer.prepare_decoder(model["tp"]["transformer"])
    tcache, tcross = transformer.init_decode_state(tparams, torch.from_numpy(memory),
                                                   torch.from_numpy(mem_mask), torch.from_numpy(pos), cfg, t)
    step = torch.zeros((), dtype=torch.int32)
    for i in range(4):
        a = anc.copy()
        a[:, :, i] = np.arange(k)
        hs, cache = jtransformer.decode_step_beam(jp, cache, cross, jnp.asarray(tokens[:, i]), jnp.int32(i),
                                                  jcfg, jnp.asarray(a), k)
        got, tcache = transformer.decode_step_beam(tparams, tcache, tcross, torch.from_numpy(tokens[:, i]),
                                                   step, cfg, torch.from_numpy(a), k)
        np.testing.assert_allclose(got.numpy(), np.asarray(hs), atol=3e-5, rtol=0, err_msg=f"step {i}")
        step += 1
    for li in range(2):
        np.testing.assert_allclose(tcache.self_k[li].numpy(), np.asarray(cache.self_k[li]), atol=3e-5, rtol=0)
        np.testing.assert_allclose(tcache.self_v[li].numpy(), np.asarray(cache.self_v[li]), atol=3e-5, rtol=0)


@pytest.mark.parametrize("flags", [dict(HEAD_KERNEL=True), dict(LAYER_GRID=False, MERGED_LAYER=True)])
def test_greedy_flag_paths_equal_reference(model, flags):
    want = np.asarray(jdecode.greedy(model["params"], model["jcfg"],
                                     JMasked(jnp.asarray(model["img"]), jnp.asarray(model["mask"])),
                                     max_len=16, bos_token=BOS, eos_token=6))
    old = {name: getattr(tk, name) for name in flags}
    for name, value in flags.items():
        setattr(tk, name, value)
    try:
        got = decode.greedy(model["tp"], model["cfg"],
                            Masked(torch.from_numpy(model["img"]), torch.from_numpy(model["mask"])),
                            max_len=16, bos_token=BOS, eos_token=6)
    finally:
        for name, value in old.items():
            setattr(tk, name, value)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_global,use_location", [(False, False), (True, True)])
def test_beam_predictor_strings_equal_reference(use_global, use_location):
    cfg_kw = dict(TINY, max_position_embeddings=12, image_size=64, use_global_features=use_global,
                  use_location_features=use_location, beam_size=3)
    jtok, _, _ = jax_prepare_tokenizer()
    tok, _, _ = prepare_tokenizer()
    jcfg = JaxConfig(**{**cfg_kw, "vocab_size": jtok.vocab_size})
    cfg = Config(**{**cfg_kw, "vocab_size": tok.vocab_size})
    params, _ = jcaption.build_model(jcfg, jax.random.key(0))
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (60 + 10 * i, 80, 3), dtype=np.uint8) for i in range(3)]
    boxes = [[5, 5, 30 + i, 25] for i in range(3)]
    want = JaxPredictor(params, jcfg, jtok, max_batch=2).predict_batch(imgs, boxes, beam=True)
    pred = Predictor(weights.to_state_dict(jax.tree.map(np.asarray, params), cfg), cfg, tok,
                     max_batch=2, device="cpu")
    assert pred.predict_batch(imgs, boxes, decoder="beam") == want
    assert pred.predict(imgs[2], boxes[2], beam=True) == want[2]
    assert isinstance(pred.predict(imgs[0], boxes[0], decoder="sample"), str)   # ported: no longer raises
    with pytest.raises(ValueError, match="unknown decoder"):
        pred.predict(imgs[0], boxes[0], decoder="nope")
