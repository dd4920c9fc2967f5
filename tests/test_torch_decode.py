"""The port's serving slice as a whole, held against retr_tpu on the CPU.

- greedy token buffers equal retr_tpu.decode.greedy's in f32, post-EOS junk and
  the skipped final write included, with the stacked-kernel dispatch on and off;
- in bf16 storage, decode-step logits within a stated tolerance of retr_tpu's
  kernel path (Pallas in interpret mode) and of its default XLA path: argmax
  near-ties of random weights flip under bf16, so tokens are not compared there;
- the decode steps call the kernel wrappers only at the widths the kernels take;
- ``sample`` where it reduces to argmax equals retr_tpu's greedy and sample
  buffers, its draws on fixed logits match retr_tpu.decode.sample's in
  distribution, and a seed gives the same buffer twice;
- ``greedy_with_prefix`` buffers equal retr_tpu's, mixed prefix lengths and a
  forced EOS included;
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
    tp = weights.to_params(weights.to_state_dict(jax.tree.map(np.asarray, params), cfg), cfg, device="cpu")
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


def _bf16_step_inputs():
    """Encoder memory, mask, positions and teacher-forced tokens for 5 decode
    steps at batch 8, from a seeded rng."""
    rng = np.random.default_rng(2)
    memory = rng.standard_normal((8, 7, 64)).astype(np.float32)
    mem_mask = np.zeros((8, 7), bool)
    mem_mask[:, -2:] = True
    pos = rng.standard_normal((7, 64)).astype(np.float32)
    tokens = rng.integers(0, 96, (8, 10)).astype(np.int32)
    return memory, mem_mask, pos, tokens


def _jax_bf16_step_logits(model, jcfg, layer_grid, interpret):
    """retr_tpu's bf16 decode step, 5 teacher-forced steps: f32 logits."""
    memory, mem_mask, pos, tokens = _bf16_step_inputs()
    jp, jmem, jpos = jdecode._cast_for_decode(model["params"], jnp.asarray(memory), jnp.asarray(pos), jnp.bfloat16)
    old_grid, old_int = dk.LAYER_GRID, dk.FORCE_INTERPRET
    dk.LAYER_GRID, dk.FORCE_INTERPRET = layer_grid, interpret
    try:
        cache, cross = jtransformer.init_decode_state(jp["transformer"], jmem, jnp.asarray(mem_mask), jpos, jcfg,
                                                      tokens.shape[1])
        ref = []
        for i in range(5):
            hs, cache = jtransformer.decode_step(jp["transformer"], cache, cross, jnp.asarray(tokens[:, i]),
                                                 jnp.int32(i), jcfg)
            ref.append(np.asarray(jcaption.mlp_head(jp["mlp"], hs).astype(jnp.float32)))
    finally:
        dk.LAYER_GRID, dk.FORCE_INTERPRET = old_grid, old_int
    return ref


def _port_bf16_step_logits(model, layer_grid):
    """The port's bf16 decode step on the same inputs: f32 logits."""
    memory, mem_mask, pos, tokens = _bf16_step_inputs()
    cfg = model["cfg"]
    tp, tmem, tpos = decode._cast_for_decode(model["tp"], torch.from_numpy(memory), torch.from_numpy(pos),
                                             torch.bfloat16)
    tparams = transformer.prepare_decoder(tp["transformer"])
    old = tk.LAYER_GRID
    tk.LAYER_GRID = layer_grid
    try:
        cache, cross = transformer.init_decode_state(tparams, tmem, torch.from_numpy(mem_mask), tpos, cfg,
                                                     tokens.shape[1])
        assert cache.self_k.dtype == cross.cross_k.dtype == torch.bfloat16
        step = torch.zeros((), dtype=torch.int32)
        got = []
        for i in range(5):
            hs, cache = transformer.decode_step(tparams, cache, cross, torch.from_numpy(tokens[:, i]), step, cfg)
            got.append(caption.mlp_head(tp["mlp"], hs).float().numpy())
            step += 1
    finally:
        tk.LAYER_GRID = old
    return got


@pytest.mark.parametrize("layer_grid", [True, False])
def test_bf16_decode_step_logits_match_kernel_path(model, layer_grid):
    """bf16 storage: 5 teacher-forced steps of the port's decode step against
    retr_tpu's Pallas decode step (interpret mode, same dispatch). Tolerance
    0.05 on logits of magnitude ~1: both round at the same points; f32 summation
    order may flip single bf16 roundings that then propagate."""
    ref = _jax_bf16_step_logits(model, model["jcfg"].replace(use_pallas_decode=True), layer_grid, True)
    for i, got in enumerate(_port_bf16_step_logits(model, layer_grid)):
        np.testing.assert_allclose(got, ref[i], atol=0.05, rtol=0, err_msg=f"step {i}")


@pytest.mark.parametrize("layer_grid", [True, False])
def test_bf16_decode_step_logits_match_xla_path(model, layer_grid):
    """bf16 storage: the same 5 steps against retr_tpu's default decode step,
    the XLA path (``use_pallas_decode=False``, a knob the port does not read: it
    always computes the kernels' arithmetic). XLA rounds each product's output
    to bf16 where the kernels keep f32 (the stacked step's residual, q/k/v
    before the cache write). Measured on this config: at most 0.0039 on logits
    of magnitude <= 0.36 (one to two bf16 ulps), the same as against the
    Pallas trio; tolerance 2**-7."""
    assert not model["jcfg"].use_pallas_decode
    ref = _jax_bf16_step_logits(model, model["jcfg"], layer_grid, False)
    for i, got in enumerate(_port_bf16_step_logits(model, layer_grid)):
        np.testing.assert_allclose(got, ref[i], atol=2 ** -7, rtol=0, err_msg=f"step {i}")


WRAPPERS = ("fused_stack_step", "fused_layer_step", "self_attn_block", "cross_attn_block", "ff_block",
            "self_attn_block_beam", "mlp_head_argmax", "mlp_head_topk")


def _spy_wrappers(monkeypatch):
    """Record which kernel wrappers of ops/decoder_kernels a run calls (each
    still runs: on the CPU it takes its plain version)."""
    called = set()
    for name in WRAPPERS:
        fn = getattr(tk, name)

        def spy(*a, _name=name, _fn=fn, **kw):
            called.add(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(tk, name, spy)
    return called


@pytest.mark.parametrize("width,heads,ff,layers", [(64, 4, 128, {"fused_stack_step", "self_attn_block_beam",
                                                                 "cross_attn_block", "ff_block"}),
                                                   (256, 8, 256, {"fused_stack_step", "self_attn_block_beam",
                                                                  "cross_attn_block", "ff_block"})])
def test_decode_calls_the_kernels_only_where_the_rule_allows(monkeypatch, width, heads, ff, layers):
    """Greedy (HEAD_KERNEL on) and beam 3 (BEAM_TOPK_KERNEL on) decode: the
    steps call the kernel wrappers at every width, the tuned width
    (decode_kernels_fit) and any other; the rule is the wrappers' own, which
    choose between the tuned and the any-width CUDA kernels on the card."""
    cfg = Config(**{**TINY, "hidden_dim": width, "nheads": heads, "dim_feedforward": ff, "dec_layers": 1})
    torch.manual_seed(0)
    params = weights.to_params(weights.reference_module(cfg).state_dict(), cfg, device="cpu")
    rng = np.random.default_rng(3)
    samples = Masked(torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32)),
                     torch.zeros(2, 32, 32, dtype=torch.bool))
    called = _spy_wrappers(monkeypatch)
    monkeypatch.setattr(tk, "HEAD_KERNEL", True)
    monkeypatch.setattr(tk, "BEAM_TOPK_KERNEL", True)
    decode.greedy(params, cfg, samples, max_len=6, bos_token=BOS, eos_token=-1)
    decode.beam_search(params, cfg, samples, max_len=6, bos_token=BOS, eos_token=-1, beam_size=3)
    assert called == layers | {"mlp_head_argmax", "mlp_head_topk"}


def _samples(model):
    return (Masked(torch.from_numpy(model["img"]), torch.from_numpy(model["mask"])),
            JMasked(jnp.asarray(model["img"]), jnp.asarray(model["mask"])))


@pytest.mark.parametrize("temperature,top_k,top_p", [(0.0, 0, 1.0), (1.0, 1, 1.0), (1.0, 0, 1e-9),
                                                     (0.7, 8, 1e-9)])
def test_sample_reducing_to_argmax_equals_reference(model, temperature, top_k, top_p):
    """Temperature 0 and top_k 1 are argmax by rule; top_p 1e-9 keeps only the
    largest logit, alone or after a top-8 shortlist. The buffers must equal
    retr_tpu.decode.greedy's and retr_tpu.decode.sample's exactly."""
    samples, jsamples = _samples(model)
    kw = dict(max_len=16, bos_token=BOS, eos_token=model["eos"], temperature=temperature, top_k=top_k,
              top_p=top_p)
    want = np.asarray(jdecode.sample(model["params"], model["jcfg"], jsamples, jax.random.key(3), **kw))
    np.testing.assert_array_equal(want, model["ref"])
    got = decode.sample(model["tp"], model["cfg"], samples, torch.Generator().manual_seed(3), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_is_deterministic_per_seed(model):
    samples, _ = _samples(model)
    kw = dict(max_len=16, bos_token=BOS, eos_token=-1, temperature=1.0, top_k=8, top_p=0.9)
    runs = [decode.sample(model["tp"], model["cfg"], samples, torch.Generator().manual_seed(s), **kw)
            for s in (11, 11, 12)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


# fixed logits for the distribution test: no cumulative mass near the cuts
FIXED_LOGITS = np.array([0.3, 2.0, -1.0, 1.2, 0.8, -2.0, 1.5, 0.0, -0.5, 1.0, -1.5, 0.5], np.float32)


def _kept_probs(logits, temperature, top_k, top_p):
    """The renormalized distribution the filters leave, in float64 from the rules
    of retr_tpu.decode.sample: the top-k shortlist, then the smallest prefix
    whose mass reaches top_p (at least one token)."""
    z = logits.astype(np.float64) / temperature
    order = np.argsort(-z, kind="stable")
    if 0 < top_k < len(z):
        order = order[:top_k]
    p = np.exp(z[order] - z[order].max())
    p /= p.sum()
    keep = np.concatenate([[True], np.cumsum(p)[:-1] < top_p])
    out = np.zeros(len(z))
    out[order[keep]] = p[keep] / p[keep].sum()
    return out


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.8, 4, 1.0), (1.0, 0, 0.7),
                                                     (0.8, 4, 0.7)])
def test_sample_draws_match_reference_in_distribution(temperature, top_k, top_p):
    """20000 draws on fixed logits (vocab 12). retr_tpu's draws come from its
    sample loop on a model whose head gives these logits at every step (zero
    last-layer weights, the logits as its bias: 400 rows x 50 steps); the port's
    from ``sample_tokens``, the port's step, on 20000 rows. Every draw of each
    package lies in the set retr_tpu drew from, and each token's frequency is
    within 0.015 of its renormalized probability."""
    want = _kept_probs(FIXED_LOGITS, temperature, top_k, top_p)
    jcfg = JaxConfig(**{**TINY, "vocab_size": 12, "max_position_embeddings": 51})
    params, _ = jcaption.build_model(jcfg, jax.random.key(0))
    last = params["mlp"]["layers"][-1]
    params["mlp"]["layers"][-1] = {"w": jnp.zeros_like(last["w"]), "b": jnp.asarray(FIXED_LOGITS)}
    rng = np.random.default_rng(4)
    jsamples = JMasked(jnp.asarray(rng.standard_normal((400, 3, 32, 32)).astype(np.float32)),
                       jnp.zeros((400, 32, 32), bool))
    jdraws = np.asarray(jdecode.sample(params, jcfg, jsamples, jax.random.key(5), max_len=51, bos_token=BOS,
                                       eos_token=-1, temperature=temperature, top_k=top_k, top_p=top_p))[:, 1:]
    logits = torch.from_numpy(np.tile(FIXED_LOGITS, (20000, 1)))
    got = decode.sample_tokens(logits, torch.Generator().manual_seed(5), temperature=temperature, top_k=top_k,
                               top_p=top_p).numpy()
    jax_set = set(np.unique(jdraws).tolist())
    assert jax_set == set(np.nonzero(want)[0].tolist())
    assert set(np.unique(got).tolist()) <= jax_set
    for draws in (got, jdraws.reshape(-1)):
        assert draws.size == 20000
        freq = np.bincount(draws, minlength=12) / draws.size
        np.testing.assert_allclose(freq, want, atol=0.015, rtol=0)


def test_greedy_with_prefix_equals_reference(model):
    """Prefix lengths 0 to 5 over six rows, one prefix holding the EOS (it
    finishes that row); all-zero lengths are exactly greedy."""
    samples, jsamples = _samples(model)
    eos = model["eos"]
    rng = np.random.default_rng(6)
    prefix = rng.integers(7, 96, (6, 5)).astype(np.int32)
    prefix[3, 2] = eos
    lens = np.array([0, 2, 5, 3, 1, 4], np.int32)
    kw = dict(max_len=16, bos_token=BOS, eos_token=eos)
    got = {}
    for name, pl in (("mixed", lens), ("none", np.zeros(6, np.int32))):
        want = np.asarray(jdecode.greedy_with_prefix(model["params"], model["jcfg"], jsamples, jnp.asarray(prefix),
                                                     jnp.asarray(pl), **kw))
        got[name] = decode.greedy_with_prefix(model["tp"], model["cfg"], samples, torch.from_numpy(prefix),
                                              torch.from_numpy(pl), **kw).numpy()
        np.testing.assert_array_equal(got[name], want)
    np.testing.assert_array_equal(got["none"], model["ref"])
    for r in range(6):
        np.testing.assert_array_equal(got["mixed"][r, 1:lens[r] + 1], prefix[r, :lens[r]])
    assert (got["mixed"][3, 4:] == 0).all() or got["mixed"][3, 3] == eos   # the forced EOS finished row 3


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
    sd = weights.to_state_dict(jax.tree.map(np.asarray, params), cfg)
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
        "for m in ('predictor', 'serve', 'native', 'train.checkpoints', 'engine', 'metrics.nlg',\n"
        "          'metrics.meteor', 'data.annotations', 'data.dataset', 'utils.logging', 'utils.profiling'):\n"
        "    assert 'retr_tpu_torch.' + m in sys.modules, m\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_prune_token_ids_matches_reference():
    seqs = [[101, 5, 6, 102, 7, 0], [101, 0, 9, 9], [101, 102]]
    for clean in (True, False):
        assert decode.prune_token_ids(seqs, clean=clean) == jdecode.prune_token_ids(seqs, clean=clean)
