"""The decode loop as chunks over in-place carries, the decode tree kept across
calls and the graph sessions' keys, on the CPU (the graphs themselves are
held against the eager loop on the card, tests/test_torch_cuda.py).

- the chunked loops against retr_tpu.decode.greedy, greedy_with_prefix and
  beam_search, with chunks of 16, 8, 7, 5, 4 and 3 steps: ``max_len`` not a
  multiple of 16, every row finished inside the first chunk, a stop exactly
  at a chunk boundary and one step past it, beam's early stop;
- a step reads only cache slots written earlier in the same call: caches
  that start full of garbage give the same buffers;
- the decode tree is one object across two calls, is rebuilt after an
  in-place update of one weight (an AdamW step too), and the decode then
  follows the new weight; a new params object gets a tree of its own;
- each flag, shape and tree a capture reads changes the session key;
- a returned buffer is not the next call's, and a CPU decode makes no session.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retr_tpu import decode as jdecode
from retr_tpu.config import Config as JaxConfig
from retr_tpu.masking import Masked as JMasked
from retr_tpu.models import caption as jcaption
from retr_tpu_torch import decode
from retr_tpu_torch.config import Config
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import transformer, weights
from retr_tpu_torch.ops import decoder_kernels as tk
from retr_tpu_torch.ops import graphs

TINY = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=2,
            dim_feedforward=128, vocab_size=96, max_position_embeddings=21, dropout=0.0, image_size=32)
BOS = 1
EOS = 6      # under seed 1 the six rows finish at slots 6, 8, 8, 8, 3 and 3
BEAM_EOS = 56


@pytest.fixture(scope="module")
def model():
    """A seeded tiny model, the six images of tests/test_torch_decode.py, and
    retr_tpu's buffers: greedy to max_len 16 with EOS 6 and to max_len 21 with
    no EOS, prefix completion, beam 3 with early stop."""
    jcfg, cfg = JaxConfig(**TINY), Config(**TINY)
    params = jax.jit(lambda k: jcaption.build_model(jcfg, k)[0])(jax.random.key(1))   # jit: 2x faster than eager
    rng = np.random.default_rng(1)
    img = rng.standard_normal((6, 3, 32, 32)).astype(np.float32)
    mask = np.zeros((6, 32, 32), bool)
    mask[1, :, 20:] = True
    mask[2, 24:, :] = True
    js = JMasked(jnp.asarray(img), jnp.asarray(mask))
    prefix = rng.integers(7, 96, (6, 5)).astype(np.int32)
    prefix[3, 2] = EOS
    lens = np.array([0, 2, 5, 3, 1, 4], np.int32)
    ref = {
        "eos": np.asarray(jdecode.greedy(params, jcfg, js, max_len=16, bos_token=BOS, eos_token=EOS)),
        "long": np.asarray(jdecode.greedy(params, jcfg, js, max_len=21, bos_token=BOS, eos_token=-1)),
        "prefix": np.asarray(jdecode.greedy_with_prefix(params, jcfg, js, jnp.asarray(prefix), jnp.asarray(lens),
                                                        max_len=16, bos_token=BOS, eos_token=EOS)),
        "beam": [np.asarray(a) for a in jdecode.beam_search(params, jcfg, JMasked(js.tensors[:3], js.mask[:3]),
                                                            max_len=16, bos_token=BOS, eos_token=BEAM_EOS,
                                                            beam_size=3, length_penalty=0.7, early_stop=True)],
    }
    tp = weights.to_params(weights.to_state_dict(jax.tree.map(np.asarray, params), cfg), cfg, device="cpu")
    return dict(cfg=cfg, tp=tp, samples=Masked(torch.from_numpy(img), torch.from_numpy(mask)),
                prefix=torch.from_numpy(prefix), lens=torch.from_numpy(lens), ref=ref)


@pytest.fixture
def check_every():
    old = decode.CHECK_EVERY
    yield lambda n: setattr(decode, "CHECK_EVERY", n)
    decode.CHECK_EVERY = old


@pytest.mark.parametrize("every", [16, 8, 7, 3])
def test_greedy_chunks_equal_reference_whatever_the_stop(model, check_every, every):
    """EOS 6 at max_len 16: with chunks of 16 every row finishes inside the
    first; of 8 the last rows finish on the chunk's last step (slot 8), so
    the host check at step 8 stops the loop; of 7 one step past a boundary."""
    first = [int(np.nonzero(row[1:] == EOS)[0][0]) + 1 for row in model["ref"]["long"]]
    assert max(first) == 8
    check_every(every)
    got = decode.greedy(model["tp"], model["cfg"], model["samples"], max_len=16, bos_token=BOS, eos_token=EOS)
    np.testing.assert_array_equal(got.numpy(), model["ref"]["eos"])


@pytest.mark.parametrize("every", [16, 5])
def test_greedy_chunks_equal_reference_past_a_multiple_of_the_chunk(model, check_every, every):
    """max_len 21, no EOS: 20 steps, chunks 0-15 and 16-19 (or four of 5)."""
    check_every(every)
    got = decode.greedy(model["tp"], model["cfg"], model["samples"], max_len=21, bos_token=BOS, eos_token=-1)
    np.testing.assert_array_equal(got.numpy(), model["ref"]["long"])


@pytest.mark.parametrize("every", [16, 4])
def test_prefix_chunks_equal_reference(model, check_every, every):
    check_every(every)
    got = decode.greedy_with_prefix(model["tp"], model["cfg"], model["samples"], model["prefix"], model["lens"],
                                    max_len=16, bos_token=BOS, eos_token=EOS)
    np.testing.assert_array_equal(got.numpy(), model["ref"]["prefix"])


@pytest.mark.parametrize("every", [16, 4])
def test_beam_chunks_equal_reference_with_early_stop(model, check_every, every, monkeypatch):
    """Beam 3, length penalty 0.7, early stop: the JAX loop stops within its
    first 4 steps; the port's loop stops at the next host check, after the
    first chunk (15 steps at max_len 16 in chunks of 16, 4 in chunks of 4)."""
    steps = []
    real = transformer.decode_step_beam
    monkeypatch.setattr(transformer, "decode_step_beam", lambda *a, **k: steps.append(1) or real(*a, **k))
    check_every(every)
    samples = Masked(model["samples"].tensors[:3], model["samples"].mask[:3])
    t, s = decode.beam_search(model["tp"], model["cfg"], samples, max_len=16, bos_token=BOS, eos_token=BEAM_EOS,
                              beam_size=3, length_penalty=0.7, early_stop=True)
    want_t, want_s = model["ref"]["beam"]
    np.testing.assert_array_equal(t.numpy(), want_t)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=0, atol=1e-5)
    assert len(steps) == {16: 15, 4: 4}[every]


def _garbage_caches(loop, seed):
    g = torch.Generator().manual_seed(seed)
    for c in loop.cache:
        c.copy_(torch.randn(c.shape, generator=g) * 1e3)


@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_steps_read_only_slots_written_in_the_same_call(model, kind):
    """A session's caches hold the last call's values when the next starts,
    and they are never cleared: the loops started on caches full of
    garbage give the buffers of zeroed caches, bit for bit."""
    cfg, tp = model["cfg"], model["tp"]
    memory, mask, pos = decode.caption.encode(tp, cfg, model["samples"])
    tparams = decode._decoder_tree(tp["transformer"])
    out = []
    for garbage in (False, True):
        if kind == "greedy":
            loop = decode._TokenLoop(decode._RetrDecoder(tp, cfg), lambda lp, i, hs: lp.decoder.argmax(hs), rows=6,
                                     mem_len=memory.shape[1], max_len=21, eos_token=-1, dtype=memory.dtype,
                                     device=memory.device)
        else:
            loop = decode._BeamLoop(tparams, tp["mlp"], None, cfg, rows=6, beams=3, mem_len=memory.shape[1],
                                    max_len=21, eos_token=BEAM_EOS, length_penalty=0.7, early_stop=False,
                                    dtype=memory.dtype, device=memory.device)
        if garbage:
            _garbage_caches(loop, 3)
        loop.start(memory, mask, pos, BOS)
        decode._drive(loop, 21)
        out.append(loop.result(owned=False))
    if kind == "greedy":
        assert torch.equal(out[0], out[1])
    else:
        assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def _fresh_decode(params, cfg, samples, dtype):
    """A decode on a deep copy of ``params``: a tree no earlier call built."""
    return decode.greedy(copy.deepcopy(params), cfg, samples, max_len=16, bos_token=BOS, eos_token=-1,
                         compute_dtype=dtype)


def test_decode_tree_is_kept_across_calls(model):
    tp = model["tp"]
    kw = dict(max_len=16, bos_token=BOS, eos_token=-1)
    a = decode.greedy(tp, model["cfg"], model["samples"], **kw)
    tree = decode._decoder_tree(tp["transformer"])
    cast = decode._cast_for_decode(tp, torch.zeros(1), torch.zeros(1), torch.bfloat16)[0]
    b = decode.greedy(tp, model["cfg"], model["samples"], **kw)
    assert decode._decoder_tree(tp["transformer"]) is tree
    again = decode._cast_for_decode(tp, torch.zeros(1), torch.zeros(1), torch.bfloat16)[0]
    assert again["transformer"] is cast["transformer"] and again["mlp"] is cast["mlp"]
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("update", ["add_", "adamw"])
def test_decode_tree_is_rebuilt_after_an_in_place_update(model, dtype, update):
    """One decoder weight updated in place (as checkpoint loads do, or by an
    AdamW step as the trainer's): the next decode builds a new tree and
    follows the new weight, as a decode on a copy made after the update."""
    cfg = model["cfg"]
    tp = copy.deepcopy(model["tp"])
    kw = dict(max_len=16, bos_token=BOS, eos_token=-1, compute_dtype=dtype)
    before = decode.greedy(tp, cfg, model["samples"], **kw)
    src = tp["transformer"] if dtype == torch.float32 else decode._cast(tp["transformer"], dtype)
    tree = decode._decoder_tree(src)
    w = tp["transformer"]["decoder"]["layers"][1]["ff"]["lin2"]["w"]
    version = w._version
    if update == "add_":
        with torch.no_grad():
            w.add_(torch.randn(w.shape, generator=torch.Generator().manual_seed(0)))
    else:
        w.requires_grad_(True)
        w.grad = torch.randn(w.shape, generator=torch.Generator().manual_seed(0))
        torch.optim.AdamW([w], lr=0.5).step()
        w.requires_grad_(False)
        w.grad = None
    assert w._version > version
    after = decode.greedy(tp, cfg, model["samples"], **kw)
    src = tp["transformer"] if dtype == torch.float32 else decode._cast(tp["transformer"], dtype)
    assert decode._decoder_tree(src) is not tree
    assert torch.equal(after, _fresh_decode(tp, cfg, model["samples"], dtype))
    assert not torch.equal(after, before)


def test_decode_tree_is_new_for_a_new_params_object(model):
    tp = model["tp"]
    other = copy.deepcopy(tp)
    assert decode._decoder_tree(other["transformer"]) is not decode._decoder_tree(tp["transformer"])
    kw = dict(max_len=16, bos_token=BOS, eos_token=-1)
    assert torch.equal(decode.greedy(other, model["cfg"], model["samples"], **kw),
                       decode.greedy(tp, model["cfg"], model["samples"], **kw))


KEY_CHANGES = {  # what a capture reads -> a change of it
    "LAYER_GRID": ("flag", "LAYER_GRID", False), "MERGED_LAYER": ("flag", "MERGED_LAYER", True),
    "HEAD_KERNEL": ("flag", "HEAD_KERNEL", True), "BEAM_TOPK_KERNEL": ("flag", "BEAM_TOPK_KERNEL", True),
    "_stack_max_blocks": ("flag", "_stack_max_blocks", 7), "_block_rows": ("flag", "_block_rows", 16),
    "_beam_rows": ("flag", "_beam_rows", 10), "_stack_trace": ("flag", "_stack_trace", torch.zeros(4)),
    "kind": ("arg", "kind", "beam"), "rows": ("arg", "rows", 33), "beams": ("arg", "beams", 5),
    "max_len": ("arg", "max_len", 64), "memory length": ("memory", (32, 197, 8), torch.float32),
    "dtype": ("memory", (32, 196, 8), torch.bfloat16), "tree": ("arg", "trees", "other"),
    "extra": ("arg", "extra", (1.0,)),
}


@pytest.mark.parametrize("change", list(KEY_CHANGES))
def test_session_key_names_what_a_capture_reads(change):
    tree, other = {"w": torch.zeros(2)}, {"w": torch.zeros(2)}
    base = dict(kind="greedy", rows=32, beams=1, max_len=128, trees=[tree], extra=())
    memory = torch.zeros(32, 196, 8)
    key = graphs.session_key(base["kind"], memory, **{k: v for k, v in base.items() if k != "kind"})
    assert graphs.session_key(base["kind"], torch.zeros(32, 196, 8), **{k: v for k, v in base.items()
                                                                           if k != "kind"}) == key
    what, name, value = KEY_CHANGES[change]
    old = {n: getattr(tk, n) for n in ("LAYER_GRID", "MERGED_LAYER", "HEAD_KERNEL", "BEAM_TOPK_KERNEL",
                                       "_stack_max_blocks", "_block_rows", "_beam_rows", "_stack_trace")}
    try:
        kw = dict(base)
        if what == "flag":
            setattr(tk, name, value)
        elif what == "memory":
            memory = torch.zeros(name, dtype=value)
        else:
            kw[name] = [other] if value == "other" else value
        kind = kw.pop("kind")
        assert graphs.session_key(kind, memory, **kw) != key
    finally:
        for n, v in old.items():
            setattr(tk, n, v)


def test_returned_buffer_is_not_the_next_calls_and_the_cpu_makes_no_session(model):
    graphs.clear()
    kw = dict(max_len=16, bos_token=BOS, eos_token=-1)
    a = decode.greedy(model["tp"], model["cfg"], model["samples"], **kw)
    keep = a.clone()
    b = decode.greedy(model["tp"], model["cfg"], model["samples"], **kw)
    b.fill_(0)
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, keep)
    samples = Masked(model["samples"].tensors[:3], model["samples"].mask[:3])
    decode.beam_search(model["tp"], model["cfg"], samples, beam_size=2, **kw)
    decode.sample(model["tp"], model["cfg"], samples, torch.Generator().manual_seed(0), **kw)
    decode.greedy_with_prefix(model["tp"], model["cfg"], model["samples"], model["prefix"], model["lens"], **kw)
    assert graphs.sessions() == []


def _stress(worker, n_threads=16):
    """``worker(t)`` on ``n_threads`` threads at once, with a short switch
    interval so that they interleave; each join is bounded."""
    import sys
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)


def test_decode_tree_and_session_registry_under_threads():
    """The ServingQueue's dispatcher and the HTTP server decode from two
    threads: under 16 threads each tree is built once and every thread gets
    that one object, and each session key makes one session."""
    built = []
    memo = decode._Memo(lambda tree: built.append(1) or {"copy": tree["w"].clone()})
    trees = [{"w": torch.full((3,), float(i))} for i in range(3)]
    got, sessions, made = [], [], []

    def worker(t):
        for n in range(50):
            got.append((n % 3, memo(trees[n % 3])))
            key = ("stress", (t + n) % graphs.MAX_SESSIONS)
            sessions.append((key, graphs.session(key, lambda key=key: made.append(key) or object())))

    try:
        _stress(worker)
    finally:
        with graphs._registry:
            graphs._sessions.clear()
    assert len(built) == 3 and len(got) == 800
    assert all(out is memo(trees[i]) and torch.equal(out["copy"], trees[i]["w"]) for i, out in got)
    assert sorted(made) == sorted(set(made)) and len(made) == graphs.MAX_SESSIONS
    assert len({(key, id(s)) for key, s in sessions}) == graphs.MAX_SESSIONS
