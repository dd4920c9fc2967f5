"""The tensor-parallel decode blocks and the vocabulary head's combine over mp
(retr_tpu_torch/ops/decoder_kernels.py ``partial=True``, the epilogues;
retr_tpu_torch/decode.py), on the CPU in one process.

- Each decode block at the tiny config (hidden 64, 4 heads, FF 128): the sum
  over mp = 2 and 4 slices (heads 2 and 1, FF columns 64 and 32, cut as
  ``parallel/mesh.param_specs`` cuts them) of the partial plain version,
  finished by its epilogue (slices cut by ``chip_smoke.tp_slice``, which
  phase 3b shares), against retr_tpu's Pallas block on the whole
  heads in interpret mode, within 1e-5 of max(1, max|ref|) in f32; the beam
  block at beams 1 and 5; each self block's cache slots equal to the JAX
  cache's local heads.
- The head's combine (vocabulary 342 split over mp = 2 and 3) against the
  whole vocabulary: greedy ids equal, with ties crafted across the slice
  boundary (the lowest global index wins, argmax's first max);
  ``topk_log_softmax`` values within 1e-6 and ids equal; the gathered
  logits bit-equal (-0.0 and NaN included).

The combine's collectives run between threads, one per rank, each under its
own mesh: ``parallel.mesh.all_reduce`` is replaced by an exchange between
the threads (the real collectives are held in tests/test_torch_sweep.py's
and tests/test_torch_parallel.py's gloo worlds).
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import tp_slice
from retr_tpu.models import layers
from retr_tpu.ops import decoder_kernels as dk
from retr_tpu_torch import decode
from retr_tpu_torch.ops import decoder_kernels as tk
from retr_tpu_torch.parallel import mesh as pmesh

C, H, F, B, S, T, V = 64, 4, 128, 8, 23, 12, 342
D = C // H
STEP = 5
TOL = 1e-5


def _norm(rng):
    return {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(C), jnp.float32),
            "bias": jnp.asarray(0.1 * rng.standard_normal(C), jnp.float32)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= TOL * max(1.0, float(np.abs(ref).max())), err


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(11)
    key = jax.random.key(3)
    k = jax.random.split(key, 4)
    att = {"norm": _norm(rng), "mha": layers.mha_init(k[0], C)}
    # nonzero biases, so the epilogue's bias is seen
    att["mha"] = jax.tree.map(lambda a: a + 0.05 * jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
                              att["mha"])
    ff = {"norm": _norm(rng), "lin1": layers.xavier_linear_init(k[1], C, F),
          "lin2": layers.xavier_linear_init(k[2], F, C)}
    return att, ff


@pytest.mark.parametrize("mp", [2, 4])
def test_ff_block_partial_sum_matches_pallas(blocks, mp):
    _, ff = blocks
    x = jnp.asarray(np.random.default_rng(1).standard_normal((B, C)), jnp.float32)
    ref = dk.ff_block(ff, x, interpret=True)
    tp, tx = _torch(ff), _t(x)
    s = sum(tk.ff_block(tp_slice(tp, mp, r), tx, partial=True) for r in range(mp))
    got = tk.ff_block_epilogue(tp, tx, s)
    assert got.dtype == torch.float32
    _close(got, ref)


@pytest.mark.parametrize("mp", [2, 4])
def test_cross_attn_block_partial_sum_matches_pallas(blocks, mp):
    att, _ = blocks
    rng = np.random.default_rng(2)
    x, qpos = (jnp.asarray(rng.standard_normal(sh), jnp.float32) for sh in ((B, C), (C,)))
    ck, cv = (jnp.asarray(rng.standard_normal((B, H, S, D)), jnp.float32) for _ in range(2))
    pad = rng.random((B, S)) < 0.3
    pad[:, 0] = False
    kb = jnp.where(jnp.asarray(pad), -jnp.inf, 0.0).astype(jnp.float32)
    ref = dk.cross_attn_block(att, x, qpos, ck, cv, kb, num_heads=H, interpret=True)
    tp, hl = _torch(att), H // mp
    parts = []
    for r in range(mp):
        heads = slice(r * hl, (r + 1) * hl)
        p = tp_slice(tp, mp, r)
        parts.append(tk.cross_attn_block(p, _t(x), _t(qpos), _t(ck)[:, heads], _t(cv)[:, heads], _t(kb),
                                         num_heads=hl, partial=True))
    _close(tk.attn_block_epilogue(tp, _t(x), sum(parts)), ref)


def _self_case(rows, seed):
    rng = np.random.default_rng(seed)
    arr = lambda *sh: jnp.asarray(rng.standard_normal(sh), jnp.float32)  # noqa: E731
    return arr(rows, C), arr(C), arr(H, rows, D, T), arr(H, rows, D, T), rng


def _self_partials(att, mp, x, qpos, kc, vc, call):
    """Each rank's partial on its heads of a copy of the [B, H, T, D] caches;
    returns (the epilogue of the summed partials, the caches the ranks wrote,
    put back together along the heads)."""
    tp, hl = _torch(att), H // mp
    kc_t, vc_t = (_t(c).permute(1, 0, 3, 2).contiguous() for c in (kc, vc))
    parts, ks, vs = [], [], []
    for r in range(mp):
        heads = slice(r * hl, (r + 1) * hl)
        k_loc, v_loc = kc_t[:, heads].contiguous(), vc_t[:, heads].contiguous()
        p = tp_slice(tp, mp, r)
        y, k_out, v_out = call(p, _t(x), _t(qpos), k_loc, v_loc, hl)
        assert k_out is k_loc and y.dtype == torch.float32
        parts.append(y)
        ks.append(k_loc)
        vs.append(v_loc)
    return tk.attn_block_epilogue(tp, _t(x), sum(parts)), torch.cat(ks, 1), torch.cat(vs, 1)


@pytest.mark.parametrize("mp", [2, 4])
def test_self_attn_block_partial_sum_matches_pallas(blocks, mp):
    att, _ = blocks
    x, qpos, kc, vc, _ = _self_case(B, 4)
    ref, kc_ref, vc_ref = dk.self_attn_block(att, x, qpos, kc, vc, jnp.int32(STEP), num_heads=H, interpret=True)
    step = torch.tensor(STEP, dtype=torch.int32)
    got, k_all, v_all = _self_partials(att, mp, x, qpos, kc, vc, lambda p, x_, q_, k_, v_, hl: tk.self_attn_block(
        p, x_, q_, k_, v_, step, num_heads=hl, partial=True))
    _close(got, ref)
    _close(k_all.permute(1, 0, 3, 2), kc_ref)     # each rank's heads: the JAX cache's local heads
    _close(v_all.permute(1, 0, 3, 2), vc_ref)


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("beams", [1, 5])
def test_self_attn_block_beam_partial_sum_matches_pallas(blocks, mp, beams):
    """8 groups of ``beams`` rows; the ancestry crosses rows of each group."""
    att, _ = blocks
    rows = 8 * beams
    x, qpos, kc, vc, rng = _self_case(rows, 5 + beams)
    anc = rng.integers(0, beams, (rows, T)).astype(np.int32)
    ref, kc_ref, vc_ref = dk.self_attn_block_beam(att, x, jnp.asarray(anc), qpos, kc, vc, jnp.int32(STEP),
                                                  num_heads=H, num_beams=beams, interpret=True)
    step = torch.tensor(STEP, dtype=torch.int32)
    got, k_all, v_all = _self_partials(
        att, mp, x, qpos, kc, vc, lambda p, x_, q_, k_, v_, hl: tk.self_attn_block_beam(
            p, x_, torch.from_numpy(anc), q_, k_, v_, step, num_heads=hl, num_beams=beams, partial=True))
    _close(got, ref)
    _close(k_all.permute(1, 0, 3, 2), kc_ref)
    _close(v_all.permute(1, 0, 3, 2), vc_ref)


# -- the head's combine over mp: ranks as threads -------------------------------------


class _Group:
    """The mp group of ``n`` threads: ``reduce`` exchanges their tensors."""

    def __init__(self, n):
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n)
        self.local = threading.local()

    def reduce(self, t, op):
        self.slots[self.local.rank] = t.clone()
        self.barrier.wait()
        stacked = torch.stack(self.slots)
        out = {"sum": lambda: stacked.sum(0, dtype=t.dtype), "max": lambda: stacked.amax(0),
               "min": lambda: stacked.amin(0)}[op]()
        self.barrier.wait()
        t.copy_(out)
        return t


def _on_ranks(monkeypatch, mp, fn):
    """fn(rank) on ``mp`` threads, each under a mesh of its own whose mp
    group is a :class:`_Group`; returns the results in rank order."""
    group = _Group(mp)
    monkeypatch.setattr(pmesh, "all_reduce", lambda t, g, op="sum": g.reduce(t, op))
    monkeypatch.setattr(pmesh.dist, "get_world_size", lambda g=None: g.n)
    monkeypatch.setattr(pmesh.dist, "get_rank", lambda g=None: g.local.rank)
    out, errors = [None] * mp, []

    def run(r):
        group.local.rank = r
        try:
            with pmesh.active(pmesh.Mesh(1, mp, r, 0, r, None, group, group, torch.device("cpu"))):
                out[r] = fn(r)
        except BaseException as exc:   # noqa: BLE001 - surfaced below
            errors.append(exc)
            group.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(mp)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    if errors:
        raise errors[0]
    return out


def _logits(mp, seed=0):
    """Logits [6, V] with ties: row 0 at the slice boundary (the max at the
    last column of rank 0 and the first of rank 1), row 1 inside one slice
    and across the last boundary, row 2 the whole row equal, row 3 a max
    of -0.0 beside 0.0 elsewhere."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(6, V, generator=g)
    n = V // mp
    x[0, n - 1] = x[0, n] = 9.0
    x[1, 2] = x[1, 7] = x[1, V - 1] = x[1, (mp - 1) * n] = 8.0
    x[2] = 0.25
    x[3] = -1.0
    x[3, n + 1] = -0.0
    x[3, 3] = 0.0
    return x


def _split(x, mp, r):
    n = x.shape[-1] // mp
    return x[:, r * n:(r + 1) * n].contiguous()


@pytest.mark.parametrize("mp", [2, 3])
def test_greedy_argmax_over_mp_takes_the_lowest_global_index(monkeypatch, mp):
    x = _logits(mp)
    got = _on_ranks(monkeypatch, mp, lambda r: decode._argmax_over_mp(_split(x, mp, r)))
    want = x.argmax(dim=-1).to(torch.int32)
    assert want[:4].tolist() == [V // mp - 1, 2, 0, 3]
    for g in got:
        assert torch.equal(g, want)


@pytest.mark.parametrize("mp", [2, 3])
def test_beam_topk_log_softmax_over_mp_matches_the_whole_vocabulary(monkeypatch, mp):
    x = _logits(mp, seed=1)
    k = 5
    got = _on_ranks(monkeypatch, mp, lambda r: decode._topk_log_softmax_over_mp(_split(x, mp, r), k))
    want_v, want_i = tk.topk_log_softmax(x, k)
    assert want_i[1].tolist()[:4] == [2, 7, (mp - 1) * (V // mp), V - 1]   # ties in index order
    for v, i in got:
        assert torch.equal(i, want_i)
        assert float((v - want_v).abs().max()) <= 1e-6


@pytest.mark.parametrize("mp", [2, 3])
def test_sampling_gathers_the_logits_bit_for_bit(monkeypatch, mp):
    x = _logits(mp, seed=2)
    x[4, 5] = float("nan")
    got = _on_ranks(monkeypatch, mp, lambda r: decode._gather_vocab(_split(x, mp, r)))
    for g in got:
        assert torch.equal(g.view(torch.int32), x.view(torch.int32))


@pytest.mark.parametrize("inner,heads,fits", [(256, 8, True), (128, 4, True), (64, 2, True), (32, 1, True),
                                              (128, 8, False), (96, 3, False), (256, 4, False)])
def test_decode_kernels_fit_an_mp_slice(inner, heads, fits):
    """The tuned kernels take a slice of whole 32-wide heads, 1, 2, 4 or 8 of them."""
    assert tk.decode_kernels_fit(256, heads, 1024, 5, inner) == fits
