"""Layers, positional encoding, masking and the weight bridge of the port, held
against retr_tpu on the same seeded numpy inputs (f32, atol 1e-6 unless stated:
both sides compute the same f32 expressions and differ only in summation order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retr_tpu import masking as jmask
from retr_tpu.config import Config as JaxConfig
from retr_tpu.models import caption as jcaption
from retr_tpu.models import layers as jlayers
from retr_tpu.models import positional as jpos
from retr_tpu_torch import masking as tmask
from retr_tpu_torch.config import Config
from retr_tpu_torch.models import layers as tlayers
from retr_tpu_torch.models import positional as tpos
from retr_tpu_torch.models import weights

TINY = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=2,
            dim_feedforward=128, vocab_size=96, max_position_embeddings=12, dropout=0.0, image_size=32)
ATOL = 1e-6


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _tree(p):
    if isinstance(p, dict):
        return {k: _tree(v) for k, v in p.items()}
    return _t(p)


def test_layer_norm_and_linear_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32), "bias": rng.standard_normal(64).astype(np.float32)}
    for eps in (1e-5, 1e-12):
        ref = jlayers.layer_norm(p, jnp.asarray(x), eps=eps)
        got = tlayers.layer_norm(_tree(p), _t(x), eps=eps)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL * 4)
    lin = {"w": rng.standard_normal((64, 32)).astype(np.float32) * 0.1, "b": rng.standard_normal(32).astype(np.float32)}
    np.testing.assert_allclose(tlayers.linear(_tree(lin), _t(x)).numpy(),
                               np.asarray(jlayers.linear(lin, jnp.asarray(x))), atol=ATOL * 4)


def test_attention_and_heads_match():
    rng = np.random.default_rng(1)
    b, s, e, h = 2, 7, 64, 4
    p = jlayers.mha_init(jax.random.key(0), e)
    q_in, kv = rng.standard_normal((b, 3, e)).astype(np.float32), rng.standard_normal((b, s, e)).astype(np.float32)
    pad = np.zeros((b, s), bool)
    pad[1, -2:] = True
    ref = jlayers.multi_head_attention(p, jnp.asarray(q_in), jnp.asarray(kv), jnp.asarray(kv), num_heads=h,
                                       bias=jmask.key_padding_bias(jnp.asarray(pad)))[0]
    got = tlayers.multi_head_attention(_tree(jax.tree.map(np.asarray, p)), _t(q_in), _t(kv), _t(kv),
                                       num_heads=h, bias=tmask.key_padding_bias(torch.from_numpy(pad)))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL * 4)
    x = _t(kv)
    torch.testing.assert_close(tlayers.merge_heads(tlayers.split_heads(x, h)), x, rtol=0, atol=0)
    np.testing.assert_array_equal(tlayers.split_heads(x, h).numpy(), np.asarray(jlayers.split_heads(jnp.asarray(kv), h)))


@pytest.mark.parametrize("seq_len,d", [(196, 256), (17, 64), (1500, 32)])
def test_sine_table_matches(seq_len, d):
    ref = jpos.positional_encoding("sine", seq_len, d)
    got = tpos.positional_encoding("sine", seq_len, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_learned_positions_not_ported_yet():
    """Ported since: the learned table's LayerNorm equals retr_tpu's on the
    same parameters (the name is kept from when the port raised here); it
    needs its parameters, and drops out only under ``train``."""
    p = jpos.learned_init(jax.random.key(3), 64)
    tp = {"table": torch.from_numpy(np.array(p["table"])),
          "norm": {k: torch.from_numpy(np.array(v)) for k, v in p["norm"].items()}}
    ref = jpos.positional_encoding("learned", 10, 64, p)
    got = tpos.positional_encoding("learned", 10, 64, tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="src_pos"):
        tpos.positional_encoding("learned", 10, 64)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(tpos.positional_encoding("learned", 10, 64, tp, dropout_rate=0.5, generator=gen), got)
    dropped = tpos.positional_encoding("learned", 10, 64, tp, dropout_rate=0.5, generator=gen, train=True)
    assert 0.3 < float((dropped == 0).float().mean()) < 0.7


def test_masks_match():
    np.testing.assert_array_equal(tmask.causal_mask(6).numpy(), np.asarray(jmask.causal_mask(6)))
    pad = np.random.default_rng(2).random((3, 9)) < 0.4
    np.testing.assert_array_equal(tmask.key_padding_bias(torch.from_numpy(pad)).numpy(),
                                  np.asarray(jmask.key_padding_bias(jnp.asarray(pad))))


@pytest.mark.parametrize("src,dst", [((64, 64), (2, 2)), ((224, 224), (14, 14)), ((100, 37), (7, 3))])
def test_downsample_mask_nearest_matches(src, dst):
    m = np.random.default_rng(3).random((2,) + src) < 0.5
    ref = jmask.downsample_mask_nearest(jnp.asarray(m), *dst)
    got = tmask.downsample_mask_nearest(torch.from_numpy(m), *dst)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_ensure_unmasked_values_with_jax_drawn_filler():
    """The JAX package draws the filler with jax.random.choice; given the same
    indices the port produces the same mask (and leaves visible rows alone)."""
    mask = np.zeros((3, 4, 5), bool)
    mask[0] = True                      # fully masked -> filler
    mask[2, :, 1:] = True               # one visible column -> unchanged
    key = jax.random.key(42)
    n = 20
    n_unmask = max(1, round(n * 0.01))
    idx = np.asarray(jax.random.choice(key, n, shape=(n_unmask,), replace=False))
    ref = jmask.ensure_unmasked_values(jnp.asarray(mask), key)
    got = tmask.ensure_unmasked_values(torch.from_numpy(mask), idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got[1:].numpy(), mask[1:])
    # the port's default filler: numpy default_rng(seed), at least one position
    assert len(tmask.filler_indices(196, 42)) == 2 and len(tmask.filler_indices(4, 42)) == 1


@pytest.mark.parametrize("variant", [(False, False), (False, True), (True, True)])
def test_weight_bridge_strict_load_and_round_trip(variant):
    use_global, use_loc = variant
    jcfg = JaxConfig(**TINY, use_global_features=use_global, use_location_features=use_loc)
    cfg = Config(**TINY, use_global_features=use_global, use_location_features=use_loc)
    params, _ = jcaption.build_model(jcfg, jax.random.key(0))
    pnp = jax.tree.map(np.asarray, params)
    sd = weights.to_state_dict(pnp, cfg)
    module = weights.reference_module(cfg)
    result = module.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys

    # state dict -> tree gives back the JAX tree leaf for leaf (BN folds exactly)
    tree = weights.to_params(module.state_dict(), cfg, device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(pnp)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), tree))[0])
    assert len(flat_ref) == len(flat_got)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_got[path], leaf, err_msg=jax.tree_util.keystr(path))
