"""The port's backbone and encoder held against retr_tpu (f32, seeded numpy inputs).

Tolerances: backbone features rtol 1e-4 / atol 1e-4 (deep conv stacks; the two
frameworks sum convolutions in different orders), masks exact; encoder memory
atol 1e-4 for the same reason.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retr_tpu.config import Config as JaxConfig
from retr_tpu.masking import Masked as JMasked
from retr_tpu.models import caption as jcaption
from retr_tpu.models import resnet as jresnet
from retr_tpu_torch.config import Config
from retr_tpu_torch.masking import Masked, filler_indices
from retr_tpu_torch.models import caption, resnet, weights

TINY = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=2, dec_layers=1,
            dim_feedforward=128, vocab_size=96, max_position_embeddings=12, dropout=0.0, image_size=64)


def _inputs(b, size, seed):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, 3, size, size)).astype(np.float32)
    mask = np.zeros((b, size, size), bool)
    mask[0, :, size // 2:] = True
    mask[-1, size * 3 // 4:, :] = True
    return img, mask


def _tree(p):
    if isinstance(p, dict):
        return {k: _tree(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_tree(v) for v in p]
    return torch.tensor(np.asarray(p, np.float32))


@pytest.mark.parametrize("name,dilation", [("ResNet18", False), ("ResNet50", True)])
def test_backbone_forward_matches(name, dilation):
    jp = jresnet.init(jax.random.key(1), name, dilation)
    img, mask = _inputs(2, 64, 0)
    ref = jresnet.backbone_forward(jp, JMasked(jnp.asarray(img), jnp.asarray(mask)), name=name,
                                   dilation=dilation)
    got = resnet.backbone_forward(_tree(jax.tree.map(np.asarray, jp)),
                                  Masked(torch.from_numpy(img), torch.from_numpy(mask)),
                                  name=name, dilation=dilation)
    side = 4 if dilation else 2
    channels = 2048 if name == "ResNet50" else 512
    assert got.tensors.shape == ref.tensors.shape == (2, channels, side, side)
    np.testing.assert_allclose(got.tensors.numpy(), np.asarray(ref.tensors), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))


@pytest.mark.parametrize("variant", [(False, False), (False, True), (True, True)])
def test_encode_matches(variant):
    use_global, use_loc = variant
    jcfg = JaxConfig(**TINY, use_global_features=use_global, use_location_features=use_loc)
    cfg = Config(**TINY, use_global_features=use_global, use_location_features=use_loc)
    params, _ = jcaption.build_model(jcfg, jax.random.key(3))
    tp = weights.to_params(weights.to_state_dict(jax.tree.map(np.asarray, params), cfg), cfg, device="cpu")
    img, mask = _inputs(3, 64, 1)
    gimg, gmask = _inputs(3, 64, 2)
    loc = np.random.default_rng(4).random((3, 5)).astype(np.float32)
    jkw, tkw = {}, {}
    if use_loc:
        jkw["loc_feats"], tkw["loc_feats"] = jnp.asarray(loc), torch.from_numpy(loc)
    if use_global:
        jkw["global_samples"] = JMasked(jnp.asarray(gimg), jnp.asarray(gmask))
        tkw["global_samples"] = Masked(torch.from_numpy(gimg), torch.from_numpy(gmask))
    ref = jcaption.encode(params, jcfg, JMasked(jnp.asarray(img), jnp.asarray(mask)), **jkw)
    got = caption.encode(tp, cfg, Masked(torch.from_numpy(img), torch.from_numpy(mask)), **tkw)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_fully_masked_target_uses_the_given_filler():
    """A fully padded image: the port unmasks exactly the filler positions it is
    given (JAX-drawn here), as retr_tpu does with its own key."""
    jcfg, cfg = JaxConfig(**TINY), Config(**TINY)
    params, _ = jcaption.build_model(jcfg, jax.random.key(5))
    tp = weights.to_params(weights.to_state_dict(jax.tree.map(np.asarray, params), cfg), cfg, device="cpu")
    img, mask = _inputs(2, 64, 6)
    mask[1] = True
    n = 4  # 64 px / output stride 32 = 2x2 map
    idx = np.asarray(jax.random.choice(jax.random.key(jcfg.seed), n, shape=(1,), replace=False))
    ref = jcaption.encode(params, jcfg, JMasked(jnp.asarray(img), jnp.asarray(mask)))
    got = caption.encode(tp, cfg, Masked(torch.from_numpy(img), torch.from_numpy(mask)), filler_idx=idx)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4, rtol=1e-4)
    assert int((~got[1][1]).sum()) == 1
    # the default filler comes from numpy with cfg.seed
    dflt = caption.encode(tp, cfg, Masked(torch.from_numpy(img), torch.from_numpy(mask)))
    assert np.flatnonzero(~dflt[1][1].numpy()).tolist() == sorted(filler_indices(n, cfg.seed).tolist())


def test_global_without_location_is_not_implemented():
    cfg = Config(**TINY, use_global_features=True)
    with pytest.raises(NotImplementedError):
        caption.build_encoder_input({}, cfg, Masked(torch.zeros(1, 3, 64, 64), torch.zeros(1, 64, 64, dtype=torch.bool)))
