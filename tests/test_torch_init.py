"""Fresh initialisation of the port (``retr_tpu_torch.models.caption.build_model``
and the initialisers of models/layers.py, positional.py, resnet.py and
transformer.py) held against retr_tpu's on the CPU, at the small config of the
JAX tests (ResNet18, 1+1 layers, hidden 64, vocab 97).

torch cannot replay ``jax.random``, so the trees are compared in distribution:
- every leaf's path and shape equal the JAX tree's, for every variant;
- the constant leaves are exact: LayerNorm ones and zeros, zero MHA biases,
  and each folded identity BatchNorm (scale 1/sqrt(1 + 1e-5) in f32, bias 0);
- for each uniform leaf max|x| <= bound, and > 0.9 bound where the leaf has at
  least 1000 entries;
- each random leaf's mean lies within 5 sigma/sqrt(n) of 0, and, where the leaf
  has at least 4096 entries, its variance within 10% of its initialiser's
  (b^2/3 for U(+-b), 2/fan_out for the kaiming-normal convolutions): at that
  size 10% is more than 4.5 standard deviations of the sample variance;
- the same statistics hold on the JAX tree, so the rule the checker encodes is
  the reference's.
"""

import math

import numpy as np
import pytest
import torch

import jax

from retr_tpu.config import Config as JaxConfig
from retr_tpu.models import caption as jcaption
from retr_tpu_torch.config import Config
from retr_tpu_torch.models import caption, layers, resnet
from retr_tpu_torch.train.state import tree_leaves_with_path

SMALL = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=1,
             dim_feedforward=128, vocab_size=97, max_position_embeddings=16, image_size=64)
# the variant whose tree has every kind of leaf: loc_proj, src_pos, encoder.norm
FULL = dict(SMALL, use_location_features=True, position_embedding="learned", pre_norm=True)
BN_SCALE = np.float32(1.0 / math.sqrt(1.0 + resnet.BN_EPS))

VARIANTS = [dict(use_location_features=loc, use_global_features=glob, position_embedding=pos, pre_norm=pre)
            for loc, glob in ((False, False), (True, False), (True, True))
            for pos in ("sine", "learned") for pre in (True, False)]


def _jax_paths(tree):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(k.key if hasattr(k, "key") else k.idx for k in kp)] = tuple(leaf.shape)
    return out


def _port_paths(tree):
    return {p: tuple(leaf.shape) for p, leaf in tree_leaves_with_path(tree)}


def leaf_specs(tree, path=()):
    """(path, leaf, (kind, value)) of every leaf, kind "const" (value),
    "uniform" (bound) or "normal" (std): the reference's initialiser of each."""
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaf_specs(v, path + (i,))
        return
    if set(tree) == {"w", "b"}:                                   # a linear, w [in, out]
        fan_in, fan_out = tree["w"].shape
        xavier = math.sqrt(6.0 / (fan_in + fan_out))
        if "mha" in path:
            bound = math.sqrt(6.0 / (4 * fan_in)) if path[-1] in ("q", "k", "v") else xavier
            yield path + ("w",), tree["w"], ("uniform", bound)
            yield path + ("b",), tree["b"], ("const", 0.0)
        else:
            w_bound = xavier if path[-1] in ("lin1", "lin2") else 1.0 / math.sqrt(fan_in)
            yield path + ("w",), tree["w"], ("uniform", w_bound)
            yield path + ("b",), tree["b"], ("uniform", 1.0 / math.sqrt(fan_in))
        return
    if set(tree) == {"scale", "bias"}:                            # LayerNorm or folded BN
        yield path + ("scale",), tree["scale"], ("const", BN_SCALE if path[0] == "backbone" else 1.0)
        yield path + ("bias",), tree["bias"], ("const", 0.0)
        return
    if set(tree) == {"w"}:                                        # a convolution, OIHW
        o, _, kh, kw = tree["w"].shape
        yield path + ("w",), tree["w"], ("normal", math.sqrt(2.0 / (o * kh * kw)))
        return
    for k in sorted(tree):
        if k == "table":                                          # xavier embedding tables
            n, d = tree[k].shape
            yield path + (k,), tree[k], ("uniform", math.sqrt(6.0 / (n + d)))
        else:
            yield from leaf_specs(tree[k], path + (k,))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def trees():
    jcfg, cfg = JaxConfig(**FULL), Config(**FULL)
    jparams = jax.tree.map(np.asarray, jax.jit(lambda k: jcaption.build_model(jcfg, k)[0])(jax.random.key(0)))
    params, _ = caption.build_model(cfg, device="cpu")
    return {"port": params, "jax": jparams}


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: "-".join(f"{k}={v[k]}" for k in v))
def test_paths_and_shapes_equal_reference(variant):
    jcfg, cfg = JaxConfig(**SMALL, **variant), Config(**SMALL, **variant)
    want = _jax_paths(jax.eval_shape(lambda k: jcaption.build_model(jcfg, k)[0], jax.random.key(0)))
    params, _ = caption.build_model(cfg, device="cpu")
    assert _port_paths(params) == want
    assert all(leaf.dtype == torch.float32 and leaf.device.type == "cpu" for _, leaf in tree_leaves_with_path(params))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_constant_leaves_are_exact(trees, package):
    n = 0
    for path, leaf, (kind, value) in leaf_specs(trees[package]):
        if kind == "const":
            x = _np(leaf)
            assert x.dtype == np.float32 and np.array_equal(x, np.full(x.shape, value, np.float32)), path
            n += 1
    assert n > 40   # every LayerNorm, MHA bias and folded BatchNorm


@pytest.mark.parametrize("package", ["port", "jax"])
def test_uniform_leaves_fill_their_bounds(trees, package):
    n = 0
    for path, leaf, (kind, bound) in leaf_specs(trees[package]):
        if kind == "uniform":
            x = _np(leaf)
            top = float(np.abs(x).max())
            assert top <= np.float32(bound), (path, top, bound)
            if x.size >= 1000:
                assert top > 0.9 * bound, (path, top, bound)
            n += 1
    assert n > 20


@pytest.mark.parametrize("package", ["port", "jax"])
def test_random_leaves_have_their_initialisers_moments(trees, package):
    checked_var = 0
    for path, leaf, (kind, value) in leaf_specs(trees[package]):
        if kind == "const":
            continue
        x = _np(leaf).astype(np.float64).ravel()
        var = value ** 2 / 3.0 if kind == "uniform" else value ** 2
        assert abs(x.mean()) <= 5.0 * math.sqrt(var / x.size), (path, x.mean(), var)
        if x.size >= 4096:
            assert abs(x.var() / var - 1.0) <= 0.10, (path, x.var(), var)
            checked_var += 1
    assert checked_var > 15


def test_same_seed_same_tree_other_seed_other_tree():
    cfg = Config(**FULL)
    a, _ = caption.build_model(cfg, device="cpu")
    b, _ = caption.build_model(cfg, device="cpu")
    c, _ = caption.build_model(cfg, seed=cfg.seed + 1, device="cpu")
    la, lb, lc = (list(tree_leaves_with_path(t)) for t in (a, b, c))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    random_paths = {p for p, _, (kind, _) in leaf_specs(a) if kind != "const"}
    assert all(not torch.equal(x, y) for (p, x), (_, y) in zip(la, lc) if p in random_paths)


def test_global_without_location_raises_before_building():
    cfg = Config(**SMALL, use_global_features=True, use_location_features=False)
    with pytest.raises(NotImplementedError):
        caption.build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        jcaption.build_model(JaxConfig(**SMALL, use_global_features=True, use_location_features=False),
                             jax.random.key(0))


def test_criterion_equals_reference():
    """Mean softmax cross-entropy over every position, PAD (id 0) included."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 97)).astype(np.float32) * 3
    targets = rng.integers(0, 97, (3, 7)).astype(np.int32)
    targets[:, 4:] = 0
    _, crit = caption.build_model(Config(**SMALL), device="cpu")
    # under jit the JAX parameters are traced and dropped, not built
    jcrit = jax.jit(lambda k, x, t: jcaption.build_model(JaxConfig(**SMALL), k)[1](x, t))
    got = float(crit(torch.from_numpy(logits), torch.from_numpy(targets)))
    want = float(jcrit(jax.random.key(0), logits, targets))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("name,make,bound", [
    ("xavier_uniform", lambda g: layers.xavier_uniform(g, (300, 100)), math.sqrt(6 / 400)),
    ("torch_linear_init.w", lambda g: layers.torch_linear_init(g, 300, 100)["w"], 1 / math.sqrt(300)),
    ("torch_linear_init.b", lambda g: layers.torch_linear_init(g, 300, 100)["b"], 1 / math.sqrt(300)),
    ("xavier_linear_init.b", lambda g: layers.xavier_linear_init(g, 300, 100)["b"], 1 / math.sqrt(300)),
    ("embedding_init", lambda g: layers.embedding_init(g, 300, 100)["table"], math.sqrt(6 / 400)),
    ("mha_init.q", lambda g: layers.mha_init(g, 100)["q"]["w"], math.sqrt(6 / 400)),
    ("mha_init.out", lambda g: layers.mha_init(g, 100)["out"]["w"], math.sqrt(6 / 200)),
])
def test_initialiser_draws_from_its_generator_within_its_bound(name, make, bound):
    a = make(torch.Generator().manual_seed(5))
    assert torch.equal(a, make(torch.Generator().manual_seed(5)))
    assert float(a.abs().max()) <= np.float32(bound) and float(a.abs().max()) > 0.9 * bound


def test_kaiming_conv_and_identity_bn():
    w = resnet._kaiming_normal_conv(torch.Generator().manual_seed(0), (256, 64, 3, 3))
    assert abs(float(w.double().std()) / math.sqrt(2.0 / (256 * 9)) - 1.0) < 0.02
    bn = resnet._frozen_bn_identity(8)
    assert torch.equal(bn["scale"], torch.full((8,), float(BN_SCALE))) and not bn["bias"].any()
