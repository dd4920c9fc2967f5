"""The port's training data path held against retr_tpu on the CPU: the RefCOCO
dataset and DataLoader on the synthetic fixture (HostBatches bit-equal, every
partition, shuffled epochs, shards, ``drop_last``, ``return_unique``, worker
errors, ``pad_host_batch``), colour jitter (the apply under JAX's own draws
within 1e-3 on the 0-255 scale; the draws in distribution), the training
``device_batch`` (within 1e-5 after normalization under JAX's draws), and
the learned source positions (``caption.forward`` logits within 1e-5,
greedy tokens equal)."""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retr_tpu.config import Config as JaxConfig
from retr_tpu.data import dataset as jdataset
from retr_tpu.data import pipeline as jpipeline
from retr_tpu.data.tokenizer import prepare_tokenizer as jax_prepare_tokenizer
from retr_tpu.masking import Masked as JMasked
from retr_tpu.models import caption as jcaption
from retr_tpu.ops import image as jimops
from retr_tpu import decode as jdecode
from retr_tpu_torch import decode
from retr_tpu_torch.config import Config
from retr_tpu_torch.data import dataset, pipeline, preprocess
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import caption, weights
from retr_tpu_torch.ops import image as imops
from tests.synth_refcoco import make_synth_refcoco

CPU = torch.device("cpu")
RANGES = (imops.BRIGHTNESS, imops.CONTRAST, imops.SATURATION)


def jax_jitter_draws(key, n: int) -> imops.JitterDraws:
    """The draws ``retr_tpu``'s ``_finish_images`` makes for ``key`` over n
    rows (``split(key, n)``, then per row ``split(k, 4)``, three uniforms and
    ``permutation(kp, 3)``: retr_tpu/ops/image.py:203-222), as the port's
    JitterDraws."""
    def one(k):
        kb, kc, ks, kp = jax.random.split(k, 4)
        f = [jax.random.uniform(kk, (), minval=lo, maxval=hi) for kk, (lo, hi) in zip((kb, kc, ks), RANGES)]
        return (*f, jax.random.permutation(kp, 3))

    fb, fc, fs, perm = jax.vmap(one)(jax.random.split(key, n))
    return imops.JitterDraws(*(torch.from_numpy(np.array(a)) for a in (fb, fc, fs)),
                             torch.from_numpy(np.array(perm)).long())


def jax_batch_draws(key, n: int, context: bool):
    """The draws of JAX's device_batch(train=True, key): target rows from the
    first half of split(key), context rows from the second."""
    k_t, k_c = jax.random.split(key)
    return [jax_jitter_draws(k_t, n)] + ([jax_jitter_draws(k_c, n)] if context else [])


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("refcoco")
    coco_dir, ref_dir = make_synth_refcoco(str(root), n_images=16, sents_per_ann=[1, 2, 3])
    return coco_dir, ref_dir, prepare_tokenizer()[0], jax_prepare_tokenizer()[0]


def _cfgs(fixture, **kw):
    coco_dir, ref_dir, tok, _ = fixture
    base = dict(dir=coco_dir, ref_dir=ref_dir, image_size=32, max_position_embeddings=12,
                vocab_size=tok.vocab_size, **kw)
    return JaxConfig(**base), Config(**base)


def _assert_host_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "HostBatch"
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
        else:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


LOADERS = {  # label -> (mode, return_unique, loader kwargs)
    "train shuffled drop_last": ("training", False, dict(shuffle=True, drop_last=True, seed=3)),
    "train shard 0 of 2": ("train", False, dict(shuffle=True, shard=(0, 2), seed=5)),
    "train shard 1 of 2 drop_last": ("train", False, dict(shuffle=True, drop_last=True, shard=(1, 2), seed=5)),
    "train return_unique": ("training", True, dict(shuffle=True)),
    "val return_unique": ("validation", True, {}),
    "testA": ("testA", False, {}),
}


@pytest.mark.parametrize("label", list(LOADERS))
def test_loader_batches_bit_equal(fixture, label):
    """Two epochs through both loaders: the same HostBatches, bit for bit."""
    mode, unique, kw = LOADERS[label]
    jcfg, cfg = _cfgs(fixture)
    tok, jtok = fixture[2], fixture[3]
    ds = dataset.build_dataset(cfg, mode, tokenizer=tok, return_unique=unique)
    jds = jdataset.build_dataset(jcfg, mode, tokenizer=jtok, return_unique=unique)
    assert ds.annot == jds.annot and ds.annot_select == jds.annot_select and len(ds) > 0
    loader = dataset.DataLoader(ds, 3, num_workers=2, **kw)
    jloader = jdataset.DataLoader(jds, 3, num_workers=2, **kw)
    assert len(loader) == len(jloader)
    for epoch in range(2):
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader), epoch
        for g, w in zip(got, want):
            _assert_host_equal(g, w)
    assert loader.epoch == jloader.epoch == 2


def test_loader_with_context_and_location_features_bit_equal(fixture):
    jcfg, cfg = _cfgs(fixture, use_global_features=True, use_location_features=True)
    ds = dataset.build_dataset(cfg, "train", tokenizer=fixture[2])
    jds = jdataset.build_dataset(jcfg, "train", tokenizer=fixture[3])
    got = list(dataset.DataLoader(ds, 4, shuffle=True, seed=1))
    want = list(jdataset.DataLoader(jds, 4, shuffle=True, seed=1))
    assert got[0].context_images is not None and got[0].loc_feats is not None
    for g, w in zip(got, want):
        _assert_host_equal(g, w)


def test_worker_error_reaches_the_consumer(fixture):
    _, cfg = _cfgs(fixture)

    def read_image(path):
        if path.endswith("1005.jpg"):
            raise OSError(f"cannot read {path}")
        return preprocess.load_image(path)

    ds = dataset.build_dataset(cfg, "train", tokenizer=fixture[2], read_image=read_image)
    with pytest.raises(OSError, match="1005.jpg"):
        list(dataset.DataLoader(ds, 2, num_workers=2))


def test_default_reader_raises_without_pil(fixture, monkeypatch):
    _, cfg = _cfgs(fixture)
    ds = dataset.build_dataset(cfg, "val", tokenizer=fixture[2])
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="read_image"):
        ds[0]


def test_load_image_reads_an_np_save_file_by_its_magic(tmp_path, monkeypatch):
    """A uint8 HWC array saved by np.save under a COCO .jpg name reads back
    bit-equal, without PIL."""
    arr = np.random.default_rng(0).integers(0, 256, (7, 9, 3), dtype=np.uint8)
    path = tmp_path / "COCO_train2014_000000001000.jpg"
    with open(path, "wb") as f:
        np.save(f, arr)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = preprocess.load_image(str(path))
    assert got.dtype == np.uint8 and np.array_equal(got, arr)


def test_read_image_argument_and_pad_host_batch(fixture):
    """A numpy reader of the same pixels gives the same samples as the PIL
    default; pad_host_batch pads a ragged batch as retr_tpu's does."""
    jcfg, cfg = _cfgs(fixture)
    arrays = {}

    def read_image(path):
        if path not in arrays:
            arrays[path] = preprocess.load_image(path)
        return arrays[path]

    ds = dataset.build_dataset(cfg, "train", tokenizer=fixture[2], read_image=read_image)
    jds = jdataset.build_dataset(jcfg, "train", tokenizer=fixture[3])
    host = dataset.collate([ds[i] for i in range(3)])
    jhost = jdataset.collate([jds[i] for i in range(3)])
    _assert_host_equal(host, jhost)
    for size in (2, 3, 5):
        _assert_host_equal(dataset.pad_host_batch(host, size), jdataset.pad_host_batch(jhost, size))


def _images(seed, n=8, s=24):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)
    img[0] = 255                        # clipped bright
    img[1, :, :, 1:] = 0                # saturated red
    img[2] = rng.integers(100, 110, (s, s, 3))   # low contrast
    return img


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_color_jitter_under_jax_draws_matches(seed):
    img = _images(seed)
    key = jax.random.key(seed)
    want = np.asarray(jax.vmap(jimops.color_jitter)(jnp.asarray(img, jnp.float32),
                                                    jax.random.split(key, img.shape[0])))
    got = imops.apply_color_jitter(torch.from_numpy(img).float(), jax_jitter_draws(key, img.shape[0]))
    assert got.dtype == torch.float32 and tuple(got.shape) == img.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_jitter_draws_in_distribution():
    """4000 rows: each factor within its range with the uniform's mean and
    quartiles (within 0.03 of the range), each of the 6 orders at 1/6 +- 0.03."""
    n = 4000
    d = imops.jitter_draws(torch.Generator().manual_seed(0), n, CPU)
    for f, (lo, hi) in zip((d.brightness, d.contrast, d.saturation), RANGES):
        assert f.shape == (n,) and f.dtype == torch.float32
        assert float(f.min()) >= lo and float(f.max()) < hi
        u = (f.numpy() - lo) / (hi - lo)
        assert abs(u.mean() - 0.5) < 0.03
        assert np.allclose(np.quantile(u, [0.25, 0.5, 0.75]), [0.25, 0.5, 0.75], atol=0.03)
    assert d.order.shape == (n, 3) and bool((d.order.sort(dim=1).values == torch.arange(3)).all())
    orders, counts = np.unique(d.order.numpy(), axis=0, return_counts=True)
    assert len(orders) == 6 and np.all(np.abs(counts / n - 1 / 6) < 0.03)
    # a row draws its own order: the first op is not shared by the batch
    assert len(set(d.order[:, 0].tolist())) == 3


@pytest.mark.parametrize("context", [False, True])
def test_train_device_batch_under_jax_draws_matches(fixture, context, monkeypatch):
    jcfg, cfg = _cfgs(fixture, use_global_features=context, use_location_features=context)
    ds = dataset.build_dataset(cfg, "train", tokenizer=fixture[2])
    jds = jdataset.build_dataset(jcfg, "train", tokenizer=fixture[3])
    host = dataset.collate([ds[i] for i in range(4)])
    jhost = jdataset.collate([jds[i] for i in range(4)])
    key = jax.random.key(11)
    draws = jax_batch_draws(key, 4, context)
    monkeypatch.setattr(imops, "jitter_draws", lambda gen, n, dev: draws.pop(0))
    got = pipeline.device_batch(host, CPU, train=True, generator=torch.Generator().manual_seed(0))
    want = jpipeline.device_batch(jhost, train=True, key=key)
    assert not draws
    for name in ("images", "global_images"):
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None
            continue
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_array_equal(got.caps.numpy(), np.asarray(want.caps))


def test_train_device_batch_needs_a_generator_and_is_seeded(fixture):
    _, cfg = _cfgs(fixture)
    ds = dataset.build_dataset(cfg, "train", tokenizer=fixture[2])
    host = dataset.collate([ds[i] for i in range(4)])
    with pytest.raises(ValueError, match="generator"):
        pipeline.device_batch(host, CPU, train=True)

    def images(seed):
        return pipeline.device_batch(host, CPU, train=True, generator=torch.Generator().manual_seed(seed)).images

    plain = pipeline.device_batch(host, CPU).images
    assert torch.equal(images(3), images(3))
    assert not torch.equal(images(3), images(4)) and not torch.equal(images(3), plain)


LEARNED = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=2,
               dim_feedforward=128, vocab_size=96, max_position_embeddings=12, dropout=0.0, image_size=32,
               position_embedding="learned")


def test_learned_source_positions_match(fixture):
    """position_embedding="learned": the weights cross through to_state_dict
    and the reference module's names; teacher-forced logits within 1e-5 and
    greedy tokens equal to retr_tpu's."""
    jcfg, cfg = JaxConfig(**LEARNED), Config(**LEARNED)
    params = jax.jit(lambda k: jcaption.build_model(jcfg, k)[0])(jax.random.key(4))   # jit: 2x faster than eager
    assert "src_pos" in params["transformer"]
    sd = weights.to_state_dict(jax.tree.map(np.asarray, params), cfg)
    weights.reference_module(cfg).load_state_dict(sd, strict=True)
    tp = weights.to_params(sd, cfg, device="cpu")
    np.testing.assert_array_equal(tp["transformer"]["src_pos"]["table"].numpy(),
                                  np.asarray(params["transformer"]["src_pos"]["table"]))
    rng = np.random.default_rng(4)
    img = rng.standard_normal((3, 3, 32, 32)).astype(np.float32)
    mask = np.zeros((3, 32, 32), bool)
    mask[1, :, 20:] = True
    caps = rng.integers(3, 96, (3, 12)).astype(np.int32)
    caps[:, 0] = 1
    cap_mask = np.arange(12)[None, :] >= np.array([12, 7, 4])[:, None]
    want = jax.jit(lambda p, *a: jcaption.forward(p, jcfg, JMasked(*a[:2]), *a[2:]))(
        params, *(jnp.asarray(a) for a in (img, mask, caps, cap_mask)))
    samples = Masked(torch.from_numpy(img), torch.from_numpy(mask))
    with torch.no_grad():
        got = caption.forward(tp, cfg, samples, torch.from_numpy(caps), torch.from_numpy(cap_mask))
        ids = decode.greedy(tp, cfg, samples, max_len=12, bos_token=1, eos_token=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    jids = jdecode.greedy(params, jcfg, JMasked(jnp.asarray(img), jnp.asarray(mask)), max_len=12,
                          bos_token=1, eos_token=6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
