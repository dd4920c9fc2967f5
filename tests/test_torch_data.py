"""The port's host preprocessing, tokenizer and batch finishing, held against
retr_tpu on the same seeded numpy inputs.

Everything before normalisation is integer or boolean work and must be equal;
the normalised images are the same f32 expression on both sides (atol 1e-6).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from retr_tpu.data import dataset as jdataset
from retr_tpu.data import pipeline as jpipeline
from retr_tpu.data import preprocess as jpre
from retr_tpu.data.tokenizer import prepare_tokenizer as jax_prepare_tokenizer
from retr_tpu_torch.data import dataset, pipeline, preprocess
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.ops import image as imops

SHAPES = [(60, 80), (81, 50), (47, 47), (33, 70)]   # landscape, portrait, square, diff % 4 == 1
CAPTIONS = ["the woman in the red coat", "left dog!", "", "a man, on the RIGHT side"]


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape + (3,), dtype=np.uint8)


def _box(shape, seed):
    rng = np.random.default_rng(seed + 100)
    h, w = shape
    x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
    return [x, y, rng.uniform(4, w - x), rng.uniform(4, h - y)]


@pytest.mark.parametrize("use_global,use_location", [(False, False), (False, True), (True, True)])
@pytest.mark.parametrize("shape", SHAPES)
def test_preprocess_sample_matches(shape, use_global, use_location):
    tok, jtok = prepare_tokenizer()[0], jax_prepare_tokenizer()[0]
    img, box = _image(shape, 0), _box(shape, 0)
    kw = dict(image_size=32, max_length=12, use_global=use_global, use_location=use_location)
    got = preprocess.preprocess_sample(img, box, CAPTIONS[0], tok, **kw)
    want = jpre.preprocess_sample(img, box, CAPTIONS[0], jtok, **kw)
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("text", CAPTIONS)
def test_tokenizer_matches(text):
    tok, jtok = prepare_tokenizer()[0], jax_prepare_tokenizer()[0]
    assert tok.tokenize(text) == jtok.tokenize(text)
    enc, jenc = tok.encode_plus(text, max_length=10), jtok.encode_plus(text, max_length=10)
    assert enc["input_ids"] == jenc["input_ids"] and enc["attention_mask"] == jenc["attention_mask"]
    assert tok.decode(enc["input_ids"]) == jtok.decode(jenc["input_ids"])


@pytest.mark.parametrize("in_hw,out", [((47, 47), 32), ((20, 20), 64), ((224, 224), 224)])
def test_pil_resize_matches_pillow(in_hw, out):
    img = _image(in_hw, 3)
    ref = np.asarray(Image.fromarray(img).resize((out, out), Image.BILINEAR))
    np.testing.assert_array_equal(imops.pil_resize_uint8(img, out, out), ref)


@pytest.mark.parametrize("use_global,use_location", [(False, False), (True, True)])
def test_collate_and_device_batch_match(use_global, use_location):
    tok, jtok = prepare_tokenizer()[0], jax_prepare_tokenizer()[0]
    kw = dict(image_size=32, max_length=12, use_global=use_global, use_location=use_location)
    items = [(_image(s, i), _box(s, i), CAPTIONS[i]) for i, s in enumerate(SHAPES)]
    host = dataset.collate([preprocess.preprocess_sample(im, bb, c, tok, **kw) for im, bb, c in items])
    jhost = jdataset.collate([jpre.preprocess_sample(im, bb, c, jtok, **kw) for im, bb, c in items])
    for name in jhost._fields:
        g, w = getattr(host, name), getattr(jhost, name)
        if w is None:
            assert g is None, name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)

    got = pipeline.device_batch(host, torch.device("cpu"))
    want = jpipeline.device_batch(jhost)
    for name in ("images", "image_masks", "caps", "cap_masks", "global_images", "global_masks",
                 "loc_feats"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0, err_msg=name)
