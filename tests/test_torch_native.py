"""The port's native host core (retr_tpu_torch.native) on the CPU.

- images, masks, the batch API and the WordPiece encoder are bit-equal to the
  port's numpy and Python spec and to retr_tpu.native on the same inputs;
- ``preprocess_sample`` and ``encode_plus`` go through the core, and give what
  the spec gives;
- six processes loading a fresh build directory at once all succeed;
- where the library is unavailable the spec runs and the first fallback is
  logged; a failure inside a call raises.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from retr_tpu import native as jnative
from retr_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from retr_tpu_torch import native
from retr_tpu_torch.data import preprocess
from retr_tpu_torch.data.tokenizer import DEFAULT_TEST_WORDS, WordPieceTokenizer
from retr_tpu_torch.ops import image as imops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ref_native(monkeypatch):
    """retr_tpu.native, loaded again where its first load in this process
    failed: its loader builds straight to the library's final name, so a
    process that loaded while another was writing it records a failure for
    good (ROADMAP S1). By the time tests run every such build has ended."""
    if jnative.load() is None:
        monkeypatch.setattr(jnative, "_tried", False)
    if jnative.load_tokenizer_lib() is None:
        monkeypatch.setattr(jnative, "_tok_tried", False)
    assert jnative.load() is not None and jnative.load_tokenizer_lib() is not None
    return jnative


def _spec_image(img, out):
    return imops.pil_resize_uint8(imops.pad_uint8_to_square(img), out, out)


def _spec_mask(mask, out):
    sq = imops.pad_mask_to_square(mask)
    w = imops.torch_bilinear_weights(sq.shape[0], out)
    return (w @ sq.astype(np.float64) @ w.T) != 0.0


@pytest.mark.parametrize("shape", [(64, 48, 3), (48, 64, 3), (37, 123, 3), (224, 224, 3), (260, 180, 3),
                                   (50, 70, 1)])
def test_image_bit_equal_to_spec_and_reference(ref_native, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    got = native.pad_resize_image(img, 224)
    assert got.shape == (224, 224, shape[2]) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _spec_image(img, 224))
    np.testing.assert_array_equal(got, ref_native.pad_resize_image(img, 224))


@pytest.mark.parametrize("shape", [(64, 48), (48, 64), (50, 50), (123, 37)])
def test_mask_bit_equal_to_spec_and_reference(ref_native, shape):
    mask = np.random.default_rng(shape[0]).random(shape) > 0.8
    got = native.pad_resize_mask(mask, 14)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, _spec_mask(mask, 14))
    np.testing.assert_array_equal(got, ref_native.pad_resize_mask(mask, 14))


def test_batch_equal_to_single_and_reference(ref_native):
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (rng.integers(40, 120), rng.integers(40, 120), 3), dtype=np.uint8)
              for _ in range(6)]
    got = native.pad_resize_image_batch(images, 64, n_threads=3)
    np.testing.assert_array_equal(got, ref_native.pad_resize_image_batch(images, 64, n_threads=3))
    for i, im in enumerate(images):
        np.testing.assert_array_equal(got[i], _spec_image(im, 64))


TEXTS = ["Hello, WORLD!", "the RED dog runs... fast?", "tokenization tokenization's",
         "a b c d e f g h i j k l m n o p", "", "!!!", "word\twith\ttabs and  spaces", "man\x0bleft\x0cof"]


def _python_ids(tok, text, n):
    ids = tok.encode(text, max_length=n)
    return ids + [tok.vocab[tok.PAD]] * (n - len(ids))


def test_wordpiece_equal_to_spec_and_reference(ref_native, tmp_path):
    words = ["hello", "world", "tokenization", "running", "dog", "red", "man", "left"]
    tok = WordPieceTokenizer.synthetic(words)
    nat = tok._native_encoder()
    assert isinstance(nat, native.NativeWordPiece)
    vocab_file = tmp_path / "vocab.txt"
    vocab_file.write_text("".join(tok.ids_to_tokens.get(i, f"[slot{i}]") + "\n" for i in range(tok.vocab_size)))
    ref = ref_native.NativeWordPiece(str(vocab_file))
    for text in TEXTS:
        ids, n = nat.encode(text, 12)
        assert ids.tolist() == _python_ids(tok, text, 12), text
        want_ids, want_n = ref.encode(text, 12)
        assert ids.tolist() == want_ids.tolist() and n == want_n, text
    out, lengths = nat.encode_batch(TEXTS * 3, 10, n_threads=3)
    want_out, want_len = ref.encode_batch(TEXTS * 3, 10, n_threads=3)
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_array_equal(lengths, want_len)


def test_encode_plus_through_the_core_equals_spec_and_reference():
    tok = WordPieceTokenizer.synthetic(DEFAULT_TEST_WORDS)
    spec = WordPieceTokenizer(tok.vocab)
    spec._native = False
    jtok = JaxWordPiece.synthetic(DEFAULT_TEST_WORDS)
    for text in TEXTS + ["The man on the left wearing a red hat"]:
        got = tok.encode_plus(text, max_length=16)
        assert got == spec.encode_plus(text, max_length=16) == jtok.encode_plus(text, max_length=16), text
    assert isinstance(tok._native, native.NativeWordPiece)


@pytest.mark.parametrize("use_global", [False, True])
def test_preprocess_sample_through_the_core_equals_spec(monkeypatch, use_global):
    tok = WordPieceTokenizer.synthetic(DEFAULT_TEST_WORDS)
    img = np.random.default_rng(4).integers(0, 256, (90, 130, 3), dtype=np.uint8)
    kw = dict(image_size=64, max_length=12, use_global=use_global, use_location=use_global)
    calls = []
    real = native.pad_resize_image
    monkeypatch.setattr(native, "pad_resize_image", lambda *a: calls.append(1) or real(*a))
    got = preprocess.preprocess_sample(img, [10, 12, 50.4, 41.6], "the red dog", tok, **kw)
    assert len(calls) == (2 if use_global else 1)
    monkeypatch.setattr(native, "available", lambda name="preprocess": False)
    want = preprocess.preprocess_sample(img, [10, 12, 50.4, 41.6], "the red dog", tok, **kw)
    for a, b in zip(got, want):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


def test_unavailable_library_falls_back_to_the_spec_and_logs_once(monkeypatch, caplog):
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_failed", {"preprocess": "g++ not found", "tokenizer": "g++ not found"})
    monkeypatch.setattr(native, "_warned", False)
    with pytest.raises(native.Unavailable):
        native.load("preprocess")
    img = np.random.default_rng(5).integers(0, 256, (40, 70, 3), dtype=np.uint8)
    tok = WordPieceTokenizer.synthetic(DEFAULT_TEST_WORDS)
    with caplog.at_level(logging.WARNING, logger="retr_tpu_torch.native"):
        for _ in range(3):
            s = preprocess.preprocess_sample(img, [5, 5, 30, 20], "the dog", tok, image_size=32, max_length=8)
            np.testing.assert_array_equal(s.target_image, _spec_image(img[5:25, 5:35], 32))
    assert tok._native is False
    assert [r.message for r in caplog.records].count(caplog.records[0].message) == 1
    assert "unavailable" in caplog.records[0].message


def test_failures_inside_a_call_raise():
    """Only an unavailable library is swallowed: a vocabulary that cannot be
    read, or an input the core refuses, raises."""
    tok = WordPieceTokenizer(WordPieceTokenizer.synthetic(["dog"]).vocab, vocab_path="/nonexistent/vocab.txt")
    with pytest.raises(RuntimeError, match="vocabulary"):
        tok.encode_plus("the dog", max_length=8)
    with pytest.raises(RuntimeError, match="retr_pad_resize_image"):
        native.pad_resize_image(np.zeros((0, 5, 3), np.uint8), 16)
    with pytest.raises(ValueError):
        native.pad_resize_mask(np.zeros((4, 4, 1), bool), 16)


def test_concurrent_first_loads_all_succeed(tmp_path):
    """Six processes build and load both libraries into one fresh directory at
    once (each writes a temporary file and renames it): all must succeed and
    agree with the spec."""
    go = tmp_path / "go"
    code = (
        "import os, sys, time\n"
        "import numpy as np\n"
        "from retr_tpu_torch import native\n"
        f"native.BUILD_DIR = {str(tmp_path / 'build')!r}\n"
        f"while not os.path.exists({str(go)!r}):\n"
        "    time.sleep(0.005)\n"
        "img = np.arange(30 * 20 * 3, dtype=np.uint8).reshape(30, 20, 3)\n"
        "out = native.pad_resize_image(img, 16)\n"
        "tok = native.load('tokenizer')\n"
        "print(int(out.astype(np.int64).sum()))\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    go.touch()
    results = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [err for _, err in results]
    img = np.arange(30 * 20 * 3, dtype=np.uint8).reshape(30, 20, 3)
    want = int(_spec_image(img, 16).astype(np.int64).sum())
    assert [int(out) for out, _ in results] == [want] * 6
    assert sorted(p.name.split("-")[0] for p in (tmp_path / "build").iterdir()) == \
        ["libretr_preprocess", "libretr_tokenizer"]
