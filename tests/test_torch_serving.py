"""The port's serving surface held against retr_tpu on the CPU.

- ``sequence_scores``: log-probs within 1e-5 of retr_tpu's, ``valid`` equal,
  and the fused attention kernel's plain version within 1e-5 of the plain path;
- ``greedy_with_attention``: ids equal, each map's key and shape equal, values
  within 1e-5; the maps come from the plain core (no fused-attention launch);
- ``greedy_decoding`` and ``greedy_single`` strings equal;
- Predictor: ``complete``, ``score`` (logprob within 1e-4, n_tokens equal),
  ``predict_with_attention`` (maps within 1e-5), ``decoder="sample"`` at
  temperature 0, and ``from_checkpoint`` on a reference ``.pth``, each equal to
  retr_tpu.predictor.Predictor's;
- ServingQueue and the HTTP server, as tests/test_predictor.py holds the JAX
  ones: batching equal to the synchronous API, error propagation, isolation of a
  bad request, reject after close, shedding with Retry-After, concurrent submit
  and close, 200 / 400 / 404 / 503, /healthz, the image_path allowlist.

f32 throughout, small configs (ResNet18, 32-64 px, 1-2 layers, hidden 64).
"""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retr_tpu import decode as jdecode
from retr_tpu import predictor as jpredictor
from retr_tpu.config import Config as JaxConfig
from retr_tpu.data.tokenizer import prepare_tokenizer as jax_prepare_tokenizer
from retr_tpu.masking import Masked as JMasked
from retr_tpu.models import caption as jcaption
from retr_tpu_torch import decode
from retr_tpu_torch import predictor as tpredictor
from retr_tpu_torch.config import Config
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import weights
from retr_tpu_torch.ops import decoder_kernels as dk
from retr_tpu_torch.predictor import Predictor, ServingOverloaded, ServingQueue
from retr_tpu_torch.serve import run_in_thread

TINY = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=2,
            dim_feedforward=128, vocab_size=96, max_position_embeddings=16, dropout=0.0, image_size=32)
BOS, EOS = 1, 6
ATT_KEYS = {"enc_tc_self_att", "dec_exp_self_att", "dec_exp_tc_cross_att"}


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JaxConfig(**TINY), Config(**TINY)
    params, _ = jcaption.build_model(jcfg, jax.random.key(1))
    rng = np.random.default_rng(1)
    img = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    mask = np.zeros((4, 32, 32), bool)
    mask[1, :, 20:] = True
    tp = weights.to_params(weights.to_state_dict(jax.tree.map(np.asarray, params), cfg), cfg, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, params=params, tp=tp,
                samples=Masked(torch.from_numpy(img), torch.from_numpy(mask)),
                jsamples=JMasked(jnp.asarray(img), jnp.asarray(mask)))


def _captions(rng, b=4, t=16):
    caps = rng.integers(7, 96, (b, t)).astype(np.int32)
    caps[:, 0] = BOS
    lens = np.array([t, 9, 5, 12])[:b]
    masks = np.arange(t)[None, :] >= lens[:, None]
    caps[masks] = 0
    return caps, masks


def test_sequence_scores_equal_reference(model):
    caps, masks = _captions(np.random.default_rng(2))
    want_lp, want_v = jdecode.sequence_scores(model["params"], model["jcfg"], model["jsamples"],
                                              jnp.asarray(caps), jnp.asarray(masks))
    got_lp, got_v = decode.sequence_scores(model["tp"], model["cfg"], model["samples"], torch.from_numpy(caps),
                                           torch.from_numpy(masks))
    assert got_lp.shape == (4, 15) and got_lp.dtype == torch.float32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-5, rtol=0)

    dk.reset_launches()
    fused_lp, fused_v = decode.sequence_scores(model["tp"], model["cfg"].replace(use_pallas_attention=True),
                                               model["samples"], torch.from_numpy(caps), torch.from_numpy(masks))
    assert dk.LAUNCHES["fused_attention"] == 0          # the CPU runs the kernel's plain version
    np.testing.assert_array_equal(fused_v.numpy(), got_v.numpy())
    np.testing.assert_allclose(fused_lp.numpy(), got_lp.numpy(), atol=1e-5, rtol=0)


def test_greedy_with_attention_equals_reference(model, monkeypatch):
    kw = dict(max_len=16, bos_token=BOS, eos_token=EOS)
    want_ids, want_atts = jdecode.greedy_with_attention(model["params"], model["jcfg"], model["jsamples"], **kw)
    called = []
    real = decode.caption.forward
    monkeypatch.setattr(decode.caption, "forward",
                        lambda *a, **k: called.append(k.get("return_attention")) or real(*a, **k))
    cfg = model["cfg"].replace(use_pallas_attention=True)       # maps turn the kernel off for the call
    monkeypatch.setattr("retr_tpu_torch.ops.attention.attention",
                        lambda *a, **k: pytest.fail("the attention-map path reached the fused attention"))
    ids, atts = decode.greedy_with_attention(model["tp"], cfg, model["samples"], **kw)
    assert called == [True]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    assert set(atts) == set(want_atts) == ATT_KEYS
    s = atts["enc_tc_self_att"].shape[-1]
    assert atts["enc_tc_self_att"].shape == (1, 4, s, s)
    assert atts["dec_exp_self_att"].shape == (2, 4, 16, 16)
    assert atts["dec_exp_tc_cross_att"].shape == (2, 4, 16, s)
    for k in ATT_KEYS:
        assert atts[k].shape == want_atts[k].shape, k
        np.testing.assert_allclose(atts[k].numpy(), np.asarray(want_atts[k]), atol=1e-5, rtol=0, err_msg=k)


def test_greedy_strings_equal_reference(model):
    jtok, _, _ = jax_prepare_tokenizer()
    tok, _, _ = prepare_tokenizer()
    kw = dict(max_len=16, bos_token=BOS, eos_token=EOS)
    want = jdecode.greedy_decoding(model["jsamples"], model["params"], model["jcfg"], jtok, **kw)
    assert decode.greedy_decoding(model["samples"], model["tp"], model["cfg"], tok, **kw) == want
    one = Masked(model["samples"].tensors[2:3], model["samples"].mask[2:3])
    jone = JMasked(model["jsamples"].tensors[2:3], model["jsamples"].mask[2:3])
    want_one = jdecode.greedy_single(model["params"], model["jcfg"], jone, jtok, **kw)
    assert decode.greedy_single(model["tp"], model["cfg"], one, tok, **kw) == want_one


# ---------------------------------------------------------------------------------
# Predictor
# ---------------------------------------------------------------------------------

PRED_CFG = dict(TINY, dec_layers=1, max_position_embeddings=12, image_size=64)


def _pair(**cfg_kw):
    """retr_tpu's and the port's Predictor on the same seeded weights."""
    jtok, _, _ = jax_prepare_tokenizer()
    tok, _, _ = prepare_tokenizer()
    kw = {**PRED_CFG, "vocab_size": jtok.vocab_size, **cfg_kw}
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    params, _ = jcaption.build_model(jcfg, jax.random.key(0))
    sd = weights.to_state_dict(jax.tree.map(np.asarray, params), cfg)
    return (jpredictor.Predictor(params, jcfg, jtok, max_batch=2),
            Predictor(sd, cfg, tok, max_batch=2, device="cpu"))


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def port():
    """The port's Predictor alone, for the queue and the server."""
    return _pair()[1]


def _requests(n, seed=5):
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, 256, (60 + 10 * i, 80, 3), dtype=np.uint8) for i in range(n)],
            [[5, 5, 30 + i, 25] for i in range(n)])


def test_predictor_complete_equals_reference(pair):
    jpred, pred = pair
    imgs, boxes = _requests(2)
    for prefix in ("red dog", "the woman on the left", ""):
        want = jpred.complete(imgs[0], boxes[0], prefix)
        assert pred.complete(imgs[0], boxes[0], prefix) == want
    assert pred.complete(imgs[1], boxes[1], "red dog").startswith("red dog")


def test_predictor_score_equals_reference(pair):
    jpred, pred = pair
    imgs, boxes = _requests(3)
    texts = ["red dog", "the woman on the left holding a hat", "chair"]
    want = jpred.score(imgs, boxes, texts)
    got = pred.score(imgs, boxes, texts)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g["n_tokens"] == w["n_tokens"]
        assert abs(g["logprob"] - w["logprob"]) <= 1e-4
        assert abs(g["ppl"] - w["ppl"]) <= 1e-4 * w["ppl"]


def test_predictor_predict_with_attention_equals_reference(pair):
    jpred, pred = pair
    imgs, boxes = _requests(1)
    want_text, want = jpred.predict_with_attention(imgs[0], boxes[0])
    text, atts = pred.predict_with_attention(imgs[0], boxes[0])
    assert text == want_text
    assert set(atts) == set(want) == ATT_KEYS
    for k in ATT_KEYS:
        assert isinstance(atts[k], np.ndarray) and atts[k].shape == want[k].shape, k
        np.testing.assert_allclose(atts[k], want[k], atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_allclose(atts["dec_exp_tc_cross_att"].sum(-1), 1.0, atol=1e-4)


def test_predictor_sample_equals_reference_at_temperature_zero():
    jpred, pred = _pair(sample_temperature=0.0)
    imgs, boxes = _requests(3)
    want = jpred.predict_batch(imgs, boxes)
    assert jpred.predict_batch(imgs, boxes, decoder="sample") == want
    assert pred.predict_batch(imgs, boxes, decoder="sample") == want
    with pytest.raises(ValueError, match="unknown decoder"):
        pred.predict(imgs[0], boxes[0], decoder="nope")


def test_predictor_sample_is_deterministic_per_seed():
    _, pred = _pair(sample_temperature=1.0, sample_top_k=8)
    imgs, boxes = _requests(3)
    a = pred.predict_batch(imgs, boxes, decoder="sample", seed=7)
    assert pred.predict_batch(imgs, boxes, decoder="sample", seed=7) == a
    assert all(isinstance(t, str) for t in a)


@pytest.mark.parametrize("name,loc,glob", [("Concat_refcoco_checkpoint_3.pth", False, False),
                                           ("Concat_loc_checkpoint_3.pth", True, False)])
def test_from_checkpoint_pth_equals_reference(tmp_path, monkeypatch, name, loc, glob):
    """A reference .pth (model_state_dict in the reference's names) loads into
    both packages with the variant read from the file name; the base config
    of both (``Config()``, full width) is swapped for the tiny one here."""
    jtok, _, _ = jax_prepare_tokenizer()
    tok, _, _ = prepare_tokenizer()
    kw = {**PRED_CFG, "vocab_size": jtok.vocab_size}
    cfg = Config(**{**kw, "use_location_features": loc, "use_global_features": glob})
    torch.manual_seed(3)
    path = str(tmp_path / name)
    torch.save({"model_state_dict": weights.reference_module(cfg).state_dict(), "epoch": 3}, path)
    monkeypatch.setattr(jpredictor, "Config", lambda: JaxConfig(**kw))
    monkeypatch.setattr(tpredictor, "Config", lambda: Config(**kw))
    jpred = jpredictor.Predictor.from_checkpoint(path, tokenizer=jtok, max_batch=2)
    pred = Predictor.from_checkpoint(path, tokenizer=tok, max_batch=2, device="cpu")
    assert pred.cfg.use_location_features is loc and pred.cfg == cfg
    imgs, boxes = _requests(3)
    assert pred.predict_batch(imgs, boxes) == jpred.predict_batch(imgs, boxes)


def test_from_checkpoint_directory_is_not_ported(tmp_path):
    """A directory is read as a checkpoint of retr_tpu_torch.main (tests/test_torch_main.py);
    one without its retr_metadata.json is refused."""
    (tmp_path / "Concat_refcoco_checkpoint_7").mkdir()
    with pytest.raises(FileNotFoundError, match="retr_metadata.json"):
        Predictor.from_checkpoint(str(tmp_path / "Concat_refcoco_checkpoint_7"), device="cpu")


# ---------------------------------------------------------------------------------
# ServingQueue
# ---------------------------------------------------------------------------------


def _img(seed=0, shape=(60, 60, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_serving_queue_batches_and_matches_sync(port):
    """More requests than one batch holds, so coalescing and re-dispatch both run."""
    imgs, boxes = _requests(5)
    want = port.predict_batch(imgs, boxes)
    q = ServingQueue(port, max_wait_s=0.05)
    futs = [q.submit(im, bb) for im, bb in zip(imgs, boxes)]
    got = [f.result(timeout=120) for f in futs]
    q.close()
    assert got == want
    st = q.stats()
    assert st["accepted"] == 5 and st["rejected"] == 0 and st["queued"] == 0


def test_serving_queue_sample_decoder_matches_sync():
    """decoder='sample' at temperature 0 through the queue equals greedy."""
    _, pred = _pair(sample_temperature=0.0)
    imgs, boxes = _requests(3)
    q = ServingQueue(pred, max_wait_s=0.05, decoder="sample")
    got = [f.result(timeout=120) for f in [q.submit(im, bb) for im, bb in zip(imgs, boxes)]]
    q.close()
    assert got == pred.predict_batch(imgs, boxes)


def test_serving_queue_propagates_errors(port):
    q = ServingQueue(port, max_wait_s=0.01)
    fut = q.submit(_img(), "not-a-bbox")
    with pytest.raises(Exception):
        fut.result(timeout=120)
    q.close()


def test_serving_queue_isolates_bad_request(port):
    """One malformed request batched with good ones fails only its own future."""
    img, bb = _img(), [5, 5, 30, 30]
    want = port.predict(img, bb)
    q = ServingQueue(port, max_wait_s=0.3)  # a long window: the three coalesce
    bad = q.submit(img, "not-a-bbox")
    good = [q.submit(img, bb) for _ in range(2)]
    results = [f.result(timeout=120) for f in good]
    with pytest.raises(Exception):
        bad.result(timeout=120)
    q.close()
    assert results == [want, want]


def test_serving_queue_rejects_after_close(port):
    q = ServingQueue(port)
    q.close()
    with pytest.raises(RuntimeError, match="closed"):
        q.submit(_img(), [1, 1, 10, 10])


def test_serving_queue_sheds_when_full(port, monkeypatch):
    """With the dispatcher held and ``max_queued`` requests standing, the next
    submit raises ServingOverloaded at once with a positive Retry-After; all
    that was admitted resolves once the dispatcher runs again."""
    img, bb = _img(), [5, 5, 30, 30]
    release, entered = threading.Event(), threading.Event()
    orig = port._preprocess_one

    def slow(image, bbox):
        entered.set()
        release.wait(60)
        return orig(image, bbox)

    monkeypatch.setattr(port, "_preprocess_one", slow)
    q = ServingQueue(port, max_wait_s=0.01, max_queued=2)
    first = q.submit(img, bb)
    assert entered.wait(30)  # the dispatcher holds request 1; the queue is empty again
    queued = [q.submit(img, bb) for _ in range(2)]
    with pytest.raises(ServingOverloaded) as ei:
        q.submit(img, bb)
    assert ei.value.retry_after_s > 0
    st = q.stats()
    assert st["rejected"] == 1 and st["accepted"] == 3 and st["max_queued"] == 2
    release.set()
    results = [f.result(timeout=120) for f in [first] + queued]
    q.close()
    assert all(isinstance(r, str) for r in results)
    assert q.stats()["queued"] == 0


def test_serving_queue_concurrent_submit_and_close(port):
    """Threads submitting while the queue closes (switch interval shortened):
    every accepted future resolves, with a result or the closed-queue error,
    and both workers end."""
    import sys

    q = ServingQueue(port, max_wait_s=0.01)
    img = _img()
    futs, rejected = [], []
    lock = threading.Lock()

    def submitter():
        for _ in range(4):
            try:
                f = q.submit(img, [5, 5, 30, 30])
                with lock:
                    futs.append(f)
            except RuntimeError:
                with lock:
                    rejected.append(1)
            time.sleep(0.002)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter) for _ in range(12)]
        for t in threads:
            t.start()
        time.sleep(0.02)
        q.close(wait=False)
        for t in threads:
            t.join(timeout=60)
        q._dispatcher.join(timeout=300)
        q._collector.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not q._dispatcher.is_alive() and not q._collector.is_alive()
    assert len(futs) + len(rejected) == 48 and futs
    assert all(f.done() for f in futs)
    assert sum(f.exception() is None for f in futs) >= 1


# ---------------------------------------------------------------------------------
# HTTP server
# ---------------------------------------------------------------------------------


def _png_payload(img, bbox):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return {"image": base64.b64encode(buf.getvalue()).decode(), "bbox": bbox}


def _post(base, body, path="/predict"):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return 200, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return 200, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_serving_endpoint(port):
    """POST /predict equals the synchronous API under concurrent clients; a bad
    request gets 400 and the server stays up; unknown paths 404; /healthz
    names the device."""
    img, bbox = _img(1, (70, 80, 3)), [5, 5, 40, 30]
    want = port.predict(img, bbox)
    q = ServingQueue(port, max_wait_s=0.02)
    server, base = run_in_thread(q)
    try:
        code, health = _get(base, "/healthz")
        assert code == 200 and health["ok"] is True and health["device"] == "cpu"
        payload = _png_payload(img, bbox)
        with ThreadPoolExecutor(3) as pool:
            got = list(pool.map(lambda _: _post(base, payload), range(3)))
        assert [(c, b["expression"]) for c, b, _ in got] == [(200, want)] * 3
        code, body, _ = _post(base, b'{"bbox": [1,2,3,4]}')
        assert code == 400 and body == {"error": "ValueError"}
        assert _post(base, payload, "/nope")[0] == 404
        assert _get(base, "/nope")[0] == 404
        code, health = _get(base, "/healthz")
        assert code == 200 and health["queue"]["accepted"] == 3
    finally:
        server.shutdown()
        server.server_close()
        q.close()


def test_http_serving_503_on_overload(port):
    """ServingOverloaded becomes 503 with a Retry-After header and
    ``retry_after_s`` in the body; the server survives the shed."""
    q = ServingQueue(port, max_wait_s=0.02, max_queued=0)   # sheds every submit
    server, base = run_in_thread(q)
    try:
        code, body, headers = _post(base, _png_payload(_img(1, (70, 80, 3)), [5, 5, 40, 30]))
        assert code == 503
        assert int(headers["Retry-After"]) >= 1
        assert body["error"] == "overloaded" and body["retry_after_s"] > 0
        code, health = _get(base, "/healthz")
        assert code == 200 and health["queue"]["rejected"] >= 1
    finally:
        server.shutdown()
        server.server_close()
        q.close()


def test_http_image_path_allowlist(port, tmp_path):
    """'image_path' is refused without an allowlist root; with one, only paths
    inside it resolve, and a refusal's body does not echo the path."""
    from PIL import Image

    img, bbox = _img(2, (70, 80, 3)), [5, 5, 40, 30]
    Image.fromarray(img).save(tmp_path / "ok.png")
    want = port.predict(img, bbox)

    q1 = ServingQueue(port, max_wait_s=0.02)
    server1, base1 = run_in_thread(q1)
    try:
        code, body, _ = _post(base1, {"image_path": str(tmp_path / "ok.png"), "bbox": bbox})
        assert code == 400 and str(tmp_path) not in json.dumps(body)
    finally:
        server1.shutdown()
        server1.server_close()
        q1.close()

    q2 = ServingQueue(port, max_wait_s=0.02)
    server2, base2 = run_in_thread(q2, image_root=str(tmp_path))
    try:
        code, body, _ = _post(base2, {"image_path": "ok.png", "bbox": bbox})
        assert code == 200 and body["expression"] == want
        code, body, _ = _post(base2, {"image_path": "../../etc/passwd", "bbox": bbox})
        assert code == 400 and "passwd" not in json.dumps(body)
    finally:
        server2.shutdown()
        server2.server_close()
        q2.close()
