"""The plain reference against the port at tiny sizes on the CPU, for both
variants (RE:TR's Caption and CaptionGlobalLoc): host preprocessing, the
teacher-forced logits, and whole runs of the three drivers, whose numbers
then come out near zero."""

import numpy as np
import pytest
import torch

from portbench import synth, weights
from portbench.reference import model as ref_model
from portbench.reference import preprocess as ref_pre
from portbench.tests import tiny

VARIANTS = pytest.mark.parametrize("globloc", [False, True], ids=["caption", "globloc"])


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        img = synth.make_image(i)
        out.append((img, synth.draw_box(rng, *img.shape[:2])))
    return out


@VARIANTS
def test_preprocessing_equals_the_ports(globloc):
    from retr_tpu_torch.data.preprocess import preprocess_sample
    from retr_tpu_torch.data.tokenizer import prepare_tokenizer

    tok = prepare_tokenizer("")[0]
    for img, box in _requests(4):
        port = preprocess_sample(img, box, "", tok, image_size=64, use_global=globloc, use_location=globloc)
        ref = ref_pre.sample(img, box, 64, globloc, globloc)
        np.testing.assert_array_equal(port.target_image, ref["img"])
        np.testing.assert_array_equal(port.target_mask, ref["mask"])
        if globloc:
            np.testing.assert_array_equal(port.context_image, ref["g_img"])
            np.testing.assert_array_equal(port.context_mask, ref["g_mask"])
            np.testing.assert_array_equal(port.loc_feats, ref["loc"])


@VARIANTS
def test_teacher_forced_logits_equal_the_ports(globloc):
    from retr_tpu_torch.config import Config
    from retr_tpu_torch.data.pipeline import finish_images
    from retr_tpu_torch.masking import Masked
    from retr_tpu_torch.models import caption
    from retr_tpu_torch.models import weights as port_weights

    mcfg = dict(tiny.TINY, use_global_features=globloc, use_location_features=globloc)
    cfg = Config.from_dict(mcfg)
    sd = weights.state_dict(mcfg, 7, "cpu", unreachable=weights.UNREACHABLE_IDS)
    params = port_weights.to_params(sd, cfg, device="cpu")
    samples = [ref_pre.sample(img, box, 64, globloc, globloc) for img, box in _requests(3, 1)]
    inp = ref_pre.batch(samples, "cpu")
    t = cfg.max_position_embeddings
    caps = torch.randint(104, mcfg["vocab_size"], (3, t))
    caps[:, 0] = 101
    pad = torch.zeros(3, t, dtype=torch.bool)
    u8 = torch.as_tensor(np.stack([s["img"] for s in samples]))
    g = Masked(finish_images(torch.as_tensor(np.stack([s["g_img"] for s in samples]))),
               inp["g_mask"]) if globloc else None
    port = caption.forward(params, cfg, Masked(finish_images(u8), inp["mask"]), caps, pad, global_samples=g,
                           loc_feats=inp.get("loc"))
    ref = ref_model.build(mcfg, sd, "cpu")(inp["img"], inp["mask"], caps, pad, g_img=inp.get("g_img"),
                                           g_mask=inp.get("g_mask"), loc=inp.get("loc"))
    torch.testing.assert_close(port, ref, rtol=1e-4, atol=1e-4)


def _execute(tmp_path, name, globloc=False, seconds=1.5):
    from portbench import run

    synth.POOL_IMAGES = 12
    root, bench = tiny.files(str(tmp_path / "files"), globloc=globloc)
    work = next(w for w in bench["workloads"] if w["name"] == name)
    return run.execute(work, bench, 2 ** 33 + 17, seconds, False, device="cpu", files=root,
                       checkout=str(tmp_path / "checkout"))


@pytest.fixture(autouse=True)
def _pool_size():
    full = synth.POOL_IMAGES
    yield
    synth.POOL_IMAGES = full


@pytest.mark.parametrize("name", ["tiny-sweep", "tiny-serve", "tiny-train"])
@VARIANTS
def test_a_run_on_the_cpu_is_correct(tmp_path, name, globloc):
    res = _execute(tmp_path, name, globloc)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["metrics"]["setup_s"]["value"] > 0
