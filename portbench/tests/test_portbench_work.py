"""The yardstick's operation and byte counts, against hand-worked values and
against PyTorch's own count of the plain reference's products, and the
readers' shares against the published peaks."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, weights, work
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.tests.tiny import TINY

R101 = harness.load_json(harness.HERE, "configs", "retr-r101.json")["config"]
GLOBLOC = harness.load_json(harness.HERE, "configs", "retr-r101-globloc.json")["config"]


def test_resnet101_dilated_at_224_by_hand():
    # stem 2*3*64*49*112^2 = 236,027,904; the counter's figure below is the sum
    # of every conv of torchvision's ResNet-101 with layer4 at 14 x 14
    assert work.backbone_flops("ResNet101", True, 224) == 19_837_583_360
    assert work.conv_flops(3, 64, 7, 112) == 236_027_904
    # undilated, layer4 runs at 7 x 7 and costs a quarter of its dilated work
    assert work.backbone_flops("ResNet101", False, 224) == 15_598_714_880


@pytest.mark.parametrize("name,side", [("ResNet18", 64), ("ResNet101", 224)])
def test_backbone_count_equals_torchs(name, side):
    with torch.device("meta"):
        m = ref_model.ResNet(name, True)
        with FlopCounterMode(display=False) as fc:
            m(torch.empty(1, 3, side, side))
    assert fc.get_total_flops() == work.backbone_flops(name, True, side)


def test_memory_tokens():
    assert work.memory_tokens(R101) == 196
    assert work.memory_tokens(GLOBLOC) == 397


@pytest.mark.parametrize("globloc", [False, True], ids=["caption", "globloc"])
def test_forward_and_training_counts_equal_torchs(globloc):
    cfg = dict(TINY, use_global_features=globloc, use_location_features=globloc)
    model = ref_model.build(cfg, weights.state_dict(cfg, 5, "cpu"), "cpu").train()
    ref_train.trained(model)
    b, t = 2, cfg["max_position_embeddings"]
    img, mask = torch.randn(b, 3, 64, 64), torch.zeros(b, 64, 64, dtype=torch.bool)
    caps, cap_mask = torch.randint(104, 400, (b, t)), torch.zeros(b, t, dtype=torch.bool)
    kw = dict(g_img=img.clone(), g_mask=mask.clone(), loc=torch.rand(b, 5)) if globloc else {}
    with FlopCounterMode(display=False) as fc:
        model(img, mask, caps, cap_mask, **kw)
    fwd = work._encode_flops(cfg) + work._decoder_full_flops(cfg, t) + work._head_flops(cfg, t)
    assert fc.get_total_flops() == b * fwd
    with FlopCounterMode(display=False) as fc:
        model(img, mask, caps, cap_mask, **kw).sum().backward()
    assert fc.get_total_flops() == b * work.train_sample_flops(cfg)


def test_caption_count_by_hand():
    """A KV-cached step t attends to t + 1 positions: the teacher-forced
    decoder's T x T products halve to T(T + 1)/2; everything else is the
    teacher-forced forward over 127 positions."""
    c, t, layers = 256, 127, 6
    full = work._encode_flops(R101) + work._decoder_full_flops(R101, t) + work._head_flops(R101, t)
    causal_saving = layers * 2 * 2 * c * (t * t - t * (t + 1) // 2)
    # the cross K/V is computed once per caption in both
    assert work.caption_flops(R101, t) == full - causal_saving
    assert 29.5e9 < work.caption_flops(R101) < 30.5e9


def test_stack_step_by_hand():
    # 512 rows, step 0, S 196, bf16: x in and y out 2*512*256*2; per layer the
    # weights (self: q/k/v/out 4*256^2, their biases 4*256, LN 2*256; cross:
    # q/out, their biases, 3*256 of norms; FF 2*256*2048, biases 2048 + 256,
    # LN 2*256), the slot written (2*512*8*32*2) and the cross K/V
    # (2*512*8*196*32*2); the f32 key bias 512*196*4 and the step counter
    nbytes, ops = work.stack_step_work(512, 0, 196)
    attn_w, cross_w, ff_w = 4 * 65536 + 4 * 256 + 512, 2 * 65536 + 256 + 256 + 768, 2 * 524288 + 2048 + 256 + 512
    per_layer = (attn_w + cross_w + ff_w) * 2 + 2 * 512 * 8 * 32 * 2 + 2 * 512 * 8 * 196 * 32 * 2
    assert nbytes == 2 * 512 * 256 * 2 + 6 * per_layer + 512 * 196 * 4 + 4
    assert ops == 6 * (2 * 512 * 4 * 65536 + 2 * 2 * 512 * 8 * 32
                       + 2 * 512 * 2 * 65536 + 2 * 2 * 512 * 8 * 196 * 32 + 2 * 512 * 2 * 256 * 2048)
    # the PERF.md table's 0.2496 ms bound at step 63 (bytes bound it)
    assert work.roofline_s(*work.stack_step_work(512, 63, 196), "bfloat16") == pytest.approx(0.2496e-3, rel=2e-3)


def _reader(name):
    return harness.load_module(f"{harness.HERE}/metrics/{name}.py", "m_" + name.replace(".", "_"))


def test_shares_reach_100_percent_only_at_the_peak():
    ctx = {"cfg": R101, "traffic": {"batch": 512}, "steps": 127}
    bound = work.stack_step_bound_s(512, 196)
    for launches, share in ((127, 100.0), (127, 50.0)):
        t = launches * bound * 100.0 / share
        prof = {"kernels": {"void stack_kernel<__nv_bfloat16>(StackArgs)": {"s": t, "count": launches}}}
        assert _reader("stack_step_roofline").read({**ctx, "profile": prof}) == pytest.approx(share)
    peak_rate = work.PEAK_FLOPS["bfloat16"] / work.caption_flops(R101)
    assert _reader("mfu.eval").read({**ctx, "e2e": {"captions_per_s": peak_rate}}) == pytest.approx(100.0)
    peak_rate = work.PEAK_FLOPS["float32"] / work.train_sample_flops(GLOBLOC)
    assert _reader("mfu.train").read({"cfg": GLOBLOC, "e2e": {"train_samples_per_s": peak_rate}}) == \
        pytest.approx(100.0)


def test_readers_return_nothing_without_a_profile():
    for name in ("idle_share.eval", "idle_share.serve", "idle_share.train", "stack_step_roofline"):
        assert _reader(name).read({"profile": None, "cfg": R101, "traffic": {"batch": 512}, "steps": 127}) is None
