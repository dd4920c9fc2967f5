"""The LM decoder (``Config.decoder_kind == "lm"``, models/lm.py) held against
the plain float32 reference of tests/lm_oracle.py on the CPU, at a tiny size:
hidden 64, one dense layer and two MoE layers, 4 heads, kv_lora 16, rope 4,
8 routed experts, top-2, 1 shared, vocabulary 256; RE:TR's CaptionGlobalLoc
encoder (ResNet-18 at 64 px, width 32) in front.

- teacher-forced logits within 1e-4 of max(1, |ref|) (float32 sums in
  another order; the grouped expert products against the expert loop);
- prefill + cached greedy decode (the absorbed form): every step's logits
  against the reference's full forward at that position, and the loop's
  tokens equal to ``decode.greedy``'s;
- the correction bias selects and does not weigh;
- the cache holds (kv_lora_rank + qk_rope_head_dim) x itemsize bytes a
  position and layer;
- ``eval_model``, ``Predictor.predict_batch`` and ``ServingQueue`` give
  ``decode.greedy``'s captions; sampling at top-k 1 and a prefix of length 0
  give greedy's;
- where the tracer records, a batch counts its routed pairs and its busiest
  [layer, expert] over the mean (``moe.*``);
- ``Config`` round-trips; beam search, training and meshes raise
  ``NotImplementedError``.
"""

import os
import sys

import pytest
import torch

from retr_tpu_torch import decode, engine
from retr_tpu_torch.config import Config
from retr_tpu_torch.data import dataset
from retr_tpu_torch.data.pipeline import device_batch
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import caption, lm, weights
from retr_tpu_torch.predictor import Predictor, ServingQueue

# the oracles and the fixture by path: on a machine where another installed
# package is named "tests", ``from tests import ...`` finds that one
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import lm_oracle  # noqa: E402
import torch_oracle  # noqa: E402
from synth_refcoco import make_synth_refcoco  # noqa: E402

BOS, EOS = 101, 102
LM = dict(decoder_kind="lm", lm_hidden_size=64, lm_layers=3, lm_heads=4, lm_kv_lora_rank=16,
          lm_qk_nope_head_dim=8, lm_qk_rope_head_dim=4, lm_v_head_dim=8, lm_intermediate_size=96,
          lm_moe_intermediate_size=32, lm_n_routed_experts=8, lm_n_shared_experts=1, lm_num_experts_per_tok=2,
          lm_first_k_dense_replace=1, lm_rope_theta=10000.0)
ENC = dict(backbone="ResNet18", dilation=False, hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
           dim_feedforward=64, vocab_size=256, max_position_embeddings=8, dropout=0.0, image_size=64,
           use_global_features=True, use_location_features=True, verbose=False)
ENCODER_KEYS = ("backbone.", "input_proj.", "loc_proj.", "transformer.encoder.")


def _init_lm(model: torch.nn.Module, seed: int) -> None:
    """Seeded weights: matrices at 1/sqrt(fan-in), norms near 1, a correction
    bias of 0.2 spread (it moves the selection), the head's PAD/BOS/EOS rows 0."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.randn(p.shape, generator=gen)
            if name.endswith("e_score_correction_bias"):
                p.copy_(0.2 * draw)
            elif p.dim() >= 2:
                p.copy_(draw * p.shape[-1] ** -0.5)
            elif "norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.05 * draw)
            else:
                p.copy_(0.02 * draw)
        model.language_model.model.embed_tokens.weight.mul_(model.language_model.model.embed_tokens.weight.shape[1]
                                                            ** 0.5)
        model.language_model.lm_head.weight[[0, BOS, EOS]] = 0.0


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    cfg = Config(**ENC, **LM)
    enc = torch_oracle.CaptionModel("ResNet18", dilation=False, vocab=256, d=32, h=4, nenc=1, ndec=1, dff=64,
                                    max_pos=8, use_loc=True, use_global=True).eval()
    oracle = lm_oracle.LMOracle(cfg.to_dict()).eval()
    _init_lm(oracle, 3)
    sd = {k: v for k, v in enc.state_dict().items() if k.startswith(ENCODER_KEYS)}
    sd.update(oracle.state_dict())
    gen = torch.Generator().manual_seed(5)
    img, gimg = torch.randn((2, 3, 3, 64, 64), generator=gen)
    mask = torch.zeros((3, 64, 64), dtype=torch.bool)
    mask[1, :, 40:] = True
    gmask = torch.zeros_like(mask)
    gmask[2, 30:] = True
    loc = torch.rand((3, 5), generator=gen)
    with torch.no_grad():
        memory, mem_mask = lm_oracle.encoder_memory(enc, img, mask, gimg, gmask, loc)
    return dict(cfg=cfg, sd=sd, oracle=oracle, params=weights.to_params(sd, cfg, device="cpu"),
                inputs=(Masked(img, mask), Masked(gimg, gmask), loc), memory=memory, mem_mask=mem_mask)


def _close(got, want, tol=1e-4):
    assert torch.all((got - want).abs() <= tol * want.abs().clamp_min(1.0)), (got - want).abs().max()


def _encode(t):
    samples, g, loc = t["inputs"]
    return caption.encode(t["params"], t["cfg"], samples, global_samples=g, loc_feats=loc)


def test_encoder_memory_matches_the_reference(tiny):
    memory, mask, _ = _encode(tiny)
    assert torch.equal(mask, tiny["mem_mask"]) and tiny["mem_mask"].any()
    _close(memory, tiny["memory"])


def test_teacher_forced_logits_match_the_reference(tiny):
    tokens = torch.randint(103, 256, (3, 6), generator=torch.Generator().manual_seed(1))
    tokens[:, 0] = BOS
    want = tiny["oracle"](tiny["memory"], tiny["mem_mask"], tokens)
    with torch.no_grad():
        got = lm.forward(tiny["params"]["lm"], tiny["memory"], tiny["mem_mask"], tokens, tiny["cfg"])
    _close(got, want)


def test_prefill_and_cached_steps_match_the_full_forward(tiny):
    cfg, p = tiny["cfg"], tiny["params"]["lm"]
    memory, mem_mask = tiny["memory"], tiny["mem_mask"]
    b, s = mem_mask.shape
    state = lm.alloc_state(cfg, b, s, cfg.max_position_embeddings, torch.float32, "cpu")
    tokens = torch.full((b, 1), BOS)
    with torch.no_grad():
        lm.prefill(p, memory, mem_mask, cfg, state)
        for i in range(cfg.max_position_embeddings - 1):
            hs = lm.decode_step(p, state, tokens[:, i].int(), torch.tensor(i, dtype=torch.int32), s, cfg)
            got = lm.logits(p, hs)
            want = tiny["oracle"](memory, mem_mask, tokens)[:, i]
            _close(got, want)
            tokens = torch.cat([tokens, got.argmax(-1, keepdim=True)], 1)
    k, n_moe = cfg.lm_num_experts_per_tok, lm.moe_layers(cfg)
    # every MoE layer routes each step's rows; the last layer skips the prefix
    assert state.tally.sum() == b * s * k * (n_moe - 1) + b * (cfg.max_position_embeddings - 1) * k * n_moe
    samples, g, loc = tiny["inputs"]
    ids = decode.greedy(tiny["params"], cfg, samples, global_samples=g, loc_feats=loc,
                        max_len=cfg.max_position_embeddings, bos_token=BOS, eos_token=EOS)
    assert torch.equal(ids.long(), tokens)


def test_the_expert_counters_read_a_batchs_tally(tiny):
    """Where the tracer records, a batch counts its routed pairs
    (``moe.pairs``) and its busiest [layer, expert] over the mean
    (``moe.max_expert_tokens``), read from the tally after the loop."""
    from retr_tpu_torch.utils import profiling

    cfg, p = tiny["cfg"], tiny["params"]["lm"]
    memory, mem_mask = tiny["memory"], tiny["mem_mask"]
    b, s = mem_mask.shape
    samples, g, loc = tiny["inputs"]
    kw = dict(global_samples=g, loc_feats=loc, max_len=cfg.max_position_embeddings, bos_token=BOS, eos_token=EOS)
    ids = decode.greedy(tiny["params"], cfg, samples, **kw)
    state = lm.alloc_state(cfg, b, s, cfg.max_position_embeddings, torch.float32, "cpu")
    with torch.no_grad():
        lm.prefill(p, memory, mem_mask, cfg, state)
        for i in range(cfg.max_position_embeddings - 1):
            lm.decode_step(p, state, ids[:, i], torch.tensor(i, dtype=torch.int32), s, cfg)
    profiling.reset()
    profiling.enable()
    try:
        decode.greedy(tiny["params"], cfg, samples, **kw)
        decode.greedy(tiny["params"], cfg, samples, **kw)
        got = profiling.counters()
    finally:
        profiling.disable()
        profiling.reset()
    tally = state.tally.double()
    assert got["moe.pairs"] == 2 * int(tally.sum())
    assert got["moe.max_expert_tokens"] == pytest.approx(2 * float(tally.max() / tally.mean()), rel=1e-6)
    assert 1.0 < got["moe.max_expert_tokens"] / 2 <= cfg.lm_n_routed_experts


def test_the_correction_bias_selects_and_does_not_weigh(tiny):
    cfg = tiny["cfg"]
    moe_p = tiny["params"]["lm"]["layers"][1]["moe"]
    x = torch.randn((64, cfg.lm_hidden_size), generator=torch.Generator().manual_seed(2))
    idx, w = lm.route(moe_p, x, cfg)
    s = torch.sigmoid(x @ moe_p["router"].t())
    assert moe_p["bias"].abs().min() > 0
    plain = s.topk(cfg.lm_num_experts_per_tok, -1).indices
    assert (idx.sort(-1).values != plain.sort(-1).values).any()          # the bias moved a choice
    chosen = s.gather(1, idx)
    _close(w, chosen / chosen.sum(-1, keepdim=True) * cfg.lm_routed_scaling_factor, 1e-6)
    ref_idx, ref_w = tiny["oracle"].language_model.model.layers[1].mlp.route(x)
    assert torch.equal(idx, ref_idx)
    _close(w, ref_w, 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_cache_holds_the_latent_alone(tiny, dtype):
    cfg = tiny["cfg"]
    state = lm.alloc_state(cfg, 2, 13, 8, dtype, "cpu")
    per = state.cache[0, 0, 0].numel() * state.cache.element_size()
    assert per == (cfg.lm_kv_lora_rank + cfg.lm_qk_rope_head_dim) * torch.empty((), dtype=dtype).element_size()
    assert state.cache.shape == (cfg.lm_layers, 2, 24, cfg.lm_kv_lora_rank + cfg.lm_qk_rope_head_dim)   # 21 up to 8s


def test_sampling_at_top_k_1_and_an_empty_prefix_give_greedy(tiny):
    cfg = tiny["cfg"]
    samples, g, loc = tiny["inputs"]
    kw = dict(global_samples=g, loc_feats=loc, max_len=cfg.max_position_embeddings, bos_token=BOS, eos_token=EOS)
    ids = decode.greedy(tiny["params"], cfg, samples, **kw)
    sampled = decode.sample(tiny["params"], cfg, samples, torch.Generator().manual_seed(0), top_k=1, **kw)
    prefixed = decode.greedy_with_prefix(tiny["params"], cfg, samples, torch.zeros((3, 2), dtype=torch.int32),
                                         torch.zeros(3, dtype=torch.int32), **kw)
    assert torch.equal(ids, sampled) and torch.equal(ids, prefixed)


@pytest.fixture(scope="module")
def split(tiny, tmp_path_factory):
    coco_dir, ref_dir = make_synth_refcoco(str(tmp_path_factory.mktemp("lm")), n_images=12, sents_per_ann=2)
    tok = prepare_tokenizer()[0]
    cfg = tiny["cfg"].replace(dir=coco_dir, ref_dir=ref_dir, batch_size=2, num_workers=1)
    return cfg, tok


def test_eval_model_gives_decode_greedys_captions(tiny, split):
    cfg, tok = split
    loader = dataset.DataLoader(dataset.build_dataset(cfg, "validation", tokenizer=tok, return_unique=True), 2,
                                num_workers=1)
    _, hyps = engine.eval_model(tiny["params"], cfg, loader, tok)
    want = []
    for hb in loader:
        b = device_batch(hb, "cpu")
        ids = decode.greedy(tiny["params"], cfg, Masked(b.images, b.image_masks),
                            global_samples=Masked(b.global_images, b.global_masks), loc_feats=b.loc_feats,
                            max_len=cfg.max_position_embeddings, bos_token=BOS, eos_token=EOS)
        want += tok.batch_decode(decode.prune_token_ids(ids.tolist(), bos_token=BOS, eos_token=EOS))
    assert [h["expression"] for h in hyps] == want and len(want) == len(loader.dataset)


def test_predictor_and_serving_queue_give_decode_greedys_captions(tiny, split):
    cfg, tok = split
    pred = Predictor(tiny["sd"], cfg, tok, max_batch=4, device="cpu")
    gen = torch.Generator().manual_seed(4)
    images = [torch.randint(0, 256, (48 + 8 * i, 64, 3), generator=gen, dtype=torch.uint8).numpy() for i in range(5)]
    boxes = [[4.0, 6.0, 20.0 + i, 30.0] for i in range(5)]
    got = pred.predict_batch(images, boxes)
    want = []
    for i in range(0, 5, 4):
        b = pred._device_batch([pred._preprocess_one(im, bb) for im, bb in zip(images[i:i + 4], boxes[i:i + 4])])
        ids = decode.greedy(pred.params, cfg, Masked(b.images, b.image_masks),
                            global_samples=Masked(b.global_images, b.global_masks), loc_feats=b.loc_feats,
                            max_len=cfg.max_position_embeddings, bos_token=BOS, eos_token=EOS)
        want += tok.batch_decode(decode.prune_token_ids(ids.tolist()[:len(images[i:i + 4])], bos_token=BOS,
                                                        eos_token=EOS))
    assert got == want
    q = ServingQueue(pred, max_wait_s=0.05)
    served = [f.result(timeout=120) for f in [q.submit(im, bb) for im, bb in zip(images, boxes)]]
    q.close()
    assert served == want


def test_config_round_trips(tiny):
    cfg = tiny["cfg"]
    assert Config.from_json(cfg.to_json()) == cfg and cfg.to_dict()["lm_layers"] == 3
    plain = Config(**ENC)
    assert "decoder_kind" not in plain.to_dict() and Config.from_dict(plain.to_dict()) == plain
    with pytest.raises(ValueError):
        Config(**ENC, **{**LM, "lm_num_experts_per_tok": 9})
    with pytest.raises(ValueError):
        Config(decoder_kind="rnn")


def test_beam_training_and_meshes_raise(tiny, monkeypatch):
    from retr_tpu_torch.parallel import mesh as pmesh
    from retr_tpu_torch.train import state as tstate

    cfg = tiny["cfg"]
    samples, g, loc = tiny["inputs"]
    kw = dict(global_samples=g, loc_feats=loc, max_len=8, bos_token=BOS, eos_token=EOS)
    with pytest.raises(NotImplementedError, match="LM beam search"):
        decode.beam_search(tiny["params"], cfg, samples, **kw)
    for make in (lambda: tstate.make_train_step(cfg), lambda: tstate.make_eval_step(cfg),
                 lambda: tstate.create_train_state(cfg, tiny["params"], device="cpu"),
                 lambda: caption.init(torch.Generator(), cfg)):
        with pytest.raises(NotImplementedError, match="LM training"):
            make()
    with pytest.raises(NotImplementedError, match="LM training"):
        weights.to_state_dict(tiny["params"], cfg)
    monkeypatch.setattr(pmesh, "current", lambda: object())      # any active mesh
    with pytest.raises(NotImplementedError, match="LM under dp/mp"):
        decode.greedy(tiny["params"], cfg, samples, **kw)


@pytest.mark.cuda
def test_graph_decode_of_the_lm_equals_the_eager_loop(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tiny["cfg"].replace(compute_dtype="bfloat16")
    params = weights.to_params({k: v.cuda() for k, v in tiny["sd"].items()}, cfg, device="cuda")
    samples, g, loc = tiny["inputs"]
    kw = dict(global_samples=Masked(g.tensors.cuda(), g.mask.cuda()), loc_feats=loc.cuda(), max_len=8,
              bos_token=BOS, eos_token=EOS, compute_dtype=torch.bfloat16)
    s = Masked(samples.tensors.cuda(), samples.mask.cuda())
    decode.CUDA_GRAPHS = False
    try:
        eager = decode.greedy(params, cfg, s, **kw)
    finally:
        decode.CUDA_GRAPHS = True
    graphed = [decode.greedy(params, cfg, s, **kw) for _ in range(3)]
    assert all(torch.equal(eager, x) for x in graphed)
