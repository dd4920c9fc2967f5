"""Set-up and judging that the drivers share."""

from __future__ import annotations

import gc
import os

import numpy as np
import torch

from portbench import synth, weights
from portbench.reference import judge, model as ref_model, preprocess as ref_pre

NLG_METRICS = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"]


class Cell:
    """The program's configuration, weights and vocabulary for one run.

    ``config``: the configuration file's dict; ``traffic``: the traffic
    file's; ``scratch``: this run's directory under TMPDIR; ``checkout``: where
    the image pool is cached."""

    def __init__(self, config: dict, traffic: dict, seed: int, *, device: str, scratch: str, checkout: str):
        from retr_tpu_torch.config import Config

        self.model_cfg = dict(config["config"])
        self.traffic, self.seed, self.device, self.scratch = traffic, int(seed), device, scratch
        self.vocab_file = synth.write_vocab(os.path.join(scratch, "vocab.txt"), self.model_cfg["vocab_size"])
        self.coco = synth.ensure_pool(checkout)
        self.cfg = Config.from_dict({**self.model_cfg, "vocab_file": self.vocab_file, "dir": self.coco,
                                     "project_data_path": scratch, "seed": self.seed % (1 << 31)})

    def state_dict(self, *, decode: bool) -> dict:
        """The seed's weights on the device; ``decode`` makes PAD, BOS and EOS
        unreachable (every row runs all its steps)."""
        return weights.state_dict(self.model_cfg, self.seed, self.device,
                                  unreachable=weights.UNREACHABLE_IDS if decode else ())

    def tokenizer(self):
        from retr_tpu_torch.data.tokenizer import prepare_tokenizer

        return prepare_tokenizer(self.vocab_file)[0]


def release() -> None:
    """Drop the program's graph sessions and cached blocks before the reference runs."""
    from retr_tpu_torch.ops import graphs

    graphs.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def draw_sample(n_total: int, n: int, seed: int) -> list:
    """``n`` distinct indices of ``n_total`` drawn from the seed, in order."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 9])
    return sorted(rng.choice(n_total, min(n, n_total), replace=False).tolist())


def served_ids(texts, steps: int) -> tuple:
    """Served strings -> ([N, steps] int64 ids, how many strings do not read back
    as ``steps`` known tokens). A string that does not is judged as fully wrong:
    its ids are -1, so it is never a sample's valid answer."""
    rows, bad = [], 0
    for text in texts:
        ids = synth.parse(text)
        if len(ids) != steps or min(ids, default=-1) < 0:
            bad += 1
            ids = [-1] * steps
        rows.append(ids)
    return torch.tensor(rows, dtype=torch.int64), bad


def judge_captions(model_cfg: dict, state_dict: dict, requests, texts, *, bos: int, steps: int,
                   device, image_side: int, control: bool = False) -> dict:
    """Hold served captions to the reference. ``requests``: (image array,
    box) per caption; ``texts``: the served strings. Returns {"token_gap": the
    widest gap of a served token among the readable strings, "unreadable":
    strings that are not ``steps`` known tokens}, and with ``control`` also "control_gap"."""
    ids, bad = served_ids(texts, steps)
    keep = [i for i in range(len(texts)) if ids[i, 0] >= 0]
    out = {"unreadable": bad, "token_gap": 0.0}
    if not keep:
        return out
    ref = ref_model.build(model_cfg, state_dict, device)
    g, loc = model_cfg["use_global_features"], model_cfg["use_location_features"]
    samples = [ref_pre.sample(requests[i][0], requests[i][1], image_side, g, loc) for i in keep]
    served = ids[keep].to(device)
    with _full_f32():
        out["token_gap"] = float(judge.token_gaps(ref, samples, served, bos).max())
        if control:
            ctl = ref_model.build(model_cfg, judge.float8_weights(state_dict), device, dtype=torch.bfloat16)
            out["control_gap"] = float(judge.token_gaps(ref, samples, served, bos, control=ctl).max())
    return out


class _full_f32:
    """TF32 off for the reference's float32 products and convolutions."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.old
