"""High-level inference API: image + bbox -> referring expression.

The port of retr_tpu/predictor.py's ``Predictor`` for greedy and beam decoding:
host preprocessing (crop / pad / PIL-exact resize / tokenize), normalization on
the device, encode once, the KV-cached greedy or beam loop through the CUDA
decode kernels, then pruning and detokenization.

    pred = Predictor(state_dict, cfg, tokenizer, max_batch=32)   # runs on cuda
    pred.predict(image, bbox)                          # -> "the woman in the red coat"
    pred.predict_batch(images, bboxes)                 # -> list[str], greedy
    pred.predict_batch(images, bboxes, beam=True)      # beam search, cfg.beam_size beams

Each chunk of up to ``max_batch`` requests is padded to ``max_batch`` rows by
repeating its last request, as the JAX package does. Beam search uses
``cfg.beam_size`` and ``cfg.length_penalty`` and returns the best hypothesis.
Sampling (ROADMAP item A7), ``ServingQueue`` and the HTTP server are not ported
yet.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence

import numpy as np
import torch

from retr_tpu_torch import decode as decode_mod
from retr_tpu_torch import device as device_mod
from retr_tpu_torch.config import Config
from retr_tpu_torch.data.dataset import collate
from retr_tpu_torch.data.pipeline import device_batch
from retr_tpu_torch.data.preprocess import load_image, preprocess_sample
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import weights
from retr_tpu_torch.precision import dtype_of


class Predictor:
    def __init__(self, params_state: Mapping[str, torch.Tensor], cfg: Config, tokenizer=None, *,
                 max_batch: int = 8, device=None):
        """params_state: a reference-named state dict (models/weights.py).
        ``device`` defaults to ``cuda``; without CUDA that raises (pass "cpu")."""
        self.device = device_mod.resolve(device)
        self.cfg = cfg
        self.params = weights.to_params(params_state, cfg, device=self.device)
        self.max_batch = max_batch
        if tokenizer is None:
            tokenizer, _, _ = prepare_tokenizer(cfg.vocab_file)
        self.tokenizer = tokenizer
        self.bos = tokenizer.convert_tokens_to_ids(tokenizer.cls_token)
        self.eos = tokenizer.convert_tokens_to_ids(tokenizer.sep_token)
        self.pad = tokenizer.convert_tokens_to_ids(tokenizer.pad_token)

    def predict(self, image, bbox, *, beam: bool = False, decoder: str = "greedy") -> str:
        return self.predict_batch([image], [bbox], beam=beam, decoder=decoder)[0]

    def predict_batch(self, images: Sequence, bboxes: Sequence, *, beam: bool = False,
                      decoder: str = "greedy") -> List[str]:
        """images: file paths or HWC uint8 arrays; bboxes: [x, y, w, h] each.

        ``decoder``: 'greedy' | 'beam' (``beam=True`` is shorthand for 'beam');
        'sample' is not ported yet and raises NotImplementedError."""
        if len(images) != len(bboxes):
            raise ValueError(f"{len(images)} images but {len(bboxes)} boxes")
        if beam:
            decoder = "beam"
        if decoder == "sample":
            raise NotImplementedError("decoder='sample' is not ported to retr_tpu_torch yet "
                                      "(ROADMAP item A7)")
        if decoder not in ("greedy", "beam"):
            raise ValueError(f"unknown decoder {decoder!r}")
        out: List[str] = []
        for i in range(0, len(images), self.max_batch):
            samples = [self._preprocess_one(im, bb) for im, bb in
                       zip(images[i:i + self.max_batch], bboxes[i:i + self.max_batch])]
            out += self._run_samples(samples, decoder)
        return out

    def _preprocess_one(self, image, bbox):
        arr = load_image(image) if isinstance(image, str) else np.asarray(image)
        return preprocess_sample(
            arr, bbox, "", self.tokenizer,
            image_size=self.cfg.image_size,
            max_length=self.cfg.max_position_embeddings,
            use_global=self.cfg.use_global_features,
            use_location=self.cfg.use_location_features,
        )

    def _run_samples(self, samples, decoder: str = "greedy") -> List[str]:
        true_n = len(samples)
        samples = samples + [samples[-1]] * (self.max_batch - true_n)
        batch = device_batch(collate(samples), self.device)
        g = (Masked(batch.global_images, batch.global_masks)
             if batch.global_images is not None else None)
        common = dict(global_samples=g, loc_feats=batch.loc_feats,
                      max_len=self.cfg.max_position_embeddings, bos_token=self.bos,
                      eos_token=self.eos, compute_dtype=dtype_of(self.cfg.compute_dtype))
        imgs = Masked(batch.images, batch.image_masks)
        if decoder == "beam":
            tokens, _ = decode_mod.beam_search(self.params, self.cfg, imgs, beam_size=self.cfg.beam_size,
                                               length_penalty=self.cfg.length_penalty, **common)
            ids = tokens[:, 0]
        else:
            ids = decode_mod.greedy(self.params, self.cfg, imgs, **common)
        pruned = decode_mod.prune_token_ids(
            ids[:true_n].cpu().tolist(), clean=True,
            pad_token=self.pad, bos_token=self.bos, eos_token=self.eos,
        )
        return self.tokenizer.batch_decode(pruned)
