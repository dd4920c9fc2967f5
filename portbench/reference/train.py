"""The plain reference's training step: RE:TR's teacher-forced step in float32.

Cross-entropy of the logits of ``caps[:, :-1]`` against ``caps[:, 1:]``,
averaged over every position (PAD included, as RE:TR's criterion is), the
word embedding's PAD row kept out of the update (``padding_idx``), the global
gradient norm clipped to ``clip_max_norm``, and ``torch.optim.AdamW`` over two
groups: layer2-4 of the backbone at ``lr_backbone``, everything after the
backbone at ``lr``; the stem, layer1 and every BatchNorm stay frozen.

A training step draws randomness the reference cannot choose for itself: the
colour jitter of each batch and the dropout masks. Both are drawn here
afresh from the seed by the scheme the measured program documents (integer
seeds derived by ``fold_in``, a splitmix64 mix; one ``torch.Generator`` on
the device per layer and per image stream; ``torch.rand`` draws in the
order the layer computes), so both sides see the same masks and factors.
Imports nothing of the measured program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref_model
from portbench.reference import preprocess

_MASK64 = (1 << 64) - 1
BRIGHTNESS, CONTRAST, SATURATION = (0.5, 1.3), (0.8, 1.5), (0.2, 1.5)   # RE:TR's ColorJitter


def fold_in(seed: int, data: int) -> int:
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class Drops(ref_model.Drops):
    """Dropout keep-masks of one step whose root seed is ``root``: the encoder
    from ``fold_in(root, 0)`` (layer i: ``fold_in(., i)``), the decoder from
    ``fold_in(root, 1)`` (embeddings ``777``, layer i ``100 + i``). Masks are
    drawn in the batch-first layout ([B, S, C], [B, H, Sq, Sk]) and handed to
    the reference's sequence-first tensors transposed."""

    def __init__(self, root: int, device, rate: float):
        self.enc, self.dec = fold_in(root, 0), fold_in(root, 1)
        self.device, self.keep = device, 1.0 - rate
        self.gens = {}

    def _gen(self, layer: str) -> torch.Generator:
        if layer not in self.gens:
            if layer == "embed":
                seed = fold_in(self.dec, 777)
            elif layer.startswith("enc"):
                seed = fold_in(self.enc, int(layer[3:]))
            else:
                seed = fold_in(self.dec, 100 + int(layer[3:]))
            self.gens[layer] = generator(seed, self.device)
        return self.gens[layer]

    def mask(self, site: str, shape, device):
        layer = site.split(".", 1)[0]
        if site.endswith(".probs") or layer == "embed":
            return torch.rand(shape, generator=self._gen(layer), device=device) < self.keep
        s, b, c = shape           # a residual branch, [S, B, C] here, [B, S, C] in the draw
        return (torch.rand((b, s, c), generator=self._gen(layer), device=device) < self.keep).transpose(0, 1)


def _gray(x):
    return x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114


def color_jitter(x: torch.Tensor, seed: int) -> torch.Tensor:
    """torchvision's ColorJitter(brightness, contrast, saturation) with RE:TR's
    ranges on [N, H, W, 3] floats in [0, 255]: per row three uniform factors
    and a random order of the three ops, drawn from a generator seeded with
    ``seed`` (factors first, then the order's keys)."""
    n = x.shape[0]
    gen = generator(seed, x.device)
    u = torch.rand((3, n), generator=gen, device=x.device)
    lo = torch.tensor([BRIGHTNESS[0], CONTRAST[0], SATURATION[0]], device=x.device)[:, None]
    hi = torch.tensor([BRIGHTNESS[1], CONTRAST[1], SATURATION[1]], device=x.device)[:, None]
    f = lo + u * (hi - lo)
    order = torch.argsort(torch.rand((n, 3), generator=gen, device=x.device), dim=1)
    out = x.clone()
    for r in range(n):
        y = out[r]
        for op in order[r].tolist():
            if op == 0:
                y = torch.clamp(y * f[0, r], 0.0, 255.0)
            elif op == 1:
                mean = torch.round(_gray(y).mean())
                y = torch.clamp(mean + (y - mean) * f[1, r], 0.0, 255.0)
            else:
                g = _gray(y)[..., None]
                y = torch.clamp(g + (y - g) * f[2, r], 0.0, 255.0)
        out[r] = y
    return out


def caption_ids(text: str, length: int, vocab: dict) -> tuple:
    """[CLS] words [SEP] padded with [PAD] to ``length`` (a vocabulary whose
    every word is one token): (ids, pad mask) as int64 / bool arrays."""
    ids = [vocab["[CLS]"]] + [vocab[w] for w in text.split()][: length - 2] + [vocab["[SEP]"]]
    mask = [False] * len(ids) + [True] * (length - len(ids))
    return np.array(ids + [vocab["[PAD]"]] * (length - len(ids)), np.int64), np.array(mask)


def batch(rows, cfg: dict, aug_seed: int, vocab: dict, device) -> dict:
    """One training batch from raw rows (image array, box, expression): host
    preprocessing, the jitter of the target (and context) stream drawn from
    ``fold_in(aug_seed, 0)`` (and ``1``), normalization, token ids."""
    g, loc = cfg["use_global_features"], cfg["use_location_features"]
    samples = [preprocess.sample(im, box, cfg["image_size"], g, loc) for im, box, _ in rows]
    out = {}
    for key in samples[0]:
        t = torch.as_tensor(np.stack([s[key] for s in samples])).to(device)
        if key in ("img", "g_img"):
            t = color_jitter(t.float(), fold_in(aug_seed, 0 if key == "img" else 1))
            t = preprocess.normalize(t)
        out[key] = t
    caps = [caption_ids(text, cfg["max_position_embeddings"] + 1, vocab) for _, _, text in rows]
    out["caps"] = torch.as_tensor(np.stack([c[0] for c in caps])).to(device)
    out["cap_mask"] = torch.as_tensor(np.stack([c[1] for c in caps])).to(device)
    return out


def trained(model) -> dict:
    """name -> parameter of every trained leaf, and the two AdamW groups."""
    names = {}
    for name, p in model.named_parameters():
        frozen = name.startswith("backbone.") and not any(f".{s}." in name for s in ref_model.TRAINED_BACKBONE_STAGES)
        p.requires_grad_(not frozen)
        if not frozen:
            names[name] = p
    return names


def make_optimizer(model, cfg: dict) -> torch.optim.AdamW:
    params = trained(model)
    backbone = [p for n, p in params.items() if n.startswith("backbone.")]
    rest = [p for n, p in params.items() if not n.startswith("backbone.")]
    return torch.optim.AdamW([{"params": rest, "lr": cfg["lr"]}, {"params": backbone, "lr": cfg["lr_backbone"]}],
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg["weight_decay"], foreach=False)


def step(model, opt, b: dict, root: int, cfg: dict) -> tuple:
    """One update; returns (loss, {name: the clipped gradient the optimizer got})."""
    opt.zero_grad(set_to_none=True)
    drops = Drops(root, b["caps"].device, cfg["dropout"])
    logits = model(b["img"], b["mask"], b["caps"][:, :-1], b["cap_mask"][:, :-1], g_img=b.get("g_img"),
                   g_mask=b.get("g_mask"), loc=b.get("loc"), drops=drops)
    tgt = b["caps"][:, 1:]
    loss = (torch.logsumexp(logits, -1) - logits.gather(-1, tgt[..., None])[..., 0]).mean()
    loss.backward()
    params = trained(model)
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    params["transformer.embeddings.word_embeddings.weight"].grad[cfg["pad_token_id"]] = 0.0
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad) for p in params.values()]))
    if cfg["clip_max_norm"] > 0 and norm >= cfg["clip_max_norm"]:
        for p in params.values():
            p.grad.mul_(cfg["clip_max_norm"] / norm)
    grads = {n: p.grad.detach().clone() for n, p in params.items()}
    opt.step()
    return float(loss.detach()), grads
