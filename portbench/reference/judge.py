"""How the reference judges served captions.

Teacher forcing: the reference reads each sampled prompt with the program's
served tokens after BOS and gives the logits at every position. A served
token is judged by its gap: how far its reference logit lies below the
reference's best at that position. Greedy decoding in the configuration's
precision serves tokens whose gap is within that precision's rounding; a
token altered where it is produced, or a prompt preprocessed or encoded
wrongly, shows as a wide gap.

The control puts the reference in the program's place one precision lower:
its weights rounded to float8 (e4m3, a scale per output channel), computed
in bfloat16 (for a bfloat16 configuration). At each position of the same
prompts and tokens it reads the gap of the token the control puts first.
"""

from __future__ import annotations

import torch

from portbench.reference import preprocess


def _forward(model, inp: dict, caps: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    mask = torch.zeros(caps[lo:hi].shape, dtype=torch.bool, device=caps.device)
    pick = {k: v[lo:hi] for k, v in inp.items()}
    return model(pick["img"], pick["mask"], caps[lo:hi], mask, g_img=pick.get("g_img"),
                 g_mask=pick.get("g_mask"), loc=pick.get("loc"))[:, :-1]


@torch.no_grad()
def token_gaps(model, samples, served: torch.Tensor, bos: int, *, control=None, block: int = 16) -> torch.Tensor:
    """[N, T] gaps of the served tokens (``served`` [N, T], after BOS), or,
    with ``control``, of the tokens the control model puts first."""
    device = served.device
    inp = preprocess.batch(samples, device)
    caps = torch.cat([torch.full((served.shape[0], 1), bos, dtype=served.dtype, device=device), served], 1)
    out = []
    for lo in range(0, served.shape[0], block):
        hi = min(lo + block, served.shape[0])
        logits = _forward(model, inp, caps, lo, hi)
        chosen = served[lo:hi] if control is None else _forward(control, inp, caps, lo, hi).argmax(-1)
        out.append(logits.max(-1).values - logits.gather(-1, chosen[..., None].long())[..., 0])
        del logits
    return torch.cat(out)


def float8_weights(state_dict: dict) -> dict:
    """Every weight of two or more dimensions rounded to float8 e4m3 with a
    scale per output channel (row), returned in bfloat16; other leaves in
    bfloat16."""
    out = {}
    for k, v in state_dict.items():
        v = v.float()
        if v.dim() >= 2 and not k.endswith(("running_mean", "running_var")):
            amax = v.abs().reshape(v.shape[0], -1).amax(1).clamp_min(1e-12)
            scale = (amax / torch.finfo(torch.float8_e4m3fn).max).reshape(-1, *[1] * (v.dim() - 1))
            v = (v / scale).to(torch.float8_e4m3fn).float() * scale
        out[k] = v.to(torch.bfloat16)
    return out
