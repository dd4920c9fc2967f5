"""The port's serial-chain timer (retr_tpu_torch/utils/timing.py) against
retr_tpu/utils/timing.py: ``chain_apply``'s scalar on the same numpy input
and function, ``thread`` off (a 1e-30 tap of each output folded into the
input) and on (each output the next input), within 1e-6 relative; and
``time_chained`` on the CPU, where the same code runs without a card.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from retr_tpu.utils import timing as jtiming
from retr_tpu_torch.utils import timing


def _inputs():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((16, 16)).astype(np.float32) * 0.3,
            "v": rng.standard_normal((4, 16)).astype(np.float32)}


def _stateless(lib):
    """An output of another structure than the input (a decode step's kind)."""
    tanh = jnp.tanh if lib is jnp else torch.tanh
    return lambda x: {"h": tanh(x["v"] @ x["w"]), "s": (x["v"] * x["v"]).sum()}


def _step(lib):
    """state -> state of the same structure (a train step's kind)."""
    tanh = jnp.tanh if lib is jnp else torch.tanh
    return lambda x: {"w": x["w"] * 0.9 + 0.01, "v": tanh(x["v"] @ x["w"]) + 0.1}


@pytest.mark.parametrize("thread", [False, True])
@pytest.mark.parametrize("iters", [1, 5])
def test_chain_apply_equals_retr_tpu(thread, iters):
    x = _inputs()
    make = _step if thread else _stateless
    want = float(jtiming.chain_apply(make(jnp), thread=thread)({k: jnp.asarray(v) for k, v in x.items()},
                                                                  jnp.int32(iters)))
    tx = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    got = timing.chain_apply(make(torch), thread=thread)(tx, iters)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want)), (float(got), want)
    for k, v in x.items():           # the input is not written
        assert np.array_equal(tx[k].numpy(), v)


def test_time_chained_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(256, 256, generator=g)
    t = timing.time_chained(lambda x: torch.tanh(x @ a), torch.randn(64, 256, generator=g), k=8, rounds=3)
    assert isinstance(t, float) and math.isfinite(t) and t > 0
