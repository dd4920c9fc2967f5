"""A run whose timed path is broken underneath comes out not correct. Each
test skips the harness's look for a card and drives the rest of a run at the
tiny CPU size with one fault planted in the program: a token altered where it
is produced, answers left out, a train step that returns its state
unchanged, half of the batch left out of the loss."""

import pytest

from portbench import synth
from portbench.tests import tiny


@pytest.fixture(autouse=True)
def _pool_size():
    full = synth.POOL_IMAGES
    synth.POOL_IMAGES = 12
    yield
    synth.POOL_IMAGES = full


def _execute(tmp_path, name):
    from portbench import run

    root, bench = tiny.files(str(tmp_path / "files"))
    work = next(w for w in bench["workloads"] if w["name"] == name)
    return run.execute(work, bench, 2 ** 32 + 5, 1.5, False, device="cpu", files=root,
                       checkout=str(tmp_path / "checkout"))


def _patch_greedy(monkeypatch, change):
    from retr_tpu_torch import decode

    real = decode.greedy
    monkeypatch.setattr(decode, "greedy", lambda *a, **k: change(real(*a, **k)))


def _alter_token(ids):
    ids = ids.clone()
    ids[:, 5] = 104 + (ids[:, 5] - 103) % (tiny.TINY["vocab_size"] - 104)
    return ids


@pytest.mark.parametrize("name", ["tiny-sweep", "tiny-serve"])
def test_a_token_altered_where_it_is_produced(tmp_path, monkeypatch, name):
    _patch_greedy(monkeypatch, _alter_token)
    res = _execute(tmp_path, name)
    assert not res["correct"]
    assert res["checks"]["token_gap"]["value"] > res["checks"]["token_gap"]["limit"]


def test_answers_left_out(tmp_path, monkeypatch):
    """``eval_model`` itself stops on a batch short of answers (its scorer
    asserts one hypothesis a reference): the run ends with no result line."""
    _patch_greedy(monkeypatch, lambda ids: ids[:-1])
    with pytest.raises(AssertionError):
        _execute(tmp_path, "tiny-sweep")


def test_a_step_that_returns_its_state_unchanged(tmp_path, monkeypatch):
    from retr_tpu_torch.train import state as state_mod

    def make_train_step(cfg, **_):
        def step(state, batch, seed):
            loss = state_mod.loss_fn(state.params, cfg, batch, state_mod.step_seed(seed, state), train=True)
            state.step += 1
            return state, loss.detach()
        return step

    monkeypatch.setattr(state_mod, "make_train_step", make_train_step)
    res = _execute(tmp_path, "tiny-train")
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(tmp_path, monkeypatch):
    from retr_tpu_torch.data.pipeline import Batch
    from retr_tpu_torch.train import state as state_mod

    real = state_mod.loss_fn

    def half(params, cfg, batch, seed, **kw):
        n = batch.images.shape[0] // 2
        return real(params, cfg, Batch(*(None if x is None else x[:n] for x in batch)), seed, **kw)

    monkeypatch.setattr(state_mod, "loss_fn", half)
    res = _execute(tmp_path, "tiny-train")
    assert not res["correct"]
    assert res["checks"]["loss_gap"]["value"] > res["checks"]["loss_gap"]["limit"]
