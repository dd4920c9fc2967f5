"""On the card: a run of each cell at its own size comes out correct, and the
control, read at the same served answers, fails one of the numbers compared
(one seed here; the readings behind each limit come from
``portbench/readings.py`` on a dozen seeds and more).

    python -m pytest -m cuda portbench/tests/test_portbench_card.py
"""

import pytest

from portbench import harness

CELLS = ["r101-eval-greedy", "r101-serve-greedy", "globloc-train-f32"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_where_the_program_passes(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import run
    from portbench.drivers import common

    work, bench = harness.cell(workload)
    try:
        res = run.execute(work, bench, 4_000_000_007, 3.0, False, control=True)
    finally:
        common.release()
    assert res["correct"], res["checks"]
    limits = {k: c["limit"] for k, c in res["checks"].items()}
    control = {k[len("control_"):] if k != "control_gap" else "token_gap": v for k, v in res["control"].items()}
    assert control and any(v > limits[k] for k, v in control.items() if k in limits), control
