"""On the card, for the LM-decoder cell and the float32 CaptionGlobalLoc
evaluation cell: a run at the cell's own size comes out correct, and the
control, read at the same served answers, fails one of the numbers compared
(the check of ``test_portbench_card.py``).

    python -m pytest -m cuda portbench/tests/test_portbench_card_lm.py
"""

import pytest

from portbench.tests.test_portbench_card import test_the_control_fails_where_the_program_passes as _card_check


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kimivl-eval-greedy", "globloc-eval-greedy"])
def test_the_control_fails_where_the_program_passes(workload):
    _card_check(workload)
