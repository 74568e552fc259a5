"""The control on the card at each cell's own size, on three seeds: the
plain reference computed in float8 operands in the program's place
must come out as not correct, while the program's own readings on the
same runs stay inside the limits.  Run on the card with
``python -m pytest -m cuda bench/tests``; skipped where no card is."""
import pytest

CELLS = ["arctic-2l.chat", "arctic-2l.code"]
SEEDS = [3000900001, 3000900002, 3000900003]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes(card, cell):
    from bench import control
    from bench.lib import spec
    got = control.readings(cell, SEEDS, 10.0)
    limits = spec.workload(cell)["check"]["limits"]
    assert not any(got["correct_other"])
    for r in got["program"]:
        assert all(r[k] <= lim for k, lim in limits.items()), r
