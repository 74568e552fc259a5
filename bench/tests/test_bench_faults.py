"""The check that decides ``correct``, held to its faults and its control
at SMOKE size on the CPU: each run skips the look for a card and drives
the rest of a run with the timed path broken underneath (or the
lower-precision control in the program's place), and ``correct`` comes
out false."""
import pytest

from bench.lib import harness


def _run(cell, fault=None, control=False):
    ctx = harness.context(cell, 2**31 + 4242, 1.0, False, device="cpu",
                          smoke=True, fault=fault, control=control)
    res = harness.run_cell(ctx)
    # Something was compared: a refusal for want of tokens proves nothing.
    judged = res.get("control") or res["readings"]
    assert judged.get("tokens", 0) > 0, judged
    return res


@pytest.mark.parametrize("cell", ["arctic-2l.chat", "arctic-2l.code"])
def test_altered_token_is_caught(cell):
    res = _run(cell, fault="alter_token")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["arctic-2l.chat", "arctic-2l.code"])
def test_fp8_control_is_not_correct(cell):
    res = _run(cell, control=True)
    assert res["correct"] is False, res["checks"]
