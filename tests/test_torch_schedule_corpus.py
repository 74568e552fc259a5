"""Port counterpart of ``tests/test_schedule_corpus.py``: the
reference's ``tests/schedules/`` corpus (DESIGN.md §15), read in place
and replayed on the port's scenarios.

Every JSON file is a schedule the checker once found interesting — a
minimized counterexample against a preserved-broken implementation
(``expect: violation``) or a regression schedule that once exposed a
since-fixed bug and must now pass (``expect: pass``).  Each replay is
held to the reference's replay of the same file: the verdict, the error
type and the trace of yield sites.
"""
import glob
import os

import pytest

pytest.importorskip("torch")

from repro.checker import scenarios as jscenarios  # noqa: E402
from repro.core import interleave as jil  # noqa: E402
from repro_torch.checker import scenarios  # noqa: E402
from repro_torch.core import interleave as il  # noqa: E402

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "schedules")
CORPUS = sorted(glob.glob(os.path.join(CORPUS_DIR, "*.json")))


def test_corpus_exists():
    assert CORPUS, "tests/schedules/ corpus is empty"


@pytest.mark.parametrize(
    "path", CORPUS, ids=[os.path.basename(p) for p in CORPUS])
def test_replay(path):
    rec = il.load_schedule(path)
    scen = scenarios.get(rec["scenario"])
    res = il.run_schedule(scen.make_world, rec["schedule"],
                          max_steps=scen.max_steps, strict=False)
    jscen = jscenarios.get(rec["scenario"])
    ref = jil.run_schedule(jscen.make_world, rec["schedule"],
                           max_steps=jscen.max_steps, strict=False)
    assert (res.failed, type(res.error).__name__) == (
        ref.failed, type(ref.error).__name__)
    assert [s for _, s, _ in res.trace] == [s for _, s, _ in ref.trace]
    if rec["expect"] == "violation":
        assert res.failed, (
            f"{path}: schedule no longer reproduces the violation "
            f"(did the scenario change shape?)")
    else:
        assert not res.failed, (
            f"{path}: regression schedule fails again: {res.error!r}\n"
            f"note: {rec.get('note', '')}")


def test_corpus_scenarios_registered():
    for path in CORPUS:
        rec = il.load_schedule(path)
        assert rec["scenario"] in scenarios.SCENARIOS, path
    assert list(scenarios.SCENARIOS) == list(jscenarios.SCENARIOS)
