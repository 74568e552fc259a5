"""Every configuration, cell, mix and metric of ``BENCHMARK.json`` loads
by name, and each metric's reader declares what the file says."""
import json

import pytest

from bench.lib import harness, spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def test_paths_and_command():
    assert BENCH["paths"] == ["bench"]
    assert BENCH["command"] == ["python3", "bench/run.py"]
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(cell):
    w = [x for x in BENCH["workloads"] if x["name"] == cell][0]
    wl = spec.workload(cell)
    assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
    assert wl["chips"] == w["chips"] == 1
    spec.traffic(wl["traffic"])
    spec.driver(wl["driver"])
    cfg = spec.config(wl["config"])
    spec.reference(cfg["reference"])
    # The port's config equals every size the file states.
    _, sizes = harness.port_config(cfg, smoke=False)
    assert sizes["num_layers"] == cfg["num_layers"]


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_declares_its_entry(name):
    entry = [m for m in BENCH["per_layer"] if m["name"] == name][0]
    mod = spec.metric(name)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    drivers = {spec.workload(w)["driver"] for w in entry["workloads"]}
    assert drivers == {mod.DRIVER}


def test_every_metric_file_is_listed():
    assert sorted(m["name"] for m in BENCH["per_layer"]) == \
        spec.metric_names()


def test_reduced_keys_differ_from_the_published():
    for c in BENCH["configs"]:
        cfg = spec.config(c["name"])
        assert c["reduced"] == cfg["reduced"]
        for k in c["reduced"]:
            assert cfg["published"][k] != cfg[k]
