"""Both cells end to end at SMOKE size on the CPU, in a subprocess:
each prints a result of the contract's shape, and nothing the run loads
is JAX or the JAX package (top-level module names compared whole)."""
import json
import subprocess
import sys

from bench.lib import spec

SCRIPT = r"""
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from bench.lib import harness
for cell, trace, secs in (("arctic-2l.code", 0, 1.0),
                          ("arctic-2l.chat", 1, 3.0)):
    ctx = harness.context(cell, 2**31 + 99, secs, bool(trace), device="cpu",
                          smoke=True)
    print(json.dumps(harness.run_cell(ctx)))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_drivers_print_the_contract_and_load_no_jax():
    code = SCRIPT.format(src=str(spec.ROOT / "src"), root=str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    plain, serve, mods = (json.loads(x) for x in lines[-3:])
    for res, names in ((plain, {"output_tokens_per_s", "ttft_p95_ms",
                                "tpot_p95_ms", "setup_s"}),
                       (serve, {"decode_forward_ms", "slot_occupancy"})):
        assert list(res)[:5] == ["correct", "attempted", "failed",
                                 "metrics", "device"]
        assert list(res)[-1] == "checks"
        assert res["correct"] is True, res["checks"]
        assert names <= set(res["metrics"])
        assert all(set(m) == {"value", "unit"}
                   for m in res["metrics"].values())
        assert res["device"]["platform"] == "cpu"
    assert "busy_s" in serve["device"] and "breakdown" in serve
    assert not {"jax", "jaxlib", "flax", "repro"} & set(mods)


def test_references_load_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(spec.ROOT)!r}]\n"
            "import json\n"
            "from bench.lib import spec, serve_check, work, traffic\n"
            "spec.reference('moe_decoder')\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd="/")
    assert out.returncode == 0, out.stderr[-2000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not {"jax", "jaxlib", "flax", "repro", "repro_torch"} & mods


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "arctic-2l.chat", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=120, cwd=spec.ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
