"""Port counterpart of ``tests/test_examples.py``: the four examples of
``examples_torch/`` stay runnable on the CPU (``--device cpu``; a
subprocess each, with the reference test's arguments, timeouts and
assertions).  Each parameter-count line must equal the line the
reference example prints for the same architecture, computed here from
the reference's own model."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args, timeout=420):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / script), *args,
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return proc.stdout


def _ref_params(cfg) -> int:
    """The reference model's parameter count, from shapes alone."""
    shapes = jax.eval_shape(ref_build_model(cfg).init, jax.random.PRNGKey(0))
    return sum(x.size for x in jax.tree.leaves(shapes))


def _ref_quickstart_line(arch: str) -> str:
    cfg = ref_smoke_config(arch)
    return f"{cfg.name}: {_ref_params(cfg) / 1e6:.2f}M params ({cfg.family})"


def test_quickstart():
    out = _run("quickstart.py")
    assert "train step: loss=" in out
    assert "generated token ids" in out
    assert out.splitlines()[0] == _ref_quickstart_line("smollm-135m")


def test_quickstart_moe_arch():
    out = _run("quickstart.py", "--arch", "olmoe-1b-7b")
    assert "generated token ids" in out
    assert out.splitlines()[0] == _ref_quickstart_line("olmoe-1b-7b")


def test_train_e2e_short(tmp_path):
    # enough steps to clear the 20-step LR warmup so loss visibly drops
    out = _run("train_e2e.py", "--steps", "35", "--batch", "2",
               "--seq", "32", "--ckpt-dir", str(tmp_path), timeout=600)
    assert "loss:" in out and "checkpoints:" in out
    cfg = dataclasses.replace(
        ref_get_config("smollm-135m"), name="smollm-25m", num_layers=8,
        d_model=384, num_heads=6, num_kv_heads=2, d_ff=1024,
        vocab_size=16384)
    assert out.splitlines()[0] == (f"{cfg.name}: {_ref_params(cfg) / 1e6:.1f}"
                                   f"M params, resume from step 0")


def test_lockfree_pipeline_demo():
    out = _run("lockfree_pipeline_demo.py")
    rows = {}
    for line in out.splitlines():
        parts = line.split()
        if (len(parts) >= 4 and parts[0] in ("barrier", "nbb", "nbb2")
                and parts[1].replace(",", "").isdigit()):
            rows[parts[0]] = parts
    assert rows["barrier"][3] == "True" and rows["nbb"][3] == "True"
    assert rows["nbb2"][3] == "True"
    b = int(rows["barrier"][1].replace(",", ""))
    n = int(rows["nbb"][1].replace(",", ""))
    assert b >= 4 * n   # ring moves ~1/S of the barrier's bytes
