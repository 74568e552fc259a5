"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, every submodule imports with both
blocked, and the entry points refuse to run without a card unless the
CPU is asked for."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_jax_or_reference_imports_in_the_source():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                               f"imports {name}")
    assert not bad, "\n".join(bad)


def test_every_submodule_imports_with_jax_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None}\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_config_registry_matches_reference():
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for name in tconfigs.list_archs():
        j, t = jconfigs.get_config(name), tconfigs.get_config(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
    assert tconfigs.get_smoke_config("smollm-135m").compute_dtype is \
        torch.bfloat16


def test_only_the_uniform_family_is_built():
    from repro_torch.configs import get_smoke_config, list_archs
    from repro_torch.models.model import build_model
    built = []
    for name in list_archs():
        try:
            build_model(get_smoke_config(name), device="cpu")
            built.append(name)
        except NotImplementedError as exc:
            assert "not ported yet" in str(exc)
    assert "smollm-135m" in built
    # The uniform families (attention, MoE) and the local:global one.
    assert {"olmoe-1b-7b", "arctic-480b", "gemma3-27b"} <= set(built)
    assert not {"zamba2-2.7b", "rwkv6-1.6b",
                "llama-3.2-vision-11b", "whisper-tiny"} & set(built)


def test_entry_points_refuse_without_a_card(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("smollm-135m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--smoke"])


def test_engine_constructs_every_scheduler():
    """All five schedulers of the JAX engine construct on the CPU (the
    default is ``slot_fused``, as there); ``slot_paged`` still refuses a
    model it cannot page (a sliding-window ring)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import SCHEDULERS, ServeEngine
    cfg = get_smoke_config("smollm-135m")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert ServeEngine(model, params, device="cpu").scheduler == "slot_fused"
    for sched in SCHEDULERS:
        eng = ServeEngine(model, params, scheduler=sched, device="cpu")
        assert eng.scheduler == sched
    with pytest.raises(ValueError, match="unknown scheduler"):
        ServeEngine(model, params, scheduler="lockstep", device="cpu")
    windowed = build_model(dataclasses.replace(cfg, sliding_window=16),
                           device="cpu")
    with pytest.raises(ValueError, match="slot_paged needs"):
        ServeEngine(windowed, params, scheduler="slot_paged", device="cpu")
