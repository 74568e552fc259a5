"""One run of one cell: the spec found by name, the card checked, the
driver run, the result printed as one JSON line.

The result's last key, ``checks``, holds each number compared with its
limit; the same lines end standard error.  A run that finds no card, or
fewer than its cell asks for, fails without a result; so does one whose
process holds ``jax``, ``jaxlib``, ``flax`` or ``repro`` once its window
has closed."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional

from bench.lib import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    smoke: bool
    t0: float
    cfg: object = None            # the port's ModelConfig
    sizes: dict = None            # the sizes the references read
    fault: Optional[str] = None   # a planted fault (tests, the control)
    control: bool = False         # the lower-precision control instead


def sizes_of(cfg) -> dict:
    """The sizes of a port config under the names the configuration files
    and the references use."""
    out = dict(num_layers=cfg.num_layers, d_model=cfg.d_model,
               num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
               head_dim=cfg.head_dim_, d_ff=cfg.d_ff,
               vocab_size=cfg.vocab_size, norm_eps=cfg.norm_eps,
               rope_theta=cfg.rope_theta, tie_embeddings=cfg.tie_embeddings,
               dtype=cfg.dtype)
    if cfg.moe is not None:
        out.update(num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                   d_ff_expert=cfg.moe.d_ff_expert,
                   capacity_factor=cfg.moe.capacity_factor,
                   dense_residual=cfg.moe.dense_residual)
    return out


def port_config(cspec: dict, smoke: bool):
    """The port's config as the file states it run: the registry's
    ``arch`` with the file's ``overrides``; every size the file gives
    must equal the config's (the smoke size skips that)."""
    from repro_torch.configs import get_config, get_smoke_config
    if smoke:
        cfg = get_smoke_config(cspec["arch"])
        return cfg, sizes_of(cfg)
    cfg = dataclasses.replace(get_config(cspec["arch"]),
                              **cspec.get("overrides", {}))
    sizes = sizes_of(cfg)
    wrong = {k: (cspec[k], v) for k, v in sizes.items()
             if k in cspec and cspec[k] != v}
    if wrong:
        raise ValueError(f"{cspec['name']}: the port's config differs "
                         f"from the file: {wrong}")
    return cfg, sizes


def context(name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", smoke: bool = False, t0: float = None,
            fault: Optional[str] = None, control: bool = False) -> Context:
    wl = spec.workload(name)
    ctx = Context(wl, spec.config(wl["config"]), spec.traffic(wl["traffic"]),
                  int(seed), float(seconds), bool(trace), device, smoke,
                  time.monotonic() if t0 is None else t0, fault=fault,
                  control=control)
    if smoke:
        ctx.traffic.update(wl.get("smoke", {}).get("traffic", {}))
    ctx.cfg, ctx.sizes = port_config(ctx.config, smoke)
    return ctx


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(ctx: Context) -> dict:
    """The driver's result, with the per-layer metrics of a traced run
    read by the metric files."""
    drv = spec.driver(ctx.workload["driver"])
    out = drv.run(ctx)
    metrics: Dict[str, dict] = {}
    if ctx.trace:
        for name, mod in spec.metrics_for(ctx.workload["driver"]).items():
            value = mod.read(out["layer_ctx"])
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    else:
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in out["e2e"].items()}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if ctx.trace and out.get("breakdown") is not None:
        result["breakdown"] = out["breakdown"]
    result["power"] = out.get("power", "")
    result["readings"] = out.get("readings")
    if out.get("control") is not None:
        result["control"] = out["control"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out["checks"].items()}
    return result


def forbidden_modules() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def main(argv=None, t0: float = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    wl = spec.workload(args.workload)
    import torch
    chips = int(wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = context(args.workload, args.seed, args.seconds, bool(args.trace),
                  t0=t0)
    result = run_cell(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the process holds {bad} after the window",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def setup_env(root) -> None:
    """Fixed cache directories inside the checkout, set before torch is
    imported; no library may load JAX on its own."""
    cache = os.path.join(root, "build", "bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
