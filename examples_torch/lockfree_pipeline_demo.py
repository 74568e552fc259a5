"""The paper's experiment at device level: lock-based (barrier) vs
lock-free (NBB ring) pipeline exchange over a process group.

    PYTHONPATH=src python examples_torch/lockfree_pipeline_demo.py \
        --device cpu                 # 8 gloo ranks on the host
    PYTHONPATH=src python examples_torch/lockfree_pipeline_demo.py \
        --ranks 4                    # NCCL, one rank per card

Spawns ``--ranks`` processes (default 8), one pipeline stage each:
gloo under ``--device cpu``, NCCL with one rank per card under ``cuda``
(the default; it stops when fewer cards are visible than ranks).  For
each schedule, rank 0 prints the collective bytes of one call as the
port's accountant (``launch.hlo_analysis``) counts them at one stage —
hardware-independent, the ratio is what carries over — then its wall
time per call on the run's device, and whether every schedule computes
``pipeline_reference``'s result.
"""
import argparse
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"
sys.path.insert(0, str(SRC))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.launch import hlo_analysis  # noqa: E402
from repro_torch.parallel.pipeline import (pipeline_apply,  # noqa: E402
                                           pipeline_reference)

SCHEDULES = ("barrier", "nbb", "nbb2")
RANK_TIMEOUT_S = 600        # a rank that hangs (a lost peer) fails the run


def stage_fn(p, x):
    return torch.tanh(x @ p["w"])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rank(rank: int, world: int, port: int, device_type: str) -> None:
    """One stage of the pipeline: the three schedules, timed and checked
    on every rank; rank 0 prints the table's rows."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)        # the ranks share the host's cores
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh(device_type, (world,),
                                mesh_dim_names=("stage",))
        S, M, B, D = world, 16, 8, 256
        g = torch.Generator().manual_seed(0)
        params = {"w": (torch.randn(S, D, D, generator=g) * 0.1).to(device)}
        mbs = torch.randn(M, B, D, generator=g).to(device)
        want = pipeline_reference(stage_fn, params, mbs, S)
        for schedule in SCHEDULES:
            acc = hlo_analysis.analyze(pipeline_apply, stage_fn, params, mbs,
                                       mesh, "stage", schedule)
            coll = int(sum(acc.collective_bytes.values()))

            def call():
                return pipeline_apply(stage_fn, params, mbs, mesh,
                                      axis="stage", schedule=schedule)

            out = call()                # warm-up
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(10):
                out = call()
            _sync(device)
            dt = (time.perf_counter() - t0) / 10
            got = out.full_tensor()[-1]
            ok = bool(torch.allclose(got, want, atol=1e-5))
            if rank == 0:
                print(f"{schedule:10} {coll:18,} {dt * 1e3:8.1f}  {ok}",
                      flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8,
                    help="pipeline stages, one process each")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; one rank per card) or cpu (gloo)")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device_type = torch.device(args.device).type
    if args.rank is not None:
        run_rank(args.rank, args.ranks, args.port, device_type)
        return None

    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass --device "
                               "cpu to run on the CPU")
        cards = torch.cuda.device_count()
        if cards < args.ranks:
            raise SystemExit(f"--ranks {args.ranks} needs {args.ranks} "
                             f"cards (one rank per card); {cards} visible")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
         "--ranks", str(args.ranks), "--port", str(port), "--device",
         args.device], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(args.ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S))
    finally:
        for p in procs:                 # a failed rank must not hang on
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode, err[-2000:])
           for r, (p, (_, err)) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    if bad:
        raise RuntimeError(f"pipeline ranks failed: {bad}")

    print(f"{'schedule':10} {'collective bytes':>18} {'ms/call':>8}  match")
    rows = []
    for line in outs[0][0].splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0] in SCHEDULES:
            print(line)
            rows.append({"schedule": parts[0],
                         "bytes": int(parts[1].replace(",", "")),
                         "ms": float(parts[2]), "match": parts[3] == "True"})
    print("\nbarrier = the reference MCAPI global lock (everyone exchanges "
          "with everyone);\nnbb = the paper's lock-free ring (point-to-point"
          " only). Fewer collective\nbytes at identical results is the "
          "paper's 25x.")
    return rows


if __name__ == "__main__":
    main()
