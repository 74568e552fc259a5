"""Paged attention on Hopper: build, load and wrap the CUDA C++ kernel.

The kernel (``csrc/paged_attention.cu``) replaces the JAX package's
Pallas TPU kernel ``paged_attention`` (``src/repro/kernels/
paged_attention.py:101``, ``pl.pallas_call`` at ``:152``).  It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C entry
point the first time a CUDA tensor reaches :func:`paged_attention`, and
loaded through ``ctypes``; nothing is built or imported for the card when
this module is imported, so the CPU tests can import it.

Dispatch is by where the tensors lie: a CPU ``q`` runs the plain PyTorch
version (``ref.paged_attention_ref``); a CUDA ``q`` launches the kernel on
``torch.cuda.current_stream()`` or raises.  There is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
# <repo>/build/kernels: listed in .gitignore, built at first use.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# Kernel launches made by :func:`paged_attention` (CUDA tensors only).
# Callers reset it to 0 and read it to show a run went through the kernel.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the paged-attention kernel is "
                       "built from source and needs the CUDA toolkit")


def build() -> Path:
    """Compile the kernel into ``BUILD_DIR`` (once per source content)
    and return the shared library's path.  The compiler's register and
    shared-memory report (``-Xptxas -v``) is kept beside it as ``.log``."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libpaged_attention_{tag}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.paged_attention_max_rows.argtypes = [ctypes.c_int,
                                                     ctypes.c_int]
            lib.paged_attention_max_rows.restype = ctypes.c_int
            ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_float)
            lib.paged_attention_launch.argtypes = (
                [ptr] * 6 + [i32] * 8 + [i64] * 13 + [f32, f32, ptr])
            lib.paged_attention_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(q, k_pages, v_pages, block, lens) -> None:
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block", block), ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q, k_pages and v_pages must "
                        "share one dtype")
    if block.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("paged_attention: block and lens must be int32")
    if q.dim() != 4 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("paged_attention: q [B,T,H,hd] and k/v pages "
                         "[n_pages, ps, Hkv, hd] expected")
    B, T, H, hd = q.shape
    _, _, Hkv, khd = k_pages.shape
    if khd != hd or H % Hkv:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not "
                         f"fit pages {tuple(k_pages.shape)}")
    if block.dim() != 2 or block.shape[0] != B or tuple(lens.shape) != (B,):
        raise ValueError("paged_attention: block [B,P] and lens [B] "
                         "expected")
    if (q.stride(3) != 1 or k_pages.stride(3) != 1
            or v_pages.stride(3) != 1 or block.stride(1) != 1
            or lens.stride(0) != 1):
        raise ValueError("paged_attention: the last dimension of q, k/v "
                         "pages and block, and lens, must be unit-stride")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block: torch.Tensor,
                    lens: torch.Tensor, softcap: float = 0.0
                    ) -> torch.Tensor:
    """Attend q over page-scattered KV via a block table.

    q:        [B, T, H, hd] — the T newest tokens of each row (their KV
              already written; positions lens-T .. lens-1).
    k_pages:  [n_pages, page_size, Hkv, hd] — one layer of the pool, any
              page/token/head strides (a ``pool[:, :, li]`` view is read
              in place, never made contiguous).
    v_pages:  same shape.
    block:    [B, P] int32 — page ids per row, position-ordered.
    lens:     [B] int32 — kv extent per row including the T queries.

    Returns [B, T, H, hd] in q.dtype.
    """
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, block, lens,
                                       softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check(q, k_pages, v_pages, block, lens)
    global launches
    lib = _load()
    B, T, H, hd = q.shape
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    g = H // Hkv
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    t_max = lib.paged_attention_max_rows(hd, ps) // g
    if t_max < 1:
        raise ValueError(f"paged_attention: head_dim {hd} with {g} query "
                         "heads per kv head does not fit shared memory")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for t0 in range(0, T, t_max):
        # A chunk too long for one block's shared memory is split along
        # T: queries [t0, t1) are the newest of a row t1 - T shorter.
        t1 = min(T, t0 + t_max)
        ln = lens if t1 == T else lens - (T - t1)
        qs, os_ = q[:, t0:t1], out[:, t0:t1]
        err = lib.paged_attention_launch(
            qs.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block.data_ptr(), ln.data_ptr(), os_.data_ptr(),
            _DTYPES[q.dtype], B, t1 - t0, H, Hkv, hd, ps, block.shape[1],
            qs.stride(0), qs.stride(1), qs.stride(2),
            k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
            v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
            os_.stride(0), os_.stride(1), os_.stride(2),
            block.stride(0), float(softcap), float(hd ** -0.5), stream)
        if err != 0:
            raise RuntimeError(f"paged_attention: kernel launch failed "
                               f"(cudaError {err})")
        launches += 1
    return out
