"""NBB double-buffered matmul on Hopper: build, load and wrap the CUDA
C++ kernel.

The kernel (``csrc/nbb_matmul.cu``) replaces the JAX package's Pallas TPU
kernel ``nbb_matmul`` (``src/repro/kernels/nbb_matmul.py:84``,
``pl.pallas_call`` at ``:96``): the paper's NBB ring rebuilt as a 2-slot
shared-memory ring per operand, filled by the copy engine
(``cp.async.bulk``) and handed between a producer warp and the consumer
warps by full/empty mbarriers.  It is compiled with ``nvcc`` for
``sm_90a`` the first time a CUDA tensor reaches :func:`nbb_matmul`
(``kernels/build.py``) and loaded through ``ctypes``; importing this
module builds nothing.

Dispatch is by where the tensors lie: a CPU ``a`` runs the plain PyTorch
version (``ref.matmul_ref``); a CUDA ``a`` launches the kernel on
``torch.cuda.current_stream()`` or raises.  There is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

SOURCE = kbuild.CSRC / "nbb_matmul.cu"

# Kernel launches made by :func:`nbb_matmul` (CUDA tensors only).
# Callers reset it to 0 and read it to show a run went through the kernel.
launches = 0

# The kernel's own block tile (M, N) and K step, fixed in the source.
TILE = (64, 64, 32)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    lib.nbb_matmul_tile.argtypes = [ctypes.c_int]
    lib.nbb_matmul_tile.restype = ctypes.c_int
    lib.nbb_matmul_launch.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p])
    lib.nbb_matmul_launch.restype = ctypes.c_int
    tile = tuple(lib.nbb_matmul_tile(i) for i in range(3))
    if tile != TILE:
        raise RuntimeError(f"nbb_matmul: the built kernel's tile {tile} is "
                           f"not {TILE}")


def _check_cuda(a: torch.Tensor, b: torch.Tensor) -> None:
    """What the copy engine needs: contiguous row-major operands on one
    card, 16-byte aligned bases and rows."""
    if b.device != a.device:
        raise ValueError(f"nbb_matmul: b on {b.device}, a on {a.device}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"nbb_matmul: dtype {a.dtype} not supported "
                        "(float32 or bfloat16)")
    if b.dtype != a.dtype:
        raise TypeError("nbb_matmul: a and b must share one dtype")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("nbb_matmul: a and b must be contiguous row-major "
                         "(the bulk copies read whole rows)")
    size = a.element_size()
    K, N = b.shape
    if a.data_ptr() % 16 or b.data_ptr() % 16 or (K * size) % 16 \
            or (N * size) % 16:
        raise ValueError(f"nbb_matmul: the bulk copies need 16-byte aligned "
                         f"rows: K={K} and N={N} at {size} bytes each, "
                         f"bases {a.data_ptr() % 16} and "
                         f"{b.data_ptr() % 16} bytes off")


def nbb_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256,
               bn: int = 256, bk: int = 512) -> torch.Tensor:
    """[M, K] @ [K, N] with a float32 accumulator, in a's dtype.

    ``bm``/``bn``/``bk`` keep the reference's contract: each is clamped
    to its dimension, and M, N and K must be multiples of the clamped
    values (``nbb_matmul.py:87-91``).  The CUDA kernel does not tile by
    them: its block tile is its own, ``TILE`` = 64 x 64 outputs with a
    K step of 32.  The reference's default ring at 256 x 256 x 512 would
    hold 2 * (256 * 512 + 512 * 256) * 2 bytes = 1 MiB of bf16 tiles,
    which does not fit the 227 KB of shared memory a Hopper block may
    have.  On the card the operands must be contiguous, with K and N
    rows a multiple of 16 bytes (the copy engine's alignment).
    """
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("nbb_matmul: a [M,K] and b [K,N] expected")
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"nbb_matmul: a {tuple(a.shape)} does not fit b "
                         f"{tuple(b.shape)}")
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"nbb_matmul: ({M}, {N}, {K}) is not a multiple of "
                         f"the clamped blocks ({bm}, {bn}, {bk})")
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"nbb_matmul: unsupported device {a.device}")
    _check_cuda(a, b)
    global launches
    lib = kbuild.load(SOURCE, _declare)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.nbb_matmul_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                _DTYPES[a.dtype], M, N, K, stream)
    if err != 0:
        raise RuntimeError(f"nbb_matmul: kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out
