"""NBB ring matmul on Hopper: build, load and wrap the CUDA C++ kernel.

The kernel (``csrc/nbb_matmul.cu``) replaces the JAX package's Pallas TPU
kernel ``nbb_matmul`` (``src/repro/kernels/nbb_matmul.py:84``,
``pl.pallas_call`` at ``:96``): the paper's NBB ring rebuilt as an S-slot
shared-memory ring, filled by the copy engine and handed between a
producer warp and the consumer warps by full/empty mbarriers.  bfloat16
runs on the tensor cores (TMA tiles, ``wgmma``), in one of two tile
instances picked by :func:`instance_for`; float32 on the CUDA cores.  It
is compiled with ``nvcc`` for ``sm_90a`` the first time a CUDA tensor
reaches :func:`nbb_matmul` (``kernels/build.py``) and loaded through
``ctypes``; importing this module builds nothing.

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

# The kernel's instances (index = its ``instance`` argument), fixed in
# the source: dtype, block tile (M, N), K step and ring slots.
INSTANCES = (("float32", 64, 64, 32, 2),      # CUDA cores
             ("bfloat16", 64, 64, 64, 4),     # wgmma, one consumer group
             ("bfloat16", 128, 128, 64, 3))   # wgmma, two consumer groups
# Each instance's block tile (M, N) and K step.
TILE = tuple((m, n, k) for _, m, n, k, _ in INSTANCES)
SLOTS = tuple(s for *_, s in INSTANCES)


def smem_requests() -> dict:
    """{instance: the dynamic shared bytes its launches ask for}, named as
    ``build.smem_report`` names them: each bf16 instance's ring of
    ``SLOTS`` A and B tiles and 1024 bytes to align it; the float32 ring
    is static."""
    out = {"nbb_simt_kernel": 0}
    for _, m, n, k, slots in INSTANCES[1:]:
        out[f"nbb_wgmma_kernel<{m}, {n}, {slots}>"] = (
            slots * (m * k + k * n) * 2 + 1024)
    return out


# Streaming multiprocessors of an H100: the large bf16 tile is taken once
# its tiling fills them.
_SMS = 132

_DTYPES = (torch.float32, torch.bfloat16)


def instance_for(dtype: torch.dtype, M: int, N: int) -> int:
    """The kernel instance for a product of this dtype and output shape:
    float32 takes the CUDA-core instance 0; bfloat16 the 128 x 128 tile
    (2) when that tiling gives at least one block per SM, else the 64 x 64
    tile (1), which spreads a smaller product over 4x the blocks."""
    if dtype == torch.float32:
        return 0
    m, n = TILE[2][:2]
    return 2 if -(-M // m) * -(-N // n) >= _SMS else 1


def _declare(lib: ctypes.CDLL) -> None:
    lib.nbb_matmul_tile.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.nbb_matmul_tile.restype = ctypes.c_int
    lib.nbb_matmul_launch.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p])
    lib.nbb_matmul_launch.restype = ctypes.c_int
    for i, want in enumerate(INSTANCES):
        got = tuple(lib.nbb_matmul_tile(i, w) for w in range(4))
        if got != want[1:]:
            raise RuntimeError(f"nbb_matmul: the built kernel's instance {i} "
                               f"is {got}, not {want[1:]}")


def _check_cuda(a: torch.Tensor, b: torch.Tensor) -> None:
    """What the copy engine needs: contiguous row-major operands on one
    card, 16-byte aligned bases and rows (TMA's rule for the tensor maps
    too)."""
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
    them: its block tile is its instance's (``TILE[instance_for(...)]``:
    64 x 64 with K steps of 32 in float32; 64 x 64 or 128 x 128 with K
    steps of 64 in bfloat16).  The reference's default ring at 256 x 256
    x 512 would hold 2 * (256 * 512 + 512 * 256) * 2 bytes = 1 MiB of
    bf16 tiles, which does not fit the 227 KB of shared memory a Hopper
    block may have.  On the card the operands must be contiguous, with K
    and N rows a multiple of 16 bytes (the copy engine's alignment).
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
                                instance_for(a.dtype, M, N), M, N, K, stream)
    if err != 0:
        raise RuntimeError(f"nbb_matmul: kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out
