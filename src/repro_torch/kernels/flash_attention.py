"""Flash attention on Hopper: build, load and wrap the CUDA C++ kernel.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
TPU kernel ``flash_attention`` (``src/repro/kernels/flash_attention.py:
103``, ``pl.pallas_call`` at ``:137``).  It is compiled with ``nvcc`` for
``sm_90a`` the first time a CUDA tensor reaches :func:`flash_attention`
(``kernels/build.py``) and loaded through ``ctypes``; importing this module
builds nothing.

Dispatch is by where the tensors lie: a CPU ``q`` runs the plain PyTorch
version (``ref.flash_attention_ref``); a CUDA ``q`` launches the kernel on
``torch.cuda.current_stream()`` or raises.  There is no fallback.

:func:`flash_attention_trainable` is the same forward with a gradient
(the JAX package's ``custom_vjp`` at ``flash_attention.py:164``).
"""
from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

SOURCE = kbuild.CSRC / "flash_attention.cu"

# Kernel launches made by :func:`flash_attention` (CUDA tensors only).
# Callers reset it to 0 and read it to show a run went through the kernel.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Query rows (g * block_q) a block aims for: enough rows to reuse each K/V
# tile, few enough that a prefill spreads over many blocks.
_TARGET_ROWS = 64


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention_max_rows.argtypes = [ctypes.c_int]
    lib.flash_attention_max_rows.restype = ctypes.c_int
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.flash_attention_launch.argtypes = (
        [ptr] * 4 + [i32] * 8 + [i64] * 12 + [i32, i32, f32, f32, ptr])
    lib.flash_attention_launch.restype = ctypes.c_int


def block_q_for(T: int, g: int, max_rows: int) -> int:
    """Query tokens per block: the largest power of two whose g-fold rows
    fit both the row target and shared memory, at most T (at least 1)."""
    bq = 1
    while 2 * bq * g <= min(_TARGET_ROWS, max_rows) and 2 * bq <= T:
        bq *= 2
    return bq


def _check(q, k, v, window: int) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q [B,T,H,hd] and k/v "
                         "[B,S,Hkv,hd] expected")
    B, T, H, hd = q.shape
    kB, S, Hkv, khd = k.shape
    if kB != B or khd != hd or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"fit k/v {tuple(k.shape)}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head_dim of q, k and v "
                         "must be unit-stride")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Blocked online-softmax GQA attention.

    q:   [B, T, H, hd] — with ``causal``, the T queries sit at positions
         S-T .. S-1 of the kv sequence (its suffix).
    k/v: [B, S, Hkv, hd], H % Hkv == 0, any batch/sequence/head strides
         (a ring slice ``ring[:, :S]`` is read in place).
    window: sliding window (0 = unlimited); softcap: tanh cap (0 = off).

    Returns [B, T, H, hd] in q.dtype.
    """
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, window)
    global launches
    lib = kbuild.load(SOURCE, _declare)
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    max_rows = lib.flash_attention_max_rows(hd)
    if max_rows < g:
        raise ValueError(f"flash_attention: head_dim {hd} with {g} query "
                         "heads per kv head does not fit shared memory")
    bq = block_q_for(T, g, max_rows)
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, T, S, H, Hkv, hd, bq,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        int(causal), int(window), float(softcap), float(hd ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out


class _FlashTrainable(torch.autograd.Function):
    """Forward on :func:`flash_attention`; backward by recompute through
    ``ref.flash_attention_ref`` (``_fa_fwd``/``_fa_bwd``,
    ``flash_attention.py:175-189``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, softcap)
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)

    @staticmethod
    def backward(ctx, g):
        causal, window, softcap = ctx.opts
        with record_function("flash_attention_trainable.backward"), \
                torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True)
                       for t in ctx.saved_tensors)
            out = ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window, softcap=softcap)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              window: int = 0,
                              softcap: float = 0.0) -> torch.Tensor:
    """:func:`flash_attention` with a gradient.

    The forward is the Hopper kernel on CUDA (its plain version on the
    CPU).  The backward recomputes attention from (q, k, v) through the
    plain ``ref.flash_attention_ref`` and differentiates it with autograd,
    as the JAX package's VJP does in jnp: the JAX package has no backward
    kernel, so neither does the port yet.  That backward materialises the
    f32 scores ``[B, Hkv, g, T, S]`` of one call at a time (about 151 MB
    at smollm's B=4, T=S=1024).  A recomputing checkpoint
    (``torch.utils.checkpoint``) re-runs the forward, and so the kernel,
    once more in the backward.  ``block_q``/``block_k``/``interpret`` of
    the JAX signature have no meaning here.
    """
    return _FlashTrainable.apply(q, k, v, causal, window, softcap)
