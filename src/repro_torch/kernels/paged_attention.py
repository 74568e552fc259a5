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
``torch.cuda.current_stream()`` or raises.  There is no fallback.  On the
card :func:`route` picks one of the kernel's three routes: ``split``
(decode: flash-decoding over :func:`split_plan`'s runs of keys, then a
combine launch), ``chunk_tc`` (bf16 chunks on the tensor cores) or
``simt`` (everything else, on the CUDA cores).  Every route takes the
optional ring bound (``ring``, ``window``): a sliding-window ring read
with wrap-around.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

SOURCE = kbuild.CSRC / "paged_attention.cu"

# Kernel launches made by :func:`paged_attention` (CUDA tensors only):
# ``launches`` counts the attention passes (one per call, or one per
# T-piece of a chunk split along T), ``combine_launches`` the launches
# that merge a split-KV pass's splits (one per split-route pass),
# ``simt_launches`` the passes that took the CUDA-core ``simt`` route,
# ``ring_launches`` the passes under the ring bound.  Callers reset them
# to 0 and read them to show a run went through the kernel, and through
# which route.
launches = 0
combine_launches = 0
simt_launches = 0
ring_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("simt", "split", "chunk_tc")
_FAST_HEAD_DIMS = (16, 32, 64, 80, 128)
# The split route's limits, fixed in the source (checked at load): query
# rows g*T a block holds, and keys per tile (split_keys is a multiple).
SPLIT_ROWS = 16
SPLIT_TILE = 64
# Blocks a split-KV pass aims to stay under: 8 per SM of an H100.
_MAX_SPLIT_BLOCKS = 8 * 132


def _declare(lib: ctypes.CDLL) -> None:
    lib.paged_attention_max_rows.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.paged_attention_max_rows.restype = ctypes.c_int
    lib.paged_attention_split_limit.argtypes = [ctypes.c_int]
    lib.paged_attention_split_limit.restype = ctypes.c_int
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.paged_attention_launch.argtypes = (
        [ptr] * 8 + [i32] * 13 + [i64] * 13 + [f32, f32, ptr])
    lib.paged_attention_launch.restype = ctypes.c_int
    limits = (lib.paged_attention_split_limit(0),
              lib.paged_attention_split_limit(1))
    if limits != (SPLIT_ROWS, SPLIT_TILE):
        raise RuntimeError(f"paged_attention: the built kernel's split "
                           f"limits {limits} are not "
                           f"{(SPLIT_ROWS, SPLIT_TILE)}")


def split_plan(B: int, Hkv: int, P: int, ps: int) -> tuple:
    """(n_split, keys per split) of a split-KV pass, from the static
    shapes only: never from ``lens``, whose values would need a
    device-to-host read.  Each split is whole pages covering at least one
    64-key tile (a multiple of it), as many splits as keep B * Hkv *
    n_split under ``_MAX_SPLIT_BLOCKS``; the splits cover all P * ps
    positions, and those past a row's length cost an empty block."""
    tile_pages = -(-SPLIT_TILE // ps)
    per_row = max(1, _MAX_SPLIT_BLOCKS // max(1, B * Hkv))
    pages = max(tile_pages, -(-P // per_row))
    pages = -(-pages // tile_pages) * tile_pages
    return max(1, -(-P // pages)), pages * ps


def _aligned(t: torch.Tensor) -> bool:
    """16-byte aligned rows: the base, and every stride but the last a
    multiple of 16 bytes (the 16-byte ``cp.async`` copies)."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(st % step == 0
                                          for st in t.stride()[:-1])


def route(q: torch.Tensor, k_pages: torch.Tensor,
          v_pages: torch.Tensor) -> str:
    """The kernel route for these operands: ``split`` when the g*T query
    rows of a kv head fit one split block (decode), else ``chunk_tc`` for
    bf16; both need a head_dim of 16, 32, 64, 80 or 128 and 16-byte
    aligned rows.  Everything else takes ``simt``."""
    B, T, H, hd = q.shape
    g = H // k_pages.shape[2]
    if hd not in _FAST_HEAD_DIMS or not all(
            map(_aligned, (q, k_pages, v_pages))):
        return "simt"
    if g * T <= SPLIT_ROWS:
        return "split"
    return "chunk_tc" if q.dtype == torch.bfloat16 else "simt"


def _check(q, k_pages, v_pages, block, lens, kv_lens, ring: int,
           window: int) -> None:
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block", block), ("lens", lens), ("kv_lens", kv_lens)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q, k_pages and v_pages must "
                        "share one dtype")
    if block.dtype != torch.int32 or lens.dtype != torch.int32 or (
            kv_lens is not None and kv_lens.dtype != torch.int32):
        raise TypeError("paged_attention: block, lens and kv_lens must be "
                        "int32")
    if q.dim() != 4 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("paged_attention: q [B,T,H,hd] and k/v pages "
                         "[n_pages, ps, Hkv, hd] expected")
    B, T, H, hd = q.shape
    _, _, Hkv, khd = k_pages.shape
    if khd != hd or H % Hkv:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not "
                         f"fit pages {tuple(k_pages.shape)}")
    if block.dim() != 2 or block.shape[0] != B or tuple(lens.shape) != (B,) \
            or (kv_lens is not None and tuple(kv_lens.shape) != (B,)):
        raise ValueError("paged_attention: block [B,P], lens [B] and "
                         "kv_lens [B] expected")
    if (q.stride(3) != 1 or k_pages.stride(3) != 1
            or v_pages.stride(3) != 1 or block.stride(1) != 1
            or lens.stride(0) != 1
            or (kv_lens is not None and kv_lens.stride(0) != 1)):
        raise ValueError("paged_attention: the last dimension of q, k/v "
                         "pages and block, lens and kv_lens, must be "
                         "unit-stride")
    if window < 0:
        raise ValueError(f"paged_attention: window {window} < 0")
    ref._check_ring(block, k_pages, ring)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block: torch.Tensor,
                    lens: torch.Tensor, softcap: float = 0.0,
                    kv_lens: Optional[torch.Tensor] = None,
                    ring: int = 0, window: int = 0) -> torch.Tensor:
    """Attend q over page-scattered KV via a block table.

    q:        [B, T, H, hd] — the T newest tokens of each row (their KV
              already written; positions lens-T .. lens-1).
    k_pages:  [n_pages, page_size, Hkv, hd] — one layer of the pool, any
              page/token/head strides (a ``pool[:, :, li]`` view is read
              in place, never made contiguous).
    v_pages:  same shape.
    block:    [B, P] int32 — page ids per row, position-ordered.
    lens:     [B] int32 — kv extent per row including the T queries.
    kv_lens:  optional [B] int32 — keys each row has written: query t of
              row b sees keys < min(lens[b] - T + t + 1, kv_lens[b]).
    ring:     0, or the slots of a ring read with wrap-around (at most P *
              page_size): the row's count is n = kv_lens (lens without
              it), its keys the positions [max(0, n - ring), n), and
              position p lives at slot p % ring of the row's pages.
    window:   0, or the keys a query sees at most: query q sees no key at
              or below q - window.

    Returns [B, T, H, hd] in q.dtype; exact zeros for a query that sees
    no key.
    """
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, block, lens,
                                       softcap=softcap, kv_lens=kv_lens,
                                       ring=ring, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check(q, k_pages, v_pages, block, lens, kv_lens, ring, window)
    if ring and kv_lens is None:
        # The kernel reads a ring row's count from kv_lens: lens here, and
        # it stays lens when a simt chunk is split along T below.
        kv_lens = lens
    global launches, combine_launches, simt_launches, ring_launches
    lib = kbuild.load(SOURCE, _declare)
    B, T, H, hd = q.shape
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    P = block.shape[1]
    g = H // Hkv
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    way = route(q, k_pages, v_pages)
    n_split, split_keys, part, t_max = 1, 0, None, T
    if way == "split":
        n_split, split_keys = split_plan(B, Hkv, P, ps)
        # Each split's (m, l) and f32 accumulator, for the combine launch.
        part = torch.empty(B * Hkv * n_split * g * T * (hd + 2),
                           dtype=torch.float32, device=q.device)
    elif way == "simt":
        t_max = lib.paged_attention_max_rows(hd, ps) // g
        if t_max < 1:
            raise ValueError(f"paged_attention: head_dim {hd} with {g} "
                             "query heads per kv head does not fit shared "
                             "memory")
    for t0 in range(0, T, t_max):
        # A chunk too long for one block's shared memory (simt) is split
        # along T: queries [t0, t1) are the newest of a row t1 - T shorter
        # (kv_lens bounds keys, not queries: the same for every piece).
        t1 = min(T, t0 + t_max)
        ln = lens if t1 == T else lens - (T - t1)
        qs, os_ = q[:, t0:t1], out[:, t0:t1]
        err = lib.paged_attention_launch(
            qs.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block.data_ptr(), ln.data_ptr(),
            None if kv_lens is None else kv_lens.data_ptr(), os_.data_ptr(),
            None if part is None else part.data_ptr(), _DTYPES[q.dtype],
            ROUTES.index(way), B, t1 - t0, H, Hkv, hd, ps, P, n_split,
            split_keys, ring, window, qs.stride(0), qs.stride(1), qs.stride(2),
            k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
            v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
            os_.stride(0), os_.stride(1), os_.stride(2),
            block.stride(0), float(softcap), float(hd ** -0.5), stream)
        if err != 0:
            raise RuntimeError(f"paged_attention: kernel launch failed "
                               f"(cudaError {err})")
        launches += 1
        combine_launches += way == "split"
        simt_launches += way == "simt"
        ring_launches += ring > 0
    return out
