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
(bf16 decode: split-KV on ``mma.sync``), ``wgmma`` (bf16 chunks: every
query row of a kv head in one block, on ``wgmma``) or ``simt`` (float32
and everything else, on the CUDA cores).  The first two cut each row's
keys into the runs of :func:`split_plan` and merge them in split order
in the same launch (the last run of a row to finish merges; its arrival
counters are ``flash_attention.arrival_counters``, one array per device
and stream).  Every
route takes the optional ring bound (``ring``, ``window``): a
sliding-window ring read with wrap-around.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import TILE_ROWS, arrival_counters

SOURCE = kbuild.CSRC / "paged_attention.cu"

# Kernel launches made by :func:`paged_attention` (CUDA tensors only):
# ``launches`` counts the attention passes (one per call, or one per
# T-piece of a chunk split along T), ``split_launches`` those on the
# ``split`` route (one-token decodes: one launch each, merge included),
# ``simt_launches`` those on the CUDA-core ``simt`` route,
# ``ring_launches`` those under the ring bound.  Callers reset them to 0
# and read them to show a run went through the kernel, and through which
# route.
launches = 0
split_launches = 0
simt_launches = 0
ring_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("simt", "split", "wgmma")
_FAST_HEAD_DIMS = (16, 32, 64, 80, 128)
# The tensor-core routes' limits, fixed in the source (checked at load):
# query rows g*T a split block holds (one 16-row mma tile), keys per tile
# (split_keys is a multiple), and runs of a chunk's row at most (the
# merge's shared memory).
SPLIT_ROWS = 16
SPLIT_TILE = 64
CHUNK_SPLITS = 8
# A decode row's keys are cut into about this many runs of whole tiles,
# as flash's split route cuts its (flash_attention.SPLITS): each run
# streams a few tiles, and the last merges few partials.
SPLITS = 8
# A chunk's run is at least this many tiles: its partial is g*T rows of
# f32, as large as the run's K/V at 2 * g*T / split_keys, so a chunk
# splits only rows long enough to fill the card with few runs.
CHUNK_RUN_TILES = 8
# The sizes that set the tensor-core routes' shared memory, fixed in the
# source (the tests read them there): the most runs a decode row's split
# merges, and the K/V stages of the chunk route's ring.
SPLIT_MAX = 64
CHUNK_STAGES = 3


def chunk_warpgroups(hd: int) -> int:
    """Consumer warpgroups (64-row tiles) a chunk block holds at most
    (``chunk::kMaxWG``): two at head_dim 128, three below."""
    return 2 if hd >= 128 else 3


def smem_requests() -> dict:
    """{instance: the dynamic shared bytes its launches ask for at most}
    for every kernel instance of the library, named as
    ``build.smem_report`` names them: the split and chunk routes (the
    chunk at :func:`chunk_warpgroups`) computed from the constants above
    and the shared tile's (``flash_attention.TILE_ROWS``), as the source
    computes them; the CUDA-core route sizes its launch by the shape, up
    to ``build.SMEM_PER_BLOCK``."""
    out = {}
    for hd in _FAST_HEAD_DIMS:
        rows = 4 * SPLIT_TILE * 8               # two tiles' row offsets
        tiles = (SPLIT_ROWS + 4 * SPLIT_TILE) * (hd + 8) * 2
        merge = (SPLIT_ROWS * (hd + 8) * 2
                 + (3 * SPLIT_MAX + 2) * SPLIT_ROWS * 4)
        out[f"paged_split<{hd}>"] = max(tiles, merge) + rows
        wg = chunk_warpgroups(hd)
        ring = (wg + 2 * CHUNK_STAGES) * TILE_ROWS * hd * 2
        merge = (3 * CHUNK_SPLITS + 2) * wg * TILE_ROWS * 4
        for cap in ("false", "true"):
            out[f"paged_chunk<{hd}, {cap}>"] = (
                1024 + max(ring, merge) + 2 * CHUNK_STAGES * 8 + rows)
    for t in ("float", "bf16"):
        out[f"paged_simt<{t}>"] = kbuild.SMEM_PER_BLOCK
    return out


def _declare(lib: ctypes.CDLL) -> None:
    lib.paged_attention_max_rows.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.paged_attention_max_rows.restype = ctypes.c_int
    lib.paged_attention_split_limit.argtypes = [ctypes.c_int]
    lib.paged_attention_split_limit.restype = ctypes.c_int
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.paged_attention_workspace.argtypes = [i32] * 7 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.paged_attention_workspace.restype = i64
    lib.paged_attention_launch.argtypes = (
        [ptr] * 9 + [i32] * 13 + [i64] * 13 + [f32, f32, ptr])
    lib.paged_attention_launch.restype = ctypes.c_int
    limits = tuple(lib.paged_attention_split_limit(i) for i in range(3))
    if limits != (SPLIT_ROWS, SPLIT_TILE, CHUNK_SPLITS):
        raise RuntimeError(f"paged_attention: the built kernel's split "
                           f"limits {limits} are not "
                           f"{(SPLIT_ROWS, SPLIT_TILE, CHUNK_SPLITS)}")


def split_plan(T: int, positions: int, ring: int = 0, window: int = 0,
               chunk: bool = False) -> tuple:
    """(split_keys, n_split) of a split-KV pass, from the static shapes of
    one row: T queries over a table of ``positions`` (P * page_size)
    slots, or a ring of ``ring``, with an optional ``window``; never from
    the batch, the kv heads or ``lens`` (a device-to-host read).  A row's
    keys, [lo, hi) from the row's own key_lo (or the first query's window
    edge) to its key end, are at most ``ring`` or ``positions``, and
    ``window + T - 1``; they are cut into runs of ``split_keys`` (whole
    64-key tiles) from lo on the device: about ``SPLITS`` runs for a
    decode (the ``split`` route), runs of at least ``CHUNK_RUN_TILES``
    tiles and at most ``CHUNK_SPLITS`` of them for a chunk (``chunk``:
    the ``wgmma`` route).  A batch row's sums run in the same order alone
    as in any batch."""
    keys = ring if ring else positions
    if window:
        keys = min(keys, window + T - 1)
    tiles = max(1, -(-keys // SPLIT_TILE))
    if chunk:
        n = min(CHUNK_SPLITS, -(-tiles // CHUNK_RUN_TILES))
        run = -(-tiles // n)
    else:
        run = max(1, (tiles + SPLITS // 2) // SPLITS)
    return SPLIT_TILE * run, -(-tiles // run)


def _aligned(t: torch.Tensor) -> bool:
    """16-byte aligned rows: the base, and every stride but the last a
    multiple of 16 bytes (the 16-byte ``cp.async`` copies)."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(st % step == 0
                                          for st in t.stride()[:-1])


def route(q: torch.Tensor, k_pages: torch.Tensor,
          v_pages: torch.Tensor) -> str:
    """The kernel route for these operands: for bf16 at a head_dim of 16,
    32, 64, 80 or 128 with 16-byte aligned rows, ``split`` when the g*T
    query rows of a kv head fit one 16-row tile (decode), else ``wgmma``.
    Everything else (float32 included: no TF32) takes ``simt``."""
    B, T, H, hd = q.shape
    g = H // k_pages.shape[2]
    if q.dtype != torch.bfloat16 or hd not in _FAST_HEAD_DIMS or not all(
            map(_aligned, (q, k_pages, v_pages))):
        return "simt"
    return "split" if g * T <= SPLIT_ROWS else "wgmma"


def plan(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
         block: torch.Tensor, ring: int = 0, window: int = 0) -> tuple:
    """(route, (split_keys, n_split) or None) of a call on the card: the
    :func:`route`, and for the two split-KV routes :func:`split_plan` of
    one row of these shapes (the batch never enters it)."""
    way = route(q, k_pages, v_pages)
    if way == "simt":
        return way, None
    return way, split_plan(q.shape[1], block.shape[1] * k_pages.shape[1],
                           ring, window, chunk=way == "wgmma")


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
    global launches, split_launches, simt_launches, ring_launches
    lib = kbuild.load(SOURCE, _declare)
    B, T, H, hd = q.shape
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    P = block.shape[1]
    g = H // Hkv
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    way, runs = plan(q, k_pages, v_pages, block, ring, window)
    split_keys, n_split, part, count, t_max = 0, 1, None, None, T
    if way == "simt":
        t_max = lib.paged_attention_max_rows(hd, ps) // g
        if t_max < 1:
            raise ValueError(f"paged_attention: head_dim {hd} with {g} "
                             "query heads per kv head does not fit shared "
                             "memory")
    else:
        split_keys, n_split = runs
        n_count = ctypes.c_int(0)
        floats = lib.paged_attention_workspace(
            ROUTES.index(way), B, T, H, Hkv, hd, n_split,
            ctypes.byref(n_count))
        if floats:
            # Each run's f32 accumulator and (max, sum) of its rows, for
            # the merge in the launch.
            part = torch.empty(floats, dtype=torch.float32, device=q.device)
            count = arrival_counters(q.device, stream, n_count.value)
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
            None if part is None else part.data_ptr(),
            None if count is None else count.data_ptr(), _DTYPES[q.dtype],
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
        split_launches += way == "split"
        simt_launches += way == "simt"
        ring_launches += ring > 0
    return out
