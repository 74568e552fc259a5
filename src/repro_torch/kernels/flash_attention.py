"""Flash attention on Hopper: build, load and wrap the CUDA C++ kernels.

The forward (``csrc/flash_attention.cu``) replaces the JAX package's
Pallas TPU kernel ``flash_attention`` (``src/repro/kernels/
flash_attention.py:103``, ``pl.pallas_call`` at ``:137``); the backward
(``csrc/flash_attention_bwd.cu``) computes the VJP that the JAX
package's ``_fa_bwd`` (``:182-189``) takes through its jnp reference.
Each is compiled with ``nvcc`` for ``sm_90a`` the first time a CUDA
tensor reaches it (``kernels/build.py``) and loaded through ``ctypes``;
importing this module builds nothing.

Dispatch is by where the tensors lie: a CPU ``q`` runs the plain
PyTorch versions (``ref.flash_attention_ref``, ``ref.
flash_attention_fwd_ref``, ``ref.flash_attention_bwd_ref``); a CUDA
``q`` launches a kernel on ``torch.cuda.current_stream()`` or raises.
There is no fallback.  On the card the forward takes one of three
routes (:func:`forward_route`): bf16 with 16-byte aligned rows at
head_dim 16/32/64/80/128 takes ``split`` when the g*T query rows of a kv
head fit one 16-row tile (one-token reads: one block per key split,
merged in split order by the split that finishes last, in the same
launch) and ``wgmma`` otherwise (prefills, chunks, training: TMA-fed
``wgmma`` tiles); float32 and other bf16 inputs take ``simt`` (f32 FMA,
no TF32).  The backward takes its tensor-core instance where
:func:`tensor_core_route` holds.

:func:`flash_attention_trainable` is the forward with a gradient (the
JAX package's ``custom_vjp`` at ``flash_attention.py:164``).
"""
from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

SOURCE = kbuild.CSRC / "flash_attention.cu"
BWD_SOURCE = kbuild.CSRC / "flash_attention_bwd.cu"

# Kernel launches made by the forward (:func:`flash_attention` and the
# trainable forward: one per call, whatever the route) and by the
# backward (:func:`flash_attention_bwd`: one per call, which runs its
# passes in turn), CUDA tensors only; those of either that took the
# CUDA-core instance; the forward launches that took the split route; and
# the forward launches that were non-causal (cross-attention, the
# bidirectional encoder).  Callers reset them to 0 and read them to show
# a run went through the kernels, and through which.
launches = 0
bwd_launches = 0
simt_launches = 0
split_launches = 0
noncausal_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Head dims with a tensor-core instance, forward and backward (80:
# zamba2-2.7b's shared attention).
TC_HEAD_DIMS = (16, 32, 64, 80, 128)
ROUTES = ("simt", "split", "wgmma")
# Query rows (g * block_q) a block of the CUDA-core forward aims for:
# enough rows to reuse each K/V tile, few enough that a prefill spreads
# over many blocks.
_TARGET_ROWS = 64
# The split route's limits, fixed in the source (checked at load): the
# query rows g*T of a kv head one block holds (one 16-row mma tile), the
# keys a block stages at once (split_keys is a multiple of them).
SPLIT_ROWS = 16
SPLIT_CHUNK = 64
# The splits a row's keys are cut into, about: each split streams a few
# chunks (the next loads while one is multiplied), and the last merges
# few partials.  On an H100 the best run grows with S: 64 keys at the
# wave's S=513, 192 at whisper's 1500, 192-512 at llama-vision's 1600
# (PERF.md §6).
SPLITS = 8
# The tiles' sizes that set the tensor-core instances' shared memory,
# fixed in the sources (the tests read them there): rows of a ``wgmma``
# tile (``flash_tiles.cuh``), the most splits the split route merges, the
# K/V stages of the forward's ``wgmma`` ring, and the most warpgroups of
# a backward dK/dV block.
TILE_ROWS = 64
SPLIT_MAX = 64
WGMMA_STAGES = 3
BWD_WARPGROUPS = 2


def tile_slots(hd: int) -> int:
    """Ring slots of a backward warpgroup (``Tile<hd>::kSlots``): two
    tiles in flight at head_dim 128, three below."""
    return 2 if hd >= 128 else 3


def smem_requests(backward: bool = False) -> dict:
    """{instance: the dynamic shared bytes its launches ask for at most}
    for every kernel instance of the forward's library (or the
    backward's), named as ``build.smem_report`` names them.  The
    tensor-core instances' sizes are computed from the tile constants
    above, as the sources compute them; a CUDA-core instance sizes its
    launch by the shape, up to ``build.SMEM_PER_BLOCK``."""
    out = {}
    for hd in TC_HEAD_DIMS:
        tile = TILE_ROWS * hd * 2
        if backward:
            slots = tile_slots(hd)
            dq = 2 * tile + slots * 2 * tile + 1024
            w = BWD_WARPGROUPS
            dkdv = (2 * tile + w * slots * 2 * tile
                    + w * slots * 2 * TILE_ROWS * 4 + 1024)
            for cap in ("false", "true"):
                out[f"flash_bwd_dq_wgmma<{hd}, {cap}>"] = dq
            for cap in ("false", "true"):
                out[f"flash_bwd_dkdv_wgmma<{hd}, {cap}>"] = dkdv
            continue
        tiles = (SPLIT_ROWS + 4 * SPLIT_CHUNK) * (hd + 8) * 2
        merge = (SPLIT_ROWS * (hd + 8) * 2
                 + (3 * SPLIT_MAX + 2) * SPLIT_ROWS * 4)
        out[f"flash_fwd_split<{hd}>"] = max(tiles, merge)
        for cap in ("false", "true"):
            out[f"flash_fwd_wgmma<{hd}, {cap}>"] = (
                1024 + (1 + 2 * WGMMA_STAGES) * tile
                + (2 * WGMMA_STAGES + 1) * 8)
    simt = (("flash_bwd_dq_simt", "flash_bwd_dkdv_simt") if backward
            else ("flash_fwd_simt",))
    for t in ("float", "bf16"):
        for kernel in simt:
            out[f"{kernel}<{t}>"] = kbuild.SMEM_PER_BLOCK
    return out


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention_max_rows.argtypes = [ctypes.c_int]
    lib.flash_attention_max_rows.restype = ctypes.c_int
    lib.flash_attention_split_limit.argtypes = [ctypes.c_int]
    lib.flash_attention_split_limit.restype = ctypes.c_int
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.flash_attention_launch.argtypes = (
        [ptr] * 7 + [i32] * 12 + [i64] * 12 + [i32, i32, f32, f32, ptr])
    lib.flash_attention_launch.restype = ctypes.c_int
    limits = (lib.flash_attention_split_limit(0),
              lib.flash_attention_split_limit(1))
    if limits != (SPLIT_ROWS, SPLIT_CHUNK):
        raise RuntimeError(f"flash_attention: the built kernel's split "
                           f"limits {limits} are not "
                           f"{(SPLIT_ROWS, SPLIT_CHUNK)}")


def _declare_bwd(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_launch.argtypes = (
        [ptr] * 10 + [i32] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
        + [i32, i32, f32, f32, ptr])
    lib.flash_attention_bwd_launch.restype = ctypes.c_int


def tensor_core_route(*tensors: torch.Tensor) -> bool:
    """Whether a kernel takes a tensor-core instance for these operands:
    bf16, a head_dim in ``TC_HEAD_DIMS``, and every row 16-byte aligned
    (the data pointer, and the batch, sequence and head strides a
    multiple of 8 elements), as the split route's 16-byte ``cp.async``
    copies and the TMA tensor maps of the ``wgmma`` route and the
    backward need.  Otherwise the CUDA-core instance runs."""
    first = tensors[0]
    if first.dtype != torch.bfloat16 or first.shape[-1] not in TC_HEAD_DIMS:
        return False
    return all(t.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in t.stride()[:-1])
               for t in tensors)


def split_plan(T: int, S: int, window: int = 0) -> tuple:
    """(k_begin, split_keys, n_split) of the split route: the keys any
    query can see, [k_begin, S) (a window moves the left edge to the
    first query's ``S - T - window + 1``), cut into ``n_split`` runs of
    ``split_keys`` keys from k_begin: whole ``SPLIT_CHUNK``s, as many as
    make about ``SPLITS`` runs.  A function of T, S and the window alone:
    never of the batch or the card, so a batch row's sums run in the same
    order alone as in any batch."""
    k_begin = max(0, S - T - window + 1) if window > 0 else 0
    n_keys = max(0, S - k_begin)
    chunks = max(1, -(-n_keys // SPLIT_CHUNK))
    split_keys = SPLIT_CHUNK * max(1, (chunks + SPLITS // 2) // SPLITS)
    return k_begin, split_keys, max(1, -(-n_keys // split_keys))


def forward_route(T: int, S: int, H: int, Hkv: int, hd: int,
                  dtype: torch.dtype, aligned: bool, window: int = 0):
    """(route, split plan or None) of the forward on the card: ``split``
    (with :func:`split_plan`) for bf16 whose g*T query rows of a kv head
    fit one ``SPLIT_ROWS``-row tile, ``wgmma`` for the rest of bf16, both
    at a head_dim in ``TC_HEAD_DIMS`` with 16-byte aligned rows
    (``aligned``: :func:`tensor_core_route`'s stride test); ``simt``
    otherwise."""
    if dtype != torch.bfloat16 or hd not in TC_HEAD_DIMS or not aligned:
        return "simt", None
    if (H // Hkv) * T <= SPLIT_ROWS:
        return "split", split_plan(T, S, window)
    return "wgmma", None


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
    return _forward(q, k, v, causal, window, softcap, None)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """:func:`flash_attention` and each row's natural log-sum-exp of its
    masked, scaled (and capped) scores: (out, lse [B, H, T] float32), the
    residuals :func:`flash_attention_bwd` reads.  A row with no visible
    key gets lse -1e30."""
    if q.device.type == "cpu":
        return ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                           window=window, softcap=softcap)
    B, T, H, _ = q.shape
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, causal, window, softcap, lse), lse


def _cuda(q: torch.Tensor, what: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if type(q).__name__ == "DTensor":
        # The kernel reads raw pointers: under a mesh the caller passes
        # each rank's shard (``layers.on_local_heads``).
        raise TypeError(f"{what}: a DTensor reached the kernel; pass its "
                        f"local shards")


# The split-KV arrival counters, one int32 array per (device index,
# stream); see :func:`arrival_counters`.
_COUNTERS: dict = {}


def arrival_counters(device: torch.device, stream: int,
                     n: int) -> torch.Tensor:
    """The arrival counters of ``stream`` for a split-KV launch (this
    module's split route and paged attention's two tensor-core routes):
    int32 zeros, at least ``n``, one array per (device, stream) so that
    two streams never share one; launches on one stream run in order, so
    they share it.  The split that finishes last resets its counter to
    0, so a launch leaves them as it found them."""
    key = (device.index, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = c
    return c


def _forward(q, k, v, causal: bool, window: int, softcap: float,
             lse: torch.Tensor | None) -> torch.Tensor:
    """Launch the forward kernel; ``lse`` ([B, H, T] f32) receives each
    row's log-sum-exp when given."""
    global launches, simt_launches, split_launches, noncausal_launches
    _cuda(q, "flash_attention")
    _check(q, k, v, window)
    lib = kbuild.load(SOURCE, _declare)
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    way, plan = forward_route(T, S, H, Hkv, hd, q.dtype,
                              tensor_core_route(q, k, v), window)
    if way == "wgmma":
        # TMA takes no zero stride (a broadcast operand): copy it first.
        q, k, v = _rows_readable(q), _rows_readable(k), _rows_readable(v)
    bq = 0
    if way == "simt":
        max_rows = lib.flash_attention_max_rows(hd)
        if max_rows < g:
            raise ValueError(f"flash_attention: head_dim {hd} with {g} "
                             "query heads per kv head does not fit shared "
                             "memory")
        bq = block_q_for(T, g, max_rows)
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    k_begin, split_keys, n_split = plan or (0, 0, 0)
    part = count = None
    if way == "split" and n_split > 1:
        # Each split's f32 accumulator [16, hd] and (max, sum) [2, 16].
        # n_split stays under the kernel's 64 (split_plan's runs).
        part = torch.empty(B * Hkv * n_split * SPLIT_ROWS * (hd + 2),
                           dtype=torch.float32, device=q.device)
        count = arrival_counters(q.device, stream, B * Hkv)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if part is None else part.data_ptr(),
        None if count is None else count.data_ptr(),
        _DTYPES[q.dtype], ROUTES.index(way), B, T, S, H, Hkv, hd, bq,
        k_begin, split_keys, n_split,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        int(causal), int(window), float(softcap), float(hd ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    simt_launches += way == "simt"
    split_launches += way == "split"
    noncausal_launches += 0 if causal else 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """The gradient of :func:`flash_attention`: (dq, dk, dv) from the
    forward's inputs, its output ``out``, its log-sum-exp ``lse`` [B, H,
    T] f32 and the cotangent ``dout`` [B, T, H, hd].  On the card, a dQ
    pass, then a dK/dV pass that sums the query heads of each kv head in
    registers: no atomics, so repeated calls are bit-identical, and
    nothing of size [T, S] is written.  dq, dk and dv are contiguous, in
    the dtypes of q, k, v.  One call counts one backward launch."""
    global bwd_launches, simt_launches
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                           causal=causal, window=window,
                                           softcap=softcap)
    _cuda(q, "flash_attention_bwd")
    _check(q, k, v, window)
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} does not match q")
    if (lse.shape != (B, H, T) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         "[B, H, T] float32 tensor beside q")
    # The cotangent may come broadcast (a sum's gradient); the kernels
    # read rows with a unit head_dim stride, and TMA takes no zero stride.
    q, k, v, out, dout = (_rows_readable(t) for t in (q, k, v, out, dout))
    lib = kbuild.load(BWD_SOURCE, _declare_bwd)
    dq = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, Hkv, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, Hkv, hd), dtype=v.dtype, device=q.device)
    ops = (q, k, v, out, dout, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*[st for t in ops
                                         for st in t.stride()[:3]])
    route = tensor_core_route(q, k, v, out, dout)
    # Each query row's D (and, on the tensor cores, its lse in log2 units,
    # both padded to whole 64-row tiles), written by the dQ pass for the
    # dK/dV pass.
    dsum = torch.empty((B, H, -(-T // 64), 2, 64) if route else (B, H, T),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], int(route), B, T,
        S, H, Hkv, hd, strides, int(causal), int(window), float(softcap),
        float(hd ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed "
                           f"(cudaError {err})")
    bwd_launches += 1
    simt_launches += 0 if route else 1
    return dq, dk, dv


def _rows_readable(t: torch.Tensor) -> torch.Tensor:
    """``t``, or its contiguous copy where the backward could not read it
    in place: a head_dim stride other than 1, or a zero stride over more
    than one element (a broadcast, which a TMA tensor map cannot
    describe)."""
    st = t.stride()
    if st[3] != 1 or (0 in st and any(x == 0 and n > 1
                                      for x, n in zip(st, t.shape))):
        return t.contiguous()
    return t


class _FlashTrainable(torch.autograd.Function):
    """Forward on the flash kernel, keeping its log-sum-exp; backward on
    the flash backward kernel (``_fa_fwd``/``_fa_bwd``,
    ``flash_attention.py:175-189``).  On the CPU both are the plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, window, softcap = ctx.opts
        with record_function("flash_attention_trainable.backward"):
            dq, dk, dv = flash_attention_bwd(
                *ctx.saved_tensors, dout, causal=causal, window=window,
                softcap=softcap)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              window: int = 0,
                              softcap: float = 0.0) -> torch.Tensor:
    """:func:`flash_attention` with a gradient.

    On CUDA the forward is the flash kernel, which also writes each row's
    log-sum-exp, and the backward is the flash backward kernel
    (:func:`flash_attention_bwd`), which recomputes the probabilities from
    (q, k, lse) tile by tile: no [T, S] tensor reaches device memory.  On
    the CPU both are the plain versions.  A recomputing checkpoint
    (``torch.utils.checkpoint``) re-runs the forward, and so its kernel,
    once more in the backward.  ``block_q``/``block_k``/``interpret`` of
    the JAX signature have no meaning here.
    """
    return _FlashTrainable.apply(q, k, v, causal, window, softcap)
