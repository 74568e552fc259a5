#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA Hopper card and the CUDA toolkit (``nvcc``).  Phases,
each of which fails the run hard:

1. device report: ``nvidia-smi`` name and power limit, torch and CUDA
   versions, and the build of every kernel from ``src/repro_torch`` (one
   ``nvcc`` per source, all started together), with the count of
   tensor-core instructions (HMMA/HGMMA in ``cuobjdump -sass``) in each
   kernel: every bf16 ``mma.sync`` kernel (the flash forward's split
   route and the paged chunk kernel, at head_dim 16/32/64/80/128) must
   have some, every ``wgmma`` instance HGMMA (the flash forward's at the
   five head dims with and without a softcap, the backward's, the NBB
   matmul's), no forward or backward instance a spill or a ``wgmma``
   that ptxas serialized, the forward's ``mma.sync`` tile kernel
   (``flash_fwd_tc``) gone, every float32 (CUDA-core) one none; and
   each built instance's shared memory, static (the compiler's) plus the
   dynamic bytes its launches ask for at most, under the card's
   ``shared_memory_per_block_optin``, the dynamic bytes equal to what
   the wrappers compute from their tile constants;
2. each kernel against its plain PyTorch version on the card: paged
   attention at the reference test shapes and the paged main path's (a
   strided per-layer view of a [512, 16, 30, 3, 64] pool), then its
   split-KV decode (with a lens=0 row and rows shorter than one run) and
   wgmma T=64 chunk (with softcap), each one launch a pass, twice,
   bit-identical, its arrival counters back at 0,
   then both at olmoe-1b-7b's shapes (hd 128, 16 kv heads, g 1) without
   and with the written-key bound ``kv_lens`` (rows of 0, below and equal
   to lens) against both plain versions; then the ring bound (a
   sliding-window ring read with wrap-around) on every route (simt in
   f32, the split decode and the wgmma chunk in bf16) at gemma3-27b's
   local-layer shapes (B=4, ring 1024 as 16 pages of
   64, 16 kv heads of 128, g 2, rows at n = 700/1024/1500/2047, T=1 and
   T=64, with and without ``kv_lens``, windows 1024 and 200) against both
   plain versions (f32 2e-5, bf16 3e-2), queries with no key exactly 0,
   and ring = P * ps over unwrapped rows bit-identical to no ring;
   flash
   attention at the reference test shapes, ragged T and S, and the dense
   main path's (B=1 causal prefills of 64/256/512 tokens over a ring
   slice, a T=1 decode at S=513 over a strided B=4 ring slice); the
   flash forward's split route (the wave's decode, llama-vision's and
   whisper's cross decodes, a window at T=1, 4 tokens x g 4 with softcap,
   S under one split, S=20000, queries with no key) against the plain
   version and the plain split form at the wrapper's plan, counted in
   ``split_launches``, repeats and batch rows alone bit-identical, its
   arrival counters back at 0, the bound rejecting a dropped key tile;
   and the dense decode read — the paged kernel over a [4, 1024] ring
   viewed as identity pages — against both plain versions; (2c) the NBB
   matmul at
   the reference test shapes in f32 and bf16, the f32 instance's one and
   13 K tiles, each bf16 instance's ring at 1, S-1, S+1 and 2S+1 K steps,
   ragged edges and the kernel benchmark's 512 x 1024 x 512 bf16, each
   twice, bit-identical, then one call through ``ops.nbb_matmul`` at that
   shape as its entry point's run; (2d) ``flash_attention_trainable`` (the flash
   forward and backward kernels): its output against the plain version
   and its gradients against ``ref.flash_attention_bwd_ref``, element by
   element, at the reference test's f32 case, a window + softcap GQA case
   in f32 and bf16, a bf16 window + softcap case over 16 key tiles and
   smollm's bf16 training shape; at head_dim 80, zamba2-2.7b's training
   shape (B=4, T=S=1024, 32/32 heads, bf16) and a ragged 32/8-head case
   with window + softcap (f32 2e-5, bf16); whisper-tiny's non-causal
   encoder (T=S=1500) and cross read (T=448, S=1500) at B=4, 6 heads of
   64 (f32 2e-5, bf16 3e-2 x max |plain|); at each training shape and
   each head_dim 80 and non-causal case the gradient bound must also
   reject the kernel's gradients with one tile (query rows x keys, all
   visible) left out; (2e)
   flash's non-causal route at the cross-attention families' shapes
   (llama-3.2-vision-11b's cross read of 1600 image tokens at T=1 and
   T=64, 32/8 heads of 128; whisper-tiny's encoder at T=S=1500 and its
   cross decode, 6 heads of 64), K/V read in place from a stacked cross
   cache, bf16 on the tensor-core instance (3e-2 x max |plain|, repeats
   bit-identical) and f32 on the CUDA-core one (2e-5), where each bound
   must also reject the kernel's output with a planted fault: the other
   superblock's K/V, the last key tile dropped, the 1/sqrt(hd) scale
   dropped; (2f) the head_dim 80 instances at zamba2-2.7b's shared
   attention (32/32 heads of 80, K/V read in place from [B, 1024] rings):
   flash at B=1, T=S of 64, 256 and 257 and at B=4, T=1, S=513, the paged
   split-KV decode over the ring as 64-token identity pages at B=4 (rows
   at lens 0, 1, 63, 64, 700, ...) and its T=64 chunk, bf16 on the
   tensor-core instances (3e-2 x max |plain| for the T=1 flash read, else
   3e-2) and f32 on the CUDA-core ones (2e-5), each bound rejecting the
   kernel's output with its last key tile dropped; (2g) the last three
   architectures' heads: the paged split (T=1) and wgmma (T=64) routes at
   qwen3-14b's 40/8 heads of 128 (g 5), arctic-480b's 56/8 (g 7) and
   stablelm-3b's 32/32 heads of 80 over real 16-slot pages (B=8, NaN in
   every slot past a row's keys) against both plain versions (3e-2),
   and flash's wgmma prefill and split read at the same heads over ring
   slices with NaN past S, each twice, bit-identical;
3. the paged main path at full width: ``smollm-135m`` (random weights
   from a seed) served by the ``slot_paged`` engine to 4 client sessions
   x 4 requests, every stream complete and exactly-once, the paged kernel
   launched 30 times per model forward, on its split-KV route 30 times
   per one-token decode forward; then where one dispatch's time
   goes.  In every served and trained run, every flash launch takes the
   split or the ``wgmma`` route (none the CUDA-core one);
4. the dense main path at full width: the same 16 requests under
   ``slot_fused`` (flash launches = 30 x prefills, paged launches and
   paged split launches = 30 x decode steps), then 4 requests each under
   ``slot_chunked`` and ``wave`` (its prefills on flash's ``wgmma``
   route, its decode steps on the split route: split launches = 30 x
   decode steps); then where a prefill's and a decode block's time goes;
3c-3e. the robustness paths of ``slot_paged`` at full width (30 layers,
   d=576, bf16, seed-0 weights; ``max_len=1024``, 16-token pages,
   ``chunk_tokens=64``, ``k_max=8``), each run driven inline, every kernel
   counter zeroed before it and read after it (paged launches = 30 x
   forwards, paged split launches = 30 x one-token forwards, no flash,
   no CUDA-core
   route); every served run of phases 3-5 without a fault plan must end
   with 0 watchdog catches and 0 failed requests in ``fault_report()``,
   so a device error cannot hide behind the watchdog: (3c) overload —
   2 priority classes, preemption, WFQ, 8 slots over 128 pages (47 MB of
   K/V), two low-class clients sending 4 requests each (400-480 prompt
   tokens, 64 new, one outstanding at a time), then, once both decode,
   two high-class clients 4 requests each at once (40-120 tokens, 32
   new): at least one preemption, every parked sequence resumed and
   finished, swap bytes whole pages, no negative page in any dispatched
   block table, each preempted request's stream byte-identical to the
   same request served alone, TTFT p50 per class printed; (3d) faults —
   ``FaultPlan.sweep(8, seed=0)`` over the eight sites this path probes,
   4 requests a plan, ``tick_retries=1``: no wedge, every failure an
   injected one (the watchdog's catches equal the raising faults fired),
   survivors byte-identical to the run with no fault; (3e) recovery —
   snapshots every 2 ticks, the engine abandoned at its second, middle
   and next-to-last tick and restored in a fresh engine from the newest
   snapshot plus the journal: every stream byte-identical to the
   uninterrupted run, snapshot bytes and restore times printed;
3f. the MoE family at full width: ``olmoe-1b-7b`` (16 layers, d=2048,
   16/16 heads of 128, 64 experts top-8, vocab 50304, bf16, seed-0
   weights) under ``slot_paged`` (``max_batch=8``, 512 pages,
   ``chunk_tokens=64``, ``k_max=8``) on the same 16 requests: every
   stream complete and exactly-once, paged launches = 16 x forwards,
   paged split launches = 16 x one-token forwards, no CUDA-core route,
   no watchdog
   catch; then where a decode block's and a chunk's time goes;
3g. the local:global family at full width: ``gemma3-27b`` (62 layers: 10
   superblocks of 5 local layers with a 1024-token window and 1 global,
   then 2 local; d=5376, 32/16 heads of 128, vocab 262144, bf16, seed-0
   weights drawn on the card a layer at a time, 54.0 GB; no cut), after
   olmoe's weights are freed: ``slot_chunked`` (``max_batch=4``,
   ``max_len=4096``, ``chunk_tokens=64``, ``k_max=8``) on 4 requests, two
   with prompts of 1100 and 1500 tokens so every local ring wraps in
   prefill and in decode, two of 480 and 40, 32 new tokens each: every
   stream complete and exactly-once, paged launches = 62 x forwards, ring
   launches = 52 x forwards, paged split launches = 62 x one-token
   forwards, no
   CUDA-core route, no watchdog catch; ``slot_fused`` on 2 requests (1100
   and 300 tokens): flash on the 10 global layers of the wrapped prefill
   and all 62 of the other, the ring bound on its 52 local layers and on
   every decode step's; then where a decode block's and a chunk's time
   goes (rows past the window), and the peak device memory;
3h. the vlm_cross family at full width: ``llama-3.2-vision-11b`` (8
   superblocks of 4 self layers and a cross layer at index 3, d=4096,
   32/8 heads of 128, d_ff 14336, vocab 128256 untied, 1600 image
   tokens, bf16, seed-0 weights, 19.55 GB; no cut), after gemma's
   weights are freed: (a) ``prefill`` of 2 prompts of 256 tokens with
   seeded image embeddings at ``max_len`` 1024, then 16 ``decode_step``s:
   two plumbing checks of the port against itself (every cross cache
   equal to ``cross_kv`` of the images; the last position's logits over
   the filled caches within 2^-8 x max |logit| of the cache-less
   ``forward(tokens, extras)``'s), tokens that differ from those with zero
   images, non-causal flash launches = 8 x forwards (the decode steps'
   one-token cross reads on the split route: 8 x steps) and the self
   layers' (flash prefill, paged decode) = 32 x forwards; (b)
   ``slot_chunked`` (``max_batch=4``, ``max_len=2048``,
   ``chunk_tokens=64``, ``k_max=8``) on 4 requests of 100-1000 tokens,
   32 new each: every stream exactly-once, non-causal flash = 8 x
   forwards, paged = 32 x forwards, no causal flash, no CUDA-core route,
   no watchdog catch, ``dense_cache_bytes`` and peak memory printed; then
   where a decode block's and a chunk's time goes;
3i. the enc_dec family at full width: ``whisper-tiny`` (4 encoder and 4
   decoder layers, d=384, 6 heads of 64, vocab 51865 tied, 1500 frames,
   bf16): ``prefill`` with seeded frames [4, 1500, 384] (the encoder on
   the non-causal route, 4 launches a prefill) and 16 decode steps at
   ``max_len`` 448, every cross cache equal to ``cross_kv`` of the
   encoder's output, the decode steps' cross reads on flash's split
   route (4 x steps); ``slot_chunked`` on 4 requests (split launches = 4
   x one-token forwards); the engine refusing ``slot_fused``;
3j. the zamba_hybrid family at full width: ``zamba2-2.7b`` (54 mamba2
   layers in 9 superblocks, each opened by the one shared attention block
   over its own ring; d=2560, 32/32 heads of 80, vocab 32000; bf16,
   seed-0 weights, 2,340,750,240 parameters built where ``param_count()``
   claims 5,092,515,840; no cut): a B=2 prefill of 60 tokens (the
   recurrence's scan) + 4 teacher-forced decode steps against the
   cache-less forward over the 64 tokens (its chunked form), logits
   within 2^-2 of the largest in bf16 and 2^-12 with the weights in
   float32; ``slot_fused`` (the launcher's fallback: neither chunkable
   nor pageable; ``max_batch=4``, ``max_len=1024``) on 4 requests of
   64-128 tokens, 32 new each: every stream exactly-once, flash launches
   = 9 x prefills, paged = 9 x decode steps, no CUDA-core route, no
   watchdog catch, peak memory; then where a prefill's and a decode
   block's time goes (the ranges ``mamba.ssd``, ``rwkv.wkv``);
3k. the uniform_rwkv family the same way: ``rwkv6-1.6b`` (24 layers,
   d=2048, vocab 65536 untied, 1,583,941,632 parameters), no attention
   launch of either kind;
3l-3n. the registry's last three architectures at full width, bf16,
   seed-0 weights, each under ``slot_paged`` (``max_batch=8``,
   ``max_len=1024``, 512 pages of 16, ``chunk_tokens=64``, ``k_max=8``) on
   the main workload's 16 requests: the parameter count, every stream
   complete and exactly-once, paged launches = L x forwards, paged split
   launches = L x one-token forwards, no flash, no CUDA-core route, no
   watchdog catch, then where a decode block's and a chunk's time goes
   and the peak device memory: (3l) ``qwen3-14b`` (40 layers, d=5120,
   40/8 heads of 128, qk-norm, vocab 151936 untied; no cut), then 2
   requests each under ``slot_fused`` (flash's wgmma prefills at g 5)
   and ``wave`` (its split-route decode), then the serve launcher's
   ``main`` with its own parser and default scheduler (``slot_chunked``)
   for 4 requests; (3m) ``stablelm-3b`` (32 layers, d=2560, 32/32 heads
   of 80, vocab 50304 untied; no cut): the paged kernel at hd 80 over
   real pages; (3n) ``arctic-480b`` at full width on 2 of its 35 layers
   (d=7168, 56/8 heads of 128, 128 experts top-2 beside a dense residual
   MLP, capacity 1 at decode and 10 in a chunk), its expert leaves drawn
   an expert at a time (the draw's peak under 80 GB, beside what one
   expert layer drawn whole took: the rule before);
5. CPU/CUDA parity: the SMOKE configs at float32, same weights on both
   devices, identical greedy tokens: smollm under ``slot_paged``,
   ``slot_fused`` and ``wave``, olmoe (weights x3) under ``slot_paged``
   and ``slot_fused``, gemma (weights x3) under ``slot_chunked`` and
   ``slot_fused`` with prompts of up to 30 tokens past its window of 8,
   llama-vision and whisper (weights x3) through ``prefill`` with an
   image or frame source + 4 decode steps and under ``slot_chunked``,
   zamba and rwkv (weights x3) under ``slot_fused``, ``slot`` and
   ``wave``, qwen3 and arctic widened to 10/2 and 14/2 heads (g 5 and 7;
   weights x3) under ``slot_paged`` and ``slot_fused``; and 3 training
   steps' losses (within 1e-4 relative) of the
   zamba, rwkv and whisper (with frames) SMOKE configs;
6. kernel timing at the main paths' shapes (CUDA events around windows
   enqueued behind a device-side spin, so they time the card's work and
   not the host's launch rate; paged: slot_paged's T=1 decode and T=64
   chunk, slot_fused's dense-ring decode, olmoe's T=1 and T=64 with
   ``kv_lens``; the ring bound at gemma's T=1 and T=64; non-causal
   flash at llama-vision's cross decode and chunk and whisper's
   encoder and cross decode; the flash forward's training shapes with
   lse at head_dim 64 and 80; head_dim 80 at zamba's B=1 T=S=256 prefill
   and B=4 dense-ring decode, and the trainable flash forward + backward
   and the backward alone at zamba's training shape; paged at 3l-3n's
   T=1 decode and T=64 chunk: qwen3's g 5, arctic's g 7, stablelm's hd 80
   over real pages, with ``kv_lens``; every flash forward
   row also with the host's µs to enqueue a call), beside each kernel's
   bound,
   its plain version and the one PyTorch call that computes the same
   function
   where there is one (``scaled_dot_product_attention`` forward, backward,
   and forward + backward for the trainable flash; ``torch.matmul`` for
   the NBB matmul, a gather into position order + masked SDPA for the
   ring bound: yardsticks the port never calls);
7. training at full width: ``smollm-135m`` through
   ``repro_torch.launch.train`` (batch 4 x 1024 tokens, remat "nothing",
   20 steps, 2 producer threads, async checkpoints every 10), the flash
   forward launched exactly 60 times a step (30 layers, forward and remat
   recompute) and the flash backward 30 times, the loss falling; a resume
   from its checkpoint for 5 more steps; where one step's time goes;
   CPU/CUDA parity of 3 SMOKE steps' losses at float32;
7b-7d. training at full width, no cut, 10 steps each with every loss
   and grad norm finite, the loss falling and no CUDA-core launch: (7b)
   ``zamba2-2.7b`` (2,340,750,240 parameters) and (7c) ``rwkv6-1.6b``
   (1,583,941,632) through ``repro_torch.launch.train`` (batch 4 x 1024,
   the recurrences' chunked form, remat "nothing", ``--ckpt-every 0``),
   zamba's flash forward launched 2 x 9 and its backward 9 times a step
   at head_dim 80 on the tensor cores, rwkv no attention kernel; each
   with where a step's time goes and the first step's gradient norm in
   bf16 against float32; (7d) ``whisper-tiny`` through ``Trainer`` on
   ``DataPipeline(extras_shape=(1500, 384))`` batches of 4 x 448 tokens,
   the pipeline's ``"extras"`` moved to ``"frame_embeds"`` here, with
   flash forward launches = 2 x (encoder + decoder self + cross layers) a
   step (the encoder's and the cross reads' on the non-causal route) and
   one backward per attention call;
8. the interleaving checker on the host, over the port's core: every
   scenario explored at its budget capped at 1500 executions (each
   verdict must be the scenario's ``expect``), the six schedules of
   ``tests/schedules/`` replayed, and the functional bit set on a CUDA
   tensor against ``HostBitset``;
9. parallelism on ``make_host_mesh()`` (1x1 ``("data", "model")``, an
   NCCL world of one): (9a) full-width ``smollm-135m`` trained through
   ``Trainer(mesh=, shardings=(param, opt state, batch))`` for 5 steps at
   batch 4 x 1024 (remat "nothing", seed 0) against the same 5 steps with
   no mesh — every loss equal (largest relative difference printed, 1e-3
   at most), equal flash forward and backward launches, none on the
   CUDA-core instance — then ``remesh(None, None)`` and 2 more steps
   equal to a run that never had a mesh, with each run's step wall and
   device time; (9b) one cache-less forward of full-width
   ``olmoe-1b-7b`` (B=2 x 256) under ``axis_rules(make_host_mesh())``:
   the expert-parallel route (64 local experts from 0, a data all-gather
   of the experts' weights and a model all-reduce each layer, counted by
   the accountant) against the local route, logits and aux; (9c)
   ``pipeline_apply`` at one stage under all three schedules against
   ``pipeline_reference`` (f32, 1e-5), and a scripted ``NBBState``
   sequence (fill to full, one BUFFER_FULL, drain, one BUFFER_EMPTY) and
   NBW writes and reads on CUDA tensors under
   ``torch.cuda.set_sync_debug_mode("error")``, equal to the same on the
   CPU; (9d) ``python -m repro_torch.launch.dryrun --arch smollm-135m
   --shape train_4k`` and ``--arch rwkv6-1.6b --shape prefill_32k`` (a
   recurrent family's cached prefill: its 32768-step scan planned by trip
   count), two processes started in the background at the lowest CPU
   priority once phase 7's smollm training has been timed, as they plan
   on the host's CPU: they share the host with phases 7b-10, and with no
   earlier phase; read after phase 10): each plan's per-device FLOPs,
   argument bytes, bytes, peak estimate and collective bytes by kind,
   printed as plan estimates, its argument bytes equal to the count
   derived from the specs and ``0 < bytes_min <= bytes``;
10. the four examples of ``examples_torch/`` on the card, each ``main``
   run in this process: (10a) ``quickstart`` for ``smollm-135m`` and
   ``olmoe-1b-7b`` (SMOKE, bf16, head_dim 16: one train step, prefill of
   8 tokens, 6 decode steps), loss and grad norm finite, 7 token ids in
   the vocabulary, flash forward and backward launched, none on the
   CUDA-core instance; (10b) ``train_e2e --full-135m`` (smollm-135m at
   full width: 30 layers, d=576) at batch 8 x 128 for 60 steps with its
   checkpoints under ``build/``, the loss falling, flash forward = 2 x 30
   and backward = 30 launches a step, then the same command for 10 steps,
   which must resume from step 60 and say so on its first line; (10c)
   ``serve_batched`` (``slot_fused``, 3 threaded clients x 2 streamed
   requests and a cancel mid-decode): every stream complete and exactly
   once, the cancelled request in one terminal state (cancelled, or
   completed where its 48 tokens finished first), every pool page free
   again, no watchdog catch; (10d) ``lockfree_pipeline_demo --ranks 1``
   (one rank: an NCCL world of one), every schedule matching
   ``pipeline_reference``.

Phase 7 runs before the timing of phase 6, which reports its launch
count; the paged row's launches add phases 3c-3g's to phase 3's, the
ring row's are 3g's launches under the ring bound, the non-causal
flash row's are 3h's and 3i's non-causal launches, the split route's
row's are its launches in phase 4's wave run, 3h and 3i (whisper's cross
decode row: 3i's), the hd 80 serving
rows' are 3j's served launches, the trainable flash and flash backward
rows' are phase 7's, 7d's and 10b's, the hd 80 training rows' are
7b's, and the rows of the last three architectures' paged reads
(``paged_attention_g5``, ``_g7``, ``_hd80_pages``) their ``slot_paged``
runs' in 3l-3n.
Every
kernel counter is set to 0 just before a served or trained run (or the
NBB matmul's entry-point call) and read just after it; launches made to
compare or time a kernel (or to serve a request alone for comparison)
are not counted.  A "phase time:" line gives each group of phases'
seconds.  Prints one
JSON line of kernel results, then the device line ``{"ok": true,
"device": {...}}`` last.  Exits non-zero, printing no result, without a
card or outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, bf16 / f32 math.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
MAIN = dict(n_pages=512, ps=16, L=30, Hkv=3, hd=64, B=8, H=9, P=64,
            chunk=64)
# olmoe-1b-7b's slot_paged path (phase 3f): the same pool geometry at hd
# 128 with one query head per kv head.
OLMOE = dict(MAIN, L=16, Hkv=16, hd=128, H=16)
# The dense main path (slot_fused): a [4, 1024] ring per layer, B=1
# prefills of bucketed prompts, B=4 decode.
DENSE = dict(L=30, B=4, size=1024, Hkv=3, hd=64, H=9, prefill=(64, 256, 512),
             decode_S=513)


def _to_device(tree, dev):
    """A nested dict of tensors, moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _to_dtype(tree, dtype):
    """A nested dict of tensors, cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _to_dtype(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


_LAP = [0.0]


def lap(label: str) -> None:
    """Print the seconds since the previous lap, so the script's time can
    be read phase by phase; ``lap("")`` only starts the clock."""
    now = time.monotonic()
    if label:
        print(f"phase time: {label} {now - _LAP[0]:.1f} s")
    _LAP[0] = now


def part_time(label: str) -> None:
    """Print the seconds since the previous lap, not restarting it: the
    parts of a long phase, read against the lap that closes it."""
    print(f"  part time: {label} {time.monotonic() - _LAP[0]:.1f} s "
          "into the phase")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_SPIN = {}


def spin(ms: float) -> None:
    """Hold the current stream for about ``ms`` ms (``torch.cuda._sleep``,
    its cycles per ms measured once)."""
    import torch
    if "cycles_per_ms" not in _SPIN:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        b.synchronize()
        _SPIN["cycles_per_ms"] = 10 ** 7 / a.elapsed_time(b)
    torch.cuda._sleep(int(ms * _SPIN["cycles_per_ms"]))


def timed(fn, reps: int = 5, inner: int = 50, with_host: bool = False):
    """Median device ms per call over ``reps`` CUDA-event windows of
    ``inner`` calls, after a warm-up.  Each window is enqueued behind a
    device-side spin longer than the host takes to enqueue it, so the
    events time the card's work, not the host's launch rate.  With
    ``with_host``, (ms, the host's µs per call to enqueue one)."""
    import torch
    for _ in range(5):
        fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(inner):
        fn(i)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        spin(2 * host_ms + 1)
        a.record()
        for i in range(inner):
            fn(i)
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    if with_host:
        return statistics.median(samples), host_ms * 1e3 / inner
    return statistics.median(samples)


# The flash forward's split-route launches in the served runs that make
# them (phase 4's wave decode steps, the cross reads of 3h's and 3i's
# one-token forwards), for phase 6's rows.
SPLIT_SERVED = {"wave": 0, "vlm": 0, "whisper": 0}


# ---------------------------------------------------------------------------
# Phase 1: device report and kernel build
# ---------------------------------------------------------------------------
def cuobjdump() -> str:
    """The CUDA toolkit's ``cuobjdump``, or the copy Triton ships."""
    import shutil
    found = shutil.which("cuobjdump")
    if found:
        return found
    candidates = [Path("/usr/local/cuda/bin/cuobjdump")]
    try:
        import triton
        candidates.append(Path(triton.__file__).parent / "backends" / "nvidia"
                          / "bin" / "cuobjdump")
    except ImportError:
        pass
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("chip smoke failed: no cuobjdump to read the SASS")


def tensor_core_counts(lib, opcodes=("HMMA", "HGMMA")) -> dict:
    """{kernel function: count of ``opcodes`` instructions} in ``lib``."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and any(op in line for op in opcodes):
            counts[fn] += 1
    return counts


def phase_build():
    import torch
    from repro_torch.kernels import (build, flash_attention, nbb_matmul,
                                     paged_attention)
    sources = {"paged_attention": paged_attention.SOURCE,
               "flash_attention": flash_attention.SOURCE,
               "flash_attention_bwd": flash_attention.BWD_SOURCE,
               "nbb_matmul": nbb_matmul.SOURCE}
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(sources)) as ex:    # one nvcc per source
        libs = dict(zip(sources, ex.map(build.build, sources.values())))
    dt = time.monotonic() - t0
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}")
    print(f"kernel build: {dt:.1f} s ({', '.join(libs)})")
    spills, serialized = {}, set()
    for name, lib in libs.items():
        kernel = name
        for line in Path(lib).with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = demangle(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print(f"  {kernel}: {line.split(':', 1)[-1].strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
                if m:
                    spills[kernel] = int(m[1]) + int(m[2])
            elif "warning" in line or "Performance Loss" in line:
                print(f"  {kernel}: {line.strip()}")
                if "wgmma" in line and "serialized" in line:
                    serialized.add(kernel)
    # Tensor-core instructions in the SASS: each bf16 tensor-core instance
    # must issue them (HMMA, mma.sync, in the flash forward's and paged
    # attention's split routes, flash_fwd_split<hd> and paged_split<hd>;
    # HGMMA, wgmma, in each of the flash forward's flash_fwd_wgmma<hd,
    # softcap>, paged attention's paged_chunk<hd, softcap>, the flash
    # backward's flash_bwd_{dq,dkdv}_wgmma<hd> and the NBB matmul's
    # nbb_wgmma_kernel<...>), each float32 instance none (flash_*_simt<T>,
    # paged_simt<float>, nbb_simt_kernel): no TF32.
    rules = {  # source: (tensor-core needle, least count, f32 needles, least)
        "flash_attention": ("_fwd_wgmmaI", 10, ("_simtI",), 2),
        "flash_attention_bwd": ("_wgmmaI", 20, ("_simtI",), 2),
        "paged_attention": ("paged_chunkI", 10, ("paged_simtIf",), 1),
        "nbb_matmul": ("nbb_wgmma_kernelI", 2, ("nbb_simt_kernel",), 1)}
    for name, (tc_needle, n_tc, f32_needles, n_f32) in rules.items():
        counts = tensor_core_counts(libs[name])
        tc = {f: n for f, n in counts.items() if tc_needle in f}
        f32 = {f: n for f, n in counts.items()
               if any(x in f for x in f32_needles)}
        check(len(tc) >= n_tc and all(n > 0 for n in tc.values()),
              f"{name}: a tensor-core kernel without HMMA/HGMMA: {tc}")
        check(len(f32) >= n_f32 and not any(f32.values()),
              f"{name}: a float32 kernel with HMMA/HGMMA: {f32}")
        hgmma = tensor_core_counts(libs[name], ("HGMMA",))
        check(all(hgmma[f] > 0 for f in tc),
              f"{name}: a wgmma instance without HGMMA: {hgmma}")
        if name == "paged_attention":
            # The chunk route's wgmma at each head dim, with and without a
            # softcap; the split route's mma.sync at each; no combine
            # kernel, no mma.sync chunk kernel; no spill in either route.
            dims = {int(re.search(r"ILi(\d+)E", f)[1]) for f in tc}
            split = {f: n for f, n in counts.items() if "paged_splitI" in f}
            check(dims == {16, 32, 64, 80, 128} and len(tc) == 10,
                  f"paged_attention: the wgmma instances "
                  f"{sorted(map(demangle, tc))}")
            check(len(split) == 5 and all(split.values())
                  and not any(hgmma[f] for f in split),
                  f"paged_attention: the split instances {split}")
            check(not any("paged_combine" in f or "chunk_tc" in f
                          for f in counts),
                  "paged_attention: paged_combine or paged_chunk_tc is "
                  "still built")
            spilled = {k: n for k, n in spills.items()
                       if ("paged_chunk" in k or "paged_split" in k) and n}
            check(not spilled, f"paged_attention: spills {spilled}")
        if name == "flash_attention":
            # The forward's routes: a wgmma instance at each of the five
            # head dims, with and without a softcap, and a split instance
            # (mma.sync) at each; the mma.sync tile kernel of before is
            # gone; no spill, no serialized wgmma.
            dims = {int(re.search(r"ILi(\d+)E", f)[1]) for f in tc}
            split = {f: n for f, n in counts.items() if "_fwd_splitI" in f}
            check(dims == {16, 32, 64, 80, 128} and len(tc) == 10,
                  f"flash_attention: the wgmma instances "
                  f"{sorted(map(demangle, tc))}")
            check(len(split) == 5 and all(split.values()),
                  f"flash_attention: the split instances {split}")
            check(not any("_fwd_tcI" in f for f in counts),
                  "flash_attention: flash_fwd_tc is still built")
            spilled = {k: n for k, n in spills.items()
                       if "flash_fwd_" in k and n}
            check(not spilled, f"flash_attention: spills {spilled}")
            check(not any("flash_fwd_" in k for k in serialized),
                  f"flash_attention: ptxas serialized the wgmma of "
                  f"{sorted(serialized)}")
        if name == "flash_attention_bwd":
            # Every head dim of the route, zamba's 80 included, in both
            # passes, with and without a softcap; no per-head partial sum
            # left; no spill.
            dims = {int(re.search(r"ILi(\d+)E", f)[1]) for f in tc}
            hd80 = {f: n for f, n in tc.items() if "ILi80E" in f}
            check(dims == {16, 32, 64, 80, 128} and len(tc) == 20
                  and len(hd80) == 4, f"flash_attention_bwd: the wgmma "
                  f"instances {sorted(map(demangle, tc))}")
            check(not any("sum_heads" in f for f in counts),
                  "flash_attention_bwd: flash_bwd_sum_heads is still built")
            spilled = {k: n for k, n in spills.items()
                       if "flash_bwd_" in k and "_wgmma" in k and n}
            check(not spilled, f"flash_attention_bwd: spills {spilled}")
            check(not any("flash_bwd_" in k for k in serialized),
                  f"flash_attention_bwd: ptxas serialized the wgmma of "
                  f"{sorted(serialized)}")
        print(f"  {name} SASS tensor-core instructions (HMMA/HGMMA): "
              + ", ".join(sorted(f"{demangle(f)} {n}"
                                 for f, n in counts.items())))
    phase_smem()


def phase_smem() -> None:
    """Phase 1's shared-memory line of each library: every instance's
    static + dynamic bytes and their share of the card's opt-in limit a
    block; fails if one exceeds it or if a library's instances or dynamic
    sizes differ from its wrapper's (``ops.shared_memory``)."""
    import torch
    from repro_torch.kernels import ops
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    print(f"shared memory a block may ask for (opt-in): {optin} bytes")
    for name, (rows, want) in ops.shared_memory().items():
        check({r[0]: r[2] for r in rows} == want,
              f"{name}: the built instances' dynamic shared memory "
              f"{rows} is not the wrapper's {want}")
        over = [r for r in rows if r[1] + r[2] > optin]
        check(not over, f"{name}: over the opt-in limit {optin}: {over}")
        print(f"  {name} shared memory (static + dynamic, share of "
              f"{optin}): " + ", ".join(
                  f"{n} {st}+{dyn} ({(st + dyn) / optin:.1%})"
                  for n, st, dyn in rows))


def demangle(mangled: str) -> str:
    """``flash_fwd_wgmma<64, false>`` for a kernel's mangled name
    (``c++filt``)."""
    full = subprocess.run(["c++filt", mangled], capture_output=True,
                          text=True, check=True).stdout
    return full.replace("(anonymous namespace)::", "").split("(")[0] \
        .removeprefix("void ")


# ---------------------------------------------------------------------------
# Phase 2: each kernel vs its plain version on the card
# ---------------------------------------------------------------------------
REF_CASES = [
    dict(seed=0, B=3, T=1, H=4, Hkv=2, hd=32, n_pages=32, ps=8, P=4,
         lens=[9, 1, 31]),
    dict(seed=1, B=2, T=8, H=4, Hkv=4, hd=16, n_pages=24, ps=8, P=3,
         lens=[8, 20]),
    dict(seed=2, B=2, T=1, H=8, Hkv=1, hd=16, n_pages=16, ps=4, P=4,
         lens=[5, 13]),
    dict(seed=2, B=2, T=1, H=6, Hkv=2, hd=16, n_pages=16, ps=4, P=4,
         lens=[5, 13]),
    dict(seed=2, B=2, T=1, H=9, Hkv=3, hd=16, n_pages=16, ps=4, P=4,
         lens=[5, 13]),
    dict(seed=3, B=1, T=1, H=2, Hkv=2, hd=16, n_pages=8, ps=8, P=4,
         lens=[7]),
    dict(seed=3, B=1, T=1, H=2, Hkv=2, hd=16, n_pages=8, ps=8, P=4,
         lens=[8]),
    dict(seed=3, B=1, T=1, H=2, Hkv=2, hd=16, n_pages=8, ps=8, P=4,
         lens=[9]),
    dict(seed=5, B=2, T=1, H=2, Hkv=2, hd=16, n_pages=16, ps=4, P=4,
         lens=[0, 11]),
]
TOLS = {"float32": 1e-4, "bfloat16": 3e-2}


def ref_case(torch, c):
    import numpy as np
    rng = np.random.default_rng(c["seed"])
    q = rng.normal(size=(c["B"], c["T"], c["H"], c["hd"]))
    kv = (c["n_pages"], c["ps"], c["Hkv"], c["hd"])
    k, v = rng.normal(size=kv), rng.normal(size=kv)
    block = rng.permutation(c["n_pages"])[:c["B"] * c["P"]].reshape(
        c["B"], c["P"])
    f = lambda a, dt: torch.tensor(a, dtype=dt, device="cuda")  # noqa: E731
    return (f(q, torch.float32), f(k, torch.float32), f(v, torch.float32),
            f(block, torch.int32), f(np.asarray(c["lens"]), torch.int32))


def main_path_inputs(torch, T: int, seed: int, m=MAIN):
    """A bf16 pool of the main path's shape (``m``: MAIN or OLMOE), a
    block table of disjoint scattered pages and lengths like the served
    traffic's (bucketed prompts of 64..512 tokens plus up to 32
    generated)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (m["n_pages"], m["ps"], m["L"], m["Hkv"], m["hd"])
    pk = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    pv = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    block = torch.randperm(m["n_pages"], generator=g, device="cuda")[
        :m["B"] * m["P"]].reshape(m["B"], m["P"]).to(torch.int32)
    if T == 1:
        lens = torch.randint(65, 545, (m["B"],), generator=g, device="cuda")
    else:
        lens = (torch.randint(0, 8, (m["B"],), generator=g, device="cuda")
                * T + T)
    q = torch.randn((m["B"], T, m["H"], m["hd"]), generator=g,
                    device="cuda").to(torch.bfloat16)
    return q, pk, pv, block, lens.to(torch.int32)


def phase_compare():
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {}
    for c in REF_CASES:
        base = ref_case(torch, c)
        for dt_name, tol in TOLS.items():
            dt = getattr(torch, dt_name)
            q, k, v = (t.to(dt) for t in base[:3])
            out = pa.paged_attention(q, k, v, base[3], base[4])
            torch.cuda.synchronize()
            want = ref.paged_attention_ref(q, k, v, base[3], base[4])
            err = (out.float() - want.float()).abs().max().item()
            check(err <= tol, f"reference case {c} {dt_name}: err {err}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
            # Poison: every block entry at or past a row's extent points at
            # a page full of 1e4; the output must not move by a bit.
            ps, P = k.shape[1], base[3].shape[1]
            used = (base[4][:, None].long()
                    > torch.arange(P, device="cuda")[None, :] * ps)
            block2 = torch.where(used, base[3], k.shape[0]).to(torch.int32)
            poison = torch.full((1,) + tuple(k.shape[1:]), 1e4, dtype=dt,
                                device="cuda")
            out2 = pa.paged_attention(q, torch.cat([k, poison]),
                                      torch.cat([v, poison]), block2,
                                      base[4])
            torch.cuda.synchronize()
            check(torch.equal(out, out2), f"poison pages leaked: {c}")
    main_err = 0.0
    for T in (1, MAIN["chunk"]):
        q, pk, pv, block, lens = main_path_inputs(torch, T, seed=T)
        for li in (0, MAIN["L"] - 1):
            kview, vview = pk[:, :, li], pv[:, :, li]
            check(not kview.is_contiguous(), "layer view is contiguous")
            for dt_name, tol in TOLS.items():
                dt = getattr(torch, dt_name)
                args = (q.to(dt), kview.to(dt), vview.to(dt)) \
                    if dt_name == "float32" else (q, kview, vview)
                out = pa.paged_attention(*args, block, lens)
                torch.cuda.synchronize()
                want = ref.paged_attention_ref(*args, block, lens)
                err = (out.float() - want.float()).abs().max().item()
                check(err <= tol, f"main shape T={T} layer {li} "
                                  f"{dt_name}: err {err}")
                if dt_name == "bfloat16":
                    main_err = max(main_err, err)
    split_err = phase_compare_split()
    olmoe_err = phase_compare_olmoe()
    print(f"kernel vs plain: reference cases (and their poison-page "
          f"variants, bit-identical) max err f32 "
          f"{worst['float32']:.3g} (tol 1e-4), bf16 "
          f"{worst['bfloat16']:.3g} (tol 3e-2); main-path shapes bf16 "
          f"max err {main_err:.3g}")
    return max(main_err, split_err, olmoe_err)


# (label, B, T, lens, softcap): the split-KV decode at the paged main
# path's table (B=8, ps=16, P=64: 8 runs of 128 keys) with a lens=0
# row, rows shorter than one run and one that ends on a run's edge; the
# T=64 wgmma chunk (2 runs of 512) with a row shorter than T, one past
# the table, and softcap.
SPLIT_CASES = [
    ("split decode", 8, 1, [0, 5, 63, 64, 65, 300, 545, 1024], 0.0),
    ("split decode softcap", 8, 1, [1, 17, 128, 129, 700, 64, 1000, 2],
     30.0),
    ("tensor-core chunk T=64", 4, 64, [64, 300, 40, 1100], 0.0),
    ("tensor-core chunk T=64 softcap", 4, 64, [64, 300, 40, 1100], 30.0),
]


def phase_compare_split():
    """The tensor-core routes at the paged main path's shapes (a strided
    layer view of the bf16 pool): each against the plain version and the
    plain split-KV version at the wrapper's plan (which merges the runs as
    the kernel does), its route and launch counts (one launch a pass, the
    merge in it), two calls bit-identical, and the arrival counters back
    at 0.  Returns the max bf16 error."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    m = MAIN
    _, pk, pv, block, _ = main_path_inputs(torch, 1, seed=40)
    kview, vview = pk[:, :, 3], pv[:, :, 3]
    g = torch.Generator(device="cuda").manual_seed(41)
    worst, lines = 0.0, []
    for label, B, T, lens, cap in SPLIT_CASES:
        q = torch.randn((B, T, m["H"], m["hd"]), generator=g,
                        device="cuda").to(torch.bfloat16)
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        blk = block[:B]
        way = pa.route(q, kview, vview)
        check(way == ("split" if T == 1 else "wgmma"),
              f"{label}: route {way}")
        before = (pa.launches, pa.split_launches)
        out = pa.paged_attention(q, kview, vview, blk, ln, softcap=cap)
        again = pa.paged_attention(q, kview, vview, blk, ln, softcap=cap)
        torch.cuda.synchronize()
        splits = 2 if way == "split" else 0
        check((pa.launches - before[0], pa.split_launches - before[1])
              == (2, splits), f"{label}: launches")
        check(counters_at_zero(), f"{label}: arrival counters not at 0")
        check(torch.equal(out, again), f"{label}: two calls differ")
        want = ref.paged_attention_ref(q, kview, vview, blk, ln, softcap=cap)
        err = (out.float() - want.float()).abs().max().item()
        split_keys = pa.plan(q, kview, vview, blk)[1][0]
        want2 = ref.paged_attention_split_ref(q, kview, vview, blk, ln,
                                              split_keys, softcap=cap)
        err = max(err, (out.float() - want2.float()).abs().max().item())
        check(err <= TOLS["bfloat16"], f"{label}: err {err}")
        check(torch.count_nonzero(out[ln <= 0]) == 0,
              f"{label}: a lens=0 row is not zero")
        worst = max(worst, err)
        lines.append(f"{label} ({way}, B={B}, lens {lens}) {err:.3g}")
    print("redesigned paged routes vs plain (bf16, tol 3e-2; two calls "
          "bit-identical): " + "; ".join(lines))
    return worst


# olmoe's kv_lens per row (B=8) beside lens, per T: 0 (an idle slot),
# below lens (a dead decode row, a padded chunk tail) and equal to lens.
OLMOE_KV_LENS = {1: lambda lens: [0, 0] + [max(0, n - 1) for n in lens[2:5]]
                 + lens[5:],
                 64: lambda lens: [0, 0] + [n - 20 for n in lens[2:5]]
                 + lens[5:]}


def phase_compare_olmoe():
    """The paged kernel at olmoe-1b-7b's main-path shapes (hd 128, 16 kv
    heads, g 1; strided layer views of a [512, 16, 16, 16, 128] bf16
    pool): the T=1 split-KV decode (8 runs of 128 keys, merged in the
    launch) and the T=64 wgmma chunk, without and with ``kv_lens`` (rows
    of 0, below and equal to lens), against both plain versions; zero
    rows exact, two calls bit-identical, kv_lens = lens bit-identical to
    no kv_lens.  Returns the max bf16 error."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    m = OLMOE
    worst, lines = 0.0, []
    for T in (1, m["chunk"]):
        q, pk, pv, block, lens = main_path_inputs(torch, T, 50 + T, m)
        kview, vview = pk[:, :, 5], pv[:, :, 5]
        way = pa.route(q, kview, vview)
        check(way == ("split" if T == 1 else "wgmma"),
              f"olmoe T={T}: route {way}")
        split_keys, n_split = pa.plan(q, kview, vview, block)[1]
        check(n_split > 1, f"olmoe T={T}: split plan "
                           f"{(split_keys, n_split)} does not split")
        kl = torch.tensor(OLMOE_KV_LENS[T](lens.tolist()), dtype=torch.int32,
                          device="cuda")
        for kv_lens in (None, kl):
            before = (pa.launches, pa.split_launches, pa.simt_launches)
            out = pa.paged_attention(q, kview, vview, block, lens,
                                     kv_lens=kv_lens)
            again = pa.paged_attention(q, kview, vview, block, lens,
                                       kv_lens=kv_lens)
            torch.cuda.synchronize()
            split = way == "split"
            check((pa.launches - before[0], pa.split_launches - before[1],
                   pa.simt_launches - before[2]) == (2, 2 * split, 0),
                  f"olmoe T={T}: launches")
            check(counters_at_zero(), f"olmoe T={T}: arrival counters not "
                                      "at 0")
            check(torch.equal(out, again), f"olmoe T={T}: two calls differ")
            want = ref.paged_attention_ref(q, kview, vview, block, lens,
                                           kv_lens=kv_lens)
            want2 = ref.paged_attention_split_ref(
                q, kview, vview, block, lens, split_keys, kv_lens=kv_lens)
            err = max((out.float() - w.float()).abs().max().item()
                      for w in (want, want2))
            check(err <= TOLS["bfloat16"], f"olmoe T={T} kv_lens "
                                           f"{kv_lens is not None}: err {err}")
            if kv_lens is not None:
                check(torch.count_nonzero(out[kv_lens == 0]) == 0,
                      f"olmoe T={T}: a kv_lens=0 row is not zero")
            worst = max(worst, err)
            lines.append(f"T={T} ({way}) kv_lens "
                         f"{'-' if kv_lens is None else kv_lens.tolist()} "
                         f"{err:.3g}")
        same = pa.paged_attention(q, kview, vview, block, lens,
                                  kv_lens=torch.maximum(lens, kl))
        check(torch.equal(same, pa.paged_attention(q, kview, vview, block,
                                                   lens)),
              f"olmoe T={T}: kv_lens = lens changed the output")
    print("paged at olmoe-1b-7b's shapes (hd 128, Hkv 16, g 1) vs both "
          "plain versions (bf16, tol 3e-2; two calls bit-identical): "
          + "; ".join(lines))
    return worst


# gemma3-27b's local layers (phase 3g): a [4, 1024] ring per layer of 16
# kv heads of 128, 32 query heads (g 2), read as 16 identity pages of 64
# slots, window 1024.
GEMMA = dict(B=4, size=1024, ps=64, Hkv=16, H=32, hd=128, window=1024,
             chunk=64)
# Row counts n (keys written once the dispatch's writes land): below the
# ring, at it, past it and one short of two rings.
GEMMA_N = [700, 1024, 1500, 2047]
# (label, T, n_valid per row or None): T=1 decode; T=64 chunks; with
# kv_lens (a write mask) rows that wrote all, part or none of the chunk,
# and a dead decode row.
RING_CASES = [
    ("decode", 1, None),
    ("decode kv_lens", 1, [1, 0, 1, 0]),
    ("chunk", 64, None),
    ("chunk kv_lens", 64, [64, 10, 0, 37]),
]


def gemma_ring(torch, seed: int, dt=None):
    """K and V of one gemma local layer's [4, 1024, 16, 128] ring (bf16
    by default), viewed as 64 identity pages of 64 slots, and its block
    table."""
    d = GEMMA
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (d["B"] * d["size"] // d["ps"], d["ps"], d["Hkv"], d["hd"])
    k, v = (torch.randn(shape, generator=g, device="cuda").to(
        dt or torch.bfloat16) for _ in range(2))
    block = torch.arange(shape[0], dtype=torch.int32, device="cuda").view(
        d["B"], d["size"] // d["ps"])
    return k, v, block


def ring_inputs(torch, T: int, n_valid, seed: int, dt):
    """(q, lens, kv_lens or None) of a ring read at GEMMA_N: lens = cp +
    T; with n_valid, kv_lens = cp + n_valid = n."""
    d = GEMMA
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((d["B"], T, d["H"], d["hd"]), generator=g,
                    device="cuda").to(dt)
    n = torch.tensor(GEMMA_N, dtype=torch.int32, device="cuda")
    if n_valid is None:
        return q, n, None
    cp = n - torch.tensor(n_valid, dtype=torch.int32, device="cuda")
    return q, (cp + T).to(torch.int32), n


def phase_compare_ring():
    """The ring bound (a sliding-window ring read with wrap-around) on
    every route at gemma3-27b's local-layer shapes: T=1 and T=64 on
    ``split`` and ``wgmma`` in bf16 and ``simt`` in f32, with and
    without ``kv_lens``, window 1024 and a window of 200 inside it; each
    against both plain versions, queries that see no key exactly 0, two
    calls bit-identical; and ring = P * ps with window 0 over rows that
    never wrapped bit-identical to the call without the new arguments.
    Returns the max bf16 error."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    d = GEMMA
    tols = {"float32": 2e-5, "bfloat16": 3e-2}
    worst, lines = {}, []
    for dt_name, tol in tols.items():
        dt = getattr(torch, dt_name)
        k, v, block = gemma_ring(torch, 60, dt)
        for label, T, n_valid in RING_CASES:
            for window in (d["window"], 200):
                if window != d["window"] and dt_name == "float32":
                    continue
                q, lens, kv_lens = ring_inputs(torch, T, n_valid, 61 + T, dt)
                kw = dict(kv_lens=kv_lens, ring=d["size"], window=window)
                way = pa.route(q, k, v)
                want_way = ("simt" if dt_name == "float32" else
                            "split" if T == 1 else "wgmma")
                check(way == want_way, f"ring {label} {dt_name}: route {way}")
                before = (pa.launches, pa.split_launches,
                          pa.simt_launches, pa.ring_launches)
                out = pa.paged_attention(q, k, v, block, lens, **kw)
                again = pa.paged_attention(q, k, v, block, lens, **kw)
                torch.cuda.synchronize()
                # simt splits a long chunk along T: several passes a call.
                n = pa.launches - before[0]
                check(n >= 2 and (pa.split_launches - before[1],
                                  pa.simt_launches - before[2],
                                  pa.ring_launches - before[3])
                      == (n * (way == "split"), n * (way == "simt"), n)
                      and (way == "simt" or n == 2),
                      f"ring {label} {dt_name}: launches")
                check(torch.equal(out, again),
                      f"ring {label} {dt_name}: two calls differ")
                check(counters_at_zero(), f"ring {label} {dt_name}: "
                                          "arrival counters not at 0")
                split_keys = pa.split_plan(T, block.shape[1] * d["ps"],
                                           d["size"], window)[0]
                wants = (ref.paged_attention_ref(q, k, v, block, lens, **kw),
                         ref.paged_attention_split_ref(
                             q, k, v, block, lens, split_keys, **kw))
                err = max((out.float() - w.float()).abs().max().item()
                          for w in wants)
                check(err <= tol, f"ring {label} window {window} {dt_name}: "
                                  f"err {err}")
                empty = wants[0].float().abs().amax((2, 3)) == 0   # [B, T]
                check(torch.count_nonzero(out[empty]) == 0,
                      f"ring {label} {dt_name}: a query with no key is "
                      "not zero")
                worst[dt_name] = max(worst.get(dt_name, 0.0), err)
                lines.append(f"{label} T={T} window {window} {dt_name} "
                             f"({way}) {err:.3g}")
        # Rows that never wrapped: the ring bound at ring = P * ps, window
        # 0, is the bound without it, bit for bit.
        for T, n_valid in ((1, [1, 1, 0, 1]), (64, [64, 5, 0, 64])):
            q, _, _ = ring_inputs(torch, T, None, 70 + T, dt)
            n = torch.tensor([64, 700, 1000, 1024], dtype=torch.int32,
                             device="cuda")
            cp = n - torch.tensor(n_valid, dtype=torch.int32, device="cuda")
            lens = (cp + T).to(torch.int32)
            plain = pa.paged_attention(q, k, v, block, lens, kv_lens=n)
            ringed = pa.paged_attention(q, k, v, block, lens, kv_lens=n,
                                        ring=d["size"])
            torch.cuda.synchronize()
            check(torch.equal(plain, ringed), f"ring = P * ps, T={T} "
                                              f"{dt_name}: not bit-identical")
    print("paged ring bound at gemma3-27b's local shapes (B=4, ring 1024 = "
          "16 pages of 64, Hkv 16, H 32, hd 128; n " + str(GEMMA_N)
          + ") vs both plain versions (tol f32 2e-5, bf16 3e-2; two calls "
          "bit-identical; ring = P * ps on unwrapped rows bit-identical to "
          "no ring): " + "; ".join(lines))
    return worst["bfloat16"]


# (B, T, S, H, Hkv, hd, kwargs): tests/test_kernels.py and
# tests/test_kernels_decode.py, then ragged T and S.
FLASH_CASES = [
    (1, 128, 128, 4, 4, 64, {}),
    (2, 128, 256, 8, 2, 64, {}),
    (1, 256, 256, 6, 3, 128, {}),
    (1, 512, 512, 4, 4, 64, {"window": 128}),
    (1, 1, 1024, 4, 4, 64, {"window": 256}),
    (1, 512, 512, 4, 4, 64, {"window": 512}),
    (1, 128, 128, 2, 2, 64, {"softcap": 50.0}),
    (1, 128, 256, 4, 4, 64, {"causal": False}),
    (2, 1, 512, 8, 2, 64, {}),
    (1, 128, 128, 16, 1, 64, {}),
    (1, 128, 128, 12, 4, 64, {}),
    (1, 128, 128, 9, 3, 64, {}),
    (2, 37, 101, 9, 3, 64, {}),
    (1, 45, 77, 6, 2, 32, {"window": 20, "softcap": 30.0}),
    (1, 3, 70, 4, 1, 16, {"causal": False}),
]


def dense_ring(torch, B: int, seed: int):
    """bf16 K and V rings of the dense main path: [L, B, 1024, Hkv, hd]."""
    d = DENSE
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (d["L"], B, d["size"], d["Hkv"], d["hd"])
    return tuple(torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))


def phase_compare_flash():
    """Flash kernel vs plain: reference and ragged cases in f32 (TF32
    off) and bf16, then the dense main path's shapes in bf16 over ring
    slices read in place.  Returns the main-path bf16 max error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {}
    g = torch.Generator(device="cuda").manual_seed(21)
    for B, T, S, H, Hkv, hd, kw in FLASH_CASES:
        q = torch.randn((B, T, H, hd), generator=g, device="cuda")
        k = torch.randn((B, S, Hkv, hd), generator=g, device="cuda")
        v = torch.randn((B, S, Hkv, hd), generator=g, device="cuda")
        for dt_name, tol in TOLS.items():
            dt = getattr(torch, dt_name)
            args = (q.to(dt), k.to(dt), v.to(dt))
            out = fa.flash_attention(*args, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(*args, **kw)
            err = (out.float() - want.float()).abs().max().item()
            check(err <= tol, f"flash case {(B, T, S, H, Hkv, hd, kw)} "
                              f"{dt_name}: err {err}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
    d = DENSE
    main_err = 0.0
    rk1, rv1 = dense_ring(torch, 1, seed=22)
    rk4, rv4 = dense_ring(torch, d["B"], seed=23)
    shapes = [(rk1, rv1, T, T) for T in d["prefill"]]
    shapes.append((rk4, rv4, 1, d["decode_S"]))
    for rk, rv, T, S in shapes:
        B = rk.shape[1]
        q = torch.randn((B, T, d["H"], d["hd"]), generator=g,
                        device="cuda").to(torch.bfloat16)
        for li in (0, d["L"] - 1):
            k, v = rk[li][:, :S], rv[li][:, :S]
            check(B == 1 or not k.is_contiguous(), "ring slice contiguous")
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v)
            err = (out.float() - want.float()).abs().max().item()
            check(err <= TOLS["bfloat16"],
                  f"flash main shape B={B} T={T} S={S}: err {err}")
            main_err = max(main_err, err)
    print(f"flash vs plain: {len(FLASH_CASES)} reference/ragged cases max "
          f"err f32 {worst['float32']:.3g} (tol 1e-4), bf16 "
          f"{worst['bfloat16']:.3g} (tol 3e-2); dense main-path shapes "
          f"(B=1 T=S in {d['prefill']}, B=4 T=1 S={d['decode_S']}, bf16, "
          f"ring slices) max err {main_err:.3g}")
    return main_err


# The forward's split route (label, B, T, S, H, Hkv, hd, kwargs): the
# wave's decode over ring slices, the cross decodes of llama-3.2-vision-
# 11b (S=1600, g 4, hd 128) and whisper-tiny (S=1500, g 1), a window at
# T=1 (the first split starts at its edge), 4 tokens x g 4 (16 rows),
# S shorter than one split, a long S (splits of 3 chunks), queries with
# no key (S < T).
FLASH_SPLIT_CASES = [
    ("wave decode", 4, 1, 513, 9, 3, 64, {}),
    ("llama cross decode", 4, 1, 1600, 32, 8, 128, {"causal": False}),
    ("whisper cross decode", 4, 1, 1500, 6, 6, 64, {"causal": False}),
    ("window 256", 2, 1, 1024, 4, 4, 64, {"window": 256}),
    ("T=4 x g 4, softcap", 2, 4, 300, 16, 4, 80, {"softcap": 30.0}),
    ("S < one split", 3, 1, 50, 9, 3, 64, {}),
    ("S=20000", 1, 1, 20000, 8, 1, 64, {}),
    ("no key", 2, 4, 2, 4, 2, 16, {}),
]


def phase_compare_flash_split(cases=None, poison: bool = False):
    """The flash forward's split route against the plain version and the
    plain split form at the wrapper's own plan (bf16: 3e-2 x max |plain|,
    a mean over many keys; lse 1e-4), K/V read in place from [B, S + 64]
    rings; its launch counted in ``split_launches`` and in no CUDA-core
    count; two calls bit-identical; the first and last batch rows alone
    bit-identical to the same rows in the batch; queries with no key
    exactly 0 with lse -1e30; the arrival counters back at 0; and the
    bound rejecting the output with the last key tile dropped.  ``cases``
    default to ``FLASH_SPLIT_CASES``; with ``poison`` the rings' slots
    past S hold NaN, and no output may be NaN.  Returns the max error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(700)
    worst, lines = 0.0, []
    for label, B, T, S, H, Hkv, hd, kw in cases or FLASH_SPLIT_CASES:
        q = torch.randn((B, T, H, hd), generator=g, device="cuda").to(
            torch.bfloat16)
        rk, rv = (torch.randn((B, S + 64, Hkv, hd), generator=g,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        if poison:
            rk[:, S:], rv[:, S:] = float("nan"), float("nan")
        k, v = rk[:, :S], rv[:, :S]
        way, plan = fa.forward_route(T, S, H, Hkv, hd, q.dtype,
                                     fa.tensor_core_route(q, k, v),
                                     kw.get("window", 0))
        check(way == "split", f"flash split {label}: route {way}")
        before = (fa.launches, fa.split_launches, fa.simt_launches)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        again = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check((fa.launches - before[0], fa.split_launches - before[1],
               fa.simt_launches - before[2]) == (2, 2, 0),
              f"flash split {label}: launches")
        check(torch.equal(out, again), f"flash split {label}: two calls "
                                       "differ")
        check(not bool(torch.isnan(out).any()),
              f"flash split {label}: a NaN past S was read")
        for b in {0, B - 1}:
            alone = fa.flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                       **kw)
            check(torch.equal(alone[0], out[b]),
                  f"flash split {label}: row {b} alone differs")
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        split_out, split_lse = ref.flash_attention_split_ref(
            q, k, v, plan[1], **kw)
        seen = split_lse > -1e29                        # [B, H, T]
        rows = seen.permute(0, 2, 1)[..., None]
        want = torch.where(rows, want.float(), 0.0)
        bound = 3e-2 * max(want.abs().max().item(), 1e-6)
        err = max((out.float() - w.float()).abs().max().item()
                  for w in (want, split_out))
        lerr = max((torch.where(seen, lse - want_lse, 0.0)).abs().max().item(),
                   (lse - split_lse).abs().max().item())
        check(err <= bound and lerr <= 1e-4,
              f"flash split {label}: err {err} (bound {bound}), lse {lerr}")
        check(torch.count_nonzero(out * ~rows) == 0
              and bool((lse[~seen] == -1e30).all()),
              f"flash split {label}: a query with no key is not 0")
        check(all(int(c.abs().sum()) == 0 for c in fa._COUNTERS.values()),
              f"flash split {label}: a counter was left set")
        bad = "-"
        if bool(seen.all()):
            cut = S - (S % KEY_TILE or KEY_TILE)
            e = (fa.flash_attention(q, k[:, :cut], v[:, :cut], **kw).float()
                 - want).abs().max().item()
            check(e > bound, f"flash split {label}: bound {bound} misses "
                             f"the dropped last key tile (err {e})")
            bad = f"{e:.3g}"
        worst = max(worst, err)
        lines.append(f"{label} (B={B} T={T} S={S} {H}/{Hkv} hd {hd}, plan "
                     f"{plan}) err {err:.3g} <= {bound:.3g}, lse {lerr:.2g}, "
                     f"tile dropped {bad}")
        del q, rk, rv, k, v, out, again, want, split_out
    print("flash split route vs plain and plain split form (bf16, 3e-2 x "
          "max |plain|; repeats and rows alone bit-identical): "
          + "; ".join(lines))
    return worst


def phase_compare_dense_decode():
    """The dense decode read: the paged kernel over a [4, 1024] ring
    viewed as identity-mapped 64-token pages with per-row lengths, held
    against the paged plain version and, row by row, against flash's
    plain version over the ring prefix (the same function)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models.layers import ring_page_size
    d = DENSE
    B, size = d["B"], d["size"]
    ps = ring_page_size(size)
    P = size // ps
    rk, rv = dense_ring(torch, B, seed=24)
    block = torch.arange(B * P, dtype=torch.int32,
                         device="cuda").view(B, P)
    lens = torch.tensor([65, 300, 513, 1000], dtype=torch.int32,
                        device="cuda")
    g = torch.Generator(device="cuda").manual_seed(25)
    q = torch.randn((B, 1, d["H"], d["hd"]), generator=g,
                    device="cuda").to(torch.bfloat16)
    worst = {}
    for li in (0, d["L"] - 1):
        kp = rk[li].view(B * P, ps, d["Hkv"], d["hd"])
        vp = rv[li].view(B * P, ps, d["Hkv"], d["hd"])
        for dt_name, tol in TOLS.items():
            dt = getattr(torch, dt_name)
            args = (q.to(dt), kp.to(dt), vp.to(dt))
            out = pa.paged_attention(*args, block, lens)
            torch.cuda.synchronize()
            want = ref.paged_attention_ref(*args, block, lens)
            err = (out.float() - want.float()).abs().max().item()
            for b in range(B):
                n = int(lens[b])
                row = ref.flash_attention_ref(
                    args[0][b:b + 1], rk[li][b:b + 1, :n].to(dt),
                    rv[li][b:b + 1, :n].to(dt))
                err = max(err, (out[b:b + 1].float()
                                - row.float()).abs().max().item())
            check(err <= tol, f"dense decode layer {li} {dt_name}: err "
                              f"{err}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
    print(f"dense decode (paged kernel over identity pages, B=4, lens "
          f"{lens.tolist()}, ps={ps}): max err f32 {worst['float32']:.3g}, "
          f"bf16 {worst['bfloat16']:.3g} vs both plain versions")


# (M, K, N, blocks, dtypes, (atol, rtol)): tests/test_kernels.py's shapes
# and tolerances; the f32 instance's own K tiles (32 each): one tile and
# 13 of them (odd: the last slot's phase parity differs from the
# first's); each bf16 instance's ring (K steps of 64, S slots: 4 for the
# 64 x 64 tile, 3 for the 128 x 128 one) at 1, S-1, S+1 and 2S+1 steps,
# so every slot's parity is met in more than one round and the last round
# is partial; ragged M/N/K edges (TMA's zero fill in bf16); and
# bench_kernels.py's shape.
NBB_F32 = (5e-4, 1e-3)
NBB_EXACT = (2e-5, 2e-5)
NBB_BF16 = (3e-2, 3e-2)
NBB_CASES = [
    (256, 512, 256, (128, 128, 128), ("float32", "bfloat16"), None),
    (128, 128, 128, (128, 128, 128), ("float32", "bfloat16"), None),
    (512, 1024, 256, (256, 256, 256), ("float32", "bfloat16"), None),
    (128, 384, 128, (128, 128, 128), ("float32",), NBB_EXACT),
    (128, 32, 128, (256, 256, 512), ("float32", "bfloat16"), NBB_EXACT),
    (128, 416, 128, (256, 256, 512), ("float32", "bfloat16"), NBB_EXACT),
    (100, 40, 72, (256, 256, 512), ("float32", "bfloat16"), NBB_EXACT),
    (128, 64, 128, (128, 128, 64), ("bfloat16",), None),
    (128, 192, 128, (128, 128, 192), ("bfloat16",), None),
    (128, 320, 128, (128, 128, 320), ("bfloat16",), None),
    (128, 576, 128, (128, 128, 576), ("bfloat16",), None),
    (1408, 64, 1536, (1408, 1536, 64), ("bfloat16",), None),
    (1408, 128, 1536, (1408, 1536, 128), ("bfloat16",), None),
    (1408, 256, 1536, (1408, 1536, 256), ("bfloat16",), None),
    (1408, 448, 1536, (1408, 1536, 448), ("bfloat16",), None),
    (1500, 200, 1544, (1500, 1544, 200), ("float32", "bfloat16"), None),
    (512, 1024, 512, (256, 256, 512), ("bfloat16",), None),
]
NBB_BENCH = (512, 1024, 512)      # bench_kernels.py:95-98, bf16


def phase_compare_nbb():
    """2c: the NBB matmul kernel vs ``ref.matmul_ref`` (TF32 off), then
    its entry point's run: one ``ops.nbb_matmul`` call at the benchmark's
    shape and blocks with the counter set to 0 just before.  Returns
    (max abs err over every case, entry-point launches)."""
    import torch
    from repro_torch.kernels import nbb_matmul as nbb
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    check(nbb.TILE == ((64, 64, 32), (64, 64, 64), (128, 128, 64))
          and nbb.SLOTS == (2, 4, 3),
          f"kernel tiles {nbb.TILE} / slots {nbb.SLOTS}: the cases assume "
          "(64, 64, 32) x 2, (64, 64, 64) x 4 and (128, 128, 64) x 3")
    used = set()
    g = torch.Generator(device="cuda").manual_seed(31)

    def err_within(out, want, atol, rtol):
        """(max abs err, every element within atol + rtol * |want|)."""
        diff = (out.float() - want.float()).abs()
        return diff.max().item(), bool(
            (diff <= atol + rtol * want.float().abs()).all())

    worst = {}
    for M, K, N, (bm, bn, bk), dtypes, tol in NBB_CASES:
        a = torch.randn((M, K), generator=g, device="cuda")
        b = torch.randn((K, N), generator=g, device="cuda")
        for dt_name in dtypes:
            dt = getattr(torch, dt_name)
            atol, rtol = tol if tol and dt_name == "float32" else (
                NBB_F32 if dt_name == "float32" else NBB_BF16)
            before = nbb.launches
            out = nbb.nbb_matmul(a.to(dt), b.to(dt), bm=bm, bn=bn, bk=bk)
            again = nbb.nbb_matmul(a.to(dt), b.to(dt), bm=bm, bn=bn, bk=bk)
            torch.cuda.synchronize()
            check(nbb.launches == before + 2, "nbb_matmul did not launch")
            check(torch.equal(out, again), f"nbb case {(M, K, N)} "
                                           f"{dt_name}: two calls differ")
            used.add(nbb.instance_for(dt, M, N))
            err, ok = err_within(out, ref.matmul_ref(a.to(dt), b.to(dt)),
                                 atol, rtol)
            check(ok, f"nbb case {(M, K, N)} {dt_name}: max err {err} "
                      f"(atol {atol}, rtol {rtol})")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
    check(used == {0, 1, 2}, f"cases ran instances {used}, not all three")
    try:
        nbb.nbb_matmul(a, b.t())
        check(False, "a transposed operand was not refused")
    except ValueError:
        pass
    M, K, N = NBB_BENCH
    a = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn((K, N), generator=g, device="cuda").to(torch.bfloat16)
    nbb.launches = 0
    out = ops.nbb_matmul(a, b, bm=256, bn=256, bk=512)
    torch.cuda.synchronize()
    launches = nbb.launches
    check(launches == 1, f"ops.nbb_matmul launched {launches} times")
    err, ok = err_within(out, ref.matmul_ref(a, b), *NBB_BF16)
    check(ok, f"ops.nbb_matmul at {NBB_BENCH}: err {err}")
    print(f"nbb_matmul vs plain: {sum(len(c[4]) for c in NBB_CASES)} cases "
          f"(test shapes; f32 K of 1 and 13 tiles of 32; bf16 rings of 4 "
          f"and 3 slots at 1, S-1, S+1, 2S+1 K steps of 64; ragged 100 x "
          f"40 x 72 and 1500 x 200 x 1544; {M} x {K} x {N} bf16; each "
          f"twice, bit-identical) max err f32 "
          f"{worst['float32']:.3g} (atol 2e-5 or 5e-4 as the reference), "
          f"bf16 {worst['bfloat16']:.3g} (3e-2); entry point "
          f"ops.nbb_matmul {M} x {K} x {N} bf16: {launches} launch, err "
          f"{err:.3g}")
    return max(worst.values()), launches


# Cases of ``flash_attention_trainable`` (B, T, S, H, Hkv, hd, kwargs,
# dtype, dropped tile): tests/test_kernels.py:86-104's case and the window
# + softcap GQA case of the card tests in f32; that case again in bf16 (96
# rows: a ragged second tile), a bf16 window + softcap case over 16 key
# tiles, and smollm's training shape (batch 4 x 1024 tokens, 9 / 3 heads)
# in bf16; zamba2-2.7b's shared attention at head_dim 80 (32/32 heads at
# its training shape in bf16; 32/8 heads over a ragged 96 rows with window
# + softcap in f32 and bf16); whisper-tiny's non-causal reads at head_dim
# 64 as it trains (batch 4: the encoder over 1500 frames, the decoder's
# 448 text tokens over them), in f32 and bf16; in bf16 the cases the
# wgmma backward's tiles make risky: head_dim 128 (two 128-byte boxes a
# row) with g = 4, head_dim 16 (one 32-byte box) over 32 rows, and a
# ragged T = S = 1000 at 9/3 heads (a last query and key tile of 40 rows,
# zero-filled by TMA).  Every element of the
# output and of each gradient must lie within atol + rtol |want|
# (TRAINABLE_TOL).  f32: the reference's 1e-4, and 2e-5 for the head_dim
# 80 and non-causal cases.  bf16 gradients: rtol 1e-2 (2.5 bf16 steps) of
# the element's own |want|, above atol 2e-2, about one bf16 step (1/64)
# of the first rows' entries (|want| 2-8): there the bf16 rounding of out,
# P and dS moves entries near zero by up to 0.0146 (PERF.md gives the
# readings).  The non-causal gradients are sums over 448-1500 rows or
# keys of probabilities near 1/1500, about 0.01-0.1: an absolute 2e-2
# would pass nearly any value, so bf16 holds them to 3e-2 x max |plain|,
# as the non-causal forward (2e).  Where a case names a tile (query rows,
# keys; every key of it visible to every row of it), the gradient bound
# must also reject the kernel's own gradients with that tile left out (at
# smollm's training shape that moves them by 0.26-0.30).
TRAIN_ATTN = dict(B=4, T=1024, H=9, Hkv=3, hd=64)
# zamba2-2.7b's shared attention as it trains (batch 4 x 1024 tokens).
ZAMBA_ATTN = dict(B=4, T=1024, H=32, Hkv=32, hd=80)
TILE_1024 = (slice(960, 1024), slice(448, 512))   # late rows x middle keys
# Under window 40, rows 64-95 all see keys 56-64 (key > row - 40).
TILE_96 = (slice(64, 96), slice(56, 65))
TILE_ENC = (slice(1436, 1500), slice(704, 768))
TILE_CROSS = (slice(384, 448), slice(704, 768))
TILE_512 = (slice(448, 512), slice(192, 256))
TILE_1000 = (slice(936, 1000), slice(448, 512))   # the ragged last rows
WS = {"window": 40, "softcap": 30.0}
NC = {"causal": False}
TRAINABLE_CASES = [
    (1, 128, 128, 2, 2, 64, {}, "float32", None),
    (2, 96, 96, 9, 3, 64, WS, "float32", None),
    (2, 96, 96, 9, 3, 64, WS, "bfloat16", None),
    (1, 1024, 1024, 9, 3, 64, {"window": 300, "softcap": 30.0}, "bfloat16",
     None),
    (4, 1024, 1024, 9, 3, 64, {}, "bfloat16", TILE_1024),
    (4, 1024, 1024, 32, 32, 80, {}, "bfloat16", TILE_1024),
    (2, 96, 96, 32, 8, 80, WS, "float32", TILE_96),
    (2, 96, 96, 32, 8, 80, WS, "bfloat16", TILE_96),
    (4, 1500, 1500, 6, 6, 64, NC, "float32", TILE_ENC),
    (4, 1500, 1500, 6, 6, 64, NC, "bfloat16", TILE_ENC),
    (4, 448, 1500, 6, 6, 64, NC, "float32", TILE_CROSS),
    (4, 448, 1500, 6, 6, 64, NC, "bfloat16", TILE_CROSS),
    (2, 512, 512, 16, 4, 128, {}, "bfloat16", TILE_512),
    (2, 32, 32, 4, 2, 16, {}, "bfloat16", None),
    (2, 1000, 1000, 9, 3, 64, {}, "bfloat16", TILE_1000),
]
# {dtype: {"out" or "grad": (atol, rtol)}}
TRAINABLE_TOL = {"float32": {"out": (1e-4, 0.0), "grad": (1e-4, 1e-4)},
                 "bfloat16": {"out": (5e-3, 1e-2), "grad": (2e-2, 1e-2)}}
TRAINABLE_TOL_F32_TIGHT = {"out": (2e-5, 0.0), "grad": (2e-5, 2e-5)}
NONCAUSAL_GRAD_SCALE = 3e-2


def trainable_tol(hd: int, kw: dict, dt_name: str, name: str, want):
    """(atol, rtol) of one output of a 2d case (``name``: out, dq, dk,
    dv)."""
    part = "out" if name == "out" else "grad"
    if dt_name == "float32":
        tight = hd == 80 or not kw.get("causal", True)
        return (TRAINABLE_TOL_F32_TIGHT if tight else TRAINABLE_TOL[
            "float32"])[part]
    if not kw.get("causal", True):
        return (NONCAUSAL_GRAD_SCALE * want.float().abs().max().item(), 0.0)
    return TRAINABLE_TOL["bfloat16"][part]


def within(got, want, tol):
    """(max abs err, every element within atol + rtol |want|, the least
    atol that would pass at this rtol)."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    slack = diff - rtol * want.float().abs()
    return diff.max().item(), bool((slack <= atol).all()), slack.max().item()


def dropped_tile(q, k, v, out, lse, dout, rows: slice, keys: slice,
                 softcap: float = 0.0):
    """What the gradients lose when a kernel leaves out the tile of query
    ``rows`` x ``keys``, every key visible to every row: the plain
    backward on that tile alone, with the whole rows' out and lse, gives
    (dq of ``rows``, dk and dv of ``keys``)."""
    from repro_torch.kernels import ref
    return ref.flash_attention_bwd_ref(
        q[:, rows], k[:, keys], v[:, keys], out[:, rows], lse[:, :, rows],
        dout[:, rows], causal=False, softcap=softcap)


def tile_visible(T: int, S: int, kw: dict, rows: slice, keys: slice) -> bool:
    """Whether every key of the tile is visible to every query row of it
    (queries at positions S - T + t)."""
    off = S - T
    if kw.get("causal", True) and keys.stop - 1 > off + rows.start:
        return False
    w = kw.get("window", 0)
    return not (w and keys.start <= off + rows.stop - 1 - w)


def phase_compare_trainable():
    """2d: ``flash_attention_trainable`` on the card, forward and backward
    kernels (one launch of each per call), against the plain versions:
    its output against ``ref.flash_attention_fwd_ref``'s, and its
    gradients against ``ref.flash_attention_bwd_ref`` on the plain
    forward's residuals.  Returns the max abs errors (output, gradients)
    at smollm's and at zamba2-2.7b's training shapes: {"hd64": (..),
    "hd80": (..)}."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(41)
    at_shape = {(4, 1024, 64, "bfloat16"): "hd64",
                (4, 1024, 80, "bfloat16"): "hd80"}
    errs_at = {}
    for B, T, S, H, Hkv, hd, kw, dt_name, tile in TRAINABLE_CASES:
        dt = getattr(torch, dt_name)
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
                   for shape in ((B, T, H, hd), (B, S, Hkv, hd),
                                 (B, S, Hkv, hd)))
        gout = torch.randn((B, T, H, hd), generator=g, device="cuda").to(dt)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = (fa.launches, fa.bwd_launches, fa.simt_launches)
        out = ops.flash_attention_trainable(*leaves, **kw)
        grads = torch.autograd.grad(out, leaves, gout)
        torch.cuda.synchronize()
        label = f"trainable {(B, T, S, H, Hkv, hd, kw)} {dt_name}"
        check((fa.launches - before[0], fa.bwd_launches - before[1])
              == (1, 1), f"{label}: not one forward and one backward launch")
        check((fa.simt_launches - before[2] == 0) == (dt_name == "bfloat16"),
              f"{label}: the wrong route (CUDA-core launches "
              f"{fa.simt_launches - before[2]})")
        want_out, lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, want_out, lse, gout, **kw)
        key = at_shape.get((B, T, hd, dt_name)) if not kw else None
        errs, failed, tols = [], [], {}
        out_err = grad_err = 0.0
        for name, a, b in zip(("out", "dq", "dk", "dv"),
                              (out.detach(),) + grads, (want_out,) + want):
            atol, rtol = tols[name] = trainable_tol(hd, kw, dt_name, name, b)
            err, ok, least = within(a, b, (atol, rtol))
            if not ok:
                failed.append(f"{name}: max err {err} beyond atol {atol:.3g}"
                              f" + rtol {rtol} |want| (needs atol "
                              f"{least:.3g})")
            errs.append(f"{name} {err:.3g} (max|want| "
                        f"{b.float().abs().max().item():.3g}; atol "
                        f"{atol:.3g} rtol {rtol}: least atol at that rtol "
                        f"{least:.3g})")
            if name == "out":
                out_err = err
            else:
                grad_err = max(grad_err, err)
        if key is not None:
            errs_at[key] = (out_err, grad_err)
        if tile is not None:
            rows, keys = tile
            check(tile_visible(T, S, kw, rows, keys),
                  f"{label}: the planted tile is not wholly visible")
            lost = dropped_tile(q, k, v, want_out, lse, gout, rows, keys,
                                kw.get("softcap", 0.0))
            caught = []
            for name, a, b, part, where in zip(("dq", "dk", "dv"), grads,
                                               want, lost, (rows, keys, keys)):
                bad = a.float().clone()
                bad[:, where] -= part.float()
                err, ok, least = within(bad, b, tols[name])
                if ok:
                    failed.append(f"the bound passes {name} with the "
                                  f"{rows} x {keys} tile left out (max err "
                                  f"{err})")
                caught.append(f"{name} {err:.3g} (least atol {least:.3g})")
            errs.append(f"rows {rows.start}-{rows.stop - 1} x keys "
                        f"{keys.start}-{keys.stop - 1} left out: max err "
                        + ", ".join(caught))
        print(f"flash_attention_trainable (forward + backward kernels) vs "
              f"plain, B={B} T={T} S={S} H={H} Hkv={Hkv} hd={hd} {kw} "
              f"{dt_name}: " + "; ".join(errs))
        check(not failed, f"{label}: " + "; ".join(failed))
        del q, k, v, gout, leaves, out, grads, want_out, lse, want
    check(set(errs_at) == {"hd64", "hd80"}, f"2d: {sorted(errs_at)}")
    return errs_at


# ---------------------------------------------------------------------------
# Phases 3 and 4: the paged and dense main paths at full width
# ---------------------------------------------------------------------------
def full_width_model(arch: str = "smollm-135m", layers: int = 0):
    """``arch`` at full width on the card (its depth cut to ``layers``
    where given), random weights from seed 0, with a count of model
    forwards: [all, one-token decode forwards]."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg)                          # cuda by default
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    forwards = [0, 0]
    fwd = model.forward

    def counted_forward(params, tokens, *a, **kw):
        forwards[0] += 1
        forwards[1] += tokens.shape[1] == 1
        return fwd(params, tokens, *a, **kw)

    model.forward = counted_forward
    return model, params, forwards


def main_workload(vocab: int):
    """4 clients x 4 requests: even requests a random prompt of 40-480
    tokens, odd ones a shared 240-token system prompt + 16 user tokens."""
    import numpy as np
    rng = np.random.default_rng(1234)
    system = rng.integers(0, vocab, 240)
    prompts = {}
    for c in range(4):
        for r in range(4):
            if r % 2 == 0:
                prompts[c, r] = rng.integers(0, vocab,
                                             int(rng.integers(40, 481)))
            else:
                prompts[c, r] = np.concatenate(
                    [system, rng.integers(0, vocab, 16)])
    return prompts


def serve_run(eng, prompts, max_tokens: int, forwards, smi: str,
              label: str):
    """Serve ``prompts`` ({(client, r): tokens}) with one thread per
    client session, every kernel counter set to 0 just before and read
    just after.  Checks every stream, that every flash launch took the
    tensor-core instance and no paged launch the CUDA-core route; returns
    (launches {kernel: n}, model forwards, wall s, tok/s, TTFT p50 ms)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    vocab = eng.model.cfg.vocab_size
    clients = sorted({c for c, _ in prompts})
    results, errors = {}, []

    def client(c: int) -> None:
        try:
            with eng.connect(c) as session:
                rs = sorted(r for cc, r in prompts if cc == c)
                hs = [session.submit_i(prompts[c, r], max_tokens=max_tokens)
                      for r in rs]
                for r, h in zip(rs, hs):
                    results[c, r] = (list(h.tokens(timeout_s=600)),
                                     h.response)
        except Exception as exc:        # noqa: BLE001 — reported below
            errors.append(repr(exc))

    zero_counts(forwards)
    thread = eng.start()
    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,)) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = {"flash_attention": fa.launches,
                "flash_noncausal": fa.noncausal_launches,
                "flash_split": fa.split_launches,
                "paged_attention": pa.launches,
                "paged_split": pa.split_launches,
                "paged_ring": pa.ring_launches}
    simt = fa.simt_launches
    paged_simt = pa.simt_launches
    n_fwd = forwards[0]
    eng.stop()
    thread.join(timeout=30)
    check(not any(t.is_alive() for t in threads), f"{label}: a client hung")
    check(not errors, f"{label}: client errors: {errors}")
    check(eng.dead is None, f"{label}: engine died: {eng.dead}")
    fr = eng.fault_report()
    check(fr["tick_failures"] == 0 and fr["requests_failed"] == 0,
          f"{label}: the tick watchdog caught {fr['tick_failures']} "
          f"exceptions, {fr['requests_failed']} requests failed")
    check(simt == 0, f"{label}: {simt} flash launches took the CUDA-core "
                     "instance, not the tensor-core one")
    check(paged_simt == 0, f"{label}: {paged_simt} paged launches took the "
                           "CUDA-core route, not split-KV or tensor-core")
    n_req = len(prompts)
    check(len(results) == n_req and eng.stats["served"] == n_req,
          f"{label}: served {eng.stats['served']} of {n_req}")
    ttft, n_tok = [], 0
    for (c, r), (stream, resp) in sorted(results.items()):
        out = list(map(int, resp.tokens_out))
        check(len(out) == max_tokens,
              f"{label} request {c}/{r}: {len(out)} tokens")
        check(all(0 <= t < vocab for t in out),
              f"{label} request {c}/{r}: token out of range")
        check(sorted(p for p, _ in stream) == list(range(max_tokens)),
              f"{label} request {c}/{r}: stream not exactly-once")
        check([t for _, t in sorted(stream)] == out,
              f"{label} request {c}/{r}: stream disagrees with tokens_out")
        ttft.append(resp.first_token_t - resp.submit_t)
        n_tok += len(out)
    ttft_ms = 1e3 * statistics.median(ttft)
    print(f"{label}: {n_req} requests served in {dt:.2f} s, "
          f"{n_tok / dt:.1f} tok/s, TTFT p50 {ttft_ms:.0f} ms, forwards "
          f"{n_fwd} ({1e3 * dt / max(n_fwd, 1):.1f} ms of wall time each), "
          f"launches flash_attention {launches['flash_attention']} "
          f"paged_attention {launches['paged_attention']} (split route "
          f"{launches['paged_split']}) [{smi}]")
    print(f"  {label} stats: {eng.stats}")
    return launches, n_fwd, dt, n_tok / dt, ttft_ms


def phase_serve(model, params, forwards, smi: str):
    """The paged main path: ``slot_paged``, 16 requests, 32 tokens each;
    the paged kernel launched 30 times per forward, flash never."""
    from repro_torch.serve.engine import ServeEngine
    cfg = model.cfg
    eng = ServeEngine(model, params, max_batch=8, max_len=1024,
                      n_clients=4, pool_pages=512, page_size=16,
                      scheduler="slot_paged", chunk_tokens=64, k_max=8)
    kv_mb = 2 * eng.pool.store_k.numel() * eng.pool.store_k.element_size()
    print(f"paged main path: smollm-135m (30 layers, d=576, 9/3 heads, "
          f"vocab 49152, bf16) slot_paged, pool {kv_mb / 1e6:.0f} MB of K/V")
    launches, n_fwd, *_ = serve_run(eng, main_workload(cfg.vocab_size), 32,
                                    forwards, smi, "slot_paged")
    check(n_fwd > 0 and launches["paged_attention"]
          == cfg.num_layers * n_fwd,
          f"paged_attention launches {launches['paged_attention']} != "
          f"{cfg.num_layers} x {n_fwd} forwards")
    check(launches["flash_attention"] == 0, "slot_paged launched flash")
    # Each decode forward's 30 passes take the split route, one launch
    # each; the T=64 chunks the wgmma route.
    check(forwards[1] > 0 and launches["paged_split"]
          == cfg.num_layers * forwards[1],
          f"paged split launches {launches['paged_split']} != "
          f"{cfg.num_layers} x {forwards[1]} decode forwards")
    check(eng.stats["prefix_hits"] > 0, "the shared prefix never hit")
    print(f"  prefix_hits {eng.stats['prefix_hits']}, "
          f"prefill_tokens_saved {eng.stats['prefill_tokens_saved']}")
    return launches["paged_attention"]


def phase_serve_olmoe(smi: str):
    """3f: ``olmoe-1b-7b`` at full width (16 layers, d=2048, 16/16 heads
    of 128, 64 experts top-8, vocab 50304, bf16, seed-0 weights) under
    ``slot_paged`` on the main workload's 16 requests: every stream
    complete and exactly-once, paged launches = 16 x forwards, paged
    split launches = 16 x one-token forwards, no flash, no CUDA-core
    route, no watchdog catch; then where a decode block's and a chunk's
    time goes.  Returns the paged launches."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import tree
    t0 = time.monotonic()
    model, params, forwards = full_width_model("olmoe-1b-7b")
    torch.cuda.synchronize()
    cfg = model.cfg
    # ModelConfig.param_count leaves out the 2 L + 1 norm vectors.
    n_params = sum(t.numel() for t in tree.flatten(params)[0])
    want = cfg.param_count() + (2 * cfg.num_layers + 1) * cfg.d_model
    check(n_params == want, f"olmoe params {n_params} != {want}")
    eng = ServeEngine(model, params, max_batch=8, max_len=1024,
                      n_clients=4, pool_pages=512, page_size=16,
                      scheduler="slot_paged", chunk_tokens=64, k_max=8)
    kv_mb = 2 * eng.pool.store_k.numel() * eng.pool.store_k.element_size()
    print(f"olmoe main path: olmoe-1b-7b ({cfg.num_layers} layers, "
          f"d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim_}, {cfg.moe.num_experts} experts top-"
          f"{cfg.moe.top_k}, vocab {cfg.vocab_size}, bf16, {n_params} "
          f"params drawn in {time.monotonic() - t0:.1f} s) slot_paged, pool "
          f"{kv_mb / 1e6:.0f} MB of K/V, device memory "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    launches, n_fwd, *_ = serve_run(eng, main_workload(cfg.vocab_size), 32,
                                    forwards, smi, "olmoe slot_paged")
    L = cfg.num_layers
    check(n_fwd > 0 and launches["paged_attention"] == L * n_fwd,
          f"olmoe: paged launches {launches['paged_attention']} != {L} x "
          f"{n_fwd} forwards")
    check(forwards[1] > 0 and launches["paged_split"] == L * forwards[1],
          f"olmoe: split launches {launches['paged_split']} != {L} x "
          f"{forwards[1]} decode forwards")
    check(launches["flash_attention"] == 0, "olmoe slot_paged launched "
                                            "flash")
    print(f"  olmoe: forwards {n_fwd} ({forwards[1]} one-token), "
          f"prefix_hits {eng.stats['prefix_hits']}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del eng
    phase_split(model, params, smi, m=OLMOE)
    return launches["paged_attention"]


# gemma3-27b at full width (3g).  max_len 4096, not 2048: a prompt of
# 1100-1500 tokens is bucketed to 2048 positions, and 2048 + 32 new
# tokens would fail the engine's oversize check at max_len 2048.  The
# dense schedulers still account each admitted sequence's bucketed
# prompt and budget in the page pool (as the reference's do): 320 pages
# of 16 cover the 4800 tokens of 3g's four requests (2.6 GB).
GEMMA_SERVE = dict(max_batch=4, max_len=4096, chunk_tokens=64, k_max=8,
                   pool_pages=320, page_size=16)


def gemma_workload(vocab: int, lengths):
    """One request per client: a random prompt of each length."""
    import numpy as np
    rng = np.random.default_rng(4321)
    return {(c, 0): rng.integers(0, vocab, n)
            for c, n in enumerate(lengths)}


def phase_serve_gemma(smi: str):
    """3g: ``gemma3-27b`` at full width (62 layers: 10 superblocks of 5
    local layers with a 1024-token window and one global layer, then 2
    local; d=5376, 32/16 heads of 128, vocab 262144, bf16, seed-0 weights
    drawn on the card a layer at a time; no cut).  ``slot_chunked`` (its
    launcher's fallback: not pageable) serves 4 requests, two with
    prompts of 1100-1500 tokens so every local ring wraps in prefill and
    decode, two of 40-480: every stream complete and exactly-once, paged
    launches = 62 x forwards, paged split launches = 62 x one-token
    forwards, no CUDA-core route, no watchdog catch.  ``slot_fused`` serves 2
    requests, one prompt past 1024: flash carries the unwrapped prefill
    layers, the paged ring bound the wrapped ones.  Then where a decode
    block's and a chunk's time goes, and the peak device memory.
    Returns (paged launches, of them under the ring bound)."""
    import gc

    import torch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import tree
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model, params, forwards = full_width_model("gemma3-27b")
    torch.cuda.synchronize()
    cfg = model.cfg
    per, nsb, tail = model._gemma_plan()
    check((per, nsb, tail) == (5, 10, 2), f"gemma plan {(per, nsb, tail)}")
    n_params = sum(t.numel() for t in tree.flatten(params)[0])
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim_
    want = cfg.param_count() + (2 * L + 1) * d + 2 * L * hd   # norms
    check(n_params == want, f"gemma params {n_params} != {want}")
    weights_gb = torch.cuda.memory_allocated() / 1e9
    print(f"gemma main path: gemma3-27b ({L} layers = {nsb} x ({per} local "
          f"+ 1 global) + {tail} local, window {cfg.sliding_window}, "
          f"d={d}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {hd}, vocab "
          f"{cfg.vocab_size}, bf16; {n_params} params drawn in "
          f"{time.monotonic() - t0:.1f} s, {weights_gb:.2f} GB on the card; "
          f"{before / 1e9:.2f} GB held before) [{smi}]")
    long_short = gemma_workload(cfg.vocab_size, (1100, 480, 1500, 40))
    G = L - L // (per + 1)                  # windowed (local) layers
    paged_launches = ring_launches = 0
    for sched, work in (("slot_chunked", long_short),
                        ("slot_fused", gemma_workload(cfg.vocab_size,
                                                      (1100, 300)))):
        eng = ServeEngine(model, params, n_clients=len(work),
                          scheduler=sched, **GEMMA_SERVE)
        check(eng.dense_cache_bytes() == 2 * GEMMA_SERVE["max_batch"]
              * cfg.num_kv_heads * hd * 2
              * (G * cfg.sliding_window + (L - G) * GEMMA_SERVE["max_len"]),
              f"gemma {sched}: dense_cache_bytes {eng.dense_cache_bytes()}")
        torch.cuda.reset_peak_memory_stats()
        launches, n_fwd, *_ = serve_run(eng, work, 32, forwards, smi,
                                        f"gemma {sched}")
        st = eng.stats
        pl, fl = launches["paged_attention"], launches["flash_attention"]
        check(launches["paged_split"] == L * forwards[1]
              and forwards[1] > 0,
              f"gemma {sched}: split launches {launches['paged_split']} "
              f"!= {L} "
              f"x {forwards[1]} one-token forwards")
        rl = launches["paged_ring"]
        ring_launches += rl
        if sched == "slot_chunked":
            check(fl == 0 and n_fwd > 0 and pl == L * n_fwd
                  and rl == G * n_fwd,
                  f"gemma slot_chunked: paged launches {pl} != {L} x "
                  f"{n_fwd} forwards, or ring launches {rl} != {G} x "
                  f"{n_fwd} (flash {fl})")
        else:
            # A prefill bucketed past the window wraps the local rings:
            # those layers read through the ring bound, the global ones
            # through flash; an unwrapped prefill is flash throughout.
            wrapped = sum(eng._bucket(len(p)) > cfg.sliding_window
                          for p in work.values())
            check(st["prefills"] == len(work) and wrapped == 1
                  and fl == L * st["prefills"] - G * wrapped
                  and pl == G * wrapped + L * st["decode_steps"]
                  and rl == G * (wrapped + st["decode_steps"]),
                  f"gemma slot_fused: flash {fl}, paged {pl}, prefills "
                  f"{st['prefills']}, decode steps {st['decode_steps']}")
        paged_launches += pl
        print(f"  gemma {sched}: forwards {n_fwd} ({forwards[1]} one-token), "
              f"ring launches {rl}, "
              f"dense cache {eng.dense_cache_bytes() / 1e9:.2f} GB, peak "
              f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"GB")
        del eng
        gc.collect()        # the engine's sessions hold it in a cycle
        torch.cuda.empty_cache()
        part_time(f"gemma {sched}")
    phase_split_gemma(model, params, smi)
    return paged_launches, ring_launches


def phase_split_gemma(model, params, smi: str):
    """gemma3-27b's dense rings (slot_chunked): one K=4 decode block (the
    profile's events cost ~0.1 ms of host time each to read, and K=8
    cost the script ~35 s more) and
    one T=64 chunk at B=4, every row past the window (positions
    1100-2000), so every local layer reads its ring with wrap-around."""
    import torch
    vocab, B, C = model.cfg.vocab_size, GEMMA_SERVE["max_batch"], 64
    g = torch.Generator(device="cuda").manual_seed(6)
    caches = model.init_cache(B, GEMMA_SERVE["max_len"])
    for t in _leaves(caches):
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    i32 = dict(dtype=torch.int32, device="cuda")
    pos = torch.randint(1100, 2001, (B,), generator=g, device="cuda").to(
        torch.int32)
    cur = torch.randint(0, vocab, (B,), generator=g, device="cuda").to(
        torch.int32)
    rem, eos = torch.full((B,), 1000, **i32), torch.full((B,), -1, **i32)
    chunk = torch.randint(0, vocab, (B, C), generator=g, device="cuda").to(
        torch.int32)
    nval = torch.full((B,), C, **i32)
    torch.cuda.reset_peak_memory_stats()
    profile_split((
        ("gemma3-27b slot_chunked decode block K=4 B=4", 4,
         lambda: model.decode_loop(params, caches, cur, pos, rem, eos, k=4,
                                   max_len=GEMMA_SERVE["max_len"])),
        ("gemma3-27b slot_chunked prefill chunk T=64 B=4", 1,
         lambda: model.prefill_chunk_into(params, caches, chunk, pos,
                                          nval))), smi)
    print(f"  gemma time split: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Phases 2e, 3h and 3i: the cross-attention families
# ---------------------------------------------------------------------------
# Non-causal flash at the cross-attention families' shapes (B, T, S, H,
# Hkv, hd): llama-3.2-vision-11b's cross layers at a decode step and a
# 64-token chunk over 1600 image tokens, whisper-tiny's encoder over 1500
# frames and its decoder's cross read of them (ragged: 1500 is no
# multiple of the 64-key tile).
NONCAUSAL = {"llama cross decode": (4, 1, 1600, 32, 8, 128),
             "llama cross chunk": (4, 64, 1600, 32, 8, 128),
             "whisper encoder": (4, 1500, 1500, 6, 6, 64),
             "whisper cross decode": (4, 1, 1500, 6, 6, 64)}
# f32 is held to 2e-5 absolute.  bf16 to 3e-2 of the output's own scale
# (max |plain|): these outputs are means over >= 1500 keys, about 0.2-0.4
# at most, so an absolute 3e-2 would be as large as a typical value.
NONCAUSAL_TOLS = {"float32": 2e-5, "bfloat16": 3e-2}
KEY_TILE = 64


def noncausal_bound(dt_name: str, want) -> float:
    tol = NONCAUSAL_TOLS[dt_name]
    return tol if dt_name == "float32" else tol * want.abs().max().item()


def noncausal_inputs(torch, B, T, S, H, Hkv, hd, seed: int, nsb: int = 2):
    """q [B, T, H, hd] and a stacked cross cache kv [2 (K, V), nsb, B, S,
    Hkv, hd]; superblock s reads ``kv[0][s]``, ``kv[1][s]`` in place, as
    the model does."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, T, H, hd), generator=g, device="cuda")
    kv = torch.randn((2, nsb, B, S, Hkv, hd), generator=g, device="cuda")
    return q, kv


def planted_faults(q, kv):
    """The kernel run with a fault planted in what it reads, each as
    (name, out): the other superblock's K/V, the last key tile dropped
    (the ragged one where S is no multiple of the tile), and the
    1/sqrt(hd) scale dropped."""
    from repro_torch.kernels import flash_attention as fa
    k, v = kv[0][1], kv[1][1]
    S, hd = k.shape[1], q.shape[-1]
    cut = S - (S % KEY_TILE or KEY_TILE)
    return (("other superblock's K/V",
             fa.flash_attention(q, kv[0][0], kv[1][0], causal=False)),
            (f"last key tile dropped ({S} -> {cut} keys)",
             fa.flash_attention(q, k[:, :cut], v[:, :cut], causal=False)),
            ("1/sqrt(hd) scale dropped",
             fa.flash_attention(q * hd ** 0.5, k, v, causal=False)))


def phase_compare_noncausal():
    """2e: flash's non-causal route against its plain version at the
    cross and encoder shapes, in bf16 on the tensor-core instance and in
    f32 on the CUDA-core one (TF32 off), K/V read in place from a stacked
    cross cache; each bf16 call twice, bit-identical.  Each bound must
    also reject the kernel's output under every planted fault.  Returns
    the bf16 max error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {}
    for i, (name, shape) in enumerate(NONCAUSAL.items()):
        base = noncausal_inputs(torch, *shape, seed=300 + i)
        for dt_name in NONCAUSAL_TOLS:
            q, kv = (t.to(getattr(torch, dt_name)) for t in base)
            k, v = kv[0][1], kv[1][1]
            tc = fa.tensor_core_route(q, k, v)
            check(tc == (dt_name == "bfloat16"),
                  f"non-causal {name} {dt_name}: tensor-core route {tc}")
            out = fa.flash_attention(q, k, v, causal=False)
            torch.cuda.synchronize()
            if tc:
                again = fa.flash_attention(q, k, v, causal=False)
                check(torch.equal(out, again),
                      f"non-causal {name}: repeat not bit-identical")
            want = ref.flash_attention_ref(q, k, v, causal=False).float()
            bound = noncausal_bound(dt_name, want)
            err = (out.float() - want).abs().max().item()
            check(err <= bound, f"non-causal {name} {dt_name}: err {err} > "
                                f"{bound}")
            faults = []
            for fault, bad in planted_faults(q, kv):
                e = (bad.float() - want).abs().max().item()
                check(e > bound, f"non-causal {name} {dt_name}: bound "
                                 f"{bound} misses a planted fault, {fault} "
                                 f"(err {e})")
                faults.append(f"{fault} {e:.4g}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
            print(f"  non-causal flash {name} {shape} {dt_name}: err "
                  f"{err:.4g} <= bound {bound:.4g}; planted faults exceed "
                  f"it: {', '.join(faults)}")
            del q, kv, k, v, out, want
    print(f"non-causal flash vs plain (2e): max err f32 "
          f"{worst['float32']:.3g} (tol 2e-5), bf16 "
          f"{worst['bfloat16']:.3g} (tol 3e-2 x max |plain|); every "
          "planted fault rejected")
    return worst["bfloat16"]


# zamba2-2.7b's shared attention (2f, 3j): 32/32 heads of 80 over a dense
# [B, 1024] ring, read as 64-token identity pages by the paged kernel.
HD80 = dict(H=32, Hkv=32, hd=80, size=1024, ps=64)


def hd80_bound(dt_name: str, want, mean: bool) -> float:
    """2e's bounds where every output is a mean over many keys (the T=1
    read of 513), else 3e-2 absolute in bf16 (causal prefills and short
    rows read one key or few); f32 2e-5."""
    return (noncausal_bound(dt_name, want) if mean
            else NONCAUSAL_TOLS[dt_name])


def hd80_ring(torch, B: int, seed: int):
    """f32 K and V rings [B, 1024, 32, 80] of zamba's shared block."""
    h = HD80
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, h["size"], h["Hkv"], h["hd"])
    return tuple(torch.randn(shape, generator=g, device="cuda")
                 for _ in range(2))


def flash_tile_dropped(q, k, v):
    """The flash kernel's causal output with each 64-query tile's last
    key tile dropped.  At T == 1 the one query reads keys below the last
    tile's start (the ragged one where S is no multiple of 64); at T == S
    the queries [t0, t0 + 64) read only the keys below t0 (their diagonal
    tile, the last their causal walk reaches, left out: no key for the
    first tile)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    T, S = q.shape[1], k.shape[1]
    if T == 1:
        cut = S - (S % KEY_TILE or KEY_TILE)
        return fa.flash_attention(q, k[:, :cut], v[:, :cut])
    out = [torch.zeros_like(q[:, :KEY_TILE])]
    for t0 in range(KEY_TILE, T, KEY_TILE):
        out.append(fa.flash_attention(q[:, t0:t0 + KEY_TILE], k[:, :t0],
                                      v[:, :t0], causal=False))
    return torch.cat(out, 1)


def phase_compare_hd80():
    """2f: the head_dim 80 instances (zamba2-2.7b's shared attention,
    32/32 heads) against their plain versions, K/V read in place from
    [B, 1024] rings: flash at B=1, T=S of 64, 256 and 257 (a ragged tile)
    and at B=4, T=1, S=513; the paged kernel over the ring as 64-token
    identity pages, split-KV decode at B=4 (rows at lens 0, 1, 63, 64,
    then 700, 64, 1000, 129, also against the plain split-KV version)
    and the T=64 chunk (lens 64, 300, 700, 1024).  bf16 takes the
    tensor-core instances (flash_fwd_wgmma<80>, paged_chunk<80>), the
    flash split route's flash_fwd_split<80> (the T=1 read) and the
    bf16 split, each called twice, bit-identical; f32 the CUDA-core ones
    (TF32 off).  Each bound must also reject the kernel's output with its
    last key tile dropped (flash: :func:`flash_tile_dropped`; paged:
    ``kv_lens`` one tile short of each row's keys).  Returns the bf16
    max errors (flash, paged)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    h = HD80
    H, hd, ps = h["H"], h["hd"], h["ps"]
    g = torch.Generator(device="cuda").manual_seed(500)
    worst = {"flash": 0.0, "paged": 0.0}
    lines = []

    def held(label, kind, dt_name, out, want, bad, mean):
        want = want.float()
        bound = hd80_bound(dt_name, want, mean)
        err = (out.float() - want).abs().max().item()
        check(err <= bound, f"hd 80 {label} {dt_name}: err {err} > {bound}")
        e = (bad.float() - want).abs().max().item()
        check(e > bound, f"hd 80 {label} {dt_name}: bound {bound} misses "
                         f"the dropped last key tile (err {e})")
        if dt_name == "bfloat16":
            worst[kind] = max(worst[kind], err)
        lines.append(f"{label} {dt_name} err {err:.3g} <= {bound:.3g}, "
                     f"tile dropped {e:.3g}")

    # Flash: B=1 prefills over a ring slice, B=4 decode over a strided one.
    for B, T, S in ((1, 64, 64), (1, 256, 256), (1, 257, 257), (4, 1, 513)):
        rk, rv = hd80_ring(torch, B, seed=501 + T)
        q32 = torch.randn((B, T, H, hd), generator=g, device="cuda")
        for dt_name in NONCAUSAL_TOLS:
            dt = getattr(torch, dt_name)
            ring_k, ring_v = rk.to(dt), rv.to(dt)
            q, k, v = q32.to(dt), ring_k[:, :S], ring_v[:, :S]
            tc = fa.tensor_core_route(q, k, v)
            check(tc == (dt_name == "bfloat16"),
                  f"hd 80 flash {dt_name}: tensor-core route {tc}")
            simt = fa.simt_launches
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            if tc:
                check(fa.simt_launches == simt,
                      "hd 80 flash: a bf16 call took the CUDA-core route")
                check(torch.equal(out, fa.flash_attention(q, k, v)),
                      f"hd 80 flash B={B} T={T}: repeat not bit-identical")
            held(f"flash B={B} T={T} S={S}", "flash", dt_name, out,
                 ref.flash_attention_ref(q, k, v),
                 flash_tile_dropped(q, k, v), mean=T == 1)
            del q, k, v, out, ring_k, ring_v
    # Paged: the B=4 ring as identity pages.
    B = 4
    P = h["size"] // ps
    rk, rv = hd80_ring(torch, B, seed=520)
    block = torch.arange(B * P, dtype=torch.int32, device="cuda").view(B, P)
    for T, lens in ((1, [0, 1, 63, 64]), (1, [700, 64, 1000, 129]),
                    (64, [64, 300, 700, 1024])):
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        short = torch.clamp((ln - 1) // KEY_TILE * KEY_TILE, min=0).to(
            torch.int32)
        q32 = torch.randn((B, T, H, hd), generator=g, device="cuda")
        for dt_name in NONCAUSAL_TOLS:
            dt = getattr(torch, dt_name)
            q = q32.to(dt)
            kp = rk.to(dt).view(B * P, ps, h["Hkv"], hd)
            vp = rv.to(dt).view(B * P, ps, h["Hkv"], hd)
            way = pa.route(q, kp, vp)
            want_way = ("simt" if dt_name == "float32" else
                        "split" if T == 1 else "wgmma")
            check(way == want_way, f"hd 80 paged T={T} {dt_name}: route "
                                   f"{way}, not {want_way}")
            before = (pa.launches, pa.split_launches, pa.simt_launches)
            out = pa.paged_attention(q, kp, vp, block, ln)
            torch.cuda.synchronize()
            check((pa.launches - before[0], pa.split_launches - before[1])
                  == (1, int(way == "split")), f"hd 80 paged T={T}: launches")
            if dt_name == "bfloat16":
                check(pa.simt_launches == before[2],
                      "hd 80 paged: a bf16 call took the CUDA-core route")
                check(torch.equal(out, pa.paged_attention(q, kp, vp, block,
                                                          ln)),
                      f"hd 80 paged T={T}: repeat not bit-identical")
            check(torch.count_nonzero(out[ln <= 0]) == 0,
                  f"hd 80 paged T={T}: a lens=0 row is not zero")
            label = f"paged {way} T={T} lens {lens}"
            held(label, "paged", dt_name, out,
                 ref.paged_attention_ref(q, kp, vp, block, ln),
                 pa.paged_attention(q, kp, vp, block, ln, kv_lens=short),
                 mean=False)
            if way != "simt":
                keys = pa.plan(q, kp, vp, block)[1][0]
                held(label + " vs split plain", "paged", dt_name, out,
                     ref.paged_attention_split_ref(q, kp, vp, block, ln,
                                                   keys),
                     pa.paged_attention(q, kp, vp, block, ln,
                                        kv_lens=short), mean=False)
            del q, kp, vp, out
    for line in lines:
        print(f"  {line}")
    print(f"hd 80 vs plain (2f): flash_fwd_wgmma<80> and _split<80> max err "
          f"{worst['flash']:.3g}, paged_split<80> and paged_chunk<80> max err "
          f"{worst['paged']:.3g} (bf16: 3e-2 x max |plain| for the T=1 "
          "flash read of 513 keys, else 3e-2; f32 on the CUDA-core "
          "instances 2e-5); every dropped last key tile rejected")
    return worst["flash"], worst["paged"]


def counters_at_zero() -> bool:
    """Every split-KV arrival counter (flash's and paged attention's)
    back at 0, as the run of each row that arrives last leaves it."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    torch.cuda.synchronize()
    return all(int(c.abs().sum()) == 0 for c in fa._COUNTERS.values())


def _fresh_memory():
    import gc

    import torch
    gc.collect()        # an engine's sessions hold it in a cycle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _counts():
    """{kernel: launches} of flash (causal and non-causal forwards apart,
    the forwards on the split route, and its backward), paged and its
    split-route launches, and the CUDA-core launches of either."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    torch.cuda.synchronize()
    return dict(causal=fa.launches - fa.noncausal_launches,
                noncausal=fa.noncausal_launches, bwd=fa.bwd_launches,
                split=fa.split_launches,
                paged=pa.launches, psplit=pa.split_launches,
                simt=fa.simt_launches + pa.simt_launches)


def _cross_leaf(model, caches):
    return (caches["cross"] if model.cfg.encoder is not None
            else caches["super"]["cross"])


def check_cross_filled(model, params, caches, source, label: str) -> None:
    """A plumbing check: every filled cross cache equals ``cross_kv`` of
    the source (the encoder's output for enc_dec), computed again by the
    same function on the same inputs.  It shows which leaf each layer's
    K/V reached, not that ``cross_kv`` is right: that is held to the
    reference by the CPU tests and by phase 5's CPU/CUDA parity."""
    import torch
    from repro_torch.models.layers import cross_kv
    from repro_torch.models.model import _layer
    with torch.no_grad():
        if model.cfg.encoder is not None:
            source = model._encode(params, source)
            lp = params["layers"]["cross"]["attn"]
        else:
            lp = params["super"]["cross"]["attn"]
        c = _cross_leaf(model, caches)
        for i in range(c["k"].shape[0]):
            kv = cross_kv(_layer(lp, i), model.cfg, source)
            check(torch.equal(kv["k"], c["k"][i])
                  and torch.equal(kv["v"], c["v"][i]),
                  f"{label}: cross cache {i} != cross_kv of the source")


def decode_run(model, params, tokens, source, max_len: int, steps: int):
    """``prefill(tokens, max_len, extras=source)``, then ``steps``
    ``decode_step``s at a [B] position: (tokens [B, steps + 1], cache)."""
    import torch
    B, T = tokens.shape
    with torch.no_grad():
        tok, caches = model.prefill(params, tokens, max_len, extras=source)
        out = [tok]
        for i in range(steps):
            pos = torch.full((B,), T + i, dtype=torch.int32,
                             device=tokens.device)
            tok, caches = model.decode_step(params, caches, tok[:, None],
                                            pos)
            out.append(tok)
    return torch.stack(out, 1), caches


VLM_SERVE = dict(max_batch=4, max_len=2048, chunk_tokens=64, k_max=8,
                 pool_pages=320, page_size=16)
VLM_PARAMS = 9_775_157_248          # with its norms (the reference's init)
WHISPER_PARAMS = 41_158_272


def phase_serve_vlm(smi: str):
    """3h: ``llama-3.2-vision-11b`` at full width (8 superblocks of 4
    self layers and a cross layer at index 3; d=4096, 32/8 heads of 128,
    d_ff 14336, vocab 128256 untied, 1600 image tokens; bf16, seed-0
    weights drawn on the card a layer at a time, 19.55 GB; no cut).
    (a) ``prefill`` of 2 prompts of 256 tokens with seeded image
    embeddings [2, 1600, 4096] at ``max_len`` 1024, then 16
    ``decode_step``s.  Two plumbing checks (the port against itself; its
    values are held to the reference on the CPU and in phase 5): every
    cross cache equals ``cross_kv`` of the images, and the last
    position's logits of a forward over the filled caches (prefill's
    computation, run again) lie within one bf16 ulp of the largest logit
    of the cache-less ``forward(tokens, extras)``'s.  The tokens differ
    from those with zero images, non-causal flash launches = 8 x forwards
    and the self layers' (flash prefill, paged decode) = 32 x forwards.  (b)
    ``slot_chunked`` (the launcher's fallback: not pageable) serves 4
    requests of 100-1000 tokens, 32 new each: every stream exactly-once,
    non-causal flash = 8 x forwards, paged = 32 x forwards, no causal
    flash, no CUDA-core route, no watchdog catch.  Then where a decode
    block's and a chunk's time goes.  Returns the non-causal launches of
    (a) and (b)."""
    import torch
    from repro_torch.models.layers import unembed_matrix
    from repro_torch.models.losses import full_logits
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import tree
    _fresh_memory()
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    model, params, forwards = full_width_model("llama-3.2-vision-11b")
    torch.cuda.synchronize()
    cfg = model.cfg
    nsb, per, cross_at = model._vlm_plan()
    check((nsb, per, cross_at) == (8, 5, 3), f"vlm plan {nsb, per, cross_at}")
    n_params = sum(t.numel() for t in tree.flatten(params)[0])
    check(n_params == VLM_PARAMS, f"vlm params {n_params} != {VLM_PARAMS}")
    n_cross, n_self = nsb, nsb * (per - 1)
    print(f"vlm main path: llama-3.2-vision-11b ({cfg.num_layers} layers = "
          f"{nsb} x ({per - 1} self + 1 cross at {cross_at}), d="
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.num_image_tokens} image tokens, bf16; {n_params} params "
          f"drawn in {time.monotonic() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; "
          f"{before / 1e9:.2f} GB held before) [{smi}]")
    # (a) the model path, image-conditioned.
    g = torch.Generator(device="cuda").manual_seed(8)
    B, T, steps = 2, 256, 16
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                           device="cuda")
    images = torch.randn((B, cfg.num_image_tokens, cfg.d_model),
                         generator=g, device="cuda").to(cfg.compute_dtype)
    zero_counts(forwards)
    toks, caches = decode_run(model, params, tokens, images, 1024, steps)
    got = _counts()
    n_fwd = forwards[0]
    check(n_fwd == steps + 1 and got["noncausal"] == n_cross * n_fwd
          and got["causal"] + got["paged"] == n_self * n_fwd
          and got["causal"] == n_self and got["simt"] == 0,
          f"vlm model path: launches {got}, forwards {n_fwd}")
    check_cross_filled(model, params, caches, images, "vlm")
    with torch.no_grad():
        w = unembed_matrix(params["embed"], cfg).to(cfg.compute_dtype)
        hidden, _, _ = model.forward(params, tokens, extras=images)
        want = full_logits(hidden[:, -1:], w)
        # Prefill's own computation, kept to its logits.
        h_pre, _, _ = model.forward(
            params, tokens,
            caches=model.fill_cross_cache(
                params, model.init_cache(B, 1024), images),
            cache_pos=0, start_pos=0)
        have = full_logits(h_pre[:, -1:], w)
    err = (have - want).abs().max().item()
    scale = want.abs().max().item()
    check(math.isfinite(err) and err <= 2 ** -8 * scale,
          f"vlm: prefill logits {err} from the cache-less forward's "
          f"(bound 2^-8 x {scale:.3f})")
    check(torch.equal(torch.argmax(have[:, -1], -1).to(toks.dtype),
                      toks[:, 0]), "vlm: prefill's token is not the argmax "
                                   "of its logits")
    zeros, _ = decode_run(model, params, tokens, torch.zeros_like(images),
                          1024, steps)
    differ = int((zeros != toks).sum())
    check(differ > 0, "vlm: tokens with images equal those with zero "
                      "images")
    print(f"  vlm model path: prefill B={B} T={T} + {steps} decode steps, "
          f"launches {got} over {n_fwd} forwards; plumbing: cross caches "
          f"= cross_kv of the images, last-position logits within "
          f"{err:.4g} of the cache-less forward's (bound 2^-8 x max "
          f"|logit| {scale:.3f}); "
          f"{differ} of {toks.numel()} tokens differ from zero images'")
    check(got["split"] == n_cross * steps,
          f"vlm model path: split-route launches {got['split']} != "
          f"{n_cross} x {steps} decode steps' cross reads")
    noncausal = got["noncausal"]
    SPLIT_SERVED["vlm"] = got["split"]
    del caches, hidden
    # (b) served.
    work = gemma_workload(cfg.vocab_size, (1000, 100, 640, 300))
    eng = ServeEngine(model, params, n_clients=len(work),
                      scheduler="slot_chunked", **VLM_SERVE)
    dense = eng.dense_cache_bytes()
    self_b = 2 * n_self * VLM_SERVE["max_batch"] * VLM_SERVE["max_len"] \
        * cfg.num_kv_heads * cfg.head_dim_ * 2
    cross_b = 2 * n_cross * VLM_SERVE["max_batch"] * cfg.num_image_tokens \
        * cfg.num_kv_heads * cfg.head_dim_ * 2
    check(dense == self_b + cross_b, f"vlm dense_cache_bytes {dense}")
    torch.cuda.reset_peak_memory_stats()
    launches, n_fwd, *_ = serve_run(eng, work, 32, forwards, smi,
                                    "vlm slot_chunked")
    nc = launches["flash_noncausal"]
    check(n_fwd > 0 and nc == n_cross * n_fwd
          and launches["flash_attention"] == nc
          and launches["flash_split"] == n_cross * forwards[1]
          and launches["paged_attention"] == n_self * n_fwd
          and launches["paged_split"] == n_self * forwards[1],
          f"vlm slot_chunked: launches {launches}, forwards {n_fwd} "
          f"({forwards[1]} one-token)")
    noncausal += nc
    SPLIT_SERVED["vlm"] += launches["flash_split"]
    print(f"  vlm slot_chunked: forwards {n_fwd} ({forwards[1]} one-token), "
          f"non-causal flash {nc} = {n_cross} x {n_fwd}, dense cache "
          f"{dense / 1e6:.1f} MB ({self_b / 1e6:.1f} MB of self rings, "
          f"{cross_b / 1e6:.1f} MB of cross K/V), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del eng
    _fresh_memory()
    phase_split_vlm(model, params, smi)
    return noncausal


def phase_split_vlm(model, params, smi: str):
    """llama-3.2-vision-11b's dense rings and cross K/V (slot_chunked):
    one K=8 decode block and one T=64 chunk at B=4, rows at positions
    300-1000, the cross caches random (as filled from images)."""
    import torch
    vocab, B, C = model.cfg.vocab_size, VLM_SERVE["max_batch"], 64
    g = torch.Generator(device="cuda").manual_seed(9)
    caches = model.init_cache(B, VLM_SERVE["max_len"])
    for t in _leaves(caches):
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    i32 = dict(dtype=torch.int32, device="cuda")
    pos = torch.randint(300, 1001, (B,), generator=g, device="cuda").to(
        torch.int32)
    cur = torch.randint(0, vocab, (B,), generator=g, device="cuda").to(
        torch.int32)
    rem, eos = torch.full((B,), 1000, **i32), torch.full((B,), -1, **i32)
    chunk = torch.randint(0, vocab, (B, C), generator=g, device="cuda").to(
        torch.int32)
    nval = torch.full((B,), C, **i32)
    torch.cuda.reset_peak_memory_stats()
    profile_split((
        ("llama-3.2-vision-11b slot_chunked decode block K=8 B=4", 8,
         lambda: model.decode_loop(params, caches, cur, pos, rem, eos, k=8,
                                   max_len=VLM_SERVE["max_len"])),
        ("llama-3.2-vision-11b slot_chunked prefill chunk T=64 B=4", 1,
         lambda: model.prefill_chunk_into(params, caches, chunk, pos,
                                          nval))), smi)
    print(f"  vlm time split: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


WHISPER_SERVE = dict(max_batch=4, max_len=448, chunk_tokens=64, k_max=8,
                     pool_pages=128, page_size=16)


def phase_serve_whisper(smi: str):
    """3i: ``whisper-tiny`` at full width (4 encoder and 4 decoder layers,
    d=384, 6/6 heads of 64, vocab 51865 tied, 1500 frames; bf16, seed-0
    weights; no cut).  ``prefill`` of 4 prompts of 64 tokens with seeded
    frames [4, 1500, 384] at ``max_len`` 448 (Whisper's text context,
    arXiv:2212.04356), then 16 ``decode_step``s: the encoder on flash's
    non-causal route, 4 launches per prefill, and the decoder's cross
    layers 4 per forward; every cross cache equals ``cross_kv`` of the
    encoder's output.  Then ``slot_chunked`` serves 4 requests (40-256
    tokens, 32 new each), and the engine refuses ``slot_fused``.  Returns
    the non-causal launches."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import tree
    _fresh_memory()
    model, params, forwards = full_width_model("whisper-tiny")
    cfg = model.cfg
    n_params = sum(t.numel() for t in tree.flatten(params)[0])
    check(n_params == WHISPER_PARAMS,
          f"whisper params {n_params} != {WHISPER_PARAMS}")
    L, Le = cfg.num_layers, cfg.encoder.num_layers
    g = torch.Generator(device="cuda").manual_seed(10)
    B, T, steps = 4, 64, 16
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                           device="cuda")
    frames = torch.randn((B, cfg.encoder.num_frames, cfg.d_model),
                         generator=g, device="cuda").to(cfg.compute_dtype)
    zero_counts(forwards)
    toks, caches = decode_run(model, params, tokens, frames,
                              WHISPER_SERVE["max_len"], steps)
    got = _counts()
    n_fwd = forwards[0]
    check(n_fwd == steps + 1 and got["noncausal"] == Le + L * n_fwd
          and got["causal"] == L and got["paged"] == L * steps
          and got["split"] == L * steps and got["simt"] == 0,
          f"whisper model path: launches {got}, forwards {n_fwd}")
    check_cross_filled(model, params, caches, frames, "whisper")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "whisper: token out of range")
    noncausal = got["noncausal"]
    SPLIT_SERVED["whisper"] = got["split"]
    print(f"whisper main path: whisper-tiny ({Le} encoder + {L} decoder "
          f"layers, d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
          f"heads of {cfg.head_dim_}, vocab {cfg.vocab_size}, "
          f"{cfg.encoder.num_frames} frames, bf16, {n_params} params): "
          f"prefill B={B} T={T} + {steps} decode steps at max_len "
          f"{WHISPER_SERVE['max_len']}, launches {got} over {n_fwd} "
          f"forwards (encoder {Le} per prefill) [{smi}]")
    del caches
    work = gemma_workload(cfg.vocab_size, (200, 40, 130, 256))
    eng = ServeEngine(model, params, n_clients=len(work),
                      scheduler="slot_chunked", **WHISPER_SERVE)
    launches, n_fwd, *_ = serve_run(eng, work, 32, forwards, smi,
                                    "whisper slot_chunked")
    nc = launches["flash_noncausal"]
    check(n_fwd > 0 and nc == L * n_fwd
          and launches["flash_attention"] == nc
          and launches["flash_split"] == L * forwards[1]
          and launches["paged_attention"] == L * n_fwd,
          f"whisper slot_chunked: launches {launches}, forwards {n_fwd} "
          f"({forwards[1]} one-token)")
    noncausal += nc
    SPLIT_SERVED["whisper"] += launches["flash_split"]
    print(f"  whisper slot_chunked: forwards {n_fwd}, non-causal flash {nc}"
          f", dense cache {eng.dense_cache_bytes() / 1e6:.1f} MB")
    del eng
    try:
        ServeEngine(model, params, scheduler="slot_fused", **WHISPER_SERVE)
    except ValueError as exc:
        check("scheduler='slot_chunked'" in str(exc),
              f"whisper slot_fused refused without naming slot_chunked: "
              f"{exc}")
        print(f"  whisper slot_fused refused: {exc}")
    else:
        check(False, "whisper: the engine accepted slot_fused")
    _fresh_memory()
    return noncausal


# The recurrent families at full width (3j, 3k): slot_fused, the
# launcher's fallback (neither chunkable nor pageable).  Prompts of
# 64-128 tokens bucket to 64 or 128 positions of a [4, 1024] batch cache.
RECURRENT_SERVE = dict(max_batch=4, max_len=1024, k_max=8, pool_pages=256,
                       page_size=16)
# Parameters of the built trees (with their norms), which
# ``ModelConfig.param_count()`` miscounts in both packages (ROADMAP §3).
BUILT_PARAMS = {"zamba2-2.7b": 2_340_750_240, "rwkv6-1.6b": 1_583_941_632}
# The plumbing check's bounds on the logits of a prefill (the scan) plus
# teacher-forced decode steps against the cache-less forward's (the
# chunked form), as a share of the largest logit.  In bf16 the two paths
# round the residual stream at different places and the gap grows with
# depth: at full width on the CPU, zamba's was 2^-8 of the largest logit
# at 6 layers and 2^-5.6 at 18, rwkv's 2^-7.3 at 2 layers and 2^-5.5 at
# 8, so bf16 is held to 2^-2 (a lost or misplaced state moves logits by
# their own size).  The same weights in float32 are the sharp check.
PLUMB_TOL = {"bfloat16": 2 ** -2, "float32": 2 ** -12}


def recurrent_plumbing(model, params, T0: int, steps: int, forwards):
    """A prefill of T0 tokens over a fresh cache (the scan over the
    prompt; flash over zamba's rings) and ``steps`` teacher-forced decode
    forwards at [B] positions (the paged kernel over the rings as
    identity pages), against the cache-less forward over the same T0 +
    steps tokens (the chunked form, a multiple of the chunk).  Returns
    (launches of the cached path, logits error, max |logit|, share of
    equal argmaxes)."""
    import torch
    from repro_torch.models.layers import unembed_matrix
    from repro_torch.models.losses import full_logits
    cfg = model.cfg
    chunk = (cfg.ssm or cfg.rwkv).chunk
    check((T0 + steps) % chunk == 0, "plumbing: the cache-less forward "
                                     "would not take the chunked form")
    g = torch.Generator(device="cuda").manual_seed(12)
    B = 2
    tokens = torch.randint(0, cfg.vocab_size, (B, T0 + steps), generator=g,
                           device="cuda")
    w = unembed_matrix(params["embed"], cfg).to(cfg.compute_dtype)
    zero_counts(forwards)
    with torch.no_grad():
        caches = model.init_cache(B, RECURRENT_SERVE["max_len"])
        h, caches, _ = model.forward(params, tokens[:, :T0], caches=caches,
                                     cache_pos=0, start_pos=0)
        have = [full_logits(h[:, -1:], w)]
        for i in range(steps):
            pos = torch.full((B,), T0 + i, dtype=torch.int32, device="cuda")
            h, caches, _ = model.forward(
                params, tokens[:, T0 + i:T0 + i + 1], caches=caches,
                cache_pos=pos, start_pos=pos[:, None])
            have.append(full_logits(h, w))
        got = _counts()
        got["forwards"] = forwards[0]
        hidden, _, _ = model.forward(params, tokens)
        want = full_logits(hidden[:, T0 - 1:], w).float()
    have = torch.cat(have, 1).float()
    check(bool(torch.isfinite(have).all() and torch.isfinite(want).all()),
          f"{cfg.name}: non-finite logits")
    err = (have - want).abs().max().item()
    same = (have.argmax(-1) == want.argmax(-1)).float().mean().item()
    return got, err, want.abs().max().item(), same


def phase_serve_recurrent(arch: str, smi: str):
    """3j (``zamba2-2.7b``: 54 mamba2 layers in 9 superblocks, each
    opened by the one shared attention block over its own ring; d=2560,
    32/32 heads of 80, SSM 80 heads of 64 with state 64, vocab 32000 tied)
    and 3k (``rwkv6-1.6b``: 24 rwkv6 layers, d=2048, 32 heads of 64, d_ff
    7168, vocab 65536 untied) at full width, bf16, seed-0 weights drawn on
    the card a layer at a time; no cut.  (a) A plumbing check of the
    port against itself (its values are held to the reference on the CPU
    and in phase 5): the logits of a B=2 prefill of 60 tokens plus 4
    teacher-forced decode steps within ``PLUMB_TOL`` of the largest
    logit of the cache-less forward over the same 64 tokens, which runs
    the chunked form, so both recurrence forms run on the card, in bf16
    and with the same weights in float32 (the CUDA-core instances); zamba's
    cached path launches flash once per superblock in the prefill and
    the paged kernel (split route) once per superblock in each decode
    step, rwkv's no attention kernel.  (b) ``slot_fused`` serves 4
    requests of 64-128 tokens, 32 new each: every stream complete and
    exactly-once, flash launches = 9 x prefills and paged = 9 x decode
    forwards (0 and 0 for rwkv), no CUDA-core route, no watchdog catch,
    ``dense_cache_bytes`` and the peak device memory printed.  (c) Where a
    B=1 prefill's of 64 tokens and a K=4 decode block's time goes, the
    recurrences under their profiler ranges.  Returns (b)'s launches."""
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import tree
    _fresh_memory()
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    model, params, forwards = full_width_model(arch)
    torch.cuda.synchronize()
    cfg = model.cfg
    zamba = model._structure() == "zamba_hybrid"
    n_attn = model._zamba_plan()[0] if zamba else 0
    if zamba:
        check(model._zamba_plan() == (9, 6), f"zamba plan "
                                             f"{model._zamba_plan()}")
    n_params = sum(t.numel() for t in tree.flatten(params)[0])
    check(n_params == BUILT_PARAMS[arch],
          f"{arch} params {n_params} != {BUILT_PARAMS[arch]}")
    shape = (f"{cfg.num_layers} mamba2 layers in {n_attn} superblocks, "
             f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
             f"{cfg.head_dim_} in the shared block" if zamba
             else f"{cfg.num_layers} rwkv6 layers, "
                  f"{cfg.d_model // cfg.rwkv.head_dim} heads of "
                  f"{cfg.rwkv.head_dim}, d_ff {cfg.d_ff}")
    print(f"{arch} main path ({shape}, d={cfg.d_model}, vocab "
          f"{cfg.vocab_size}, bf16): {n_params} params built "
          f"(param_count() gives {cfg.param_count()}, ROADMAP §3), drawn "
          f"in {time.monotonic() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; "
          f"{before / 1e9:.2f} GB held before [{smi}]")
    # (a) plumbing, in bf16 and with the weights in float32.
    T0, steps = 60, 4
    got, err, scale, same = recurrent_plumbing(model, params, T0, steps,
                                               forwards)
    check(got["forwards"] == steps + 1 and got["causal"] == n_attn
          and got["paged"] == n_attn * steps
          and got["psplit"] == n_attn * steps and got["noncausal"] == 0
          and got["simt"] == 0,
          f"{arch} model path: launches {got}")
    f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    f32_params = _to_dtype(params, torch.float32)
    _, err32, scale32, same32 = recurrent_plumbing(f32, f32_params, T0,
                                                   steps, [0, 0])
    del f32, f32_params
    _fresh_memory()
    for dt, e, sc, sm in (("bfloat16", err, scale, same),
                          ("float32", err32, scale32, same32)):
        bound = PLUMB_TOL[dt]
        check(e <= bound * sc, f"{arch} {dt}: cached logits {e} from the "
                               f"cache-less forward's (bound "
                               f"2^{math.log2(bound):.0f} x {sc:.3f})")
        print(f"  {arch} model path {dt}: prefill B=2 T={T0} (scan) + "
              f"{steps} decode steps, logits within {e:.4g} of the "
              f"cache-less forward's over {T0 + steps} tokens (chunked "
              f"form; bound 2^{math.log2(bound):.0f} x max |logit| "
              f"{sc:.3f}), argmax equal at {sm:.3f} of the positions")
    print(f"  {arch} model path bf16 launches {got}")
    part_time(f"{arch} drawn, plumbing in bf16 and f32")
    # (b) served.
    work = gemma_workload(cfg.vocab_size, (64, 100, 128, 80))
    eng = ServeEngine(model, params, n_clients=len(work),
                      scheduler="slot_fused", **RECURRENT_SERVE)
    dense = eng.dense_cache_bytes()
    torch.cuda.reset_peak_memory_stats()
    launches, n_fwd, *_ = serve_run(eng, work, 32, forwards, smi,
                                    f"{arch} slot_fused")
    st = eng.stats
    fl, pl = launches["flash_attention"], launches["paged_attention"]
    check(st["prefills"] == len(work)
          and n_fwd == st["prefills"] + st["decode_steps"]
          and fl == n_attn * st["prefills"]
          and pl == n_attn * st["decode_steps"]
          and launches["paged_split"] == n_attn * forwards[1]
          and launches["flash_noncausal"] == launches["paged_ring"] == 0,
          f"{arch} slot_fused: launches {launches}, prefills "
          f"{st['prefills']}, decode steps {st['decode_steps']}")
    print(f"  {arch} slot_fused: forwards {n_fwd} ({st['prefills']} "
          f"prefills, {st['decode_steps']} decode steps), flash {fl} = "
          f"{n_attn} x prefills, paged {pl} = {n_attn} x decode steps, "
          f"dense cache {dense / 1e6:.1f} MB, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del eng
    _fresh_memory()
    part_time(f"{arch} slot_fused")
    phase_split_recurrent(model, params, smi)
    return {"flash": fl, "paged": pl}


def phase_split_recurrent(model, params, smi: str):
    """Where a slot_fused B=1 prefill of 64 tokens (the scan, with
    zamba's flash) and a K=4 decode block at B=4 (rows at 65-160, zamba's
    rings read by the paged kernel) spend their time; the recurrences
    are the ranges ``mamba.ssd`` and ``rwkv.wkv``.  (The profile's
    events cost ~0.1 ms of host time each to read: a prefill of 128
    tokens and K=8 cost zamba's split ~50 s more, rwkv's ~28 s.)"""
    import torch
    cfg = model.cfg
    vocab, B = cfg.vocab_size, RECURRENT_SERVE["max_batch"]
    max_len = RECURRENT_SERVE["max_len"]
    g = torch.Generator(device="cuda").manual_seed(13)
    caches = model.init_cache(B, max_len)
    i32 = dict(dtype=torch.int32, device="cuda")
    pos = torch.randint(65, 161, (B,), generator=g, device="cuda").to(
        torch.int32)
    cur = torch.randint(0, vocab, (B,), generator=g, device="cuda").to(
        torch.int32)
    rem, eos = torch.full((B,), 1000, **i32), torch.full((B,), -1, **i32)
    prompt = torch.randint(0, vocab, (1, 64), generator=g,
                           device="cuda").to(torch.int32)
    torch.cuda.reset_peak_memory_stats()
    profile_split((
        (f"{cfg.name} slot_fused prefill B=1 T=64", 1,
         lambda: model.prefill(params, prompt, max_len)),
        (f"{cfg.name} slot_fused decode block K=4 B=4", 4,
         lambda: model.decode_loop(params, caches, cur, pos, rem, eos, k=4,
                                   max_len=max_len))), smi)
    print(f"  {cfg.name} time split: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def parity_cross(arch: str, scale: float = 3.0):
    """A cross-attention family's SMOKE config at float32, weights x
    ``scale``, same weights on both devices: ``prefill`` with a seeded
    image or frame source + 4 decode steps gives the same greedy tokens
    on the CPU and the card; then a ``slot_chunked`` served run (the
    shared ``parity``)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = _scaled(build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(7)), scale)
    n_src = (cfg.encoder.num_frames if cfg.encoder is not None
             else cfg.num_image_tokens)
    g = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (2, 13), generator=g)
    source = torch.randn((2, n_src, cfg.d_model), generator=g)
    seqs = {dev: decode_run(build_model(cfg, device=dev),
                            _to_device(params, dev), tokens.to(dev),
                            source.to(dev), 32, 4)[0].tolist()
            for dev in ("cpu", "cuda")}
    check(seqs["cpu"] == seqs["cuda"],
          f"{arch}: CPU and CUDA prefill(extras) + decode tokens differ")
    print(f"cpu/cuda parity, {arch} prefill(extras) + decode: "
          f"{sum(map(len, seqs['cuda']))} greedy tokens identical (SMOKE, "
          f"float32, weights x{scale:g})")
    parity(arch, ("slot_chunked",), scale)


def phase_timing_noncausal(launches: int, max_err: float, smi: str):
    """Non-causal flash at the cross-attention families' shapes, bf16:
    llama-3.2-vision-11b's cross read at a decode step (B=4, T=1, S=1600:
    the split route) and a 64-token chunk (wgmma), whisper-tiny's encoder
    (B=4, T=S=1500: wgmma) and its cross decode (B=4, T=1, S=1500:
    split), beside the byte or operation bound, the plain version and one
    ``scaled_dot_product_attention`` call (non-causal, GQA) on the same
    inputs.  The JSON rows are llama's cross decode, the commonest call
    (8 per llama decode forward), and whisper's, with the split-route
    launches of 3i."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    rows = {}
    for i, name in enumerate(("llama cross decode", "llama cross chunk",
                              "whisper encoder", "whisper cross decode")):
        B, T, S, H, Hkv, hd = NONCAUSAL[name]
        q, kv = (t.to(torch.bfloat16) for t in noncausal_inputs(
            torch, B, T, S, H, Hkv, hd, seed=400 + i))
        k, v = kv[0][1], kv[1][1]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        way = fa.forward_route(T, S, H, Hkv, hd, q.dtype, True)[0]
        before = (fa.launches, fa.noncausal_launches, fa.split_launches)
        rows[name] = flash_timing(
            f"flash_attention non-causal, {name}: B={B} T={T} S={S} (H={H}, "
            f"Hkv={Hkv}, hd={hd}, bf16, {way} route)",
            lambda _: fa.flash_attention(q, k, v, causal=False),
            lambda _: ref.flash_attention_ref(q, k, v, causal=False),
            lambda _: F.scaled_dot_product_attention(qt, kt, vt,
                                                     enable_gqa=True),
            (2 * B * T * H * hd + 2 * B * S * Hkv * hd) * 2,
            4 * hd * H * B * T * S, smi)
        (fa.launches, fa.noncausal_launches,
         fa.split_launches) = before                   # not counted
        del q, kv, k, v, qt, kt, vt
    return [flash_json("flash_attention_noncausal", rows["llama cross decode"],
                       launches, max_err),
            flash_json("flash_attention_cross_decode_whisper",
                       rows["whisper cross decode"],
                       SPLIT_SERVED["whisper"], max_err)]


def flash_timing(label: str, kern, plain, sdpa, nbytes: int, flops: int,
                 smi: str):
    """One flash shape in phase 6: the kernel's device ms and the host's
    µs to enqueue a call, its plain version's ms and one SDPA call's,
    beside the bound (the larger of ``nbytes`` at the memory rate and
    ``flops`` at the bf16 tensor-core peak); prints the row and returns
    (ms, plain ms, bound ms, bound by, SDPA ms, host µs)."""
    t_kern, host_us = timed(kern, with_host=True)
    t_plain = timed(plain, inner=10)
    t_sdpa = timed(sdpa, inner=10)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    bound = max(t_bytes, t_ops)
    print(f"{label}: kernel {t_kern:.4f} ms ({flops / t_kern / 1e9:.1f} "
          f"TFLOP/s; host {host_us:.1f} us a call), bound {bound:.5f} ms "
          f"({by}: {nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP), plain "
          f"{t_plain:.4f} ms, library (SDPA, not used by the port) "
          f"{t_sdpa:.4f} ms [{smi}]")
    return t_kern, t_plain, bound, by, t_sdpa, host_us


# The flash forward's shapes of phase 6 (label, B, T, S, H, Hkv, hd,
# kwargs): the B=1 prefills, the wave's decode, the training shapes with
# lse, zamba's prefill, the cross reads of llama-vision and whisper and
# whisper's encoder.
FLASH_FORWARD_SHAPES = [
    ("prefill 64", 1, 64, 64, 9, 3, 64, {}),
    ("prefill 256", 1, 256, 256, 9, 3, 64, {}),
    ("prefill 512", 1, 512, 512, 9, 3, 64, {}),
    ("wave decode", 4, 1, 513, 9, 3, 64, {}),
    ("train hd64 lse", 4, 1024, 1024, 9, 3, 64, {}),
    ("train hd80 lse", 4, 1024, 1024, 32, 32, 80, {}),
    ("prefill hd80 256", 1, 256, 256, 32, 32, 80, {}),
    ("llama cross decode", 4, 1, 1600, 32, 8, 128, {"causal": False}),
    ("llama cross chunk", 4, 64, 1600, 32, 8, 128, {"causal": False}),
    ("whisper encoder", 4, 1500, 1500, 6, 6, 64, {"causal": False}),
    ("whisper cross decode", 4, 1, 1500, 6, 6, 64, {"causal": False}),
]


def flash_forward_times(label: str = "") -> str:
    """The flash forward's device ms and the host's µs a call at
    ``FLASH_FORWARD_SHAPES`` (K/V cycled over ring slices, as phase 6
    reads them), as one printed line: the quick comparison of two
    versions of the kernel, run in turns within one call (phase 6 adds
    bounds, plain versions and SDPA).  Whichever ``repro_torch`` is on
    the path is timed; not part of :func:`main`."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    build.build(fa.SOURCE)
    g = torch.Generator(device="cuda").manual_seed(200)
    out = []
    for name, B, T, S, H, Hkv, hd, kw in FLASH_FORWARD_SHAPES:
        n = 30 if hd == 64 and kw.get("causal", True) else (
            9 if hd == 80 else 2)
        rk, rv = (torch.randn((n, B, max(1024, S), Hkv, hd), generator=g,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        views = [(rk[i][:, :S], rv[i][:, :S]) for i in range(n)]
        q = torch.randn((B, T, H, hd), generator=g, device="cuda").to(
            torch.bfloat16)
        fwd = fa.flash_attention_fwd if "lse" in name else fa.flash_attention
        ms, host = timed(lambda i: fwd(q, *views[i % n], **kw),  # noqa: B023
                         with_host=True)
        out.append(f"{name} {ms:.4f} ms host {host:.1f} us")
        del rk, rv, views, q
    line = f"flash forward times {label} [{nvidia_smi_line()}]: " + \
        "; ".join(out)
    print(line, flush=True)
    return line


def flash_json(name: str, row, launches: int, max_err: float) -> dict:
    """The kernel JSON row of a flash forward shape timed by
    :func:`flash_timing`."""
    t_kern, t_plain, bound, by, t_sdpa, _ = row
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:137",
            "launches": launches, "max_abs_err": max_err, "ms": t_kern,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": t_sdpa}


def phase_serve_dense(model, params, forwards, smi: str):
    """The dense main path: ``slot_fused`` on 8 of the 16 requests (each
    client's first two: flash launches = 30 x prefills, paged = 30 x
    decode steps), then 4 requests each under ``slot_chunked`` (paged
    only) and ``wave`` (flash only).  Returns the slot_fused run's
    launches."""
    from repro_torch.serve.engine import ServeEngine
    L = model.cfg.num_layers
    prompts = main_workload(model.cfg.vocab_size)
    half = {k: p for k, p in prompts.items() if k[1] < 2}
    few = {k: p for k, p in half.items() if k[0] < 2}
    kw = dict(max_batch=4, max_len=1024, page_size=16, pool_pages=256,
              k_max=8)
    fused_launches = None
    for sched, work, extra in (("slot_fused", half, {}),
                               ("slot_chunked", few, {"chunk_tokens": 64}),
                               ("wave", few, {})):
        eng = ServeEngine(model, params, n_clients=4, scheduler=sched,
                          **kw, **extra)
        launches, n_fwd, *_ = serve_run(eng, work, 32, forwards, smi, sched)
        st = eng.stats
        fl, pl = launches["flash_attention"], launches["paged_attention"]
        # Every one-token decode forward makes 30 paged passes on the split
        # route; chunks and flash prefills none, nor the wave's flash
        # decode.
        want_split = 0 if sched == "wave" else L * forwards[1]
        check(launches["paged_split"] == want_split
              and (pl == 0 or forwards[1] > 0),
              f"{sched}: paged split launches "
              f"{launches['paged_split']} != {want_split} ({L} x "
              f"{forwards[1]} decode forwards)")
        if sched == "slot_fused":
            check(fl == L * st["prefills"] and st["prefills"] == len(work)
                  and launches["flash_split"] == 0,
                  f"slot_fused: flash launches {fl} != {L} x "
                  f"{st['prefills']} prefills (split route "
                  f"{launches['flash_split']}, none expected)")
            check(pl > 0 and pl == L * st["decode_steps"]
                  and n_fwd == st["prefills"] + st["decode_steps"],
                  f"slot_fused: paged launches {pl} != {L} x "
                  f"{st['decode_steps']} decode steps")
            fused_launches = launches
        elif sched == "slot_chunked":
            check(fl == 0 and pl == L * n_fwd and pl > 0,
                  f"slot_chunked: launches {launches}, forwards {n_fwd}")
        else:
            # The prefills take the wgmma route, the one-token decode
            # steps the split route.
            check(pl == 0 and fl == L * n_fwd
                  and n_fwd == st["prefills"] + st["decode_steps"]
                  and launches["flash_split"] == L * st["decode_steps"] > 0,
                  f"wave: launches {launches}, forwards {n_fwd}, decode "
                  f"steps {st['decode_steps']}")
            SPLIT_SERVED["wave"] = launches["flash_split"]
        del eng
    return fused_launches


# ---------------------------------------------------------------------------
# Phases 3b and 4b: where one dispatch's time goes
# ---------------------------------------------------------------------------
def profile_split(cases, smi: str):
    """For each (name, model forwards, fn): wall time of one call after a
    warm-up (mean of 3), against the device time the profiler attributes
    to it — the device's busy and idle shares (device-side rows only:
    ``kernel_rows``), each kernel's part, and the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    for name, steps, fn in cases:
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3 * 1e3
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        t1 = time.perf_counter()
        averages = prof.key_averages()
        rows = kernel_rows(prof, averages)
        busy = sum(dev_us(e) for e in rows) / 1e3
        every_row = sum(dev_us(e) for e in averages) / 1e3
        if busy == 0:
            print(f"time split, {name}: wall {wall:.2f} ms; device time "
                  f"not measured (the profiler saw no device activity) "
                  f"[{smi}]")
            continue
        check(not any("flash_" in e.key and "_simt" in e.key for e in rows),
              f"time split, {name}: a CUDA-core flash kernel ran")
        check(not any("paged_simt" in e.key for e in rows),
              f"time split, {name}: the CUDA-core paged kernel ran")
        kern = {k: sum(dev_us(e) for e in rows if needle in e.key) / 1e3
                for k, needle in (("flash_attention", "flash_fwd_"),
                                  ("paged_attention", "paged_"))}
        top = sorted(rows, key=dev_us, reverse=True)[:5]
        ranges = range_ms(prof)
        read_s = time.perf_counter() - t1
        print(f"time split, {name}: wall {wall:.2f} ms "
              f"({wall / steps:.2f} ms per forward), device busy "
              f"{busy:.3f} ms (idle share {1 - busy / wall:.3f}; every "
              f"profiler row summed: {every_row:.3f} ms), "
              f"flash_attention {kern['flash_attention']:.3f} ms, "
              f"paged_attention {kern['paged_attention']:.3f} ms"
              + "".join(f", range {k} {v:.3f} ms"
                        for k, v in sorted(ranges.items()) if v)
              + "; top device ops: "
              + "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms"
                          for e in top)
              + f"; host time: the profiled call {t1 - t0:.1f} s, its "
                f"{len(prof.events())} events read in {read_s:.1f} s "
                f"[{smi}]")


def phase_split(model, params, smi: str, m=MAIN, k: int = 8):
    """The paged path: one K=``k`` decode block and one T=64 prefill
    chunk at its shapes (``m``; B=8, lengths 65..512)."""
    import torch
    vocab = model.cfg.vocab_size
    B, P, C = m["B"], m["P"], m["chunk"]
    g = torch.Generator(device="cuda").manual_seed(3)
    shape = (m["n_pages"] + 1, m["ps"], m["L"], m["Hkv"], m["hd"])
    caches = {
        "pages_k": torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16),
        "pages_v": torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16),
        "block": torch.randperm(m["n_pages"], generator=g, device="cuda")[
            :B * P].reshape(B, P).to(torch.int32)}
    i32 = dict(dtype=torch.int32, device="cuda")
    pos = torch.randint(65, 513, (B,), generator=g, device="cuda").to(
        torch.int32)
    cur = torch.randint(0, vocab, (B,), generator=g, device="cuda").to(
        torch.int32)
    rem, eos = torch.full((B,), 1000, **i32), torch.full((B,), -1, **i32)
    chunk = torch.randint(0, vocab, (B, C), generator=g, device="cuda").to(
        torch.int32)
    start = (torch.randint(0, 7, (B,), generator=g, device="cuda")
             * C).to(torch.int32)
    nval = torch.full((B,), C, **i32)
    name = model.cfg.name
    profile_split((
        (f"{name} slot_paged decode block K={k}", k,
         lambda: model.decode_loop(params, caches, cur, pos, rem, eos, k=k,
                                   max_len=1024)),
        (f"{name} slot_paged prefill chunk T=64", 1,
         lambda: model.prefill_chunk_into(params, caches, chunk, start,
                                          nval))), smi)


def phase_split_dense(model, params, smi: str):
    """The dense path (slot_fused): one B=1 monolithic prefill of 256 and
    of 512 tokens (flash), and one K=8 decode block at B=4 over a dense
    [4, 1024] ring with lengths 65..512 (paged kernel over identity
    pages)."""
    import torch
    d, vocab = DENSE, model.cfg.vocab_size
    B = d["B"]
    g = torch.Generator(device="cuda").manual_seed(4)
    rk, rv = dense_ring(torch, B, seed=5)
    caches = {"k": rk, "v": rv}
    i32 = dict(dtype=torch.int32, device="cuda")
    pos = torch.randint(65, 513, (B,), generator=g, device="cuda").to(
        torch.int32)
    cur = torch.randint(0, vocab, (B,), generator=g, device="cuda").to(
        torch.int32)
    rem, eos = torch.full((B,), 1000, **i32), torch.full((B,), -1, **i32)
    prompts = {T: torch.randint(0, vocab, (1, T), generator=g,
                                device="cuda").to(torch.int32)
               for T in (256, 512)}
    profile_split((
        ("slot_fused prefill B=1 T=256", 1, lambda: model.prefill(
            params, prompts[256], d["size"])),
        ("slot_fused prefill B=1 T=512", 1, lambda: model.prefill(
            params, prompts[512], d["size"])),
        ("slot_fused decode block K=8 B=4", 8, lambda: model.decode_loop(
            params, caches, cur, pos, rem, eos, k=8, max_len=d["size"]))),
        smi)


# ---------------------------------------------------------------------------
# Phases 3c-3e: the robustness paths of slot_paged at full width
# ---------------------------------------------------------------------------
# smollm-135m's slot_paged geometry for the three robustness runs; the
# overload run's pool of 128 pages (47 MB of K/V) is what forces
# preemption.
ROBUST = dict(max_len=1024, page_size=16, chunk_tokens=64, k_max=8)
RAISING_SITES = ("engine.dispatch", "engine.sync", "transport.stall")
FAULT_SITES = ("engine.dispatch", "engine.sync", "pool.page_write",
               "pool.claim", "pool.extend", "transport.recv",
               "transport.send_burst", "transport.stall")


def zero_counts(forwards):
    """Every kernel counter and the model's forward counts set to 0."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    fa.launches = fa.simt_launches = fa.noncausal_launches = 0
    fa.bwd_launches = fa.split_launches = 0
    pa.launches = pa.split_launches = pa.simt_launches = 0
    pa.ring_launches = 0
    forwards[0] = forwards[1] = 0


def read_counts(forwards, label: str, L: int):
    """The launches since ``zero_counts``; checks that the paged kernel
    ran 30 times per forward (on the split route for each layer of a
    one-token decode forward), flash never, and no CUDA-core route."""
    c = _counts()
    got = dict(paged=c["paged"], psplit=c["psplit"],
               flash=c["causal"] + c["noncausal"], simt=c["simt"],
               forwards=forwards[0], decode_forwards=forwards[1])
    check(got["forwards"] > 0 and got["paged"] == L * got["forwards"],
          f"{label}: paged launches {got['paged']} != {L} x "
          f"{got['forwards']} forwards")
    check(got["psplit"] == L * got["decode_forwards"],
          f"{label}: paged split launches {got['psplit']} != {L} x "
          f"{got['decode_forwards']} decode forwards")
    check(got["flash"] == 0 and got["simt"] == 0,
          f"{label}: flash launches {got['flash']}, CUDA-core launches "
          f"{got['simt']}")
    return got


def drive_inline(eng, handles, label: str, max_ticks: int = 2000,
                 on_tick=None) -> int:
    """Tick ``eng`` on this thread until every handle is terminal; the
    tick budget is the no-wedge check.  ``on_tick(ticks)`` may submit
    more work (it returns the handles to add)."""
    ticks = 0
    while not all(h.test() for h in handles):
        ticks += 1
        check(ticks < max_ticks, f"{label}: wedged after {ticks} ticks "
              f"({sum(h.test() for h in handles)}/{len(handles)} done)")
        eng.tick()
        if on_tick is not None:
            handles.extend(on_tick(ticks))
    return ticks


def clean_run(eng, label: str) -> None:
    """A run with no fault plan: the watchdog caught nothing and no
    request failed (a real device error cannot hide behind the
    watchdog), the pool drained and its copy ledger balances."""
    fr = eng.fault_report()
    check(fr["tick_failures"] == 0 and fr["requests_failed"] == 0
          and fr["dead"] is None and fr["faults_injected"] == 0,
          f"{label}: fault report {fr}")
    pool = eng.pool
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()
    check(pool.n_seqs() == 0 and pool.used_pages() == 0,
          f"{label}: pool not drained: {pool.stats()}")
    check(pool.kv_copy_bytes == pool.cow_copy_bytes + pool.swap_in_bytes
          + pool.swap_out_bytes, f"{label}: copy ledger {pool.stats()}")


def tokens_of(h):
    return list(map(int, h.response.tokens_out))


def serve_alone(model, params, prompt, max_tokens: int):
    """One request on a fresh slot_paged engine, no policy: the stream
    a preempted, failed-around or restored request must reproduce."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(model, params, max_batch=8, n_clients=1,
                      pool_pages=128, scheduler="slot_paged", **ROBUST)
    h = eng.connect(0).submit_i(prompt, max_tokens=max_tokens)
    drive_inline(eng, [h], "served alone")
    check(h.response.fsm.state.endswith("COMPLETED"),
          f"served alone: {h.response.fsm.state}")
    clean_run(eng, "served alone")
    return tokens_of(h)


def phase_overload(model, params, forwards, smi: str):
    """Overload control with page-swap preemption: 2 priority classes,
    preemption and WFQ, 8 slots over a 128-page pool.  Two low-class
    clients each send 2 requests (400-480 prompt tokens, 64 new), one
    outstanding at a time; once both hold a decoding slot, two
    high-class clients each send 4 requests at once (40-120 prompt
    tokens, 32 new).  Returns the paged launches."""
    import numpy as np
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.overload import OverloadPolicy
    L, vocab = model.cfg.num_layers, model.cfg.vocab_size
    rng = np.random.default_rng(2024)
    low = {c: [rng.integers(0, vocab, int(rng.integers(400, 481)))
               for _ in range(2)] for c in (0, 1)}
    high = {c: [rng.integers(0, vocab, int(rng.integers(40, 121)))
                for _ in range(4)] for c in (2, 3)}
    policy = OverloadPolicy(n_classes=2, preemption=True, wfq=True)
    # No prefix cache: its references would keep a parked sequence's
    # prompt pages resident (shared pages never move), and the burst
    # would find the pool full with no victim left to swap.
    eng = ServeEngine(model, params, max_batch=8, n_clients=4,
                      pool_pages=128, scheduler="slot_paged",
                      prefix_cache=False, overload=policy, **ROBUST)
    page_b = eng.pool.page_nbytes
    kv_mb = eng.pool.n_pages * page_b
    print(f"overload: slot_paged, 2 classes, preemption, WFQ, max_batch 8, "
          f"pool 128 pages ({kv_mb / 1e6:.0f} MB of K/V, {page_b} B a "
          f"page), no prefix cache")
    sess = [eng.connect(c) for c in range(4)]
    parked_ids, tables = set(), []
    orig_bt = eng._block_table

    def recording_block_table():
        bt = orig_bt()
        tables.append(int(bt.min()))
        parked_ids.update(p.req.req_id for p in eng._parked)
        return bt
    eng._block_table = recording_block_table
    sent = {c: 0 for c in (0, 1)}
    handles, prompts_of = [], {}
    lows = {}

    def send_low(c):
        h = sess[c].submit_i(low[c][sent[c]], max_tokens=64, priority=1)
        prompts_of[h.req_id] = (low[c][sent[c]], 64)
        lows[c] = h
        sent[c] += 1
        return h
    highs_sent = [False]

    def on_tick(ticks):
        new = []
        for c in (0, 1):
            if lows[c].test() and sent[c] < len(low[c]):
                new.append(send_low(c))
        if (not highs_sent[0] and all(
                s.request is not None and s.generated > 0
                and s.request.client_id in (0, 1)
                for s in eng.slots[:2])):
            highs_sent[0] = True
            for c in (2, 3):
                for p in high[c]:
                    h = sess[c].submit_i(p, max_tokens=32, priority=0)
                    prompts_of[h.req_id] = (p, 32)
                    new.append(h)
        return new

    zero_counts(forwards)
    t0 = time.monotonic()
    handles = [send_low(0), send_low(1)]
    ticks = drive_inline(eng, handles, "overload", on_tick=on_tick)
    dt = time.monotonic() - t0
    got = read_counts(forwards, "overload", L)
    st = eng.stats
    n_req = sum(map(len, low.values())) + sum(map(len, high.values()))
    check(highs_sent[0] and len(handles) == n_req, "overload: the high-"
          f"class burst never came ({len(handles)} requests)")
    check(all(h.response.fsm.state.endswith("COMPLETED") for h in handles),
          "overload: not every request completed: "
          + str([h.response.fsm.state for h in handles]))
    check(st["preemptions"] >= 1, "overload: no preemption")
    check(st["resumes"] == st["preemptions"] and not eng._parked,
          f"overload: {st['resumes']} resumes of {st['preemptions']} "
          "preemptions")
    check(st["swap_out_bytes"] > 0 and st["swap_out_bytes"] % page_b == 0
          and st["swap_in_bytes"] % page_b == 0,
          f"overload: swap bytes {st['swap_out_bytes']} / "
          f"{st['swap_in_bytes']} not whole pages of {page_b} B")
    check(min(tables) >= 0, "overload: a dispatched block table held a "
          "negative page")
    clean_run(eng, "overload")
    ttft = eng.class_ttft()
    print(f"overload: {n_req} requests in {ticks} ticks, {dt:.2f} s; "
          f"preemptions {st['preemptions']}, resumes {st['resumes']}, "
          f"swap out {st['swap_out_bytes']} B ({st['swap_out_bytes'] // page_b}"
          f" pages), swap in {st['swap_in_bytes']} B, host_syncs "
          f"{st['host_syncs']}, {len(tables)} dispatched block tables, none "
          f"negative; TTFT p50 high {ttft[0]['p50_ms']:.0f} ms (n="
          f"{ttft[0]['n']}), low {ttft[1]['p50_ms']:.0f} ms (n="
          f"{ttft[1]['n']}); launches paged {got['paged']} (split route "
          f"{got['psplit']}) over {got['forwards']} forwards [{smi}]")
    by_id = {h.req_id: h for h in handles}
    for rid in sorted(parked_ids):
        prompt, n = prompts_of[rid]
        check(tokens_of(by_id[rid]) == serve_alone(model, params, prompt, n),
              f"overload: preempted request {rid}'s stream differs from "
              "the same request served alone")
    print(f"overload: {len(parked_ids)} preempted requests' streams "
          "byte-identical to each served alone")
    return got["paged"]


def phase_faults(model, params, forwards, smi: str):
    """``FaultPlan.sweep(8, seed=0)`` over the sites the engine probes on
    this path, each plan a run of 4 requests with ``tick_retries=1``:
    every request ends in tokens or a typed terminal, nothing wedges,
    every failure is an injected fault, and the survivors' streams equal
    the run with no fault.  Returns the paged launches of all 9 runs."""
    import numpy as np
    from repro_torch.core.faults import FaultPlan
    from repro_torch.serve.engine import FailedStatus, ServeEngine
    L, vocab = model.cfg.num_layers, model.cfg.vocab_size
    rng = np.random.default_rng(77)
    prompts = [rng.integers(0, vocab, int(rng.integers(40, 201)))
               for _ in range(4)]

    def run(plan):
        eng = ServeEngine(model, params, max_batch=4, n_clients=2,
                          pool_pages=128, scheduler="slot_paged",
                          fault_plan=plan, tick_retries=1, **ROBUST)
        sess = [eng.connect(c) for c in range(2)]
        hs = [sess[i % 2].submit_i(p, max_tokens=24)
              for i, p in enumerate(prompts)]
        drive_inline(eng, hs, f"faults {plan}")
        return eng, hs

    total = 0
    zero_counts(forwards)
    ref_eng, ref_h = run(None)
    total += read_counts(forwards, "faults (no plan)", L)["paged"]
    clean_run(ref_eng, "faults (no plan)")
    ref = [tokens_of(h) for h in ref_h]
    check(all(len(t) == 24 for t in ref), "faults: the no-fault run")
    lines = []
    for plan in FaultPlan.sweep(8, seed=0, sites=FAULT_SITES):
        zero_counts(forwards)
        eng, hs = run(plan)
        total += read_counts(forwards, f"faults {plan.name}", L)["paged"]
        fr = eng.fault_report()
        check(eng.dead is None, f"faults {plan.name}: engine died")
        raised = sum(s in RAISING_SITES for s in plan.fired)
        check(fr["tick_failures"] == raised,
              f"faults {plan.name}: the watchdog caught "
              f"{fr['tick_failures']} exceptions, {raised} injected "
              f"({plan.fired})")
        refused = sum(s in ("pool.claim", "pool.extend")
                      for s in plan.fired)
        survived = 0
        for h, want in zip(hs, ref):
            r = h.response
            if r.fsm.state.endswith("COMPLETED"):
                check(tokens_of(h) == want,
                      f"faults {plan.name}: a survivor's stream differs")
                survived += 1
            elif isinstance(r.status, FailedStatus):
                check("injected fault" in r.status.reason
                      or "poisoned page write" in r.status.reason,
                      f"faults {plan.name}: failure not injected: "
                      f"{r.status.reason}")
            else:
                check(r.fsm.state.endswith("CANCELLED") and refused > 0,
                      f"faults {plan.name}: {r.fsm.state} with no "
                      "injected refusal")
        pool = eng.pool
        eng.prefix_cache.clear()
        check(pool.n_seqs() == 0
              and pool.used_pages() == len(pool.quarantined),
              f"faults {plan.name}: pool not drained")
        lines.append(f"{plan.name} fired {plan.fired}: {survived}/4 "
                     f"survived, {fr['requests_failed']} failed, "
                     f"{eng.stats['rejected']} rejected, "
                     f"{fr['tick_failures']} watchdog catches")
    print("faults: 8 plans x 4 requests, every survivor byte-identical to "
          "the no-fault run, every failure injected:\n  "
          + "\n  ".join(lines) + f"\n  paged launches {total} [{smi}]")
    return total


def phase_recovery(model, params, forwards, smi: str):
    """Crash recovery: snapshots every 2 ticks; the engine is abandoned
    at its second tick, its middle one and the one before last, and a
    fresh engine in this process restores from the newest snapshot plus
    the journal and finishes — every stream byte-identical to the
    uninterrupted run.  Returns the paged launches of the 4 runs."""
    import shutil

    import numpy as np
    from repro_torch.serve.engine import ServeEngine
    L, vocab = model.cfg.num_layers, model.cfg.vocab_size
    rng = np.random.default_rng(99)
    prompts = [rng.integers(0, vocab, int(rng.integers(150, 451)))
               for _ in range(4)]
    root = ROOT / "build" / "chip_smoke_snapshots"
    shutil.rmtree(root, ignore_errors=True)

    def make(d):
        return ServeEngine(model, params, max_batch=4, n_clients=2,
                           pool_pages=128, scheduler="slot_paged",
                           snapshot_dir=str(d), snapshot_every=2, **ROBUST)

    def run(d, kill=None):
        eng = make(d)
        sess = [eng.connect(c) for c in range(2)]
        hs = [sess[i % 2].submit_i(p, max_tokens=48)
              for i, p in enumerate(prompts)]
        ticks, info = 0, {}
        while not all(h.test() for h in hs):
            ticks += 1
            check(ticks < 2000, "recovery: wedged")
            eng.tick()
            if ticks == kill:
                for s in sess:
                    s.pump()
                fr = eng.fault_report()
                check(fr["tick_failures"] == 0,
                      f"recovery: fault report {fr}")
                info["snapshot_bytes"] = eng.stats["snapshot_bytes"]
                del eng                 # abandoned: no final snapshot
                eng = make(d)
                t0 = time.perf_counter()
                report = eng.restore_latest()
                info["restore_s"] = time.perf_counter() - t0
                check(report is not None and report["failed"] == 0,
                      f"recovery: restore at tick {kill}: {report}")
                info["report"] = report
                sess = [eng.connect(c, resume=s)
                        for c, s in enumerate(sess)]
        clean_run(eng, f"recovery kill@{kill}")
        return [tokens_of(h) for h in hs], ticks, info, eng

    total = 0
    zero_counts(forwards)
    ref, ticks, _, eng = run(root / "ref")
    total += read_counts(forwards, "recovery (uninterrupted)", L)["paged"]
    snaps, snap_b = eng.stats["snapshots"], eng.stats["snapshot_bytes"]
    check(all(len(t) == 48 for t in ref) and ticks >= 6,
          f"recovery: the uninterrupted run ({ticks} ticks)")
    lines = []
    for kill in sorted({2, ticks // 2, ticks - 1}):
        zero_counts(forwards)
        got, _, info, eng = run(root / f"kill{kill}", kill)
        total += read_counts(forwards, f"recovery kill@{kill}", L)["paged"]
        check(got == ref, f"recovery: kill at tick {kill}: streams differ "
                          "from the uninterrupted run")
        rep = info["report"]
        lines.append(f"kill@{kill}: restored {os.path.basename(rep['path'])}"
                     f" ({info['snapshot_bytes']} B) in "
                     f"{1e3 * info['restore_s']:.1f} ms, resumed "
                     f"{rep['resumed']}, replayed {rep['replayed']}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"recovery: 4 requests, {ticks} ticks, {snaps} snapshots "
          f"(last {snap_b} B); every restored stream byte-identical to "
          "the uninterrupted run:\n  " + "\n  ".join(lines)
          + f"\n  paged launches {total} [{smi}]")
    return total


# ---------------------------------------------------------------------------
# Phase 5: CPU/CUDA parity at float32
# ---------------------------------------------------------------------------
def _scaled(tree, scale: float):
    """Every weight matrix (rank >= 2) times ``scale``, as the parity
    tests' ``smoke_pair(scale=)`` does."""
    if isinstance(tree, dict):
        return {k: _scaled(v, scale) for k, v in tree.items()}
    return tree * scale if tree.dim() >= 2 else tree


def phase_parity():
    """The SMOKE configs at float32, same weights on both devices: greedy
    tokens identical on the CPU and the card; smollm under slot_paged,
    slot_fused and wave, olmoe (weights x3, so its streams vary and its
    expert capacity binds behind idle rows) under slot_paged and
    slot_fused; gemma (weights x3) under slot_chunked and slot_fused
    with prompts of up to 30 tokens and 16-token chunks, so its 8-slot
    local rings wrap in prefill, in chunks and in decode; llama-vision
    and whisper (weights x3) through an image- or frame-conditioned
    prefill + decode and under slot_chunked; zamba and rwkv (weights x3)
    under slot_fused, slot and wave; qwen3 and arctic at 10/2 and 14/2
    heads (g 5 and 7; weights x3) under slot_paged and slot_fused."""
    for arch, scheds, scale in (
            ("smollm-135m", ("slot_paged", "slot_fused", "wave"), 1.0),
            ("olmoe-1b-7b", ("slot_paged", "slot_fused"), 3.0)):
        parity(arch, scheds, scale)
    parity("gemma3-27b", ("slot_chunked", "slot_fused"), 3.0,
           prompt_extra=(0, 12, 23), chunk_tokens=16)
    lap("5 parity (smollm, olmoe, gemma)")
    for arch in ("llama-3.2-vision-11b", "whisper-tiny"):
        parity_cross(arch)
    lap("5 parity (llama-vision, whisper)")
    for arch in ("zamba2-2.7b", "rwkv6-1.6b"):
        parity(arch, ("slot_fused", "slot", "wave"), 3.0)
    lap("5 parity (zamba, rwkv)")
    for arch, heads in (("qwen3-14b", 10), ("arctic-480b", 14)):
        parity(arch, ("slot_paged", "slot_fused"), 3.0, num_heads=heads,
               num_kv_heads=2)
    lap("5 parity (qwen3 g 5, arctic g 7)")


def parity(arch: str, scheds, scale: float, prompt_extra=(0,),
           chunk_tokens: int = 4, **overrides):
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              **overrides)
    cpu_model = build_model(cfg, device="cpu")
    params = _scaled(cpu_model.init(torch.Generator().manual_seed(7)), scale)

    lengths = [12, 2, 7, 2, 1, 9, 24, 3]
    for sched in scheds:
        seqs = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, device=dev)
            eng = ServeEngine(model, _to_device(params, dev), max_batch=2,
                              max_len=64, n_clients=1, pool_pages=64,
                              page_size=4, chunk_tokens=chunk_tokens,
                              scheduler=sched, device=dev)
            for i, n in enumerate(lengths):
                plen = 5 + i % 3 + prompt_extra[i % len(prompt_extra)]
                check(eng.submit(0, (np.arange(plen) + 3 * i)
                                 % cfg.vocab_size, max_tokens=n)
                      is not None, "intake full")
            while (eng.stats["served"] + eng.stats["rejected"]
                   < len(lengths)):
                eng.step()
            check(eng.stats["rejected"] == 0
                  and eng.fault_report()["tick_failures"] == 0,
                  f"{sched} {dev}: requests rejected or a tick failed")
            got = {}
            for _ in lengths:
                r = eng.get_response(0, timeout_s=30)
                check(bool(r), f"{sched}: parity response timed out")
                got[r.req_id] = list(map(int, r.tokens_out))
            seqs[dev] = [got[k] for k in sorted(got)]
        check(seqs["cpu"] == seqs["cuda"],
              f"{arch} {sched}: CPU and CUDA greedy tokens differ")
        print(f"cpu/cuda parity, {arch} {sched}: "
              f"{sum(map(len, seqs['cuda']))} greedy tokens identical "
              f"(SMOKE, {cfg.num_heads}/{cfg.num_kv_heads} heads, float32, "
              f"weights x{scale:g})")


# ---------------------------------------------------------------------------
# Phase 8: the interleaving checker on the card machine's host
# ---------------------------------------------------------------------------
CHECK_BUDGET = 1500     # benchmarks/bench_check.py --quick


def phase_checker():
    """The port's checker over the port's core: every scenario explored
    at its own budget (at most 1500 executions, as bench_check's quick
    mode), one line each; a verdict other than the scenario's ``expect``
    fails.  The six schedules of ``tests/schedules/`` replayed in place,
    each failing exactly when it expects a violation.  Then the
    functional bit set on a CUDA tensor against ``HostBitset`` for a
    fixed claim/release sequence."""
    from repro_torch.checker import scenarios
    from repro_torch.core import bitset
    from repro_torch.core import interleave as il
    t0 = time.monotonic()
    for name, scen in scenarios.SCENARIOS.items():
        budget = min(scen.explore_budget, CHECK_BUDGET)
        r = scenarios.explore_scenario(name, max_executions=budget)
        verdict = "pass" if r.ok else "violation"
        cx = r.counterexample
        print(f"  checker {name}: expect {scen.expect}, got {verdict} "
              f"({r.executions} executions, {r.distinct_states} distinct "
              f"states, exhausted {r.exhausted}"
              + ("" if cx is None else f", {cx.error_type} at schedule "
                 f"{list(cx.schedule)}") + ")")
        check(verdict == scen.expect, f"checker {name}: {verdict}, expected "
                                      f"{scen.expect}")
    corpus = sorted((ROOT / "tests" / "schedules").glob("*.json"))
    check(len(corpus) == 6, f"schedule corpus: {len(corpus)} files")
    for path in corpus:
        rec = il.load_schedule(str(path))
        scen = scenarios.get(rec["scenario"])
        res = il.run_schedule(scen.make_world, rec["schedule"],
                              max_steps=scen.max_steps, strict=False)
        check(res.failed == (rec["expect"] == "violation"),
              f"schedule {path.name}: failed={res.failed}, expected "
              f"{rec['expect']} ({res.error!r})")
    print(f"checker: {len(scenarios.SCENARIOS)} scenarios as expected, "
          f"{len(corpus)} schedules replayed as recorded "
          f"({time.monotonic() - t0:.1f} s on the host)")
    host, bits = bitset.HostBitset(40), bitset.init(40, device="cuda")
    ops = [None] * 42 + [3, 33, None, None, 0, None]   # None: claim
    for op in ops:
        if op is None:
            bits, slot = bitset.claim_first_free(bits, 40)
            want = host.try_claim(owner=object())
            check(int(slot) == (-1 if want is None else want),
                  f"bitset claim: cuda {int(slot)}, host {want}")
        else:
            bits = bitset.release(bits, op)
            host.release(op)
            check(not bool(bitset.is_claimed(bits, op)), "bitset release")
        check(int(bitset.count(bits)) == host.count(), "bitset count")
    check(bits.is_cuda, "bitset words left the card")
    print(f"bitset: {len(ops)} claims and releases on a CUDA tensor equal "
          f"HostBitset's (slots, -1 when full, counts)")


# ---------------------------------------------------------------------------
# Phase 6: kernel timing at the main paths' shapes
# ---------------------------------------------------------------------------
def work(q, block, lens, hkv: int, itemsize: int, kv_lens=None):
    """(bytes, flops) the function needs on these inputs: q, out, the
    block table, lens and kv_lens once each, and the K/V of every
    position below each row's key end (min(lens, kv_lens); the timed
    inputs stay inside the table) once per kv head; two hd-long dot
    products per (query head, visible key)."""
    B, T, H, hd = q.shape
    lens_l = [int(x) for x in lens.tolist()]
    kv_l = (lens_l if kv_lens is None
            else [int(x) for x in kv_lens.tolist()])
    ends = [max(0, min(n, k)) for n, k in zip(lens_l, kv_l)]
    kv_bytes = sum(ends) * hkv * hd * 2 * itemsize
    nbytes = (2 * q.numel() * itemsize + kv_bytes + block.numel() * 4
              + len(lens_l) * 4 * (1 if kv_lens is None else 2))
    visible = sum(max(0, min(e, n - T + t + 1)) for n, e in zip(lens_l, ends)
                  for t in range(T))
    return nbytes, 4 * hd * H * visible


def parent_paged():
    """The paged-attention wrapper of another checkout of the repository
    (its root in ``CHIP_SMOKE_PARENT``, e.g. the parent commit unpacked
    under ``build/``), built from that checkout's own kernel source, so
    phase 6 times it in turns with this tree's kernel on the same inputs;
    None when the variable is unset."""
    root = os.environ.get("CHIP_SMOKE_PARENT")
    if not root:
        return None
    import importlib.util
    path = Path(root) / "src" / "repro_torch" / "kernels" / \
        "paged_attention.py"
    spec = importlib.util.spec_from_file_location("parent_paged_attention",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = path.parent / "csrc" / "paged_attention.cu"
    return mod


def parent_turns(kern, call) -> str:
    """With a parent checkout (:func:`parent_paged`), its kernel and this
    tree's timed in turns (parent, this, this, parent) on the same
    inputs, as printed text; else ''.  ``call(mod, i)`` runs one call
    through the wrapper module ``mod``."""
    parent = parent_paged()
    if parent is None:
        return ""
    a = timed(lambda i: call(parent, i))
    b, c = timed(kern), timed(kern)
    d = timed(lambda i: call(parent, i))
    return (f"; in turns, parent {a:.4f} ms, this tree {b:.4f} and "
            f"{c:.4f} ms, parent {d:.4f} ms")


def paged_timing_row(label: str, q, views, block, lens, smi: str,
                     kv_lens=None):
    """Device ms of the paged kernel (cycling ``views``, one layer's K/V
    each, so a call finds its K/V out of L2 as the served model does),
    its bound, its plain version, and the gather + SDPA yardstick on the
    same inputs (``kv_lens`` as the served path passes it); printed, and
    returned as (ms, plain, bound, by)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    B, T, H, hd = q.shape
    ps, Hkv = views[0][0].shape[1], views[0][0].shape[2]
    P = block.shape[1]
    S, n = P * ps, len(views)
    kern = lambda i: pa.paged_attention(  # noqa: E731
        q, *views[i % n], block, lens, kv_lens=kv_lens)
    plain = lambda i: ref.paged_attention_ref(  # noqa: E731
        q, *views[i % n], block, lens, kv_lens=kv_lens)

    def gather(i):
        k, v = views[i % n]
        blk = block.long()
        return (k[blk].reshape(B, S, Hkv, hd), v[blk].reshape(B, S, Hkv, hd))

    kg, vg = gather(0)
    q_pos = lens.long()[:, None] - T + torch.arange(T, device="cuda")[None]
    kv_pos = torch.arange(S, device="cuda")[None, None, :]
    mask = kv_pos <= q_pos[:, :, None]
    if kv_lens is not None:
        mask &= kv_pos < kv_lens.long()[:, None, None]
    mask = mask[:, None]                                 # [B,1,T,S]
    g = H // Hkv
    qt, kt, vt = (x.transpose(1, 2) for x in (
        q, kg.repeat_interleave(g, dim=2), vg.repeat_interleave(g, dim=2)))
    sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask)
    before = (pa.launches, pa.split_launches)
    t_kern = timed(kern)
    t_plain = timed(plain, inner=10)
    t_gather = timed(gather, inner=10)
    t_sdpa = timed(sdpa, inner=10)
    turns = parent_turns(kern, lambda mod, i: mod.paged_attention(
        q, *views[i % n], block, lens, kv_lens=kv_lens))
    pa.launches, pa.split_launches = before   # timing is not counted
    nbytes, flops = work(q, block, lens, Hkv, 2, kv_lens)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    bound = max(t_bytes, t_ops)
    way = pa.route(q, *views[0])
    runs = pa.plan(q, *views[0], block)[1]
    plan = "" if runs is None else (f", {runs[1]} runs of {runs[0]} keys "
                                    "at most")
    kv = "" if kv_lens is None else f", kv_lens {kv_lens.tolist()}"
    print(f"paged_attention {label} (H={H}, Hkv={Hkv}, hd={hd}, ps={ps}, "
          f"P={P}, bf16, lens {lens.tolist()}{kv}; route {way}{plan}): "
          f"kernel "
          f"{t_kern:.4f} ms, bound {bound:.5f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), plain "
          f"{t_plain:.4f} ms; yardstick (not used by the port): gather "
          f"{t_gather:.4f} ms + SDPA on gathered K/V {t_sdpa:.4f} ms"
          f"{turns} [{smi}]")
    return t_kern, t_plain, bound, by


def phase_timing_paged(launches: int, max_err: float, smi: str):
    """The paged kernel at the main paths' shapes: slot_paged's T=1
    decode and T=64 chunk (B=8 over the strided layer views of the pool)
    and slot_fused's decode read (B=4 over the [4, 1024] ring as 64-token
    identity pages, lens 65/300/513/1000), then olmoe-1b-7b's T=1 and
    T=64 (hd 128, 16 kv heads, g 1, with kv_lens).  The kernel JSON row
    carries smollm's T=1 decode, the hot shape."""
    import torch
    from repro_torch.models.layers import ring_page_size
    m, d = MAIN, DENSE
    rows = {}
    for T in (1, m["chunk"]):
        q, pk, pv, block, lens = main_path_inputs(torch, T, seed=100 + T)
        views = [(pk[:, :, li], pv[:, :, li]) for li in range(m["L"])]
        rows[T] = paged_timing_row(f"T={T} B={m['B']}", q, views, block,
                                   lens, smi)
    B, size = d["B"], d["size"]
    ps = ring_page_size(size)
    rk, rv = dense_ring(torch, B, seed=102)
    views = [(rk[li].view(B * size // ps, ps, d["Hkv"], d["hd"]),
              rv[li].view(B * size // ps, ps, d["Hkv"], d["hd"]))
             for li in range(d["L"])]
    block = torch.arange(B * size // ps, dtype=torch.int32,
                         device="cuda").view(B, size // ps)
    lens = torch.tensor([65, 300, 513, 1000], dtype=torch.int32,
                        device="cuda")
    g = torch.Generator(device="cuda").manual_seed(103)
    q = torch.randn((B, 1, d["H"], d["hd"]), generator=g,
                    device="cuda").to(torch.bfloat16)
    paged_timing_row(f"dense-ring decode T=1 B={B}", q, views, block, lens,
                     smi)
    # olmoe-1b-7b's slot_paged shapes, with kv_lens = lens as every row of
    # a served batch that writes passes it.
    m = OLMOE
    for T in (1, m["chunk"]):
        q, pk, pv, block, lens = main_path_inputs(torch, T, 110 + T, m)
        views = [(pk[:, :, li], pv[:, :, li]) for li in range(m["L"])]
        paged_timing_row(f"olmoe T={T} B={m['B']}", q, views, block, lens,
                         smi, kv_lens=lens.clone())
        del q, pk, pv, views
    t_kern, t_plain, bound, by = rows[1]
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:152",
            "launches": launches, "max_abs_err": max_err, "ms": t_kern,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def ring_work(q, block, lens, kv_lens, ring: int, window: int, hkv: int,
              itemsize: int):
    """(bytes, flops) a ring read needs on these inputs: q, out, the
    block table, lens and kv_lens once each, and the K/V of the row's
    keys (the positions [max(0, n - ring), n) it still holds, n =
    kv_lens or lens) once per kv head; two hd-long dot products per
    (query head, visible key), query q seeing the positions in [max(lo,
    q - window + 1), min(q, n - 1)]."""
    B, T, H, hd = q.shape
    lens_l = [int(x) for x in lens.tolist()]
    n_l = lens_l if kv_lens is None else [int(x) for x in kv_lens.tolist()]
    held = [min(n, ring) for n in n_l]
    nbytes = (2 * q.numel() * itemsize + sum(held) * hkv * hd * 2 * itemsize
              + block.numel() * 4 + B * 4 * (1 if kv_lens is None else 2))
    visible = 0
    for ln, n in zip(lens_l, n_l):
        lo = max(0, n - ring)
        for t in range(T):
            qp = ln - T + t
            first = max(lo, qp - window + 1) if window else lo
            visible += max(0, min(qp, n - 1) - first + 1)
    return nbytes, 4 * hd * H * visible


def ring_timing_row(label: str, q, views, block, lens, kv_lens, smi: str):
    """Device ms of the paged kernel under the ring bound at gemma's
    local-layer shapes (cycling ``views``, one layer's ring each), its
    bound, its plain version, and the yardstick the port never calls: a
    gather of the ring into position order plus masked SDPA.  Returns
    (ms, plain, bound, by, gather + SDPA ms)."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    d = GEMMA
    B, T, H, hd = q.shape
    ring, window, Hkv, n = d["size"], d["window"], d["Hkv"], len(views)
    kw = dict(kv_lens=kv_lens, ring=ring, window=window)
    kern = lambda i: pa.paged_attention(  # noqa: E731
        q, *views[i % n], block, lens, **kw)
    plain = lambda i: ref.paged_attention_ref(  # noqa: E731
        q, *views[i % n], block, lens, **kw)
    gather = lambda i: ref._ring_keys(  # noqa: E731
        q, *views[i % n], block, lens, kv_lens, ring, window)
    kg, vg, mask = gather(0)
    g = H // Hkv
    qt, kt, vt = (x.transpose(1, 2) for x in (
        q, kg.repeat_interleave(g, dim=2), vg.repeat_interleave(g, dim=2)))
    sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask[:, None])
    before = (pa.launches, pa.split_launches, pa.ring_launches)
    t_kern = timed(kern)
    t_plain = timed(plain, inner=10)
    t_gather = timed(gather, inner=10)
    t_sdpa = timed(sdpa, inner=10)
    turns = parent_turns(kern, lambda mod, i: mod.paged_attention(
        q, *views[i % n], block, lens, **kw))
    pa.launches, pa.split_launches, pa.ring_launches = before
    nbytes, flops = ring_work(q, block, lens, kv_lens, ring, window, Hkv, 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    bound = max(t_bytes, t_ops)
    way = pa.route(q, *views[0])
    kv = "" if kv_lens is None else f", kv_lens {kv_lens.tolist()}"
    print(f"paged_attention ring bound {label} (ring {ring}, window "
          f"{window}, H={H}, Hkv={Hkv}, hd={hd}, ps={d['ps']}, bf16, lens "
          f"{lens.tolist()}{kv}; route {way}): kernel {t_kern:.4f} ms, "
          f"bound {bound:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP), plain {t_plain:.4f} ms; yardstick "
          f"(not used by the port): gather into position order "
          f"{t_gather:.4f} ms + masked SDPA {t_sdpa:.4f} ms{turns} [{smi}]")
    return t_kern, t_plain, bound, by, t_gather + t_sdpa


def phase_timing_ring(launches: int, max_err: float, smi: str):
    """The ring bound at gemma3-27b's local-layer shapes: the T=1 decode
    (the dense decode loop passes no kv_lens) and the T=64 chunk (kv_lens
    = lens, as a chunk's write mask gives), B=4, rows at n = 700, 1024,
    1500 and 2047, over 8 layers' rings.  The JSON row carries T=1."""
    import torch
    rows = {}
    for T, with_kv in ((1, False), (GEMMA["chunk"], True)):
        views = [gemma_ring(torch, 200 + i)[:2] for i in range(8)]
        block = gemma_ring(torch, 0)[2]
        q, lens, _ = ring_inputs(torch, T, None, 210 + T, torch.bfloat16)
        rows[T] = ring_timing_row(f"T={T} B={GEMMA['B']}", q, views, block,
                                  lens, lens.clone() if with_kv else None,
                                  smi)
        del views
    t_kern, t_plain, bound, by, lib = rows[1]
    return {"name": "paged_attention_ring", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:152",
            "launches": launches, "max_abs_err": max_err, "ms": t_kern,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib}


def flash_work(B: int, T: int, S: int, H: int, Hkv: int, hd: int,
               itemsize: int):
    """(bytes, flops) causal flash needs on these inputs: q, k, v read
    once and out written once; two hd-long dot products per (query head,
    visible key), a query t seeing keys 0 .. t + S - T."""
    nbytes = (2 * B * T * H * hd + 2 * B * S * Hkv * hd) * itemsize
    visible = B * sum(min(S, t + S - T + 1) for t in range(T))
    return nbytes, 4 * hd * H * visible


def phase_timing_flash(launches: int, max_err: float, split_err: float,
                       train_hd80: int, smi: str):
    """Flash at the dense main path's shapes: B=1 causal prefills (T=S,
    the wgmma route) and the wave's B=4 one-token decode at S=513 (the
    split route), bf16, over ring slices (the 30 layers' slices are
    cycled, as the served model reads them); then the training shapes
    (B=4, T=S=1024: smollm's 9/3 heads of 64, zamba2-2.7b's 32/32 of 80)
    as training runs them, with the log-sum-exp (``flash_attention_fwd``).
    The yardstick is one ``scaled_dot_product_attention`` call on the
    same inputs (GQA, causal at T == S); the port never calls it.
    Returns the JSON rows of the T=256 prefill (the commonest bucket),
    the wave decode (with every served run's split-route launches) and
    the hd 80 training forward (7b's forward launches)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    d = DENSE
    g = torch.Generator(device="cuda").manual_seed(200)
    rows = {}
    tr, zt = TRAIN_ATTN, ZAMBA_ATTN
    shapes = ([(1, T, T, d) for T in d["prefill"]]
              + [(d["B"], 1, d["decode_S"], d), (tr["B"], tr["T"], tr["T"], d),
                 (zt["B"], zt["T"], zt["T"], zt)])
    for B, T, S, m in shapes:
        H, Hkv, hd = m["H"], m["Hkv"], m["hd"]
        n = d["L"] if m is d else 9
        shape = (n, B, d["size"], Hkv, hd)
        rk, rv = (torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        views = [(rk[li][:, :S], rv[li][:, :S]) for li in range(n)]
        q = torch.randn((B, T, H, hd), generator=g,
                        device="cuda").to(torch.bfloat16)
        tviews = [(k.transpose(1, 2), v.transpose(1, 2)) for k, v in views]
        qt = q.transpose(1, 2)
        train = T == tr["T"]
        fwd = fa.flash_attention_fwd if train else fa.flash_attention
        way = fa.forward_route(T, S, H, Hkv, hd, q.dtype, True)[0]
        what = ("training shape, with lse" if train else "ring slice")
        before = (fa.launches, fa.split_launches)
        rows[(T, hd)] = flash_timing(
            f"flash_attention B={B} T={T} S={S} (H={H}, Hkv={Hkv}, hd={hd}, "
            f"causal, bf16, {what}, {way} route)",
            lambda i: fwd(q, *views[i % n]),  # noqa: B023
            lambda i: ref.flash_attention_ref(q, *views[i % n]),  # noqa: B023
            lambda i: F.scaled_dot_product_attention(  # noqa: B023
                qt, *tviews[i % n], is_causal=T > 1, enable_gqa=True),
            *flash_work(B, T, S, H, Hkv, hd, 2), smi)
        fa.launches, fa.split_launches = before   # timing is not counted
        del rk, rv, views, tviews, q, qt
    return [flash_json("flash_attention", rows[(256, 64)], launches,
                       max_err),
            flash_json("flash_attention_split", rows[(1, 64)],
                       sum(SPLIT_SERVED.values()), split_err),
            flash_json("flash_attention_hd80_train_forward",
                       rows[(zt["T"], 80)], train_hd80, max_err)]


def phase_timing_hd80(launches: dict, flash_err: float, paged_err: float,
                      smi: str):
    """zamba2-2.7b's shared attention at head_dim 80 (32/32 heads), bf16,
    over its 9 superblocks' [1, 1024] and [4, 1024] rings (cycled, as the
    served model reads them): the flash prefill at B=1, T=S=256 and the
    dense-ring decode read at B=4 (the paged kernel's split route over
    64-token identity pages, rows at 65-160 as 3j's served rows), each
    beside its bound, its plain version and SDPA on the same shape (on
    gathered K/V for the paged read).  Returns the two JSON rows, with
    3j's served launches."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    h = HD80
    H, Hkv, hd, size, ps = h["H"], h["Hkv"], h["hd"], h["size"], h["ps"]
    n = 9
    g = torch.Generator(device="cuda").manual_seed(530)

    def rings(B):
        shape = (n, B, size, Hkv, hd)
        return tuple(torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))

    T = S = 256
    rk, rv = rings(1)
    views = [(rk[i][:, :S], rv[i][:, :S]) for i in range(n)]
    tviews = [(k.transpose(1, 2), v.transpose(1, 2)) for k, v in views]
    q = torch.randn((1, T, H, hd), generator=g, device="cuda").to(
        torch.bfloat16)
    qt = q.transpose(1, 2)
    before = fa.launches
    row = flash_timing(
        f"flash_attention hd 80, zamba prefill B=1 T={T} S={S} (H={H}, "
        f"Hkv={Hkv}, hd={hd}, causal, bf16, ring slice, wgmma route)",
        lambda i: fa.flash_attention(q, *views[i % n]),
        lambda i: ref.flash_attention_ref(q, *views[i % n]),
        lambda i: F.scaled_dot_product_attention(
            qt, *tviews[i % n], is_causal=True),
        *flash_work(1, T, S, H, Hkv, hd, 2), smi)
    fa.launches = before                    # timing launches are not counted
    flash_row = flash_json("flash_attention_hd80", row, launches["flash"],
                           flash_err)
    del rk, rv, views, tviews, q, qt
    B = 4
    rk, rv = rings(B)
    P = size // ps
    pviews = [(rk[i].view(B * P, ps, Hkv, hd), rv[i].view(B * P, ps, Hkv,
                                                          hd))
              for i in range(n)]
    block = torch.arange(B * P, dtype=torch.int32, device="cuda").view(B, P)
    lens = torch.tensor([65, 100, 129, 160], dtype=torch.int32,
                        device="cuda")
    q = torch.randn((B, 1, H, hd), generator=g, device="cuda").to(
        torch.bfloat16)
    t_kern, t_plain, bound, by = paged_timing_row(
        f"hd 80, zamba dense-ring decode T=1 B={B}", q, pviews, block, lens,
        smi)
    paged_row = {"name": "paged_attention_hd80", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
                 "replaces": "src/repro/kernels/paged_attention.py:152",
                 "launches": launches["paged"], "max_abs_err": paged_err,
                 "ms": t_kern, "plain_ms": t_plain, "bound_ms": bound,
                 "bound_by": by, "library_ms": None}
    return [flash_row, paged_row]


NBB_TIMING = ((512, 1024, 512), (4096, 4096, 4096))


def phase_timing_nbb(launches: int, max_err: float, smi: str):
    """The NBB matmul in bf16 at the benchmark's shape and at 4096^3,
    beside its bound (FLOPs at the bf16 tensor-core peak, or a, b and c
    moved once), its plain version and one ``torch.matmul`` (cuBLAS, a
    yardstick the port never calls)."""
    import torch
    from repro_torch.kernels import nbb_matmul as nbb
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(300)
    rows = {}
    for M, K, N in NBB_TIMING:
        a = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        b = torch.randn((K, N), generator=g, device="cuda").to(torch.bfloat16)
        inner = 50 if M * N * K < 1e9 else 5
        before = nbb.launches
        t_kern = timed(lambda i: nbb.nbb_matmul(a, b), inner=inner)
        t_plain = timed(lambda i: ref.matmul_ref(a, b), inner=inner)
        t_lib = timed(lambda i: torch.matmul(a, b), inner=inner)
        nbb.launches = before               # timing launches are not counted
        flops = 2 * M * N * K
        nbytes = (M * K + K * N + M * N) * 2
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        bound = max(t_bytes, t_ops)
        inst = nbb.instance_for(torch.bfloat16, M, N)
        print(f"nbb_matmul {M} x {K} x {N} bf16 (instance {inst}: tile "
              f"{nbb.TILE[inst]}, {nbb.SLOTS[inst]} slots): kernel "
              f"{t_kern:.4f} ms "
              f"({flops / t_kern / 1e9:.1f} TFLOP/s), bound {bound:.5f} ms "
              f"({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP), "
              f"plain {t_plain:.4f} ms, library (torch.matmul, not used by "
              f"the port) {t_lib:.4f} ms [{smi}]")
        rows[M] = (t_kern, t_plain, bound, by, t_lib)
    t_kern, t_plain, bound, by, t_lib = rows[NBB_BENCH[0]]
    return {"name": "nbb_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/nbb_matmul.cu",
            "replaces": "src/repro/kernels/nbb_matmul.py:96",
            "launches": launches, "max_abs_err": max_err, "ms": t_kern,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": t_lib}


def phase_timing_trainable(launches: int, max_err: float, smi: str,
                           shape=TRAIN_ATTN, name="flash_attention_trainable"):
    """``flash_attention_trainable`` forward + backward at a training
    shape (smollm's B=4, T=S=1024, H=9, Hkv=3, hd=64 or zamba2-2.7b's
    32/32 heads of 80; causal, bf16), beside its bound (a flash
    backward's five products and the forward's two, or q, k, v, dout read
    and out, dq, dk, dv written once), autograd through the plain
    version, and ``scaled_dot_product_attention`` forward + backward (a
    yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    B, T, H, Hkv, hd = (shape[k] for k in ("B", "T", "H", "Hkv", "hd"))
    g = torch.Generator(device="cuda").manual_seed(400)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_(True) for shape in (
        (B, T, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd)))
    gout = torch.randn((B, T, H, hd), generator=g, device="cuda").to(
        torch.bfloat16)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))

    def fwd_bwd(fn, leaves, cot):
        return lambda i: torch.autograd.grad(fn(*leaves), leaves, cot)

    before = (fa.launches, fa.bwd_launches)
    t_kern = timed(fwd_bwd(ops.flash_attention_trainable, (q, k, v), gout),
                   inner=10)
    t_plain = timed(fwd_bwd(ref.flash_attention_ref, (q, k, v), gout),
                    inner=10)
    t_sdpa = timed(fwd_bwd(lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=True, enable_gqa=True), (qt, kt, vt),
        gout.transpose(1, 2)), inner=10)
    fa.launches, fa.bwd_launches = before   # timing launches are not counted
    _, fwd_flops = flash_work(B, T, T, H, Hkv, hd, 2)
    flops = fwd_flops * 14 // 4             # + dS, dP, dQ, dK, dV products
    nbytes = 2 * (2 * B * T * H * hd + 2 * B * T * Hkv * hd) * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    bound = max(t_bytes, t_ops)
    print(f"flash_attention_trainable forward + backward B={B} T=S={T} "
          f"(H={H}, Hkv={Hkv}, hd={hd}, causal, bf16): forward + backward "
          f"kernels {t_kern:.4f} ms, bound {bound:.5f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP), plain "
          f"{t_plain:.4f} ms, library (SDPA forward + backward, not used by "
          f"the port) {t_sdpa:.4f} ms [{smi}]")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention.py",
            "replaces": "src/repro/kernels/flash_attention.py:164",
            "launches": launches, "max_abs_err": max_err, "ms": t_kern,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": t_sdpa}


def phase_timing_flash_bwd(launches: int, max_err: float, smi: str,
                           shape=TRAIN_ATTN, name="flash_attention_bwd"):
    """The flash backward kernel alone at a training shape, on the
    forward kernel's residuals, beside its bound (five products per
    visible (query, key) pair, or q, k, v, out, dout and lse read and dq,
    dk, dv written once), the plain backward
    (``ref.flash_attention_bwd_ref``) and SDPA's backward alone (its
    forward run once, outside the timing; a yardstick the port never
    calls)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, T, H, Hkv, hd = (shape[k] for k in ("B", "T", "H", "Hkv", "hd"))
    g = torch.Generator(device="cuda").manual_seed(500)
    q, k, v, dout = (torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16) for shape in ((B, T, H, hd), (B, T, Hkv, hd),
                                      (B, T, Hkv, hd), (B, T, H, hd)))
    before = (fa.launches, fa.bwd_launches)
    out, lse = fa.flash_attention_fwd(q, k, v)
    t_kern = timed(lambda i: fa.flash_attention_bwd(q, k, v, out, lse, dout),
                   inner=20)
    t_plain = timed(lambda i: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, dout), inner=5)
    qt, kt, vt = (x.transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
    t_sdpa = timed(lambda i: torch.autograd.grad(
        o, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True), inner=20)
    fa.launches, fa.bwd_launches = before   # timing launches are not counted
    _, fwd_flops = flash_work(B, T, T, H, Hkv, hd, 2)
    flops = fwd_flops * 5 // 2              # S, dP, dV, dK, dQ products
    nbytes = (4 * B * T * H * hd + 4 * B * T * Hkv * hd) * 2 + B * H * T * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    bound = max(t_bytes, t_ops)
    slots = 2 if hd >= 128 else 3
    print(f"flash_attention_bwd B={B} T=S={T} (H={H}, Hkv={Hkv}, hd={hd}, "
          f"causal, bf16): kernel (TMA + wgmma, two passes: dQ, one "
          f"warpgroup a block, then dK/dV, {2 if H > Hkv else 1} a "
          f"block, with the "
          f"{H // Hkv} query heads of a kv head summed in registers; 64 x "
          f"64 tiles, each warpgroup its own TMA ring of {slots} slots) "
          f"{t_kern:.4f} ms "
          f"({flops / t_kern / 1e9:.1f} TFLOP/s), bound {bound:.5f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP), plain "
          f"{t_plain:.4f} ms, library (SDPA backward, not used by the port) "
          f"{t_sdpa:.4f} ms [{smi}]")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:182",
            "launches": launches, "max_abs_err": max_err, "ms": t_kern,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": t_sdpa}


# ---------------------------------------------------------------------------
# Phase 7: training at full width
# ---------------------------------------------------------------------------
TRAIN = dict(steps=20, resume_steps=5, ckpt_every=10)


# The port's profiler ranges (``torch.profiler.record_function``): the
# flash backward, the optimizer, the fill of paged rows that see no key,
# the expert mixture, and the two recurrences.
RANGES = ("flash_attention_trainable.backward", "adamw.update",
          "attention.fill_unseen", "moe.block", "mamba.ssd", "rwkv.wkv")


def range_ms(prof) -> dict:
    """Device ms of the kernels that ran inside each of ``RANGES``'s
    spans on the device timeline (the range's device-side annotation),
    summed over calls.  ``key_averages`` reports a range's span itself,
    idle gaps between its kernels included (merged with its host-side
    subtree under one key), and a host-side subtree misses kernels
    launched outside an aten op (the flash backward's, through ctypes on
    the autograd thread), so neither is used."""
    import bisect
    import itertools

    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in dev
                     if e.name not in RANGES)
    starts = [k0 for k0, _ in kernels]
    # Prefix sums of the kernels' durations in start order: a range's
    # kernels (those starting inside it) are one slice, found by bisection
    # (a decode block has hundreds of ranges and ten thousands of kernels).
    total = [0, *itertools.accumulate(k1 - k0 for k0, k1 in kernels)]
    out = {}
    for e in dev:
        if e.name in RANGES:
            a = bisect.bisect_left(starts, e.time_range.start)
            b = bisect.bisect_left(starts, e.time_range.end)
            out[e.name] = out.get(e.name, 0.0) + (total[b] - total[a]) / 1e3
    return out


def kernel_rows(prof, averages=None):
    """The profiler's device-side rows (kernels, copies, memsets): each
    device op once.  The host-side rows carry the same device time again
    under the op that launched it, so summing every row counts it twice;
    user ranges are left out too.  ``averages``: ``prof.key_averages()``
    where the caller has it (each call walks every event again)."""
    from torch.autograd import DeviceType
    return [e for e in (averages or prof.key_averages())
            if e.device_type == DeviceType.CUDA and e.key not in RANGES]


def phase_train(smi: str):
    """Full-width ``smollm-135m`` through the training launcher, then a
    resume from its checkpoint.  Returns the 20-step run's flash forward
    and backward launches."""
    import shutil

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as launcher
    from repro_torch.train import checkpoint as ckpt_lib
    ckpt_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    B, T = TRAIN_ATTN["B"], TRAIN_ATTN["T"]
    args = ["--arch", "smollm-135m", "--batch", str(B), "--seq", str(T),
            "--remat", "nothing", "--ckpt-every", str(TRAIN["ckpt_every"]),
            "--ckpt-dir", str(ckpt_dir), "--lr", "1e-3",
            "--warmup-steps", "2", "--log-every", "1"]
    print(f"training: smollm-135m (30 layers, d=576, 9/3 heads, vocab "
          f"49152, bf16, random weights from seed 0), batch {B} x {T}, "
          f"remat nothing, {TRAIN['steps']} steps, async checkpoint every "
          f"{TRAIN['ckpt_every']}")
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.bwd_launches = fa.simt_launches = 0
    t0 = time.monotonic()
    tr = launcher.main(args + ["--steps", str(TRAIN["steps"])])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, bwd_launches = fa.launches, fa.bwd_launches
    L = tr.model.cfg.num_layers
    hist = tr.history
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN["steps"] and all(map(math.isfinite, losses)),
          f"training losses: {losses}")
    check(launches == 2 * L * TRAIN["steps"],
          f"flash launches {launches} != 2 x {L} x {TRAIN['steps']} steps")
    check(bwd_launches == L * TRAIN["steps"],
          f"flash backward launches {bwd_launches} != {L} x "
          f"{TRAIN['steps']} steps")
    check(fa.simt_launches == 0, f"{fa.simt_launches} flash launches took "
          "the CUDA-core instance, not the tensor-core one")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    saved = tr.ckpt.saved_steps
    check(ckpt_lib.latest_step(ckpt_dir) == TRAIN["steps"]
          and TRAIN["steps"] in saved, f"checkpoints saved: {saved}")
    dts = sorted(h["dt_s"] for h in hist[1:])
    step_s = statistics.median(dts)
    print(f"training: {TRAIN['steps']} steps in {wall:.1f} s; step (median "
          f"of steps 2-{TRAIN['steps']}) {1e3 * step_s:.1f} ms "
          f"({1e3 * dts[0]:.1f}-{1e3 * dts[-1]:.1f}), {B * T / step_s:.0f} "
          f"tokens/s; step 1 {1e3 * hist[0]['dt_s']:.0f} ms; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; checkpoints saved at steps "
          f"{sorted(set(saved))}; "
          f"flash launches {launches} (= 2 x {L} layers x {TRAIN['steps']} "
          f"steps), flash backward launches {bwd_launches} (= {L} x "
          f"{TRAIN['steps']}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    del tr
    fa.launches = fa.bwd_launches = fa.simt_launches = 0
    tr2 = launcher.main(args + ["--steps", str(TRAIN["resume_steps"]),
                                "--resume"])
    torch.cuda.synchronize()
    total = TRAIN["steps"] + TRAIN["resume_steps"]
    losses2 = [h["loss"] for h in tr2.history]
    check(tr2.step == total and all(map(math.isfinite, losses2))
          and ckpt_lib.latest_step(ckpt_dir) == total,
          f"resume: step {tr2.step}, losses {losses2}")
    check(fa.launches == 2 * L * TRAIN["resume_steps"]
          and fa.bwd_launches == L * TRAIN["resume_steps"]
          and fa.simt_launches == 0,
          f"resume: flash launches {fa.launches}, backward "
          f"{fa.bwd_launches}, CUDA-core {fa.simt_launches}")
    print(f"resume from step {TRAIN['steps']}: {TRAIN['resume_steps']} more "
          f"steps to {tr2.step}, loss {losses2[0]:.4f} -> {losses2[-1]:.4f}, "
          f"flash launches {fa.launches}, backward {fa.bwd_launches}")
    phase_train_split(tr2.model, tr2.opt, tr2.params, tr2.opt_state, smi)
    del tr2
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches, bwd_launches


def phase_train_split(model, opt, params, opt_state, smi: str,
                      batch=None, label: str = "batch 4 x 1024",
                      flash=(60, 30), reps: int = 3):
    """Where one training step's device time goes: the flash forward
    kernel, the flash backward kernels (and everything under the
    backward's profiler range), cuBLAS matrix products, the optimizer,
    the recurrences' ranges (``mamba.ssd``, ``rwkv.wkv``), and the
    device's idle share of the step's wall time.  ``batch`` defaults to
    a ``synth_batch`` of 4 x 1024 tokens; ``flash`` is the (forward,
    backward) launches a step makes.  The wall is the mean of ``reps``
    steps after a warm-up one (none for ``reps=1``: the caller has just
    trained)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.train.train_step import make_train_step
    step = make_train_step(model, opt)
    if batch is None:
        B, T = TRAIN_ATTN["B"], TRAIN_ATTN["T"]
        batch = synth_batch(0, 0, 999, B, T, model.cfg.vocab_size)
    batch = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}

    def run():
        out = step(params, opt_state, batch)
        torch.cuda.synchronize()
        return out

    if reps > 1:
        run()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    wall = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rows = kernel_rows(prof)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    if busy == 0:
        print(f"training step split: wall {wall:.1f} ms; device time not "
              f"measured (the profiler saw no device activity) [{smi}]")
        return
    ranges = range_ms(prof)

    def part(*needles):
        return sum(e.self_device_time_total for e in rows
                   if any(n in e.key for n in needles)) / 1e3

    check(not any("flash_" in e.key and "_simt" in e.key for e in rows),
          "training step split: a CUDA-core flash kernel ran")
    fwd = part("flash_fwd_split", "flash_fwd_wgmma")
    bwd = part("flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")
    mm = part("gemm", "nvjet", "xmma", "cutlass")
    rec = "".join(f"; {r} range {ranges[r]:.1f} ms" for r in
                  ("mamba.ssd", "rwkv.wkv") if ranges.get(r))
    top = sorted(rows, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    print(f"training step split ({model.cfg.name}, {label}, remat "
          f"{model.remat_policy}): wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms (idle share {1 - busy / wall:.3f}); flash forward "
          f"kernel {fwd:.1f} ms ({flash[0]} launches); flash backward "
          f"kernels {bwd:.1f} ms ({flash[1]} launches of the dQ and dK/dV "
          f"passes; the backward's range "
          f"{ranges.get('flash_attention_trainable.backward', 0):.1f} ms); "
          f"cuBLAS matrix products {mm:.1f} ms; optimizer "
          f"{ranges.get('adamw.update', 0):.1f} ms{rec}; top device ops: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms"
                      for e in top) + f" [{smi}]")


def smoke_train_batch(cfg, seq_no: int, B: int, T: int):
    """A ``synth_batch``; for the cross families with the source the loss
    reads (the pipeline's ``"extras"`` renamed: ``Model.loss`` reads
    ``image_embeds``/``frame_embeds`` only, in both packages)."""
    from repro_torch.data.pipeline import synth_batch
    src = _source_shape(cfg)
    b = synth_batch(0, 0, seq_no, B, T, cfg.vocab_size, src)
    return with_source(cfg, b)


def _source_shape(cfg):
    if cfg.encoder is not None:
        return (cfg.encoder.num_frames, cfg.d_model)
    if cfg.num_image_tokens:
        return (cfg.num_image_tokens, cfg.d_model)
    return None


def with_source(cfg, batch: dict) -> dict:
    """A pipeline batch with its ``"extras"`` under the key ``Model.loss``
    reads for the family."""
    if "extras" not in batch:
        return batch
    key = "frame_embeds" if cfg.encoder is not None else "image_embeds"
    return {"tokens": batch["tokens"], key: batch["extras"]}


FAMILY_TRAIN_PARITY_ARCHS = ("zamba2-2.7b", "rwkv6-1.6b", "whisper-tiny")


def phase_train_parity(archs=("smollm-135m",)):
    """CPU/CUDA parity of training: each SMOKE config at float32, the same
    weights and batches on both devices (64 tokens: a multiple of the
    recurrences' chunks, so their chunked form runs; whisper with frames
    under ``frame_embeds``), 3 steps' losses within 1e-4 relative."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamW, OptConfig
    from repro_torch.train.train_step import make_train_step
    for arch in archs:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        params = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(9))
        opt = AdamW(OptConfig(lr=1e-3, warmup_steps=2, total_steps=10))
        losses = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, device=dev)
            step = make_train_step(model, opt)
            p = _to_device(params, dev)
            state = opt.init(p)
            losses[dev] = []
            for s in range(3):
                batch = {k: torch.as_tensor(v).to(dev) for k, v in
                         smoke_train_batch(cfg, s, 2, 64).items()}
                p, state, metrics = step(p, state, batch)
                losses[dev].append(float(metrics["loss"]))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        check(rel <= 1e-4, f"{arch} train parity: cpu {losses['cpu']} cuda "
                           f"{losses['cuda']}")
        print(f"cpu/cuda training parity ({arch} SMOKE, float32, 3 steps"
              f"{', frames' if cfg.encoder is not None else ''}): losses "
              f"{[round(x, 6) for x in losses['cuda']]}, max relative diff "
              f"{rel:.3g} (tol 1e-4)")


# ---------------------------------------------------------------------------
# Phases 7b-7d: training the recurrent families and whisper-tiny
# ---------------------------------------------------------------------------
TRAIN_FAMILY = dict(steps=10, batch=4, seq=1024)
# Peak learning rate after 2 warm-up steps.  smollm's 1e-3 left
# zamba2-2.7b's loss oscillating (273.9 at step 1, 369.8 at step 10, grad
# norms 800-5300 on an H100 80GB HBM3 at 700 W; PERF.md): its tied
# N(0, 1) embedding gives
# logits of std sqrt(2560) = 51 at init, and a 1e-3 Adam step moves its
# 54 mamba layers' weights (std ~0.02) by 5% a step.
TRAIN_LR = {"zamba2-2.7b": 1e-4, "rwkv6-1.6b": 1e-3}
WHISPER_TRAIN = dict(steps=10, batch=4, seq=448)


def check_trained(label: str, hist, steps: int):
    """Every step's loss and grad norm finite, the loss falling; ->
    (losses, median step seconds of steps 2..)."""
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    check(len(hist) == steps and all(map(math.isfinite, losses + norms)),
          f"{label}: losses {losses}, grad norms {norms}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    return losses, statistics.median(h["dt_s"] for h in hist[1:])


def grad_norm_bf16_f32(arch: str, B: int, T: int):
    """The first step's gradient norm of the launcher's seed-0 weights on
    one fixed batch, in bf16 and with the same weights in float32 (the
    f32 flash takes its CUDA-core instances: a comparison, not the main
    path; its launches are not counted)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.train import tree
    cfg = get_config(arch)
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             synth_batch(0, 0, 0, B, T, cfg.vocab_size).items()}
    out = {}
    for dt in ("bfloat16", "float32"):
        model = build_model(dataclasses.replace(cfg, dtype=dt))
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        loss, _, grads = loss_and_grads(model, params, batch)
        sq = sum(g.float().pow(2).sum() for g in tree.flatten(grads)[0])
        out[dt] = (float(loss), math.sqrt(float(sq)))
        del model, params, grads
        _fresh_memory()
    return out


def phase_train_recurrent(arch: str, smi: str):
    """7b (``zamba2-2.7b``) and 7c (``rwkv6-1.6b``) at full width through
    ``repro_torch.launch.train``: batch 4 x 1024 tokens (a multiple of the
    SSD chunk 64 and of rwkv's 16, so the recurrence takes its chunked
    form), remat "nothing", lr ``TRAIN_LR`` after 2 warm-up steps, 10 steps,
    ``--ckpt-every 0`` (no checkpoint: the smollm run covers them).  Every
    step's loss and grad norm finite, the loss falling; zamba's shared
    attention launches the flash forward 2 x 9 times a step (the forward
    and the remat recompute of its 9 calls) and the flash backward 9
    times, rwkv no attention kernel; no CUDA-core launch.  Then where a
    step's time goes, and the first step's gradient norm in bf16 against
    float32 on one batch.  Returns the run's {kernel: launches}."""
    import torch
    from repro_torch.launch import train as launcher
    from repro_torch.train import tree
    _fresh_memory()
    steps, B, T = (TRAIN_FAMILY[k] for k in ("steps", "batch", "seq"))
    args = ["--arch", arch, "--batch", str(B), "--seq", str(T), "--remat",
            "nothing", "--lr", str(TRAIN_LR[arch]), "--warmup-steps", "2",
            "--steps", str(steps), "--ckpt-every", "0", "--log-every", "1"]
    zero_counts([0, 0])
    t0 = time.monotonic()
    tr = launcher.main(args)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    c = _counts()
    model = tr.model
    n_params = sum(t.numel() for t in tree.flatten(tr.params)[0])
    check(n_params == BUILT_PARAMS[arch],
          f"{arch} params {n_params} != {BUILT_PARAMS[arch]}")
    zamba = model._structure() == "zamba_hybrid"
    n_attn = model._zamba_plan()[0] if zamba else 0
    label = f"{arch} training"
    check(c["causal"] == 2 * n_attn * steps and c["bwd"] == n_attn * steps
          and c["noncausal"] == c["paged"] == c["simt"] == 0,
          f"{label}: launches {c}, want flash forward 2 x {n_attn} x "
          f"{steps}, backward {n_attn} x {steps}, nothing else")
    losses, step_s = check_trained(label, tr.history, steps)
    peak = torch.cuda.max_memory_allocated() / 1e9
    g0 = tr.history[0]["grad_norm"]
    print(f"{label}: {n_params} params, batch {B} x {T}, remat nothing, "
          f"{steps} steps in {wall:.1f} s (model drawn and built "
          f"included); step (median of steps 2-{steps}) "
          f"{1e3 * step_s:.1f} ms, {B * T / step_s:.0f} tokens/s; step 1 "
          f"{1e3 * tr.history[0]['dt_s']:.0f} ms; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; grad norm {g0:.4g} -> "
          f"{tr.history[-1]['grad_norm']:.4g}; flash forward launches "
          f"{c['causal']} (= 2 x {n_attn} x {steps}), backward {c['bwd']} "
          f"(= {n_attn} x {steps}), CUDA-core 0; peak device memory "
          f"{peak:.2f} GB [{smi}]")
    phase_train_split(model, tr.opt, tr.params, tr.opt_state, smi,
                      label=f"batch {B} x {T}", flash=(2 * n_attn, n_attn),
                      reps=1)
    del tr, model
    _fresh_memory()
    gn = grad_norm_bf16_f32(arch, B, T)
    (l16, n16), (l32, n32) = gn["bfloat16"], gn["float32"]
    check(all(map(math.isfinite, (l16, n16, l32, n32))),
          f"{arch}: first-step loss / grad norm {gn}")
    print(f"  {arch} first step on one batch (seed-0 weights): bf16 loss "
          f"{l16:.4f}, grad norm {n16:.4g}; float32 loss {l32:.4f}, grad "
          f"norm {n32:.4g} (bf16 / f32 {n16 / n32:.4f}) [{smi}]")
    return c


def phase_train_whisper(smi: str):
    """7d: ``whisper-tiny`` at full width (4 encoder and 4 decoder
    layers, d=384, 6 heads of 64, vocab 51865, bf16, seed-0 weights)
    through ``Trainer``: batches of 4 x 448 tokens (its text context)
    from ``DataPipeline(extras_shape=(1500, 384))``, whose ``"extras"``
    this phase moves to ``"frame_embeds"`` so the encoder and the cross
    layers train on a source (the pipeline and ``Model.loss`` keep the
    reference's keys), remat "nothing", lr 1e-3 after 2 warm-up steps,
    10 steps, no checkpoint.  The loss finite and falling, no CUDA-core
    launch; each attention call (every encoder layer, every decoder
    layer's self and cross blocks) launches the flash forward twice a
    step (forward and remat recompute) and the backward once, the encoder
    and cross calls on the non-causal route; then one step's time split.
    Returns the run's {kernel: launches}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamW, OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    _fresh_memory()
    steps, B, T = (WHISPER_TRAIN[k] for k in ("steps", "batch", "seq"))
    cfg = get_config("whisper-tiny")
    model = build_model(cfg, remat_policy="nothing")
    opt = AdamW(OptConfig(lr=1e-3, warmup_steps=2, total_steps=steps))
    tr = Trainer(model, opt, TrainerConfig(ckpt_every=0, log_every=1))
    src = _source_shape(cfg)
    pipe = DataPipeline(batch=B, seq_len=T, vocab=cfg.vocab_size,
                        nproducers=2, seed=0, extras_shape=src)
    n_enc, n_dec = cfg.encoder.num_layers, cfg.num_layers
    calls, noncausal = n_enc + 2 * n_dec, n_enc + n_dec
    zero_counts([0, 0])
    t0 = time.monotonic()
    try:
        tr.fit((with_source(cfg, b) for b in pipe), steps=steps)
    finally:
        pipe.close()
        tr.close()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    c = _counts()
    label = "whisper-tiny training"
    check(c["causal"] + c["noncausal"] == 2 * calls * steps
          and c["noncausal"] == 2 * noncausal * steps
          and c["bwd"] == calls * steps and c["paged"] == c["simt"] == 0,
          f"{label}: launches {c}, want flash forward 2 x {calls} x "
          f"{steps} ({2 * noncausal} x {steps} non-causal), backward "
          f"{calls} x {steps}")
    losses, step_s = check_trained(label, tr.history, steps)
    print(f"{label}: batch {B} x {T} tokens with frames {src} (pipeline "
          f"extras as frame_embeds), remat nothing, {steps} steps in "
          f"{wall:.1f} s; step (median of steps 2-{steps}) "
          f"{1e3 * step_s:.1f} ms, {B * T / step_s:.0f} tokens/s; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; flash forward launches "
          f"{c['causal'] + c['noncausal']} (= 2 x ({n_enc} encoder + "
          f"{n_dec} self + {n_dec} cross) x {steps}; non-causal "
          f"{c['noncausal']} = 2 x {noncausal} x {steps}), backward "
          f"{c['bwd']} (= {calls} x {steps}), CUDA-core 0; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{smi}]")
    phase_train_split(model, tr.opt, tr.params, tr.opt_state, smi,
                      batch=smoke_train_batch(cfg, 999, B, T),
                      label=f"batch {B} x {T} with frames {src}",
                      flash=(2 * calls, calls), reps=1)
    del tr, model
    _fresh_memory()
    return c


# 9d's cells on the 16x16 mesh: a dense train step, and a recurrent
# family's cached prefill, whose 32768-step scan is planned by trip count.
DRYRUN_CELLS = (("smollm-135m", "train_4k"), ("rwkv6-1.6b", "prefill_32k"))


def _dryrun_out(arch, shape):
    return ROOT / "results" / "dryrun_torch" / f"{arch}__{shape}__16x16.json"


def start_dryrun():
    """9d's dry-runs, each in a process of its own (each plans a 256-rank
    step on a fake process group, on the host's CPU), at the lowest CPU
    priority so that they run beside the phases on the card and take the
    host's cores only when they idle.  Returns ((arch, shape), process)
    pairs."""
    import atexit
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        _dryrun_out(arch, shape).unlink(missing_ok=True)
        procs.append(((arch, shape), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape], cwd=str(ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            preexec_fn=lambda: os.nice(19))))
    # A failed phase ends the run early: the dry-runs must not outlive it.
    atexit.register(lambda: [p.kill() for _, p in procs
                             if p.poll() is None])
    return procs


def _step_times(trainer, batches):
    """Wall ms of one more step (host clock) and the device ms of its
    kernels (the profiler's device rows), on a throwaway copy of the
    trainer's state: the trainer itself is left as it was."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    saved = (trainer.params, trainer.opt_state, trainer.step,
             list(trainer.history))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        trainer.fit(iter(batches), steps=1)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    dev = sum(e.self_device_time_total for e in kernel_rows(prof)) / 1e3
    trainer.params, trainer.opt_state, trainer.step, trainer.history = saved
    return 1e3 * wall, dev


def phase_parallel(smi: str):
    """9a-9c: the parallelism slice on the card (see the module
    docstring)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.optimizer import AdamW, OptConfig
    from repro_torch.train.train_step import (abstract_params,
                                              batch_shardings,
                                              opt_state_shardings,
                                              param_shardings)
    from repro_torch.train.trainer import Trainer, TrainerConfig
    mesh = make_host_mesh()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"host mesh: {dist.get_backend()} world {dist.get_world_size()}")

    # 9a: sharded training at full width against the same steps unsharded.
    cfg = get_config("smollm-135m")
    model = build_model(cfg, remat_policy="nothing")
    opt = AdamW(OptConfig(lr=1e-3, warmup_steps=2, total_steps=7))
    tc = TrainerConfig(ckpt_every=0, log_every=1)
    B, T = 4, 1024
    rng = np.random.default_rng(9)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (B, T))
                .astype(np.int32)} for _ in range(8)]
    runs = {}
    for label in ("unsharded", "sharded"):
        shardings = None
        if label == "sharded":
            with sh.axis_rules(mesh, cfg.mesh_rules):
                shardings = (param_shardings(model, mesh),
                             opt_state_shardings(model, opt, mesh,
                                                 abstract_params(model)),
                             batch_shardings(mesh, batches[0]))
        tr = Trainer(model, opt, tc, seed=0,
                     mesh=mesh if shardings else None, shardings=shardings)
        fa.launches = fa.bwd_launches = fa.simt_launches = 0
        tr.fit(iter(batches[:5]), steps=5)
        torch.cuda.synchronize()
        launches = (fa.launches, fa.bwd_launches, fa.simt_launches)
        wall_ms, dev_ms = _step_times(tr, batches[7:8])
        if label == "sharded":
            tr.remesh(None, None)
        tr.fit(iter(batches[5:7]), steps=2)
        runs[label] = ([h["loss"] for h in tr.history], launches,
                       [1e3 * h["dt_s"] for h in tr.history[1:5]],
                       wall_ms, dev_ms)
        del tr
    (l0, n0, dt0, w0, d0), (l1, n1, dt1, w1, d1) = (runs["unsharded"],
                                                    runs["sharded"])
    rel = max(abs(a - b) / abs(a) for a, b in zip(l0, l1))
    check(all(map(math.isfinite, l1)) and len(l1) == 7,
          f"sharded losses: {l1}")
    check(max(abs(a - b) / abs(a) for a, b in zip(l0[:5], l1[:5])) <= 1e-3,
          f"sharded vs unsharded losses: {l1[:5]} vs {l0[:5]}")
    check(max(abs(a - b) / abs(a) for a, b in zip(l0[5:], l1[5:])) <= 1e-3,
          f"after remesh(None, None): {l1[5:]} vs {l0[5:]}")
    check(n0 == n1 and n1[2] == 0 and n1[0] == 2 * cfg.num_layers * 5,
          f"flash launches (fwd, bwd, CUDA-core): unsharded {n0}, "
          f"sharded {n1}")
    print(f"parallel 9a: smollm-135m (30 layers, d=576) batch {B} x {T}, "
          f"5 steps on make_host_mesh() (NCCL world 1) vs no mesh: losses "
          f"{[round(x, 4) for x in l1[:5]]}, largest relative difference "
          f"{rel:.3g} (bitwise: {l0 == l1}); after remesh(None, None) 2 "
          f"steps {[round(x, 4) for x in l1[5:]]} vs {[round(x, 4) for x in l0[5:]]}; "
          f"flash launches (fwd, bwd, CUDA-core) {n1} both runs; step wall "
          f"ms (steps 2-5) sharded {[round(x, 1) for x in dt1]} vs "
          f"unsharded {[round(x, 1) for x in dt0]}; one profiled step: "
          f"wall {w1:.1f} vs {w0:.1f} ms, device {d1:.1f} vs {d0:.1f} ms "
          f"[{smi}]")

    # 9b: expert parallelism at full width.
    phase_parallel_olmoe(mesh)

    # 9c: the paper's rings on the device.
    phase_parallel_rings(mesh)
    dist.destroy_process_group()


def read_dryrun(dryruns):
    """9d: each dry-run's plan, read once its process ends (they run
    beside phases 7b-10)."""
    deadline = time.monotonic() + 900
    for (arch, shape), proc in dryruns:
        name = f"dry-run {arch} x {shape}"
        try:
            log = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            check(False, f"{name}: no result within 900 s")
        out = _dryrun_out(arch, shape)
        check(proc.returncode == 0 and out.exists(),
              f"{name} failed: {log[-3000:]}")
        r = json.loads(out.read_text())
        mem = r["memory"]
        check(mem["argument_bytes"] == mem["argument_bytes_from_specs"],
              f"{name}: argument bytes {mem['argument_bytes']} != "
              f"{mem['argument_bytes_from_specs']} from the specs")
        check(r["flops_per_device"] > 0 and r["n_devices"] == 256,
              f"{name}: {r['flops_per_device']} flops, "
              f"{r['n_devices']} ranks")
        check(0 < r["bytes_min_per_device"]
              <= r["bytes_accessed_per_device"],
              f"{name}: bytes_min {r['bytes_min_per_device']}, bytes "
              f"{r['bytes_accessed_per_device']}")
        print(f"parallel 9d: {name} x 16x16 (plan estimate on a fake "
              f"256-rank process group, not a card measurement): "
              f"{r['flops_per_device']:.4g} FLOPs/device, bytes "
              f"{r['bytes_accessed_per_device']:.4g} (min "
              f"{r['bytes_min_per_device']:.4g}), argument bytes "
              f"{mem['argument_bytes']} (= from specs), peak estimate "
              f"{mem['peak_estimate_bytes'] / 1e9:.2f} GB (fits "
              f"{r['device_memory_bytes'] / 1e9:.1f} GB: {r['fits']}), "
              f"collective bytes/device {r['collective_bytes_per_device']}"
              f", counts {r['collective_counts']}, planned in "
              f"{r['run_s']} s")


def phase_parallel_olmoe(mesh):
    """9b: one cache-less forward of full-width olmoe-1b-7b, local route
    against the expert-parallel one under the host mesh's rules."""
    import numpy as np
    import torch
    from repro_torch.launch import hlo_analysis
    from repro_torch.models.layers import unembed_matrix
    from repro_torch.parallel import sharding as sh
    model, params, _ = full_width_model("olmoe-1b-7b")
    cfg = model.cfg
    tok = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab_size, (2, 256)).astype(np.int32)).cuda()
    w = unembed_matrix(params["embed"], cfg)
    with torch.no_grad():
        h0, _, aux0 = model.forward(params, tok)
        with sh.axis_rules(mesh, cfg.mesh_rules):
            with hlo_analysis.Accountant() as acc:
                h1, _, aux1 = model.forward(params, tok)
        torch.cuda.synchronize()
        d_logit = float((h1.float() @ w.float() - h0.float() @ w.float())
                        .abs().max())
    d_aux = abs(float(aux1) - float(aux0))
    L = cfg.num_layers
    counts = acc.account.collective_counts
    check(counts["all-gather"] == 3 * L and counts["all-reduce"] == 2 * L,
          f"olmoe EP route collectives {counts}: want 3 x {L} data "
          f"all-gathers (the experts' weights) and 2 x {L} all-reduces "
          f"(the output over model, aux over data)")
    check(d_logit == 0.0 and d_aux == 0.0,
          f"olmoe EP vs local: logits differ by {d_logit}, aux by {d_aux}")
    print(f"parallel 9b: olmoe-1b-7b (16 layers, 64 experts top-8, "
          f"d=2048) B=2 x 256 cache-less forward, expert-parallel route "
          f"(e_local {cfg.moe.num_experts}, base 0; per layer 3 data "
          f"all-gathers and 2 all-reduces of one rank each: {counts}) vs "
          f"local: largest logit difference {d_logit}, aux {float(aux1):.6f}"
          f" vs {float(aux0):.6f}")
    del model, params


def _ring_script(torch, device):
    """The scripted NBB/NBW sequence on ``device``: a capacity-3 ring
    filled to full (one BUFFER_FULL), drained (one BUFFER_EMPTY), and an
    NBW cell of depth 2 written and read 3 times.  -> every item, status
    and counter, as tensors on ``device``."""
    from repro_torch.core import nbb, nbw
    out = []
    s = nbb.init(3, torch.zeros(4, device=device))
    for i in range(4):
        s, st = nbb.insert_item(s, torch.full((4,), i + 1.0, device=device))
        out += [st, s.update_count, nbb.size(s)]
    for _ in range(4):
        s, item, st = nbb.read_item(s)
        out += [item, st, s.acknowledge_count]
    c = nbw.init(2, torch.zeros(4, device=device))
    for i in range(3):
        c = nbw.write(c, torch.full((4,), 10.0 + i, device=device))
        value, version = nbw.read(c)
        out += [value, version]
    return out


def phase_parallel_rings(mesh):
    """9c: pipeline_apply at one stage (all three schedules) against
    pipeline_reference, and the functional NBB/NBW on the card with no
    host sync, against the CPU."""
    import torch
    from repro_torch.core import nbb
    from repro_torch.parallel.pipeline import (pipeline_apply,
                                               pipeline_reference)
    g = torch.Generator(device="cuda").manual_seed(29)
    params = {"w": torch.randn(1, 64, 64, generator=g, device="cuda") * .3,
              "b": torch.randn(1, 64, generator=g, device="cuda") * .1}
    mbs = torch.randn(6, 8, 64, generator=g, device="cuda")

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    want = pipeline_reference(stage_fn, params, mbs, 1)
    errs = {}
    for schedule in ("barrier", "nbb", "nbb2"):
        got = pipeline_apply(stage_fn, params, mbs, mesh, axis="model",
                             schedule=schedule).full_tensor()[-1]
        errs[schedule] = float((got - want).abs().max())
        check(errs[schedule] <= 1e-5, f"pipeline {schedule}: err "
                                      f"{errs[schedule]}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dev = _ring_script(torch, "cuda")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cpu = _ring_script(torch, "cpu")
    same = all(torch.equal(a.cpu(), b) for a, b in zip(dev, cpu))
    statuses = [int(dev[i]) for i in range(0, 12, 3)] + [
        int(dev[12 + 3 * i + 1]) for i in range(4)]
    check(same, "NBB/NBW on the card differ from the CPU")
    check(statuses == [nbb.OK] * 3 + [nbb.BUFFER_FULL] + [nbb.OK] * 3
          + [nbb.BUFFER_EMPTY], f"NBB statuses {statuses}")
    print(f"parallel 9c: pipeline_apply at one stage vs pipeline_reference "
          f"(f32, 6 microbatches of 8 x 64): max err {errs}; NBB insert/"
          f"read statuses {statuses} and NBW reads equal on CUDA and CPU, "
          f"run under set_sync_debug_mode('error') (no host sync)")


def load_example(name: str):
    """``examples_torch/<name>.py`` as a module, so that its ``main`` runs
    in this process and the kernel counters can be read around it."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, argv):
    """``mod.main(argv)`` with its standard output captured and then
    printed -> (its return value, its printed lines)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    text = buf.getvalue()
    print(text, end="")
    return out, text.splitlines()


def phase_examples(smi: str):
    """10: the four examples of ``examples_torch/`` on the card, each
    run in-process with every kernel counter set to 0 just before it and
    read just after (see the module docstring).  Returns 10b's flash
    forward and backward launches (a training path: they join the
    trainable flash and flash backward rows)."""
    import shutil

    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import states
    forwards = [0, 0]

    # 10a: the quickstart (SMOKE, bf16, head_dim 16).
    quickstart = load_example("quickstart")
    for arch in ("smollm-135m", "olmoe-1b-7b"):
        zero_counts(forwards)
        r, _ = run_example(quickstart, ["--arch", arch])
        c = _counts()
        vocab = get_smoke_config(arch).vocab_size
        check(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]),
              f"quickstart {arch}: loss {r['loss']}, grad norm "
              f"{r['grad_norm']}")
        check(len(r["tokens"]) == 7
              and all(0 <= t < vocab for t in r["tokens"]),
              f"quickstart {arch}: token ids {r['tokens']}")
        check(c["causal"] > 0 and c["bwd"] > 0 and c["simt"] == 0,
              f"quickstart {arch}: flash launches {c['causal']}, backward "
              f"{c['bwd']}, CUDA-core {c['simt']}")
        print(f"examples 10a: quickstart {arch} (SMOKE, bf16, "
              f"{r['params']} params): loss {r['loss']:.4f}, grad norm "
              f"{r['grad_norm']:.2f}, tokens {r['tokens']}; launches: flash "
              f"{c['causal']}, backward {c['bwd']}, paged {c['paged']}, "
              f"CUDA-core {c['simt']}")

    part_time("10a quickstart")
    # 10b: train_e2e --full-135m, then a resume from its checkpoint.
    train_e2e = load_example("train_e2e")
    L = get_config("smollm-135m").num_layers
    ckpt_dir = ROOT / "build" / "chip_smoke_train_e2e"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = ["--full-135m", "--batch", "8", "--seq", "128", "--ckpt-dir",
            str(ckpt_dir)]
    runs = []
    for steps in (60, 10):
        zero_counts(forwards)
        r, lines = run_example(train_e2e, args + ["--steps", str(steps)])
        runs.append((r, lines, _counts(), steps))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    (r1, lines1, c1, s1), (r2, lines2, c2, s2) = runs
    losses = [h["loss"] for h in r1["history"]]
    check(r1["resumed_from"] == 0 and all(map(math.isfinite, losses))
          and losses[-1] < losses[0], f"train_e2e: losses {losses}, "
          f"resumed from {r1['resumed_from']}")
    check(r2["resumed_from"] == s1
          and lines2[0].endswith(f"resume from step {s1}")
          and r2["history"][-1]["step"] == s1 + s2,
          f"train_e2e resume: first line {lines2[0]!r}, history "
          f"{r2['history']}")
    for (r, _, c, steps) in runs:
        check(c["causal"] == 2 * L * steps and c["bwd"] == L * steps
              and c["simt"] == 0,
              f"train_e2e {steps} steps: flash launches {c['causal']} (want "
              f"{2 * L * steps}), backward {c['bwd']} (want {L * steps}), "
              f"CUDA-core {c['simt']}")
    walls = [round(1e3 * h["dt_s"], 1) for h in r1["history"]]
    print(f"examples 10b: train_e2e --full-135m (smollm-135m, 30 layers, "
          f"d=576, {r1['params']} params, bf16) batch 8 x 128, {s1} steps "
          f"in {r1['seconds']:.1f} s ({r1['tok_s']:.0f} tokens/s), logged "
          f"step walls ms {walls}, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; resumed from step {r2['resumed_from']} for "
          f"{s2} steps ({r2['tok_s']:.0f} tokens/s), loss "
          f"{r2['history'][-1]['loss']:.4f}; flash launches {c1['causal']} "
          f"+ {c2['causal']}, backward {c1['bwd']} + {c2['bwd']}, "
          f"CUDA-core 0 [{smi}]")

    part_time("10b train_e2e")
    # 10c: serve_batched (slot_fused, SMOKE).
    serve_batched = load_example("serve_batched")
    zero_counts(forwards)
    r, _ = run_example(serve_batched, [])
    c = _counts()
    eng, cancelled = r["engine"], r["cancelled"]
    check(len(r["streams"]) == 6
          and all(len(resp.tokens_out) == 8
                  and [p for p, _ in got] == list(range(8))
                  for resp, got in r["streams"]),
          f"serve_batched streams: {[(len(g), len(x.tokens_out)) for x, g in r['streams']]}")
    check(bool(cancelled) and cancelled.fsm.state in (
        states.REQUEST_CANCELLED, states.REQUEST_COMPLETED),
          f"serve_batched cancel: {cancelled}")
    check(eng.pool.free_pages() == eng.pool.n_pages,
          f"serve_batched: {eng.pool.free_pages()} of {eng.pool.n_pages} "
          f"pages free")
    check(c["causal"] > 0 and c["simt"] == 0
          and eng.fault_report()["tick_failures"] == 0,
          f"serve_batched: flash {c['causal']}, CUDA-core {c['simt']}, "
          f"faults {eng.fault_report()}")
    print(f"examples 10c: serve_batched (slot_fused, SMOKE): 6 streams "
          f"complete and exactly once; the cancelled request ended "
          f"{cancelled.fsm.state} after {len(cancelled.tokens_out)}/48 "
          f"tokens; pool free {eng.pool.free_pages()}/{eng.pool.n_pages}; "
          f"launches: flash {c['causal']}, paged {c['paged']}, CUDA-core "
          f"{c['simt']}")
    del eng, r

    part_time("10c serve_batched")
    # 10d: the pipeline demo as an NCCL world of one.
    demo = load_example("lockfree_pipeline_demo")
    rows, _ = run_example(demo, ["--ranks", "1"])
    check([row["schedule"] for row in rows] == ["barrier", "nbb", "nbb2"]
          and all(row["match"] for row in rows),
          f"lockfree_pipeline_demo rows: {rows}")
    print(f"examples 10d: lockfree_pipeline_demo --ranks 1 (NCCL world of "
          f"one, S=1 M=16 B=8 D=256): "
          + ", ".join(f"{row['schedule']} {row['bytes']} B {row['ms']} ms"
                      for row in rows) + " [plumbing only]")
    return c1["causal"], c1["bwd"]


# ---------------------------------------------------------------------------
# Phases 2g, 3l-3n and their timing: the registry's last three
# architectures (qwen3-14b, stablelm-3b, arctic-480b)
# ---------------------------------------------------------------------------
# Their slot_paged pools (3l-3n) in 3f's geometry: 512 pages of 16 slots,
# B=8 rows of 64 pages, 64-token chunks; qwen3-14b's 40/8 heads of 128
# (g 5), arctic-480b's 56/8 (g 7) at 2 of its 35 layers, stablelm-3b's
# 32/32 heads of 80 (g 1).  ``L`` is the pool's layers in phase 6's
# timing (arctic's 2 layers padded to 16 views, so a call finds its K/V
# out of L2 as the served model does behind 53.5 GB of expert reads).
QWEN3 = dict(MAIN, L=40, Hkv=8, hd=128, H=40)
ARCTIC = dict(MAIN, L=16, Hkv=8, hd=128, H=56)
STABLELM = dict(MAIN, L=32, Hkv=32, hd=80, H=32)
ARCTIC_LAYERS = 2            # of 35: one card holds 80 GB
LAST_ARCHS = (("qwen3-14b", QWEN3, "g5"),
              ("stablelm-3b", STABLELM, "hd80_pages"),
              ("arctic-480b", ARCTIC, "g7"))
LAST_SERVE = dict(max_batch=8, max_len=1024, pool_pages=512, page_size=16,
                  chunk_tokens=64, k_max=8)
# Rows of phase 2g's paged cases per T: a lens=0 row, rows shorter than
# one run, on a run's edge, long ones; at T=64 rows shorter than T and
# one past the table.
GROUP_LENS = {1: [0, 5, 63, 64, 65, 300, 545, 1024],
              64: [64, 40, 0, 300, 512, 576, 1024, 1100]}
# The flash forward at the same heads: the wave's one-token read (split
# route) over [4, S + 64] rings whose slots past S hold NaN.
GROUP_FLASH_SPLIT = [
    (f"{arch} {tag} read", 4, 1, 513, m["H"], m["Hkv"], m["hd"], {})
    for arch, m, tag in LAST_ARCHS]


def poisoned_pool(torch, seed: int, B: int, T: int, m, lens):
    """bf16 q and a strided layer view of a [n_pages, ps, 2, Hkv, hd]
    pool at ``m``'s heads whose slots past each row's keys are NaN, the
    rows on disjoint scattered pages -> (q, k view, v view, block,
    lens)."""
    ps, P, Hkv, hd = m["ps"], m["P"], m["Hkv"], m["hd"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = B * P + 4
    pool = torch.randn((2, n_pages, ps, 2, Hkv, hd), generator=g,
                       device="cuda").to(torch.bfloat16)
    q = torch.randn((B, T, m["H"], hd), generator=g,
                    device="cuda").to(torch.bfloat16)
    block = torch.randperm(n_pages, generator=g, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    held = torch.zeros((n_pages, ps), dtype=torch.bool, device="cuda")
    for b, n in enumerate(lens):
        keys = torch.arange(min(n, P * ps), device="cuda")
        held[block[b].long()[keys // ps], keys % ps] = True
    layer = pool[:, :, :, 1]                   # a view: writes reach pool
    layer[:, ~held] = float("nan")
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, pool[0, :, :, 1], pool[1, :, :, 1], block, ln


def phase_compare_groups():
    """2g: the paged kernel's split (T=1) and wgmma (T=64) routes at
    qwen3-14b's 40/8 heads of 128 (g 5), arctic-480b's 56/8 (g 7) and
    stablelm-3b's 32/32 heads of 80 over real 16-slot pages (B=8, 64
    pages a row, slots past each row's keys NaN), against the plain
    version and the plain split-KV version at the wrapper's plan: within
    3e-2 in bf16, two calls bit-identical, no NaN read, rows with no key
    (or queries before position 0) exact zeros, one launch a pass, the
    arrival counters back at 0.  Then flash at the same heads: a causal
    B=1 prefill of 300 tokens on the wgmma route (3e-2) and the split
    route's one-token read (``phase_compare_flash_split``), each over
    ring slices with NaN past S.  Returns ({tag: paged max err}, flash
    max err)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    errs, lines = {}, []
    for i, (arch, m, tag) in enumerate(LAST_ARCHS):
        for T, lens in sorted(GROUP_LENS.items()):
            q, k, v, block, ln = poisoned_pool(torch, 800 + 2 * i + T, 8, T,
                                               m, lens)
            way, runs = pa.plan(q, k, v, block)
            check(way == ("split" if T == 1 else "wgmma"),
                  f"2g {arch} T={T}: route {way}")
            before = (pa.launches, pa.split_launches, pa.simt_launches)
            out = pa.paged_attention(q, k, v, block, ln)
            again = pa.paged_attention(q, k, v, block, ln)
            torch.cuda.synchronize()
            check((pa.launches - before[0], pa.split_launches - before[1],
                   pa.simt_launches - before[2])
                  == (2, 2 * (way == "split"), 0), f"2g {arch} T={T}: "
                                                   "launches")
            check(counters_at_zero(), f"2g {arch} T={T}: arrival counters "
                                      "not at 0")
            check(torch.equal(out, again), f"2g {arch} T={T}: two calls "
                                           "differ")
            check(not bool(torch.isnan(out).any()),
                  f"2g {arch} T={T}: a NaN past a row's keys was read")
            clean = [torch.nan_to_num(t) for t in (k, v)]
            want = ref.paged_attention_ref(q, *clean, block, ln).float()
            want2 = ref.paged_attention_split_ref(q, *clean, block, ln,
                                                  runs[0]).float()
            err = max((out.float() - w).abs().max().item()
                      for w in (want, want2))
            check(err <= TOLS["bfloat16"], f"2g {arch} T={T}: err {err}")
            empty = want.abs().amax((2, 3)) == 0               # [B, T]
            check(bool(empty.any())
                  and torch.count_nonzero(out[empty]) == 0,
                  f"2g {arch} T={T}: a query with no key is not 0")
            errs[tag] = max(errs.get(tag, 0.0), err)
            lines.append(f"{arch} ({m['H']}/{m['Hkv']} hd {m['hd']}) T={T} "
                         f"({way}, runs {runs}) {err:.3g}")
            del q, k, v, out, again, want, want2, clean
    print("paged at the last three architectures' heads vs both plain "
          "versions (bf16, tol 3e-2; NaN past each row's keys, two calls "
          "bit-identical): " + "; ".join(lines))
    g = torch.Generator(device="cuda").manual_seed(820)
    flash_err, lines = 0.0, []
    for arch, m, tag in LAST_ARCHS:
        T = S = 300
        q = torch.randn((1, T, m["H"], m["hd"]), generator=g,
                        device="cuda").to(torch.bfloat16)
        rk, rv = (torch.randn((1, S + 64, m["Hkv"], m["hd"]), generator=g,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        rk[:, S:], rv[:, S:] = float("nan"), float("nan")
        k, v = rk[:, :S], rv[:, :S]
        way = fa.forward_route(T, S, m["H"], m["Hkv"], m["hd"], q.dtype,
                               fa.tensor_core_route(q, k, v), 0)[0]
        check(way == "wgmma", f"2g flash {arch}: route {way}")
        before = (fa.launches, fa.split_launches, fa.simt_launches)
        out = fa.flash_attention(q, k, v)
        again = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        check((fa.launches - before[0], fa.split_launches - before[1],
               fa.simt_launches - before[2]) == (2, 0, 0),
              f"2g flash {arch}: launches")
        check(torch.equal(out, again) and not bool(torch.isnan(out).any()),
              f"2g flash {arch}: two calls differ or a NaN was read")
        err = (out.float() - ref.flash_attention_ref(q, k, v).float()
               ).abs().max().item()
        check(err <= TOLS["bfloat16"], f"2g flash {arch} prefill: err {err}")
        flash_err = max(flash_err, err)
        lines.append(f"{arch} ({m['H']}/{m['Hkv']} hd {m['hd']}) B=1 "
                     f"T=S={S} (wgmma) {err:.3g}")
        del q, rk, rv, k, v, out, again
    print("flash at the last three architectures' heads vs plain (bf16, "
          "tol 3e-2, NaN past S, two calls bit-identical): "
          + "; ".join(lines))
    split_err = phase_compare_flash_split(GROUP_FLASH_SPLIT, poison=True)
    return errs, max(flash_err, split_err)


def old_draw_peak(arch: str) -> float:
    """The device bytes the draw of one layer slice of ``arch``'s expert
    ``wi_gate`` took before ``Model.init`` cut large leaves into slices
    (an f32 draw of the whole slice, scaled out of place, then cast to
    bf16): the peak over what was held before, with nothing kept."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    shape = (cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert)
    fan_in = cfg.d_model
    _fresh_memory()
    held = torch.cuda.memory_allocated()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, dtype=torch.float32,
                    device="cuda") * fan_in ** -0.5
    x = x.to(torch.bfloat16)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    del x
    _fresh_memory()
    return peak


def phase_serve_last(arch: str, smi: str, layers: int = 0,
                     old_draw: float = 0.0):
    """3l (``qwen3-14b``: 40 layers, d=5120, 40/8 heads of 128 (g 5),
    qk-norm, rope theta 1e6, d_ff 17408, vocab 151936 untied; no cut),
    3m (``stablelm-3b``: 32 layers, d=2560, 32/32 heads of 80, d_ff 6912,
    vocab 50304 untied; no cut) and 3n (``arctic-480b``: d=7168, 56/8
    heads of 128 (g 7), 128 experts top-2 of d_ff 4864 beside a dense
    residual MLP of 4864, vocab 32000 untied; 2 of its 35 layers), bf16,
    seed-0 weights drawn on the card (arctic's expert leaves an expert at
    a time).  ``slot_paged`` (``max_batch=8``, ``max_len=1024``, 512
    pages of 16, ``chunk_tokens=64``, ``k_max=8``) on the main workload's
    16 requests: the parameter count, every stream complete and
    exactly-once, paged launches = L x forwards, paged split launches = L
    x one-token forwards, no flash, no CUDA-core route, no watchdog
    catch.  qwen3 also serves 2 requests under ``slot_fused`` (flash's
    wgmma prefills at g 5) and ``wave`` (its split-route decode), then
    the serve launcher's ``main`` (its own parser and default scheduler,
    ``slot_chunked``) for 4 requests.  Then where a K=4 decode block's
    and a chunk's time goes, and the peak device memory.  ``old_draw``
    (bytes, arctic): the transient of one expert leaf's layer slice drawn
    whole, as ``Model.init`` drew it before it cut such leaves, printed
    beside what the tree held when that draw came.  Returns the
    ``slot_paged`` run's paged launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import _capacity
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import tree
    m = dict(next(m for a, m, _ in LAST_ARCHS if a == arch))
    _fresh_memory()
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    model, params, forwards = full_width_model(arch, layers)
    torch.cuda.synchronize()
    draw_s = time.monotonic() - t0
    init_peak = torch.cuda.max_memory_allocated()
    cfg = model.cfg
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim_
    g = cfg.num_heads // cfg.num_kv_heads
    check((cfg.num_heads, cfg.num_kv_heads, hd) == (m["H"], m["Hkv"],
                                                     m["hd"]),
          f"{arch}: heads {cfg.num_heads}/{cfg.num_kv_heads} of {hd}")
    n_params = sum(t.numel() for t in tree.flatten(params)[0])
    # ModelConfig.param_count leaves out the 2 L + 1 norm vectors of d
    # and qk-norm's 2 L of head_dim.
    want = (cfg.param_count() + (2 * L + 1) * d
            + (2 * L * hd if cfg.qk_norm else 0))
    check(n_params == want, f"{arch} params {n_params} != {want}")
    cut = (f"{L} of {get_config(arch).num_layers} layers" if layers
           else "no cut")
    moe = ""
    if cfg.moe is not None:
        mo = cfg.moe
        caps = {t: _capacity(t, cfg) for t in (8, 8 * 64)}
        check(caps == {8: 1, 512: 10}, f"{arch}: capacities {caps}")
        moe = (f", {mo.num_experts} experts top-{mo.top_k} of d_ff "
               f"{mo.d_ff_expert} + a dense residual MLP of {cfg.d_ff}, "
               f"capacity C = {caps[8]} at 8 decode tokens and "
               f"{caps[512]} at 512 chunk tokens")
    print(f"{arch} main path ({cut}: d={d}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {hd} (g {g}), d_ff {cfg.d_ff}"
          f"{moe}, vocab {cfg.vocab_size}, bf16): {n_params} params drawn "
          f"in {draw_s:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"on the card, the draw's peak {init_peak / 1e9:.2f} GB; "
          f"{before / 1e9:.2f} GB held before [{smi}]")
    if old_draw:
        # The whole-slice rule drew wo's layers once the tree held all but
        # the dense residual MLP and the final norm (wo's stack allocated).
        held = sum(t.numel() * t.element_size()
                   for t in tree.flatten(params)[0]) - sum(
            t.numel() * t.element_size()
            for t in tree.flatten(params["layers"]["dense"])[0]) - sum(
            t.numel() * t.element_size() for t in (params["final_norm"],))
        print(f"  {arch} Model.init: drawn an expert at a time, peak "
              f"{init_peak / 1e9:.2f} GB; one expert layer slice drawn "
              f"whole (the rule before) took {old_draw / 1e9:.2f} GB more "
              f"on the card, so the draw of wo with {held / 1e9:.2f} GB "
              f"held would have peaked at {(held + old_draw) / 1e9:.2f} GB "
              f"(80 GB card)")
        check(init_peak < 80e9, f"{arch}: the draw peaked at {init_peak}")
    eng = ServeEngine(model, params, n_clients=4, scheduler="slot_paged",
                      **LAST_SERVE)
    kv_mb = 2 * eng.pool.store_k.numel() * eng.pool.store_k.element_size()
    torch.cuda.reset_peak_memory_stats()
    launches, n_fwd, *_ = serve_run(eng, main_workload(cfg.vocab_size), 32,
                                    forwards, smi, f"{arch} slot_paged")
    check(n_fwd > 0 and launches["paged_attention"] == L * n_fwd,
          f"{arch}: paged launches {launches['paged_attention']} != {L} x "
          f"{n_fwd} forwards")
    check(forwards[1] > 0 and launches["paged_split"] == L * forwards[1],
          f"{arch}: split launches {launches['paged_split']} != {L} x "
          f"{forwards[1]} decode forwards")
    check(launches["flash_attention"] == 0, f"{arch} slot_paged launched "
                                            "flash")
    print(f"  {arch} slot_paged: forwards {n_fwd} ({forwards[1]} "
          f"one-token), paged {launches['paged_attention']} = {L} x "
          f"forwards (split route {launches['paged_split']}), pool "
          f"{kv_mb / 1e6:.0f} MB of K/V, prefix_hits "
          f"{eng.stats['prefix_hits']}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del eng
    _fresh_memory()
    part_time(f"{arch} drawn, slot_paged")
    paged = launches["paged_attention"]
    if arch == "qwen3-14b":
        two = gemma_workload(cfg.vocab_size, (400, 200))
        for sched in ("slot_fused", "wave"):
            eng = ServeEngine(model, params, n_clients=len(two),
                              scheduler=sched, **dict(LAST_SERVE,
                                                      max_batch=4))
            launches, n_fwd, *_ = serve_run(eng, two, 32, forwards, smi,
                                            f"{arch} {sched}")
            st = eng.stats
            fl, pl = launches["flash_attention"], launches["paged_attention"]
            fs = launches["flash_split"]
            if sched == "slot_fused":
                ok = (fl == L * st["prefills"] and fs == 0
                      and pl == L * st["decode_steps"]
                      and launches["paged_split"] == L * forwards[1])
            else:
                ok = (pl == 0 and fl == L * n_fwd
                      and fs == L * st["decode_steps"] > 0)
            check(ok and st["prefills"] == len(two)
                  and n_fwd == st["prefills"] + st["decode_steps"],
                  f"{arch} {sched}: launches {launches}, prefills "
                  f"{st['prefills']}, decode steps {st['decode_steps']}")
            print(f"  {arch} {sched}: forwards {n_fwd} ({st['prefills']} "
                  f"prefills on flash's wgmma route, {st['decode_steps']} "
                  f"decode steps), flash {fl} (split route {fs}), paged "
                  f"{pl}")
            del eng
            _fresh_memory()
            part_time(f"{arch} {sched}")
    phase_split(model, params, smi, m=dict(m, L=L), k=4)
    print(f"  {arch} time split: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model, params
    _fresh_memory()
    part_time(f"{arch} time split")
    if arch == "qwen3-14b":
        from repro_torch.launch import serve as launcher
        zero_counts([0, 0])
        eng = launcher.main(["--arch", arch, "--max-len", "1024",
                             "--prompt-len", "200", "--max-tokens", "16",
                             "--clients", "2", "--requests-per-client", "2",
                             "--chunk-tokens", "64"])
        c = _counts()
        fr = eng.fault_report()
        check(eng.scheduler == "slot_chunked" and eng.stats["served"] == 4
              and fr["tick_failures"] == 0 and fr["requests_failed"] == 0
              and c["paged"] > 0 and c["paged"] % L == 0
              and c["psplit"] % L == 0 and c["causal"] == 0
              and c["simt"] == 0,
              f"{arch} launcher: scheduler {eng.scheduler}, stats "
              f"{eng.stats}, launches {c}, faults {fr}")
        print(f"  {arch} launcher (repro_torch.launch.serve main, "
              f"slot_chunked): 4 requests served, paged {c['paged']} "
              f"(split route {c['psplit']}), no flash, no CUDA-core route")
        del eng
        _fresh_memory()
    return paged


def phase_timing_groups(served: dict, errs: dict, smi: str):
    """The paged kernel at 3l-3n's slot_paged shapes (B=8 over strided
    layer views of the pool, lens as the served traffic's): T=1 decode
    (split) and T=64 chunk (wgmma) at qwen3-14b's g 5, arctic-480b's g 7
    and stablelm-3b's hd 80, each beside its bound, its plain version
    and gather + SDPA.  Returns a JSON row per architecture (its T=1
    decode), with its slot_paged run's launches."""
    import torch
    rows = []
    for i, (arch, m, tag) in enumerate(LAST_ARCHS):
        got = {}
        for T in (1, m["chunk"]):
            q, pk, pv, block, lens = main_path_inputs(torch, T, 900 + 2 * i
                                                      + T, m)
            views = [(pk[:, :, li], pv[:, :, li]) for li in range(m["L"])]
            got[T] = paged_timing_row(f"{arch} T={T} B={m['B']}", q, views,
                                      block, lens, smi,
                                      kv_lens=lens.clone())
            del q, pk, pv, views
        t_kern, t_plain, bound, by = got[1]
        rows.append({"name": f"paged_attention_{tag}", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "paged_attention.cu",
                     "replaces": "src/repro/kernels/paged_attention.py:152",
                     "launches": served[arch],
                     "max_abs_err": errs[tag], "ms": t_kern,
                     "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
                     "library_ms": None})
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip smoke: no port sources under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t0 = time.monotonic()
    lap("")
    smi = nvidia_smi_line()
    print(f"nvidia-smi: {smi}")
    phase_build()
    lap("1 build")
    paged_err = phase_compare()
    ring_err = phase_compare_ring()
    flash_err = phase_compare_flash()
    split_flash_err = phase_compare_flash_split()
    phase_compare_dense_decode()
    nbb_err, nbb_launches = phase_compare_nbb()
    trainable_errs = phase_compare_trainable()
    lap("2-2d kernels vs plain")
    noncausal_err = phase_compare_noncausal()
    lap("2e non-causal flash vs plain")
    hd80_flash_err, hd80_paged_err = phase_compare_hd80()
    lap("2f hd 80 vs plain")
    group_errs, _ = phase_compare_groups()
    lap("2g groups 5 and 7, hd 80 pages vs plain")
    model, params, forwards = full_width_model()
    paged_launches = phase_serve(model, params, forwards, smi)
    phase_split(model, params, smi)
    lap("3-3b smollm slot_paged")
    fused = phase_serve_dense(model, params, forwards, smi)
    phase_split_dense(model, params, smi)
    lap("4-4b smollm dense")
    paged_launches += phase_overload(model, params, forwards, smi)
    lap("3c overload")
    paged_launches += phase_faults(model, params, forwards, smi)
    lap("3d faults")
    paged_launches += phase_recovery(model, params, forwards, smi)
    del model, params
    lap("3e recovery")
    paged_launches += phase_serve_olmoe(smi)
    lap("3f olmoe")
    gemma_paged, ring_launches = phase_serve_gemma(smi)
    paged_launches += gemma_paged
    lap("3g gemma")
    noncausal_launches = phase_serve_vlm(smi)
    lap("3h llama-vision")
    noncausal_launches += phase_serve_whisper(smi)
    lap("3i whisper")
    hd80_launches = phase_serve_recurrent("zamba2-2.7b", smi)
    lap("3j zamba")
    phase_serve_recurrent("rwkv6-1.6b", smi)
    lap("3k rwkv")
    last = {}
    for tag, (arch, _, _) in zip("lmn", LAST_ARCHS):
        arctic = arch == "arctic-480b"
        last[arch] = phase_serve_last(
            arch, smi, ARCTIC_LAYERS if arctic else 0,
            old_draw_peak(arch) if arctic else 0.0)
        lap(f"3{tag} {arch}")
    phase_parity()
    phase_train_parity(FAMILY_TRAIN_PARITY_ARCHS)
    lap("5 parity")
    train_launches, train_bwd_launches = phase_train(smi)
    phase_train_parity()
    lap("7 training")
    dryrun = start_dryrun()
    zamba_train = phase_train_recurrent("zamba2-2.7b", smi)
    lap("7b zamba training")
    phase_train_recurrent("rwkv6-1.6b", smi)
    lap("7c rwkv training")
    whisper_train = phase_train_whisper(smi)
    lap("7d whisper training")
    phase_checker()
    lap("8 checker")
    phase_parallel(smi)
    lap("9 parallel")
    e2e_launches, e2e_bwd_launches = phase_examples(smi)
    lap("10 examples")
    read_dryrun(dryrun)
    lap("9d dry-run")
    hd64_out_err, hd64_grad_err = trainable_errs["hd64"]
    hd80_out_err, hd80_grad_err = trainable_errs["hd80"]
    kernels = [phase_timing_paged(paged_launches, paged_err, smi),
               phase_timing_ring(ring_launches, ring_err, smi),
               *phase_timing_flash(fused["flash_attention"], flash_err,
                                   split_flash_err, zamba_train["causal"],
                                   smi),
               *phase_timing_noncausal(noncausal_launches, noncausal_err,
                                       smi),
               phase_timing_trainable(
                   train_launches + whisper_train["causal"]
                   + whisper_train["noncausal"] + e2e_launches,
                   max(hd64_out_err, hd64_grad_err), smi),
               phase_timing_flash_bwd(train_bwd_launches
                                      + whisper_train["bwd"]
                                      + e2e_bwd_launches,
                                      hd64_grad_err, smi),
               phase_timing_nbb(nbb_launches, nbb_err, smi),
               *phase_timing_hd80(hd80_launches, hd80_flash_err,
                                  hd80_paged_err, smi),
               phase_timing_trainable(
                   zamba_train["causal"], max(hd80_out_err, hd80_grad_err),
                   smi, ZAMBA_ATTN, "flash_attention_trainable_hd80"),
               phase_timing_flash_bwd(zamba_train["bwd"], hd80_grad_err,
                                      smi, ZAMBA_ATTN,
                                      "flash_attention_bwd_hd80"),
               *phase_timing_groups(last, group_errs, smi)]
    lap("6 timing")
    print(f"chip smoke: {time.monotonic() - t0:.1f} s")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
