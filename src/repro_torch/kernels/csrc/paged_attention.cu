// Paged attention for Hopper (sm_90a), CUDA C++ with a plain C entry point.
//
// Replaces the TPU kernel of the JAX package: `paged_attention`
// (src/repro/kernels/paged_attention.py:101), whose body `_paged_kernel`
// (:47) runs under the `pl.pallas_call` at :152.  Same contract: q
// [B,T,H,hd] attends over page-scattered K/V [n_pages, ps, Hkv, hd] through
// an int32 block table [B,P] and int32 lengths [B]; query t sits at
// lens[b]-T+t and is causally masked to it; GQA maps head h to kv head
// h / (H/Hkv); optional tanh softcap; scale hd^-0.5; f32 softmax and
// accumulation; output in q's dtype.  An optional int32 kv_lens [B] bounds
// each row's keys by the count actually written (the reference's `total =
// cp + sum(write_mask)`, src/repro/models/layers.py:214-233): keys at or
// past min(lens, P*ps, kv_lens[b]) are never read or summed, so query t
// sees keys < min(lens-T+t+1, kv_lens[b]).  A row that sees no key
// (lens<=0 or kv_lens[b]<=0) returns exact zeros; the caller fills it.
// The pool is read through its strides: the caller hands one layer's
// non-contiguous view pool[:, :, li] and nothing is copied.
//
// The ring bound (optional; ring = window = 0 leaves every route as it
// was).  A sliding-window layer keeps a ring of `ring` slots that wraps:
// the reference's local layers of gemma_local_global
// (src/repro/models/layers.py:234-298, the window mask at :316-327).
// With ring > 0 the row's count is n = kv_lens[b] (the wrapper always
// passes it then), its keys are the logical positions [max(0, n - ring),
// n), and position p lives in slot p % ring of the row's pages.  With
// window > 0, query q also sees no key at or below q - window.  So query
// q sees the contiguous range [max(key_lo, q - window + 1), min(q, n -
// 1)]; an empty range gives zeros, which the caller fills.  Every route
// walks logical keys in order and maps each key to its slot when it
// loads it.
//
// What bounds it on an H100: a one-token decode is memory-bound.  Each
// query row does ~4*hd flops per key against 2*hd*sizeof(T) bytes of
// K/V, far below the ~295 flop/byte the card needs to be compute-bound,
// so the least time is the K/V bytes actually read / 3.35 TB/s; at
// serving shapes those are a few MB, so latency and the number of blocks
// in flight decide.  A chunked prefill (T=64, g=3) reuses each key for
// g*T = 192 rows: still under the line if each kv head's keys are read
// once, but too much arithmetic for the CUDA cores.
//
// Three routes (kernels/paged_attention.py `route` picks one and
// `split_plan` the split-KV plan of the first two: runs of whole 64-key
// tiles from the static shapes of one row (T, P*ps, ring, window), never
// from the batch or lens, so a batch row sums in the same order alone as
// in any batch and the host never reads lens):
//
// * split (bf16, g*T <= 16: decode), head_dim 16/32/64/80/128, 16-byte
//   aligned rows: `paged_split<hd>`, flash's split route over pages.  Grid
//   (split, kv head, b); a block holds all g*T query rows of its kv head
//   as one 16-row mma tile.  Each row cuts its keys [lo, hi) -- key_lo
//   or the first query's window edge, to key_end or the last query -- into
//   runs of split_keys on the device; a block whose run starts at or past
//   hi exits and is not counted.  K/V 64-key tiles are gathered through
//   the block table (each tile's key rows found two tiles ahead) by
//   16-byte cp.async into a double buffer; the four
//   warps take 16 keys of a tile each (S = Q K^T and O += P V on
//   mma.sync.m16n8k16, ldmatrix operands, P from registers) and are
//   merged in warp order.  A row of one run writes its output directly;
//   otherwise each run leaves its partial and the last of the row's runs
//   to arrive merges them in split order (split_merge.cuh), in the same
//   launch.
// * chunk (bf16, g*T > 16: chunked prefill, decode blocks):
//   `paged_chunk<hd, softcap>`.  Grid (split, kv head x row group, b): a
//   block holds all g*T query rows of its kv head (up to 3 tiles of 64
//   rows, 2 at hd 128; more rows take more row groups), one consumer
//   warpgroup a tile, so each page of K/V is read once per kv head, not
//   once per query head.  A producer warpgroup gathers the run's 64-key
//   tiles in logical order into a 3-stage ring: 64 of its threads find
//   the tile's key rows through the block table, then all 128 copy each
//   row's 16-byte chunks by cp.async into the swizzled layout TMA would
//   write (tc::swizzled), counted on the slot's mbarrier
//   (cp.async.mbarrier.arrive).  cp.async rather than TMA page boxes: a
//   box needs 64-aligned tiles on page boundaries, which neither a ring
//   tile across the wrap, a page size under 8, nor runs cut from each
//   row's own key_lo give, and a box cannot zero the slots past a row's
//   key end, so masked keys could meet stale NaNs in P V; one loader
//   serves every case.  S = Q K^T and O += P V on wgmma.m64nNk16 with f32
//   accumulators in registers (flash_tiles.cuh: hd 80 as a 64- and a
//   16-column box), the online softmax as flash's wgmma route; a
//   warpgroup releases, unread, tiles wholly after its rows or below
//   their window.  Runs are at least 8 tiles (kernels/paged_attention.py
//   `split_plan`): a run's partial is g*T rows of f32, as large as its
//   K/V, and is merged as the split route's are.
// * simt (float32, and any other head_dim or alignment): the first
//   design.  One block per (b, kv head) walks that row's pages in order,
//   loading each K/V tile into shared memory once for all g*T query rows
//   of the kv head; scores and the online softmax in f32 on the CUDA
//   cores.  A chunk too long for one block's shared memory is split along
//   T by the wrapper.

#include "flash_common.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"
#include "split_merge.cuh"

#include <type_traits>

namespace {

using flash::bf16;
using flash::from_f32;
using flash::kNegInf;
using flash::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = flash::kMaxSmemBytes;
// simt: keys per shared-memory tile (rounded to whole pages) and query
// rows per score pass: the tile is loaded once, then consumed in row
// chunks.
constexpr int kTileKeys = 64;
constexpr int kRowChunk = 32;
// split and chunk: keys per tile (split_keys is a multiple).
constexpr int kKeys = 64;


struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* block;
  const int* lens;
  const int* kv_lens;  // optional [B] written-key bound (nullptr: none)
  void* out;
  float* part;         // split/chunk, n_split > 1: partials, then (m, l)
  int* count;          // split/chunk, n_split > 1: arrivals, 0 between
  int T, H, Hkv, hd, ps, P;
  long long q_sb, q_st, q_sh;
  long long k_sp, k_st, k_sh;
  long long v_sp, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  long long blk_sb;
  float softcap, scale;
  int tile_pages, row_chunk;   // simt
  int n_split, split_keys;     // split, chunk
  int n_groups, wg;            // chunk: row groups a kv head, warpgroups
  int ring, window;            // the ring bound (0: none)
};

int tile_pages_for(int ps) { return ps >= kTileKeys ? 1 : kTileKeys / ps; }

// Keys row b may read at all: logical positions [key_lo, key_end), which
// are [0, min(lens, P*ps, kv_lens)) without a ring and [max(0, n - ring),
// n) with one.  Every route bounds its key walk and its mask by them; the
// causal and window bounds are per query.
__device__ __forceinline__ int key_end(const Params& p, int b) {
  if (p.ring > 0) return max(0, p.kv_lens[b]);
  int k = min(p.lens[b], p.P * p.ps);
  if (p.kv_lens != nullptr) k = min(k, p.kv_lens[b]);
  return max(0, k);
}
__device__ __forceinline__ int key_lo(const Params& p, int b) {
  return p.ring > 0 ? max(0, key_end(p, b) - p.ring) : 0;
}
// Lowest key the query at position qp sees, of a row whose keys start at
// klo.
__device__ __forceinline__ int query_lo(const Params& p, int klo, int qp) {
  return p.window > 0 ? max(klo, qp - p.window + 1) : klo;
}
// The slot of the row's pages that holds logical key `key`.
__device__ __forceinline__ int slot_of(const Params& p, int key) {
  return p.ring > 0 ? key % p.ring : key;
}

// The keys a split-KV pass walks for row b, [lo, hi): those any of its
// queries sees (from key_lo or the first query's window edge, to key_end
// or past the last query), and the runs of split_keys they fill.  Rows
// cut their runs from their own lo: a function of the row alone.
struct Walk {
  int lo, hi, used;
};
__device__ __forceinline__ Walk walk_of(const Params& p, int b) {
  const int len = p.lens[b];
  const int lo = query_lo(p, key_lo(p, b), len - p.T);
  const int hi = min(key_end(p, b), len);
  const int used =
      hi > lo ? min(p.n_split, (hi - lo + p.split_keys - 1) / p.split_keys)
              : 0;
  return {lo, hi, used};
}

// Floats of shared memory one simt block needs for R query rows.
long long smem_floats(int rows, int hd, int ps) {
  const long long kt = (long long)tile_pages_for(ps) * ps;
  const long long rc = rows < kRowChunk ? rows : kRowChunk;
  return (long long)rows * (hd + 1)     // q (pre-scaled)
         + (long long)rows * hd         // output accumulator
         + 3LL * rows                   // running max, running sum, rescale
         + kt * (hd + 1)                // K tile
         + kt * hd                      // V tile
         + rc * (kt + 1);               // scores / probabilities of a chunk
}

// ---------------------------------------------------------------------------
// simt: one block per (b, kv head)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_simt(const Params p) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = p.H / p.Hkv;
  const int R = g * p.T;                // query rows sharing this kv head
  const int hd = p.hd;
  const int ldh = hd + 1;               // +1: conflict-free column reads
  const int KT = p.tile_pages * p.ps;
  const int ldk = KT + 1;
  const int RC = p.row_chunk;

  extern __shared__ float smem[];
  float* q_s = smem;                    // [R][ldh]
  float* acc_s = q_s + R * ldh;         // [R][hd]
  float* m_s = acc_s + R * hd;          // [R]
  float* l_s = m_s + R;                 // [R]
  float* a_s = l_s + R;                 // [R]
  float* k_s = a_s + R;                 // [KT][ldh]
  float* v_s = k_s + KT * ldh;          // [KT][hd]
  float* s_s = v_s + KT * hd;           // [RC][ldk]

  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);
  const int len = p.lens[b];
  const int kend = key_end(p, b);
  const int klo = key_lo(p, b);

  // Row r = t*g + gi is query token t of head kvh*g + gi.
  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int t = r / g, h = kvh * g + r % g;
    q_s[r * ldh + d] = to_f32(q[b * p.q_sb + t * p.q_st + h * p.q_sh + d]) *
                       p.scale;
    acc_s[r * hd + d] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // Never walk past the table, never touch a page at or past kend.
  // Without a ring, tiles are whole pages from key 0; with one, runs of
  // KT logical keys from klo, each key loaded from its own slot.
  const int kcap = p.ring > 0 ? kend : (kend + p.ps - 1) / p.ps * p.ps;
  const int* brow = p.block + b * p.blk_sb;

  for (int kbase = klo; kbase < kcap; kbase += KT) {
    __syncthreads();                    // previous tile fully consumed
    const int keys = min(KT, kcap - kbase);
    // Load this tile's K and V once, for every query row of the kv head.
    // Slots past `keys` are zero-filled: they are masked, and a masked
    // probability of exactly 0 must not meet stale shared memory.
    for (int i = threadIdx.x; i < KT * hd; i += kThreads) {
      const int c = i / hd, d = i % hd;
      float kv = 0.f, vv = 0.f;
      if (c < keys) {
        const int slot = slot_of(p, kbase + c);
        const long long page = brow[slot / p.ps];
        const int off = slot % p.ps;
        kv = to_f32(kp[page * p.k_sp + off * p.k_st + kvh * p.k_sh + d]);
        vv = to_f32(vp[page * p.v_sp + off * p.v_st + kvh * p.v_sh + d]);
      }
      k_s[c * ldh + d] = kv;
      v_s[c * hd + d] = vv;
    }
    __syncthreads();

    for (int r0 = 0; r0 < R; r0 += RC) {
      const int rows = min(RC, R - r0);
      // Scores of this row chunk against the tile.
      for (int i = threadIdx.x; i < rows * KT; i += kThreads) {
        const int rr = i / KT, c = i % KT;
        const int r = r0 + rr;
        const int q_pos = len - p.T + r / g;
        float s = kNegInf;
        if (c < keys && kbase + c < kend && kbase + c <= q_pos &&
            kbase + c >= query_lo(p, klo, q_pos)) {
          const float* qr = q_s + r * ldh;
          const float* kr = k_s + c * ldh;
          float dot = 0.f;
          for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
          if (p.softcap > 0.f) dot = tanhf(dot / p.softcap) * p.softcap;
          s = dot;
        }
        s_s[rr * ldk + c] = s;
      }
      __syncthreads();
      // Online softmax, one thread per row.
      for (int rr = threadIdx.x; rr < rows; rr += kThreads) {
        const int r = r0 + rr;
        const int q_pos = len - p.T + r / g;
        // Keys of this tile the row may see, [vlo, valid): causal AND
        // below kend AND within the window.
        int valid = min(q_pos + 1, kend) - kbase;
        if (valid > keys) valid = keys;
        const int vlo = max(0, query_lo(p, klo, q_pos) - kbase);
        float* sr = s_s + rr * ldk;
        const float m_prev = m_s[r];
        float m_new = m_prev;
        for (int c = vlo; c < valid; ++c) m_new = fmaxf(m_new, sr[c]);
        float sum = 0.f;
        for (int c = 0; c < KT; ++c) {
          const float pr = c >= vlo && c < valid ? expf(sr[c] - m_new) : 0.f;
          sr[c] = pr;
          sum += pr;
        }
        const float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
      __syncthreads();
      // acc = acc * alpha + P @ V.
      for (int i = threadIdx.x; i < rows * hd; i += kThreads) {
        const int rr = i / hd, d = i % hd;
        const int r = r0 + rr;
        const float* pr = s_s + rr * ldk;
        float o = acc_s[r * hd + d] * a_s[r];
        for (int c = 0; c < keys; ++c) o += pr[c] * v_s[c * hd + d];
        acc_s[r * hd + d] = o;
      }
      __syncthreads();
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int t = r / g, h = kvh * g + r % g;
    const float l = l_s[r];
    const float o = l == 0.f ? 0.f : acc_s[r * hd + d] / l;  // masked rows
    out[b * p.o_sb + t * p.o_st + h * p.o_sh + d] = from_f32<T>(o);
  }
}

// ---------------------------------------------------------------------------
// split: bf16 decode, split-KV on mma.sync, merged in the launch
// ---------------------------------------------------------------------------
namespace split {

constexpr int kRows = 16;                  // g*T query rows: one mma tile
constexpr int kWarps = 4;
constexpr int kWarpKeys = kKeys / kWarps;
constexpr int kMaxSplits = 64;

// Q and two K and V tiles (the next loads while one is multiplied), then
// two tiles' K and V row offsets.  The warps' partials and, in the split
// that merges, every split's (max, sum) and weights [n_split][16] reuse
// the tiles' room once they are read.
template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  constexpr int tiles = (kRows + 4 * kKeys) * (HD + 8) * 2;
  constexpr int merge =
      kRows * (HD + 8) * 2 + (3 * kMaxSplits + 2) * kRows * 4;
  return tiles > merge ? tiles : merge;
}
template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  return tile_bytes<HD>() + 4 * kKeys * 8;
}

}  // namespace split

template <int HD>
__global__ void __launch_bounds__(128) paged_split(const Params p) {
  constexpr int kRows = split::kRows, kWarps = split::kWarps;
  constexpr int kWarpKeys = split::kWarpKeys;
  constexpr int LD = HD + 8, KT = HD / 16, NT = HD / 8, CH = HD / 8;
  constexpr int KN = kWarpKeys / 8;
  static_assert(kWarps * kRows * HD * 4 + 2 * kWarps * kRows * 4 <=
                    4 * kKeys * LD * 2,
                "the warps' partials fit the tiles' room");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, gc = lane & 3;
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = p.H / p.Hkv, R = g * p.T;
  const int len = p.lens[b];
  const Walk wk = walk_of(p, b);
  bf16* out = static_cast<bf16*>(p.out);
  // Row r of the tile is query token r / g of head kvh * g + r % g.
  auto out_at = [&](int r, int c) -> bf16* {
    return out + b * p.o_sb + (r / g) * p.o_st + (kvh * g + r % g) * p.o_sh +
           c;
  };
  if (sp >= wk.used) {
    // No run here: counted by no one.  A row with no key at all gets its
    // zeros from its first block.
    if (wk.used == 0 && sp == 0)
      for (int i = threadIdx.x; i < R * HD; i += blockDim.x)
        *out_at(i / HD, i % HD) = __float2bfloat16(0.f);
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [16][LD]
  bf16* k_s = q_s + kRows * LD;                    // [2][64][LD]
  bf16* v_s = k_s + 2 * kKeys * LD;                // [2][64][LD]

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb;
  for (int i = threadIdx.x; i < kRows * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < R;
    const long long at = ok ? (r / g) * p.q_st + (kvh * g + r % g) * p.q_sh
                            : 0;
    flash::cp_async16(q_s + r * LD + 8 * c, qg + at + 8 * c, ok);
  }
  flash::cp_async_commit();

  const bf16* kg = static_cast<const bf16*>(p.k) + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + kvh * p.v_sh;
  const int* brow = p.block + b * p.blk_sb;
  const int kb0 = wk.lo + sp * p.split_keys;
  const int kb1 = min(wk.hi, kb0 + p.split_keys);
  // The positions of this thread's two rows (a row past R: -1).
  const int off = len - p.T;   // query t sits at t + off
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = gr + 8 * h;
    qp[h] = r < R ? r / g + off : -1;
  }
  const int qp_lo = off, qp_hi = off + p.T - 1;
  const float sc_l2 = p.scale * flash::kLog2e;
  uint32_t qf[KT][4];
  float o[NT][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  // Tile ti of the run (keys kb0 + 64 ti ..) goes into buffer ti % 2 in
  // two steps: its key rows are found through the block table (thread r
  // < 64 takes key r; its K and V offsets, -1 at or past kb1, into
  // rowoff[ti % 2]), two tiles ahead, so the table's latency is not
  // paid in front of each tile's copies; then every thread copies
  // 16-byte chunks (threads along a row; rows past kb1 zero-filled).
  const int n_tiles = (kb1 - kb0 + kKeys - 1) / kKeys;
  long long* rowoff = reinterpret_cast<long long*>(
      smem_raw + split::tile_bytes<HD>());           // [2][K, V][64]
  auto find_rows = [&](int ti, int r) {
    const int key = kb0 + ti * kKeys + r;
    long long ko = -1, vo = -1;
    if (key < kb1) {
      const int slot = slot_of(p, key);
      const long long page = brow[slot / p.ps];
      ko = page * p.k_sp + (long long)(slot % p.ps) * p.k_st;
      vo = page * p.v_sp + (long long)(slot % p.ps) * p.v_st;
    }
    rowoff[(ti & 1) * 2 * kKeys + r] = ko;
    rowoff[(ti & 1) * 2 * kKeys + kKeys + r] = vo;
  };
  auto load_tile = [&](int ti) {
    const long long* ro = rowoff + (ti & 1) * 2 * kKeys;
    bf16* kd = k_s + (ti & 1) * kKeys * LD;
    bf16* vd = v_s + (ti & 1) * kKeys * LD;
#pragma unroll 4
    for (int i = threadIdx.x; i < kKeys * CH; i += blockDim.x) {
      const int r = i / CH, c = i % CH;
      const long long ko = ro[r], vo = ro[kKeys + r];
      flash::cp_async16(kd + r * LD + 8 * c, kg + (ko < 0 ? 0 : ko) + 8 * c,
                        ko >= 0);
      flash::cp_async16(vd + r * LD + 8 * c, vg + (vo < 0 ? 0 : vo) + 8 * c,
                        vo >= 0);
    }
    flash::cp_async_commit();
  };
  if (threadIdx.x < 2 * kKeys && threadIdx.x / kKeys < n_tiles)
    find_rows(threadIdx.x / kKeys, threadIdx.x % kKeys);
  __syncthreads();
  load_tile(0);
  for (int ti = 0; ti < n_tiles; ++ti) {
    // Tile ti + 2's rows into the offsets tile ti's copies have read.
    if (ti + 2 < n_tiles && threadIdx.x < kKeys) find_rows(ti + 2, threadIdx.x);
    const int c0 = kb0 + ti * kKeys;
    const bf16* kc = k_s + (ti & 1) * kKeys * LD;
    const bf16* vc = v_s + (ti & 1) * kKeys * LD;
    // The next tile's copies go out before this one's products; the
    // buffer they fill was read in the last iteration, which every warp
    // has left (the barrier at its end).
    if (ti + 1 < n_tiles) {
      load_tile(ti + 1);
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    if (ti == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        flash::load_a(qf[kk], q_s, LD, 0, kk * 16);
    }
    // This warp's keys: [kw, kw + 16), rows w0 .. of the tile.
    const int w0 = warp * kWarpKeys, kw = c0 + w0;
    if (kw < kb1) {
      float s[KN][4];
#pragma unroll
      for (int n = 0; n < KN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int np = 0; np < KN / 2; ++np) {
          uint32_t bfr[4];
          flash::load_b(bfr, kc, LD, w0 + np * 16, kk * 16);
          flash::mma(s[2 * np], qf[kk], bfr[0], bfr[1]);
          flash::mma(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
        }
      }
      // Scores in the log2 domain, masked ones -inf: the softcap and the
      // mask branch once per warp tile.  Every key of the run is at or
      // above the row's key_lo and below its key_end.
      if (p.softcap > 0.f) {
        const float inv_cap = p.scale / p.softcap;
        const float cap_l2 = p.softcap * flash::kLog2e;
#pragma unroll
        for (int n = 0; n < KN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = tc::fast_tanh(s[n][e] * inv_cap) * cap_l2;
      } else {
#pragma unroll
        for (int n = 0; n < KN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= sc_l2;
      }
      const bool full = kw + kWarpKeys <= kb1 &&
                        kw + kWarpKeys - 1 <= qp_lo &&
                        (p.window <= 0 || kw > qp_hi - p.window);
      if (!full) {
#pragma unroll
        for (int n = 0; n < KN; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kw + n * 8 + 2 * gc + (e & 1);
            const int q = qp[e >> 1];
            const bool ok = (kp < kb1) & (kp <= q) &
                            ((p.window <= 0) | (kp > q - p.window));
            s[n][e] = ok ? s[n][e] : -CUDART_INF_F;
          }
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < KN; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = flash::quad_max(mx[r]);
        alpha[r] = flash::fast_exp2(m[r] - mx[r]);
        m[r] = mx[r];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < KN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = flash::fast_exp2(s[n][e] - mx[e >> 1]);
          rs[e >> 1] += s[n][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // O += P V: P from registers, V transposed by ldmatrix.
#pragma unroll
      for (int kk = 0; kk < KN / 2; ++kk) {
        uint32_t a[4];
        flash::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bfr[4];
          flash::load_bt(bfr, vc, LD, w0 + kk * 16, np * 16);
          flash::mma(o[2 * np], a, bfr[0], bfr[1]);
          flash::mma(o[2 * np + 1], a, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this buffer
  }
  flash::cp_async_wait<0>();
  __syncthreads();   // every warp is done with the tiles: reuse their room

  // The four warps' partials, merged in warp order.
  float* po = reinterpret_cast<float*>(k_s);       // [warp][16][HD]
  float* pm = po + kWarps * kRows * HD;            // [warp][16]
  float* pl = pm + kWarps * kRows;                 // [warp][16]
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = flash::quad_sum(l[r]);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      po[(warp * kRows + gr + 8 * (e >> 1)) * HD + n * 8 + 2 * gc + (e & 1)] =
          o[n][e];
  if (gc == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pm[warp * kRows + gr + 8 * r] = m[r];
      pl[warp * kRows + gr + 8 * r] = l[r];
    }
  }
  __syncthreads();

  auto store = [&](int r, int c, float acc, float M, float L) {
    *out_at(r, c) = __float2bfloat16(L > 0.f ? acc / L : 0.f);  // no key: 0
  };
  const long long slot = (long long)(b * p.Hkv + kvh) * p.n_split;
  float* part_o = p.part + (slot + sp) * kRows * HD;
  float* part_ml = p.part + (long long)gridDim.z * p.Hkv * p.n_split *
                               kRows * HD;        // [..][2][16]
  for (int i = threadIdx.x; i < R * HD; i += blockDim.x) {
    const int r = i / HD, c = i % HD;
    float M = pm[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, pm[w * kRows + r]);
    float acc = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = flash::fast_exp2(pm[w * kRows + r] - M);
      acc += po[(w * kRows + r) * HD + c] * a;
      L += pl[w * kRows + r] * a;
    }
    if (wk.used == 1) {
      store(r, c, acc, M, L);
    } else {
      part_o[r * HD + c] = acc;
      if (c == 0) {
        part_ml[(slot + sp) * 2 * kRows + r] = M;
        part_ml[(slot + sp) * 2 * kRows + kRows + r] = L;
      }
    }
  }
  if (wk.used == 1) return;
  // The row's non-empty runs count in; the last merges them in split
  // order (the tiles' room is its scratch).
  int* count = p.count + b * p.Hkv + kvh;
  if (!splitkv::arrive(count, wk.used)) return;
  splitkv::merge<HD>(p.part + slot * kRows * HD, part_ml + slot * 2 * kRows,
                     wk.used, R, kRows, reinterpret_cast<float*>(k_s), count,
                     store);
}

// ---------------------------------------------------------------------------
// chunk: bf16 chunks, every query row of a kv head in one block, on wgmma
// ---------------------------------------------------------------------------
namespace chunk {

constexpr int kStages = 3;       // K/V tiles in the ring
constexpr int kMaxSplits = 8;    // runs a row's keys are cut into, at most
// Consumer warpgroups (64-row tiles) a block holds: three at hd <= 80, two
// at hd 128, so ptxas gives each thread 128 and 168 registers (an m64 x
// 128 accumulator is 64 a thread; four warpgroups at hd 64 spilled).
template <int HD>
constexpr int kMaxWG = HD >= 128 ? 2 : 3;

// Room to align the tiles to 1024 bytes; the Q tiles and the K/V ring,
// or, in the split that merges, the merge's scratch; the ring's full and
// empty barriers; the producer's row offsets of two tiles.
template <int HD>
__host__ __device__ constexpr int region_bytes(int wg) {
  const int tiles = (wg + 2 * kStages) * tc::Tile<HD>::kBytes;
  const int merge = (3 * kMaxSplits + 2) * wg * 64 * 4;
  return tiles > merge ? tiles : merge;
}
template <int HD>
__host__ __device__ constexpr int smem_bytes(int wg) {
  return 1024 + region_bytes<HD>(wg) + 2 * kStages * 8 + 4 * kKeys * 8;
}

}  // namespace chunk

// Warpgroup w of `wg` consumer warpgroups holds rows 64 w .. 64 w + 63 of
// the block's rows (row r of the kv head's g*T is token r / g of head kvh
// * g + r % g); warpgroup wg is the producer.
template <int HD, bool CAP>
__global__ void __launch_bounds__(128 * (chunk::kMaxWG<HD> + 1))
paged_chunk(const Params p) {
  using L = tc::Tile<HD>;
  constexpr int ST = chunk::kStages, NA = HD / 2, CH = HD / 8;
  const int sp = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / p.n_groups, grp = blockIdx.y % p.n_groups;
  const int g = p.H / p.Hkv, R = g * p.T, ld = 64 * p.wg;
  const int row0 = grp * ld;                  // the block's first row
  const int rows = min(ld, R - row0);         // of which exist
  const int len = p.lens[b];
  const int off = len - p.T;                  // query t sits at t + off
  const Walk wk = walk_of(p, b);
  bf16* out = static_cast<bf16*>(p.out);
  auto out_at = [&](int r, int c) -> bf16* {  // block row r, column c
    const int ri = row0 + r;
    return out + b * p.o_sb + (ri / g) * p.o_st + (kvh * g + ri % g) * p.o_sh +
           c;
  };
  if (sp >= wk.used) {
    // No run here: counted by no one; a row with no key at all gets its
    // zeros from its first block.
    if (wk.used == 0 && sp == 0)
      for (int i = threadIdx.x; i < rows * HD; i += blockDim.x)
        *out_at(i / HD, i % HD) = __float2bfloat16(0.f);
    return;
  }
  const int kb0 = wk.lo + sp * p.split_keys;
  const int kb1 = min(wk.hi, kb0 + p.split_keys);
  const int n_kt = (kb1 - kb0 + kKeys - 1) / kKeys;
  const int active = (rows + 63) / 64;        // warpgroups with rows

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = tc::aligned_smem(smem_raw);
  unsigned char* q_s = base;                          // [wg] tiles
  unsigned char* ring = base + p.wg * L::kBytes;      // [ST][K, V]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + chunk::region_bytes<HD>(p.wg));
  uint64_t* empty = full + ST;
  // The producer's K and V row offsets of a tile, two tiles deep.
  long long* rowoff = reinterpret_cast<long long*>(empty + ST);  // [2][2][64]

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 128);          // the producer's copies
      hopper::mbar_init(&empty[s], 4 * active);  // every consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wgi = warp / 4;
  float o[NA], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NA; ++i) o[i] = 0.f;
  const int gr = lane / 4, gc = lane % 4;
  const int qr0 = 16 * (warp % 4) + gr;       // the thread's rows in its tile

  if (wgi == p.wg) {
    // The producer warpgroup: tile j of the run into slot j % ST once
    // every consumer warp has released it.  Thread r < 64 finds key row r
    // through the block table (its K and V offsets, two tiles deep); then
    // each thread copies 16-byte chunks (threads along a row, so a row's
    // bytes are read together).  Keys at or past kb1 are zero-filled,
    // unread.
    const int pt = threadIdx.x - 128 * p.wg;
    const bf16* kg = static_cast<const bf16*>(p.k) + kvh * p.k_sh;
    const bf16* vg = static_cast<const bf16*>(p.v) + kvh * p.v_sh;
    const int* brow = p.block + b * p.blk_sb;
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % ST, key = kb0 + kKeys * j + pt;
      long long* off2 = rowoff + (j & 1) * 2 * kKeys;
      if (pt < kKeys) {
        long long ko = -1, vo = -1;
        if (key < kb1) {
          const int slot = slot_of(p, key);
          const long long page = brow[slot / p.ps];
          ko = page * p.k_sp + (long long)(slot % p.ps) * p.k_st;
          vo = page * p.v_sp + (long long)(slot % p.ps) * p.v_st;
        }
        off2[pt] = ko;
        off2[kKeys + pt] = vo;
      }
      if (j >= ST) hopper::mbar_wait(&empty[s], (j / ST - 1) & 1);
      // The offsets are written (and, two tiles back, read by all).
      tc::warpgroup_sync(p.wg);
      unsigned char* kd = ring + s * 2 * L::kBytes;
      unsigned char* vd = kd + L::kBytes;
#pragma unroll 2
      for (int i = pt; i < kKeys * CH; i += 128) {
        const int r = i / CH, c = i % CH;
        const long long kr = off2[r], vr = off2[kKeys + r];
        const int at = tc::swizzled<HD>(r, c);
        flash::cp_async16(kd + at, kg + (kr < 0 ? 0 : kr) + 8 * c, kr >= 0);
        flash::cp_async16(vd + at, vg + (vr < 0 ? 0 : vr) + 8 * c, vr >= 0);
      }
      hopper::cp_async_mbar_arrive(&full[s]);
    }
  } else if (wgi < active) {
    // A consumer warpgroup: its Q tile (rows past R zero-filled), swizzled
    // as the descriptors read it, then every tile of the run.
    const int wrow = row0 + 64 * wgi;           // its first row
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb;
    unsigned char* qt = q_s + wgi * L::kBytes;
    for (int i = threadIdx.x % 128; i < 64 * CH; i += 128) {
      const int r = i / CH, c = i % CH, ri = wrow + r;
      const bool ok = ri < R;
      const long long at =
          ok ? (ri / g) * p.q_st + (kvh * g + ri % g) * p.q_sh : 0;
      flash::cp_async16(qt + tc::swizzled<HD>(r, c), qg + at + 8 * c, ok);
    }
    flash::cp_async_commit();
    flash::cp_async_wait<0>();
    hopper::fence_proxy_async();
    tc::warpgroup_sync(wgi);

    // Query positions: the warpgroup's first and last, and the thread's
    // two rows' (a row past R sees nothing).
    const int wq_lo = off + wrow / g;
    const int wq_hi = off + (min(R, wrow + 64) - 1) / g;
    int qp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ri = wrow + qr0 + 8 * h;
      qp[h] = ri < R ? off + ri / g : -(1 << 30);
    }
    const float sl2 = p.scale * flash::kLog2e;
    const float inv_cap = CAP ? p.scale / p.softcap : 0.f;
    const float cap2 = p.softcap * flash::kLog2e;
    const uint32_t q_addr = hopper::smem_addr(qt);
    float sa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sa[i] = 0.f;

    for (int j = 0; j < n_kt; ++j) {
      const int s = j % ST, kb = kb0 + kKeys * j;
      hopper::mbar_wait(&full[s], (j / ST) & 1);
      // Tiles wholly after every row of the warpgroup (causal) or wholly
      // below its window are released unread.
      if (kb <= wq_hi &&
          (p.window <= 0 || kb + kKeys - 1 > wq_lo - p.window)) {
        hopper::fence_proxy_async();   // the gathered tile, to wgmma
        const uint32_t k_addr = hopper::smem_addr(ring + s * 2 * L::kBytes);
        const uint32_t v_addr = k_addr + L::kBytes;
        // S = Q K^T: 64 rows x 64 keys.
        hopper::fence_acc(sa);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          hopper::Wgmma<64>::ss<0>(sa, tc::desc_k<HD>(q_addr, kk),
                                   tc::desc_k<HD>(k_addr, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(sa);
        // Scores in log2 units (capped: c tanh(S / c)), -inf where masked;
        // only edge tiles test each element, by selects.
        const bool full_tile = kb + kKeys <= kb1 && kb + kKeys - 1 <= wq_lo &&
                               (p.window <= 0 || kb > wq_hi - p.window);
        auto scores = [&](auto masked) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            float x;
            if constexpr (CAP)
              x = tc::fast_tanh(sa[i] * inv_cap) * cap2;
            else
              x = sa[i] * sl2;
            if constexpr (decltype(masked)::value) {
              const int kp = kb + 8 * (i >> 2) + 2 * gc + (i & 1);
              const int q = qp[(i >> 1) & 1];
              const bool ok = (kp < kb1) & (kp <= q) &
                              ((p.window <= 0) | (kp > q - p.window));
              x = ok ? x : -CUDART_INF_F;
            }
            sa[i] = x;
          }
        };
        if (full_tile)
          scores(std::false_type{});
        else
          scores(std::true_type{});
        // Online softmax of the thread's two rows (register i holds row
        // qr0 + 8 ((i >> 1) & 1)); P packed pair by pair into the A
        // fragments of O += P V.
        float mx[2] = {m[0], m[1]}, alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sa[i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = flash::quad_max(mx[r]);
          alpha[r] = flash::fast_exp2(m[r] - mx[r]);
          m[r] = mx[r];
        }
        uint32_t pf[4][4];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = (i >> 1) & 1;
          const float p0 = flash::fast_exp2(sa[i] - m[r]);
          const float p1 = flash::fast_exp2(sa[i + 1] - m[r]);
          rs[r] += p0 + p1;
          pf[i / 8][(i % 8) / 2] = flash::pack_bf16(p0, p1);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
        for (int i = 0; i < NA; ++i) o[i] *= alpha[(i >> 1) & 1];
        // O += P V: P from registers, V MN-major (trans-b).
        hopper::fence_acc(o);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) tc::mma_mn<HD>(o, pf[kk], v_addr, kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(o);
      }
      if (lane == 0) hopper::mbar_arrive(&empty[s]);   // the slot is free
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = flash::quad_sum(l[r]);
  }

  // The run's rows: written directly where the row has one run, else left
  // as a partial for the merge.
  const bool consumer = wgi < active;
  if (wk.used == 1) {
    if (!consumer) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int br = 64 * wgi + qr0 + 8 * r;    // block row
      if (br >= rows) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;   // no key: zeros
      bf16* row = out_at(br, 0);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * gc) = flash::pack_bf16(
            o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
    return;
  }
  const long long group = (long long)(b * p.Hkv + kvh) * p.n_groups + grp;
  const long long slot = group * p.n_split;
  float* part_ml = p.part + (long long)gridDim.z * p.Hkv * p.n_groups *
                               p.n_split * ld * HD;   // [..][2][ld]
  if (consumer) {
    float* po = p.part + (slot + sp) * ld * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int br = 64 * wgi + qr0 + 8 * r;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(po + br * HD + 8 * j + 2 * gc) =
            make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      if (gc == 0) {
        part_ml[(slot + sp) * 2 * ld + br] = m[r];
        part_ml[(slot + sp) * 2 * ld + ld + br] = l[r];
      }
    }
  }
  int* count = p.count + group;
  if (!splitkv::arrive(count, wk.used)) return;
  auto store = [&](int r, int c, float acc, float M, float Lsum) {
    *out_at(r, c) = __float2bfloat16(Lsum > 0.f ? acc / Lsum : 0.f);
  };
  splitkv::merge<HD>(p.part + slot * ld * HD, part_ml + slot * 2 * ld,
                     wk.used, rows, ld, reinterpret_cast<float*>(base), count,
                     store);
}

template <typename T>
cudaError_t launch_simt(const Params& p, int B, cudaStream_t stream) {
  const int rows = (p.H / p.Hkv) * p.T;
  const long long smem =
      smem_floats(rows, p.hd, p.ps) * (long long)sizeof(float);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  static bool attr = false;
  const cudaError_t e = flash::allow_max_smem(paged_simt<T>, attr);
  if (e != cudaSuccess) return e;
  dim3 grid(B, p.Hkv);
  paged_simt<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
// Keys a row's split-KV walk may hold, from the static shapes: the table's
// positions, or the ring's, and with a window at most window + T - 1.  The
// plan's runs must cover them.
long long walk_keys(const Params& p) {
  long long keys = p.ring > 0 ? p.ring : (long long)p.P * p.ps;
  if (p.window > 0 && p.window + p.T - 1 < keys) keys = p.window + p.T - 1;
  return keys;
}

bool plan_covers(const Params& p, int max_splits) {
  return p.n_split >= 1 && p.n_split <= max_splits && p.split_keys > 0 &&
         p.split_keys % kKeys == 0 &&
         (long long)p.n_split * p.split_keys >= walk_keys(p) &&
         (p.n_split == 1 || (p.part != nullptr && p.count != nullptr));
}

// Row groups of a kv head and warpgroups a block of the chunk route.
template <int HD>
void chunk_shape(Params& p) {
  const int tiles = ((p.H / p.Hkv) * p.T + 63) / 64;
  p.wg = min(chunk::kMaxWG<HD>, tiles);
  p.n_groups = (tiles + p.wg - 1) / p.wg;
}

template <int HD>
cudaError_t launch_split(const Params& p, int B, cudaStream_t stream) {
  if ((p.H / p.Hkv) * p.T > split::kRows || !plan_covers(p, split::kMaxSplits))
    return cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        split::smem_bytes<HD>());
    if (e != cudaSuccess) return e;
    attr = true;
  }
  paged_split<HD><<<dim3(p.n_split, p.Hkv, B), split::kWarps * 32,
                    split::smem_bytes<HD>(), stream>>>(p);
  return cudaGetLastError();
}

template <int HD, bool CAP>
cudaError_t launch_chunk(Params p, int B, cudaStream_t stream) {
  if (!plan_covers(p, chunk::kMaxSplits)) return cudaErrorInvalidValue;
  chunk_shape<HD>(p);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_chunk<HD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        chunk::smem_bytes<HD>(chunk::kMaxWG<HD>));
    if (e != cudaSuccess) return e;
    attr = true;
  }
  paged_chunk<HD, CAP><<<dim3(p.n_split, p.Hkv * p.n_groups, B),
                         128 * (p.wg + 1), chunk::smem_bytes<HD>(p.wg),
                         stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc(const Params& p, int route, int B, cudaStream_t s) {
  if (route == 1) return launch_split<HD>(p, B, s);
  return p.softcap > 0.f ? launch_chunk<HD, true>(p, B, s)
                         : launch_chunk<HD, false>(p, B, s);
}

#define PAGED_SMEM_ROWS(HD)                                                \
  {"paged_split<" #HD ">", (const void*)paged_split<HD>,                   \
   split::smem_bytes<HD>()},                                               \
  {"paged_chunk<" #HD ", false>", (const void*)paged_chunk<HD, false>,     \
   chunk::smem_bytes<HD>(chunk::kMaxWG<HD>)},                              \
  {"paged_chunk<" #HD ", true>", (const void*)paged_chunk<HD, true>,       \
   chunk::smem_bytes<HD>(chunk::kMaxWG<HD>)}

// The chunk route at its most warpgroups a block (the limit its launches
// set).
const hopper::SmemRow kSmemRows[] = {
    PAGED_SMEM_ROWS(16), PAGED_SMEM_ROWS(32), PAGED_SMEM_ROWS(64),
    PAGED_SMEM_ROWS(80), PAGED_SMEM_ROWS(128),
    {"paged_simt<float>", (const void*)paged_simt<float>, kMaxSmemBytes},
    {"paged_simt<bf16>", (const void*)paged_simt<bf16>, kMaxSmemBytes}};

#undef PAGED_SMEM_ROWS

}  // namespace

extern "C" {

// The split route's fixed sizes: which = 0 (most query rows g*T a block
// holds), 1 (keys per tile: split_keys must be a multiple), 2 (most runs
// of the chunk route).
int paged_attention_split_limit(int which) {
  return which == 0 ? split::kRows : which == 1 ? kKeys : chunk::kMaxSplits;
}

// Instance i's shared memory (hopper::smem_row): 0, -1 past the last.
int paged_attention_smem(int i, const char** name, int* static_bytes,
                         int* dynamic_bytes) {
  return hopper::smem_row(kSmemRows, i, name, static_bytes, dynamic_bytes);
}

// Most query rows (g*T) one simt launch can hold in shared memory for
// this head_dim and page size; the wrapper splits longer chunks along T.
int paged_attention_max_rows(int hd, int ps) {
  int rows = 0;
  while (smem_floats(rows + 1, hd, ps) * (long long)sizeof(float) <=
         kMaxSmemBytes)
    ++rows;
  return rows;
}

// The scratch of a split-KV pass of route 1 (split) or 2 (chunk) with
// n_split runs: returns the floats of partials it needs (0 for one run)
// and sets *counters to the arrival counters it counts on.
long long paged_attention_workspace(int route, int B, int T, int H, int Hkv,
                                    int hd, int n_split, int* counters) {
  *counters = 0;
  if (n_split <= 1 || Hkv <= 0) return 0;
  Params p = {};
  p.H = H; p.Hkv = Hkv; p.T = T;
  long long rows = split::kRows, groups = 1;
  if (route == 2) {
    switch (hd) {
      case 128: chunk_shape<128>(p); break;
      default: chunk_shape<64>(p); break;   // four warpgroups below 128
    }
    rows = 64LL * p.wg;
    groups = p.n_groups;
  }
  *counters = (int)(B * Hkv * groups);
  return (long long)B * Hkv * groups * n_split * rows * (hd + 2);
}

// kv_lens: nullptr, or [B] int32 bounds of each row's written keys.
// ring, window: the ring bound (0, 0: none); ring > 0 needs kv_lens and
// ring <= P * ps.
// dtype: 0 = float32, 1 = bfloat16.  route: 0 = simt, 1 = split, 2 =
// chunk; 1 and 2 need bf16 and hd 16/32/64/80/128 with 16-byte aligned
// rows, and take n_split runs of split_keys keys (a multiple of 64) that
// cover a row's walk, with `part` (paged_attention_workspace floats) and
// `count` (int32 zeros, left at 0) when n_split > 1.  Strides are in
// elements; the head_dim stride of q, k, v and out must be 1.  Returns a
// cudaError_t (0 = ok).
int paged_attention_launch(
    const void* q, const void* k, const void* v, const int* block,
    const int* lens, const int* kv_lens, void* out, float* part, int* count,
    int dtype, int route, int B, int T, int H, int Hkv, int hd, int ps,
    int P, int n_split, int split_keys, int ring, int window, long long q_sb,
    long long q_st, long long q_sh, long long k_sp, long long k_st,
    long long k_sh, long long v_sp, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, long long blk_sb,
    float softcap, float scale, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.block = block; p.lens = lens;
  p.kv_lens = kv_lens; p.out = out; p.part = part; p.count = count;
  p.T = T; p.H = H; p.Hkv = Hkv; p.hd = hd; p.ps = ps; p.P = P;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sp = k_sp; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sp = v_sp; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.blk_sb = blk_sb;
  p.softcap = softcap; p.scale = scale;
  p.tile_pages = tile_pages_for(ps);
  const int rows = Hkv > 0 ? (H / Hkv) * T : 0;
  p.row_chunk = rows < kRowChunk ? rows : kRowChunk;
  p.n_split = n_split; p.split_keys = split_keys;
  p.ring = ring; p.window = window;
  if (B <= 0 || T <= 0 || rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ring < 0 || window < 0 || ring > P * ps ||
      (ring > 0 && kv_lens == nullptr))
    return cudaErrorInvalidValue;
  if (route == 0) {
    if (dtype == 0) return launch_simt<float>(p, B, s);
    if (dtype == 1) return launch_simt<bf16>(p, B, s);
    return cudaErrorInvalidValue;
  }
  if (dtype != 1 || (route != 1 && route != 2)) return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch_tc<16>(p, route, B, s);
    case 32: return launch_tc<32>(p, route, B, s);
    case 64: return launch_tc<64>(p, route, B, s);
    case 80: return launch_tc<80>(p, route, B, s);
    case 128: return launch_tc<128>(p, route, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
