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
// walks logical keys from the row's key_lo and maps each key to its slot
// when it loads it; split-KV plans its splits from key_lo on the device,
// so the plan stays one of static shapes.
//
// What bounds it on an H100: decode (T=1) is memory-bound.  Each query row
// does ~4*hd flops per key against 2*hd*sizeof(T) bytes of K/V, far below
// the ~295 flop/byte the card needs to be compute-bound, so the least time
// is the K/V bytes actually read / 3.35 TB/s; at serving shapes those are
// a few MB, so latency and the number of blocks in flight decide.  A
// chunked prefill (T=64, g=3) reuses each key for g*T = 192 rows, still
// under the line, but too much arithmetic for the CUDA cores.
//
// Three routes (the wrapper picks one; head_dim 16/32/64/128 with 16-byte
// aligned rows for the first two):
//
// * split (g*T <= kSplitRows: decode), float32 and bf16: flash-decoding.
//   Grid (split, kv head, b): each split walks a fixed run of split_keys
//   keys (whole pages, a multiple of 64), so B=8, Hkv=3 gives 384 blocks
//   where one block per (b, kv head) gave 24.  The split count comes from
//   the static shapes (P, ps, B, Hkv), never from lens: reading lens on
//   the host would sync the decode loop.  A block loads its query rows
//   once, then K/V tiles of 64 keys through the block table by 16-byte
//   cp.async into a 2-stage ring (the next tile's copies in flight under
//   this tile's products), and keeps each row's online-softmax state (max,
//   sum in the log2 domain, ex2.approx) and f32 accumulator.  It writes its
//   partial (m, l, acc) to a scratch buffer; a second launch,
//   paged_combine, merges each row's splits in split order (no atomics:
//   bit-identical from call to call).  A split that starts at or past
//   the row's key end (key_end: min(lens, P*ps, kv_lens)) writes nothing
//   and the combine does not read it; a row with no visible key has l = 0
//   everywhere and gets zeros.
// * chunk_tc (bf16, g*T > kSplitRows: chunked prefill): the tensor-core
//   design of flash_attention.cu's flash_fwd_tc.  One block per (64 query
//   tokens, query head, b), heaviest causal tiles first; K/V tiles of 64
//   keys gathered page by page through the block table by a 3-stage
//   cp.async ring; S = Q K^T and O += P V by mma.sync.m16n8k16 with
//   ldmatrix operands (flash_common.cuh); P, the running max and sum and
//   the 16 x hd accumulator stay in registers; the mask and softcap
//   branch once per tile; exponentials by ex2.approx.  The g query heads
//   of a kv head are neighbouring blocks and find its K/V in L2.
// * simt (float32 beyond the split route, and any other head_dim or
//   alignment): the first design.  One block per (b, kv head) walks that
//   row's pages in order, loading each K/V tile into shared memory once
//   for all g*T query rows of the kv head; scores and the online softmax
//   in f32 on the CUDA cores.  A chunk too long for one block's shared
//   memory is split along T by the wrapper.

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::kNegInf;

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = flash::kMaxSmemBytes;
// simt: keys per shared-memory tile (rounded to whole pages) and query
// rows per score pass: the tile is loaded once, then consumed in row
// chunks.
constexpr int kTileKeys = 64;
constexpr int kRowChunk = 32;
// split: most query rows (g*T) a block holds, keys per tile, ring stages.
constexpr int kSplitRows = 16;
constexpr int kSplitKeys = 64;
constexpr int kSplitThreads = 128;
constexpr int kSplitStages = 2;
// chunk_tc: keys per tile and ring stages.
constexpr int kChunkKeys = 64;
constexpr int kChunkStages = 3;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* block;
  const int* lens;
  const int* kv_lens;  // optional [B] written-key bound (nullptr: none)
  void* out;
  float* part;         // split: [3][part_rows] m, l; then [part_rows][hd]
  long long part_rows; // B * Hkv * n_split * g * T
  int T, H, Hkv, hd, ps, P;
  long long q_sb, q_st, q_sh;
  long long k_sp, k_st, k_sh;
  long long v_sp, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  long long blk_sb;
  float softcap, scale;
  int tile_pages, row_chunk;   // simt
  int n_split, split_keys;     // split
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
// split: flash-decoding over fixed runs of keys, then paged_combine
// ---------------------------------------------------------------------------
template <typename T, int HD>
struct SplitSmem {
  static constexpr int LD = HD + 16 / (int)sizeof(T);  // padded row
  static constexpr int tile = kSplitKeys * LD;          // elements
  static constexpr int bytes =
      kSplitStages * 2 * tile * (int)sizeof(T)   // the K/V ring
      + kSplitRows * HD * 4                      // q (f32, pre-scaled)
      + kSplitRows * kSplitKeys * 4              // scores, probabilities
      + 3 * kSplitRows * 4;                      // max, sum, rescale
};

// 16 bytes of K or V from shared memory as floats.
__device__ __forceinline__ void load_chunk(float (&o)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_chunk(float (&o)[8], const bf16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// Two neighbouring V elements as floats.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Two neighbouring partial-accumulator elements.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kSplitThreads) paged_split(const Params p) {
  using SM = SplitSmem<T, HD>;
  constexpr int LD = SM::LD;
  constexpr int EPC = 16 / (int)sizeof(T);     // elements per 16 bytes
  constexpr int CPR = HD / EPC;                // 16-byte chunks per row
  constexpr int NP = HD / 2;                   // column pairs of a row
  constexpr int ITEMS = (kSplitRows * NP + kSplitThreads - 1) / kSplitThreads;
  constexpr int SROWS = kSplitRows / (kSplitThreads / kSplitKeys);
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = p.H / p.Hkv, R = g * p.T;
  const int len = p.lens[b];
  const int kmax = key_end(p, b);               // keys any row may see
  const int klo = key_lo(p, b);
  const int k0 = klo + split * p.split_keys;
  const int k1 = min(k0 + p.split_keys, kmax);
  // A split with no key writes nothing: the combine reads only splits
  // below kmax.
  if (k0 >= k1) return;
  const int n_tiles = (k1 - k0 + kSplitKeys - 1) / kSplitKeys;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);          // [stage][64][LD]
  T* v_s = k_s + kSplitStages * SM::tile;           // [stage][64][LD]
  float* q_s = reinterpret_cast<float*>(v_s + kSplitStages * SM::tile);
  float* s_s = q_s + kSplitRows * HD;               // [R][64]
  float* m_s = s_s + kSplitRows * kSplitKeys;       // [R]
  float* l_s = m_s + kSplitRows;                    // [R]
  float* a_s = l_s + kSplitRows;                    // [R]

  const T* kbase = static_cast<const T*>(p.k) + kvh * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + kvh * p.v_sh;
  const int* brow = p.block + b * p.blk_sb;

  // Keys kb .. kb+63 of the split into ring stage j % 2, each row found
  // through the block table; keys at or past k1 are zero-filled, unread.
  auto load_tile = [&](int j) {
    const int kb = k0 + j * kSplitKeys;
    T* kd = k_s + (j % kSplitStages) * SM::tile;
    T* vd = v_s + (j % kSplitStages) * SM::tile;
    for (int i = threadIdx.x; i < kSplitKeys * CPR; i += kSplitThreads) {
      const int c = i / CPR, ch = i % CPR;
      const int key = kb + c;
      const bool valid = key < k1;
      long long ko = 0, vo = 0;
      if (valid) {
        const int slot = slot_of(p, key);
        const long long page = brow[slot / p.ps];
        const long long off = slot % p.ps;
        ko = page * p.k_sp + off * p.k_st;
        vo = page * p.v_sp + off * p.v_st;
      }
      flash::cp_async16(kd + c * LD + ch * EPC, kbase + ko + ch * EPC, valid);
      flash::cp_async16(vd + c * LD + ch * EPC, vbase + vo + ch * EPC, valid);
    }
  };
  load_tile(0);
  flash::cp_async_commit();

  // Row r = t*g + gi is query token t of head kvh*g + gi.
  const T* q = static_cast<const T*>(p.q);
  for (int i = threadIdx.x; i < R * HD; i += kSplitThreads) {
    const int r = i / HD, d = i % HD;
    const int t = r / g, h = kvh * g + r % g;
    q_s[r * HD + d] =
        to_f32(q[b * p.q_sb + t * p.q_st + h * p.q_sh + d]) * p.scale;
  }
  for (int r = threadIdx.x; r < R; r += kSplitThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // The accumulator: thread item u is (row, column pair) i = tid + 128 u.
  float acc[ITEMS][2];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) acc[u][0] = acc[u][1] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // The stage of tile j + 1 was last read in tile j - 1, which every
    // thread has finished (the barrier closing the previous iteration).
    if (j + 1 < n_tiles) load_tile(j + 1);
    flash::cp_async_commit();
    flash::cp_async_wait<1>();        // tile j has landed
    __syncthreads();
    const T* ks = k_s + (j % kSplitStages) * SM::tile;
    const T* vs = v_s + (j % kSplitStages) * SM::tile;
    const int kb = k0 + j * kSplitKeys;
    {
      // Scores: thread (c, rh) takes key c and rows rh, rh + 2, ...; the
      // rows of a warp are one, so q_s reads broadcast.
      const int c = threadIdx.x % kSplitKeys;
      const int rh = threadIdx.x / kSplitKeys;
      const int rstep = kSplitThreads / kSplitKeys;
      float dot[SROWS];
#pragma unroll
      for (int u = 0; u < SROWS; ++u) dot[u] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += EPC) {
        float kv[EPC];
        load_chunk(kv, ks + c * LD + d0);
#pragma unroll
        for (int u = 0; u < SROWS; ++u) {
          const int r = rh + rstep * u;
          if (r < R) {
            const float* qr = q_s + r * HD + d0;
#pragma unroll
            for (int e = 0; e < EPC; ++e) dot[u] = fmaf(qr[e], kv[e], dot[u]);
          }
        }
      }
      const int key = kb + c;
#pragma unroll
      for (int u = 0; u < SROWS; ++u) {
        const int r = rh + rstep * u;
        if (r < R) {
          float sc = dot[u];
          if (p.softcap > 0.f) sc = tanhf(sc / p.softcap) * p.softcap;
          sc *= flash::kLog2e;
          const int qp = len - p.T + r / g;
          if (key >= k1 || key > qp || key < query_lo(p, klo, qp))
            sc = -CUDART_INF_F;
          s_s[r * kSplitKeys + c] = sc;
        }
      }
    }
    __syncthreads();
    {
      // Online softmax: warp w takes rows w, w + 4, ...; lane l keys l and
      // l + 32.  A masked score gives exactly 0 (2^-inf).
      const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int r = w; r < R; r += kSplitThreads / 32) {
        float* sr = s_s + r * kSplitKeys;
        const float s0 = sr[lane], s1 = sr[lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        const float p0 = flash::fast_exp2(s0 - m_new);
        const float p1 = flash::fast_exp2(s1 - m_new);
        sr[lane] = p0;
        sr[lane + 32] = p1;
        const float sum = flash::warp_sum(p0 + p1);
        if (lane == 0) {
          const float alpha = flash::fast_exp2(m_old - m_new);
          m_s[r] = m_new;
          l_s[r] = l_s[r] * alpha + sum;
          a_s[r] = alpha;
        }
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V.
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int i = threadIdx.x + kSplitThreads * u;
      if (i < R * NP) {
        const int r = i / NP, dp = i % NP;
        const float alpha = a_s[r];
        float o0 = acc[u][0] * alpha, o1 = acc[u][1] * alpha;
        const float* pr = s_s + r * kSplitKeys;
        for (int c = 0; c < kSplitKeys; ++c) {
          const float pc = pr[c];
          const float2 vv = load_pair(vs + c * LD + 2 * dp);
          o0 = fmaf(pc, vv.x, o0);
          o1 = fmaf(pc, vv.y, o1);
        }
        acc[u][0] = o0;
        acc[u][1] = o1;
      }
    }
    __syncthreads();                  // the stage and s_s are free again
  }
  flash::cp_async_wait<0>();

  // The split's partial: row slot ((b * Hkv + kvh) * n_split + split) * R.
  const long long row0 =
      ((long long)(b * p.Hkv + kvh) * p.n_split + split) * R;
  float* pm = p.part;
  float* pl = pm + p.part_rows;
  float* pa = pl + p.part_rows;
  for (int r = threadIdx.x; r < R; r += kSplitThreads) {
    pm[row0 + r] = m_s[r];
    pl[row0 + r] = l_s[r];
  }
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int i = threadIdx.x + kSplitThreads * u;
    if (i < R * NP) {
      const int r = i / NP, dp = i % NP;
      store_pair(pa + (row0 + r) * HD + 2 * dp, acc[u][0], acc[u][1]);
    }
  }
}

// Merge the splits of each (b, kv head) in split order: with M the
// largest split max, out = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s -
// M), or 0 where the sum is 0 (no visible key; an empty split's m is
// -1e30, finite, so no inf - inf arises).
template <typename T, int HD>
__global__ void __launch_bounds__(128) paged_combine(const Params p) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int g = p.H / p.Hkv, R = g * p.T;
  const int kmax = key_end(p, b);
  const int used = (kmax - key_lo(p, b) + p.split_keys - 1) / p.split_keys;
  const long long base = (long long)(b * p.Hkv + kvh) * p.n_split * R;
  const float* pm = p.part;
  const float* pl = pm + p.part_rows;
  const float* pa = pl + p.part_rows;
  T* out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < R * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD;
    float m = kNegInf;
    for (int s = 0; s < used; ++s) m = fmaxf(m, pm[base + s * R + r]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < used; ++s) {
      const long long row = base + s * R + r;
      const float w = flash::fast_exp2(pm[row] - m);
      l = fmaf(pl[row], w, l);
      o = fmaf(pa[row * HD + d], w, o);
    }
    const int t = r / g, h = kvh * g + r % g;
    out[b * p.o_sb + t * p.o_st + h * p.o_sh + d] =
        from_f32<T>(l > 0.f ? o / l : 0.f);
  }
}

// ---------------------------------------------------------------------------
// chunk_tc: bf16 chunks on the tensor cores
// ---------------------------------------------------------------------------
template <int HD>
constexpr int chunk_smem_bytes() {
  return (64 + 2 * kChunkStages * kChunkKeys) * (HD + 8) * 2;  // Q, ring
}

// Keys kb .. kb+63 of kv head base (one 16-byte column per thread, every
// (blockDim / (HD / 8))-th row) into the padded tile dst, each row found
// through the block table (logical key -> slot_of); keys at or past `end`
// are zero-filled, unread.
template <int HD>
__device__ __forceinline__ void load_page_rows(bf16* dst, const bf16* base,
                                               long long sp, long long st,
                                               const int* brow,
                                               const Params& p, int kb,
                                               int end) {
  constexpr int LD = HD + 8, CH = HD / 8;
  const int c = threadIdx.x % CH, dr = blockDim.x / CH;
  for (int r = threadIdx.x / CH; r < kChunkKeys; r += dr) {
    const int key = kb + r;
    const bool valid = key < end;
    const bf16* src = base + c * 8;
    if (valid) {
      const int slot = slot_of(p, key);
      src += (long long)brow[slot / p.ps] * sp + (long long)(slot % p.ps) * st;
    }
    flash::cp_async16(dst + r * LD + c * 8, src, valid);
  }
}

template <int HD>
__global__ void __launch_bounds__(128) paged_chunk_tc(const Params p) {
  constexpr int LD = HD + 8, KT = HD / 16, NT = HD / 8, KN = kChunkKeys / 8;
  constexpr int NS = kChunkStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, gc = lane & 3;
  const int BQ = blockDim.x / 2;  // 16 rows per warp
  const int h = blockIdx.x, b = blockIdx.z;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int kvh = h / (p.H / p.Hkv);
  const int tq = min(BQ, p.T - t0);
  const int len = p.lens[b];
  const int off = len - p.T;                 // query t sits at t + off
  const int kmax = key_end(p, b);
  const int klo = key_lo(p, b);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* k_s = q_s + 64 * LD;                      // [NS][64][LD]
  bf16* v_s = k_s + NS * kChunkKeys * LD;         // [NS][64][LD]

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb +
                   t0 * p.q_st + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + kvh * p.v_sh;
  const int* brow = p.block + b * p.blk_sb;

  // Keys any row of this tile can see: [k_start, k_end) (the lowest
  // query's lower bound is the lowest), in tiles of 64 from k_start.
  const int q_last = t0 + tq - 1 + off;
  const int k_start = query_lo(p, klo, t0 + off);
  const int k_end = max(0, min(kmax, q_last + 1));
  const int n_kt =
      k_end > k_start ? (k_end - k_start + kChunkKeys - 1) / kChunkKeys : 0;

  auto load_kv = [&](int j) {
    const int kb = k_start + j * kChunkKeys, st = j % NS;
    load_page_rows<HD>(k_s + st * kChunkKeys * LD, kg, p.k_sp, p.k_st, brow,
                       p, kb, k_end);
    load_page_rows<HD>(v_s + st * kChunkKeys * LD, vg, p.v_sp, p.v_st, brow,
                       p, kb, k_end);
  };

  // Q and the first NS - 1 tiles, one commit group each (Q with tile 0).
  flash::load_rows<HD>(q_s, qg, p.q_st, BQ, tq, p.q);
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < n_kt) load_kv(j);
    flash::cp_async_commit();
  }

  // This warp's rows: w0 .. w0+15 of the tile; the thread's two rows are
  // w0 + gr and w0 + gr + 8.
  const int w0 = warp * 16;
  const bool active = w0 < tq;
  const int wq_first = t0 + w0 + off, wq_last = wq_first + 15;
  // The warp's rows see no key below lo_first; all of them see every key
  // from lo_last up to their causal and key_end bounds.
  const int lo_first = query_lo(p, klo, wq_first);
  const int lo_last = query_lo(p, klo, wq_last);
  const float sc_l2 = p.scale * flash::kLog2e;
  uint32_t qf[KT][4];
  float o[NT][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    flash::cp_async_wait<NS - 2>();  // tile j (and Q) have landed
    // Every warp is past tile j - 1, so its stage takes tile j + NS - 1,
    // whose copy then runs under the products of tiles j .. j + NS - 2.
    __syncthreads();
    if (j + NS - 1 < n_kt) load_kv(j + NS - 1);
    flash::cp_async_commit();
    const int kb = k_start + j * kChunkKeys;
    // A warp whose rows all precede the tile's first key, or all follow
    // its last one by a window, skips it.  The Q fragments are loaded at
    // tile 0, once.
    if (j == 0 && active) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        flash::load_a(qf[kk], q_s, LD, w0, kk * 16);
    }
    if (active && kb <= wq_last && kb + kChunkKeys > lo_first) {
      const bf16* ks = k_s + (j % NS) * kChunkKeys * LD;
      const bf16* vs = v_s + (j % NS) * kChunkKeys * LD;
      // S = Q K^T: 16 rows x 64 keys as KN n-tiles of 8 keys.
      float s[KN][4];
#pragma unroll
      for (int n = 0; n < KN; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int np = 0; np < KN / 2; ++np) {
          uint32_t bfr[4];
          flash::load_b(bfr, ks, LD, np * 16, kk * 16);
          flash::mma(s[2 * np], qf[kk], bfr[0], bfr[1]);
          flash::mma(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
        }
      }
      // Scores in the log2 domain; masked ones -inf (probability 0).  The
      // softcap and the mask branch once per tile.
      if (p.softcap > 0.f) {
        const float inv_cap = p.scale / p.softcap;
        const float cap_l2 = p.softcap * flash::kLog2e;
#pragma unroll
        for (int n = 0; n < KN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = tanhf(s[n][e] * inv_cap) * cap_l2;
      } else {
#pragma unroll
        for (int n = 0; n < KN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= sc_l2;
      }
      const bool full = kb + kChunkKeys <= kmax &&
                        kb + kChunkKeys - 1 <= wq_first && kb >= lo_last;
      if (!full) {
#pragma unroll
        for (int n = 0; n < KN; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kb + n * 8 + 2 * gc + (e & 1);
            const int qp = wq_first + gr + (e >> 1) * 8;
            if (kp >= kmax || kp > qp || kp < query_lo(p, klo, qp))
              s[n][e] = -CUDART_INF_F;
          }
        }
      }
      // Online softmax for the thread's two rows.
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
          flash::load_bt(bfr, vs, LD, kk * 16, np * 16);
          flash::mma(o[2 * np], a, bfr[0], bfr[1]);
          flash::mma(o[2 * np + 1], a, bfr[2], bfr[3]);
        }
      }
    }
  }
  flash::cp_async_wait<0>();

  if (!active) return;
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + w0 + gr + r * 8;
    const float lsum = flash::quad_sum(l[r]);
    if (t >= p.T) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;  // no key: zeros
    bf16* orow = out + b * p.o_sb + t * p.o_st + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * gc) =
          flash::pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
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

template <typename T, int HD>
cudaError_t launch_split(const Params& p, int B, cudaStream_t stream) {
  if ((p.H / p.Hkv) * p.T > kSplitRows || p.n_split < 1 ||
      p.split_keys % kSplitKeys != 0 ||
      (long long)p.n_split * p.split_keys < (long long)p.P * p.ps)
    return cudaErrorInvalidValue;
  static bool attr = false;
  const cudaError_t e = flash::allow_max_smem(paged_split<T, HD>, attr);
  if (e != cudaSuccess) return e;
  dim3 grid(p.n_split, p.Hkv, B);
  paged_split<T, HD>
      <<<grid, kSplitThreads, SplitSmem<T, HD>::bytes, stream>>>(p);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return e2;
  paged_combine<T, HD><<<dim3(p.Hkv, B), 128, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_chunk(const Params& p, int B, cudaStream_t stream) {
  static bool attr = false;
  const cudaError_t e = flash::allow_max_smem(paged_chunk_tc<HD>, attr);
  if (e != cudaSuccess) return e;
  const int warps = min(4, (p.T + 15) / 16);
  const int bq = 16 * warps;
  dim3 grid(p.H, (p.T + bq - 1) / bq, B);
  paged_chunk_tc<HD><<<grid, 32 * warps, chunk_smem_bytes<HD>(), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_split_hd(const Params& p, int B, cudaStream_t s) {
  switch (p.hd) {
    case 16: return launch_split<T, 16>(p, B, s);
    case 32: return launch_split<T, 32>(p, B, s);
    case 64: return launch_split<T, 64>(p, B, s);
    case 128: return launch_split<T, 128>(p, B, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_chunk_hd(const Params& p, int B, cudaStream_t s) {
  switch (p.hd) {
    case 16: return launch_chunk<16>(p, B, s);
    case 32: return launch_chunk<32>(p, B, s);
    case 64: return launch_chunk<64>(p, B, s);
    case 128: return launch_chunk<128>(p, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The split route's fixed sizes: which = 0 (most query rows g*T a block
// holds), 1 (keys per tile: split_keys must be a multiple).
int paged_attention_split_limit(int which) {
  return which == 0 ? kSplitRows : kSplitKeys;
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

// kv_lens: nullptr, or [B] int32 bounds of each row's written keys.
// ring, window: the ring bound (0, 0: none); ring > 0 needs kv_lens and
// ring <= P * ps.
// dtype: 0 = float32, 1 = bfloat16.  route: 0 = simt, 1 = split (n_split
// splits of split_keys keys, then the combine; `part` holds
// B*Hkv*n_split*g*T*(hd+2) floats), 2 = chunk_tc (bfloat16).  Strides are in elements;
// the head_dim stride of q, k, v and out must be 1.  Returns a cudaError_t
// (0 = ok).
int paged_attention_launch(
    const void* q, const void* k, const void* v, const int* block,
    const int* lens, const int* kv_lens, void* out, float* part, int dtype,
    int route, int B,
    int T, int H, int Hkv, int hd, int ps, int P, int n_split,
    int split_keys, int ring, int window, long long q_sb, long long q_st, long long q_sh,
    long long k_sp, long long k_st, long long k_sh, long long v_sp,
    long long v_st, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, long long blk_sb, float softcap, float scale,
    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.block = block; p.lens = lens;
  p.kv_lens = kv_lens; p.out = out;
  p.T = T; p.H = H; p.Hkv = Hkv; p.hd = hd; p.ps = ps; p.P = P;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sp = k_sp; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sp = v_sp; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.blk_sb = blk_sb;
  p.softcap = softcap; p.scale = scale;
  p.tile_pages = tile_pages_for(ps);
  const int rows = (H / Hkv) * T;
  p.row_chunk = rows < kRowChunk ? rows : kRowChunk;
  p.n_split = n_split; p.split_keys = split_keys;
  p.ring = ring; p.window = window;
  p.part = part;
  p.part_rows = (long long)B * Hkv * n_split * rows;
  if (B <= 0 || T <= 0 || rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1 && part == nullptr) return cudaErrorInvalidValue;
  if (ring < 0 || window < 0 || ring > P * ps ||
      (ring > 0 && kv_lens == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (route == 0) return launch_simt<float>(p, B, s);
    if (route == 1) return launch_split_hd<float>(p, B, s);
  } else if (dtype == 1) {
    if (route == 0) return launch_simt<bf16>(p, B, s);
    if (route == 1) return launch_split_hd<bf16>(p, B, s);
    if (route == 2) return launch_chunk_hd(p, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
