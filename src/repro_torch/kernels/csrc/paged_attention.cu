// Paged attention for Hopper (sm_90a), CUDA C++ with a plain C entry point.
//
// Replaces the TPU kernel of the JAX package: `paged_attention`
// (src/repro/kernels/paged_attention.py:101), whose body `_paged_kernel`
// (:47) runs under the `pl.pallas_call` at :152.  Same contract: q
// [B,T,H,hd] attends over page-scattered K/V [n_pages, ps, Hkv, hd] through
// an int32 block table [B,P] and int32 lengths [B]; query t sits at
// lens[b]-T+t and is causally masked to it; GQA maps head h to kv head
// h / (H/Hkv); optional tanh softcap; scale hd^-0.5; f32 softmax and
// accumulation; output in q's dtype; pages at or past lens are never read
// or summed; a lens<=0 row returns exact zeros.
//
// What bounds it on an H100: decode (T=1) is memory-bound.  Each query row
// does ~4*hd flops per key against 2*hd*sizeof(T) bytes of K/V, far below
// the ~295 flop/byte the card needs to be compute-bound, so the least time
// is the K/V bytes actually read / 3.35 TB/s.  A chunked prefill (T=64,
// g=3) raises the reuse to g*T rows per key, still well under the line.
//
// The design's answer: one block per (b, kv head) walks that row's pages
// in order, and each K/V tile is loaded into shared memory ONCE for all
// g*T query rows that share the kv head, so every page is read once per kv
// head (the TPU grid reads it once per query head).  Scores and the
// online softmax run in f32 in shared memory.  The pool is read through
// its strides: the caller hands one layer's non-contiguous view
// pool[:, :, li] and nothing is ever copied to make it contiguous.
//
// Deliberately simple: no split-K over pages, no cp.async/TMA ring, no
// wgmma.  Those belong to the PR that makes it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
// A block may hold at most this much dynamic shared memory on sm_90.
constexpr int kMaxSmemBytes = 232448;
// Keys per shared-memory tile (rounded to whole pages) and query rows per
// score pass: the tile is loaded once, then consumed in row chunks.
constexpr int kTileKeys = 64;
constexpr int kRowChunk = 32;

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
  void* out;
  int T, H, Hkv, hd, ps, P;
  long long q_sb, q_st, q_sh;
  long long k_sp, k_st, k_sh;
  long long v_sp, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  long long blk_sb;
  float softcap, scale;
  int tile_pages, row_chunk;
};

int tile_pages_for(int ps) { return ps >= kTileKeys ? 1 : kTileKeys / ps; }

// Floats of shared memory one block needs for R query rows.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Params p) {
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

  // Never walk past the table, never touch a page at or past lens.
  int n_pages = len <= 0 ? 0 : (len + p.ps - 1) / p.ps;
  if (n_pages > p.P) n_pages = p.P;
  const int* brow = p.block + b * p.blk_sb;

  for (int j0 = 0; j0 < n_pages; j0 += p.tile_pages) {
    __syncthreads();                    // previous tile fully consumed
    const int pages = min(p.tile_pages, n_pages - j0);
    const int keys = pages * p.ps;
    const int kbase = j0 * p.ps;
    // Load this tile's K and V once, for every query row of the kv head.
    // Slots past `keys` are zero-filled: they are masked, and a masked
    // probability of exactly 0 must not meet stale shared memory.
    for (int i = threadIdx.x; i < KT * hd; i += kThreads) {
      const int c = i / hd, d = i % hd;
      float kv = 0.f, vv = 0.f;
      if (c < keys) {
        const long long page = brow[j0 + c / p.ps];
        const int off = c % p.ps;
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
        if (c < keys && kbase + c <= q_pos) {   // causal AND valid
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
        int valid = q_pos - kbase + 1;          // keys this row may see
        if (valid > keys) valid = keys;
        float* sr = s_s + rr * ldk;
        const float m_prev = m_s[r];
        float m_new = m_prev;
        for (int c = 0; c < valid; ++c) m_new = fmaxf(m_new, sr[c]);
        float sum = 0.f;
        for (int c = 0; c < KT; ++c) {
          const float pr = c < valid ? expf(sr[c] - m_new) : 0.f;
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

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int rows = (p.H / p.Hkv) * p.T;
  const long long smem = smem_floats(rows, p.hd, p.ps) * (long long)sizeof(float);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(B, p.Hkv);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Most query rows (g*T) one launch can hold in shared memory for this
// head_dim and page size; the wrapper splits longer chunks along T.
int paged_attention_max_rows(int hd, int ps) {
  int rows = 0;
  while (smem_floats(rows + 1, hd, ps) * (long long)sizeof(float) <=
         kMaxSmemBytes)
    ++rows;
  return rows;
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head_dim
// stride of q, k, v and out must be 1.  Returns a cudaError_t (0 = ok).
int paged_attention_launch(
    const void* q, const void* k, const void* v, const int* block,
    const int* lens, void* out, int dtype, int B, int T, int H, int Hkv,
    int hd, int ps, int P, long long q_sb, long long q_st, long long q_sh,
    long long k_sp, long long k_st, long long k_sh, long long v_sp,
    long long v_st, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, long long blk_sb, float softcap, float scale,
    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.block = block; p.lens = lens; p.out = out;
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
  if (B <= 0 || T <= 0 || rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
