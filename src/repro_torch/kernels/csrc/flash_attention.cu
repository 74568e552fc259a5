// Flash attention for Hopper (sm_90a), CUDA C++ with a plain C entry point.
//
// Replaces the TPU kernel of the JAX package: `flash_attention`
// (src/repro/kernels/flash_attention.py:103), whose body `_attn_kernel`
// (:30) runs under the `pl.pallas_call` at :137.  Same contract: q
// [B,T,H,hd] attends over k/v [B,S,Hkv,hd]; GQA maps head h to kv head
// h / (H/Hkv); the causal convention puts the T queries at the suffix of
// the S keys (query t sits at position t + S - T) and masks k_pos <= q_pos;
// an optional sliding window also masks k_pos <= q_pos - window; an
// optional tanh softcap is applied to the scaled scores before masking;
// scale hd^-0.5; masked scores are -1e30 (never -inf) and their
// probabilities exactly 0; f32 softmax and accumulation; output in q's
// dtype; a row with no visible key returns exact zeros.  Unlike the TPU
// kernel, which needs S % block_k == 0 and T % block_q == 0, any T and S
// are accepted: ragged tiles are masked by bounds and nothing at or past
// S is read.
//
// What bounds it on an H100: in the main path's prefill (B=1, H=9, Hkv=3,
// hd=64, T=S up to 512) a query row does 4*hd flops per visible key while
// q, k, v and out are read or written once, so the work is far above the
// card's ~295 flop/byte line and the bound is the tensor-core rate.  A
// one-token decode (T=1) reads the whole K/V for g rows per kv head and is
// bound by the memory rate.
//
// The design's answer, deliberately simple: one block per (q tile, kv
// head, b) holds the g*block_q query rows that share the kv head, so each
// K/V tile is loaded into shared memory once for all of them; the kv loop
// starts at the window's left edge and stops at the causal diagonal of the
// tile's last query; the online-softmax state (max, sum, accumulator) stays
// in shared memory across the loop, one warp per row for the max and sum.
// The arithmetic is f32 on the CUDA cores: no wgmma, no TMA or cp.async
// ring, no split-KV for decode.  Those belong to the PR that makes it fast.
//
// Strided inputs are read in place (a layer's ring slice ring[:, :S] is
// not contiguous over the batch); the head_dim stride must be 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
// A block may hold at most this much dynamic shared memory on sm_90.
constexpr int kMaxSmemBytes = 232448;
// Keys per shared-memory tile.
constexpr int kTileKeys = 64;

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
  void* out;
  int T, S, H, Hkv, hd, block_q;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  int causal, window;
  float softcap, scale;
};

// Floats of shared memory one block needs for R query rows.
long long smem_floats(int rows, int hd) {
  const long long r = rows, ldh = hd + 1;
  return r * ldh                       // q (pre-scaled)
         + r * hd                      // output accumulator
         + 3 * r                       // running max, running sum, rescale
         + kTileKeys * ldh             // K tile
         + (long long)kTileKeys * hd   // V tile
         + r * (kTileKeys + 1);        // scores, then probabilities
}

// Is key position kp visible from query position qp?
__device__ __forceinline__ bool visible(const Params& p, int kp, int qp) {
  if (p.causal && kp > qp) return false;
  if (p.window > 0 && kp <= qp - p.window) return false;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  const int t0 = blockIdx.x * p.block_q;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = p.H / p.Hkv;
  const int tq = min(p.block_q, p.T - t0);  // query tokens of this tile
  const int R = g * tq;                      // rows: r = t*g + gi
  const int hd = p.hd;
  const int ldh = hd + 1;                    // +1: conflict-free columns
  constexpr int BK = kTileKeys;
  constexpr int lds = BK + 1;
  const int q_off = p.S - p.T;               // query t sits at t + q_off

  extern __shared__ float smem[];
  float* q_s = smem;                    // [R][ldh]
  float* acc_s = q_s + R * ldh;         // [R][hd]
  float* m_s = acc_s + R * hd;          // [R]
  float* l_s = m_s + R;                 // [R]
  float* a_s = l_s + R;                 // [R]
  float* k_s = a_s + R;                 // [BK][ldh]
  float* v_s = k_s + BK * ldh;          // [BK][hd]
  float* s_s = v_s + BK * hd;           // [R][lds]

  const T* q = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int t = t0 + r / g, h = kvh * g + r % g;
    q_s[r * ldh + d] =
        to_f32(q[b * p.q_sb + t * p.q_st + h * p.q_sh + d]) * p.scale;
    acc_s[r * hd + d] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // Keys any row of this tile can see: [k_begin, k_end).
  const int q_first = t0 + q_off, q_last = t0 + tq - 1 + q_off;
  int k_end = p.S;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int kb = k_begin; kb < k_end; kb += BK) {
    __syncthreads();                    // previous tile fully consumed
    const int keys = min(BK, k_end - kb);
    // Load the K and V tile once for every query row of the kv head.
    // Slots past `keys` are zero-filled and never summed.
    for (int i = threadIdx.x; i < BK * hd; i += kThreads) {
      const int c = i / hd, d = i % hd;
      float kv = 0.f, vv = 0.f;
      if (c < keys) {
        const long long s = kb + c;
        kv = to_f32(kg[b * p.k_sb + s * p.k_ss + kvh * p.k_sh + d]);
        vv = to_f32(vg[b * p.v_sb + s * p.v_ss + kvh * p.v_sh + d]);
      }
      k_s[c * ldh + d] = kv;
      v_s[c * hd + d] = vv;
    }
    __syncthreads();

    // Scores of every row against the tile; masked entries -1e30.
    for (int i = threadIdx.x; i < R * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const int qp = t0 + r / g + q_off;
      float s = kNegInf;
      if (c < keys && visible(p, kb + c, qp)) {
        const float* qr = q_s + r * ldh;
        const float* kr = k_s + c * ldh;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
        if (p.softcap > 0.f) dot = tanhf(dot / p.softcap) * p.softcap;
        s = dot;
      }
      s_s[r * lds + c] = s;
    }
    __syncthreads();

    // Online softmax, one warp per row: new max, probabilities (exactly
    // 0 where masked, so exp(-1e30 - -1e30) = 1 never counts), new sum.
    for (int r = warp; r < R; r += kWarps) {
      const int qp = t0 + r / g + q_off;
      float* sr = s_s + r * lds;
      float m_cur = kNegInf;
      for (int c = lane; c < keys; c += 32)
        if (visible(p, kb + c, qp)) m_cur = fmaxf(m_cur, sr[c]);
      for (int o = 16; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float pr = (c < keys && visible(p, kb + c, qp))
                             ? expf(sr[c] - m_new) : 0.f;
        sr[c] = pr;
        sum += pr;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V.
    for (int i = threadIdx.x; i < R * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const float* pr = s_s + r * lds;
      float o = acc_s[r * hd + d] * a_s[r];
      for (int c = 0; c < keys; ++c) o += pr[c] * v_s[c * hd + d];
      acc_s[r * hd + d] = o;
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int t = t0 + r / g, h = kvh * g + r % g;
    const float l = l_s[r];
    const float o = l == 0.f ? 0.f : acc_s[r * hd + d] / l;  // no key: 0
    out[b * p.o_sb + t * p.o_st + h * p.o_sh + d] = from_f32<T>(o);
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int rows = (p.H / p.Hkv) * p.block_q;
  const long long smem = smem_floats(rows, p.hd) * (long long)sizeof(float);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((p.T + p.block_q - 1) / p.block_q, p.Hkv, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Most query rows (g * block_q) one block can hold in shared memory for
// this head_dim; the wrapper picks block_q under it.
int flash_attention_max_rows(int hd) {
  int rows = 0;
  while (smem_floats(rows + 1, hd) * (long long)sizeof(float) <=
         kMaxSmemBytes)
    ++rows;
  return rows;
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head_dim
// stride of q, k, v and out must be 1.  Returns a cudaError_t (0 = ok).
int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int T, int S, int H, int Hkv, int hd, int block_q, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, int causal, int window,
    float softcap, float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.T = T; p.S = S; p.H = H; p.Hkv = Hkv; p.hd = hd; p.block_q = block_q;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.causal = causal; p.window = window;
  p.softcap = softcap; p.scale = scale;
  if (B <= 0 || T <= 0 || H <= 0) return cudaSuccess;
  if (block_q <= 0 || Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
