// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// entry point.
//
// Replaces the TPU kernel of the JAX package: `flash_attention`
// (src/repro/kernels/flash_attention.py:103), whose body `_attn_kernel`
// (:30) runs under the `pl.pallas_call` at :137.  Same contract: q
// [B,T,H,hd] attends over k/v [B,S,Hkv,hd]; GQA maps head h to kv head
// h / (H/Hkv); the causal convention puts the T queries at the suffix of
// the S keys (query t sits at position t + S - T) and masks k_pos <= q_pos;
// an optional sliding window also masks k_pos <= q_pos - window; an
// optional tanh softcap is applied to the scaled scores before masking;
// scale hd^-0.5; masked probabilities are exactly 0 (the reference's
// -1e30 scores); f32 softmax and accumulation; output in q's dtype; a row
// with no visible key returns exact zeros.  Unlike the TPU kernel, which
// needs S % block_k == 0 and T % block_q == 0, any T and S are accepted:
// ragged tiles are masked by bounds and nothing at or past S is read.
// When given a buffer, it also writes each row's natural log-sum-exp of
// the scaled scores, lse [B,H,T] f32 (-1e30 for a row with no visible
// key), which the backward (flash_attention_bwd.cu) reads.
//
// What bounds it on an H100: a query row does 4*hd flops per visible key
// while q, k, v and out move once, so prefills and the training shape
// (B=4, T=S=1024, 9/3 heads) sit far above the card's ~295 flop/byte line
// and are bound by the tensor-core rate; a one-token decode (T=1) reads
// the whole K/V for a few rows and is bound by the memory rate.
//
// Two instances:
//
// * bf16, head_dim 16/32/64/80/128, 16-byte aligned rows: `flash_fwd_tc`.
//   One block per (64 query rows, query head, b), 4 warps of 16 rows (one
//   warp per 16 rows when T is shorter); the g heads that share a kv head
//   are neighbouring blocks and read its K/V tiles from L2.  K/V tiles of
//   64 keys come through a 3-stage cp.async ring in shared memory, one
//   barrier per tile: the copies of the next two tiles are in flight
//   while a tile is multiplied.  S = Q K^T and O += P V run on the tensor
//   cores (mma.sync.m16n8k16, bf16 in, f32 accumulate, operands by
//   ldmatrix); P goes from the S accumulator to the A operand of P V in
//   registers; the online-softmax state (max, sum, 16 x hd accumulator)
//   lives in registers.  A block is a chain of dependent steps per tile,
//   so latency decides its time: the softcap and the mask branch once
//   per tile rather than per element (only tiles on an edge are masked
//   element by element), exponentials go to the special-function unit
//   (ex2.approx), and the heaviest causal q tiles launch first.  The kv
//   loop runs from the window's left edge to the causal diagonal.  No
//   wgmma/TMA yet (ROADMAP).  hd 80 (zamba2-2.7b's shared attention) is
//   five 16-wide k-steps of QK^T and five n-tile pairs of PV; its 160-byte
//   rows are ten 16-byte copies, padded to 88 elements (176 bytes: the 8
//   rows an ldmatrix reads start in 8 distinct 16-byte bank groups).
// * float32 (and bf16 outside the cases above): `flash_fwd_simt`, the
//   first, CUDA-core design.  f32 FMA, so the f32 checks (1e-4) hold:
//   TF32 keeps ~3 digits.  One block per (q tile, kv head, b) holds
//   the g*block_q rows of the kv head; state in shared memory.
//
// Strided inputs are read in place (a layer's ring slice ring[:, :S] is
// not contiguous over the batch); the head_dim stride must be 1.

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::kNegInf;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;  // [B,H,T] or null
  int T, S, H, Hkv, hd, block_q;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  int causal, window;
  float softcap, scale;
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kBK = 64;     // keys per tile
constexpr int kStages = 3;  // K/V tiles in the ring

template <int HD>
constexpr int tc_smem_bytes() {
  return (64 + 2 * kStages * kBK) * (HD + 8) * 2;  // Q, then the K/V ring
}

template <int HD>
__global__ void __launch_bounds__(128) flash_fwd_tc(const Params p) {
  constexpr int LD = HD + 8, KT = HD / 16, NT = HD / 8, KN = kBK / 8;
  constexpr int NS = kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, gc = lane & 3;
  const int BQ = blockDim.x / 2;  // 16 rows per warp
  const int h = blockIdx.x, b = blockIdx.z;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int kvh = h / (p.H / p.Hkv);
  const int tq = min(BQ, p.T - t0);
  const int off = p.S - p.T;  // query t sits at t + off

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* k_s = q_s + 64 * LD;                      // [NS][kBK][LD]
  bf16* v_s = k_s + NS * kBK * LD;                // [NS][kBK][LD]

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb +
                   t0 * p.q_st + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // Keys any row of this tile can see: [k_begin, k_end).
  const int q_first = t0 + off, q_last = t0 + tq - 1 + off;
  const int k_end = p.causal ? min(p.S, q_last + 1) : p.S;
  const int k_begin = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto load_kv = [&](int j) {
    const int kb = k_begin + j * kBK, st = j % NS;
    const int keys = min(kBK, p.S - kb);
    flash::load_rows<HD>(k_s + st * kBK * LD, kg + kb * p.k_ss, p.k_ss,
                         kBK, keys, p.k);
    flash::load_rows<HD>(v_s + st * kBK * LD, vg + kb * p.v_ss, p.v_ss,
                         kBK, keys, p.v);
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
    const int kb = k_begin + j * kBK;
    // A warp whose rows all precede the tile's first key skips it (its
    // probabilities there are all 0).  Tile 0 starts at or before every
    // row's position, so no active warp skips it, and the Q fragments are
    // loaded there once.
    if (active && !(p.causal && kb > wq_last)) {
      const bf16* ks = k_s + (j % NS) * kBK * LD;
      const bf16* vs = v_s + (j % NS) * kBK * LD;
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          flash::load_a(qf[kk], q_s, LD, w0, kk * 16);
      }
      // S = Q K^T: 16 rows x kBK keys as KN n-tiles of 8 keys.
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
      // softcap and the mask branch once per tile, outside the element
      // loops, so no element pays for a tanh or a mask it does not need.
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
      const bool full = kb + kBK <= p.S &&
                        (!p.causal || kb + kBK - 1 <= wq_first) &&
                        (p.window <= 0 || kb > wq_last - p.window);
      if (!full) {
#pragma unroll
        for (int n = 0; n < KN; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kb + n * 8 + 2 * gc + (e & 1);
            const int qp = wq_first + gr + (e >> 1) * 8;
            if (kp >= p.S || !flash::visible(p.causal, p.window, kp, qp))
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
    if (p.lse != nullptr && gc == 0)
      p.lse[((long long)b * p.H + h) * p.T + t] =
          lsum > 0.f ? (m[r] + log2f(lsum)) * flash::kLn2 : kNegInf;
  }
}

template <int HD>
cudaError_t launch_tc(const Params& p, int B, cudaStream_t stream) {
  static bool attr = false;
  const cudaError_t e = flash::allow_max_smem(flash_fwd_tc<HD>, attr);
  if (e != cudaSuccess) return e;
  const int warps = min(4, (p.T + 15) / 16);
  const int bq = 16 * warps;
  dim3 grid(p.H, (p.T + bq - 1) / bq, B);
  flash_fwd_tc<HD><<<grid, 32 * warps, tc_smem_bytes<HD>(), stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 (and other bf16 cases) on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 64;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt(const Params p) {
  using flash::to_f32;
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
      if (c < keys && flash::visible(p.causal, p.window, kb + c, qp)) {
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
        if (flash::visible(p.causal, p.window, kb + c, qp))
          m_cur = fmaxf(m_cur, sr[c]);
      for (int o = 16; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float pr =
            (c < keys && flash::visible(p.causal, p.window, kb + c, qp))
                ? expf(sr[c] - m_new) : 0.f;
        sr[c] = pr;
        sum += pr;
      }
      sum = flash::warp_sum(sum);
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
    out[b * p.o_sb + t * p.o_st + h * p.o_sh + d] = flash::from_f32<T>(o);
  }
  if (p.lse != nullptr) {
    for (int r = threadIdx.x; r < R; r += kThreads) {
      const int t = t0 + r / g, h = kvh * g + r % g;
      const float l = l_s[r];
      p.lse[((long long)b * p.H + h) * p.T + t] =
          l == 0.f ? kNegInf : m_s[r] + logf(l);
    }
  }
}

template <typename T>
cudaError_t launch_simt(const Params& p, int B, cudaStream_t stream) {
  const int rows = (p.H / p.Hkv) * p.block_q;
  const long long smem = smem_floats(rows, p.hd) * (long long)sizeof(float);
  if (smem > flash::kMaxSmemBytes) return cudaErrorInvalidValue;
  static bool attr = false;
  const cudaError_t e = flash::allow_max_smem(flash_fwd_simt<T>, attr);
  if (e != cudaSuccess) return e;
  dim3 grid((p.T + p.block_q - 1) / p.block_q, p.Hkv, B);
  flash_fwd_simt<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Most query rows (g * block_q) one block of the CUDA-core instance can
// hold in shared memory for this head_dim; the wrapper picks block_q
// under it.
int flash_attention_max_rows(int hd) {
  int rows = 0;
  while (smem_floats(rows + 1, hd) * (long long)sizeof(float) <=
         flash::kMaxSmemBytes)
    ++rows;
  return rows;
}

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = CUDA cores (block_q
// used), 1 = tensor cores (bf16, hd 16/32/64/80/128, every row 16-byte
// aligned: the wrapper checks).  lse: [B,H,T] f32 or null.  Strides are in
// elements; the head_dim stride of q, k, v and out must be 1.  Returns a
// cudaError_t (0 = ok).
int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int dtype, int route, int B, int T, int S, int H, int Hkv, int hd,
    int block_q, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, int causal, int window, float softcap, float scale,
    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.lse = static_cast<float*>(lse);
  p.T = T; p.S = S; p.H = H; p.Hkv = Hkv; p.hd = hd; p.block_q = block_q;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.causal = causal; p.window = window;
  p.softcap = softcap; p.scale = scale;
  if (B <= 0 || T <= 0 || H <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1) return cudaErrorInvalidValue;
    switch (hd) {
      case 16: return launch_tc<16>(p, B, s);
      case 32: return launch_tc<32>(p, B, s);
      case 64: return launch_tc<64>(p, B, s);
      case 80: return launch_tc<80>(p, B, s);
      case 128: return launch_tc<128>(p, B, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (block_q <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_simt<float>(p, B, s);
  if (dtype == 1) return launch_simt<bf16>(p, B, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
