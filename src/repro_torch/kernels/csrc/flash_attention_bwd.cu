// Flash attention backward for Hopper (sm_90a), CUDA C++ with a plain C
// entry point.
//
// The gradient of flash_attention.cu's forward: the JAX package has no
// Pallas backward (its `_fa_bwd`, src/repro/kernels/flash_attention.py:
// 182-189, differentiates the jnp reference), and this kernel computes
// the same VJP from the forward's residuals (q, k, v, out, lse) and the
// cotangent dout, without a [T, S] tensor in device memory:
//
//   D  = rowsum(dout * out)                      per query row
//   S  = scale * q k^T, capped: c * tanh(S / c)   (recomputed)
//   P  = exp(S - lse), 0 where masked
//   dV = sum over queries of P^T dout
//   dP = dout v^T
//   dS = P * (dP - D) * (1 - (S / c)^2 under a softcap c)
//   dK = scale * dS^T q    (summed over the g query heads of a kv head)
//   dQ = scale * dS k
//
// with the forward's causal-at-suffix, window, GQA and ragged-edge masks.
//
// What bounds it on an H100: five products per visible (query, key)
// pair against q, k, v, out, dout read once and dq, dk, dv written once,
// so at the training shape (B=4, T=S=1024, 9/3 heads, hd 64) it is bound
// by the tensor-core rate.
//
// Design: deterministic, two launches, no atomics.
//   1. dQ pass, one block per (64 query rows, query head, b), 4 warps of
//      16 rows: computes D of its rows (and writes it for pass 2), then
//      walks the key tiles the rows can see through a 2-stage cp.async
//      ring, recomputing S and P and accumulating dQ in registers.
//   2. dK/dV pass, one block per (64 keys, query head, b), 4 warps of 16
//      keys: walks every 64-query tile of its head that can see its keys
//      through the same ring (q, dout, lse, D per tile), computing S^T
//      and dP^T directly with the keys as rows, so P^T and dS^T are the A
//      operands of dV += P^T dout and dK += dS^T q straight from
//      registers.  With g > 1 query heads per kv head, each block writes
//      its head's share in f32 and a third launch sums the g shares in a
//      fixed order: a block per kv head would walk g times as many tiles
//      in series (48 at the training shape), one per query head walks 16.
// bf16 (head_dim 16/32/64/80/128, 16-byte aligned rows) runs on the
// tensor cores (mma.sync.m16n8k16, f32 accumulation); as in the forward,
// each tile costs one barrier, the softcap and the mask branch once per
// tile outside the element loops, and exponentials use ex2.approx.  float32,
// and bf16 outside those cases, runs a CUDA-core instance of the same
// two passes (f32 FMA, no TF32) for the f32 checks, not for speed.
// head_dim 80 (zamba2-2.7b's shared attention): a 160-byte row is ten
// 16-byte copies, so flash::load_rows leaves idle the threads past a
// whole number of rows; every other loop over a row's columns steps by
// k-steps of 16 (HD / 16 = 5), n-tiles of 8 (NT = 10) or pairs of
// columns, which 80 divides.

#include "flash_common.cuh"

namespace {

using flash::bf16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;  // [B,H,T]
  float* dsum;       // D, [B,H,T]: written by pass 1, read by pass 2
  void* dq;
  void* dk;
  void* dv;
  // [2][B,S,H,hd] f32: each query head's share of dK (scaled) and dV,
  // summed over the g heads of a kv head by flash_bwd_sum_heads; null
  // when g == 1 (the dK/dV pass then writes dk and dv itself).
  float* partial;
  int T, S, H, Hkv, hd;
  // Element strides (batch, sequence, head) of q, k, v, out, dout, dq,
  // dk, dv; every head_dim stride is 1.
  long long st[8][3];
  int causal, window;
  float softcap, scale;
};

enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV };

__device__ __forceinline__ long long at(const Params& p, int t, int b,
                                        int s, int h) {
  return b * p.st[t][0] + s * p.st[t][1] + h * p.st[t][2];
}

// The rows [t_lo, t_hi) whose positions can see some key of [kb, ke).
__device__ __forceinline__ void query_range(const Params& p, int kb, int ke,
                                            int& t_lo, int& t_hi) {
  const int off = p.S - p.T;
  t_lo = p.causal ? max(0, kb - off) : 0;
  t_hi = p.window > 0 ? min(p.T, ke - 1 + p.window - off) : p.T;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kBK = 64;

template <int HD>
constexpr int dq_smem_bytes() {
  return (2 * 64 + 4 * kBK) * (HD + 8) * 2;  // Q, dO, 2 stages of K, V
}

template <int HD>
constexpr int dkdv_smem_bytes() {
  return (2 * kBK + 4 * 64) * (HD + 8) * 2 + 4 * 64 * 4;  // + lse, D
}

template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_dq_tc(const Params p) {
  constexpr int LD = HD + 8, KT = HD / 16, NT = HD / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, gc = lane & 3;
  const int BQ = blockDim.x / 2;
  const int h = blockIdx.x, b = blockIdx.z;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int kvh = h / (p.H / p.Hkv);
  const int tq = min(BQ, p.T - t0);
  const int off = p.S - p.T;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* do_s = q_s + 64 * LD;                     // [64][LD]
  bf16* k_s = do_s + 64 * LD;                     // [2][kBK][LD]
  bf16* v_s = k_s + 2 * kBK * LD;                 // [2][kBK][LD]

  const bf16* qg = static_cast<const bf16*>(p.q) + at(p, kQ, b, t0, h);
  const bf16* dog = static_cast<const bf16*>(p.dout) + at(p, kDO, b, t0, h);
  const bf16* kg = static_cast<const bf16*>(p.k) + at(p, kK, b, 0, kvh);
  const bf16* vg = static_cast<const bf16*>(p.v) + at(p, kV, b, 0, kvh);

  const int q_first = t0 + off, q_last = t0 + tq - 1 + off;
  const int k_end = p.causal ? min(p.S, q_last + 1) : p.S;
  const int k_begin = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto load_kv = [&](int j) {
    const int kb = k_begin + j * kBK, st = j & 1;
    const int keys = min(kBK, p.S - kb);
    flash::load_rows<HD>(k_s + st * kBK * LD, kg + kb * p.st[kK][1],
                         p.st[kK][1], kBK, keys, p.k);
    flash::load_rows<HD>(v_s + st * kBK * LD, vg + kb * p.st[kV][1],
                         p.st[kV][1], kBK, keys, p.v);
  };
  flash::load_rows<HD>(q_s, qg, p.st[kQ][1], BQ, tq, p.q);
  flash::load_rows<HD>(do_s, dog, p.st[kDO][1], BQ, tq, p.dout);
  if (n_kt > 0) load_kv(0);
  flash::cp_async_commit();

  const int w0 = warp * 16;
  const bool active = w0 < tq;
  const int wq_first = t0 + w0 + off, wq_last = wq_first + 15;
  // D and lse (log2 units) of the thread's rows w0 + gr and w0 + gr + 8;
  // 0 for rows past T, whose q and dout are zero and whose dS is then 0.
  float d_row[2] = {0.f, 0.f}, lse_row[2] = {0.f, 0.f};
  if (active) {
    const bf16* og = static_cast<const bf16*>(p.out);
    const bf16* dg = static_cast<const bf16*>(p.dout);
    for (int r = 0; r < 16; ++r) {
      const int t = t0 + w0 + r;
      float part = 0.f;
      if (t < p.T) {
        const bf16* orow = og + at(p, kO, b, t, h);
        const bf16* drow = dg + at(p, kDO, b, t, h);
        for (int c = 2 * lane; c < HD; c += 64) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(orow + c));
          const float2 y = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(drow + c));
          part += x.x * y.x + x.y * y.y;
        }
      }
      part = flash::warp_sum(part);
      if (r == gr) d_row[0] = part;
      if (r == gr + 8) d_row[1] = part;
      if (t < p.T && lane == 0)
        p.dsum[((long long)b * p.H + h) * p.T + t] = part;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + w0 + gr + r * 8;
      if (t < p.T)
        lse_row[r] = p.lse[((long long)b * p.H + h) * p.T + t] *
                     flash::kLog2e;
    }
  }

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    flash::cp_async_wait<0>();  // tile j (and Q, dO) have landed
    // Every warp is past tile j - 1, so its stage takes tile j + 1, whose
    // copy then runs under the products of tile j.
    __syncthreads();
    if (j + 1 < n_kt) load_kv(j + 1);
    flash::cp_async_commit();
    const int kb = k_begin + j * kBK;
    if (active && !(p.causal && kb > wq_last)) {
      const bf16* ks = k_s + (j & 1) * kBK * LD;
      const bf16* vs = v_s + (j & 1) * kBK * LD;
      float s[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // S = Q K^T and dP = dO V^T, 16 rows x 64 keys each.
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4], ad[4];
        flash::load_a(a, q_s, LD, w0, kk * 16);
        flash::load_a(ad, do_s, LD, w0, kk * 16);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4], bv[4];
          flash::load_b(bk, ks, LD, np * 16, kk * 16);
          flash::load_b(bv, vs, LD, np * 16, kk * 16);
          flash::mma(s[2 * np], a, bk[0], bk[1]);
          flash::mma(s[2 * np + 1], a, bk[2], bk[3]);
          flash::mma(dp[2 * np], ad, bv[0], bv[1]);
          flash::mma(dp[2 * np + 1], ad, bv[2], bv[3]);
        }
      }
      // dS, in place of S.  The softcap and the mask branch once per
      // tile, outside the element loops: first the capped scores (and,
      // under a cap, dP - D times its derivative 1 - tanh^2), then -inf
      // where masked, then dS = exp(S - lse) (dP - D).
      if (p.softcap > 0.f) {
        const float inv_cap = p.scale / p.softcap;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float t = tanhf(s[n][e] * inv_cap);
            s[n][e] = t * p.softcap;
            dp[n][e] = (dp[n][e] - d_row[e >> 1]) * (1.f - t * t);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] *= p.scale;
            dp[n][e] -= d_row[e >> 1];
          }
        }
      }
      const bool full = kb + kBK <= p.S &&
                        (!p.causal || kb + kBK - 1 <= wq_first) &&
                        (p.window <= 0 || kb > wq_last - p.window);
      if (!full) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kb + n * 8 + 2 * gc + (e & 1);
            const int qp = wq_first + gr + (e >> 1) * 8;
            if (kp >= p.S || !flash::visible(p.causal, p.window, kp, qp))
              s[n][e] = -CUDART_INF_F;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = flash::fast_exp2(s[n][e] * flash::kLog2e -
                                     lse_row[e >> 1]) * dp[n][e];
      // dQ += dS K: dS from registers, K transposed by ldmatrix.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        flash::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bfr[4];
          flash::load_bt(bfr, ks, LD, kk * 16, np * 16);
          flash::mma(dq[2 * np], a, bfr[0], bfr[1]);
          flash::mma(dq[2 * np + 1], a, bfr[2], bfr[3]);
        }
      }
    }
  }
  flash::cp_async_wait<0>();

  if (!active) return;
  bf16* dqg = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + w0 + gr + r * 8;
    if (t >= p.T) continue;
    bf16* row = dqg + at(p, kDQ, b, t, h);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * gc) = flash::pack_bf16(
          dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_tc(const Params p) {
  constexpr int LD = HD + 8, KT = HD / 16, NT = HD / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, gc = lane & 3;
  const int h = blockIdx.x, b = blockIdx.z;
  const int kb = blockIdx.y * kBK;  // causal: the first tiles are heaviest
  const int keys = min(kBK, p.S - kb);
  const int kvh = h / (p.H / p.Hkv);
  const int off = p.S - p.T;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kBK][LD]
  bf16* v_s = k_s + kBK * LD;                     // [kBK][LD]
  bf16* q_s = v_s + kBK * LD;                     // [2][64][LD]
  bf16* do_s = q_s + 2 * 64 * LD;                 // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * 64 * LD);  // [2][64]
  float* d_s = lse_s + 2 * 64;                                  // [2][64]

  int t_lo, t_hi;
  query_range(p, kb, kb + keys, t_lo, t_hi);
  const int qi_lo = t_lo / 64;
  const int n_it = t_hi > t_lo ? (t_hi + 63) / 64 - qi_lo : 0;

  auto load_q = [&](int it) {
    const int t0 = (qi_lo + it) * 64;
    const int st = it & 1, rows = min(64, p.T - t0);
    flash::load_rows<HD>(q_s + st * 64 * LD,
                         static_cast<const bf16*>(p.q) + at(p, kQ, b, t0, h),
                         p.st[kQ][1], 64, rows, p.q);
    flash::load_rows<HD>(
        do_s + st * 64 * LD,
        static_cast<const bf16*>(p.dout) + at(p, kDO, b, t0, h),
        p.st[kDO][1], 64, rows, p.dout);
    const long long row0 = ((long long)b * p.H + h) * p.T + t0;
    for (int i = threadIdx.x; i < 64; i += blockDim.x) {
      const bool ok = i < rows;
      flash::cp_async4(lse_s + st * 64 + i, ok ? p.lse + row0 + i : p.lse,
                       ok);
      flash::cp_async4(d_s + st * 64 + i, ok ? p.dsum + row0 + i : p.dsum,
                       ok);
    }
  };
  flash::load_rows<HD>(k_s,
                       static_cast<const bf16*>(p.k) + at(p, kK, b, kb, kvh),
                       p.st[kK][1], kBK, keys, p.k);
  flash::load_rows<HD>(v_s,
                       static_cast<const bf16*>(p.v) + at(p, kV, b, kb, kvh),
                       p.st[kV][1], kBK, keys, p.v);
  if (n_it > 0) load_q(0);
  flash::cp_async_commit();

  // This warp's keys: kp0 .. kp0+15; the thread's are kp0 + gr (+ 8).
  const int w0 = warp * 16, kp0 = kb + w0;
  const bool active = w0 < keys;
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    flash::cp_async_wait<0>();  // tile it (and K, V) have landed
    __syncthreads();            // every warp is past tile it - 1
    if (it + 1 < n_it) load_q(it + 1);
    flash::cp_async_commit();
    const int t0 = (qi_lo + it) * 64, st = it & 1;
    const int qp_first = t0 + off, qp_last = qp_first + 63;
    // Skip when every query of the tile precedes this warp's first key
    // (causal) or lies past the window of its last key.
    const bool run = active && !(p.causal && qp_last < kp0) &&
                     !(p.window > 0 && qp_first > kp0 + 15 + p.window - 1);
    if (run) {
      const bf16* qs = q_s + st * 64 * LD;
      const bf16* dos = do_s + st * 64 * LD;
      const float* lses = lse_s + st * 64;
      const float* dss = d_s + st * 64;
      float s[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries.
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t ak[4], av[4];
        flash::load_a(ak, k_s, LD, w0, kk * 16);
        flash::load_a(av, v_s, LD, w0, kk * 16);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bq[4], bd[4];
          flash::load_b(bq, qs, LD, np * 16, kk * 16);
          flash::load_b(bd, dos, LD, np * 16, kk * 16);
          flash::mma(s[2 * np], ak, bq[0], bq[1]);
          flash::mma(s[2 * np + 1], ak, bq[2], bq[3]);
          flash::mma(dp[2 * np], av, bd[0], bd[1]);
          flash::mma(dp[2 * np + 1], av, bd[2], bd[3]);
        }
      }
      // P^T into dp, dS^T into s.  The softcap and the mask branch once
      // per tile, outside the element loops, as in the dQ pass.
      if (p.softcap > 0.f) {
        const float inv_cap = p.scale / p.softcap;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tl = n * 8 + 2 * gc + (e & 1);
            const float t = tanhf(s[n][e] * inv_cap);
            s[n][e] = t * p.softcap;
            dp[n][e] = (dp[n][e] - dss[tl]) * (1.f - t * t);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tl = n * 8 + 2 * gc + (e & 1);
            s[n][e] *= p.scale;
            dp[n][e] -= dss[tl];
          }
        }
      }
      const bool full = kp0 + 16 <= p.S && t0 + 64 <= p.T &&
                        (!p.causal || qp_first >= kp0 + 15) &&
                        (p.window <= 0 || qp_last < kp0 + p.window);
      if (!full) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tl = n * 8 + 2 * gc + (e & 1);
            const int kp = kp0 + gr + (e >> 1) * 8;
            if (kp >= p.S || t0 + tl >= p.T ||
                !flash::visible(p.causal, p.window, kp, qp_first + tl))
              s[n][e] = -CUDART_INF_F;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tl = n * 8 + 2 * gc + (e & 1);
          const float pr =
              flash::fast_exp2((s[n][e] - lses[tl]) * flash::kLog2e);
          s[n][e] = pr * dp[n][e];
          dp[n][e] = pr;
        }
      }
      // dV += P^T dO and dK += dS^T Q, the queries as the k dimension.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ap[4], as[4];
        flash::c_to_a(ap, dp[2 * kk], dp[2 * kk + 1]);
        flash::c_to_a(as, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bd[4], bq[4];
          flash::load_bt(bd, dos, LD, kk * 16, np * 16);
          flash::load_bt(bq, qs, LD, kk * 16, np * 16);
          flash::mma(dv[2 * np], ap, bd[0], bd[1]);
          flash::mma(dv[2 * np + 1], ap, bd[2], bd[3]);
          flash::mma(dk[2 * np], as, bq[0], bq[1]);
          flash::mma(dk[2 * np + 1], as, bq[2], bq[3]);
        }
      }
    }
  }
  flash::cp_async_wait<0>();

  if (!active) return;
  bf16* dkg = static_cast<bf16*>(p.dk);
  bf16* dvg = static_cast<bf16*>(p.dv);
  const long long part = (long long)p.S * p.H * HD * gridDim.z;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kp0 + gr + r * 8;
    if (kp >= p.S) continue;
    if (p.partial != nullptr) {
      float* krow = p.partial + (((long long)b * p.S + kp) * p.H + h) * HD;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<float2*>(krow + n * 8 + 2 * gc) = make_float2(
            dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
        *reinterpret_cast<float2*>(krow + part + n * 8 + 2 * gc) =
            make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
      }
      continue;
    }
    bf16* krow = dkg + at(p, kDK, b, kp, kvh);
    bf16* vrow = dvg + at(p, kDV, b, kp, kvh);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8 + 2 * gc) = flash::pack_bf16(
          dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(vrow + n * 8 + 2 * gc) =
          flash::pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// dk and dv from the per-query-head shares: for each (b, key, kv head,
// d), the sum over the g heads of the kv head in head order, cast to bf16.
__global__ void __launch_bounds__(256) flash_bwd_sum_heads(const Params p,
                                                           int B) {
  const int g = p.H / p.Hkv, hd = p.hd;
  const long long n = (long long)B * p.S * p.Hkv * hd;
  const long long part = (long long)B * p.S * p.H * hd;
  bf16* dk = static_cast<bf16*>(p.dk);
  bf16* dv = static_cast<bf16*>(p.dv);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int d = i % hd;
    long long rest = i / hd;
    const int kvh = rest % p.Hkv;
    rest /= p.Hkv;
    const int s = rest % p.S, b = rest / p.S;
    const float* src =
        p.partial + (((long long)b * p.S + s) * p.H + kvh * g) * hd + d;
    float sk = 0.f, sv = 0.f;
    for (int gi = 0; gi < g; ++gi) {
      sk += src[gi * hd];
      sv += src[part + gi * hd];
    }
    dk[at(p, kDK, b, s, kvh) + d] = __float2bfloat16(sk);
    dv[at(p, kDV, b, s, kvh) + d] = __float2bfloat16(sv);
  }
}

template <int HD>
cudaError_t launch_tc(const Params& p, int B, cudaStream_t stream) {
  static bool attr_dq = false, attr_dkdv = false;
  cudaError_t e = flash::allow_max_smem(flash_bwd_dq_tc<HD>, attr_dq);
  if (e != cudaSuccess) return e;
  e = flash::allow_max_smem(flash_bwd_dkdv_tc<HD>, attr_dkdv);
  if (e != cudaSuccess) return e;
  const int warps = min(4, (p.T + 15) / 16);
  const int bq = 16 * warps;
  flash_bwd_dq_tc<HD><<<dim3(p.H, (p.T + bq - 1) / bq, B), 32 * warps,
                        dq_smem_bytes<HD>(), stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_tc<HD><<<dim3(p.H, (p.S + kBK - 1) / kBK, B), 128,
                          dkdv_smem_bytes<HD>(), stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.partial == nullptr) return e;
  const long long n = (long long)B * p.S * p.Hkv * HD;
  const long long want = (n + 255) / 256;
  const int blocks = want < 132 * 16 ? (int)want : 132 * 16;
  flash_bwd_sum_heads<<<blocks, 256, 0, stream>>>(p, B);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 (and other bf16 cases) on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kRows = 16;      // query rows of a dQ block
constexpr int kKeys = 16;      // keys of a dK/dV block
constexpr int kTile = 64;      // keys (pass 1) or queries (pass 2) a step

long long simt_dq_floats(int hd) {
  const long long ldh = hd + 1;
  return 2 * kRows * ldh + kRows * hd + 2 * kTile * ldh +
         kRows * (kTile + 1) + 2 * kRows;
}

long long simt_dkdv_floats(int hd) {
  const long long ldh = hd + 1;
  return 2 * kKeys * ldh + 2 * kKeys * hd + 2 * kTile * ldh +
         2 * kKeys * (kTile + 1) + 2 * kTile;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_simt(const Params p) {
  using flash::to_f32;
  const int h = blockIdx.x, b = blockIdx.z, t0 = blockIdx.y * kRows;
  const int kvh = h / (p.H / p.Hkv);
  const int tq = min(kRows, p.T - t0), hd = p.hd, ldh = hd + 1;
  constexpr int lds = kTile + 1;
  const int off = p.S - p.T;
  extern __shared__ float smem[];
  float* q_s = smem;                    // [kRows][ldh]
  float* do_s = q_s + kRows * ldh;      // [kRows][ldh]
  float* dq_s = do_s + kRows * ldh;     // [kRows][hd]
  float* k_s = dq_s + kRows * hd;       // [kTile][ldh]
  float* v_s = k_s + kTile * ldh;       // [kTile][ldh]
  float* ds_s = v_s + kTile * ldh;      // [kRows][lds]
  float* lse_s = ds_s + kRows * lds;    // [kRows]
  float* d_s = lse_s + kRows;           // [kRows]
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  const T* out = static_cast<const T*>(p.out);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  for (int i = threadIdx.x; i < kRows * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const bool ok = r < tq;
    q_s[r * ldh + d] = ok ? to_f32(q[at(p, kQ, b, t0 + r, h) + d]) : 0.f;
    do_s[r * ldh + d] = ok ? to_f32(dout[at(p, kDO, b, t0 + r, h) + d]) : 0.f;
    dq_s[r * hd + d] = 0.f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float part = 0.f;
    if (r < tq)
      for (int d = lane; d < hd; d += 32)
        part += to_f32(dout[at(p, kDO, b, t0 + r, h) + d]) *
                to_f32(out[at(p, kO, b, t0 + r, h) + d]);
    part = flash::warp_sum(part);
    if (lane == 0) {
      const long long row = ((long long)b * p.H + h) * p.T + t0 + r;
      d_s[r] = part;
      lse_s[r] = r < tq ? p.lse[row] : 0.f;
      if (r < tq) p.dsum[row] = part;
    }
  }

  const int q_first = t0 + off, q_last = t0 + tq - 1 + off;
  const int k_end = p.causal ? min(p.S, q_last + 1) : p.S;
  const int k_begin = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  for (int kb = k_begin; kb < k_end; kb += kTile) {
    __syncthreads();
    const int keys = min(kTile, k_end - kb);
    for (int i = threadIdx.x; i < kTile * hd; i += kThreads) {
      const int c = i / hd, d = i % hd;
      const bool ok = c < keys;
      k_s[c * ldh + d] = ok ? to_f32(kg[at(p, kK, b, kb + c, kvh) + d]) : 0.f;
      v_s[c * ldh + d] = ok ? to_f32(vg[at(p, kV, b, kb + c, kvh) + d]) : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      float ds = 0.f;
      if (r < tq && c < keys &&
          flash::visible(p.causal, p.window, kb + c, t0 + r + off)) {
        const float* qr = q_s + r * ldh;
        const float* dr = do_s + r * ldh;
        const float* kr = k_s + c * ldh;
        const float* vr = v_s + c * ldh;
        float dot = 0.f, dpv = 0.f;
        for (int d = 0; d < hd; ++d) {
          dot += qr[d] * kr[d];
          dpv += dr[d] * vr[d];
        }
        float sc = dot * p.scale;
        if (p.softcap > 0.f) sc = tanhf(sc / p.softcap) * p.softcap;
        ds = expf(sc - lse_s[r]) * (dpv - d_s[r]);
        if (p.softcap > 0.f) ds *= 1.f - (sc / p.softcap) * (sc / p.softcap);
      }
      ds_s[r * lds + c] = ds;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const float* dr = ds_s + r * lds;
      float acc = dq_s[r * hd + d];
      for (int c = 0; c < keys; ++c) acc += dr[c] * k_s[c * ldh + d];
      dq_s[r * hd + d] = acc;
    }
  }
  __syncthreads();
  T* dq = static_cast<T*>(p.dq);
  for (int i = threadIdx.x; i < tq * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    dq[at(p, kDQ, b, t0 + r, h) + d] =
        flash::from_f32<T>(dq_s[r * hd + d] * p.scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_simt(const Params p) {
  using flash::to_f32;
  const int kvh = blockIdx.x, b = blockIdx.z, kb = blockIdx.y * kKeys;
  const int keys = min(kKeys, p.S - kb), hd = p.hd, ldh = hd + 1;
  const int g = p.H / p.Hkv, off = p.S - p.T;
  constexpr int lds = kTile + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                    // [kKeys][ldh]
  float* v_s = k_s + kKeys * ldh;       // [kKeys][ldh]
  float* dk_s = v_s + kKeys * ldh;      // [kKeys][hd]
  float* dv_s = dk_s + kKeys * hd;      // [kKeys][hd]
  float* q_s = dv_s + kKeys * hd;       // [kTile][ldh]
  float* do_s = q_s + kTile * ldh;      // [kTile][ldh]
  float* p_s = do_s + kTile * ldh;      // [kKeys][lds]
  float* ds_s = p_s + kKeys * lds;      // [kKeys][lds]
  float* lse_s = ds_s + kKeys * lds;    // [kTile]
  float* d_s = lse_s + kTile;           // [kTile]
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  for (int i = threadIdx.x; i < kKeys * hd; i += kThreads) {
    const int c = i / hd, d = i % hd;
    const bool ok = c < keys;
    k_s[c * ldh + d] = ok ? to_f32(kg[at(p, kK, b, kb + c, kvh) + d]) : 0.f;
    v_s[c * ldh + d] = ok ? to_f32(vg[at(p, kV, b, kb + c, kvh) + d]) : 0.f;
    dk_s[c * hd + d] = dv_s[c * hd + d] = 0.f;
  }
  int t_lo, t_hi;
  query_range(p, kb, kb + keys, t_lo, t_hi);
  for (int gi = 0; gi < g; ++gi) {
    const int h = kvh * g + gi;
    for (int t0 = t_lo; t0 < t_hi; t0 += kTile) {
      const int nq = min(kTile, t_hi - t0);
      __syncthreads();
      for (int i = threadIdx.x; i < kTile * hd; i += kThreads) {
        const int r = i / hd, d = i % hd;
        const bool ok = r < nq;
        q_s[r * ldh + d] = ok ? to_f32(q[at(p, kQ, b, t0 + r, h) + d]) : 0.f;
        do_s[r * ldh + d] =
            ok ? to_f32(dout[at(p, kDO, b, t0 + r, h) + d]) : 0.f;
      }
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const long long row = ((long long)b * p.H + h) * p.T + t0 + r;
        lse_s[r] = r < nq ? p.lse[row] : 0.f;
        d_s[r] = r < nq ? p.dsum[row] : 0.f;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < kKeys * kTile; i += kThreads) {
        const int c = i / kTile, r = i % kTile;
        float pr = 0.f, ds = 0.f;
        if (c < keys && r < nq &&
            flash::visible(p.causal, p.window, kb + c, t0 + r + off)) {
          const float* qr = q_s + r * ldh;
          const float* dr = do_s + r * ldh;
          const float* kr = k_s + c * ldh;
          const float* vr = v_s + c * ldh;
          float dot = 0.f, dpv = 0.f;
          for (int d = 0; d < hd; ++d) {
            dot += qr[d] * kr[d];
            dpv += dr[d] * vr[d];
          }
          float sc = dot * p.scale;
          if (p.softcap > 0.f) sc = tanhf(sc / p.softcap) * p.softcap;
          pr = expf(sc - lse_s[r]);
          ds = pr * (dpv - d_s[r]);
          if (p.softcap > 0.f)
            ds *= 1.f - (sc / p.softcap) * (sc / p.softcap);
        }
        p_s[c * lds + r] = pr;
        ds_s[c * lds + r] = ds;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < kKeys * hd; i += kThreads) {
        const int c = i / hd, d = i % hd;
        const float* pc = p_s + c * lds;
        const float* dc = ds_s + c * lds;
        float av = dv_s[c * hd + d], ak = dk_s[c * hd + d];
        for (int r = 0; r < nq; ++r) {
          av += pc[r] * do_s[r * ldh + d];
          ak += dc[r] * q_s[r * ldh + d];
        }
        dv_s[c * hd + d] = av;
        dk_s[c * hd + d] = ak;
      }
    }
  }
  __syncthreads();
  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
  for (int i = threadIdx.x; i < keys * hd; i += kThreads) {
    const int c = i / hd, d = i % hd;
    dk[at(p, kDK, b, kb + c, kvh) + d] =
        flash::from_f32<T>(dk_s[c * hd + d] * p.scale);
    dv[at(p, kDV, b, kb + c, kvh) + d] = flash::from_f32<T>(dv_s[c * hd + d]);
  }
}

template <typename T>
cudaError_t launch_simt(const Params& p, int B, cudaStream_t stream) {
  const long long s1 = simt_dq_floats(p.hd) * (long long)sizeof(float);
  const long long s2 = simt_dkdv_floats(p.hd) * (long long)sizeof(float);
  if (s1 > flash::kMaxSmemBytes || s2 > flash::kMaxSmemBytes)
    return cudaErrorInvalidValue;
  static bool attr_dq = false, attr_dkdv = false;
  cudaError_t e = flash::allow_max_smem(flash_bwd_dq_simt<T>, attr_dq);
  if (e != cudaSuccess) return e;
  e = flash::allow_max_smem(flash_bwd_dkdv_simt<T>, attr_dkdv);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_simt<T><<<dim3(p.H, (p.T + kRows - 1) / kRows, B), kThreads,
                         s1, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_simt<T><<<dim3(p.Hkv, (p.S + kKeys - 1) / kKeys, B),
                           kThreads, s2, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = CUDA cores, 1 = tensor
// cores (bf16, hd 16/32/64/80/128, every row 16-byte aligned: the wrapper
// checks).  lse: the forward's [B,H,T] f32; dsum: [B,H,T] f32 scratch;
// partial: [2,B,S,H,hd] f32 scratch for the tensor-core route when
// H > Hkv (else null).
// strides: 24 element strides, (batch, sequence, head) of q, k, v, out,
// dout, dq, dk, dv in that order; every head_dim stride is 1.  Launches
// the dQ pass, then the dK/dV pass (then the sum of the heads' shares,
// when partial is given), on `stream`.  Returns a cudaError_t
// (0 = ok).
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, void* partial, int dtype, int route, int B, int T, int S,
    int H, int Hkv, int hd, const long long* strides, int causal, int window, float softcap,
    float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<float*>(dsum);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.partial = static_cast<float*>(partial);
  p.T = T; p.S = S; p.H = H; p.Hkv = Hkv; p.hd = hd;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.causal = causal; p.window = window;
  p.softcap = softcap; p.scale = scale;
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || (H > Hkv) != (partial != nullptr))
      return cudaErrorInvalidValue;
    switch (hd) {
      case 16: return launch_tc<16>(p, B, s);
      case 32: return launch_tc<32>(p, B, s);
      case 64: return launch_tc<64>(p, B, s);
      case 80: return launch_tc<80>(p, B, s);
      case 128: return launch_tc<128>(p, B, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) return launch_simt<float>(p, B, s);
  if (dtype == 1) return launch_simt<bf16>(p, B, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
