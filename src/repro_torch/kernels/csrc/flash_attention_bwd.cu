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
// with the forward's causal-at-suffix, window, GQA and ragged-edge masks;
// a row with no visible key gets 0.
//
// What bounds it on an H100: five products per visible (query, key) pair
// against q, k, v, out, dout read once and dq, dk, dv written once, so at
// the training shapes (B=4, T=S=1024: smollm's 9/3 heads of 64, zamba2's
// 32/32 of 80) it is bound by the tensor-core rate (989 TFLOP/s bf16).
//
// Design (bf16, head_dim 16/32/64/80/128, 16-byte aligned rows):
// deterministic, two launches, no atomics, no scratch beyond each query
// row's lse and D.  No producer warp: each consumer warpgroup feeds its
// own ring of shared-memory slots by TMA (`cp.async.bulk.tensor.4d` over
// (hd, heads, rows, batch), a box of one head x 64 rows, so a ragged T or
// S arrives zero-filled), its first thread refilling a slot once the
// warpgroup's products on it are done.  Products are `wgmma.mma_async`
// m64nNk16 on 64 x 64 tiles with f32 accumulators in registers; a block
// exits as soon as its tiles are done, so two or three blocks share an SM
// and one's start and end run under another's products.
//   1. dQ pass, one warpgroup per (64 query rows, query head, b),
//      heaviest causal tiles first: computes D and lse (log2) of its rows
//      and writes them, padded to whole 64-row tiles, for pass 2; holds Q
//      and dO, walks the key tiles the rows can see (K, V through its
//      ring of 3 slots, 2 at hd 128): S = Q K^T and dP = dO V^T from
//      shared memory, dS in registers, then dQ += dS K with dS as the
//      register A operand and K read MN-major (the descriptor's transpose
//      bit, no copy).
//   2. dK/dV pass, one block per (64 keys, kv head, b), heaviest first:
//      holds K and V, walks the query tiles of the kv head's g query heads
//      in head order (Q, dO, lse, D through the rings), computing S^T = K
//      Q^T and dP^T = V dO^T with the keys as rows, so P^T and dS^T are the
//      register A operands of dV += P^T dO and dK += dS^T Q (dO and Q
//      MN-major).  dK and dV stay in registers across the g heads: no
//      per-head partial, no third launch.  Under GQA (g > 1: smollm's
//      9/3 heads), where a block's chain of tiles is g x T / 64, two
//      warpgroups take alternate tiles, each its own ring, and their f32
//      shares are summed in a fixed order at the end (warpgroup 0's +
//      warpgroup 1's, through shared memory); with g = 1 (zamba2's
//      32/32) one warpgroup takes them all.
// Seven products per tile pair (S and dP are computed in both passes):
// the price of summing dQ without atomics.  Tiles come as 64-column boxes
// at the 128-byte swizzle, and the rest of head_dim (16 or 32 columns) as
// one box at the 32- or 64-byte swizzle: hd 64 and 128 are one and two
// wide boxes, hd 80 a wide box and 16 columns (the products over N = 80
// are one over each box), hd 16 and 32 the rest alone.  Elementwise work
// runs element by element into the A fragments of the next products:
// exponentials by ex2.approx, the mask branch once per tile (selects on
// edge tiles), the softcap (tanh by ex2.approx) in instances of its own.
// float32, and bf16 outside those cases, runs a CUDA-core instance of the
// same two passes (f32 FMA, no TF32) for the f32 checks, not for speed.

#include "flash_common.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace {

using flash::bf16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;  // [B,H,T]
  // Written by pass 1, read by pass 2: D [B,H,T] on the CUDA cores; on
  // the tensor cores each 64-row query tile's lse (log2 units) and D,
  // [B,H,ceil(T/64)][2][64], 0 past T.
  float* dsum;
  void* dq;
  void* dk;
  void* dv;
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
// bf16 on the tensor cores: TMA + wgmma
// ---------------------------------------------------------------------------
namespace tc {

using namespace ::tc;   // tiles, descriptors, products, TMA: flash_tiles.cuh

constexpr int kWarpgroups = 2;     // per dK/dV block, each its own ring
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kStatsFloats = 2 * kRows;  // a query tile's lse (log2) and D

struct Maps {
  OperandMaps q, k, v, dout;
};

// Shared memory of a pass: two fixed tiles, each warpgroup's ring of
// two-tile slots, the dK/dV pass's row statistics per slot, and room to
// align the tiles to 1024 bytes.
template <int HD>
constexpr int dq_smem_bytes() {
  using L = Tile<HD>;
  return 2 * L::kBytes + L::kSlots * 2 * L::kBytes + 1024;
}

template <int HD>
constexpr int dkdv_smem_bytes(int warpgroups) {
  using L = Tile<HD>;
  return 2 * L::kBytes + warpgroups * L::kSlots * 2 * L::kBytes +
         warpgroups * L::kSlots * kStatsFloats * 4 + 1024;
}

// The two warpgroups' f32 shares of an accumulator are summed in a fixed
// order (warpgroup 0's + warpgroup 1's): warpgroup 1 leaves its registers
// in shared memory (its own ring, free once its tiles are done), and after
// a barrier warpgroup 0 adds them.
template <int N>
__device__ __forceinline__ void put(const float (&acc)[N], float* red,
                                    int tid) {
#pragma unroll
  for (int i = 0; i < N; ++i) red[i * 128 + tid] = acc[i];
}

template <int N>
__device__ __forceinline__ void add(float (&acc)[N], const float* red,
                                    int tid) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += red[i * 128 + tid];
}

// Store rows r0 (and r0 + 8) of a [64][HD] accumulator times `mul` as
// bf16 rows of `dst` (row r at dst + r * stride), rows < valid only.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2],
                                           bf16* dst, long long stride,
                                           int r0, int valid, float mul) {
  const int gc = threadIdx.x % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= valid) continue;
    bf16* row = dst + r * stride;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * gc) = flash::pack_bf16(
          acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

}  // namespace tc

// Pass 1: dQ, and each query row's statistics for pass 2: one warpgroup
// a block, which walks every key tile its rows see, so that two to three
// blocks share an SM and one's start and end run under another's
// products.  CAP: the scores carry a tanh softcap (an instance of its
// own, so the common case holds no registers for it).
template <int HD, bool CAP>
__global__ void __launch_bounds__(128)
flash_bwd_dq_wgmma(const __grid_constant__ tc::Maps maps, const Params p) {
  using L = tc::Tile<HD>;
  constexpr int SL = L::kSlots, NA = HD / 2;
  __shared__ __align__(8) uint64_t fixed_bar;
  __shared__ __align__(8) uint64_t full[SL];
  __shared__ float lse_s[tc::kRows], d_s[tc::kRows];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = tc::aligned_smem(smem_raw);
  unsigned char* do_s = q_s + L::kBytes;
  unsigned char* ring = do_s + L::kBytes;   // [slot][K, V]

  const int h = blockIdx.x, b = blockIdx.z;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * tc::kRows;  // heaviest first
  const int kvh = h / (p.H / p.Hkv);
  const int tq = min(tc::kRows, p.T - t0);
  const int off = p.S - p.T;
  const int q_first = t0 + off, q_last = t0 + tq - 1 + off;
  const int k_end = p.causal ? min(p.S, q_last + 1) : p.S;
  const int k_begin = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  const int n_kt = k_end > k_begin ? (k_end - k_begin + 63) / 64 : 0;

  // Key tile k into slot k % SL.
  auto issue = [&](int k) {
    const int s = k % SL, kb = k_begin + k * 64;
    uint64_t* bar = &full[s];
    unsigned char* dst = ring + s * 2 * L::kBytes;
    hopper::mbar_arrive_expect_tx(bar, 2 * L::kBytes);
    tc::load_tile<HD>(dst, maps.k, kvh, kb, b, bar);
    tc::load_tile<HD>(dst + L::kBytes, maps.v, kvh, kb, b, bar);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(&fixed_bar, 1);
    for (int s = 0; s < SL; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_kt > 0) {
    hopper::mbar_arrive_expect_tx(&fixed_bar, 2 * L::kBytes);
    tc::load_tile<HD>(q_s, maps.q, h, t0, b, &fixed_bar);
    tc::load_tile<HD>(do_s, maps.dout, h, t0, b, &fixed_bar);
    for (int k = 0; k < min(SL, n_kt); ++k) issue(k);
  }

  // D = rowsum(dout * out) and lse (log2 units) of the 64 rows; 0 for
  // rows past T (their q and dout arrive as zeros, so their dS is 0).
  // Every thread takes 16-byte chunks of the rows, all loads in flight at
  // once; each row's chunks are then summed in chunk order.  Pass 2 reads
  // both per query tile: stats [B,H,T/64][2][64].
  constexpr int CH = HD / 8, NC = tc::kRows * CH;
  __shared__ float part_s[NC];
  const long long bh = (long long)b * p.H + h;
#pragma unroll
  for (int j = 0; j < (NC + 127) / 128; ++j) {
    const int i = threadIdx.x + j * 128, r = i / CH, t = t0 + r;
    if (i >= NC) break;
    float part = 0.f;
    if (t < p.T) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(p.out) + at(p, kO, b, t, h) + 8 * (i % CH));
      const uint4 y = *reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(p.dout) + at(p, kDO, b, t, h) +
          8 * (i % CH));
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
        const float2 c = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
        part += a.x * c.x + a.y * c.y;
      }
    }
    part_s[i] = part;
  }
  __syncthreads();
  if (threadIdx.x < tc::kRows) {
    const int r = threadIdx.x, t = t0 + r;
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) d += part_s[r * CH + c];
    const float l = t < p.T ? p.lse[bh * p.T + t] * flash::kLog2e : 0.f;
    d_s[r] = d;
    lse_s[r] = l;
    float* rec = p.dsum + (bh * gridDim.y + t0 / tc::kRows) * tc::kStatsFloats;
    rec[r] = l;
    rec[tc::kRows + r] = d;
  }
  __syncthreads();

  // This thread's rows of the accumulators: qr0 and qr0 + 8.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, gc = lane % 4;
  const int qr0 = 16 * (warp % 4) + gr;
  const float lse_r[2] = {lse_s[qr0], lse_s[qr0 + 8]};
  const float d_r[2] = {d_s[qr0], d_s[qr0 + 8]};
  const float sl2 = p.scale * flash::kLog2e;
  const float inv_cap = CAP ? p.scale / p.softcap : 0.f;
  const float cap2 = p.softcap * flash::kLog2e;

  float dq[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dq[i] = 0.f;
  if (n_kt > 0) hopper::mbar_wait(&fixed_bar, 0);
  const uint32_t q_addr = hopper::smem_addr(q_s);
  const uint32_t do_addr = hopper::smem_addr(do_s);
  float sa[32], pa[32];   // S; dP
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = pa[i] = 0.f;

  for (int k = 0; k < n_kt; ++k) {
    const int s = k % SL, kb = k_begin + k * 64;
    const uint32_t k_addr = hopper::smem_addr(ring + s * 2 * L::kBytes);
    const uint32_t v_addr = k_addr + L::kBytes;
    hopper::mbar_wait(&full[s], (k / SL) & 1);
    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each.
    hopper::fence_acc(sa);
    hopper::fence_acc(pa);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::Wgmma<64>::ss<0>(sa, tc::desc_k<HD>(q_addr, kk),
                               tc::desc_k<HD>(k_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::Wgmma<64>::ss<0>(pa, tc::desc_k<HD>(do_addr, kk),
                               tc::desc_k<HD>(v_addr, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(sa);
    hopper::fence_acc(pa);
    // dS element by element: the score in log2 units (capped: c tanh(S /
    // c), and dP - D times the cap's derivative 1 - tanh^2), -inf where
    // masked, dS = exp2(S - lse) (dP - D).  The mask branches once per
    // tile (only tiles on an edge test each element), the cap once per
    // instance.
    const bool full_tile = kb + 64 <= p.S &&
                           (!p.causal || kb + 63 <= q_first) &&
                           (p.window <= 0 || kb > q_last - p.window);
    uint32_t df[4][4];
    auto ds_rows = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x, dp = pa[i + e] - d_r[r];
          if constexpr (CAP) {
            const float t = tc::fast_tanh(sa[i + e] * inv_cap);
            x = t * cap2;
            dp *= 1.f - t * t;
          } else {
            x = sa[i + e] * sl2;
          }
          if constexpr (decltype(masked)::value) {
            // Bitwise tests: selects, no branch per element.
            const int kp = kb + 8 * (i >> 2) + 2 * gc + e;
            const int qp = q_first + qr0 + 8 * r;
            const bool ok = (kp < p.S) & (!p.causal | (kp <= qp)) &
                            ((p.window <= 0) | (kp > qp - p.window));
            x = ok ? x : -CUDART_INF_F;
          }
          ds[e] = flash::fast_exp2(x - lse_r[r]) * dp;
        }
        // dS straight into the A fragment of dQ's product.
        df[i / 8][(i % 8) / 2] = flash::pack_bf16(ds[0], ds[1]);
      }
    };
    if (full_tile)
      ds_rows(std::false_type{});
    else
      ds_rows(std::true_type{});
    // dQ += dS K: dS from registers, K MN-major (trans-b).
    hopper::fence_acc(dq);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::mma_mn<HD>(dq, df[kk], k_addr, kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(dq);
    // The slot's products are done in every warp: refill it.
    __syncthreads();
    if (threadIdx.x == 0 && k + SL < n_kt) issue(k + SL);
  }

  tc::store_rows<HD>(dq, static_cast<bf16*>(p.dq) + at(p, kDQ, b, t0, h),
                     p.st[kDQ][1], qr0, tq, p.scale);
}

// Pass 2: dK and dV of 64 keys of one kv head, summed over its g query
// heads and every query tile that sees the keys, by one or two
// warpgroups (blockDim.x / 128: the launch picks, see launch_tc).
template <int HD, bool CAP>
__global__ void __launch_bounds__(tc::kThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ tc::Maps maps,
                     const Params p) {
  using L = tc::Tile<HD>;
  constexpr int SL = L::kSlots, NA = HD / 2;
  __shared__ __align__(8) uint64_t fixed_bar;
  __shared__ __align__(8) uint64_t full[tc::kWarpgroups][SL];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = tc::aligned_smem(smem_raw);
  unsigned char* v_s = k_s + L::kBytes;
  const int NW = blockDim.x / 128;
  unsigned char* ring = v_s + L::kBytes;   // [wg][slot][Q, dO]
  float* stats_s = reinterpret_cast<float*>(
      ring + NW * SL * 2 * L::kBytes);     // [wg][slot][2][64]

  const int kvh = blockIdx.x, b = blockIdx.z;
  const int kb = blockIdx.y * tc::kRows;  // causal: the first are heaviest
  const int keys = min(tc::kRows, p.S - kb);
  const int g = p.H / p.Hkv, off = p.S - p.T;
  const int nqt = (p.T + tc::kRows - 1) / tc::kRows;
  int t_lo, t_hi;
  query_range(p, kb, kb + keys, t_lo, t_hi);
  const int qi_lo = t_lo / tc::kRows;
  const int n_it = t_hi > t_lo ? (t_hi + tc::kRows - 1) / tc::kRows - qi_lo
                               : 0;
  // The (query head, query tile) pairs in head order; warpgroup wg takes
  // pairs wg, wg + NW, ...
  const int n_tiles = g * n_it;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n_mine = (n_tiles - wg + NW - 1) / NW;

  auto issue = [&](int k) {
    const int n = wg + NW * k, s = k % SL;
    const int h = kvh * g + n / n_it, t0 = (qi_lo + n % n_it) * tc::kRows;
    uint64_t* bar = &full[wg][s];
    unsigned char* dst = ring + (wg * SL + s) * 2 * L::kBytes;
    hopper::mbar_arrive_expect_tx(bar,
                                  2 * L::kBytes + tc::kStatsFloats * 4);
    tc::load_tile<HD>(dst, maps.q, h, t0, b, bar);
    tc::load_tile<HD>(dst + L::kBytes, maps.dout, h, t0, b, bar);
    hopper::bulk_copy(
        stats_s + (wg * SL + s) * tc::kStatsFloats,
        p.dsum + (((long long)b * p.H + h) * nqt + t0 / tc::kRows) *
                     tc::kStatsFloats,
        tc::kStatsFloats * 4, bar);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(&fixed_bar, 1);
    for (int w = 0; w < tc::kWarpgroups; ++w)
      for (int s = 0; s < SL; ++s) hopper::mbar_init(&full[w][s], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    hopper::mbar_arrive_expect_tx(&fixed_bar, 2 * L::kBytes);
    tc::load_tile<HD>(k_s, maps.k, kvh, kb, b, &fixed_bar);
    tc::load_tile<HD>(v_s, maps.v, kvh, kb, b, &fixed_bar);
  }
  if (tid == 0)
    for (int k = 0; k < min(SL, n_mine); ++k) issue(k);

  // This thread's keys: kr0 and kr0 + 8 of the tile; its queries of a
  // tile: columns 8 j + 2 gc (+ 1).
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, gc = lane % 4;
  const int kr0 = 16 * (warp % 4) + gr;
  const float sl2 = p.scale * flash::kLog2e;
  const float inv_cap = CAP ? p.scale / p.softcap : 0.f;
  const float cap2 = p.softcap * flash::kLog2e;
  float dk[NA], dv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;
  // A block exits only when its copies have landed: warpgroup 0 waits
  // for the fixed tiles whenever they were loaded.
  if (n_mine > 0) hopper::mbar_wait(&fixed_bar, 0);
  const uint32_t k_addr = hopper::smem_addr(k_s);
  const uint32_t v_addr = hopper::smem_addr(v_s);
  float sa[32], pa[32];   // S^T; dP^T
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = pa[i] = 0.f;

  for (int k = 0; k < n_mine; ++k) {
    const int n = wg + NW * k, s = k % SL;
    const int t0 = (qi_lo + n % n_it) * tc::kRows;
    const uint32_t q_addr =
        hopper::smem_addr(ring + (wg * SL + s) * 2 * L::kBytes);
    const uint32_t do_addr = q_addr + L::kBytes;
    hopper::mbar_wait(&full[wg][s], (k / SL) & 1);
    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each.
    hopper::fence_acc(sa);
    hopper::fence_acc(pa);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::Wgmma<64>::ss<0>(sa, tc::desc_k<HD>(k_addr, kk),
                               tc::desc_k<HD>(q_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::Wgmma<64>::ss<0>(pa, tc::desc_k<HD>(v_addr, kk),
                               tc::desc_k<HD>(do_addr, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(sa);
    hopper::fence_acc(pa);
    // P^T and dS^T, as in pass 1 with the queries as columns (their lse
    // and D come with the tile), element by element in pairs packed
    // straight into the A fragments of dV's and dK's products.  Registers
    // i, i + 1 (i even) hold columns 8 (i / 4) + 2 gc (+ 1): one float2 of
    // lse and of D each.
    const float* lse_t = stats_s + (wg * SL + s) * tc::kStatsFloats;
    const float* d_t = lse_t + tc::kRows;
    const int qp0 = t0 + off;
    const bool full_tile = kb + 64 <= p.S && t0 + 64 <= p.T &&
                           (!p.causal || qp0 >= kb + 63) &&
                           (p.window <= 0 || qp0 + 63 < kb + p.window);
    uint32_t pf[4][4], df[4][4];
    auto p_ds = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = 8 * (i >> 2) + 2 * gc;
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 dd = *reinterpret_cast<const float2*>(d_t + col);
        float pr[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x, dp = pa[i + e] - (e ? dd.y : dd.x);
          if constexpr (CAP) {
            const float t = tc::fast_tanh(sa[i + e] * inv_cap);
            x = t * cap2;
            dp *= 1.f - t * t;
          } else {
            x = sa[i + e] * sl2;
          }
          if constexpr (decltype(masked)::value) {
            const int tl = col + e;
            const int kp = kb + kr0 + 8 * ((i >> 1) & 1), qp = qp0 + tl;
            const bool ok = (kp < p.S) & (t0 + tl < p.T) &
                            (!p.causal | (kp <= qp)) &
                            ((p.window <= 0) | (kp > qp - p.window));
            x = ok ? x : -CUDART_INF_F;
          }
          pr[e] = flash::fast_exp2(x - (e ? lse2.y : lse2.x));
          ds[e] = pr[e] * dp;
        }
        pf[i / 8][(i % 8) / 2] = flash::pack_bf16(pr[0], pr[1]);
        df[i / 8][(i % 8) / 2] = flash::pack_bf16(ds[0], ds[1]);
      }
    };
    if (full_tile)
      p_ds(std::false_type{});
    else
      p_ds(std::true_type{});
    // dV += P^T dO and dK += dS^T Q: the queries as k, A from registers,
    // dO and Q MN-major (trans-b).
    hopper::fence_acc(dv);
    hopper::fence_acc(dk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::mma_mn<HD>(dv, pf[kk], do_addr, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::mma_mn<HD>(dk, df[kk], q_addr, kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(dv);
    hopper::fence_acc(dk);
    tc::warpgroup_sync(wg);
    if (tid == 0 && k + SL < n_mine) issue(k + SL);
  }

  if (NW == 2) {
    float* red = reinterpret_cast<float*>(ring + SL * 2 * L::kBytes);
    if (wg == 1) {
      tc::put(dk, red, tid);
      tc::put(dv, red + NA * 128, tid);
    }
    __syncthreads();
    if (wg == 1) return;
    tc::add(dk, red, tid);
    tc::add(dv, red + NA * 128, tid);
  }
  tc::store_rows<HD>(dk, static_cast<bf16*>(p.dk) + at(p, kDK, b, kb, kvh),
                     p.st[kDK][1], kr0, keys, p.scale);
  tc::store_rows<HD>(dv, static_cast<bf16*>(p.dv) + at(p, kDV, b, kb, kvh),
                     p.st[kDV][1], kr0, keys, 1.f);
}

template <int HD, bool CAP>
cudaError_t launch_tc(const Params& p, int B, cudaStream_t stream) {
  constexpr int dq_smem = tc::dq_smem_bytes<HD>();
  constexpr int dkdv_smem = tc::dkdv_smem_bytes<HD>(tc::kWarpgroups);
  static_assert(dkdv_smem <= flash::kMaxSmemBytes, "exceeds shared memory");
  // The dynamic shared memory each pass asks for (their static barriers
  // count against the same limit, so not the sm_90 maximum).
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_wgmma<HD, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<HD, CAP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkdv_smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  // A stride TMA cannot take (the wrapper copies such operands first).
  tc::Maps maps = {};
  if (!tc::operand_maps<HD>(&maps.q, p.q, B, p.T, p.H, p.st[kQ]) ||
      !tc::operand_maps<HD>(&maps.k, p.k, B, p.S, p.Hkv, p.st[kK]) ||
      !tc::operand_maps<HD>(&maps.v, p.v, B, p.S, p.Hkv, p.st[kV]) ||
      !tc::operand_maps<HD>(&maps.dout, p.dout, B, p.T, p.H, p.st[kDO]))
    return cudaErrorInvalidPitchValue;
  const int nqt = (p.T + tc::kRows - 1) / tc::kRows;
  const int nkt = (p.S + tc::kRows - 1) / tc::kRows;
  // The dK/dV pass's warpgroups a block.  A block walks the query tiles
  // of its kv head's g query heads in series, g times as many under GQA
  // as without; two warpgroups halve that chain and share the block's K
  // and V, one lets two blocks share an SM, so that one's start and end
  // run under the other's products.  Two when g > 1, one when g = 1 (on
  // an H100 at B=4, T=S=1024: smollm's 9/3 heads take 0.079 ms with two,
  // 0.093 with one; zamba2's 32/32 0.270 with one, 0.304 with two;
  // PERF.md §6).  The choice, and with it the order of the f32 sums,
  // depends on g alone: not on the batch or the card.
  const int nw = p.H / p.Hkv > 1 ? tc::kWarpgroups : 1;
  flash_bwd_dq_wgmma<HD, CAP><<<dim3(p.H, nqt, B), 128, dq_smem, stream>>>(
      maps, p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_wgmma<HD, CAP><<<dim3(p.Hkv, nkt, B), 128 * nw,
                                  tc::dkdv_smem_bytes<HD>(nw),
                             stream>>>(maps, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc(const Params& p, int B, cudaStream_t stream) {
  return p.softcap > 0.f ? launch_tc<HD, true>(p, B, stream)
                         : launch_tc<HD, false>(p, B, stream);
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

#define BWD_SMEM_ROWS(HD)                                                  \
  {"flash_bwd_dq_wgmma<" #HD ", false>",                                   \
   (const void*)flash_bwd_dq_wgmma<HD, false>, tc::dq_smem_bytes<HD>()},    \
  {"flash_bwd_dq_wgmma<" #HD ", true>",                                    \
   (const void*)flash_bwd_dq_wgmma<HD, true>, tc::dq_smem_bytes<HD>()},     \
  {"flash_bwd_dkdv_wgmma<" #HD ", false>",                                 \
   (const void*)flash_bwd_dkdv_wgmma<HD, false>,                           \
   tc::dkdv_smem_bytes<HD>(tc::kWarpgroups)},                              \
  {"flash_bwd_dkdv_wgmma<" #HD ", true>",                                  \
   (const void*)flash_bwd_dkdv_wgmma<HD, true>,                            \
   tc::dkdv_smem_bytes<HD>(tc::kWarpgroups)}

// The dK/dV pass at its most warpgroups a block (its launches ask for one
// or two).
const hopper::SmemRow kSmemRows[] = {
    BWD_SMEM_ROWS(16), BWD_SMEM_ROWS(32), BWD_SMEM_ROWS(64),
    BWD_SMEM_ROWS(80), BWD_SMEM_ROWS(128),
    {"flash_bwd_dq_simt<float>", (const void*)flash_bwd_dq_simt<float>,
     flash::kMaxSmemBytes},
    {"flash_bwd_dkdv_simt<float>", (const void*)flash_bwd_dkdv_simt<float>,
     flash::kMaxSmemBytes},
    {"flash_bwd_dq_simt<bf16>", (const void*)flash_bwd_dq_simt<bf16>,
     flash::kMaxSmemBytes},
    {"flash_bwd_dkdv_simt<bf16>", (const void*)flash_bwd_dkdv_simt<bf16>,
     flash::kMaxSmemBytes}};

#undef BWD_SMEM_ROWS

}  // namespace

extern "C" {

// Instance i's shared memory (hopper::smem_row): 0, -1 past the last.
int flash_attention_bwd_smem(int i, const char** name, int* static_bytes,
                             int* dynamic_bytes) {
  return hopper::smem_row(kSmemRows, i, name, static_bytes, dynamic_bytes);
}

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = CUDA cores, 1 = tensor
// cores (bf16, hd 16/32/64/80/128, every row 16-byte aligned: the wrapper
// checks).  lse: the forward's [B,H,T] f32; dsum: f32 scratch, [B,H,T]
// on the CUDA cores, [B,H,ceil(T/64),2,64] on the tensor cores.
// strides: 24 element strides, (batch, sequence, head) of q, k, v, out,
// dout, dq, dk, dv in that order; every head_dim stride is 1.  Launches
// the dQ pass, then the dK/dV pass, on `stream`.  Returns a cudaError_t
// (0 = ok).
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, int dtype, int route, int B, int T, int S, int H, int Hkv,
    int hd, const long long* strides, int causal, int window, float softcap,
    float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<float*>(dsum);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.T = T; p.S = S; p.H = H; p.Hkv = Hkv; p.hd = hd;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.causal = causal; p.window = window;
  p.softcap = softcap; p.scale = scale;
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0) return cudaSuccess;
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
  if (dtype == 0) return launch_simt<float>(p, B, s);
  if (dtype == 1) return launch_simt<bf16>(p, B, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
