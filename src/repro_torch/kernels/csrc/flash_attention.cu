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
// ragged tiles are masked.  When given a buffer, it also writes each
// row's natural log-sum-exp of the scaled scores, lse [B,H,T] f32 (-1e30
// for a row with no visible key), which the backward
// (flash_attention_bwd.cu) reads.
//
// What bounds it on an H100: a query row does 4*hd flops per visible key
// while q, k, v and out move once, so prefills, the encoder and the
// training shape (B=4, T=S=1024) sit far above the card's ~295 flop/byte
// line and are bound by the tensor-core rate (989 TFLOP/s bf16); a read
// with few query rows per kv head (a one-token decode, a cross read at a
// decode step) reads the whole K/V for them and is bound by the memory
// rate (3.35 TB/s).
//
// Three routes (kernels/flash_attention.py `forward_route` picks one and,
// for `split`, its plan: a function of T, S and the window alone, never
// of the batch or the card, so a batch row's sums run in the same order
// alone as in any batch):
//
// * split: bf16 at head_dim 16/32/64/80/128 with 16-byte aligned rows,
//   when the g*T query rows of a kv head fit one 16-row tile (the wave's
//   one-token decode, cross reads at a decode step): `flash_fwd_split`.
//   Bound by bytes: each K/V byte is read once, by one block.  A block
//   per (key split, kv head, b) holds all g*T rows of its kv head; a
//   split is a run of whole 64-key chunks from the first visible key
//   (the window's edge), about 8 runs a row, so the grid grows with S
//   and the card fills at B = 4.  The chunks come by 16-byte cp.async,
//   double-buffered (the next loads while one is multiplied); the four
//   warps take 16 keys of a chunk each (S = Q K^T and O += P V on
//   mma.sync.m16n8k16, ldmatrix operands, P from registers) and are
//   merged in warp order.  Each split leaves its (max, sum, f32
//   accumulator) in a scratch buffer and counts its arrival on its (b,
//   kv head)'s counter; the split that arrives last merges them all in
//   split order and resets the counter to 0: one launch, and the same
//   result whichever split finishes last.  The counters belong to the
//   wrapper, one array per (device, stream).  What holds it back (PERF.md
//   §6): the merge waits for the last split of each row, and a block's
//   chunks stream one after another.
// * wgmma: the rest of bf16 at those head dims (prefills, chunks, the
//   encoder, training): `flash_fwd_wgmma<hd, softcap>`.  Bound by the
//   tensor-core rate, so every product is a wgmma: a block is one
//   consumer warpgroup of 64 query rows of one head and a producer warp;
//   Q comes once by TMA, K/V 64-key tiles through a 3-stage ring on
//   mbarriers (every barrier in dynamic shared memory), by 4-D tensor
//   maps (hd, heads, rows, batch) encoded by the launch, so ring slices
//   are read in place and keys past S arrive as zeros (and are masked);
//   S = Q K^T from shared memory, the online softmax in registers
//   (ex2.approx, masks only on edge tiles and branch-free, the softcap in
//   instances of its own), P packed pair by pair into bf16 A fragments
//   and O += P V with V read MN-major.  hd 80 is a 64-column box at the
//   128-byte swizzle and a 16-column one, O += P V an n64 + n16 pair
//   into one accumulator (flash_tiles.cuh).  The heaviest causal tiles
//   launch first.  One warpgroup a block beat two (which shared the ring)
//   at every shape measured, and the producer warp beat the warpgroup
//   refilling its own ring; issuing the next tile's S under this tile's
//   softmax was slower (PERF.md §6).
// * simt: float32 (and bf16 outside the cases above): `flash_fwd_simt`,
//   the first, CUDA-core design.  f32 FMA, so the f32 checks (1e-4) hold:
//   TF32 keeps ~3 digits.  One block per (q tile, kv head, b) holds the
//   g*block_q rows of the kv head; state in shared memory.
//
// Strided inputs are read in place (a layer's ring slice ring[:, :S] is
// not contiguous over the batch); the head_dim stride must be 1.

#include "flash_common.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"
#include "split_merge.cuh"

#include <type_traits>

namespace {

using flash::bf16;
using flash::kNegInf;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;   // [B,H,T] or null
  // split, n_split > 1: each split's f32 accumulator [16][hd] for
  // [B,Hkv,n_split], then its (max in log2 units, sum) [2][16].
  float* part;
  int* count;   // split, n_split > 1: [B*Hkv] arrivals, 0 between launches
  int T, S, H, Hkv, hd, block_q;
  int k_begin, split_keys, n_split;   // split: the keys [k_begin, S) cut
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  int causal, window;
  float softcap, scale;
};

// ---------------------------------------------------------------------------
// bf16, few query rows per kv head: split-KV, merged in one launch
// ---------------------------------------------------------------------------
namespace split {

constexpr int kRows = 16;                  // g*T query rows: one mma tile
constexpr int kChunk = 64;                 // keys staged at once
constexpr int kWarps = 4;
constexpr int kWarpKeys = kChunk / kWarps;
constexpr int kMaxSplits = 64;

// Q and two K and V chunks (the next loads while one is multiplied).  The
// warps' partials and, in the split that merges, every split's (max, sum)
// and weights [n_split][16] reuse the chunks' room once they are read.
template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int tiles = (kRows + 4 * kChunk) * (HD + 8) * 2;
  constexpr int merge =
      kRows * (HD + 8) * 2 + (3 * kMaxSplits + 2) * kRows * 4;
  return tiles > merge ? tiles : merge;
}

}  // namespace split

template <int HD>
__global__ void __launch_bounds__(128) flash_fwd_split(const Params p) {
  constexpr int kRows = split::kRows, kChunk = split::kChunk;
  constexpr int kWarps = split::kWarps, kWarpKeys = split::kWarpKeys;
  constexpr int LD = HD + 8, KT = HD / 16, NT = HD / 8, CH = HD / 8;
  constexpr int KN = kWarpKeys / 8;
  static_assert(kWarps * kRows * HD * 4 + 2 * kWarps * kRows * 4 <=
                    4 * kChunk * LD * 2,
                "the warps' partials fit the chunks' room");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, gc = lane & 3;
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = p.H / p.Hkv, R = g * p.T;
  const int off = p.S - p.T;   // query t sits at t + off

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [16][LD]
  bf16* k_s = q_s + kRows * LD;                    // [2][kChunk][LD]
  bf16* v_s = k_s + 2 * kChunk * LD;               // [2][kChunk][LD]

  // Row r of the tile is query token r / g of head kvh * g + r % g.
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb;
  for (int i = threadIdx.x; i < kRows * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < R;
    const long long at = ok ? (r / g) * p.q_st + (kvh * g + r % g) * p.q_sh
                            : 0;
    flash::cp_async16(q_s + r * LD + 8 * c, qg + at + 8 * c, ok);
  }
  flash::cp_async_commit();

  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int kb0 = p.k_begin + sp * p.split_keys;
  const int kb1 = min(p.S, kb0 + p.split_keys);
  // The positions of this thread's two rows (a row past R: -1).
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

  // Chunk ci of the split (keys kb0 + 64 ci ..) into buffer ci % 2.
  const int n_chunks = kb1 > kb0 ? (kb1 - kb0 + kChunk - 1) / kChunk : 0;
  auto load_chunk = [&](int ci) {
    const int c0 = kb0 + ci * kChunk, keys = min(kChunk, kb1 - c0);
    bf16* kd = k_s + (ci & 1) * kChunk * LD;
    bf16* vd = v_s + (ci & 1) * kChunk * LD;
    flash::load_rows<HD>(kd, kg + c0 * p.k_ss, p.k_ss, kChunk, keys, p.k);
    flash::load_rows<HD>(vd, vg + c0 * p.v_ss, p.v_ss, kChunk, keys, p.v);
    flash::cp_async_commit();
  };
  if (n_chunks > 0) load_chunk(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = kb0 + ci * kChunk;
    const bf16* kc = k_s + (ci & 1) * kChunk * LD;
    const bf16* vc = v_s + (ci & 1) * kChunk * LD;
    // The next chunk's copies go out before this one's products; the
    // buffer they fill was read in the last iteration, which every warp
    // has left (the barrier at its end).
    if (ci + 1 < n_chunks) {
      load_chunk(ci + 1);
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    if (ci == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        flash::load_a(qf[kk], q_s, LD, 0, kk * 16);
    }
    // This warp's keys: [kw, kw + 16), rows w0 .. of the chunk.
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
      // mask branch once per warp tile.
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
                        (!p.causal || kw + kWarpKeys - 1 <= qp_lo) &&
                        (p.window <= 0 || kw > qp_hi - p.window);
      if (!full) {
#pragma unroll
        for (int n = 0; n < KN; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kw + n * 8 + 2 * gc + (e & 1);
            const int q = qp[e >> 1];
            const bool ok = (kp < kb1) & (!p.causal | (kp <= q)) &
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
  __syncthreads();   // every warp is done with the chunk: reuse its room

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

  bf16* out = static_cast<bf16*>(p.out);
  // Row r's output (and lse) from its accumulator, max (log2) and sum.
  auto store = [&](int r, int c, float acc, float M, float L) {
    const int t = r / g, h = kvh * g + r % g;
    out[b * p.o_sb + t * p.o_st + h * p.o_sh + c] =
        __float2bfloat16(L > 0.f ? acc / L : 0.f);   // no key: zeros
    if (c == 0 && p.lse != nullptr)
      p.lse[((long long)b * p.H + h) * p.T + t] =
          L > 0.f ? (M + log2f(L)) * flash::kLn2 : kNegInf;
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
    if (p.n_split == 1) {
      store(r, c, acc, M, L);
    } else {
      part_o[r * HD + c] = acc;
      if (c == 0) {
        part_ml[(slot + sp) * 2 * kRows + r] = M;
        part_ml[(slot + sp) * 2 * kRows + kRows + r] = L;
      }
    }
  }
  if (p.n_split == 1) return;

  // Count this split in; the last to arrive merges every split's partial
  // in split order (the chunks' room is its scratch) and resets the
  // counter (split_merge.cuh).
  int* count = p.count + b * p.Hkv + kvh;
  if (!splitkv::arrive(count, p.n_split)) return;
  splitkv::merge<HD>(p.part + slot * kRows * HD, part_ml + slot * 2 * kRows,
                     p.n_split, R, kRows, reinterpret_cast<float*>(k_s),
                     count, store);
}

template <int HD>
cudaError_t launch_split(const Params& p, int B, cudaStream_t stream) {
  if (p.n_split < 1 || p.n_split > split::kMaxSplits || p.split_keys <= 0 ||
      p.split_keys % split::kChunk || (p.H / p.Hkv) * p.T > split::kRows ||
      (p.n_split > 1 && (p.part == nullptr || p.count == nullptr)))
    return cudaErrorInvalidValue;
  // The dynamic shared memory it asks for (its static flag counts against
  // the same limit, so not the sm_90 maximum).
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_split<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        split::smem_bytes<HD>());
    if (e != cudaSuccess) return e;
    attr = true;
  }
  flash_fwd_split<HD><<<dim3(p.n_split, p.Hkv, B), split::kWarps * 32,
                        split::smem_bytes<HD>(), stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, many query rows: TMA-fed wgmma tiles
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kStages = 3;   // K/V tiles in the ring

struct Maps {
  tc::OperandMaps q, k, v;
};

// Room to align the tiles to 1024 bytes, the Q tile, the K/V ring, then
// the ring's full and empty barriers and Q's.
template <int HD>
constexpr int smem_bytes() {
  return 1024 + (1 + 2 * kStages) * tc::Tile<HD>::kBytes +
         (2 * kStages + 1) * 8;
}

}  // namespace wg

// One consumer warpgroup of 64 query rows of one head and a producer warp
// that keeps the K/V ring full.
template <int HD, bool CAP>
__global__ void __launch_bounds__(160)
flash_fwd_wgmma(const __grid_constant__ wg::Maps maps, const Params p) {
  using L = tc::Tile<HD>;
  constexpr int ST = wg::kStages, NA = HD / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = tc::aligned_smem(smem_raw);
  unsigned char* ring = q_s + L::kBytes;             // [ST][K, V]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * 2 * L::kBytes);
  uint64_t* empty = full + ST;
  uint64_t* q_bar = empty + ST;

  const int h = blockIdx.x, b = blockIdx.z;
  const int kvh = h / (p.H / p.Hkv);
  const int off = p.S - p.T;   // query t sits at t + off
  // Rows t0 .. t0 + 63, heaviest causal tiles first, and the keys any of
  // them sees, [k_begin, k_end), as n_kt 64-key tiles.
  const int t0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const int q_first = t0 + off, q_last = min(p.T, t0 + 64) - 1 + off;
  const int k_end = p.causal ? min(p.S, q_last + 1) : p.S;
  const int k_begin = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  const int n_kt = k_end > k_begin ? (k_end - k_begin + 63) / 64 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);   // every consumer warp
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  // K/V tile j into slot j % ST.
  auto issue = [&](int j) {
    const int s = j % ST;
    unsigned char* dst = ring + s * 2 * L::kBytes;
    hopper::mbar_arrive_expect_tx(&full[s], 2 * L::kBytes);
    tc::load_tile<HD>(dst, maps.k, kvh, k_begin + 64 * j, b, &full[s]);
    tc::load_tile<HD>(dst + L::kBytes, maps.v, kvh, k_begin + 64 * j, b,
                      &full[s]);
  };
  if (threadIdx.x >= 128) {
    // The producer warp: each tile into a slot every consumer warp has
    // released.
    if (threadIdx.x == 128) {
      for (int j = 0; j < n_kt; ++j) {
        if (j >= ST) hopper::mbar_wait(&empty[j % ST], (j / ST - 1) & 1);
        issue(j);
      }
    }
    return;
  }
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(q_bar, L::kBytes);
    tc::load_tile<HD>(q_s, maps.q, h, t0, b, q_bar);
  }

  // The thread's rows of the accumulators: qr0 and qr0 + 8.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, gc = lane % 4;
  const int qr0 = 16 * warp + gr;
  const float sl2 = p.scale * flash::kLog2e;
  const float inv_cap = CAP ? p.scale / p.softcap : 0.f;
  const float cap2 = p.softcap * flash::kLog2e;
  float o[NA], sa[32];
#pragma unroll
  for (int i = 0; i < NA; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  hopper::mbar_wait(q_bar, 0);
  const uint32_t q_addr = hopper::smem_addr(q_s);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % ST, kb = k_begin + 64 * j;
    const uint32_t k_addr = hopper::smem_addr(ring + s * 2 * L::kBytes);
    const uint32_t v_addr = k_addr + L::kBytes;
    hopper::mbar_wait(&full[s], (j / ST) & 1);
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
    // Scores in log2 units (capped: c tanh(S / c)), -inf where masked:
    // the mask branches once per tile (only tiles on an edge test each
    // element, by selects), the cap once per instance.
    const bool full_tile = kb + 64 <= p.S &&
                           (!p.causal || kb + 63 <= q_first) &&
                           (p.window <= 0 || kb > q_last - p.window);
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
          const int qp = q_first + qr0 + 8 * ((i >> 1) & 1);
          const bool ok = (kp < p.S) & (!p.causal | (kp <= qp)) &
                          ((p.window <= 0) | (kp > qp - p.window));
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
    if (lane == 0) hopper::mbar_arrive(&empty[s]);   // the slot is free
  }

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = flash::quad_sum(l[r]);
    const int t = t0 + qr0 + 8 * r;
    if (t >= p.T) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;   // no key: zeros
    bf16* row = out + b * p.o_sb + t * p.o_st + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * gc) = flash::pack_bf16(
          o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (p.lse != nullptr && gc == 0)
      p.lse[((long long)b * p.H + h) * p.T + t] =
          lsum > 0.f ? (m[r] + log2f(lsum)) * flash::kLn2 : kNegInf;
  }
}

template <int HD, bool CAP>
cudaError_t launch_wgmma(const Params& p, int B, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma<HD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wg::smem_bytes<HD>());
    if (e != cudaSuccess) return e;
    attr = true;
  }
  wg::Maps maps = {};
  const long long qs[3] = {p.q_sb, p.q_st, p.q_sh};
  const long long ks[3] = {p.k_sb, p.k_ss, p.k_sh};
  const long long vs[3] = {p.v_sb, p.v_ss, p.v_sh};
  const int S = max(p.S, 1);   // no key: the maps are never read
  if (!tc::operand_maps<HD>(&maps.q, p.q, B, p.T, p.H, qs) ||
      !tc::operand_maps<HD>(&maps.k, p.k, B, S, p.Hkv, ks) ||
      !tc::operand_maps<HD>(&maps.v, p.v, B, S, p.Hkv, vs))
    return cudaErrorInvalidPitchValue;   // the wrapper copies such operands
  const dim3 grid(p.H, (p.T + 63) / 64, B);
  flash_fwd_wgmma<HD, CAP><<<grid, 160, wg::smem_bytes<HD>(), stream>>>(maps,
                                                                      p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc(const Params& p, int route, int B,
                      cudaStream_t stream) {
  if (route == 1) return launch_split<HD>(p, B, stream);
  return p.softcap > 0.f ? launch_wgmma<HD, true>(p, B, stream)
                         : launch_wgmma<HD, false>(p, B, stream);
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

#define FWD_SMEM_ROWS(HD)                                                  \
  {"flash_fwd_split<" #HD ">", (const void*)flash_fwd_split<HD>,           \
   split::smem_bytes<HD>()},                                               \
  {"flash_fwd_wgmma<" #HD ", false>",                                      \
   (const void*)flash_fwd_wgmma<HD, false>, wg::smem_bytes<HD>()},          \
  {"flash_fwd_wgmma<" #HD ", true>",                                       \
   (const void*)flash_fwd_wgmma<HD, true>, wg::smem_bytes<HD>()}

const hopper::SmemRow kSmemRows[] = {
    FWD_SMEM_ROWS(16), FWD_SMEM_ROWS(32), FWD_SMEM_ROWS(64),
    FWD_SMEM_ROWS(80), FWD_SMEM_ROWS(128),
    {"flash_fwd_simt<float>", (const void*)flash_fwd_simt<float>,
     flash::kMaxSmemBytes},
    {"flash_fwd_simt<bf16>", (const void*)flash_fwd_simt<bf16>,
     flash::kMaxSmemBytes}};

#undef FWD_SMEM_ROWS

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

// The split route's limits the wrapper checks at load: 0 -> query rows a
// block holds, 1 -> keys it stages at once (split_keys is a multiple).
int flash_attention_split_limit(int which) {
  return which == 0 ? split::kRows : split::kChunk;
}

// Instance i's shared memory (hopper::smem_row): 0, -1 past the last.
int flash_attention_smem(int i, const char** name, int* static_bytes,
                         int* dynamic_bytes) {
  return hopper::smem_row(kSmemRows, i, name, static_bytes, dynamic_bytes);
}

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = simt (CUDA cores,
// block_q used), 1 = split (k_begin, split_keys, n_split; part and count
// when n_split > 1), 2 = wgmma; 1 and 2 need bf16, hd 16/32/64/80/128 and
// every row 16-byte aligned (the wrapper checks).  lse: [B,H,T] f32 or
// null.  Strides are in elements; the head_dim stride of q, k, v and out
// must be 1.  Returns a cudaError_t (0 = ok).
int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    void* part, void* count, int dtype, int route, int B, int T, int S,
    int H, int Hkv, int hd, int block_q, int k_begin, int split_keys,
    int n_split, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, int causal, int window, float softcap, float scale,
    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.lse = static_cast<float*>(lse);
  p.part = static_cast<float*>(part);
  p.count = static_cast<int*>(count);
  p.T = T; p.S = S; p.H = H; p.Hkv = Hkv; p.hd = hd; p.block_q = block_q;
  p.k_begin = k_begin; p.split_keys = split_keys; p.n_split = n_split;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.causal = causal; p.window = window;
  p.softcap = softcap; p.scale = scale;
  if (B <= 0 || T <= 0 || H <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1 || route == 2) {
    if (dtype != 1) return cudaErrorInvalidValue;
    switch (hd) {
      case 16: return launch_tc<16>(p, route, B, s);
      case 32: return launch_tc<32>(p, route, B, s);
      case 64: return launch_tc<64>(p, route, B, s);
      case 80: return launch_tc<80>(p, route, B, s);
      case 128: return launch_tc<128>(p, route, B, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (route != 0 || block_q <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_simt<float>(p, B, s);
  if (dtype == 1) return launch_simt<bf16>(p, B, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
