// NBB ring matmul for Hopper (sm_90a), CUDA C++ with a plain C entry point.
//
// Replaces the TPU kernel of the JAX package: `nbb_matmul`
// (src/repro/kernels/nbb_matmul.py:84), whose body `_nbb_matmul_kernel`
// (:33) runs under the `pl.pallas_call` at :96.  Same contract: C[M,N] =
// A[M,K] @ B[K,N] with a float32 accumulator, written in A's dtype
// (float32 or bfloat16); A and B are row-major and contiguous.
//
// The point of the kernel is the paper's NBB ring (Kim'07), made explicit.
// Each block owns one output tile and walks K in steps through a ring of
// S slots in shared memory, each slot holding one K step of A and of B:
//
//   producer (one thread of the last warp, the copy side): for K tile k it
//     waits on slot k % S's *empty* mbarrier -- the consumers' acknowledge
//     counter -- arms the slot's *full* mbarrier with the tile's byte count,
//     and asks the copy engine for the tile; the engine's completion of
//     those bytes is the update counter.
//   consumers (the first warps, the math side): for K tile k they wait on
//     slot k % S's *full* mbarrier -- on data readiness only, never on a
//     lock -- multiply the slot, and arrive on its *empty* mbarrier once
//     their products have read it.
//
// The NBB counters, update u (tiles the producer has started) and
// acknowledge a (tiles the consumers have released), name the slots as
// u mod S and a mod S; the TPU kernel's 2-slot ring (nbb_matmul.py:54-76)
// is S = 2, where mod 2 is the one-ahead alternation.  With S slots the
// producer may run S - 1 tiles ahead, and it never overwrites a slot the
// consumers hold: it fills slot s for round r = k / S only after the
// consumers' release of round r - 1 of that slot.  An mbarrier counts its
// completed phases, so a slot's barriers complete once per round: a
// waiter for round r of the *full* barrier asks for phase parity r & 1;
// the producer, for round r >= 1, asks the *empty* barrier for the
// parity of round r - 1, (r - 1) & 1, and does not wait in round 0 (the
// ring starts empty).  For S = 2 this is the 2-slot rule (k / 2) % 2.
//
// Three instances (kTiles; the wrapper picks one by dtype and shape):
//
// * 1 and 2, bfloat16, on the tensor cores: the tiles come by TMA
//   (`cp.async.bulk.tensor.2d`, tensor maps from cuTensorMapEncodeTiled,
//   reached through cudaGetDriverEntryPoint so this nvcc build links no
//   libcuda), 128-byte swizzled, K steps of 64 (one 128-byte row of
//   bf16).  A [M,K] arrives K-major, B [K,N] N-major in boxes of 64
//   columns; `wgmma.mma_async.m64nNk16` reads both from the slot through
//   matrix descriptors (B through the descriptor's transpose bit: an
//   MN-major operand, no copy) into an f32 accumulator in registers.  One
//   consumer warpgroup per 64 rows of the tile; a warpgroup releases a
//   slot when its next tile's products are issued and the slot's have
//   finished (wgmma.wait_group 1).  TMA's out-of-bounds zero fill takes
//   the ragged edges of M, N and K; the epilogue stores only rows < M and
//   columns < N.  Instance 1 (64 x 64 tiles, one consumer warpgroup)
//   serves shapes whose 128 x 128 tiling would leave the card's SMs idle
//   (512 x 1024 x 512 gives 64 blocks); instance 2 (128 x 128, two
//   consumer warpgroups) the large ones.
// * 0, float32, on the CUDA cores: the first design.  64 x 64 tiles, K steps
//   of 32, 2 slots filled row by row with `cp.async.bulk`; f32 FMA, since
//   TF32 would break the reference's 2e-5 float32 tolerance at K = 384.
//
// What bounds it on an H100: a large product (the 4096^3 timing shape) is
// far above the ~295 flop/byte line, so the bound is the tensor-core rate
// (989 TFLOP/s bf16).  512 x 1024 x 512 is latency-bound: 16 K steps in
// series per block.  Results are bit-identical from call to call: no
// split over K, each output summed in one fixed order.
//
// The copies need 16-byte aligned bases and rows: the base pointers,
// K * sizeof(T) and N * sizeof(T) must be multiples of 16 (the wrapper
// checks; this entry point refuses).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

struct Tile {
  int m, n, k, slots;
};
// instance: {tile M, tile N, K step, ring slots}
constexpr Tile kTiles[3] = {
    {64, 64, 32, 2},    // 0: float32, CUDA cores
    {64, 64, 64, 4},    // 1: bfloat16, wgmma, one consumer warpgroup
    {128, 128, 64, 3},  // 2: bfloat16, wgmma, two consumer warpgroups
};
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int slots, uint32_t consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&full[s], 1);            // the producer's arrive
      mbar_init(&empty[s], consumers);   // one arrive per consumer
    }
    mbar_init_fence();
  }
  __syncthreads();
  // No block-wide barrier past this point: the two roles run apart.
}

// ---------------------------------------------------------------------------
// Instance 0: float32 on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kSimtM = kTiles[0].m, kSimtN = kTiles[0].n;
constexpr int kSimtK = kTiles[0].k, kSimtSlots = kTiles[0].slots;
constexpr int kSimtConsumerWarps = 8;
constexpr int kSimtThreads = kSimtConsumerWarps * 32 + 32;  // + producer
// Leading dimensions of the ring's tiles, in floats.  An A row is padded
// by 16 bytes so the consumers' column reads of neighbouring rows fall in
// different banks; every row start stays 16-byte aligned for the copies.
constexpr int kSimtLda = kSimtK + 4;
constexpr int kSimtLdb = kSimtN;
constexpr int kSimtASlot = kSimtM * kSimtLda;
constexpr int kSimtBSlot = kSimtK * kSimtLdb;

__global__ void __launch_bounds__(kSimtThreads)
nbb_simt_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(128) float a_ring[kSimtSlots * kSimtASlot];
  __shared__ __align__(128) float b_ring[kSimtSlots * kSimtBSlot];
  __shared__ __align__(8) uint64_t full[kSimtSlots];
  __shared__ __align__(8) uint64_t empty[kSimtSlots];

  const int m0 = blockIdx.y * kSimtM;
  const int n0 = blockIdx.x * kSimtN;
  const int m_valid = min(kSimtM, M - m0);
  const int n_valid = min(kSimtN, N - n0);
  const int n_k = (K + kSimtK - 1) / kSimtK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring(full, empty, kSimtSlots, kSimtConsumerWarps);

  if (warp == kSimtConsumerWarps) {
    // Producer: the copy side of the ring, one bulk copy per tile row.
    // Ragged edges by bounds: rows past M or K are not copied, a row's
    // copy is cut at K or N.
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kSimtSlots, r = kt / kSimtSlots;
      if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
      const int k0 = kt * kSimtK;
      const int k_valid = min(kSimtK, K - k0);
      const uint32_t a_row = k_valid * sizeof(float);
      const uint32_t b_row = n_valid * sizeof(float);
      if (lane == 0)
        mbar_arrive_expect_tx(&full[s], m_valid * a_row + k_valid * b_row);
      __syncwarp();   // armed before any copy can complete
      float* a_dst = a_ring + s * kSimtASlot;
      float* b_dst = b_ring + s * kSimtBSlot;
      for (int r2 = lane; r2 < m_valid; r2 += 32)
        bulk_copy(a_dst + r2 * kSimtLda, a + (long long)(m0 + r2) * K + k0,
                  a_row, &full[s]);
      for (int r2 = lane; r2 < k_valid; r2 += 32)
        bulk_copy(b_dst + r2 * kSimtLdb, b + (long long)(k0 + r2) * N + n0,
                  b_row, &full[s]);
    }
    return;
  }

  // Consumers: thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j.
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kSimtSlots;
    mbar_wait(&full[s], (kt / kSimtSlots) & 1);
    const int k_valid = min(kSimtK, K - kt * kSimtK);
    const float* as = a_ring + s * kSimtASlot;
    const float* bs = b_ring + s * kSimtBSlot;
    // The tile's partial sums first, then one add into the accumulator:
    // shorter running sums, less rounding at large K.
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
    for (int kk = 0; kk < k_valid; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[(ty + 16 * i) * kSimtLda + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk * kSimtLdb + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncwarp();                        // every lane has read the slot
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= m_valid) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      if (col < n_valid) c[(long long)(m0 + r) * N + n0 + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// Instances 1 and 2: bfloat16 on the tensor cores (TMA + wgmma)
// ---------------------------------------------------------------------------
constexpr int kBK = 64;      // K step: one 128-byte swizzle row of bf16
constexpr int kBoxN = 64;    // B arrives in boxes of 64 columns (128 bytes)
constexpr int kBoxBytes = kBK * kBoxN * 2;

template <int BM, int BN, int S>
struct WgmmaRing {
  static constexpr int consumers = BM / 64;          // warpgroups
  static constexpr int threads = consumers * 128 + 32;
  static constexpr int a_bytes = BM * kBK * 2;       // one slot of A
  static constexpr int b_bytes = kBK * BN * 2;       // one slot of B
  // The slots, plus room to align the ring to 1024 bytes (the 128-byte
  // swizzle's period, which the descriptors assume).
  static constexpr int smem_bytes = S * (a_bytes + b_bytes) + 1024;
};

template <int BM, int BN, int S>
__global__ void __launch_bounds__(WgmmaRing<BM, BN, S>::threads)
nbb_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 bf16* __restrict__ c, int M, int N, int K) {
  using R = WgmmaRing<BM, BN, S>;
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(8) uint64_t empty[S];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* a_ring = ring;                  // S x [BM][64], swizzled
  unsigned char* b_ring = ring + S * R::a_bytes; // S x BN/64 boxes [64][64]

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n_k = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32;
  init_ring(full, empty, S, R::consumers);

  if (warp == R::consumers * 4) {
    // Producer: one thread issues every copy of the block.
    if (threadIdx.x % 32 == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % S, r = kt / S;
        if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
        mbar_arrive_expect_tx(&full[s], R::a_bytes + R::b_bytes);
        tma_load_2d(a_ring + s * R::a_bytes, &map_a, kt * kBK, m0, &full[s]);
#pragma unroll
        for (int j = 0; j < BN / kBoxN; ++j)
          tma_load_2d(b_ring + s * R::b_bytes + j * kBoxBytes, &map_b,
                      n0 + j * kBoxN, kt * kBK, &full[s]);
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows m0 + 64 wg .. + 63 of the tile.
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    const uint32_t a_addr = smem_addr(a_ring + s * R::a_bytes) + wg * 64 * 128;
    const uint32_t b_addr = smem_addr(b_ring + s * R::b_bytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A: 16 columns of K are 32 bytes into each swizzled 128-byte row;
      // B: 16 rows of K are 16 x 128 bytes further into each box.
      Wgmma<BN>::template ss<1>(
          acc, smem_desc(a_addr + kk * 32, 16, 1024, 1),
          smem_desc(b_addr + kk * 16 * 128, kBoxBytes, 1024, 1), 1);
    }
    wgmma_commit();
    fence_acc(acc);
    // The previous tile's products have finished: release its slot.
    wgmma_wait<1>();
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(kt - 1) % S]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16 w + lane / 4 (+ 8); register 4 j + e holds column 8 j + 2 (lane %
  // 4) + (e & 1), the upper row for e >= 2.
  const int lane = threadIdx.x % 32;
  const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;            // N is a multiple of 8: col + 1 < N
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r < M) {
        __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(c + (long long)r * N + col) = v;
      }
    }
  }
}

// A tensor map of a row-major bf16 [rows, cols] matrix, read in boxes of
// box_rows x 64 columns, 128-byte swizzled, zeros out of bounds.
bool bf16_map(CUtensorMap* map, const void* base, int rows, int cols,
              int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int I>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int M, int N,
                         int K, cudaStream_t stream) {
  constexpr int BM = kTiles[I].m, BN = kTiles[I].n, S = kTiles[I].slots;
  using R = WgmmaRing<BM, BN, S>;
  static_assert(kTiles[I].k == kBK, "the wgmma instances step K by 64");
  static_assert(R::smem_bytes <= kMaxSmemBytes, "ring exceeds shared memory");
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        nbb_wgmma_kernel<BM, BN, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, R::smem_bytes);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  CUtensorMap map_a, map_b;
  if (!bf16_map(&map_a, a, M, K, BM) || !bf16_map(&map_b, b, K, N, kBK))
    return cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  nbb_wgmma_kernel<BM, BN, S><<<grid, R::threads, R::smem_bytes, stream>>>(
      map_a, map_b, static_cast<bf16*>(c), M, N, K);
  return cudaGetLastError();
}

#define NBB_SMEM_ROW(I, NAME)                                              \
  {NAME, (const void*)nbb_wgmma_kernel<kTiles[I].m, kTiles[I].n,            \
                                       kTiles[I].slots>,                   \
   WgmmaRing<kTiles[I].m, kTiles[I].n, kTiles[I].slots>::smem_bytes}

// The float32 ring is static.
const SmemRow kSmemRows[] = {
    {"nbb_simt_kernel", (const void*)nbb_simt_kernel, 0},
    NBB_SMEM_ROW(1, "nbb_wgmma_kernel<64, 64, 4>"),
    NBB_SMEM_ROW(2, "nbb_wgmma_kernel<128, 128, 3>")};

#undef NBB_SMEM_ROW

}  // namespace

extern "C" {

// An instance's tile: which = 0 (M), 1 (N), 2 (K step), 3 (ring slots).
int nbb_matmul_tile(int instance, int which) {
  if (instance < 0 || instance > 2 || which < 0 || which > 3) return -1;
  const Tile& t = kTiles[instance];
  return which == 0 ? t.m : which == 1 ? t.n : which == 2 ? t.k : t.slots;
}

// Instance i's shared memory (hopper::smem_row): 0, -1 past the last.
int nbb_matmul_smem(int i, const char** name, int* static_bytes,
                    int* dynamic_bytes) {
  return smem_row(kSmemRows, i, name, static_bytes, dynamic_bytes);
}

// instance: 0 = float32 (CUDA cores), 1 or 2 = bfloat16 (tensor cores; the
// wrapper picks by shape).  a [M,K], b [K,N], c [M,N], all row-major and
// contiguous.  Returns a cudaError_t (0 = ok).
int nbb_matmul_launch(const void* a, const void* b, void* c, int instance,
                      int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0) return cudaErrorInvalidValue;
  const int size = instance == 0 ? 4 : 2;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  if ((ptrs % 16) || ((long long)K * size) % 16 || ((long long)N * size) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == 0) {
    dim3 grid((N + kSimtN - 1) / kSimtN, (M + kSimtM - 1) / kSimtM);
    nbb_simt_kernel<<<grid, kSimtThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), M, N, K);
    return cudaGetLastError();
  }
  if (instance == 1) return launch_wgmma<1>(a, b, c, M, N, K, s);
  if (instance == 2) return launch_wgmma<2>(a, b, c, M, N, K, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
