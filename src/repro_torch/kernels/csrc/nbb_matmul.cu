// NBB double-buffered matmul for Hopper (sm_90a), CUDA C++ with a plain C
// entry point.
//
// Replaces the TPU kernel of the JAX package: `nbb_matmul`
// (src/repro/kernels/nbb_matmul.py:84), whose body `_nbb_matmul_kernel`
// (:33) runs under the `pl.pallas_call` at :96.  Same contract: C[M,N] =
// A[M,K] @ B[K,N] with a float32 accumulator, written in A's dtype
// (float32 or bfloat16); A and B are row-major and contiguous.
//
// The point of the kernel is the paper's NBB ring (Kim'07), made explicit.
// Each block owns one kTileM x kTileN output tile and walks K in kTileK
// steps through a 2-slot shared-memory ring per operand:
//
//   producer (warp kConsumerWarps, the copy side): for K tile k it waits on
//     the slot's *empty* mbarrier (the consumers' "acknowledge" counter),
//     arms the slot's *full* mbarrier with the tile's byte count, and
//     issues one `cp.async.bulk ... mbarrier::complete_tx::bytes` copy per
//     tile row; the copy engine's completions are the "update" counter.
//   consumers (warps 0..kConsumerWarps-1, the math side): for K tile k they
//     wait on slot k % 2's *full* mbarrier -- on data readiness only, never
//     on a lock -- accumulate the slot's product, then arrive on its
//     *empty* mbarrier.
//
// The producer is therefore at most one slot ahead of the consumers: it
// fills slot (k+1) % 2 while they read slot k % 2, the TPU kernel's
// discipline (nbb_matmul.py:54-76) with mbarriers in place of DMA
// semaphores.  Each slot's barriers complete one phase per use, so the
// phase parity a waiter asks for is (k / 2) % 2 for the full barrier and
// (k / 2 - 1) % 2 for the empty one (no wait for the first two tiles: the
// ring starts empty).
//
// What bounds it on an H100: a large product (the 4096^3 timing shape) is
// far above the ~295 flop/byte line, so the bound is the tensor-core rate.
// This first version does not approach it: the arithmetic is float32 FMA
// on the CUDA cores for both dtypes (TF32 would break the reference's
// 2e-5 float32 tolerance at K=384), each operand read from shared memory.
// Tensor maps (cuTensorMapEncodeTiled lives in libcuda, which this plain
// nvcc build does not link), a deeper ring and wgmma are the work of the
// change that makes it fast.
//
// Ragged edges are handled by bounds: rows past M or K are not copied,
// a row's copy is cut at K or N, and the consumers sum only the K tile's
// valid columns.  The bulk copies need 16-byte aligned addresses and
// sizes: the base pointers, K * sizeof(T) and N * sizeof(T) must be
// multiples of 16 (the wrapper checks; this entry point refuses).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 32;
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;   // 16 x 16, 4 x 4 each
constexpr int kThreads = kConsumers + 32;         // + one producer warp

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

// Leading dimensions of the ring's tiles, in elements.  An A row is padded
// by 16 bytes so the consumers' column reads of neighbouring rows fall in
// different banks; every row start stays 16-byte aligned for the copies.
template <typename T> struct Ring {
  static constexpr int lda = kTileK + 16 / sizeof(T);
  static constexpr int ldb = kTileN;
  static constexpr int a_slot = kTileM * lda;   // elements per slot
  static constexpr int b_slot = kTileK * ldb;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive once and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Global -> shared copy by the copy engine; completion is counted in
// bytes on `bar`.  dst, src and bytes must be multiples of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nbb_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ c, int M, int N, int K) {
  using R = Ring<T>;
  __shared__ __align__(128) T a_ring[2 * R::a_slot];
  __shared__ __align__(128) T b_ring[2 * R::b_slot];
  __shared__ __align__(8) uint64_t full[2];
  __shared__ __align__(8) uint64_t empty[2];

  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int m_valid = min(kTileM, M - m0);
  const int n_valid = min(kTileN, N - n0);
  const int n_k = (K + kTileK - 1) / kTileK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);                 // the producer's arrive
      mbar_init(&empty[s], kConsumerWarps);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // No block-wide barrier past this point: the two roles run apart.

  if (warp == kConsumerWarps) {
    // Producer: the copy side of the ring.
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt & 1;
      if (kt >= 2) mbar_wait(&empty[s], ((kt >> 1) - 1) & 1);
      const int k0 = kt * kTileK;
      const int k_valid = min(kTileK, K - k0);
      const uint32_t a_row = k_valid * sizeof(T);
      const uint32_t b_row = n_valid * sizeof(T);
      if (lane == 0)
        mbar_arrive_expect_tx(&full[s], m_valid * a_row + k_valid * b_row);
      __syncwarp();   // armed before any copy can complete
      T* a_dst = a_ring + s * R::a_slot;
      T* b_dst = b_ring + s * R::b_slot;
      for (int r = lane; r < m_valid; r += 32)
        bulk_copy(a_dst + r * R::lda, a + (long long)(m0 + r) * K + k0,
                  a_row, &full[s]);
      for (int r = lane; r < k_valid; r += 32)
        bulk_copy(b_dst + r * R::ldb, b + (long long)(k0 + r) * N + n0,
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
    const int s = kt & 1;
    mbar_wait(&full[s], (kt >> 1) & 1);
    const int k_valid = min(kTileK, K - kt * kTileK);
    const T* as = a_ring + s * R::a_slot;
    const T* bs = b_ring + s * R::b_slot;
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
      for (int i = 0; i < 4; ++i)
        av[i] = to_f32(as[(ty + 16 * i) * R::lda + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = to_f32(bs[kk * R::ldb + tx + 16 * j]);
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
      if (col < n_valid)
        c[(long long)(m0 + r) * N + n0 + col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N,
                   int K, cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  if ((ptrs % 16) || (K * sizeof(T)) % 16 || (N * sizeof(T)) % 16)
    return cudaErrorInvalidValue;
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  nbb_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel's own output tile and K step: which = 0 (M), 1 (N), 2 (K).
int nbb_matmul_tile(int which) {
  return which == 0 ? kTileM : which == 1 ? kTileN : kTileK;
}

// dtype: 0 = float32, 1 = bfloat16.  a [M,K], b [K,N], c [M,N], all
// row-major and contiguous.  Returns a cudaError_t (0 = ok).
int nbb_matmul_launch(const void* a, const void* b, void* c, int dtype, int M,
                      int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, c, M, N, K, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, c, M, N, K, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
