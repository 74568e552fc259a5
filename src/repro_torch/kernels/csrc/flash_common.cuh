// Device helpers shared by the flash-attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) and the
// paged-attention kernels (paged_attention.cu) on Hopper:
// the visibility rule, 16-byte cp.async copies into padded shared-memory
// tiles, ldmatrix fragment loads and the bf16 mma.sync.m16n8k16 product
// with f32 accumulation.
//
// Fragment layouts of mma.m16n8k16 (lane = threadIdx.x % 32, gr = lane/4,
// gc = lane%4):
//   A 16x16 (row-major): a0 (gr, 2gc..+1), a1 (gr+8, 2gc..), a2 (gr,
//     2gc+8..), a3 (gr+8, 2gc+8..);
//   B 16x8 (k x n): b0 (k 2gc..+1, n gr), b1 (k 2gc+8.., n gr);
//   C 16x8 f32: c0,c1 (gr, 2gc..+1), c2,c3 (gr+8, 2gc..+1).
// A C fragment pair (n-tiles 2j, 2j+1) packed to bf16 is the A fragment
// of k-step j of the next product: probabilities never leave registers.
//
// Shared-memory tiles are row-major [rows][HD + 8] bf16: the 16-byte pad
// puts the 8 rows an ldmatrix reads in 8 distinct 16-byte bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// A block may hold at most this much dynamic shared memory on sm_90.
constexpr int kMaxSmemBytes = 232448;

// Is key position kp visible from query position qp?
__device__ __forceinline__ bool visible(int causal, int window, int kp,
                                        int qp) {
  if (causal && kp > qp) return false;
  if (window > 0 && kp <= qp - window) return false;
  return true;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (the
// source is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `rows` rows of HD bf16 (row r at src + r * stride) into the padded
// tile dst; rows at or past `valid` are zero-filled.  The first
// dr * (HD / 8) threads of the block take part, dr = blockDim / (HD / 8),
// each on one fixed 16-byte column of every dr-th row, so its addresses
// only step.  At HD 80 (10 columns) the last blockDim % 10 threads copy
// nothing: they would repeat another thread's rows.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int rows,
                                          int valid, const void* mapped) {
  constexpr int LD = HD + 8, CH = HD / 8;
  const int c = threadIdx.x % CH, dr = blockDim.x / CH;
  if (threadIdx.x >= dr * CH) return;
  const bf16* s = src + (threadIdx.x / CH) * stride + c * 8;
  bf16* d = dst + (threadIdx.x / CH) * LD + c * 8;
  const long long step = dr * stride;
  for (int r = threadIdx.x / CH; r < rows; r += dr, s += step, d += dr * LD)
    cp_async16(d, r < valid ? static_cast<const void*>(s) : mapped,
               r < valid);
}

// 2^x by the special-function unit (ex2.approx: ~2^-22 relative error;
// 2^-inf = +0, so a masked score gives a probability of exactly 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A fragment of rows row0..row0+15, columns k0..k0+15 of a row-major
// tile with row stride ld (elements).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  ldsm_x4(a, smem_u32(tile + (row0 + r + (m & 1) * 8) * ld + k0 +
                      (m >> 1) * 8));
}

// B fragments of two n-tiles (n0..n0+7 -> b[0], b[1]; n0+8..n0+15 ->
// b[2], b[3]) over k0..k0+15, from a tile stored [n][k] (k contiguous).
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  ldsm_x4(b, smem_u32(tile + (n0 + r + (m >> 1) * 8) * ld + k0 +
                      (m & 1) * 8));
}

// The same two-n-tile B fragments from a tile stored [k][n] (n
// contiguous), transposed by ldmatrix.
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile,
                                        int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  ldsm_x4_t(b, smem_u32(tile + (k0 + r + (m & 1) * 8) * ld + n0 +
                        (m >> 1) * 8));
}

// d += a * b on the tensor cores: bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step j built from C fragments c[2j], c[2j+1].
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// Set the dynamic shared-memory limit of `kernel` to the sm_90 maximum
// once per kernel.
template <typename K>
cudaError_t allow_max_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (e == cudaSuccess) done = true;
  return e;
}

}  // namespace flash
