// The in-launch merge of a split-KV pass, shared by the split route of
// the flash forward (flash_attention.cu) and both tensor-core routes of
// paged attention (paged_attention.cu).
//
// A pass cuts each row's keys into runs ("splits"), one block per split.
// Each block leaves its rows' partial (max in log2 units, sum, f32
// accumulator) in a scratch buffer and counts its arrival on its group's
// counter; the block that arrives last merges every split's partial in
// split order and resets the counter to 0.  So the pass is one launch,
// its result does not depend on which split finishes last, and the
// counters are back at 0 for the next launch on the stream.
//
// Partial layout of a group of n splits of `ld` rows each: split s's
// accumulator of row r, column c at parts[(s * ld + r) * HD + c]; its max
// at ml[s * 2 * ld + r] and its sum at ml[s * 2 * ld + ld + r].

#pragma once

#include "flash_common.cuh"

namespace splitkv {

// Count this block's split in on `count` once every thread of the block
// has written its partial; true, in every thread, for the block that
// arrives last of `target`.  One thread fences for the block: the barrier
// makes every thread's partial its to publish (release), and its fence
// after the count orders the block's reads of the other splits' partials
// after it (acquire).  Every thread of the block must call it.
__device__ __forceinline__ bool arrive(int* count, int target) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(count, 1) == target - 1;
    __threadfence();
  }
  __syncthreads();
  return last != 0;
}

// Merge n splits' partials of rows 0 .. R - 1 (R <= ld) in split order:
// every split's (max, sum) of every row in one round of loads, then each
// row's max M, its splits' weights 2^(m_s - M) and its sum L, then each
// element's accumulator, four columns a thread with up to eight splits'
// loads in flight, so the partials stream from L2;
// store(r, c, acc, M, L) writes row r's column c (acc / L, or 0 where L
// is 0: no visible key).  `scratch` is (3 n + 2) * ld floats of shared
// memory; the counter is reset to 0 at the end.  Every thread of the
// block must call it.
template <int HD, typename Store>
__device__ __forceinline__ void merge(const float* parts, const float* ml,
                                      int n, int R, int ld, float* scratch,
                                      int* count, Store store) {
  constexpr int C4 = HD / 4;
  float* ms = scratch;        // [n][ld]
  float* ls = ms + n * ld;    // [n][ld]
  float* wts = ls + n * ld;   // [n][ld]
  float* big = wts + n * ld;  // [2][ld]: max, sum
  for (int i = threadIdx.x; i < n * ld; i += blockDim.x) {
    const int s = i / ld, r = i % ld;
    if (r < R) {
      ms[i] = __ldcg(ml + s * 2 * ld + r);
      ls[i] = __ldcg(ml + s * 2 * ld + ld + r);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float M = flash::kNegInf, L = 0.f;
    for (int s = 0; s < n; ++s) M = fmaxf(M, ms[s * ld + r]);
    for (int s = 0; s < n; ++s) {
      const float a = flash::fast_exp2(ms[s * ld + r] - M);
      wts[s * ld + r] = a;
      L += ls[s * ld + r] * a;
    }
    big[r] = M;
    big[ld + r] = L;
  }
  __syncthreads();
  const int items = R * C4;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int r = i / C4, c = 4 * (i % C4);
    const float4* src = reinterpret_cast<const float4*>(parts + r * HD + c);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const float4 x = __ldcg(src + s * ld * C4);
      const float w = wts[s * ld + r];
      acc.x += x.x * w;
      acc.y += x.y * w;
      acc.z += x.z * w;
      acc.w += x.w * w;
    }
    store(r, c, acc.x, big[r], big[ld + r]);
    store(r, c + 1, acc.y, big[r], big[ld + r]);
    store(r, c + 2, acc.z, big[r], big[ld + r]);
    store(r, c + 3, acc.w, big[r], big[ld + r]);
  }
  if (threadIdx.x == 0) *count = 0;
}

}  // namespace splitkv
